"""Build and load the port's CUDA kernels.

``deepspeed_tpu_torch/csrc/paged_attention.cu`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface, which
the wrappers load with ``ctypes`` (pointers and the stream pass as
``c_void_p``; every C entry returns ``cudaGetLastError()``).  Nothing
includes PyTorch's headers, so a build takes seconds, not minutes.

The build happens at first use, from the checkout's source only, into
``build/torch_kernels/`` at the root of the checkout (git-ignored).  The
library's file name carries a digest of its source and flags, so an edited
source is rebuilt and a stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Tuple

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "paged_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the C entry points: name -> ctypes argtypes
_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRIES = {
    "ds_paged_decode": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _P],
    "ds_paged_prefill": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, _I, _P],
}

_LIB: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (CUDA_HOME, PATH, /usr/local/cuda): the port's "
        "CUDA kernels are built from source at first use")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libpaged_attention-{digest[:16]}.so"


def build() -> Tuple[float, str]:
    """Compile the kernel library unless it is built already.  Returns the
    seconds the build took and ``nvcc``'s output (ptxas' register and spill
    report), or ``(0.0, "")`` for a library already on disk; raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    out = library_path()
    if out.exists():
        return 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                           str(SOURCE)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"CUDA kernel build failed (nvcc exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half
    return secs, proc.stdout


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with its entry points'
    argument and result types declared."""
    global _LIB
    if _LIB is None:
        build()
        lib = ctypes.CDLL(str(library_path()))
        for fn, argtypes in _ENTRIES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.ds_error_string.argtypes = [ctypes.c_int]
        lib.ds_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.ds_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
