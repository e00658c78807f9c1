"""Build and load the port's CUDA kernels.

Every source in ``deepspeed_tpu_torch/csrc`` (:data:`SOURCES`; the GEMM
sources share the header :data:`HEADERS`) is compiled by ``nvcc`` for
Hopper (``sm_90a``), one ``nvcc`` per source, all started together, and
the objects are linked into one shared library with a plain C
interface, which the wrappers load with ``ctypes`` (pointers and the stream
pass as ``c_void_p``; every C entry returns ``cudaGetLastError()``).
Nothing includes PyTorch's headers, so a build takes seconds, not minutes.

The build happens at first use, from the checkout's sources only, into
``build/torch_kernels/`` at the root of the checkout (git-ignored).  The
library's file name carries a digest of every source, header and flag, so an
edited source is rebuilt and a stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Tuple

CSRC = Path(__file__).resolve().parents[2] / "csrc"
SOURCES: Tuple[Path, ...] = (CSRC / "paged_attention.cu",
                             CSRC / "flash_attention.cu",
                             CSRC / "flash_attention_bias.cu",
                             CSRC / "flash_attention_bias_f16.cu",
                             CSRC / "flash_attention_f16.cu",
                             CSRC / "mixed_gemm.cu",
                             CSRC / "grouped_matmul.cu",
                             CSRC / "fused_adam.cu")
#: headers the sources include: part of the library's digest, not compiled
HEADERS: Tuple[Path, ...] = (CSRC / "hopper.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"

COMPILE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-shared",)

# the C entry points: name -> ctypes argtypes
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
_ENTRIES: Dict[str, list] = {
    # dtype, q, k, v, block tables, context lens, out, workspace, S, H, KV,
    # D, BS, MB, split, stream
    "ds_paged_decode": [_I] + [_P] * 7 + [_I] * 7 + [_P],
    "ds_paged_prefill": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, _I, _P],
    # dtype, q, k, v, seg, bm, b1, b2, b1 dtype, b2 dtype, b2 rep, o, lse,
    # B, S, Skv, H, KV, D, causal, window, bq, bk, nkb, scale, stream
    "ds_flash_fwd": [_I] + [_P] * 7 + [_I] * 3 + [_P] * 2 + [_I] * 11
    + [_F, _P],
    # dtype, q, k, v, do, lse, delta, seg, bm, dk, dv, (11 ints), scale, stream
    "ds_flash_bwd_dkdv": [_I] + [_P] * 10 + [_I] * 11 + [_F, _P],
    # dtype, q, k, v, do, lse, delta, seg, bm, dq, (11 ints), scale, stream
    "ds_flash_bwd_dq": [_I] + [_P] * 9 + [_I] * 11 + [_F, _P],
    # dtype, bits, x, codes, scales, out, workspace, tickets, M, N, K,
    # group, splits, stream
    "ds_mixed_gemm": [_I, _I] + [_P] * 6 + [_I] * 5 + [_P],
    # dtype, wgmma, x codes, x scales (K/group, pitch), pitch, w codes, w
    # scales, out, M, N, K, group, stream
    "ds_int8_gemm": [_I, _I, _P, _P, _I, _P, _P, _P] + [_I] * 4 + [_P],
    # dtype, lhs, rhs, tile_group, used tiles, out, M, N, K, E, tile_m, bm,
    # transposed, wgmma, stream
    "ds_grouped_matmul": [_I] + [_P] * 5 + [_I] * 8 + [_P],
    # p dtype, g dtype, p, g, m, v, step, p out, m out, v out, n, lr, b1,
    # b2, 1 - b1, 1 - b2, eps, weight decay, stream
    "ds_fused_adamw": [_I, _I] + [_P] * 8 + [_L] + [_F] * 7 + [_P],
}

_LIB: Optional[ctypes.CDLL] = None
_LOAD_LOCK = threading.Lock()


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
    h = hashlib.sha256()
    for src in SOURCES + HEADERS:
        h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    h.update(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libds_kernels-{h.hexdigest()[:16]}.so"


def build() -> Tuple[float, str]:
    """Compile the kernel library unless it is built already.  Returns the
    seconds the build took and ``nvcc``'s output (each source's seconds,
    ptxas' register and spill report), or ``(0.0, "")`` for a library
    already on disk; raises ``RuntimeError`` with the compiler's output
    when the build fails."""
    out = library_path()
    if out.exists():
        return 0.0, ""
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in SOURCES]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(SOURCES, objs)]

    def finish(proc):  # each read on its own thread: the pipes never fill
        log = proc.communicate()[0]
        return log, time.perf_counter() - t0

    with ThreadPoolExecutor(len(procs)) as pool:
        done = list(pool.map(finish, procs))
    logs, failed = [], []
    for src, proc, (log, secs) in zip(SOURCES, procs, done):
        logs.append(f"== {src.name} ({secs:.1f} s)\n{log}")
        if proc.returncode != 0:
            failed.append(f"{src.name} (nvcc exit {proc.returncode})")
    try:
        if not failed:
            link = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp),
                                   *map(str, objs)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            logs.append(f"== link\n{link.stdout}")
            if link.returncode != 0:
                failed.append(f"link (nvcc exit {link.returncode})")
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError("CUDA kernel build failed: "
                               + ", ".join(failed) + "\n" + "\n".join(logs))
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return time.perf_counter() - t0, "\n".join(logs)


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with its entry points'
    argument and result types declared.  Thread-safe: the first launches
    of two in-process replicas' engine threads build once (``build``
    names its files by process), and neither sees a half-declared
    library."""
    global _LIB
    if _LIB is None:
        with _LOAD_LOCK:
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
