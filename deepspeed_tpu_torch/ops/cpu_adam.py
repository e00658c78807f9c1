"""Host Adam / AdamW in one pass: the update of the offloaded optimizer
(``runtime/zero/offload.py``) on the host.

The reference runs the offloaded update as a jitted XLA:CPU program
(``deepspeed_tpu/runtime/zero/offload.py``), which fuses Adam into one
loop; the port's plain PyTorch update (``runtime/optimizers.py`` ``Adam``)
makes 14 passes over each leaf, ~17-35 s a step over llama3-8b at 16
layers on the H100 machine's 8 host cores.  ``csrc/cpu_adam.cpp`` is that
loop: each element's moments, bias corrections, decay and update in the
plain update's order and f32 roundings, split over the host threads
(``torch.get_num_threads()``).  It is built with ``g++`` at first use into
``build/torch_kernels/`` (the file name carries a digest of the source,
the flags and the host CPU, for ``-march=native``), as the AIO library
is; a failed build raises.

:func:`supported` says whether an optimizer and its leaves take this path:
the port's ``Adam`` (AdamW, or classic L2), not Nesterov, on contiguous
f32 host tensors.  Other optimizers step in plain PyTorch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import torch

from ..runtime.optimizers import Adam
from ..utils.logging import logger

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "deepspeed_tpu_torch" / "csrc" / "cpu_adam.cpp"
BUILD_DIR = _ROOT / "build" / "torch_kernels"
# -ffp-contract=off: no fused multiply-adds, so each operation rounds as
# PyTorch's does; -fno-math-errno lets the square root vectorize
_FLAGS = ("-O3", "-march=native", "-fopenmp", "-ffp-contract=off",
          "-fno-math-errno", "-shared", "-fPIC", "-std=c++17")

#: leaves updated by the one-pass loop
CALLS = {"cpu_adam": 0}

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _cpu_id() -> bytes:
    """The host CPU's model and flags: ``-march=native`` builds for them,
    so a library built on another CPU is never loaded."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
        return "".join(lines[:2]).encode()
    except OSError:
        return b""


def _build() -> str:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()
                            + _cpu_id()).hexdigest()[:16]
    so_path = BUILD_DIR / f"libds_cpu_adam_{digest}.so"
    if so_path.exists():
        return str(so_path)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".libds_cpu_adam_{digest}.{os.getpid()}.so"
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
    logger.info(f"building the host Adam: {' '.join(cmd)}")
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {_SRC} failed:\n{res.stderr}")
    os.replace(tmp, so_path)
    return str(so_path)


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(_build())
            f = ctypes.c_float
            lib.ds_cpu_adam_step.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64, f, f, f, f, f, f, f, f, f,
                ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.ds_cpu_adam_step.restype = None
            _LIB = lib
    return _LIB


def build() -> None:
    """Build (or find) and load the library now."""
    _lib()


def supported(opt, params: List[torch.Tensor]) -> bool:
    """Whether ``opt`` steps ``params`` through the one-pass loop."""
    return (type(opt) is Adam and not opt.nesterov
            and not isinstance(opt.count, torch.Tensor)
            and all(p.device.type == "cpu" and p.dtype == torch.float32
                    and p.is_contiguous() for p in params))


@torch.no_grad()
def adam_step(opt: Adam, params: List[torch.Tensor],
              grads: List[torch.Tensor]) -> None:
    """``opt.step(params, grads)`` in one pass a leaf (contiguous f32 host
    tensors: the f32 master and gradient buffers)."""
    lib = _lib()
    count = opt.count
    t = count + 1
    lr = opt.lr(count)
    b1, b2 = opt.b1, opt.b2
    threads = torch.get_num_threads()
    for i, (p, g) in enumerate(zip(params, grads)):
        m, v = opt.mu[i], opt.nu[i]
        g = g.contiguous()
        decay = bool(opt.weight_decay and opt.mask[i])
        lib.ds_cpu_adam_step(
            p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
            p.numel(), b1, 1.0 - b1, b2, 1.0 - b2, 1.0 - b1 ** t,
            1.0 - b2 ** t, opt.eps, -lr, opt.weight_decay, int(decay),
            int(opt.decoupled), threads)
        CALLS["cpu_adam"] += 1
    opt.count = count + 1
