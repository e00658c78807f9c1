"""Accelerator selection and device resolution.

The port runs on the card by default: entry points take ``device=`` that
defaults to ``"cuda"`` and pass it through :func:`resolve_device`, which
raises when CUDA is absent instead of carrying on quietly on the CPU.  The
CPU is used only when a caller asks for it (the CPU tests do).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .cuda_accelerator import CudaAccelerator

_accelerator: Optional[CudaAccelerator] = None


def get_accelerator() -> CudaAccelerator:
    global _accelerator
    if _accelerator is None:
        _accelerator = CudaAccelerator()
    return _accelerator


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``"cuda"``.

    Raises ``RuntimeError`` for a CUDA device when CUDA is not available:
    a caller that wants the CPU says ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "deepspeed_tpu_torch runs on an NVIDIA GPU by default and CUDA "
            "is not available here; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
