"""CUDA accelerator: the port's counterpart of
``deepspeed_tpu/accelerator/tpu_accelerator.py``.

Kept to what the serving slice uses (device name, device count,
synchronize); the wider accelerator surface arrives with the training
slice.
"""

from __future__ import annotations

import torch


class CudaAccelerator:
    """The NVIDIA GPUs visible to this process, through ``torch.cuda``."""

    name = "cuda"

    def is_available(self) -> bool:
        return torch.cuda.is_available()

    def device_name(self, index: int = 0) -> str:
        return torch.cuda.get_device_name(index)

    def device_count(self) -> int:
        return torch.cuda.device_count()

    def synchronize(self, device=None) -> None:
        torch.cuda.synchronize(device)
