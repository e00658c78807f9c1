"""CUDA accelerator: the port's counterpart of
``deepspeed_tpu/accelerator/tpu_accelerator.py``.

Kept to what the serving and training slices use: device name and count,
synchronize, the bf16 peak that MFU is taken against, and the op-builder
lookup (``create_op_builder``) over ``ops/op_registry.py``.
"""

from __future__ import annotations

import torch

# dense tensor-core peaks of an NVIDIA H100 SXM, TFLOP/s (NVIDIA's data
# sheet, without sparsity, at the 700 W power limit)
H100_SXM_PEAK_TFLOPS = {"bfloat16": 989.0, "float16": 989.0}


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

    def create_op_builder(self, op_name: str):
        """The registry entry of ``op_name`` (``ops/op_registry.py``)."""
        from ..ops.op_registry import get_op_builder

        return get_op_builder(op_name, self.name)

    def peak_tflops(self, dtype: str = "bfloat16") -> float:
        """The card's dense peak for ``dtype``: the H100 SXM data sheet's
        figure (the only card this port is built for)."""
        if dtype not in H100_SXM_PEAK_TFLOPS:
            raise ValueError(f"no peak for dtype {dtype!r}; have "
                             f"{sorted(H100_SXM_PEAK_TFLOPS)}")
        return H100_SXM_PEAK_TFLOPS[dtype]
