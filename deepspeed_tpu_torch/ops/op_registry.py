"""Named-op registry — the port of ``deepspeed_tpu/ops/op_registry.py``.

Capability analogue of the reference's op-builder system (``op_builder/
builder.py`` ``OpBuilder``/``jit_load``): a named registry mapping op names to
their implementations with compatibility probing.  The port's compute ops
are hand-written CUDA kernels (``csrc/``, built by ``nvcc`` at first launch)
with plain PyTorch versions on CPU tensors; each entry points at the port's
module.  ``async_io`` (C++ async NVMe tensor I/O) has no port yet: its
factory raises and :func:`available_ops` leaves it out.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class OpBuilderEntry:
    name: str
    factory: Callable[[], Any]
    platforms: tuple = ("cuda", "cpu")
    description: str = ""
    module: str = ""  # import path probed by is_loadable

    def is_compatible(self, platform: str) -> bool:
        return (platform in self.platforms or "any" in self.platforms) \
            and self.is_loadable()

    def is_loadable(self) -> bool:
        if not self.module:
            return True
        import importlib.util

        try:
            return importlib.util.find_spec(self.module) is not None
        except (ImportError, ModuleNotFoundError):
            return False

    def load(self) -> Any:
        try:
            return self.factory()
        except ImportError as e:
            raise ImportError(
                f"op {self.name!r} is registered but its implementation module "
                f"is unavailable: {e}") from e


_REGISTRY: Dict[str, OpBuilderEntry] = {}


def register_op(name: str, factory: Callable[[], Any],
                platforms: tuple = ("cuda", "cpu"), description: str = "",
                module: str = "") -> None:
    _REGISTRY[name] = OpBuilderEntry(name, factory, platforms, description, module)


def get_op_builder(name: str, platform: str = "cuda") -> OpBuilderEntry:
    _ensure_builtin_ops()
    if name not in _REGISTRY:
        raise KeyError(f"unknown op {name!r}; available: {sorted(_REGISTRY)}")
    entry = _REGISTRY[name]
    if not entry.is_compatible(platform):
        logger.warning(f"op {name!r} not tuned for platform {platform!r}; "
                       "falling back to portable implementation")
    return entry


def available_ops() -> Dict[str, str]:
    """Op → description, only for ops whose implementation actually imports
    (the reference's ``ds_report`` compatibility-matrix role)."""
    _ensure_builtin_ops()
    return {k: v.description for k, v in sorted(_REGISTRY.items()) if v.is_loadable()}


_builtin_loaded = False


def _ensure_builtin_ops() -> None:
    global _builtin_loaded
    if _builtin_loaded:
        return
    _builtin_loaded = True

    def _flash():
        from .hopper import flash_attention

        return flash_attention

    def _fused_adam():
        from . import fused_optimizers

        return fused_optimizers

    def _quantizer():
        from . import quantizer

        return quantizer

    def _aio():
        raise NotImplementedError(
            "op 'async_io' (C++ async NVMe tensor I/O) has no port yet: "
            "ROADMAP.md A3 (the ctypes binding to csrc/aio/ds_aio.cpp) and "
            "A14 (nvme/ offload)")

    def _paged_attn():
        from .hopper import paged_attention

        return paged_attention

    def _evoformer():
        from . import evoformer

        return evoformer

    def _grouped_gemm():
        from .hopper import grouped_matmul

        return grouped_matmul

    register_op("evoformer_attn", _evoformer,
                description="DS4Science evoformer attention (pair/mask bias)",
                module="deepspeed_tpu_torch.ops.evoformer")
    register_op("grouped_gemm", _grouped_gemm,
                description="CUDA grouped GEMM (dropless MoE expert FFN)",
                module="deepspeed_tpu_torch.ops.hopper.grouped_matmul")
    register_op("flash_attention", _flash, description="CUDA fused attention (fwd/bwd)",
                module="deepspeed_tpu_torch.ops.hopper.flash_attention")
    register_op("fused_adam", _fused_adam, description="fused AdamW update (CUDA)",
                module="deepspeed_tpu_torch.ops.fused_optimizers")
    register_op("quantizer", _quantizer,
                description="int4 packing and FP6 coding of mixed-GEMM codes",
                module="deepspeed_tpu_torch.ops.quantizer")
    register_op("async_io", _aio, platforms=("cuda", "cpu", "any"),
                description="C++ async NVMe tensor I/O (csrc/aio equivalent)",
                module="deepspeed_tpu_torch.nvme.aio_handle")
    register_op("paged_attention", _paged_attn, description="paged KV decode attention",
                module="deepspeed_tpu_torch.ops.hopper.paged_attention")
