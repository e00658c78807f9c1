"""PEFT / LoRA configuration — the port of ``deepspeed_tpu/linear/config.py``.

The same three sections serve the standalone ``deepspeed_tpu_torch.linear``
API and the ``"peft"`` block of the root config (``runtime/config.py``), as
in the reference; they are dataclasses on the port's config base
(``runtime/config_utils.py``), with the reference's checks and messages:

* ``QuantizationConfig.q_bits`` / ``mantissa_bits`` pick the frozen base's
  codec from ``ops/quantizer.py``: (8, 3) block-scaled fp8 e4m3 (the
  default; the flat ``"block"`` layout, dequantized before its matmul),
  (6, 2) fp6 e3m2, (8, 0) int8 and (4, 0) int4 (the mixed GEMM's row-group
  layout, ``ops/hopper/mixed_gemm.py``);
* ``LoRAConfig.lora_r`` / ``lora_alpha``: the factors' rank and the
  numerator of the scaling ``alpha / r``; ``base_weight_sharding`` picks
  the frozen base's logical axes, which arrive with the multi-GPU item
  (ROADMAP.md A13): on one device it is checked and kept.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from ..runtime.config_utils import ConfigError, DSConfigModel

#: projection leaves the LoRA switch targets by default — the qkv/o and MLP
#: matmuls of models/transformer.py
DEFAULT_TARGET_MODULES = ["wq", "wk", "wv", "wo", "w_in", "w_out", "w_gate"]


@dataclass
class QuantizationConfig(DSConfigModel):
    """Frozen-base storage format (reference ``linear/config.py:38``)."""

    q_bits: int = 8
    mantissa_bits: int = 3
    group_size: int = 512

    def validate(self) -> None:
        if (self.q_bits, self.mantissa_bits) not in (
                (8, 3), (6, 2), (8, 0), (4, 0)):
            raise ConfigError(
                f"unsupported quantization format q_bits={self.q_bits} "
                f"mantissa_bits={self.mantissa_bits}; supported: (8,3)=fp8 "
                "e4m3, (6,2)=fp6 e3m2, (8,0)=int8, (4,0)=int4")
        if self.group_size <= 0 or self.group_size % 4:
            raise ConfigError(
                f"group_size must be a positive multiple of 4 (fp6 packs 4 "
                f"codes per 3 bytes), got {self.group_size}")


@dataclass
class LoRAConfig(DSConfigModel):
    """LoRA adapter spec (reference ``linear/config.py:60``)."""

    enabled: bool = False
    lora_r: int = 64
    lora_alpha: float = 16.0
    base_weight_sharding: int = 1
    target_modules: List[str] = field(
        default_factory=lambda: list(DEFAULT_TARGET_MODULES))
    #: store the frozen base quantized (dequantized on the fly in forward)
    quantize_base: bool = False
    quantization: QuantizationConfig = field(
        default_factory=QuantizationConfig)

    def validate(self) -> None:
        if isinstance(self.quantization, dict):  # as pydantic takes it
            self.quantization = QuantizationConfig.from_dict(
                self.quantization)
        if self.lora_r <= 0:
            raise ConfigError(f"lora_r must be positive, got {self.lora_r}")
        if self.base_weight_sharding < 0:
            raise ConfigError("base_weight_sharding must be >= 0")

    @property
    def scaling(self) -> float:
        return float(self.lora_alpha) / float(self.lora_r)


@dataclass
class PEFTConfig(DSConfigModel):
    """The root config's ``"peft"`` block."""

    lora: LoRAConfig = field(default_factory=LoRAConfig)
