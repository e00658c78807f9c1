"""``deepspeed_tpu_torch.linear`` — the port of ``deepspeed_tpu/linear/``:
LoRA with a dense or quantized frozen base (``LoRAConfig``,
``QuantizationConfig``, ``LoRAWeight``, ``OptimizedLinear``), adapter-only
checkpoints and merged export, and the self-draft speculation heads.

The heads' module imports the model, whose import chain reaches the root
config, which imports :mod:`.config`; so it loads at first use."""

from .config import (DEFAULT_TARGET_MODULES, LoRAConfig, PEFTConfig,
                     QuantizationConfig)
from .optimized_linear import (ADAPTER_LEAF_KEYS, LoRAWeight, OptimizedLinear,
                               QuantizedBaseWeight, adapter_only_flat,
                               apply_lora, graft_adapter_pack, has_lora,
                               init_lora_weight, lora_forward,
                               merge_lora_weights, merge_trainable,
                               quantize_base_weight, trainable_mask,
                               trainable_subtree, tree_leaves, tree_map)

_SPEC_HEADS = ("apply_spec_heads", "greedy_rollouts", "init_spec_heads",
               "train_spec_heads")


def __getattr__(name):
    if name in _SPEC_HEADS:
        from . import spec_heads

        return getattr(spec_heads, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ADAPTER_LEAF_KEYS", "DEFAULT_TARGET_MODULES", "LoRAConfig",
    "LoRAWeight", "OptimizedLinear", "PEFTConfig", "QuantizationConfig",
    "QuantizedBaseWeight", "adapter_only_flat", "apply_lora",
    "apply_spec_heads", "graft_adapter_pack", "greedy_rollouts",
    "has_lora", "init_lora_weight", "init_spec_heads", "lora_forward",
    "merge_lora_weights", "merge_trainable", "quantize_base_weight",
    "train_spec_heads", "trainable_mask", "trainable_subtree",
    "tree_leaves", "tree_map",
]
