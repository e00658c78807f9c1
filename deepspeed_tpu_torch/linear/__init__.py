"""``deepspeed_tpu_torch.linear`` — the port of ``deepspeed_tpu/linear/``:
the self-draft speculation heads and the trainable-mask partition they
train through.  LoRA (``LoRAConfig``, ``OptimizedLinear``, quantized
bases) arrives with ROADMAP.md queue A item A14."""

from .optimized_linear import (merge_trainable, trainable_subtree,
                               tree_leaves, tree_map)
from .spec_heads import (apply_spec_heads, greedy_rollouts, init_spec_heads,
                         train_spec_heads)

__all__ = ["apply_spec_heads", "greedy_rollouts", "init_spec_heads",
           "merge_trainable", "train_spec_heads", "trainable_subtree",
           "tree_leaves", "tree_map"]
