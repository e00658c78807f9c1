"""ZeRO — the port of ``deepspeed_tpu/runtime/zero``: the sharding rules
of stages 1-3 and ``zero.Init`` (``sharding.py``), qwZ's quantized
gathers (``qwz.py``), and the offload tiers (``offload.py``,
``param_offload.py``), which run at stage 0."""

from .offload import OffloadedOptimizer
from .param_offload import (HostArena, LayerStreamer, ParamSwapper,
                            maybe_stream_in, offload_mask)
from .sharding import (
    ShardingRules,
    default_rules,
    rules_for_params,
    rules_for_optimizer,
    logical_to_sharding,
    shard_accounting,
    shard_pytree,
    sharding_for_tree,
    Init,
)

__all__ = [
    "OffloadedOptimizer", "HostArena", "LayerStreamer", "ParamSwapper",
    "maybe_stream_in", "offload_mask",
    "ShardingRules", "default_rules", "rules_for_params",
    "rules_for_optimizer", "logical_to_sharding", "shard_accounting",
    "shard_pytree", "sharding_for_tree", "Init",
]
