"""ZeRO on one device — the port of ``deepspeed_tpu/runtime/zero``.

The offload tiers (``offload.py``, ``param_offload.py``) run at stage 0.
The reference's package also re-exports ``sharding`` (the ZeRO 1-3
sharding rules and ``zero.Init``), which shards state across devices and
arrives with ROADMAP.md A13 (multi-GPU): those names import, and raise
``NotImplementedError`` naming A13 when used.
"""

from .offload import OffloadedOptimizer
from .param_offload import (HostArena, LayerStreamer, ParamSwapper,
                            maybe_stream_in, offload_mask)


def _a13(name: str):
    def refuse(*args, **kwargs):
        raise NotImplementedError(
            f"deepspeed_tpu_torch.runtime.zero.{name} shards state across "
            "GPUs; it arrives with ROADMAP.md A13 (multi-GPU)")

    refuse.__name__ = name
    return refuse


ShardingRules = _a13("ShardingRules")
default_rules = _a13("default_rules")
rules_for_params = _a13("rules_for_params")
rules_for_optimizer = _a13("rules_for_optimizer")
logical_to_sharding = _a13("logical_to_sharding")
shard_pytree = _a13("shard_pytree")
sharding_for_tree = _a13("sharding_for_tree")
Init = _a13("Init")

__all__ = [
    "OffloadedOptimizer", "HostArena", "LayerStreamer", "ParamSwapper",
    "maybe_stream_in", "offload_mask",
    "ShardingRules", "default_rules", "rules_for_params",
    "rules_for_optimizer", "logical_to_sharding", "shard_pytree",
    "sharding_for_tree", "Init",
]
