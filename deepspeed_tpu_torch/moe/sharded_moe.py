"""Expert-parallel MoE with an explicit all-to-all — the port of
``deepspeed_tpu/moe/sharded_moe.py``, not ported yet.

The reference shuffles tokens with ``lax.all_to_all`` over the ``ep`` mesh
axis inside ``shard_map``; the port needs a process group of GPUs for that,
which arrives with the multi-GPU item (``ROADMAP.md`` A13).  On one device
``moe/layer.py`` serves and trains every routing (capacity, dropless,
expert choice, PR-MoE); pass nothing as ``moe_fn`` to use it.
"""

from __future__ import annotations

from typing import Any, Dict

import torch


def sharded_moe_block(x: torch.Tensor, p: Dict[str, Any], cfg
                      ) -> torch.Tensor:
    raise NotImplementedError(
        "sharded_moe_block shuffles tokens over an expert-parallel ('ep') "
        "group of GPUs; it arrives with the multi-GPU item (ROADMAP.md "
        "A13). On one device, moe/layer.py's dense_moe_block serves every "
        "routing")
