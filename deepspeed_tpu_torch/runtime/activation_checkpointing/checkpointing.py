"""Activation checkpointing — the port of
``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py``.

The reference maps DeepSpeed's ``checkpointing.checkpoint(fn, *args)`` onto
``jax.checkpoint`` with a named policy; the port maps it onto
``torch.utils.checkpoint`` (non-reentrant), the mechanism the model's
remat policies use (``models/transformer.py``):

- ``everything``: ``fn`` runs as it is, every activation saved;
- ``nothing`` / ``nothing_saveable``: everything recomputed in backward;
- ``dots`` / ``dots_saveable`` and ``dots_with_no_batch_dims`` /
  ``dots_with_no_batch_dims_saveable``: recomputed except the matmul
  outputs, by a selective-checkpoint policy over the dispatcher's ops.

:func:`checkpoint_name` tags a value as the reference's does.  Under these
policies a tag changes nothing in either package (only the reference's
``cpu_checkpointing`` policy reads tags), so it returns its input; the
model's ``save_attn`` / ``save_attn_mlp`` keep the tagged values by
checkpointing the segments around them.

``cpu_checkpointing`` (the saved residuals offloaded to pinned host
memory) is refused naming ROADMAP.md A14 (offload), ``partition_activations``
(the residuals sharded over tp/sp) naming A13 (multi-GPU).  The reference's
RNG trackers have no counterpart: the port's random streams are explicit
generators, so a recompute draws what the forward drew.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from ..config import ActivationCheckpointingConfig

#: the reference's ``get_policy`` names -> the model's remat policy names
POLICIES = {
    "everything": "everything",
    "nothing": "nothing_saveable",
    "nothing_saveable": "nothing_saveable",
    "dots": "dots_saveable",
    "dots_saveable": "dots_saveable",
    "dots_with_no_batch_dims": "dots_with_no_batch_dims_saveable",
    "dots_with_no_batch_dims_saveable": "dots_with_no_batch_dims_saveable",
}

_config = ActivationCheckpointingConfig()


def configure(config: Optional[ActivationCheckpointingConfig] = None,
              **kwargs) -> None:
    """Reference: ``checkpointing.configure``."""
    global _config
    if config is not None:
        _config = config
    for k, v in kwargs.items():
        setattr(_config, k, v)


def get_policy(cfg: Optional[ActivationCheckpointingConfig] = None) -> str:
    """The remat policy name the config asks for (the reference returns the
    ``jax.checkpoint_policies`` function of the same name)."""
    cfg = cfg or _config
    if cfg.cpu_checkpointing:
        raise NotImplementedError(
            "activation_checkpointing.cpu_checkpointing offloads the saved "
            "residuals to host memory; it arrives with ROADMAP.md A14 "
            "(offload)")
    if cfg.partition_activations:
        raise NotImplementedError(
            "activation_checkpointing.partition_activations shards the "
            "saved residuals over tp/sp; it arrives with ROADMAP.md A13 "
            "(multi-GPU)")
    if cfg.policy not in POLICIES:
        raise ValueError(
            f"unknown activation-checkpoint policy {cfg.policy!r}")
    return POLICIES[cfg.policy]


def checkpoint(fn: Callable, *args,
               cfg: Optional[ActivationCheckpointingConfig] = None,
               **kwargs) -> Any:
    """Reference surface: ``deepspeed.checkpointing.checkpoint(fn, *args)``
    — run ``fn`` under remat with the configured policy."""
    import torch

    from ...models.transformer import _checkpointed

    policy = get_policy(cfg)
    if policy == "everything" or not torch.is_grad_enabled():
        return fn(*args, **kwargs)
    if kwargs:
        return _checkpointed(lambda *a: fn(*a, **kwargs), policy)(*args)
    return _checkpointed(fn, policy)(*args)


def checkpoint_name(x: Any, name: str = "ckpt") -> Any:
    """Tag an intermediate by name (``jax.ad_checkpoint.checkpoint_name``):
    the value itself, as in the reference under every policy the port
    runs."""
    del name
    return x
