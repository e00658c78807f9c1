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
  outputs, by a selective-checkpoint policy over the dispatcher's ops;
- ``cpu_checkpointing`` (the reference's
  ``save_and_offload_only_these_names`` over ``attn_out``, ``mlp_out`` and
  ``ckpt``): the tensors :func:`checkpoint_name` tags with those names are
  kept in page-locked host memory between the forward and the backward
  (packed by ``torch.autograd.graph.saved_tensors_hooks``, copied back to
  the device when the backward reads them) and everything else is
  recomputed.  torch's selective-checkpoint policies choose by op, not by
  name, so :func:`checkpoint` under this policy runs ``fn`` under hooks of
  its own: a saved tensor whose storage a tag named goes to the host, any
  other is dropped and recomputed by running ``fn`` again from its inputs
  at the backward's first read (as ``torch.utils.checkpoint`` does; a
  Python function cannot be resumed at a tag, so the recompute runs all of
  ``fn`` and drops its copies of the tagged tensors).  A tagged tensor no
  backward reads is not kept at all: the model's ``attn_out`` and
  ``mlp_out`` feed only residual adds, so over a decoder layer nothing
  goes to the host and the policy costs what ``nothing_saveable`` costs
  (the reference saves them for its recompute of the adds, which reruns
  the attention for its own backward all the same).
  ``HOST_SAVED`` counts the tensors and bytes packed to the host.

:func:`checkpoint_name` tags a value as the reference's does; outside a
``cpu_checkpointing`` checkpoint a tag changes nothing, so it returns its
input.  The model's ``save_attn`` / ``save_attn_mlp`` keep the tagged
values by checkpointing the segments around them.
``partition_activations`` (the residuals sharded over tp/sp) is refused
naming ROADMAP.md A13 (multi-GPU).  The reference's RNG trackers have no
counterpart: the port's random streams are explicit generators, so a
recompute draws what the forward drew.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

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

#: the ``cpu_checkpointing`` policy's name (the reference's optax-free
#: ``jax.checkpoint_policies`` function of that name)
CPU_POLICY = "save_and_offload_only_these_names"
#: the tags whose tensors ``cpu_checkpointing`` keeps on the host
OFFLOADED_NAMES = ("attn_out", "mlp_out", "ckpt")
#: tensors and bytes packed to the host by ``cpu_checkpointing``
HOST_SAVED = {"tensors": 0, "bytes": 0}

_config = ActivationCheckpointingConfig()
_SCOPES: List["_HostScope"] = []


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
        return CPU_POLICY
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
        return checkpoint(lambda *a: fn(*a, **kwargs), *args, cfg=cfg)
    if policy == CPU_POLICY:
        return _HostScope(fn).run(args)
    return _checkpointed(fn, policy)(*args)


def checkpoint_name(x: Any, name: str = "ckpt") -> Any:
    """Tag an intermediate by name (``jax.ad_checkpoint.checkpoint_name``).
    Inside a ``cpu_checkpointing`` checkpoint, a tensor tagged with one of
    :data:`OFFLOADED_NAMES` is kept on the host for the backward; the
    value is returned as it is."""
    if _SCOPES and name in OFFLOADED_NAMES:
        _SCOPES[-1].tag(x)
    return x


class _HostScope:
    """One ``cpu_checkpointing`` call of ``fn``: its saved tensors are
    packed to the host (tagged) or dropped for a recompute (the rest)."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.storages: set = set()
        self.tagged: list = []
        self.recomputed: Optional[list] = None

    def tag(self, x: Any) -> None:
        import torch

        if isinstance(x, torch.Tensor):
            # held until ``fn`` returns, so no later tensor takes its memory
            # and passes for it
            self.tagged.append(x)
            self.storages.add(x.untyped_storage().data_ptr())

    def run(self, args: tuple) -> Any:
        import torch

        self.args = [a.detach().requires_grad_(a.requires_grad)
                     if isinstance(a, torch.Tensor) else a for a in args]
        count = [0]

        def pack(t):
            k = count[0]
            count[0] += 1
            if t.untyped_storage().data_ptr() not in self.storages:
                return ("recompute", k)
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=(
                t.device.type == "cuda"))
            host.copy_(t.detach(), non_blocking=True)
            HOST_SAVED["tensors"] += 1
            HOST_SAVED["bytes"] += host.numel() * host.element_size()
            return ("host", host, t.device)

        _SCOPES.append(self)
        try:
            with torch.autograd.graph.saved_tensors_hooks(pack, self._unpack):
                return self.fn(*args)
        finally:
            _SCOPES.pop()
            self.storages, self.tagged = set(), []

    def _unpack(self, handle):
        if handle[0] == "host":
            return handle[1].to(handle[2], non_blocking=True)
        if self.recomputed is None:
            self._recompute()
        return self.recomputed[handle[1]]

    def _recompute(self) -> None:
        """Run ``fn`` again on its inputs, keeping every tensor it saves,
        in the order the forward saved them."""
        import torch

        saved: list = []

        def keep(t):
            saved.append(t.detach())
            return None

        with torch.enable_grad(), \
                torch.autograd.graph.saved_tensors_hooks(keep, lambda _: None):
            self.fn(*self.args)
        self.recomputed = saved
