"""Mixture-of-Experts layer — the port of ``deepspeed_tpu/moe/layer.py``.

* gating: top-k softmax routing with capacity-factor token dropping, the
  Switch load-balancing loss and the St-MoE router z-loss
  (:func:`top_k_gating`); expert-choice routing (:func:`expert_choice_gating`);
* :func:`moe_block_with_losses` / :func:`dense_moe_block`: the capacity
  buckets dispatched and combined with one-hot einsums, or, with
  ``moe_routing='dropless'``, the grouped-GEMM path of ``moe/dropless.py``;
  PR-MoE's shared expert (:func:`_prmoe_combine`) on top of either.

Plain torch, as the reference is plain XLA: no kernel here (the dropless
path's grouped GEMM is in ``ops/hopper/grouped_matmul.py``).  The dtypes
are the reference's: the router matmul, softmax and logsumexp in f32, the
dispatch and combine tensors cast to the compute dtype before the einsums.
One-hots are comparisons against an ``arange`` (``F.one_hot`` checks its
range on the host), so routing never waits for the device.  The
expert-parallel all-to-all path (``sharded_moe.py``) needs a GPU group and
waits for ``ROADMAP.md`` A13.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


class GateOutput(NamedTuple):
    combine_weights: torch.Tensor  # (B, S, E, C) float
    dispatch_mask: torch.Tensor  # (B, S, E, C) bool
    aux_loss: torch.Tensor  # scalar
    z_loss: torch.Tensor  # scalar
    load: torch.Tensor  # (E,) fraction of tokens routed per expert


def one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot(idx, n)``: f32, all zeros for an index outside
    [0, n), without a host-side range check."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def top_k_gating(logits: torch.Tensor, num_experts: int, top_k: int,
                 capacity_factor: float, min_capacity: int = 4,
                 rng: Optional[torch.Generator] = None,
                 noise_std: float = 0.0) -> GateOutput:
    """logits: (B, S, E).  Capacity-bucketed dispatch/combine tensors, the
    reference's capacity math (capacity = S k cf / E, at least
    ``min_capacity``) and slot assignment (a token's slot in its expert's
    bucket = tokens routed there earlier in the sequence this round + the
    slots used by earlier top-k rounds)."""
    B, S, E = logits.shape
    capacity = max(int(S * top_k * capacity_factor / num_experts),
                   min_capacity)
    if noise_std > 0.0 and rng is not None:
        logits = logits + torch.randn(
            logits.shape, generator=rng, device=logits.device,
            dtype=logits.dtype) * noise_std
    lf = logits.float()
    raw_probs = torch.softmax(lf, -1)  # (B, S, E)
    z_loss = (torch.logsumexp(lf, -1) ** 2).mean()
    gate_vals, gate_idx = torch.topk(raw_probs, top_k, -1)  # (B, S, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)

    me = raw_probs.mean((0, 1))  # (E,) mean router prob
    ce = one_hot(gate_idx[..., 0], E).mean((0, 1))  # (E,) top-1 fraction
    aux_loss = num_experts * (me * ce).sum()

    combine = torch.zeros((B, S, E, capacity), dtype=torch.float32,
                          device=logits.device)
    dispatch = torch.zeros((B, S, E, capacity), dtype=torch.bool,
                           device=logits.device)
    for slot in range(top_k):
        oh = one_hot(gate_idx[..., slot], E)  # (B, S, E)
        before = torch.cumsum(oh, 1) - oh  # same-round tokens ahead
        prev_used = dispatch.sum((1, 3)).float()[:, None, :]  # (B, 1, E)
        pos = before + prev_used
        keep = (pos < capacity) & (oh > 0)
        pos_cl = pos.clamp(0, capacity - 1).long()
        sel = one_hot(pos_cl, capacity) * keep[..., None]  # (B, S, E, C)
        dispatch = dispatch | (sel > 0)
        combine = combine + sel * gate_vals[..., slot][..., None, None]
    load = dispatch.any(-1).float().mean((0, 1))
    return GateOutput(combine, dispatch, aux_loss, z_loss, load)


def expert_choice_gating(logits: torch.Tensor, num_experts: int,
                         capacity_factor: float, min_capacity: int = 4
                         ) -> GateOutput:
    """Expert-choice routing: each expert takes its top-C tokens of the
    sequence (C = S cf / E, at least ``min_capacity``, at most S), weighted
    by its router probability; no auxiliary loss.  Non-causal: the
    inference engines refuse it."""
    B, S, E = logits.shape
    capacity = min(max(int(S * capacity_factor / num_experts), min_capacity),
                   S)
    lf = logits.float()
    probs = torch.softmax(lf, -1)  # (B, S, E)
    z_loss = (torch.logsumexp(lf, -1) ** 2).mean()
    vals, idx = torch.topk(probs.transpose(1, 2), capacity, -1)  # (B, E, C)
    # (B, S, E, C): token s fills expert e's slot c iff idx[b, e, c] == s
    dispatch = one_hot(idx, S).permute(0, 3, 1, 2) > 0
    combine = dispatch * vals[:, None, :, :]
    load = dispatch.any(-1).float().mean((0, 1))
    return GateOutput(combine.float(), dispatch,
                      torch.zeros((), dtype=torch.float32,
                                  device=logits.device), z_loss, load)


def dense_moe_block(x: torch.Tensor, p: Dict[str, Any], cfg) -> torch.Tensor:
    """The MoE FFN with its router losses discarded (``moe_block_with_losses``
    returns them)."""
    y, _, _ = moe_block_with_losses(x, p, cfg)
    return y


def moe_block_with_losses(x: torch.Tensor, p: Dict[str, Any], cfg
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, H) → (y, aux_loss, z_loss) for ``cfg.moe_routing``:
    'capacity' (top-k with capacity buckets), 'expert_choice', or
    'dropless' (grouped GEMM, ``moe/dropless.py``)."""
    routing = getattr(cfg, "moe_routing", "capacity")
    if routing == "dropless":
        from .dropless import dropless_moe_block_with_losses

        y, aux, z = dropless_moe_block_with_losses(x, p, cfg)
        if getattr(cfg, "moe_use_residual", False):
            y = _prmoe_combine(x, y, p, cfg)
        return y, aux, z
    dt = x.dtype
    E = cfg.num_experts
    logits = x.float() @ p["router"].float()
    if routing == "expert_choice":
        gate = expert_choice_gating(logits, E, cfg.moe_capacity_factor)
    else:
        gate = top_k_gating(logits, E, cfg.moe_top_k, cfg.moe_capacity_factor)
    disp = gate.dispatch_mask.to(dt)
    comb = gate.combine_weights.to(dt)
    xe = torch.einsum("bsec,bsh->ebch", disp, x)
    w_in = p["w_in"].to(dt)
    if "w_gate" in p:
        hmid = F.silu(torch.einsum("ebch,ehf->ebcf", xe, p["w_gate"].to(dt))) \
            * torch.einsum("ebch,ehf->ebcf", xe, w_in)
    else:
        hmid = F.gelu(torch.einsum("ebch,ehf->ebcf", xe, w_in),
                      approximate="tanh")
    ye = torch.einsum("ebcf,efh->ebch", hmid, p["w_out"].to(dt))
    y = torch.einsum("bsec,ebch->bsh", comb, ye)
    if getattr(cfg, "moe_use_residual", False):
        y = _prmoe_combine(x, y, p, cfg)
    return y, gate.aux_loss, gate.z_loss


def _prmoe_combine(x: torch.Tensor, moe_out: torch.Tensor,
                   p: Dict[str, Any], cfg) -> torch.Tensor:
    """PR-MoE / residual MoE: a dense shared-expert MLP on every token,
    mixed with the MoE output by a learned per-token 2-way softmax,
    ``out = mlp c0 + moe c1``."""
    dt = x.dtype
    if "res_w_gate" in p:
        hmid = F.silu(x @ p["res_w_gate"].to(dt)) * (x @ p["res_w_in"].to(dt))
    else:
        hmid = F.gelu(x @ p["res_w_in"].to(dt), approximate="tanh")
    mlp_out = hmid @ p["res_w_out"].to(dt)
    coef = torch.softmax(x.float() @ p["coef"].float(), -1)
    return mlp_out * coef[..., 0:1].to(dt) + moe_out * coef[..., 1:2].to(dt)
