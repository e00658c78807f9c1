"""Sequence-tiled compute — the port of
``deepspeed_tpu/sequence/tiled_compute.py``.

Position-wise work (an MLP, the logits and cross entropy) runs one sequence
tile at a time under ``torch.utils.checkpoint``, so backward recomputes
each tile instead of keeping its intermediates (the reference scans a
``jax.checkpoint``-ed body).  For the loss this means the (B, S, V) logits
never exist: one tile's (B, tile, V) at a time, in forward and again in
backward.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint


def tiled_map(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
              tile_size: int, axis: int = 1) -> torch.Tensor:
    """Apply a position-wise, shape-preserving ``fn`` over tiles of ``x``
    along ``axis``, each tile checkpointed."""
    S = x.shape[axis]
    if tile_size >= S:
        return fn(x)
    if S % tile_size != 0:
        raise ValueError(
            f"tiled_map: sequence length {S} not divisible by tile_size "
            f"{tile_size}; pick a divisor (silent untiled fallback would "
            "defeat the memory cap)")
    return torch.cat([checkpoint(fn, t, use_reentrant=False)
                      for t in x.split(tile_size, dim=axis)], dim=axis)


def tiled_mlp(x: torch.Tensor, p: Dict[str, Any], cfg, tile_size: int
              ) -> torch.Tensor:
    """Tiled SwiGLU/GELU MLP. x: (B, S, H)."""
    from ..models.transformer import _mlp_block

    return tiled_map(lambda t: _mlp_block(t, p, cfg), x, tile_size, axis=1)


def _tile_loss(xi, w, li, mi, transpose_head: bool, head_bias):
    from ..models.transformer import cross_entropy_sums

    logits = xi @ (w.T if transpose_head else w)
    if head_bias is not None:
        logits = logits + head_bias.to(logits.dtype)
    nll, correct = cross_entropy_sums(logits, li)
    return (nll * mi).sum(), (correct * mi).sum()


def tiled_logits_loss(x: torch.Tensor, embed_or_head: torch.Tensor,
                      labels: torch.Tensor, tile_size: int,
                      mask: Optional[torch.Tensor] = None,
                      transpose_head: bool = False,
                      head_bias: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused tiled cross entropy.  x: (B, S, H) final hidden states;
    ``embed_or_head``: the (V, H) embedding (tied, ``transpose_head=True``)
    or the (H, V) head.  Returns (sum_nll, sum_correct) without
    materialising (B, S, V) logits."""
    S = x.shape[1]
    if tile_size > S:
        tile_size = S
    elif S % tile_size != 0:
        raise ValueError(
            f"tiled_logits_loss: sequence length {S} not divisible by "
            f"tile_size {tile_size}; pick a divisor (an untiled fallback "
            "would materialize the full (B,S,V) logits)")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    mask = mask.float()
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    correct_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for xi, li, mi in zip(x.split(tile_size, 1), labels.split(tile_size, 1),
                          mask.split(tile_size, 1)):
        nll, correct = checkpoint(_tile_loss, xi, embed_or_head, li, mi,
                                  transpose_head, head_bias,
                                  use_reentrant=False)
        nll_sum = nll_sum + nll
        correct_sum = correct_sum + correct
    return nll_sum, correct_sum


def tiled_loss_fn(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
                  cfg, tile_size: int = 2048, attn_fn=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Drop-in replacement for ``models.transformer.loss_fn`` with the final
    logits and cross entropy computed tile by tile."""
    from ..models import transformer as tfm

    labels, mask = tfm.shift_labels(batch)
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    x = tfm.forward_hidden(params, batch["input_ids"], cfg, attn_fn=attn_fn)
    w, tied, hb = tfm.lm_head(params, cfg, tfm.torch_dtype(cfg.dtype))
    nll_sum, correct_sum = tiled_logits_loss(
        x, w, labels, tile_size, mask=mask, transpose_head=tied,
        head_bias=hb)
    denom = mask.float().sum().clamp(min=1.0)
    loss = nll_sum / denom
    return loss, {"loss": loss, "accuracy": correct_sum / denom,
                  "tokens": denom}
