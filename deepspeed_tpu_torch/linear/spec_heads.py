"""Self-draft speculation heads (Medusa-style) — the port of
``deepspeed_tpu/linear/spec_heads.py``.

Head ``i`` (0-based) is a residual block and an output projection applied
to the base model's final-norm hidden state ``h`` at position ``p``::

    logits_i = (h + silu(h @ w1[i] + b1[i])) @ w2[i]

and predicts the token at position ``p + 2 + i``: one past the base lm
head's own prediction, so ``k`` heads propose ``k`` speculative tokens from
one hidden state with no extra forward pass (the engine carries ``h``
across steps, ``inference/v2/spec.py``).  Heads are f32 whatever the
base's dtype.

Training is frozen-base: the head leaves are split out of ``{"base",
"heads"}`` with :func:`~.optimized_linear.trainable_subtree`, and only
they reach ``torch.optim.Adam`` (optax's defaults: betas 0.9 / 0.999, eps
1e-8).  Batches are drawn with an explicit ``torch.Generator``, so a run
is deterministic per seed, but not the reference's draws.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models import transformer as tfm
from .optimized_linear import (merge_trainable, trainable_subtree, tree_leaves,
                               tree_map)

__all__ = ["init_spec_heads", "apply_spec_heads", "train_spec_heads",
           "greedy_rollouts"]


def _lm_head_f32(params: Dict[str, Any], cfg: tfm.TransformerConfig
                 ) -> torch.Tensor:
    """The base model's lm head as an f32 (H, V) matrix."""
    if cfg.tie_embeddings:
        return params["embed"]["tokens"].float().T
    return params["lm_head"]["w"].float()


def init_spec_heads(generator: torch.Generator,
                    model_cfg: tfm.TransformerConfig, k: int,
                    base_params: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, torch.Tensor]:
    """Stacked head params ``{"w1": (k, H, H), "b1": (k, H), "w2": (k, H,
    V)}`` in f32 on ``generator``'s device.

    ``w1`` starts at ``0.01 * normal`` and ``b1`` at zero (the residual
    block is nearly the identity); ``w2`` copies the base lm head when
    ``base_params`` is given (untrained heads then propose the base's own
    next-token distribution), else ``0.02 * normal``."""
    if k <= 0:
        raise ValueError(f"spec heads need k >= 1, got {k}")
    H, V = model_cfg.hidden_size, model_cfg.vocab_size
    dev = generator.device
    w1 = 0.01 * torch.randn((k, H, H), generator=generator, device=dev)
    if base_params is not None:
        lm = _lm_head_f32(base_params, model_cfg).to(dev)
        w2 = lm[None].expand(k, H, V).clone()
    else:
        w2 = 0.02 * torch.randn((k, H, V), generator=generator, device=dev)
    return {"w1": w1, "b1": torch.zeros((k, H), device=dev), "w2": w2}


def apply_spec_heads(heads: Dict[str, torch.Tensor], h: torch.Tensor
                     ) -> torch.Tensor:
    """h (..., H) -> per-head logits (..., k, V), computed in f32."""
    h = h.float()
    z = torch.einsum("...h,khj->...kj", h, heads["w1"]) + heads["b1"]
    hh = h[..., None, :] + F.silu(z)
    return torch.einsum("...kh,khv->...kv", hh, heads["w2"])


@torch.no_grad()
def greedy_rollouts(params: Dict[str, Any], model_cfg: tfm.TransformerConfig,
                    prompts: List[List[int]], n_new: int) -> torch.Tensor:
    """Greedy continuations from the uncached forward: the distillation
    corpus matching the engine's own greedy decode.  Returns
    (len(prompts), prompt_len + n_new) int64 on the params' device (the
    prompts share one length)."""
    (plen,) = {len(p) for p in prompts}
    dev = params["embed"]["tokens"].device
    toks = torch.tensor(prompts, dtype=torch.long, device=dev)
    for _ in range(n_new):
        logits = tfm.forward(params, toks, model_cfg)
        toks = torch.cat([toks, logits[:, -1].argmax(-1)[:, None]], dim=1)
    assert toks.shape == (len(prompts), plen + n_new)
    return toks


def train_spec_heads(base_params: Dict[str, Any],
                     heads: Dict[str, torch.Tensor],
                     model_cfg: tfm.TransformerConfig,
                     data: torch.Tensor, *, steps: int = 100,
                     lr: float = 1e-2, batch_size: int = 8,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[Dict[str, torch.Tensor], List[float]]:
    """Distill the heads on token sequences ``data`` (N, S) with the base
    frozen: head ``i``'s logits at position ``p`` take cross-entropy
    against ``data[:, p + 2 + i]``.  Only the head leaves reach the
    optimizer (the base's leaves are ``None`` in the trainable tree).
    Returns the trained heads (new tensors; ``heads`` is untouched) and the
    loss of each step."""
    k = int(heads["w1"].shape[0])
    S = int(data.shape[1])
    if S < k + 2:
        raise ValueError(f"need sequences of >= k+2={k + 2} tokens, got {S}")
    dev = heads["w1"].device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    full = {"base": base_params, "heads": heads}
    mask = {"base": tree_map(lambda _: False, base_params),
            "heads": {key: True for key in heads}}
    trainable = trainable_subtree(full, mask)
    trainable["heads"] = {key: v.detach().clone().requires_grad_(True)
                          for key, v in trainable["heads"].items()}
    opt = torch.optim.Adam(tree_leaves(trainable), lr=lr,
                           betas=(0.9, 0.999), eps=1e-8)
    data = data.to(dev).long()
    n = int(data.shape[0])
    losses: List[float] = []
    for _ in range(steps):
        idx = torch.randint(0, n, (min(batch_size, n),), generator=generator,
                            device=dev)
        batch = data[idx]
        merged = merge_trainable(trainable, full, mask)
        with torch.no_grad():  # the frozen base
            h = tfm.forward_hidden(merged["base"], batch, model_cfg)
        logits = apply_spec_heads(merged["heads"], h)  # (B, S, k, V)
        total, count = 0.0, 0
        for i in range(k):
            lp = F.log_softmax(logits[:, : S - 2 - i, i], dim=-1)
            tgt = batch[:, 2 + i:]
            ce = -lp.gather(-1, tgt[..., None])[..., 0]
            total = total + ce.sum()
            count += ce.numel()
        loss = total / count
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    return ({key: v.detach() for key, v in trainable["heads"].items()},
            losses)

