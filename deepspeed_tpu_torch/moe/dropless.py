"""Dropless MoE dispatch through the grouped GEMM — the port of
``deepspeed_tpu/moe/dropless.py``.

Every top-k assignment is computed: tokens are scattered once into the
tile-aligned grouped layout (``ops/hopper/grouped_matmul.py``), the expert
FFN runs as three grouped GEMMs (w_gate, w_in, w_out), and the weighted
expert outputs are added back per token.  Step for step the reference:
f32 router, top-k of the softmax, gates renormalised, cast to the compute
dtype before the multiply, and the combine adds a token's k weighted rows
in assignment order in the compute dtype, as the reference's scatter-add
``y.at[token_flat].add(weighted)`` does (no atomics: deterministic for any
k).

The layout's m-tile is the CUDA kernel's row block, not the TPU's 512
(:func:`default_tile_m`): at a decode body's 16 assignments the TPU tile
would make 4608 rows for 16 real ones.  ``y`` does not depend on it
(padding rows are zero and are dropped).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.hopper.grouped_matmul import grouped_matmul, tile_aligned_layout
from .layer import one_hot


def default_tile_m(T: int, num_experts: int) -> int:
    """The layout's m-tile for ``T`` assignments: 16 rows (the kernel's
    small row block) while an expert gets 16 or fewer on average, as in a
    decode body, else 64."""
    return 16 if T <= 16 * num_experts else 64


def dropless_moe_block_with_losses(x: torch.Tensor, p: Dict[str, Any], cfg,
                                   tile_m: Optional[int] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """x: (B, S, H) → (y, aux_loss, z_loss); the router losses as in
    ``moe/layer.py`` (Switch aux loss + St-MoE z-loss)."""
    B, S, H = x.shape
    E, k = cfg.num_experts, cfg.moe_top_k
    dt = x.dtype

    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, -1)  # (B, S, E)
    z_loss = (torch.logsumexp(logits, -1) ** 2).mean()
    gate_vals, gate_idx = torch.topk(probs, k, -1)  # (B, S, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)

    me = probs.mean((0, 1))
    ce = one_hot(gate_idx[..., 0], E).mean((0, 1))
    aux_loss = E * (me * ce).sum()

    BS = B * S
    T = BS * k
    if tile_m is None:
        tile_m = default_tile_m(T, E)
    expert_flat = gate_idx.reshape(T)
    gates_flat = gate_vals.reshape(T)
    positions, tile_group, pad_sizes, M_pad, used = tile_aligned_layout(
        expert_flat, E, T, tile_m, with_used_tiles=True)
    positions = positions.long()

    # assignment a = t * k + j belongs to token t (the reference's
    # token_flat = repeat(arange(B S), k))
    x_tok = x.reshape(BS, 1, H).expand(BS, k, H).reshape(T, H)
    xs = x.new_zeros((M_pad, H)).index_put((positions,), x_tok)

    def gmm(a, w_key):
        return grouped_matmul(a, p[w_key].to(dt), tile_group, pad_sizes,
                              tile_m=tile_m, num_used_tiles=used)

    if "w_gate" in p:
        hmid = F.silu(gmm(xs, "w_gate")) * gmm(xs, "w_in")
    else:
        hmid = F.gelu(gmm(xs, "w_in"), approximate="tanh")
    ys = gmm(hmid, "w_out")  # (M_pad, H)

    weighted = (ys[positions] * gates_flat[:, None].to(dt)).view(BS, k, H)
    y = weighted[:, 0]
    for j in range(1, k):  # the scatter-add's order, one rounding per add
        y = y + weighted[:, j]
    return y.reshape(B, S, H), aux_loss, z_loss
