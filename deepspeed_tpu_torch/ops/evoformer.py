"""DS4Science evoformer attention — the port of
``deepspeed_tpu/ops/evoformer.py`` (``DS4Sci_EvoformerAttention``)::

    out = softmax(Q·Kᵀ / √D + bias1 + bias2) · V

q/k/v ``(B, N, L, H, D)`` (MSA row or column attention: N is the MSA depth
or the residue count; triangle attention: N = L); ``bias1`` ``(B, N, 1, 1,
L)``, a per-key mask bias; ``bias2`` ``(B, 1, H, L, L)``, a pair bias
shared across N.  Differentiable in all five inputs.

* **Forward**: ``(B, N, L, H, D)`` is the flash layout ``(B·N, L, H, D)``
  already, so nothing is transposed.  bias1 becomes the flash forward's
  ``bias_kv`` ``(B·N, L)`` and bias2 its ``bias_qk`` ``(B, H, L, L)``, which
  batch b·N + n reads as ``bias2[b]`` (no repeat over N).  On CUDA tensors
  :func:`~deepspeed_tpu_torch.ops.hopper.flash_attention.flash_fwd`
  launches the hand-written forward at every shape: the kernels mask the
  ragged edge, so the reference's XLA branch for lengths the TPU cannot
  tile has no counterpart.  On CPU tensors it runs the plain version.
* **Backward**: the reference's chunked recompute (``_evo_bwd``) in plain
  PyTorch, as the reference computes it in XLA outside any kernel: chunks
  over N sized by :func:`_chunk_size`, p = exp(s − lse) (0 where lse =
  −inf), and dq, dk, dv, dbias1 and dbias2 (summed over N) in f32, each
  returned in its input's dtype.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from .hopper.flash_attention import (AttnMask, flash_fwd, flash_fwd_plain,
                                     kernel_layout)

_NO_MASK = AttnMask(causal=False)


def _chunk_size(n: int, b: int, h: int, l_q: int, l_k: int,
                budget_bytes: int = 1 << 28) -> int:
    """Largest divisor of N whose per-chunk backward tiles fit the budget.

    Per N-row the backward materialises (B, H, Lq, Lk) float32 score-shaped
    tensors, and ~3 of them coexist (p, dp, ds) — budget all of them.
    """
    per_row = max(1, b * h * l_q * l_k * 4 * 3)
    cap = max(1, budget_bytes // per_row)
    for c in range(min(n, cap), 0, -1):
        if n % c == 0:
            return c
    return 1


def flash_args(q, k, v, b1=None, b2=None) -> tuple:
    """The flash forward's arguments for one evoformer call: ``(q, k, v,
    mask, sm_scale, bias_kv, bias_qk)`` with q, k, v ``(B·N, L, H, D)``,
    no mask, ``bias_kv`` ``(B·N, Lk)`` and ``bias_qk`` ``(B, H, Lq, Lk)``,
    each in the layout the kernels take (``kernel_layout``)."""
    B, N, Lq, H, D = q.shape
    Lk = k.shape[2]
    return (kernel_layout(q.reshape(B * N, Lq, H, D)),
            kernel_layout(k.reshape(B * N, Lk, H, D)),
            kernel_layout(v.reshape(B * N, Lk, H, D)), _NO_MASK,
            1.0 / math.sqrt(D),
            None if b1 is None else kernel_layout(b1.reshape(B * N, Lk)),
            None if b2 is None else kernel_layout(b2.reshape(B, H, Lq, Lk)))


def _forward(fwd, q, k, v, b1, b2) -> Tuple[torch.Tensor, torch.Tensor]:
    B, N, Lq, H, D = q.shape
    o, lse = fwd(*flash_args(q, k, v, b1, b2))
    return o.reshape(B, N, Lq, H, D), lse.reshape(B, N, H, Lq)


def evoformer_fwd(q, k, v, b1=None, b2=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out (B, N, Lq, H, D) in q's dtype, lse (B, N, H, Lq) f32)``
    through ``flash_fwd``: the kernel on CUDA tensors, the plain version on
    CPU tensors."""
    return _forward(flash_fwd, q, k, v, b1, b2)


def evoformer_fwd_plain(q, k, v, b1=None, b2=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`evoformer_fwd` through ``flash_fwd_plain`` on any device: the
    forward kernel's oracle on the card."""
    return _forward(flash_fwd_plain, q, k, v, b1, b2)


def evoformer_bwd(q, k, v, b1, b2, out, lse, g):
    """``(dq, dk, dv, dbias1, dbias2)`` of the loss with cotangent ``g``
    of ``out``, from the forward's ``out`` and ``lse``: the reference's
    ``_evo_bwd``, chunked over N, f32 inside.  An absent bias (None) gets
    None."""
    B, N, Lq, H, D = q.shape
    Lk = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    f32 = torch.float32
    delta = (g.float() * out.float()).sum(-1)  # (B, N, Lq, H)
    C = _chunk_size(N, B, H, Lq, Lk)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    db1 = None if b1 is None else torch.empty(
        (B, N, Lk), dtype=f32, device=q.device)
    b2f = None if b2 is None else b2.reshape(B, 1, H, Lq, Lk).float()
    db2 = None if b2 is None else torch.zeros(
        (B, H, Lq, Lk), dtype=f32, device=q.device)
    for n0 in range(0, N, C):
        c = slice(n0, n0 + C)
        qc, kc, vc, gc = (x[:, c].float() for x in (q, k, v, g))
        s = torch.einsum("bnqhd,bnkhd->bnhqk", qc, kc) * scale
        if b1 is not None:
            s = s + b1[:, c].float()  # (B, C, 1, 1, Lk) broadcasts
        if b2f is not None:
            s = s + b2f
        # lse = -inf marks fully-masked rows; their p must be 0, not inf
        lsee = lse[:, c, :, :, None]  # (B, C, H, Lq, 1)
        p = torch.where(torch.isfinite(lsee), torch.exp(s - lsee), 0.0)
        dv[:, c] = torch.einsum("bnhqk,bnqhd->bnkhd", p, gc).to(v.dtype)
        dp = torch.einsum("bnqhd,bnkhd->bnhqk", gc, vc)
        ds = p * (dp - delta[:, c].transpose(2, 3)[..., None])
        dq[:, c] = (torch.einsum("bnhqk,bnkhd->bnqhd", ds, kc)
                    * scale).to(q.dtype)
        dk[:, c] = (torch.einsum("bnhqk,bnqhd->bnkhd", ds, qc)
                    * scale).to(k.dtype)
        if db1 is not None:
            db1[:, c] = ds.sum((2, 3))
        if db2 is not None:
            db2 += ds.sum(1)
    if db1 is not None:
        db1 = db1.reshape(b1.shape).to(b1.dtype)
    if db2 is not None:
        db2 = db2.reshape(b2.shape).to(b2.dtype)
    return dq, dk, dv, db1, db2


class _EvoformerAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, b1, b2):
        out, lse = evoformer_fwd(q, k, v, b1, b2)
        ctx.save_for_backward(q, k, v, b1, b2, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        return evoformer_bwd(*ctx.saved_tensors, g)


def evoformer_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        biases: Sequence[Optional[torch.Tensor]] = ()
                        ) -> torch.Tensor:
    """``DS4Sci_EvoformerAttention`` equivalent (see module docstring).

    q/k/v: ``(B, N, L, H, D)`` (or unbatched ``(N, L, H, D)``); ``biases``
    holds up to two optional tensors — ``biases[0]`` with shape ``(B, N, 1,
    1, L)`` (mask bias), ``biases[1]`` with shape ``(B, 1, H, L, L)`` (pair
    bias). Differentiable in all inputs.
    """
    if q.dim() == 4:  # allow unbatched (N, L, H, D)
        out = evoformer_attention(q[None], k[None], v[None],
                                  [None if b is None else b[None]
                                   for b in biases])
        return out[0]
    if q.dim() != 5:
        raise ValueError(f"q must be (B, N, L, H, D), got {tuple(q.shape)}")
    B, N, Lq, H, D = q.shape
    Lk = k.shape[2]
    biases = list(biases) + [None] * (2 - len(biases))
    if len(biases) > 2:
        raise ValueError("at most two biases (mask bias, pair bias)")
    b1, b2 = biases
    if b1 is not None and tuple(b1.shape) != (B, N, 1, 1, Lk):
        raise ValueError(f"bias1 shape {tuple(b1.shape)} != "
                         f"{(B, N, 1, 1, Lk)}")
    if b2 is not None and tuple(b2.shape) != (B, 1, H, Lq, Lk):
        raise ValueError(f"bias2 shape {tuple(b2.shape)} != "
                         f"{(B, 1, H, Lq, Lk)}")
    return _EvoformerAttention.apply(q, k, v, b1, b2)


# reference-compatible alias (deepspeed.ops.deepspeed4science)
DS4Sci_EvoformerAttention = evoformer_attention
