"""Flash attention for training: forward, dK/dV and dQ — the port of
``deepspeed_tpu/ops/pallas/flash_attention.py``.

:func:`flash_attention` keeps the reference's signature and ``(B, S, H, D)``
layout (k/v ``(B, S, KV, D)``, ``H % KV == 0``) and is differentiable: a
``torch.autograd.Function`` whose forward runs :func:`flash_fwd` (o and an
f32 lse ``(B, H, S)``) and whose backward computes delta = rowsum(dO * O)
in plain torch, then runs :func:`flash_bwd_dkdv` and :func:`flash_bwd_dq`.
It survives ``torch.utils.checkpoint`` re-running the forward.

Masks compose as in the reference: ``causal``; ``window > 0`` keeps keys in
(row - window, row] whether or not ``causal`` is set; ``segment_ids``
``(B, S)`` keep equal ids; ``block_mask`` ``(ceil(S/block_q),
ceil(S/block_k))`` keeps (row, key) iff ``block_mask[row // block_q,
key // block_k]``.  ``block_q``/``block_k`` fix only that granularity: the
kernels pick their own tiles and mask the ragged edge themselves, so there
is no fallback for shapes the reference cannot tile.  A row with no kept
key gives o = 0 and lse = -inf.

:func:`flash_fwd` (not the public op) also takes the reference's additive
biases, in this layout: ``bias_kv`` ``(B, Skv)``, one value per key
broadcast over rows and heads, and ``bias_qk`` ``(B', H, S, Skv)`` with
``B % B' == 0``, batch b reading ``bias_qk[b // (B // B')]``; each f32 or
the forward's half type (bf16; f16 for an f16 forward).  The scores
become ``s * sm_scale + bias_kv + bias_qk`` in f32, then the masks drop
elements, then the softmax runs; lse includes the biases.
Their only caller is ``ops/evoformer.py``, whose backward is plain torch,
so the backward kernels take no bias.

On CUDA tensors each wrapper checks dtype (bf16, f16 or f32), shapes,
devices, contiguity and (bf16, f16) 16-byte alignment, launches its
hand-written kernel from ``csrc/flash_attention.cu`` on the current stream,
and raises on anything the kernel does not take.  In bf16 and f16 the
forward, dK/dV and dQ run on the tensor cores (p and ds split into hi/lo
pairs of the input's type, so they keep f32 precision; in f16 p is split
after a multiply by 2^14 and ds after a power-of-two scale per row, so
neither leaves f16's range: an output past 65504 still reads inf, as the
reference's cast gives it); f32 runs on the CUDA cores.  On CPU tensors
it runs the
plain PyTorch version (``flash_fwd_plain``, ``flash_bwd_dkdv_plain``,
``flash_bwd_dq_plain``), which is also the kernels' oracle on the card.
The public :func:`flash_attention` copies a strided or (bf16) misaligned
q, k, v or dO (a transposed tensor, a slice of a fused QKV projection)
into the layout the wrappers take; the wrappers themselves still raise on
such inputs.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from . import build

#: launches of each kernel, counted where the wrapper launches it
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
#: of LAUNCHES["flash_fwd"], the launches with a bias (the evoformer path)
BIAS_LAUNCHES = {"flash_fwd_bias": 0}
#: calls of each plain version (the CPU path and the kernels' oracle)
PLAIN_CALLS = {"flash_fwd_plain": 0, "flash_bwd_dkdv_plain": 0,
               "flash_bwd_dq_plain": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the 2-byte types, whose kernels copy 16-byte chunks
_HALF_TYPES = (torch.bfloat16, torch.float16)
_HEAD_DIMS = (32, 64, 128)  # the kernels' instantiations (csrc: ds_flash_*)


def reset_counts() -> None:
    for counts in (LAUNCHES, BIAS_LAUNCHES, PLAIN_CALLS):
        for key in counts:
            counts[key] = 0


class AttnMask(NamedTuple):
    """The masks of one attention call (see module doc).  ``segment_ids``
    and ``block_mask`` are int32 tensors on the inputs' device, or None."""

    causal: bool = True
    window: int = 0
    segment_ids: Optional[torch.Tensor] = None
    block_mask: Optional[torch.Tensor] = None
    block_q: int = 1024
    block_k: int = 1024


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def keep_mask(mask: AttnMask, S: int, Skv: int, device) -> torch.Tensor:
    """The element keep-mask, ``(B or 1, S, Skv)`` bool:
    band ∧ block table ∧ segments, as ``_reference_attention`` builds it."""
    rows = torch.arange(S, device=device)[:, None]
    cols = torch.arange(Skv, device=device)[None, :]
    keep = torch.ones((S, Skv), dtype=torch.bool, device=device)
    if mask.window > 0:
        keep = (cols > rows - mask.window) & (cols <= rows)
    elif mask.causal:
        keep = rows >= cols
    if mask.block_mask is not None:
        elem = (mask.block_mask != 0).repeat_interleave(mask.block_q, 0) \
            .repeat_interleave(mask.block_k, 1)
        keep = keep & elem[:S, :Skv]
    keep = keep[None]
    if mask.segment_ids is not None:
        seg = mask.segment_ids
        keep = keep & (seg[:, :, None] == seg[:, None, :])
    return keep


def _split_heads(q, k):
    B, S, H, D = q.shape
    KV = k.shape[2]
    return B, S, H, D, KV, H // KV


def flash_fwd_plain(q, k, v, mask: AttnMask, sm_scale: float, bias_kv=None,
                    bias_qk=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch forward, f32 inside: ``(o (B,S,H,D) in q's dtype,
    lse (B,H,S) f32)``.  The biases (module doc) are added to the scaled
    scores in f32; masked logits are then -1e30 as in
    ``_reference_attention``; rows with no kept key give o = 0 and
    lse = -inf."""
    PLAIN_CALLS["flash_fwd_plain"] += 1
    B, S, H, D, KV, G = _split_heads(q, k)
    Skv = k.shape[1]
    keep = keep_mask(mask, S, Skv, q.device)[:, None, None]  # (B|1,1,1,S,T)
    qf = q.float().reshape(B, S, KV, G, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qf, k.float()) * sm_scale
    if bias_kv is not None:
        logits = logits + bias_kv.float()[:, None, None, None, :]
    if bias_qk is not None:  # batch b reads bias_qk[b // rep], no copy
        Bq = bias_qk.shape[0]
        logits = (logits.reshape(Bq, B // Bq, KV, G, S, Skv)
                  + bias_qk.float().reshape(Bq, 1, KV, G, S, Skv)
                  ).reshape(B, KV, G, S, Skv)
    logits = logits.masked_fill(~keep, -1e30)
    # o = sum(e v) / l with e = exp(logits - max), as the kernels normalise:
    # exp(logits - lse) would lose log(l) where every logit of a row sits
    # at -1e9 (lse rounds to -1e9 there; o is the mean of V)
    m = logits.amax(-1, keepdim=True)
    e = torch.where(keep, torch.exp(logits - m), 0.0)
    l = e.sum(-1)
    lse = torch.where(l > 0, m[..., 0] + torch.log(l), -math.inf)
    o = torch.einsum("bkgst,btkd->bskgd",
                     e / torch.where(l > 0, l, 1.0)[..., None], v.float())
    return (o.reshape(B, S, H, D).to(q.dtype),
            lse.reshape(B, H, S).contiguous())


def _recompute(q, k, v, do, lse, delta, mask: AttnMask, sm_scale: float):
    """The backward's recompute, f32: p = exp(s - lse) on kept elements
    (never exponentiated where masked) and ds = p (dp - delta) scale, both
    ``(B, KV, G, S, T)``."""
    B, S, H, D, KV, G = _split_heads(q, k)
    Skv = k.shape[1]
    keep = keep_mask(mask, S, Skv, q.device)[:, None, None]
    qf = q.float().reshape(B, S, KV, G, D)
    dof = do.float().reshape(B, S, KV, G, D)
    s = torch.einsum("bskgd,btkd->bkgst", qf, k.float()) * sm_scale
    lse = lse.reshape(B, KV, G, S, 1)
    p = torch.where(keep, s - lse, -math.inf).exp()
    dp = torch.einsum("bskgd,btkd->bkgst", dof, v.float())
    ds = p * (dp - delta.reshape(B, KV, G, S, 1)) * sm_scale
    return qf, dof, p, ds


def flash_bwd_dkdv_plain(q, k, v, do, lse, delta, mask: AttnMask,
                         sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch dK and dV ``(B, Skv, KV, D)``, summed over the GQA
    group, in k's and v's dtypes."""
    PLAIN_CALLS["flash_bwd_dkdv_plain"] += 1
    qf, dof, p, ds = _recompute(q, k, v, do, lse, delta, mask, sm_scale)
    dv = torch.einsum("bkgst,bskgd->btkd", p, dof)
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qf)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, mask: AttnMask,
                       sm_scale: float) -> torch.Tensor:
    """Plain PyTorch dQ ``(B, S, H, D)`` in q's dtype."""
    PLAIN_CALLS["flash_bwd_dq_plain"] += 1
    B, S, H, D, _, _ = _split_heads(q, k)
    _, _, _, ds = _recompute(q, k, v, do, lse, delta, mask, sm_scale)
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.float())
    return dq.reshape(B, S, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(q, k, v, mask: AttnMask, extra=()) -> Tuple[int, ...]:
    """Validate CUDA inputs for the kernels; returns (B, S, Skv, H, KV, D,
    nkb) and raises on anything the kernels do not take."""
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash attention kernels take bfloat16, float16 or "
                        f"float32, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("q must be (B, S, H, D) and k, v (B, Skv, KV, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, D = q.shape
    _, Skv, KV, Dk = k.shape
    if k.shape[0] != B or Dk != D or D not in _HEAD_DIMS:
        raise ValueError(f"head dim must be one of {_HEAD_DIMS} and batch "
                         f"and head dim must match, got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if KV <= 0 or H % KV:
        raise ValueError(f"H must be a multiple of KV, got H={H}, KV={KV}")
    tensors = {"q": q, "k": k, "v": v, **dict(extra)}
    if mask.segment_ids is not None:
        if S != Skv or tuple(mask.segment_ids.shape) != (B, S):
            raise ValueError("segment_ids must be (B, S) with S == Skv")
        tensors["segment_ids"] = mask.segment_ids
    nkb = 0
    if mask.block_mask is not None:
        nqb = -(-S // mask.block_q)
        nkb = -(-Skv // mask.block_k)
        if tuple(mask.block_mask.shape) != (nqb, nkb):
            raise ValueError(
                f"block_mask shape {tuple(mask.block_mask.shape)} != grid "
                f"({nqb}, {nkb}) for S={S}, block_q={mask.block_q}, "
                f"block_k={mask.block_k}")
        tensors["block_mask"] = mask.block_mask
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in ("segment_ids", "block_mask"):
            if t.dtype != torch.int32:
                raise TypeError(f"{name} must be int32, got {t.dtype}")
        elif name in ("lse", "delta"):
            if t.dtype != torch.float32 or tuple(t.shape) != (B, H, S):
                raise ValueError(f"{name} must be f32 (B, H, S)")
        elif t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q {q.dtype}: the kernels "
                            "take one dtype")
        elif t.dtype in _HALF_TYPES and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned: the bf16 "
                             "and f16 kernels copy 16-byte chunks")
    if tuple(dict(extra).get("do", q).shape) != tuple(q.shape):
        raise ValueError("do must have q's shape")
    return B, S, Skv, H, KV, D, nkb


def _check_bias(q, bias_kv, bias_qk, B, S, Skv, H) -> Tuple:
    """Validate the forward's biases (module doc) for the kernels; returns
    (bias_kv pointer, bias_qk pointer, their dtype codes, bias_qk's batch
    repeat) and raises on anything the kernels do not take."""
    ptrs, codes, rep = [None, None], [0, 0], 1
    for i, (name, t) in enumerate((("bias_kv", bias_kv), ("bias_qk", bias_qk))):
        if t is None:
            continue
        if name == "bias_kv":
            if tuple(t.shape) != (B, Skv):
                raise ValueError(f"bias_kv must be (B, Skv) = {(B, Skv)}, got "
                                 f"{tuple(t.shape)}")
        elif (t.dim() != 4 or tuple(t.shape[1:]) != (H, S, Skv)
              or t.shape[0] <= 0 or B % t.shape[0]):
            raise ValueError(f"bias_qk must be (B', H, S, Skv) = (B', {H}, {S}, "
                             f"{Skv}) with B = {B} a multiple of B', got "
                             f"{tuple(t.shape)}")
        else:
            rep = B // t.shape[0]
        half = torch.float16 if q.dtype == torch.float16 else torch.bfloat16
        if t.dtype not in (torch.float32, half):
            raise TypeError(f"{name} must be {half} or float32 for a "
                            f"{q.dtype} forward, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype == half and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned: the "
                             f"{half} kernels copy 16-byte chunks")
        ptrs[i], codes[i] = t.data_ptr(), _DTYPE_CODES[t.dtype]
    return ptrs[0], ptrs[1], codes[0], codes[1], rep


def _mask_args(mask: AttnMask):
    seg = mask.segment_ids.data_ptr() if mask.segment_ids is not None \
        else None
    bm = mask.block_mask.data_ptr() if mask.block_mask is not None else None
    return seg, bm


def _on_cuda(name: str, q: torch.Tensor) -> bool:
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    return True


def flash_fwd(q, k, v, mask: AttnMask, sm_scale: float, bias_kv=None,
              bias_qk=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` of one attention call, with the optional biases of the
    module doc: the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if not _on_cuda("flash_fwd", q):
        return flash_fwd_plain(q, k, v, mask, sm_scale, bias_kv, bias_qk)
    B, S, Skv, H, KV, D, nkb = _check(q, k, v, mask)
    b1, b2, b1_code, b2_code, rep = _check_bias(q, bias_kv, bias_qk, B, S,
                                                Skv, H)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    seg, bm = _mask_args(mask)
    lib = build.load()
    err = lib.ds_flash_fwd(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), seg,
        bm, b1, b2, b1_code, b2_code, rep, o.data_ptr(), lse.data_ptr(), B,
        S, Skv, H, KV, D, int(mask.causal), int(mask.window), mask.block_q,
        mask.block_k, nkb, float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "flash_fwd launch")
    LAUNCHES["flash_fwd"] += 1
    if b1 is not None or b2 is not None:
        BIAS_LAUNCHES["flash_fwd_bias"] += 1
    return o, lse


def flash_bwd_dkdv(q, k, v, do, lse, delta, mask: AttnMask, sm_scale: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)``: the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if not _on_cuda("flash_bwd_dkdv", q):
        return flash_bwd_dkdv_plain(q, k, v, do, lse, delta, mask, sm_scale)
    B, S, Skv, H, KV, D, nkb = _check(
        q, k, v, mask, (("do", do), ("lse", lse), ("delta", delta)))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    seg, bm = _mask_args(mask)
    lib = build.load()
    err = lib.ds_flash_bwd_dkdv(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), seg, bm,
        dk.data_ptr(), dv.data_ptr(), B, S, Skv, H, KV, D, int(mask.causal),
        int(mask.window), mask.block_q, mask.block_k, nkb, float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "flash_bwd_dkdv launch")
    LAUNCHES["flash_bwd_dkdv"] += 1
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, mask: AttnMask, sm_scale: float
                 ) -> torch.Tensor:
    """``dq``: the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if not _on_cuda("flash_bwd_dq", q):
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, mask, sm_scale)
    B, S, Skv, H, KV, D, nkb = _check(
        q, k, v, mask, (("do", do), ("lse", lse), ("delta", delta)))
    dq = torch.empty_like(q)
    seg, bm = _mask_args(mask)
    lib = build.load()
    err = lib.ds_flash_bwd_dq(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), seg, bm,
        dq.data_ptr(), B, S, Skv, H, KV, D, int(mask.causal),
        int(mask.window), mask.block_q, mask.block_k, nkb, float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "flash_bwd_dq launch")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def attention_delta(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, ``(B, H, S)`` (``_flash_bwd``'s)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


# ---------------------------------------------------------------------------
# public op
# ---------------------------------------------------------------------------


def kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the wrappers take it: itself when contiguous and, in bf16
    or f16, 16-byte aligned; else a contiguous copy (a fresh allocation, so
    aligned)."""
    if t.is_contiguous() and (t.dtype not in _HALF_TYPES
                              or t.data_ptr() % 16 == 0):
        return t
    return t.clone(memory_format=torch.contiguous_format)


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, mask: AttnMask, sm_scale: float):
        q, k, v = kernel_layout(q), kernel_layout(k), kernel_layout(v)
        o, lse = flash_fwd(q, k, v, mask, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask, ctx.sm_scale = mask, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = kernel_layout(do)
        delta = attention_delta(do, o)
        dk, dv = flash_bwd_dkdv(q, k, v, do, lse, delta, ctx.mask,
                                ctx.sm_scale)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.mask, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    block_q: int = 1024, block_k: int = 1024,
                    segment_ids: Optional[torch.Tensor] = None,
                    window: int = 0,
                    block_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Fused attention. q: (B, S, H, D); k/v: (B, S, KV, D) with KV | H.
    Differentiable; see the module doc for the masks."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    seg = bm = None
    if segment_ids is not None:
        seg = torch.as_tensor(segment_ids, device=q.device) \
            .to(torch.int32).contiguous()
    if block_mask is not None:
        bm = torch.as_tensor(block_mask, device=q.device) \
            .to(torch.int32).contiguous()
        nq = -(-q.shape[1] // block_q)
        nk = -(-k.shape[1] // block_k)
        if tuple(bm.shape) != (nq, nk):
            raise ValueError(
                f"block_mask shape {tuple(bm.shape)} != grid ({nq}, {nk}) "
                f"for S={q.shape[1]}, block_q={block_q}, block_k={block_k}")
    mask = AttnMask(bool(causal), int(window), seg, bm, int(block_q),
                    int(block_k))
    return _FlashAttention.apply(q, k, v, mask, float(sm_scale))
