"""Paged-KV attention for the v2 serving engine: decode and chunked
prefill — the port of ``deepspeed_tpu/ops/pallas/paged_attention.py``.

Each entry has the reference's signature and layouts:

* ``paged_decode_attention(q (S,H,D), k_cache/v_cache (NB,BS,KV,D),
  block_tables (S,MB) int32, context_lens (S,) int32) -> (S,H,D)``:
  one query token per sequence; ``context_lens`` include the current
  token (its KV already written); ctx = 0 rows give zeros.
* ``paged_prefill_attention(q (S,Qp,H,D), k_cache, v_cache, block_tables,
  chunk_start (S,), chunk_len (S,)) -> (S,Qp,H,D)``: row i of sequence s
  sits at absolute position ``chunk_start[s] + i`` and sees cache
  positions <= its own and < ``chunk_start[s] + chunk_len[s]``; rows
  >= ``chunk_len[s]`` give zeros.

On CUDA tensors a wrapper checks dtype (bf16, f16 or f32), shapes, devices,
contiguity and (caches) 16-byte alignment, launches its hand-written kernel
from ``csrc/paged_attention.cu`` on the current stream, and raises on
anything the kernel does not take — it never falls back.  Decode is
split-KV: each chain is cut into splits of :func:`decode_split` positions
(fixed by ``max_blocks * block_size``, never by ``context_lens``, so a
call never waits on the device), one block each, merged in split order
through an f32 workspace by a second kernel of the same call.  Prefill
dispatches on dtype: bf16 and f16 run ``paged_prefill_tc_kernel`` on the
tensor cores (64-key tiles gathered through the block table, any block
size; f16 splits p into f16 hi/lo after a multiply by 2^14), f32 the
CUDA-core ``paged_prefill_kernel`` (one staged K/V block per step).  On
CPU tensors a wrapper runs the plain PyTorch version
(``decode_attention_plain`` / ``prefill_attention_plain``), which is also
the kernels' oracle on the card.
"""

from __future__ import annotations

import math

import torch

from . import build

#: launches of each kernel, counted where the wrapper launches it
LAUNCHES = {"paged_decode_attention": 0, "paged_prefill_attention": 0}
#: calls of each plain version (the CPU path and the kernels' oracle)
PLAIN_CALLS = {"decode_attention_plain": 0, "prefill_attention_plain": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HEAD_DIMS = (64, 128)  # the kernels' instantiations (csrc: ds_paged_*)
#: the same launches by head dim: (kernel, D) -> launches
LAUNCHES_BY_HEAD_DIM = {(name, d): 0 for name in LAUNCHES for d in _HEAD_DIMS}
_GROUPS = (1, 2, 4, 8)  # query heads per kv head (csrc: kMaxGroup)
_MAX_SMEM = 227 * 1024
_SPLIT_UNIT = 128  # decode split lengths are multiples of every tile (csrc)
_MAX_SPLITS = 32   # decode splits per chain (csrc: kMaxSplits)


def reset_counts() -> None:
    for counts in (LAUNCHES, LAUNCHES_BY_HEAD_DIM, PLAIN_CALLS):
        for key in counts:
            counts[key] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _gather_chains(cache: torch.Tensor, block_tables: torch.Tensor
                   ) -> torch.Tensor:
    """(S, MB*BS, KV, D) f32: each sequence's whole block chain, in order."""
    S, MB = block_tables.shape
    _, BS, KV, D = cache.shape
    return cache[block_tables.long()].reshape(S, MB * BS, KV, D).float()


def decode_attention_plain(q, k_cache, v_cache, block_tables, context_lens):
    """Plain PyTorch paged decode attention, f32 inside (see module doc)."""
    PLAIN_CALLS["decode_attention_plain"] += 1
    S, H, D = q.shape
    KV = k_cache.shape[2]
    k = _gather_chains(k_cache, block_tables)
    v = _gather_chains(v_cache, block_tables)
    qf = q.float().reshape(S, KV, H // KV, D) * (1.0 / math.sqrt(D))
    scores = torch.einsum("skgd,stkd->skgt", qf, k)
    pos = torch.arange(k.shape[1], device=q.device)
    valid = pos[None, :] < context_lens.long()[:, None]  # (S, T)
    scores = scores.masked_fill(~valid[:, None, None, :], -1e30)
    out = torch.einsum("skgt,stkd->skgd", torch.softmax(scores, -1), v)
    # a fully-masked (ctx = 0) row holds the mean of V: zero it explicitly
    out = torch.where(context_lens[:, None, None, None] > 0, out, 0.0)
    return out.reshape(S, H, D).to(q.dtype)


def prefill_attention_plain(q, k_cache, v_cache, block_tables, chunk_start,
                            chunk_len):
    """Plain PyTorch chunked-prefill attention, f32 inside (see module
    doc)."""
    PLAIN_CALLS["prefill_attention_plain"] += 1
    S, Qp, H, D = q.shape
    KV = k_cache.shape[2]
    k = _gather_chains(k_cache, block_tables)
    v = _gather_chains(v_cache, block_tables)
    qf = q.float().reshape(S, Qp, KV, H // KV, D) * (1.0 / math.sqrt(D))
    scores = torch.einsum("sqkgd,stkd->skgqt", qf, k)
    rows = torch.arange(Qp, device=q.device)
    t_pos = torch.arange(k.shape[1], device=q.device)
    start, qlen = chunk_start.long(), chunk_len.long()
    q_pos = start[:, None] + rows[None, :]  # (S, Qp)
    q_valid = rows[None, :] < qlen[:, None]  # (S, Qp)
    valid = ((t_pos[None, None, :] <= q_pos[:, :, None])
             & (t_pos[None, None, :] < (start + qlen)[:, None, None])
             & q_valid[:, :, None])  # (S, Qp, T)
    scores = scores.masked_fill(~valid[:, None, None], -1e30)
    out = torch.einsum("skgqt,stkd->sqkgd", torch.softmax(scores, -1), v)
    out = torch.where(q_valid[:, :, None, None, None], out, 0.0)
    return out.reshape(S, Qp, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def decode_split(positions: int) -> int:
    """Positions per split-KV block of a decode call whose chains hold
    ``positions`` (= max_blocks * block_size): 128, or the least multiple of
    128 that cuts a chain into at most 32 splits."""
    per = -(-positions // _MAX_SPLITS)
    return _SPLIT_UNIT * max(1, -(-per // _SPLIT_UNIT))


def kernels_cover(dtype: torch.dtype, H: int, KV: int, D: int) -> bool:
    """Whether the card's kernels have an instantiation for attention in
    ``dtype`` with H query heads over KV kv heads of head dim D."""
    return (dtype in _DTYPE_CODES and D in _HEAD_DIMS and KV > 0
            and H % KV == 0 and H // KV in _GROUPS)


def coverage() -> str:
    """What the card's kernels take, for a refusal's message."""
    names = ", ".join(str(dt).replace("torch.", "") for dt in _DTYPE_CODES)
    return (f"dtypes {names}, head dims {_HEAD_DIMS} and "
            f"{'/'.join(map(str, _GROUPS))} query heads per kv head")


def _check_common(q, k_cache, v_cache, int_args, H, D):
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"paged attention kernels take bfloat16, float16 or "
                        f"float32, got {q.dtype}")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError("q, k_cache and v_cache must share one dtype, got "
                        f"{q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError("k_cache and v_cache must both be (NB, BS, KV, D), "
                         f"got {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    NB, BS, KV, Dk = k_cache.shape
    if BS <= 0:
        raise ValueError("block size must be positive")
    if Dk != D or D not in _HEAD_DIMS:
        raise ValueError(f"head dim must be one of {_HEAD_DIMS} and match "
                         f"the cache, got q {D}, cache {Dk}")
    if KV <= 0 or H % KV or (H // KV) not in _GROUPS:
        raise ValueError(f"query heads per kv head must be 1, 2, 4 or 8, "
                         f"got H={H}, KV={KV}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    *int_args.items()):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in int_args.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned: the kernels "
                             "copy 16-byte chunks of slot rows")
    return NB, BS, KV


def _stream(device: torch.device):
    return torch.cuda.current_stream(device).cuda_stream


def paged_decode_attention(q, k_cache, v_cache, block_tables, context_lens):
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, block_tables,
                                      context_lens)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    if q.dim() != 3:
        raise ValueError(f"q must be (S, H, D), got {tuple(q.shape)}")
    S, H, D = q.shape
    _, BS, KV = _check_common(q, k_cache, v_cache,
                              {"block_tables": block_tables,
                               "context_lens": context_lens}, H, D)
    if block_tables.dim() != 2 or block_tables.shape[0] != S \
            or tuple(context_lens.shape) != (S,):
        raise ValueError("block_tables must be (S, MB) and context_lens (S,) "
                         f"for S={S}, got {tuple(block_tables.shape)}, "
                         f"{tuple(context_lens.shape)}")
    MB = block_tables.shape[1]
    split = decode_split(MB * BS)
    splits = -(-MB * BS // split)
    out = torch.empty_like(q)
    # each split's f32 (acc, m, l) per query head, when a chain can span
    # more than one split
    ws = torch.empty(S * H * splits * (D + 2), dtype=torch.float32,
                     device=q.device) if splits > 1 else None
    lib = build.load()
    err = lib.ds_paged_decode(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), block_tables.data_ptr(), context_lens.data_ptr(),
        out.data_ptr(), None if ws is None else ws.data_ptr(),
        S, H, KV, D, BS, MB, split, _stream(q.device))
    build.check(lib, err, "paged_decode_attention launch")
    LAUNCHES["paged_decode_attention"] += 1
    LAUNCHES_BY_HEAD_DIM["paged_decode_attention", D] += 1
    return out


def paged_prefill_attention(q, k_cache, v_cache, block_tables, chunk_start,
                            chunk_len):
    if q.device.type == "cpu":
        return prefill_attention_plain(q, k_cache, v_cache, block_tables,
                                       chunk_start, chunk_len)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention: unsupported device "
                         f"{q.device}")
    if q.dim() != 4:
        raise ValueError(f"q must be (S, Qp, H, D), got {tuple(q.shape)}")
    S, Qp, H, D = q.shape
    _, BS, KV = _check_common(q, k_cache, v_cache,
                              {"block_tables": block_tables,
                               "chunk_start": chunk_start,
                               "chunk_len": chunk_len}, H, D)
    if block_tables.dim() != 2 or block_tables.shape[0] != S \
            or tuple(chunk_start.shape) != (S,) \
            or tuple(chunk_len.shape) != (S,):
        raise ValueError("block_tables must be (S, MB), chunk_start and "
                         f"chunk_len (S,) for S={S}")
    # the f32 kernel stages one whole K and V block; the bf16 and f16 kernel
    # walks 64-key tiles gathered through the block table, whatever the
    # block size
    smem = 2 * BS * D * q.element_size()
    if q.dtype == torch.float32 and smem > _MAX_SMEM:
        raise ValueError(f"a K and a V block take {smem} bytes of shared "
                         f"memory, more than the {_MAX_SMEM} a block has")
    MB = block_tables.shape[1]
    out = torch.empty_like(q)
    lib = build.load()
    err = lib.ds_paged_prefill(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), block_tables.data_ptr(), chunk_start.data_ptr(),
        chunk_len.data_ptr(), out.data_ptr(),
        S, Qp, H, KV, D, BS, MB, _stream(q.device))
    build.check(lib, err, "paged_prefill_attention launch")
    LAUNCHES["paged_prefill_attention"] += 1
    LAUNCHES_BY_HEAD_DIM["paged_prefill_attention", D] += 1
    return out
