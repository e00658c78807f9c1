"""Grouped (per-expert) matmul, the dropless-MoE expert FFN — the port of
``deepspeed_tpu/ops/pallas/grouped_matmul.py``.

Rows arrive in the reference's TILE-ALIGNED layout (:func:`tile_aligned_layout`):
each expert's rows padded up to a multiple of ``tile_m``, so every m-tile
belongs to one expert, named by ``tile_group``.  :func:`grouped_matmul`
computes ``out[r] = lhs[r] @ rhs[tile_group[r // tile_m]]`` with f32
accumulation and the result in lhs's dtype, what ``_gmm_kernel`` computes.

* CUDA tensors launch the hand-written kernels of
  ``csrc/grouped_matmul.cu`` on the current stream (:data:`LAUNCHES`) or
  raise on what they do not take; CPU tensors run
  :func:`grouped_matmul_plain` (:data:`PLAIN_CALLS`), which is also the
  kernels' oracle on the card.  The dispatch (:func:`uses_wgmma`): bf16 or
  f16 on (E, K, N) weights with ``tile_m`` a multiple of 64 (dropless MoE's
  mixed steps) runs ``grouped_matmul_wgmma_kernel`` (also counted in
  :data:`WGMMA_LAUNCHES`), which finds each expert's tiles in
  ``tile_group`` itself and reads each expert's weights once; bf16 or f16
  at ``tile_m`` 16 (decode bodies) or on transposed weights runs
  ``grouped_matmul_bf16_kernel``, f32 ``grouped_matmul_f32_kernel``.  f16
  runs the bf16 kernels at ``__half`` (f16 x f16 products are exact in
  f32).
* ``num_used_tiles`` (a device int32 scalar, from
  ``tile_aligned_layout(..., with_used_tiles=True)``) marks where the real
  groups end.  The layout always appends all-padding tiles that the
  reference clips to expert E-1; the kernel reads no weights for them and
  writes zeros, which is their product, since padding rows are zero.  The
  count stays on the device: no host sync.
* ``rhs_transposed=True`` reads ``rhs[e]`` as (N, K), so the backward's
  ``dlhs = g @ rhs[e]^T`` is the same kernel on the same weights, never a
  transposed copy (0.94 GB per projection at Mixtral's width).
* Differentiable (:class:`_GroupedMatmul`, the reference's ``custom_vjp``):
  dlhs through the kernel on the transposed weights; drhs, the transpose of
  ``ragged_dot`` (``drhs[e] = lhs[rows of e]^T @ g[rows of e]``), which the
  reference computes in XLA outside any kernel, per group with
  ``torch.matmul`` (one host read of the group sizes, in the backward only).

The layout's counts, ranks and ``searchsorted`` are written with comparison
one-hots and cumulative sums, and ``M_pad`` comes from the shapes, so
planning a layout on the card never waits for the device.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build

#: launches of the kernels, counted where the wrapper launches one (the
#: backward's dlhs launches count too)
LAUNCHES = {"grouped_matmul": 0}
#: of those, the launches of ``grouped_matmul_wgmma_kernel``
WGMMA_LAUNCHES = {"grouped_matmul": 0}
#: calls of the plain version (the CPU path and the kernel's oracle)
PLAIN_CALLS = {"grouped_matmul_plain": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the 2-byte types: the tensor-core kernels' (16-byte rows)
_HALF_TYPES = (torch.bfloat16, torch.float16)
_KERNEL_TILE_M = (64, 16)  # the kernel's row-block heights, largest first


def reset_counts() -> None:
    for counts in (LAUNCHES, WGMMA_LAUNCHES, PLAIN_CALLS):
        for key in counts:
            counts[key] = 0


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------


def tile_aligned_layout(expert_flat: torch.Tensor, num_experts: int, T: int,
                        tile_m: int, with_used_tiles: bool = False):
    """Plan the tile-aligned grouped layout for ``T`` assignments.

    Returns (positions (T,) int32, tile_group (M_pad//tile_m,) int32,
    padded_group_sizes (E,) int32, M_pad), the reference's four values:
    ``positions[a]`` is assignment ``a``'s row in the padded layout (stable
    order within an expert), ``M_pad = (ceil(T/tile_m) + E) * tile_m`` is
    static, tiles past the last group are clipped to expert E-1, and the
    last padded size absorbs them.  ``with_used_tiles=True`` appends the
    count of tiles that hold a group, as an int32 (1,) tensor on the
    device."""
    E = num_experts
    m_tiles = (T + tile_m - 1) // tile_m + E
    M_pad = m_tiles * tile_m
    dev = expert_flat.device
    ef = expert_flat.long()
    experts = torch.arange(E, device=dev)
    onehot = (ef[:, None] == experts[None, :]).long()  # (T, E)
    counts = onehot.sum(0)
    padded = (counts + tile_m - 1) // tile_m * tile_m
    ends = torch.cumsum(padded, 0)
    offsets = ends - padded
    # rank of each assignment within its expert: assignments ahead, same e
    rank = (torch.cumsum(onehot, 0) - onehot).gather(1, ef[:, None])[:, 0]
    positions = (offsets[ef] + rank).to(torch.int32)
    # searchsorted(ends, tile_start, side="right") = #ends <= tile_start
    tile_start = torch.arange(m_tiles, device=dev) * tile_m
    tile_group = (ends[None, :] <= tile_start[:, None]).sum(1).clamp(
        0, E - 1).to(torch.int32)
    head = padded[:-1]
    pad_sizes = torch.cat([head, (M_pad - head.sum()).reshape(1)]).to(
        torch.int32)
    out = (positions, tile_group, pad_sizes, M_pad)
    if with_used_tiles:
        out += ((ends[-1:] // tile_m).to(torch.int32),)
    return out


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def grouped_matmul_plain(lhs: torch.Tensor, rhs: torch.Tensor,
                         tile_group: torch.Tensor, tile_m: int,
                         rhs_transposed: bool = False) -> torch.Tensor:
    """Plain PyTorch ``out[r] = lhs[r] @ W_e`` with ``e = tile_group[r //
    tile_m]`` and ``W_e = rhs[e]`` (K, N), or ``rhs[e]^T`` when
    ``rhs_transposed`` (rhs (E, N, K)): per tile, the product in f32 (bf16
    products are exact in f32), the result in lhs's dtype.  Every tile is
    computed, the all-padding ones too (their zero rows give zeros)."""
    PLAIN_CALLS["grouped_matmul_plain"] += 1
    M, K = lhs.shape
    N = rhs.shape[1] if rhs_transposed else rhs.shape[2]
    out = torch.empty((M, N), dtype=lhs.dtype, device=lhs.device)
    for t in range(M // tile_m):
        w = rhs[tile_group[t].long()].float()  # a gather: no host read
        if rhs_transposed:
            w = w.transpose(0, 1)
        rows = slice(t * tile_m, (t + 1) * tile_m)
        out[rows] = (lhs[rows].float() @ w).to(lhs.dtype)
    return out


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def uses_wgmma(dtype: torch.dtype, tile_m: int, rhs_transposed: bool
               ) -> bool:
    """Whether a CUDA call runs ``grouped_matmul_wgmma_kernel``: bf16 or
    f16, rhs read as (K, N), and layout tiles of a multiple of 64 rows (its
    64-row sub-tiles never span two experts)."""
    return (dtype in _HALF_TYPES and not rhs_transposed
            and tile_m % 64 == 0)


def kernel_tile_m(tile_m: int) -> int:
    """The kernel's row-block height for a layout's ``tile_m``: 64 rows
    when 64 divides it, else 16; a block never spans two layout tiles."""
    for bm in _KERNEL_TILE_M:
        if tile_m % bm == 0:
            return bm
    raise ValueError(f"grouped_matmul kernel: tile_m must be a multiple of "
                     f"16 (the mma row tile), got {tile_m}")


def _stream(device: torch.device) -> int:
    return torch._C._cuda_getCurrentRawStream(
        device.index if device.index is not None
        else torch.cuda.current_device())


def _grouped_matmul_cuda(lhs, rhs, tile_group, tile_m, rhs_transposed,
                         num_used_tiles) -> torch.Tensor:
    if lhs.dtype not in _DTYPE_CODES or rhs.dtype != lhs.dtype:
        raise TypeError(f"grouped_matmul kernel takes bfloat16, float16 or "
                        f"float32 lhs and rhs of one dtype, got "
                        f"{lhs.dtype}, {rhs.dtype}")
    M, K = lhs.shape
    E = rhs.shape[0]
    N = rhs.shape[1] if rhs_transposed else rhs.shape[2]
    bm = kernel_tile_m(tile_m)
    if lhs.dtype in _HALF_TYPES and (K % 8 or N % 8 or lhs.data_ptr() % 16
                                     or rhs.data_ptr() % 16):
        raise ValueError(f"grouped_matmul kernel ({lhs.dtype}) loads "
                         f"16-byte rows: K and N must be multiples of 8 and "
                         f"lhs, rhs 16-byte aligned, got K={K}, N={N}")
    if tile_group.dtype != torch.int32 or tuple(tile_group.shape) != (
            M // tile_m,):
        raise ValueError(f"tile_group must be int32 ({M // tile_m},), got "
                         f"{tile_group.dtype} {tuple(tile_group.shape)}")
    tensors = [("lhs", lhs), ("rhs", rhs), ("tile_group", tile_group)]
    if num_used_tiles is not None:
        if num_used_tiles.dtype != torch.int32 or num_used_tiles.numel() != 1:
            raise ValueError("num_used_tiles must be one int32 element")
        tensors.append(("num_used_tiles", num_used_tiles))
    for name, t in tensors:
        if t.device != lhs.device:
            raise ValueError(f"{name} is on {t.device}, lhs on {lhs.device}")
        if not t.is_contiguous():
            raise ValueError(f"grouped_matmul: {name} must be contiguous")
    out = torch.empty((M, N), dtype=lhs.dtype, device=lhs.device)
    if M == 0 or N == 0:
        return out
    wgmma = uses_wgmma(lhs.dtype, tile_m, rhs_transposed)
    lib = build.load()
    err = lib.ds_grouped_matmul(
        _DTYPE_CODES[lhs.dtype], lhs.data_ptr(), rhs.data_ptr(),
        tile_group.data_ptr(),
        None if num_used_tiles is None else num_used_tiles.data_ptr(),
        out.data_ptr(), M, N, K, E, tile_m, bm, int(rhs_transposed),
        int(wgmma), _stream(lhs.device))
    build.check(lib, err, "grouped_matmul launch")
    LAUNCHES["grouped_matmul"] += 1
    if wgmma:
        WGMMA_LAUNCHES["grouped_matmul"] += 1
    return out


def _gmm(lhs, rhs, tile_group, tile_m, rhs_transposed, num_used_tiles):
    """One grouped product on lhs's device: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if lhs.dim() != 2 or rhs.dim() != 3:
        raise ValueError(f"grouped_matmul wants lhs (M, K) and rhs (E, K, N),"
                         f" got {tuple(lhs.shape)}, {tuple(rhs.shape)}")
    M, K = lhs.shape
    Kr = rhs.shape[2] if rhs_transposed else rhs.shape[1]
    if K != Kr:
        raise ValueError(f"lhs K={K} != rhs K={Kr} (rhs "
                         f"{tuple(rhs.shape)}, transposed={rhs_transposed})")
    if tile_m <= 0 or M % tile_m:
        raise ValueError(f"lhs rows {M} are not a multiple of tile_m="
                         f"{tile_m}")
    if lhs.device.type == "cpu":
        return grouped_matmul_plain(lhs, rhs, tile_group, tile_m,
                                    rhs_transposed)
    if lhs.device.type != "cuda":
        raise ValueError(f"grouped_matmul: unsupported device {lhs.device}")
    return _grouped_matmul_cuda(lhs, rhs, tile_group, tile_m, rhs_transposed,
                                num_used_tiles)


class _GroupedMatmul(torch.autograd.Function):

    @staticmethod
    def forward(ctx, lhs, rhs, tile_group, padded_group_sizes, tile_m,
                num_used_tiles):
        ctx.save_for_backward(lhs, rhs, tile_group, padded_group_sizes,
                              num_used_tiles)
        ctx.tile_m = tile_m
        return _gmm(lhs, rhs, tile_group, tile_m, False, num_used_tiles)

    @staticmethod
    def backward(ctx, g):
        lhs, rhs, tile_group, sizes, used = ctx.saved_tensors
        g = g.contiguous()
        dlhs = drhs = None
        if ctx.needs_input_grad[0]:
            # dlhs[r] = g[r] @ rhs[e]^T: the same kernel, rhs read as (N, K)
            dlhs = _gmm(g, rhs, tile_group, ctx.tile_m, True,
                        used).to(lhs.dtype)
        if ctx.needs_input_grad[1]:
            # ragged_dot's transpose: drhs[e] = lhs[rows of e]^T @ g[rows
            # of e], the groups' rows from their padded sizes
            drhs = torch.zeros_like(rhs)
            start = 0
            for e, n in enumerate(sizes.tolist()):
                if n:
                    rows = slice(start, start + n)
                    drhs[e] = (lhs[rows].float().T @ g[rows].float()).to(
                        rhs.dtype)
                start += n
        return dlhs, drhs, None, None, None, None


def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor,
                   tile_group: torch.Tensor,
                   padded_group_sizes: torch.Tensor, tile_m: int = 512,
                   tile_n: int = 1024,
                   num_used_tiles: Optional[torch.Tensor] = None,
                   rhs_transposed: bool = False) -> torch.Tensor:
    """``out[r] = lhs[r] @ rhs[tile_group[r // tile_m]]`` (see the module
    doc).  ``lhs``: (M, K) tile-aligned grouped rows, M a multiple of
    ``tile_m``, padding rows zero; ``rhs``: (E, K, N), or (E, N, K) with
    ``rhs_transposed``; ``padded_group_sizes``: (E,) rows per group (the
    backward's drhs).  ``tile_n`` is the reference's TPU n-tile and changes
    no result; the kernel picks its own.  Differentiable in lhs and rhs
    (not with ``rhs_transposed``, the backward's own form)."""
    del tile_n
    if rhs_transposed or not (torch.is_grad_enabled() and (
            lhs.requires_grad or rhs.requires_grad)):
        return _gmm(lhs, rhs, tile_group, tile_m, rhs_transposed,
                    num_used_tiles)
    return _GroupedMatmul.apply(lhs, rhs, tile_group, padded_group_sizes,
                                tile_m, num_used_tiles)

