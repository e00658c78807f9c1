"""ZeRO++ qwZ — quantized weight all-gather for stage-3 parameters; the
port of ``deepspeed_tpu/runtime/zero/qwz.py``.

Stage-3 gathers ship int8 codes + f32 block scales instead of the
full-precision weights (halving the bf16 traffic, quartering the f32),
and every rank dequantizes on arrival: each rank quantizes its own shard
(blocks of ``block_size`` over the shard's flat values, the reference's
``quantize_blockwise``), the codes and the scales are all-gathered, and
the shards are dequantized and concatenated along the sharded dim — the
reference's numbers exactly.  The weight's gradient is exact
(straight-through) and reduce-scatters back onto the shards.

:func:`qwz_gather_leaf` is an autograd function over one leaf; the
engine's per-layer gathers (``runtime/engine.py``) run
:func:`quantized_gather` over all of a layer segment's shards at once, one
all-gather of codes and one of scales.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch

from ...ops.quantizer import dequantize_blockwise, quantize_blockwise
from ...utils.tree_io import tree_map


def _fsdp_dim(spec) -> int:
    """Index of the dim sharded (exactly) by 'fsdp', or -1."""
    for i, entry in enumerate(spec):
        if entry == "fsdp" or entry == ("fsdp",):
            return i
    return -1


def quantized_gather(shards: Sequence[torch.Tensor], dims: Sequence[int],
                     axis, bits: int = 8, block_size: int = 256,
                     topo=None, dtype=None,
                     sources: Optional[Sequence[Any]] = None
                     ) -> List[torch.Tensor]:
    """All-gather ``shards`` over ``axis`` as int8 blocks: each shard is
    quantized on its own (its blocks padded as the reference pads them),
    the codes of all of them ride one all-gather and the scales another;
    returns each full tensor (shards dequantized and concatenated along
    ``dims[i]``) in ``dtype`` (default: the shard's).

    ``sources[i]`` = (the flat values of the tensor the reference quantizes
    whole, the offset of ``shards[i]`` in it): a layer's slice of a
    stacked ``(L, ...)`` shard, whose blocks the reference lays over the
    whole stack.  The blocks covering the slice are cut from the stack and
    sent whole, so every code and scale is the reference's."""
    from ...comm import all_gather

    coded, skips = [], []
    for i, s in enumerate(shards):
        src = None if sources is None else sources[i]
        if src is None:
            region, skip = s, 0
        else:
            flat, off = src
            b0 = off // block_size
            b1 = -(-(off + s.numel()) // block_size)
            region, skip = flat[b0 * block_size:b1 * block_size], \
                off - b0 * block_size
        coded.append(quantize_blockwise(region, bits, block_size))
        skips.append(skip)
    counts = [c.shape[0] for c, _ in coded]
    codes = torch.cat([c for c, _ in coded])
    scales = torch.cat([s for _, s in coded])
    all_codes = all_gather(codes, axis, tiled=False, topo=topo)
    all_scales = all_gather(scales, axis, tiled=False, topo=topo)
    n = all_codes.shape[0]
    out = []
    off = 0
    for shard, d, nb, skip in zip(shards, dims, counts, skips):
        size = shard.numel()
        parts = [dequantize_blockwise(
            all_codes[k, off:off + nb], all_scales[k, off:off + nb], bits,
            block_size)[skip:skip + size].reshape(shard.shape).to(
                dtype or shard.dtype) for k in range(n)]
        out.append(torch.cat(parts, dim=d))
        off += nb
    return out


class _QwzGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis, bits, block_size, topo):
        ctx.dim, ctx.axis, ctx.topo = dim, axis, topo
        return quantized_gather([x], [dim], axis, bits, block_size, topo)[0]

    @staticmethod
    def backward(ctx, g):
        from ...comm import reduce_scatter

        return (reduce_scatter(g, ctx.axis, scatter_axis=ctx.dim,
                               topo=ctx.topo),
                None, None, None, None, None)


def qwz_gather_leaf(x: torch.Tensor, sharding: Any, topo: Any,
                    bits: int = 8, block_size: int = 256) -> torch.Tensor:
    """This rank's fsdp shard ``x`` of a leaf → the whole leaf, gathered
    as int8 codes + scales (``sharding``: a ``NamedSharding`` or its spec
    tuple).  As in the reference, a leaf with no fsdp dim, or an fsdp axis
    of one rank, comes back unchanged."""
    spec = getattr(sharding, "spec", sharding)
    dim = _fsdp_dim(spec)
    if dim < 0 or topo.size("fsdp") <= 1:
        return x
    return _QwzGather.apply(x, dim, "fsdp", bits, block_size, topo)


def qwz_gather_tree(params: Any, shardings: Any, topo: Any,
                    bits: int = 8, block_size: int = 256) -> Any:
    """Apply :func:`qwz_gather_leaf` across a param tree."""
    return tree_map(
        lambda x, s: qwz_gather_leaf(x, s, topo, bits, block_size),
        params, shardings)
