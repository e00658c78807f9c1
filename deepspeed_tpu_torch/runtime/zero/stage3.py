"""ZeRO stage 3 on the port: parameters held as shards, gathered one layer
segment at a time.

The reference lets GSPMD gather each fsdp-sharded weight where the scanned
layer body uses it (``runtime/zero/sharding.py``); the port issues the
same schedule itself, at the hook ZeRO-Infinity's streaming uses
(``param_offload.maybe_stream_in``, called inside each checkpointed
segment of ``models/transformer.py``):

* a segment's shards (layer ``i``'s slices of the stacked ``(L, ...)``
  leaves) ride ONE all-gather over ``fsdp`` per dtype, in the shard-major
  layout of ``runtime/coalesce.py`` (with qwZ: one all-gather of int8 codes
  and one of scales, ``qwz.quantized_gather``); the leaves outside
  ``params["layers"]`` (embedding, final norm, head) are gathered once per
  micro-batch by :meth:`ShardGatherer.gather_tree`;
* the gathered tensors live as long as the segment needs them: a
  checkpointed segment's recompute gathers again, so the card never holds
  every layer whole;
* the gather is an autograd function whose backward reduce-scatters the
  segment's gradients over ``fsdp`` (one call per dtype, in the
  gradients' own dtype) and adds each shard's part into the engine's f32
  gradient buffer — layer ``i``'s slice of a
  stacked leaf's buffer — and returns nothing to the shards themselves
  (an ``anchor`` puts every gather on the backward's path, as the
  streamer's does).

A leaf whose spec shards no dim (replicated by the rules) passes through
unchanged, and its full gradient is added to its buffer; the engine
all-reduces those buffers over the whole data-parallel world afterwards,
and the shard buffers over ``dp``.  ``live_bytes`` / ``peak_live_bytes``
count the gathered bytes alive at once; the comms logger
(``comm.configure``) counts the collectives.
"""

from __future__ import annotations

import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..coalesce import (Bucket, Slot, flatten_bucket_shard_major,
                        unflatten_bucket_shard, unflatten_bucket_shard_major)
from . import param_offload
from .param_offload import _copy_dicts, _root


class _Gather(torch.autograd.Function):
    """Shards → whole tensors; backward: reduce-scatter into the buffers."""

    @staticmethod
    def forward(ctx, anchor, gatherer, key, js, *shards):
        ctx.gatherer, ctx.key, ctx.js = gatherer, key, js
        return tuple(gatherer.gather(js, key, shards))

    @staticmethod
    def backward(ctx, *grads):
        ctx.gatherer.scatter_grads(ctx.js, ctx.key, grads)
        return (None, None, None, None) + (None,) * len(grads)


class ShardGatherer:
    """The stage-3 gathering state of one engine.

    ``shards[j]`` is leaf ``j``'s local shard (the whole leaf where
    ``dims[j]`` is None), split along ``dims[j]`` over the ``n`` ranks of
    ``axis``; ``full_shapes[j]`` its whole shape; ``grads[j]`` its f32
    gradient buffer (the shard's shape); ``layered[j]``: the leaf is a
    stacked layer leaf, gathered per layer at the hook."""

    def __init__(self, shards: Sequence[torch.Tensor],
                 dims: Sequence[Optional[int]],
                 full_shapes: Sequence[Tuple[int, ...]],
                 grads: Sequence[torch.Tensor], layered: Sequence[bool],
                 n: int, axis: str = "fsdp", topo=None,
                 qwz: bool = False, qwz_bits: int = 8,
                 qwz_block: int = 256):
        self.shards = list(shards)
        self.dims = list(dims)
        self.full_shapes = [tuple(s) for s in full_shapes]
        self.grads = list(grads)
        self.layered = list(layered)
        self.n, self.axis, self.topo = n, axis, topo
        self.qwz, self.qwz_bits, self.qwz_block = qwz, qwz_bits, qwz_block
        self._index = {id(t): j for j, t in enumerate(self.shards)}
        dev = self.shards[0].device if self.shards else torch.device("cpu")
        self.anchor = torch.zeros((), device=dev, requires_grad=True)
        self.live_bytes = 0
        self.peak_live_bytes = 0

    def __enter__(self) -> "ShardGatherer":
        self._prev, param_offload._ACTIVE = param_offload._ACTIVE, self
        return self

    def __exit__(self, *exc) -> None:
        param_offload._ACTIVE = self._prev

    # -- forward -------------------------------------------------------------

    def _shape(self, j: int, key) -> Tuple[int, ...]:
        full = self.full_shapes[j]
        return full if key is None else full[1:]

    def _dim(self, j: int, key) -> Optional[int]:
        d = self.dims[j]
        return d if d is None or key is None else d - 1

    def _release(self, nbytes: int) -> None:
        self.live_bytes -= nbytes

    def gather(self, js: Sequence[int], key, shards: Sequence[torch.Tensor]
               ) -> List[torch.Tensor]:
        """Members ``js`` (their shards, or layer ``key``'s slices of
        them) whole: one all-gather per dtype of the sharded ones."""
        from ...comm import all_gather
        from .qwz import quantized_gather

        out: List[Optional[torch.Tensor]] = [None] * len(js)
        groups: Dict[torch.dtype, List[int]] = {}
        for m, (j, s) in enumerate(zip(js, shards)):
            if self.dims[j] is None:
                out[m] = s.view_as(s)
            else:
                groups.setdefault(s.dtype, []).append(m)
        for dtype, ms in groups.items():
            parts = [shards[m] for m in ms]
            if self.qwz:
                # a layer's slice quantized in the stacked shard's blocks
                sources = None if key is None else [
                    (self.shards[js[m]].reshape(-1), key * parts[i].numel())
                    for i, m in enumerate(ms)]
                fulls = quantized_gather(
                    parts, [self._dim(js[m], key) for m in ms], self.axis,
                    self.qwz_bits, self.qwz_block, topo=self.topo,
                    sources=sources)
            else:
                row = torch.cat([p.reshape(-1) for p in parts])
                flat = all_gather(row, self.axis, topo=self.topo)
                bucket = self._bucket(js, ms, key)
                fulls = [v for _, v in unflatten_bucket_shard_major(
                    bucket, flat, self.n)]
            for m, f in zip(ms, fulls):
                nbytes = f.numel() * f.element_size()
                self.live_bytes += nbytes
                weakref.finalize(f, self._release, nbytes)
                out[m] = f
            self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        return out

    def _bucket(self, js, ms, key) -> Bucket:
        slots, off = [], 0
        for m in ms:
            j = js[m]
            shape = self._shape(j, key)
            size = 1
            for d in shape:
                size *= d
            slots.append(Slot(leaf=m, offset=off, size=size, shape=shape,
                              shard_dim=self._dim(j, key)))
            off += size
        return Bucket(dtype="float32", slots=tuple(slots), numel=off,
                      scatter=True)

    # -- backward ------------------------------------------------------------

    def scatter_grads(self, js: Sequence[int], key,
                      grads: Sequence[Optional[torch.Tensor]]) -> None:
        """The segment's gradients: the sharded members' reduce-scattered
        in their own dtype (one call a dtype, as the reference's GSPMD
        reduces the cotangents it gets) and added into their f32 buffers,
        the others added whole."""
        from ...comm import reduce_scatter

        groups: Dict[torch.dtype, List[int]] = {}
        for m, (j, g) in enumerate(zip(js, grads)):
            buf = self.grads[j] if key is None else self.grads[j][key]
            if self.dims[j] is None:
                if g is not None:
                    buf.add_(g)
                continue
            dt = g.dtype if g is not None else self.shards[j].dtype
            groups.setdefault(dt, []).append(m)
        for dt, ms in groups.items():
            bucket = self._bucket(js, ms, key)
            dev = self.anchor.device
            full = {m: grads[m] if grads[m] is not None else torch.zeros(
                self._shape(js[m], key), dtype=dt, device=dev) for m in ms}
            flat = flatten_bucket_shard_major(bucket, full, self.n)
            del full
            local = reduce_scatter(flat, self.axis, topo=self.topo)
            del flat
            for m, v in unflatten_bucket_shard(bucket, local, self.n):
                j = js[m]
                buf = self.grads[j] if key is None else self.grads[j][key]
                buf.add_(v)

    # -- the hooks ---------------------------------------------------------

    def _apply(self, tree: Any, key, match) -> Any:
        found: List[Tuple[tuple, int, torch.Tensor]] = []

        def walk(node, path):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, path + (k,))
            elif isinstance(node, torch.Tensor):
                j = match(node)
                if j is not None:
                    found.append((path, j, node))

        walk(tree, ())
        if not found:
            return tree
        outs = _Gather.apply(self.anchor, self, key,
                             tuple(j for _, j, _ in found),
                             *(t for _, _, t in found))
        tree = _copy_dicts(tree)
        for (path, _, _), o in zip(found, outs):
            node = tree
            for k in path[:-1]:
                node = node[k]
            node[path[-1]] = o
        return tree

    def stream_in(self, tree: Dict[str, Any], i: int) -> Dict[str, Any]:
        """``maybe_stream_in``: layer ``i``'s slices of the stacked shards
        in ``tree`` gathered whole (anything else as it is)."""
        def match(t):
            j = self._index.get(id(_root(t)))
            return j if j is not None and self.layered[j] else None

        return self._apply(tree, i, match)

    def gather_tree(self, params: Any) -> Any:
        """The parameter tree a micro-batch's loss sees: every leaf that is
        not a stacked layer leaf gathered whole (once), the layer stacks
        as their shards (gathered per layer at the hook)."""
        def match(t):
            j = self._index.get(id(t))
            return j if j is not None and not self.layered[j] else None

        return self._apply(params, None, match)
