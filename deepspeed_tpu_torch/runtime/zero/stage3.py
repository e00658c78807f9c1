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

A frozen leaf (``grads[j]`` None: a LoRA node's base, its codes and
scales) is gathered outside autograd and takes no gradient.  The walk
enters node objects (``utils/tree_io.node_items``), so a LoRA node's
children are gathered where the layer uses them.

Offload at stage 3: every trained leaf's gradient — reduce-scattered,
then divided by the world's size and reduced over the rest of it — lands
in its host buffer through ``sink`` (a
:class:`~.param_offload.LayerStreamer`: the first micro-batch writes it,
later ones add), so no f32 gradient buffer lives on the card; ``host_sq``
is the weighted sum of squares of those gradients (first micro-batch).
With ``offload_param`` (ZeRO-Infinity) a ``streamed`` shard lies in host
memory (``runtime/zero/param_offload.HostArena``) and is copied to the
card inside the gather (``param_offload.COUNTS["stream_in"]``: L forward
+ L recompute a step), so neither the stacked shards nor their gradients
are ever whole on the card.
"""

from __future__ import annotations

import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ...utils.tree_io import node_items, node_rebuild
from ..coalesce import (Bucket, Slot, flatten_bucket_shard_major,
                        unflatten_bucket_shard, unflatten_bucket_shard_major)
from . import param_offload
from .param_offload import _root


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


def _rebuild(node: Any, path: tuple, new: Dict[tuple, Any]) -> Any:
    """``node`` with the leaves at the paths of ``new`` replaced (a
    module-level function: a recursive closure would hold the gathered
    tensors in a reference cycle until the collector ran)."""
    if path in new:
        return new[path]
    kids = None if isinstance(node, torch.Tensor) else node_items(node)
    if not kids:
        return node
    return node_rebuild(node, [_rebuild(v, path + (k,), new)
                               for k, v in kids])


class ShardGatherer:
    """The stage-3 gathering state of one engine.

    ``shards[j]`` is leaf ``j``'s local shard (the whole leaf where
    ``dims[j]`` is None), split along ``dims[j]`` over the ``n`` ranks of
    ``axis``; ``full_shapes[j]`` its whole shape; ``grads[j]`` its f32
    gradient buffer (the shard's shape; None: a frozen leaf, a host
    buffer: set by :meth:`to_host`); ``layered[j]``: the leaf is a stacked
    layer leaf, gathered per layer at the hook.  ``device`` is where the
    gathers land (a shard in host memory is copied there)."""

    def __init__(self, shards: Sequence[torch.Tensor],
                 dims: Sequence[Optional[int]],
                 full_shapes: Sequence[Tuple[int, ...]],
                 grads: Sequence[Optional[torch.Tensor]],
                 layered: Sequence[bool], n: int, axis: str = "fsdp",
                 topo=None, qwz: bool = False, qwz_bits: int = 8,
                 qwz_block: int = 256, device: Any = None):
        self.shards = list(shards)
        self.dims = list(dims)
        self.full_shapes = [tuple(s) for s in full_shapes]
        self.grads = list(grads)
        self.layered = list(layered)
        self.n, self.axis, self.topo = n, axis, topo
        self.qwz, self.qwz_bits, self.qwz_block = qwz, qwz_bits, qwz_block
        self._index = {id(_root(t)): j for j, t in enumerate(self.shards)}
        self.device = torch.device(device) if device is not None else (
            self.shards[0].device if self.shards else torch.device("cpu"))
        self.anchor = torch.zeros((), device=self.device, requires_grad=True)
        self.live_bytes = 0
        self.peak_live_bytes = 0
        # offload: the leaves whose gradients go to host buffers -> (the
        # axes a gradient is reduced over after the reduce-scatter, its
        # weight in the sum of squares)
        self.sink: Optional[param_offload.LayerStreamer] = None
        self._host: Dict[int, Tuple[Any, float]] = {}
        self.world = 1
        self.host_sq: Optional[torch.Tensor] = None
        #: the leaves whose shards lie in host memory (ZeRO-Infinity)
        self.streamed: set = set()

    def to_host(self, sink, leaves: Dict[int, Tuple[Any, float]],
                world: int) -> None:
        """Send the gradients of ``leaves`` ({leaf: (axes to reduce over
        after the reduce-scatter, sum-of-squares weight)}) to
        ``sink.grads[leaf]`` (host buffers), as means over ``world``
        ranks."""
        self.sink, self._host, self.world = sink, dict(leaves), world

    def begin(self, micro_batch: int) -> None:
        """Before each micro-batch's forward (ZeRO-Infinity's sink)."""
        if self.sink is not None:
            self.sink.begin(micro_batch)
            if micro_batch == 0:
                self.host_sq = torch.zeros((), dtype=torch.float32,
                                           device=self.device)

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
        if any(j in self.streamed for j in js):
            # ZeRO-Infinity: the host shards stream to the card here
            param_offload.COUNTS["stream_in"] += 1
            shards = [s.to(self.device, non_blocking=True) for s in shards]
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
                if f.data_ptr() % 16:
                    # a member at an odd offset of the gathered buffer
                    # (1-byte codes after others): the mixed GEMM's copies
                    # read 16-byte aligned rows
                    f = f.clone()
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
            if self.dims[j] is None:
                if g is None:
                    continue
                if j in self._host:
                    self._sink(j, key, g.float())
                else:
                    buf = self.grads[j] if key is None else self.grads[j][key]
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
                if j in self._host:
                    self._sink(j, key, v.float())
                    continue
                buf = self.grads[j] if key is None else self.grads[j][key]
                buf.add_(v)

    def _sink(self, j: int, key, g: torch.Tensor) -> None:
        """A host-buffered leaf's gradient part: the mean over the world,
        into its host buffer (``sink``)."""
        from ...comm import all_reduce

        axes, weight = self._host[j]
        if self.world > 1:
            g = g / self.world
        if axes is not None:
            all_reduce(g, axes, topo=self.topo)
        if self.sink._mb == 0:  # (a norm: no temporary the leaf's size)
            self.host_sq = self.host_sq + torch.linalg.vector_norm(
                g).square() * weight
        self.sink.sink(j, key, g)

    # -- the hooks ---------------------------------------------------------

    def _apply(self, tree: Any, key, match) -> Any:
        found: List[Tuple[tuple, int, torch.Tensor]] = []

        def walk(node, path):
            if isinstance(node, torch.Tensor):
                j = match(node)
                if j is not None:
                    found.append((path, j, node))
                return
            for k, v in node_items(node) or ():
                walk(v, path + (k,))

        walk(tree, ())
        if not found:
            return tree
        trained = [f for f in found if self.grads[f[1]] is not None]
        frozen = [f for f in found if self.grads[f[1]] is None]
        new = {}
        if trained:
            outs = _Gather.apply(self.anchor, self, key,
                                 tuple(j for _, j, _ in trained),
                                 *(t for _, _, t in trained))
            new.update({p: o for (p, _, _), o in zip(trained, outs)})
        if frozen:
            with torch.no_grad():
                outs = self.gather([j for _, j, _ in frozen], key,
                                   [t for _, _, t in frozen])
            new.update({p: o for (p, _, _), o in zip(frozen, outs)})
        return _rebuild(tree, (), new)

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
            j = self._index.get(id(_root(t)))
            return j if j is not None and not self.layered[j] else None

        return self._apply(params, None, match)
