"""ZeRO-Infinity parameter offload (``offload_param``) — the port of
``deepspeed_tpu/runtime/zero/param_offload.py``.

The reference places the stacked layer parameters in the accelerator's
``pinned_host`` memory space and moves each layer's slice to the device
inside the scanned layer body (``maybe_stream_in``); the remat'd backward
streams it again, so the device never holds the whole stack.  The port
does the same with eager tensors:

* :func:`offload_mask` picks the leaves of ``params["layers"]`` with at
  least ``min_numel`` elements (``stage3_param_persistence_threshold``).
  The port's ``ModelSpec.param_axes`` is unused, so the mask is decided by
  tree position: on the model zoo's trees it equals the reference's mask,
  whose rule is "leading logical axis ``layers``";
* the engine keeps those leaves in host memory (:class:`HostArena`:
  page-locked when the engine runs on the card) and installs a
  :class:`LayerStreamer` around its forward and backward;
* ``models/transformer.forward_hidden`` calls :func:`maybe_stream_in` on
  each layer's slice *inside* the checkpointed segment: the slice is copied
  to the card where the layer runs, and the recompute of a checkpointed
  layer copies it again instead of keeping every layer's device copy alive
  across the backward (``COUNTS["stream_in"]``: L forward + L recompute a
  step under the default remat);
* the copy is an autograd function whose backward writes the layer's f32
  gradient straight into the host optimizer's gradient buffer (a
  device-to-host copy per layer slice) and returns nothing to the host
  leaf: neither the stack's parameters nor its gradients are ever whole on
  the card;
* :class:`ParamSwapper` is the NVMe tier behind the f32 master
  (``master_{i}.bin``), with the reference's write-behind thread and a
  whole-tree read-ahead.

There is no fallback that keeps parameters resident: an engine on the card
whose host buffers cannot be page-locked raises.
"""

from __future__ import annotations

import mmap
import os
import threading
import weakref
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

#: copies of a layer's offloaded slice to the device (forward and recompute)
COUNTS = {"stream_in": 0}

_PAGE = 4096


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


# ---------------------------------------------------------------------------
# host memory
# ---------------------------------------------------------------------------


def _unregister(ptrs: List[int], keep: List[torch.Tensor]) -> None:
    cudart = torch.cuda.cudart()
    for p in ptrs:
        cudart.cudaHostUnregister(p)
    keep.clear()


class HostArena:
    """Host tensors for the offload tiers, page-locked when ``device`` is a
    CUDA device.

    Each buffer is an anonymous mapping of its own, registered with
    ``cudaHostRegister`` at its exact size (rounded to pages): PyTorch's
    pinned allocator caches by power-of-two size class, which would round
    a 3.8 GB leaf up to 4.3 GB.  No buffer is locked where the host
    allocator put it: malloc may carve even a 64 MiB tensor out of freed
    heap chunks, and its first and last pages are then shared with other
    allocations, which a registration rounded to pages would lock (and
    overlap with a neighbour's).  :attr:`tensor_bytes` counts the tensors'
    bytes, :attr:`pinned_bytes` the page-locked bytes behind them.  A
    failed registration raises; nothing falls back to pageable memory on
    the card.  The buffers are unregistered when the arena is released or
    collected."""

    def __init__(self, device: Any):
        self.pin = torch.device(device).type == "cuda"
        self.tensor_bytes = 0
        self.pinned_bytes = 0
        self._ptrs: List[int] = []
        self._keep: List[torch.Tensor] = []
        self._finalizer = weakref.finalize(self, _unregister, self._ptrs,
                                           self._keep) if self.pin else None

    def empty(self, shape: Sequence[int], dtype: torch.dtype
              ) -> torch.Tensor:
        shape = tuple(shape)
        itemsize = torch.empty((), dtype=dtype).element_size()
        nbytes = int(np.prod(shape, dtype=np.int64)) * itemsize
        self.tensor_bytes += nbytes
        if not self.pin or nbytes == 0:
            return torch.empty(shape, dtype=dtype)
        # an anonymous mapping of its own: page-aligned, and the storage
        # starts where the locked pages do (``is_pinned`` looks there)
        span = (nbytes + _PAGE - 1) // _PAGE * _PAGE
        raw = torch.frombuffer(mmap.mmap(-1, span), dtype=torch.uint8)
        self._register(raw, raw.data_ptr(), span)
        return raw[:nbytes].view(dtype).view(shape)

    def adopt(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` in arena memory: itself off the card, else a page-locked
        copy."""
        if not self.pin:
            self.tensor_bytes += t.numel() * t.element_size()
            return t
        return self.copy_of(t)

    def _register(self, owner: torch.Tensor, ptr: int, span: int) -> None:
        rc = torch.cuda.cudart().cudaHostRegister(ptr, span, 0)
        if int(rc) != 0:
            raise RuntimeError(
                f"cudaHostRegister of {span} host bytes failed ({rc}); the "
                "offload tiers need page-locked host memory")
        self._ptrs.append(ptr)
        self._keep.append(owner)
        self.pinned_bytes += span

    def copy_of(self, t: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """A host buffer holding ``t`` (cast to ``dtype``)."""
        out = self.empty(t.shape, dtype or t.dtype)
        out.copy_(t.detach())
        return out

    def release(self) -> None:
        if self._finalizer is not None:
            self._finalizer()


def is_page_locked(t: torch.Tensor) -> bool:
    """Whether ``t`` lies in page-locked host memory."""
    return t.device.type == "cpu" and torch.cuda.is_available() \
        and t.is_pinned()


# ---------------------------------------------------------------------------
# which leaves offload
# ---------------------------------------------------------------------------


def resolve_threshold(thresh: Any) -> int:
    """``stage3_param_persistence_threshold``: ``"auto"`` keeps leaves under
    100,000 elements on the device (the reference's resolution)."""
    return 100_000 if isinstance(thresh, str) else int(thresh)


def offload_mask(params: Any, min_numel: int = 0) -> Any:
    """Bool tree over ``params``: True for the leaves of the stacked
    ``params["layers"]`` with at least ``min_numel`` elements (the stack is
    found by tree position; the reference reads the ``layers`` axis)."""

    def mark(node, stacked):
        if isinstance(node, dict):
            return {k: mark(v, stacked or k == "layers" and node is params)
                    for k, v in node.items()}
        return bool(stacked) and node.numel() >= min_numel

    return mark(params, False)


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------

_ACTIVE: Optional["LayerStreamer"] = None


def maybe_stream_in(layer_tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i``'s parameter slices, the offloaded ones copied to the
    device; the tree as it is when no engine streams."""
    if _ACTIVE is None:
        return layer_tree
    return _ACTIVE.stream_in(layer_tree, i)


class _StreamIn(torch.autograd.Function):
    """Host slices -> device copies.  ``anchor`` (a 0-d tensor that
    requires grad) puts the copy on the backward's path; the backward hands
    each slice's gradient to the streamer and returns none to the host
    leaves."""

    @staticmethod
    def forward(ctx, anchor, streamer, i, leaves, *hosts):
        ctx.streamer, ctx.i, ctx.leaves = streamer, i, leaves
        COUNTS["stream_in"] += 1
        dev = streamer.device
        if dev.type == "cpu":
            return tuple(h.clone() for h in hosts)
        return tuple(h.to(dev, non_blocking=True) for h in hosts)

    @staticmethod
    def backward(ctx, *grads):
        for j, g in zip(ctx.leaves, grads):
            if g is not None:
                ctx.streamer.sink(j, ctx.i, g)
        return (None, None, None, None) + (None,) * len(grads)


class LayerStreamer:
    """The streaming state of one engine: which host leaves stream, where
    their gradients go, and the sum of their squares.

    ``grads[j]`` is the host f32 gradient buffer of leaf ``j`` (the host
    optimizer's); ``begin(micro_batch)`` precedes each micro-batch's
    forward.  On the card a slice's gradient is copied to the host on the
    compute stream; the first micro-batch writes the buffer, later ones
    land in ``scratch`` and :meth:`accumulate` adds them after the device
    is done."""

    def __init__(self, host_leaves: Dict[int, torch.Tensor], device: Any,
                 arena: HostArena):
        self.device = torch.device(device)
        self._index = {id(_root(t)): j for j, t in host_leaves.items()}
        self.arena = arena
        self.grads: Dict[int, torch.Tensor] = {}
        self.scratch: Dict[int, torch.Tensor] = {}
        self.anchor = torch.zeros((), device=self.device, requires_grad=True)
        self.sq = None  # sum of squares of this step's streamed gradients
        self._mb = 0

    def __enter__(self) -> "LayerStreamer":
        global _ACTIVE
        self._prev, _ACTIVE = _ACTIVE, self
        return self

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        _ACTIVE = self._prev

    def begin(self, micro_batch: int) -> None:
        self._mb = micro_batch
        if micro_batch == 0:
            self.sq = torch.zeros((), dtype=torch.float32, device=self.device)

    def stream_in(self, tree: Dict[str, Any], i: int) -> Dict[str, Any]:
        flat: List[tuple] = []

        def walk(node, path):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, path + (k,))
            elif isinstance(node, torch.Tensor):
                j = self._index.get(id(_root(node)))
                if j is not None:
                    flat.append((path, j, node))

        walk(tree, ())
        if not flat:
            return tree
        outs = _StreamIn.apply(self.anchor, self, i,
                               tuple(j for _, j, _ in flat),
                               *(t for _, _, t in flat))

        def put(node, path, val):
            if len(path) == 1:
                node[path[0]] = val
                return
            put(node[path[0]], path[1:], val)

        tree = _copy_dicts(tree)
        for (path, _, _), out in zip(flat, outs):
            put(tree, path, out)
        return tree

    def sink(self, j: int, i: Optional[int], g: torch.Tensor) -> None:
        """Leaf ``j``'s gradient (layer ``i``'s slice of it; None: the
        whole leaf) into its host buffer."""
        g = g.float()
        if self._mb == 0:
            self.sq = self.sq + torch.linalg.vector_norm(g).square()
            _part(self.grads[j], i).copy_(g, non_blocking=True)
        elif self.device.type == "cpu":
            _part(self.grads[j], i).add_(g)
        else:
            if j not in self.scratch:
                self.scratch[j] = self.arena.empty(self.grads[j].shape,
                                                   torch.float32)
            _part(self.scratch[j], i).copy_(g, non_blocking=True)

    def accumulate(self) -> None:
        """After a later micro-batch's backward on the card: add its
        gradients (in ``scratch``) into the buffers."""
        if self.device.type == "cpu" or self._mb == 0:
            return
        torch.cuda.current_stream(self.device).synchronize()
        for j, s in self.scratch.items():
            self.grads[j].add_(s)


def _part(t: torch.Tensor, i: Optional[int]) -> torch.Tensor:
    return t if i is None else t[i]


def _root(t: torch.Tensor) -> torch.Tensor:
    """The tensor whose storage ``t`` views (a view's ``_base`` is the
    root of its chain; an arena buffer is itself a view of its mapping)."""
    return t._base if t._base is not None else t


def _copy_dicts(tree):
    if isinstance(tree, dict):
        return {k: _copy_dicts(v) for k, v in tree.items()}
    return tree


# ---------------------------------------------------------------------------
# NVMe tier of the f32 master
# ---------------------------------------------------------------------------


def host_view(t: torch.Tensor) -> np.ndarray:
    """A numpy view of a contiguous CPU tensor's bytes (bf16 as uint16)."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.uint16)
    return t.numpy()


class ParamSwapper:
    """Pages a list of host tensors to NVMe and back through the AIO
    library (reference ``ParamSwapper``: ``{prefix}_{i}.bin``, async writes
    released by a background waiter, one whole-list read-ahead)."""

    def __init__(self, swap_dir: str, aio_cfg=None, prefix: str = "param"):
        from ...nvme.aio_handle import AsyncIOHandle
        from ..config import AIOConfig

        aio_cfg = aio_cfg or AIOConfig()
        os.makedirs(swap_dir, exist_ok=True)
        self._dir = swap_dir
        self._prefix = prefix
        self._aio = AsyncIOHandle(block_size=aio_cfg.block_size,
                                  queue_depth=aio_cfg.queue_depth,
                                  thread_count=aio_cfg.thread_count)
        self._specs: List[tuple] = []
        self._read_reqs: Optional[list] = None
        self._read_bufs: Optional[list] = None
        self._write_waiter: Optional[threading.Thread] = None

    def _path(self, i: int) -> str:
        return os.path.join(self._dir, f"{self._prefix}_{i}.bin")

    def write_behind(self, tensors: List[torch.Tensor]) -> None:
        """Start writing every tensor and return; the caller may drop its
        references, and a background waiter releases the buffers as soon
        as the writes land."""
        if self._write_waiter is not None:
            # never two write sets in flight to the same files
            self._write_waiter.join()
            self._write_waiter = None
        self._specs = []
        reqs = []
        for i, t in enumerate(tensors):
            t = t.detach().contiguous()
            self._specs.append((tuple(t.shape), t.dtype))
            reqs.append(self._aio.pwrite(self._path(i), host_view(t)))

        def release():
            for r in reqs:
                try:
                    self._aio.wait(r)
                except OSError:
                    pass  # surfaced again, loudly, by the next read

        self._write_waiter = threading.Thread(target=release, daemon=True)
        self._write_waiter.start()

    def read_ahead(self) -> None:
        """Start reading every tensor back into fresh host buffers."""
        if self._read_reqs is not None:
            return
        if self._write_waiter is not None:
            # the writes land before the files are read back
            self._write_waiter.join()
            self._write_waiter = None
        reqs, bufs = [], []
        for i, (shape, dtype) in enumerate(self._specs):
            buf = torch.empty(shape, dtype=dtype)
            reqs.append(self._aio.pread(self._path(i), host_view(buf)))
            bufs.append(buf)
        self._read_reqs, self._read_bufs = reqs, bufs

    def wait_in(self) -> List[torch.Tensor]:
        """Block until the read-ahead lands; the tensors."""
        if self._read_reqs is None:
            self.read_ahead()
        for r in self._read_reqs:
            self._aio.wait(r)
        bufs = self._read_bufs
        self._read_reqs = self._read_bufs = None
        return bufs

    def drain(self) -> None:
        if self._write_waiter is not None:
            self._write_waiter.join()
            self._write_waiter = None
        self._aio.wait_all()
