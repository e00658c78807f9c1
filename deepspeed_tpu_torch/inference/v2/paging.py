"""Host-DRAM paging tier for cold KV blocks (ZeRO-Infinity for inference)
— the port of ``deepspeed_tpu/inference/v2/paging.py``.

The serving analogue of the reference's offload layer (swap_tensor / aio /
nvme, PAPER.md layer 7): under HBM pressure the prefix cache used to
**evict** LRU radix leaves, so a returning session paid full recompute.
With a :class:`BlockPager` attached, those leaves are **demoted** instead —
their KV block bytes move to a bounded host-DRAM pool (tier "host"), and
when that pool overflows, oldest-first to safetensors spill files on disk
(tier "spill") written through ``io/fast_writer.py``'s FastPersist path.
The radix tree keeps the node; a later match promotes the bytes back into
a freshly-allocated device block instead of recomputing prefill.

Tiering is exclusive: a block's bytes live in exactly one tier at a time
(device OR host OR spill OR cold).  Promotion drops the paged copy;
re-demotion re-serializes (a host-side memcpy — cheap next to the
prefill it saves).

With a :class:`~.coldstore.ColdStore` attached, the crash-durable cold
tier **replaces** bare spill files as the bottom tier: host-pool
overflow lands as manifest-verified committed entries (tier "cold")
keyed by the caller-supplied *durable key* instead of the process-local
handle integer, so the warm set survives the process.  A respawned
worker re-adopts surviving entries through :meth:`BlockPager.adopt`
(see ``engine.rehydrate_coldstore``), and startup sweeps both
uncommitted cold-store staging and orphaned ``kvblock-*.safetensors``
spill files a crashed predecessor leaked.

Serialization is the engine's existing safetensors block layer
(``build_safetensors_header`` — the same bytes ``export_prefix`` ships
between replicas), so a host-pool entry IS a valid safetensors payload and
the spill file IS a valid safetensors file.

Threading (``named_lock`` discipline): all pool state lives under
``named_lock("paging.pool")``; file IO — spill writes, spill reads, unlink
— ALWAYS happens with no lock held (entries in transit are visible in a
side map so readers never miss them).  The optional promote-ahead thread
only moves bytes disk→host-staging; it never touches the device, the
radix tree, or the allocator — those mutations stay on the engine thread,
as does every CUDA copy (the engine's ``_read_kv_block`` / ``_promote_node``).

Port: a block's arrays are torch CPU tensors (numpy arrays are accepted
too).  bf16 is carried as a tensor and serialized as its bits under the
dtype ``"BF16"`` (``utils/tree_io``), so :func:`serialize_block` is byte
for byte the reference's without ``ml_dtypes``; :func:`deserialize_block`
returns CPU tensors viewing the payload.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Any, Dict, List, Optional, Tuple

import warnings

import torch

from ...io.fast_writer import FastFileWriter, header_from_host
from ...utils.tree_io import TORCH_DTYPES, host_arrays
from ...utils.locks import named_lock
from ...utils.logging import logger
from .coldstore import GC_SWEEP_LIMIT, ColdStore


def serialize_block(arrays: Dict[str, Any],
                    metadata: Optional[Dict[str, str]] = None) -> bytes:
    """One KV block as a safetensors payload (header + raw tensor bytes in
    offset order) — byte-compatible with ``engine.export_prefix`` and with
    the reference's ``serialize_block``."""
    hosts = host_arrays(arrays)
    header, _offsets, _total = header_from_host(hosts, metadata)
    parts = [header]
    for arr, _ in hosts.values():  # dict order == offset order
        parts.append(arr.tobytes())
    return b"".join(parts)


def deserialize_block(payload: bytes) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`serialize_block`: CPU tensors viewing the payload
    (read-only memory: copy them before writing into one)."""
    hlen = int.from_bytes(payload[:8], "little")
    hdr = json.loads(payload[8:8 + hlen].decode())
    base = 8 + hlen
    hdr.pop("__metadata__", None)
    out: Dict[str, torch.Tensor] = {}
    for name, ent in hdr.items():
        lo, hi = ent["data_offsets"]
        dtype = TORCH_DTYPES[ent["dtype"]]
        count = (hi - lo) // torch.empty((), dtype=dtype).element_size()
        if count == 0:
            out[name] = torch.empty(ent["shape"], dtype=dtype)
            continue
        with warnings.catch_warnings():
            # a bytes payload is immutable; the tensors only feed copies
            warnings.simplefilter("ignore", UserWarning)
            out[name] = torch.frombuffer(
                payload, dtype=dtype, count=count, offset=base + lo
            ).reshape(ent["shape"])
    return out


class BlockPager:
    """Two-tier (host DRAM → optional disk spill) store of demoted KV
    blocks, keyed by an opaque integer handle.

    * :meth:`put` serializes a block's arrays into the host pool and
      returns ``(handle, tier)``; when the pool is over ``host_bytes`` it
      spills its OLDEST entries to ``spill_dir`` first, and returns
      ``None`` only when neither tier has room (no spill dir) — the
      caller then falls back to true eviction, so a full pager degrades
      to exactly the old behaviour.
    * :meth:`get` returns the block's arrays from whichever tier holds it
      (staged prefetch → host → in-flight spill → disk).
    * :meth:`prefetch` enqueues handles for the background thread to lift
      disk entries into a host-side staging map ahead of the engine's
      next scheduled step (the "async promote" half: the device scatter
      itself stays on the engine thread).
    * :meth:`drop` forgets a handle everywhere (called after a successful
      promote, and by ``reset``).
    """

    def __init__(self, host_bytes: int, spill_dir: str = "",
                 promote_ahead: bool = False,
                 coldstore: Optional[ColdStore] = None):
        self.host_bytes = int(host_bytes)
        self.spill_dir = spill_dir
        self.coldstore = coldstore
        self._lock = named_lock("paging.pool")
        self._next = 1
        self._host: Dict[int, bytes] = {}      # handle -> payload (FIFO)
        self._spilling: Dict[int, bytes] = {}  # write in flight, still readable
        # handle -> spill file path, or cold-store key when a ColdStore
        # is attached (the cold tier replaces bare spill files)
        self._spill: Dict[int, str] = {}
        self._staged: Dict[int, bytes] = {}    # prefetched from disk
        # handle -> (durable key, manifest meta) for cold-tier writes
        self._durable: Dict[int, Tuple[Optional[str], Optional[Dict[str, Any]]]] = {}
        self._host_used = 0
        # counters (engine/serving metrics read these as monotonic)
        self.demotions = 0
        self.promotions = 0
        self.spills = 0
        self.rehydrated = 0
        self.gc_spill_files = 0
        self.promote_wait_total_ms = 0.0
        self.promote_wait_samples: List[float] = []
        self._writer: Optional[FastFileWriter] = None
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)
            self._sweep_orphan_spill_files()
        if spill_dir and coldstore is None:
            # modest geometry: one KV block per file, not a checkpoint
            self._writer = FastFileWriter(block_size=1 << 20, queue_depth=8,
                                          thread_count=2, fsync=False)
        self._queue: "queue.Queue[Optional[int]]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        if promote_ahead:
            self._thread = threading.Thread(
                target=self._prefetch_loop, name="kv-promote-ahead",
                daemon=True)
            self._thread.start()

    def _sweep_orphan_spill_files(self) -> None:
        """Startup GC: a crashed predecessor's spill files are dead — the
        handle numbers that keyed them died with its process (and a fresh
        pager would re-number from 1, silently aliasing them).  Bounded
        per boot, counted, logged."""
        try:
            names = sorted(os.listdir(self.spill_dir))
        except OSError:
            return
        swept = 0
        for name in names:
            if not (name.startswith("kvblock-")
                    and name.endswith(".safetensors")):
                continue
            if swept >= GC_SWEEP_LIMIT:
                logger.warning(
                    f"paging: orphan sweep hit {GC_SWEEP_LIMIT}-file boot "
                    f"cap in {self.spill_dir}; remainder deferred")
                break
            try:
                os.unlink(os.path.join(self.spill_dir, name))
                swept += 1
            except OSError:
                pass
        if swept:
            logger.warning(f"paging: swept {swept} orphaned spill file"
                           f"{'' if swept == 1 else 's'} from "
                           f"{self.spill_dir}")
            self.gc_spill_files = swept

    # -- tier gauges (int reads; safe from any thread) -------------------

    @property
    def host_blocks(self) -> int:
        return len(self._host) + len(self._spilling)

    # A staged handle is a prefetched COPY of an entry that stays in
    # ``_spill`` until the handle is dropped (``_staged`` is a subset of
    # ``_spill``), so the gauges count ``_spill`` alone.  The reference
    # adds ``len(_staged)`` as well, counting a prefetched block twice until
    # it is promoted or dropped, so its ``check_consistency`` fails while a
    # prefetched block waits (ROADMAP.md queue C, C2).

    @property
    def spill_blocks(self) -> int:
        if self.coldstore is not None:
            return 0
        return len(self._spill)

    @property
    def cold_blocks(self) -> int:
        """Blocks whose bytes live in the crash-durable cold store
        (staged prefetch copies are not counted again)."""
        if self.coldstore is None:
            return 0
        return len(self._spill)

    @property
    def resident_blocks(self) -> int:
        """Blocks held by the pager across all its tiers."""
        with self._lock:
            return len(self._host) + len(self._spilling) + len(self._spill)

    def record_promote_wait(self, ms: float) -> None:
        """Engine-reported end-to-end promote latency (fetch + device
        scatter) — the SLO-facing number."""
        with self._lock:
            self.promote_wait_total_ms += ms
            self.promote_wait_samples.append(ms)
            if len(self.promote_wait_samples) > 4096:
                del self.promote_wait_samples[:2048]

    # -- demote ----------------------------------------------------------

    def put(self, arrays: Dict[str, Any],
            metadata: Optional[Dict[str, str]] = None,
            durable_key: Optional[str] = None
            ) -> Optional[Tuple[int, str]]:
        """Adopt a demoted block.  Returns ``(handle, tier)``, or ``None``
        when full (caller falls back to eviction).  ``durable_key`` names
        the block in the cold store should it overflow there — without
        one, a cold entry gets an ``anon-<handle>`` key that is still
        crash-safe but not rehydratable (nothing can re-derive it)."""
        payload = serialize_block(arrays, metadata)  # pure CPU, no lock
        spill_work: List[Tuple[int, bytes]] = []
        bottom = "cold" if self.coldstore is not None else "spill"
        with self._lock:
            if self._closed:
                return None
            projected = self._host_used + len(payload)
            if (projected > self.host_bytes and self._writer is None
                    and self.coldstore is None):
                # no bottom tier to push the overflow into; anything the
                # pager silently forgot would be a lost block, so refuse —
                # the caller degrades to plain eviction
                return None
            handle = self._next
            self._next += 1
            self._host[handle] = payload
            self._host_used += len(payload)
            if self.coldstore is not None:
                self._durable[handle] = (durable_key, metadata)
            tier = "host"
            while self._host_used > self.host_bytes and self._host:
                old, buf = next(iter(self._host.items()))
                del self._host[old]
                self._host_used -= len(buf)
                self._spilling[old] = buf
                spill_work.append((old, buf))
            if handle not in self._host:  # the new entry itself spilled
                tier = bottom
        for old, buf in spill_work:  # file IO with no lock held
            self._write_spill(old, buf)
        with self._lock:
            self.demotions += 1
        return handle, tier

    def adopt(self, durable_key: str, nbytes: int = 0,
              metadata: Optional[Dict[str, str]] = None) -> Optional[int]:
        """Re-adopt a surviving cold-store entry at restart WITHOUT
        rewriting it: registers a fresh handle pointing at ``durable_key``
        in the cold tier.  Callers verify the entry first
        (``coldstore.read``) — adopt itself is pure bookkeeping."""
        if self.coldstore is None:
            return None
        with self._lock:
            if self._closed:
                return None
            handle = self._next
            self._next += 1
            self._spill[handle] = durable_key  # cold tier: key, not path
            self._durable[handle] = (durable_key, metadata)
            self.rehydrated += 1
        return handle

    def _spill_path(self, handle: int) -> str:
        return os.path.join(self.spill_dir, f"kvblock-{handle}.safetensors")

    def _write_spill(self, handle: int, payload: bytes) -> None:
        if self.coldstore is not None:
            self._write_cold(handle, payload)
            return
        path = self._spill_path(handle)
        arrays = deserialize_block(payload)
        assert self._writer is not None
        self._writer.write_safetensors(arrays, path)
        with self._lock:
            if handle in self._spilling:  # not dropped mid-write
                del self._spilling[handle]
                self._spill[handle] = path
                self.spills += 1
            else:
                try:
                    os.unlink(path)
                except OSError:
                    pass

    def _write_cold(self, handle: int, payload: bytes) -> None:
        """Cold-tier overflow: one committed, manifest-verified entry
        under the block's durable key (IO with no lock held)."""
        with self._lock:
            key, meta = self._durable.get(handle, (None, None))
        if not key:
            key = f"anon-{handle}"  # crash-safe but not rehydratable
        assert self.coldstore is not None
        self.coldstore.write(key, payload, meta)
        kept = False
        with self._lock:
            if handle in self._spilling:  # not dropped mid-write
                del self._spilling[handle]
                self._spill[handle] = key
                self.spills += 1
                kept = True
        if not kept:  # dropped mid-write: the entry is already garbage
            self.coldstore.delete(key)

    # -- promote ---------------------------------------------------------

    def get(self, handle: int) -> Optional[Dict[str, torch.Tensor]]:
        """The block's arrays, from whichever tier holds it; ``None`` for
        an unknown handle.  Does NOT drop the entry — callers drop only
        after the device scatter succeeded, so a failed promote (no free
        device block) loses nothing."""
        with self._lock:
            buf = (self._staged.get(handle) or self._host.get(handle)
                   or self._spilling.get(handle))
            ref = None if buf is not None else self._spill.get(handle)
        if buf is not None:
            arrays = deserialize_block(buf)
        elif ref is not None and self.coldstore is not None:
            data = self.coldstore.read(ref)  # verify-before-adopt; no lock
            if data is None:  # torn/corrupt entry GC'd — degrade, never
                return None   # wrong tokens (caller re-prefills)
            arrays = deserialize_block(data)
        elif ref is not None:
            try:
                with open(ref, "rb") as f:  # IO with no lock held
                    data = f.read()
            except OSError:
                return None
            arrays = deserialize_block(data)
        else:
            return None
        with self._lock:
            self.promotions += 1
        return arrays

    def drop(self, handle: int) -> None:
        """Forget a handle everywhere (post-promote, or tree reset)."""
        with self._lock:
            buf = self._host.pop(handle, None)
            if buf is not None:
                self._host_used -= len(buf)
            self._staged.pop(handle, None)
            # an entry mid-spill is dropped by the writer when it notices
            self._spilling.pop(handle, None)
            ref = self._spill.pop(handle, None)
            self._durable.pop(handle, None)
        if ref is None:
            return
        if self.coldstore is not None:
            # tiering stays exclusive: a promoted block's cold entry is
            # dropped — durability covers the warm set AT crash time
            self.coldstore.delete(ref)  # IO with no lock held
        else:
            try:
                os.unlink(ref)  # IO with no lock held
            except OSError:
                pass

    def forget(self, handle: int) -> None:
        """Release a handle's bookkeeping WITHOUT touching disk — the
        unwind for a duplicate re-adopt, whose durable key is shared with
        a live handle that still needs the entry."""
        with self._lock:
            buf = self._host.pop(handle, None)
            if buf is not None:
                self._host_used -= len(buf)
            self._staged.pop(handle, None)
            self._spilling.pop(handle, None)
            self._spill.pop(handle, None)
            self._durable.pop(handle, None)

    # -- promote-ahead (background, host-side only) ----------------------

    def prefetch(self, handles: List[int]) -> None:
        """Ask the background thread to lift spill entries into the staging
        map so the engine's synchronous :meth:`get` finds them in DRAM.
        No-op without a promote-ahead thread, or for host-tier handles."""
        if self._thread is None:
            return
        for h in handles:
            self._queue.put(h)

    def _prefetch_loop(self) -> None:
        while True:
            handle = self._queue.get()  # blocking wait holds NO lock
            if handle is None:
                return
            with self._lock:
                if (self._closed or handle in self._staged
                        or handle in self._host or handle in self._spilling):
                    continue
                ref = self._spill.get(handle)
            if ref is None:
                continue
            if self.coldstore is not None:
                data = self.coldstore.read(ref)  # IO with no lock held
                if data is None:
                    continue
            else:
                try:
                    with open(ref, "rb") as f:  # IO with no lock held
                        data = f.read()
                except OSError:
                    continue
            with self._lock:
                if handle in self._spill:  # not dropped during the read
                    self._staged[handle] = data

    # -- lifecycle -------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        with self._lock:
            bottom = len(self._spill)
            cold = self.coldstore is not None
            out = {
                "tier_host_blocks": len(self._host) + len(self._spilling),
                "tier_spill_blocks": 0 if cold else bottom,
                "tier_cold_blocks": bottom if cold else 0,
                "demotions": self.demotions,
                "promotions": self.promotions,
                "spills": self.spills,
                "rehydrated_blocks": self.rehydrated,
                "gc_spill_files": self.gc_spill_files,
                "promote_wait_ms": self.promote_wait_total_ms,
                "host_bytes_used": self._host_used,
            }
        if self.coldstore is not None:
            out.update(self.coldstore.stats())  # IO with no lock held
        return out

    def promote_wait_percentiles(self) -> Dict[str, float]:
        with self._lock:
            samples = sorted(self.promote_wait_samples)
        if not samples:
            return {"p50": 0.0, "p95": 0.0, "p99": 0.0}
        def pct(p: float) -> float:
            i = min(len(samples) - 1, int(round(p * (len(samples) - 1))))
            return samples[i]
        return {"p50": pct(0.50), "p95": pct(0.95), "p99": pct(0.99)}

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._writer is not None:
            self._writer.close()
            self._writer = None
