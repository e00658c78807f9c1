"""Multi-tenant adapter serving — the port of
``deepspeed_tpu/serving/adapters.py``: per-request LoRA routing over one
shared (optionally quantized) base (S-LoRA, Sheng et al. 2023; batched
heterogeneous-adapter compute per Punica, Chen et al. 2023).

Three layers in this module (host logic, copied and adapted; packs are
numpy arrays, device slots torch tensors of the engine's stack):

* **checkpoint seam** — :func:`publish_adapter` commits an adapter-only
  tree (``adapter_model.safetensors`` + sha256 manifest, the PR-2 PEFT
  checkpoint format under the PR-13 rollout commit protocol) and
  :func:`load_adapter_pack` loads/validates one back into the stacked
  per-target ``(lora_a, lora_b)`` arrays the engine's adapter stack
  takes, folding the published scaling into ``lora_b`` and zero-padding
  rank up to the deployment's ``adapter_rank``;
* **:class:`AdapterRegistry`** — the per-replica residency manager: every
  registered adapter's bytes live in a dedicated :class:`BlockPager`
  (host DRAM pool → optional disk spill — the PR-18 paging discipline,
  same serialization, same tier gauges), and a refcounted LRU maps the
  hot subset onto the engine's device adapter slots.  ``acquire`` at
  admission promotes host bytes into a free (or LRU-evicted idle) slot;
  ``release`` at completion lets the slot become evictable again.  A
  request whose adapter cannot get a slot RIGHT NOW (every slot pinned
  by running rows) raises :class:`AdapterCapacityError`, which the
  broker treats exactly like KV ``AdmissionError`` — defer, not fail;
* **fleet hot-load** — :func:`fleet_register` / :func:`fleet_retire`
  walk a live replica pool and register/retire an adapter on every
  healthy replica through the transport control ops, gated by the same
  ``verify_checkpoint`` manifest check as rolling weight swaps.  No
  restart, no drain: the base model and every other adapter keep
  serving while a new tenant's adapter loads.

Threading: all registry state lives under ``named_lock(
"adapters.registry")``, which nests INSIDE ``broker.state`` (the broker
acquires/releases around admission) and OUTSIDE ``paging.pool`` (the
pager's own lock) — a strict widening of the existing
``broker.state → paging.pool`` order, so lockdep stays clean.  Slot
mutations (``engine.set_adapter_slot`` / ``clear_adapter_slot``) happen
under the registry lock so a control-thread register/retire can never
interleave a read-modify-write of the stack with the engine thread's
promote.  Checkpoint/pager file IO happens with the registry lock held
only on the rare spill path; the common promote is a host-DRAM read.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..inference.v2.coldstore import ColdStore
from ..inference.v2.engine import ADAPTER_TARGETS, adapter_target_shapes
from ..inference.v2.paging import BlockPager, deserialize_block
from ..observability.recorder import recorder
from ..observability.trace import tracer
from ..utils import faults
from ..utils.locks import named_lock
from ..utils.logging import logger


class AdapterError(ValueError):
    """Malformed adapter checkpoint / unknown adapter id / bad geometry."""


class AdapterCapacityError(RuntimeError):
    """Every device adapter slot is pinned by a running request — the
    caller defers admission (capacity frees as requests finish), exactly
    like the KV pool's
    :class:`~deepspeed_tpu_torch.inference.v2.engine.AdmissionError`."""


# ---------------------------------------------------------------------------
# checkpoint seam (publish / load-validate)
# ---------------------------------------------------------------------------


def publish_adapter(adapter_tree: Any, save_dir: str, adapter_id: str,
                    scaling: float = 1.0) -> str:
    """Commit an adapter-only tree as a hot-loadable artifact: stages
    ``adapter_model.safetensors`` into ``<adapter_id>.tmp``, writes the
    sha256 manifest (meta carries the LoRA ``scaling``, which the PEFT
    checkpoint format keeps out of the tensor file), atomically renames.
    Same commit protocol as ``rollout.publish_params``, so
    :func:`fleet_register`'s pre-check accepts exactly the directories
    that can fully load.  Returns the committed directory."""
    from ..runtime.checkpoint.engine import (_commit_dir, _save_tree,
                                             _write_manifest)
    os.makedirs(save_dir, exist_ok=True)
    final_dir = os.path.join(save_dir, adapter_id)
    tmp_dir = final_dir + ".tmp"
    os.makedirs(tmp_dir, exist_ok=True)
    _save_tree(adapter_tree, os.path.join(tmp_dir,
                                          "adapter_model.safetensors"))
    _write_manifest(tmp_dir, {"kind": "adapter_only",
                              "adapter_id": adapter_id,
                              "adapter_scaling": float(scaling)},
                    algorithm="sha256")
    _commit_dir(tmp_dir, final_dir)
    logger.info(f"adapters: published {adapter_id} -> {final_dir}")
    return final_dir


def load_adapter_pack(ckpt_dir: str, model_cfg, adapter_rank: int,
                      scaling: Optional[float] = None
                      ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Load an adapter-only checkpoint into the engine's pack format:
    ``{target: (lora_a (L, K, rank), lora_b (L, rank, N))}`` host arrays
    with scaling folded into ``lora_b`` and rank zero-padded EXACTLY to
    ``adapter_rank`` (zero columns contribute a zero delta, so padding is
    bit-free).  Validates manifest integrity, target support (the serving
    adapter path covers the attention projections — MLP targets are a
    training-only option and are rejected here, not silently dropped),
    and shape agreement with ``model_cfg``."""
    from ..runtime.checkpoint.engine import (_load_tree_flat,
                                             verify_checkpoint)

    problems = verify_checkpoint(ckpt_dir)
    if problems:
        raise AdapterError(f"refusing adapter from {ckpt_dir}: "
                           + "; ".join(problems))
    if scaling is None:
        with open(os.path.join(ckpt_dir, "manifest.json")) as f:
            meta = json.load(f).get("meta", {})
        scaling = float(meta.get("adapter_scaling", 1.0))
    flat = _load_tree_flat(os.path.join(ckpt_dir,
                                        "adapter_model.safetensors"))
    halves: Dict[str, Dict[str, np.ndarray]] = {}
    for key, t in flat.items():
        arr = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
        parts = key.split("/")
        leaf = parts[-1]
        if leaf not in ("lora_a", "lora_b"):
            raise AdapterError(f"{ckpt_dir}: non-adapter leaf {key!r} in an "
                               "adapter-only checkpoint")
        target = parts[-2] if len(parts) >= 2 else ""
        if target not in ADAPTER_TARGETS:
            raise AdapterError(
                f"{ckpt_dir}: adapter targets {target!r} ({key}); the "
                f"serving adapter path supports {ADAPTER_TARGETS} only — "
                "merge MLP-target adapters offline (export_merged_weights)")
        halves.setdefault(target, {})[leaf] = np.asarray(arr)
    shapes = adapter_target_shapes(model_cfg)
    L = model_cfg.num_layers
    pack: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for target, h in sorted(halves.items()):
        if "lora_a" not in h or "lora_b" not in h:
            raise AdapterError(f"{ckpt_dir}: target {target!r} missing one "
                               "of lora_a/lora_b")
        a = h["lora_a"].astype(np.float32)
        b = h["lora_b"].astype(np.float32)
        K, N = shapes[target]
        if a.ndim != 3 or b.ndim != 3 or a.shape[0] != L or b.shape[0] != L:
            raise AdapterError(
                f"{ckpt_dir}: target {target!r} wants layer-stacked factors "
                f"a (L={L}, K, r) / b (L, r, N); got a{a.shape} b{b.shape}")
        r = a.shape[2]
        if a.shape[1] != K or b.shape[2] != N or b.shape[1] != r:
            raise AdapterError(
                f"{ckpt_dir}: target {target!r} shape mismatch for this "
                f"model: a{a.shape} b{b.shape}, want a({L},{K},r) "
                f"b({L},r,{N})")
        if r > adapter_rank:
            raise AdapterError(
                f"{ckpt_dir}: target {target!r} rank {r} exceeds the "
                f"deployment's adapter_rank {adapter_rank}")
        b = b * np.float32(scaling)
        if r < adapter_rank:
            a = np.concatenate(
                [a, np.zeros((L, K, adapter_rank - r), np.float32)], axis=2)
            b = np.concatenate(
                [b, np.zeros((L, adapter_rank - r, N), np.float32)], axis=1)
        pack[target] = (a, b)
    if not pack:
        raise AdapterError(f"{ckpt_dir}: no adapter leaves found")
    return pack


def _arrays_from_pack(pack: Dict[str, Tuple[np.ndarray, np.ndarray]]
                      ) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for target, (a, b) in sorted(pack.items()):
        out[f"{target}/a"] = a
        out[f"{target}/b"] = b
    return out


def _pack_from_arrays(arrays: Dict[str, Any]
                      ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Inverse of :func:`_arrays_from_pack` over a deserialized payload
    (CPU tensors viewing it): numpy arrays."""
    pack: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for key in arrays:
        target, half = key.rsplit("/", 1)
        if half == "a":
            pack[target] = (np.asarray(arrays[key]),
                            np.asarray(arrays[f"{target}/b"]))
    return pack


# ---------------------------------------------------------------------------
# per-replica residency manager
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Entry:
    adapter_id: str
    handle: int            # this registry's pager handle (host/spill bytes)
    nbytes: int
    slot: Optional[int] = None   # device slot while resident
    refs: int = 0                # running requests pinning the slot
    lru: int = 0                 # last-acquire clock tick
    loads: int = 0               # promotions of THIS adapter
    retired: bool = False


class AdapterRegistry:
    """See module docstring.  ``engine`` must be an
    :class:`~deepspeed_tpu_torch.inference.v2.engine.InferenceEngineV2` built
    with ``adapter_slots``/``adapter_rank``; the registry owns a private
    :class:`BlockPager` for the host tier (``host_bytes`` /
    ``spill_dir`` mirror the KV pager knobs)."""

    def __init__(self, engine, host_bytes: int = 256 << 20,
                 spill_dir: str = "", name: str = "replica0",
                 coldstore_dir: str = ""):
        if getattr(engine, "adapter_stack", None) is None:
            raise AdapterError(
                "AdapterRegistry needs an engine built with adapter_slots "
                "(and adapter_rank) > 0")
        self.engine = engine
        self.name = name
        cold = ColdStore(coldstore_dir) if coldstore_dir else None
        self.pager = BlockPager(host_bytes, spill_dir=spill_dir,
                                coldstore=cold)
        self._lock = named_lock("adapters.registry")
        self._entries: Dict[str, _Entry] = {}
        self._free: List[int] = list(range(1, engine.cfg.adapter_slots))
        self._clock = 0
        # counters (serving metrics read these via stats())
        self.loads = 0          # host->device promotions
        self.evictions = 0      # device->host demotions (slot reclaims)
        self.hits = 0           # acquire() found the adapter resident
        self.capacity_deferrals = 0
        self.rehydrated = 0     # entries re-adopted from the cold store
        if cold is not None:
            self._rehydrate(cold)

    # -- restart rehydration (construction time, pre-traffic) -------------

    def _rehydrate(self, cold: ColdStore) -> None:
        """Re-adopt adapter packs a crashed (or restarted) predecessor
        spilled to the cold store: each surviving, manifest-verified entry
        becomes a registered-but-cold entry (no device slot) that a later
        ``acquire`` promotes through the normal path.  Entries with the
        wrong geometry for this deployment are deleted, not adopted —
        degrade to re-register, never to a wrong delta."""
        sp = tracer.begin("coldstore/rehydrate_adapters", replica=self.name)
        adopted = dropped = 0
        for key, meta, nbytes in cold.entries():
            if meta.get("kind") != "adapter_pack":
                continue
            faults.maybe_fail("serving.coldstore.rehydrate")
            adapter_id = str(meta.get("adapter_id", ""))
            payload = cold.read(key)  # verify-before-adopt; corrupt → GC'd
            if payload is None or not adapter_id \
                    or adapter_id in self._entries:
                dropped += 1
                continue
            try:
                pack = _pack_from_arrays(deserialize_block(payload))
                self._check_pack(pack)
            except (AdapterError, KeyError, ValueError):
                cold.delete(key)  # wrong geometry for this deployment
                dropped += 1
                continue
            handle = self.pager.adopt(key, nbytes, metadata=dict(meta))
            if handle is None:
                dropped += 1
                continue
            self._entries[adapter_id] = _Entry(adapter_id, handle,
                                               int(meta.get("nbytes",
                                                            nbytes)))
            adopted += 1
            recorder.record_event("adapter/rehydrate", replica=self.name,
                                  adapter=adapter_id)
        self.rehydrated = adopted
        tracer.end(sp, adopted=adopted, dropped=dropped)
        if adopted or dropped:
            logger.info(f"adapters: {self.name} rehydrated {adopted} "
                        f"adapter(s) from cold store "
                        f"({dropped} dropped)")

    # -- registration (any thread; fleet control ops land here) ----------

    def register(self, adapter_id: str, ckpt_dir: Optional[str] = None,
                 pack: Optional[Dict[str, Tuple[np.ndarray, np.ndarray]]]
                 = None, scaling: Optional[float] = None) -> None:
        """Load an adapter into the host tier and make it routable.  Either
        ``ckpt_dir`` (a :func:`publish_adapter` directory — validated) or a
        prebuilt ``pack``.  Raises :class:`AdapterError` on a duplicate id,
        a bad checkpoint, or a full host tier."""
        if (ckpt_dir is None) == (pack is None):
            raise AdapterError("register: exactly one of ckpt_dir/pack")
        if pack is None:
            pack = load_adapter_pack(ckpt_dir, self.engine.model_cfg,
                                     self.engine.cfg.adapter_rank,
                                     scaling=scaling)
        else:
            self._check_pack(pack)
            if scaling is not None and scaling != 1.0:
                pack = {t: (a, b * np.float32(scaling))
                        for t, (a, b) in pack.items()}
        with self._lock:
            if adapter_id in self._entries:
                raise AdapterError(f"adapter {adapter_id!r} already "
                                   "registered (retire it first)")
        # pager IO outside the registry lock; the entry is not yet visible
        arrays = _arrays_from_pack(pack)
        nbytes = sum(int(a.nbytes) for a in arrays.values())
        # the durable identity: should this pack overflow to the cold
        # store, a respawned registry finds it under its adapter id and
        # re-adopts it (geometry in the meta gates cross-deploy reuse)
        meta = {"kind": "adapter_pack", "adapter_id": adapter_id,
                "adapter_rank": str(self.engine.cfg.adapter_rank),
                "num_layers": str(self.engine.model_cfg.num_layers),
                "nbytes": str(nbytes)}
        put = self.pager.put(arrays, metadata=meta,
                             durable_key=f"adapter-{adapter_id}")
        if put is None:
            raise AdapterError(
                f"adapter host tier full registering {adapter_id!r} "
                "(raise --adapter_host_pool_mb or set a spill dir)")
        handle, tier = put
        with self._lock:
            if adapter_id in self._entries:  # raced a duplicate register
                self.pager.drop(handle)
                raise AdapterError(f"adapter {adapter_id!r} already "
                                   "registered (retire it first)")
            self._entries[adapter_id] = _Entry(adapter_id, handle, nbytes)
        tracer.add_event("adapter/register",
                         attrs={"replica": self.name, "adapter": adapter_id,
                                "tier": tier, "bytes": nbytes})
        recorder.record_event("adapter/register", replica=self.name,
                              adapter=adapter_id, tier=tier)
        logger.info(f"adapters: {self.name} registered {adapter_id} "
                    f"({nbytes >> 10} KiB, tier={tier})")

    def _check_pack(self, pack) -> None:
        shapes = adapter_target_shapes(self.engine.model_cfg)
        L, r = self.engine.model_cfg.num_layers, self.engine.cfg.adapter_rank
        for target, (a, b) in pack.items():
            if target not in ADAPTER_TARGETS:
                raise AdapterError(f"unsupported adapter target {target!r}; "
                                   f"serving supports {ADAPTER_TARGETS}")
            K, N = shapes[target]
            if tuple(a.shape) != (L, K, r) or tuple(b.shape) != (L, r, N):
                raise AdapterError(
                    f"pack target {target!r}: a{tuple(a.shape)} "
                    f"b{tuple(b.shape)}, want a({L},{K},{r}) b({L},{r},{N})")

    def known(self, adapter_id: str) -> bool:
        """Routable right now (registered and not retired)."""
        with self._lock:
            e = self._entries.get(adapter_id)
            return e is not None and not e.retired

    def ids(self) -> List[str]:
        with self._lock:
            return sorted(a for a, e in self._entries.items()
                          if not e.retired)

    def get_pack(self, adapter_id: str
                 ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        """The adapter's host factors (scaling already folded into
        ``lora_b``) — the export seam for ``export_merged_weights``."""
        with self._lock:
            e = self._entries.get(adapter_id)
            if e is None or e.retired:
                raise AdapterError(f"unknown adapter {adapter_id!r}")
            handle = e.handle
        arrays = self.pager.get(handle)
        if arrays is None:
            raise AdapterError(f"adapter {adapter_id!r} bytes lost "
                               "(pager dropped the handle)")
        return _pack_from_arrays(arrays)

    # -- residency (engine thread: broker admission/finalize) ------------

    def acquire(self, adapter_id: str) -> int:
        """Pin ``adapter_id`` into a device slot for one request and return
        the slot index.  Resident → refcount bump.  Not resident → promote
        from the host tier into a free slot, LRU-evicting an idle resident
        adapter if needed.  Raises :class:`AdapterError` for an unknown id
        and :class:`AdapterCapacityError` when every slot is pinned.
        Engine-thread only (slot promotion is a device copy)."""
        with self._lock:
            e = self._entries.get(adapter_id)
            if e is None or e.retired:
                raise AdapterError(f"unknown adapter {adapter_id!r}")
            self._clock += 1
            if e.slot is not None:
                e.refs += 1
                e.lru = self._clock
                self.hits += 1
                return e.slot
            slot, victim = self._pick_slot_locked()
            handle = e.handle
        t0 = time.perf_counter()
        sp = tracer.begin("adapter/promote", adapter=adapter_id, slot=slot,
                          replica=self.name)
        arrays = self.pager.get(handle)  # host-DRAM read (spill: file IO)
        if arrays is None:
            tracer.end(sp, error=True)
            raise AdapterError(f"adapter {adapter_id!r} bytes lost "
                               "(pager dropped the handle)")
        pack = _pack_from_arrays(arrays)
        with self._lock:
            if victim is not None:
                self.engine.clear_adapter_slot(slot)
                victim.slot = None
                self.evictions += 1
                tracer.add_event("adapter/demote",
                                 attrs={"replica": self.name,
                                        "adapter": victim.adapter_id,
                                        "slot": slot})
            self.engine.set_adapter_slot(slot, pack)
            e.slot = slot
            e.refs += 1
            e.lru = self._clock
            e.loads += 1
            self.loads += 1
        wait_ms = (time.perf_counter() - t0) * 1e3
        self.pager.record_promote_wait(wait_ms)
        tracer.end(sp, ok=True, wait_ms=wait_ms)
        return slot

    def _pick_slot_locked(self) -> Tuple[int, Optional[_Entry]]:
        if self._free:
            return self._free.pop(), None
        idle = [e for e in self._entries.values()
                if e.slot is not None and e.refs == 0]
        if not idle:
            self.capacity_deferrals += 1
            raise AdapterCapacityError(
                f"all {self.engine.cfg.adapter_slots - 1} adapter slots "
                "pinned by running requests")
        victim = min(idle, key=lambda e: e.lru)
        return victim.slot, victim

    def release(self, adapter_id: str) -> None:
        """Unpin one request's hold.  The adapter STAYS resident (warm for
        the next request) until LRU eviction or retire needs its slot."""
        with self._lock:
            e = self._entries.get(adapter_id)
            if e is None:
                return
            e.refs = max(0, e.refs - 1)
            if e.retired and e.refs == 0:
                self._purge_locked(e)

    def retire(self, adapter_id: str) -> bool:
        """Stop routing to ``adapter_id``.  In-flight requests finish on it
        (their rows keep the slot pinned); the host bytes and any device
        slot are reclaimed when the last ref drops.  Returns True when the
        adapter was fully purged immediately (no refs)."""
        with self._lock:
            e = self._entries.get(adapter_id)
            if e is None:
                raise AdapterError(f"unknown adapter {adapter_id!r}")
            e.retired = True
            drained = e.refs == 0
            if drained:
                self._purge_locked(e)
        tracer.add_event("adapter/retire",
                         attrs={"replica": self.name, "adapter": adapter_id,
                                "drained": drained})
        recorder.record_event("adapter/retire", replica=self.name,
                              adapter=adapter_id, drained=drained)
        return drained

    def _purge_locked(self, e: _Entry) -> None:
        if e.slot is not None:
            self.engine.clear_adapter_slot(e.slot)
            self._free.append(e.slot)
            e.slot = None
        self.pager.drop(e.handle)
        del self._entries[e.adapter_id]

    def prefetch(self, adapter_ids: List[str]) -> None:
        """Admission-lookahead promote-ahead: lift queued requests' spilled
        adapter bytes into the pager's host staging map before their
        admission turn (disk→host only; the device half stays on the
        engine thread at ``acquire``)."""
        handles: List[int] = []
        with self._lock:
            for a in adapter_ids:
                e = self._entries.get(a)
                if e is not None and not e.retired and e.slot is None:
                    handles.append(e.handle)
        if handles:
            self.pager.prefetch(handles)

    # -- observability ----------------------------------------------------

    def stats(self) -> Dict[str, float]:
        """Gauges for metrics/heartbeats — key names match the
        ``dstpu_serving_adapter_*`` Prometheus family."""
        with self._lock:
            resident = sum(1 for e in self._entries.values()
                           if e.slot is not None)
            host = sum(1 for e in self._entries.values() if e.slot is None)
            refs = sum(e.refs for e in self._entries.values())
            registered = len(self._entries)
        p = self.pager.stats()
        return {
            "resident": float(resident),
            "host": float(host),
            "loads": float(self.loads),
            "evictions": float(self.evictions),
            "promote_wait_ms": float(p["promote_wait_ms"]),
            "registered": float(registered),
            "refs": float(refs),
            "hits": float(self.hits),
            "capacity_deferrals": float(self.capacity_deferrals),
            "host_bytes_used": float(p["host_bytes_used"]),
            "spill_blocks": float(p["tier_spill_blocks"]),
            # crash-durable cold tier (inference/v2/coldstore.py)
            "cold_blocks": float(p.get("tier_cold_blocks", 0)),
            "rehydrated": float(self.rehydrated),
            "coldstore_entries": float(p.get("coldstore_entries", 0)),
        }

    def promote_wait_percentiles(self) -> Dict[str, float]:
        return self.pager.promote_wait_percentiles()

    def summary(self) -> Dict[str, Any]:
        """Heartbeat payload for adapter-aware routing: which adapters are
        device-resident here (hot) and which are registered (warm)."""
        with self._lock:
            return {
                "resident": sorted(a for a, e in self._entries.items()
                                   if e.slot is not None and not e.retired),
                "registered": sorted(a for a, e in self._entries.items()
                                     if not e.retired),
            }

    def check_leaks(self) -> None:
        """Test/bench invariant: with no requests in flight, no slot is
        pinned and slot accounting is conserved."""
        with self._lock:
            refs = {a: e.refs for a, e in self._entries.items() if e.refs}
            assert not refs, f"leaked adapter refs: {refs}"
            used = [e.slot for e in self._entries.values()
                    if e.slot is not None]
            assert len(used) == len(set(used)), f"slot aliasing: {used}"
            total = self.engine.cfg.adapter_slots - 1
            assert len(self._free) + len(used) == total, (
                self._free, used, total)

    def close(self) -> None:
        self.pager.close()


# ---------------------------------------------------------------------------
# fleet hot-load (pool-level, PR-13 rollout discipline)
# ---------------------------------------------------------------------------


def fleet_register(pool, adapter_id: str, ckpt_dir: str,
                   scaling: Optional[float] = None) -> dict:
    """Register a published adapter on every healthy replica — the
    adapter-scale analogue of ``rollout.rolling_swap``, minus the drain:
    registration only ADDS routable state, so no replica leaves rotation
    and no stream is touched.  Verifies the checkpoint manifest up front
    (never touch a replica for an adapter that can't fully load); a
    replica that fails to register is reported, not rolled back — the
    balancer's residency scoring simply never routes that adapter there."""
    from ..runtime.checkpoint.engine import verify_checkpoint

    problems = verify_checkpoint(ckpt_dir)
    if problems:
        raise AdapterError(f"refusing fleet register from {ckpt_dir}: "
                           + "; ".join(problems))
    targets = [t for t in list(pool.replicas) if t.healthy()]
    if not targets:
        raise AdapterError("no healthy replicas to register on")
    done, failed = [], {}
    for t in targets:
        try:
            t.adapter_register(adapter_id, ckpt_dir, scaling=scaling)
            done.append(t.name)
        except Exception as e:  # noqa: BLE001 — keep walking the fleet
            failed[t.name] = repr(e)
            logger.error(f"adapters: register {adapter_id} on {t.name} "
                         f"failed: {e!r}")
    tracer.add_event("adapter/fleet_register",
                     attrs={"adapter": adapter_id, "ok": len(done),
                            "failed": len(failed)})
    recorder.record_event("adapter/fleet_register", adapter=adapter_id,
                          ok=len(done), failed=len(failed))
    return {"adapter": adapter_id, "registered": done, "failed": failed}


def fleet_retire(pool, adapter_id: str) -> dict:
    """Retire an adapter fleet-wide.  In-flight requests finish; new
    submits naming it are rejected as soon as each replica processes the
    op.  Replicas that never had it count as already-retired."""
    done, failed = [], {}
    for t in [t for t in list(pool.replicas) if t.healthy()]:
        try:
            t.adapter_retire(adapter_id)
            done.append(t.name)
        except Exception as e:  # noqa: BLE001
            failed[t.name] = repr(e)
            logger.error(f"adapters: retire {adapter_id} on {t.name} "
                         f"failed: {e!r}")
    tracer.add_event("adapter/fleet_retire",
                     attrs={"adapter": adapter_id, "ok": len(done),
                            "failed": len(failed)})
    recorder.record_event("adapter/fleet_retire", adapter=adapter_id,
                          ok=len(done), failed=len(failed))
    return {"adapter": adapter_id, "retired": done, "failed": failed}
