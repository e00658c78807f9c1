"""Crash-durable cold tier for serving warm state — the port of
``deepspeed_tpu/inference/v2/coldstore.py`` (host-only, copied; KV blocks
here, adapter packs with ROADMAP.md queue A item A7).

The fourth tier below the :class:`~.paging.BlockPager` hierarchy
(device → host DRAM → this).  Where the bare spill tier wrote one
unverified file per block — gone for good the moment the process that
numbered the handles dies — a :class:`ColdStore` entry is a **committed
checkpoint in miniature**: staged in a ``<key>.tmp/`` directory, sha256
manifest written and fsynced, then renamed into place with the parent
directory fsynced (the exact ``runtime/checkpoint`` tmp→fsync→rename
discipline, reused here rather than reimplemented).  An entry therefore
either exists whole and verifiable, or not at all — a SIGKILL anywhere
in the write leaves a ``.tmp`` leftover this module garbage-collects at
the next boot, never a silently-torn payload.

Entries are keyed by **durable, content-derived names** (chain digests
for KV blocks, adapter ids for factor packs), not process-local handle
integers, so a respawned worker can enumerate what survived and re-adopt
it: ``entries()`` lists committed entries with their manifest metadata,
``read()`` verifies the manifest digests *before* returning bytes
(verify-before-adopt — a corrupt or torn entry is deleted and reported,
and the caller degrades to re-prefill, never to wrong tokens).

Layout under ``root``::

    <root>/<key>/payload.safetensors   # the block/pack bytes
    <root>/<key>/manifest.json         # sizes + sha256 digests + meta
    <root>/<key>.tmp/                  # uncommitted staging (GC'd at boot)

Fault-injection sites (``DSTPU_FAULTS`` grammar, see ``utils/faults``):

* ``serving.coldstore.write``   — before/during the payload write; a
  ``truncate`` spec here models a torn payload (caught by the manifest).
* ``serving.coldstore.commit``  — between manifest write and the atomic
  rename; a kill here leaves a ``.tmp`` orphan for startup GC.
* ``serving.coldstore.rehydrate`` — fired by adopters per entry during
  restart rehydration (see ``engine.rehydrate_coldstore``).

Threading: counters live under ``named_lock("coldstore.state")``; all
file IO happens with no lock held (per-key directories are independent
and the commit rename is atomic).
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

from ...runtime.checkpoint.engine import (
    _MANIFEST,
    _TMP_SUFFIX,
    _commit_dir,
    _fsync_path,
    _write_manifest,
    verify_checkpoint,
)
from ...utils import faults
from ...utils.locks import named_lock
from ...utils.logging import logger

#: the single payload file inside each committed entry directory
PAYLOAD = "payload.safetensors"

#: startup GC is bounded per boot so a pathological backlog can't stall
#: worker readiness; anything past the cap is swept on the next boot.
GC_SWEEP_LIMIT = 4096

_KEY_RE = re.compile(r"[^A-Za-z0-9._-]")


def sanitize_key(key: str) -> str:
    """A durable key as a safe single path component."""
    key = _KEY_RE.sub("_", str(key))
    if not key or key.startswith(".") or key.endswith(_TMP_SUFFIX):
        raise ValueError(f"invalid coldstore key {key!r}")
    return key


class ColdStore:
    """Manifest-verified durable store of opaque payloads, keyed by name.

    * :meth:`write` stages ``payload`` + metadata under ``<key>.tmp/``,
      writes the sha256 manifest, and commits with an atomic rename —
      readable concurrently with writes to other keys.
    * :meth:`read` verifies the entry's manifest (sizes + digests) and
      returns the payload bytes; a failed verification deletes the entry
      and returns ``None`` so callers degrade rather than consume
      corruption.
    * :meth:`entries` enumerates committed entries (manifest meta only —
      cheap; digest verification happens at :meth:`read` time).
    * Construction garbage-collects uncommitted ``.tmp`` leftovers from
      a crashed predecessor (bounded, counted, logged).
    """

    def __init__(self, root: str):
        self.root = root
        self._lock = named_lock("coldstore.state")
        # counters (monotonic; surfaced through pager/registry stats)
        self.writes = 0
        self.corrupt_dropped = 0
        self.gc_tmp_entries = 0
        os.makedirs(root, exist_ok=True)
        self._startup_gc()

    # -- startup GC ------------------------------------------------------

    def _startup_gc(self) -> None:
        """Sweep uncommitted ``.tmp`` staging dirs left by a crashed
        predecessor (a kill at ``serving.coldstore.commit``)."""
        swept = 0
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return
        for name in names:
            if not name.endswith(_TMP_SUFFIX):
                continue
            if swept >= GC_SWEEP_LIMIT:
                logger.warning(
                    f"coldstore: tmp sweep hit {GC_SWEEP_LIMIT}-entry boot "
                    f"cap in {self.root}; remainder deferred to next boot")
                break
            path = os.path.join(self.root, name)
            shutil.rmtree(path, ignore_errors=True)
            swept += 1
        if swept:
            logger.warning(f"coldstore: swept {swept} uncommitted .tmp "
                           f"entr{'y' if swept == 1 else 'ies'} from "
                           f"{self.root}")
            with self._lock:
                self.gc_tmp_entries += swept

    # -- paths -----------------------------------------------------------

    def path(self, key: str) -> str:
        return os.path.join(self.root, sanitize_key(key))

    # -- write (stage → manifest → commit) -------------------------------

    def write(self, key: str, payload: bytes,
              meta: Optional[Dict[str, Any]] = None) -> str:
        """Durably store ``payload`` under ``key``; returns the committed
        entry path.  Re-writing an existing key replaces it atomically."""
        final = self.path(key)
        tmp = final + _TMP_SUFFIX
        faults.maybe_fail("serving.coldstore.write")
        shutil.rmtree(tmp, ignore_errors=True)  # stale stage from a crash
        os.makedirs(tmp)
        ppath = os.path.join(tmp, PAYLOAD)
        with open(ppath, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        _write_manifest(tmp, dict(meta or {}), algorithm="sha256")
        # torn-write model: shorten the payload AFTER its digest was
        # recorded — exactly the mismatch the manifest must catch
        faults.maybe_truncate("serving.coldstore.write", ppath)
        faults.maybe_fail("serving.coldstore.commit")
        _commit_dir(tmp, final)
        with self._lock:
            self.writes += 1
        return final

    # -- read (verify-before-adopt) --------------------------------------

    def read(self, key: str) -> Optional[bytes]:
        """Payload bytes for ``key`` after manifest verification, or
        ``None`` (entry missing, torn, or corrupt — corrupt entries are
        deleted so the caller's degrade-to-recompute is permanent, not
        retried forever)."""
        entry = self.path(key)
        if not os.path.isdir(entry):
            return None
        problems = verify_checkpoint(entry, check_digests=True)
        if problems:
            logger.warning(f"coldstore: dropping corrupt entry {entry}: "
                           f"{'; '.join(problems)}")
            shutil.rmtree(entry, ignore_errors=True)
            _fsync_path(self.root)
            with self._lock:
                self.corrupt_dropped += 1
            return None
        try:
            with open(os.path.join(entry, PAYLOAD), "rb") as f:
                return f.read()
        except OSError:
            return None

    def meta(self, key: str) -> Optional[Dict[str, Any]]:
        """Manifest metadata for ``key`` (no digest verification)."""
        try:
            with open(os.path.join(self.path(key), _MANIFEST)) as f:
                return json.load(f).get("meta", {})
        except (OSError, ValueError):
            return None

    # -- enumeration -----------------------------------------------------

    def entries(self) -> List[Tuple[str, Dict[str, Any], int]]:
        """Committed entries as ``(key, meta, payload_bytes)`` — manifest
        reads only; digest verification is deferred to :meth:`read` so a
        boot over thousands of entries stays cheap until adoption."""
        out: List[Tuple[str, Dict[str, Any], int]] = []
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return out
        for name in names:
            if name.endswith(_TMP_SUFFIX):
                continue
            mpath = os.path.join(self.root, name, _MANIFEST)
            try:
                with open(mpath) as f:
                    manifest = json.load(f)
            except (OSError, ValueError):
                continue  # read() will classify + GC if ever adopted
            files = manifest.get("files", {})
            nbytes = int(files.get(PAYLOAD, {}).get("size", 0))
            out.append((name, manifest.get("meta", {}), nbytes))
        return out

    # -- delete ----------------------------------------------------------

    def delete(self, key: str) -> None:
        entry = self.path(key)
        shutil.rmtree(entry, ignore_errors=True)

    # -- gauges ----------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        entries = self.entries()
        with self._lock:
            return {
                "coldstore_entries": float(len(entries)),
                "coldstore_bytes": float(sum(n for _, _, n in entries)),
                "coldstore_writes": float(self.writes),
                "coldstore_corrupt_dropped": float(self.corrupt_dropped),
                "coldstore_gc_tmp": float(self.gc_tmp_entries),
            }
