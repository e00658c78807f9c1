"""Flight recorder: bounded postmortem rings dumped to disk on crash/fault
(the port of ``deepspeed_tpu/observability/recorder.py``).

Three rings, all host-side and cheap to append to:

* **requests** — the last N completed request timelines (rid, phase spans,
  finish reason, TTFT) assembled by the serving broker at finalize;
* **steps** — the last M engine steps (kind, batch composition, duration)
  recorded by ``InferenceEngineV2.step``;
* **events** — the last K infrastructure events (replica kills, elastic
  relaunches, checkpoint commits, injected faults).

On a crash the rings answer "what was this replica doing?":

* the fault-injection harness (``utils/faults.py``) runs registered crash
  hooks before ``os._exit`` — :func:`install_crash_hook` registers a dump;
* the serving broker dumps on an engine fault or a worker death (the
  elastic agent, which does too in the reference, is ROADMAP.md A13's).

Dumps land in ``$DSTPU_FLIGHT_DIR`` (no dump when unset and no explicit
path is given — crashing processes must not scatter files into arbitrary
working directories).  :func:`load_dump` reads a dump back.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from ..utils.locks import named_lock
from ..utils.logging import logger

_ENV_DIR = "DSTPU_FLIGHT_DIR"
_ENV_MAX_DUMPS = "DSTPU_FLIGHT_MAX_DUMPS"
_DEFAULT_MAX_DUMPS = 32


class FlightRecorder:
    """Bounded in-memory postmortem state (module singleton ``recorder``)."""

    def __init__(self, max_requests: int = 256, max_steps: int = 512,
                 max_events: int = 256):
        self._lock = named_lock("recorder.rings")
        self._requests: Deque[Dict[str, Any]] = deque(maxlen=max_requests)
        self._steps: Deque[Dict[str, Any]] = deque(maxlen=max_steps)
        self._events: Deque[Dict[str, Any]] = deque(maxlen=max_events)
        self._event_seq = itertools.count(1)
        self._hook_installed = False

    # -- recording -------------------------------------------------------

    def record_request(self, timeline: Dict[str, Any]) -> None:
        """Append one finished request's timeline (see the broker's
        ``_timeline_locked`` for the shape: rid, replica, spans, ttft_ms,
        finish_reason, tokens_out)."""
        with self._lock:
            self._requests.append(timeline)

    def record_step(self, record: Dict[str, Any]) -> None:
        with self._lock:
            self._steps.append(record)

    def record_event(self, name: str, **attrs: Any) -> None:
        with self._lock:
            self._events.append({"name": name, "t": time.monotonic(),
                                 "wall": time.time(),
                                 "seq": next(self._event_seq), **attrs})

    # -- cross-process stitching ------------------------------------------

    def events_since(self, cursor: int,
                     limit: int = 512) -> Tuple[int, List[Dict[str, Any]]]:
        """Locally-recorded events with ``seq > cursor`` (ingested remote
        events are skipped) — the worker side of shipping flight-recorder
        events to the front over the heartbeat channel."""
        with self._lock:
            fresh = [e for e in self._events
                     if e.get("seq", 0) > cursor and "src_pid" not in e]
        fresh = fresh[:limit]
        if not fresh:
            return cursor, []
        return fresh[-1]["seq"], [dict(e) for e in fresh]

    def ingest_events(self, events: List[Dict[str, Any]], pid: int) -> int:
        """Merge a worker's event batch into this ring, tagged with the
        sender pid and rebased onto this process's monotonic clock via the
        wall-clock stamp.  Malformed entries are dropped, never raised."""
        now_m, now_w = time.monotonic(), time.time()
        n = 0
        for e in events:
            try:
                ev = dict(e)
                ev["src_pid"] = int(pid)
                ev["t"] = now_m - (now_w - float(ev.get("wall", now_w)))
            except (TypeError, ValueError):
                continue
            with self._lock:
                ev["seq"] = next(self._event_seq)
                self._events.append(ev)
            n += 1
        return n

    # -- reading / dumping ----------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"requests": list(self._requests),
                    "steps": list(self._steps),
                    "events": list(self._events)}

    def clear(self) -> None:
        with self._lock:
            self._requests.clear()
            self._steps.clear()
            self._events.clear()

    def dump(self, path: Optional[str] = None,
             reason: str = "manual") -> Optional[str]:
        """Write the rings as JSON; returns the path, or None when no
        destination is configured.  Must never raise — it runs on crash
        paths where a secondary failure would mask the primary one."""
        try:
            if path is None:
                d = os.environ.get(_ENV_DIR)
                if not d:
                    return None
                os.makedirs(d, exist_ok=True)
                path = os.path.join(
                    d, f"flight_{os.getpid()}_{reason}_{int(time.time())}.json")
            body = self.snapshot()
            body["meta"] = {
                "pid": os.getpid(), "reason": reason,
                "wall": time.time(), "mono": time.monotonic(),
            }
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(body, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            logger.error(f"flight recorder: dumped {len(body['requests'])} "
                         f"request timelines / {len(body['steps'])} steps to "
                         f"{path} (reason: {reason})")
            _gc_dumps(os.path.dirname(path) or ".")
            return path
        except Exception as e:  # noqa: BLE001 — crash path; never mask
            try:
                logger.error(f"flight recorder dump failed: {e!r}")
            except Exception:
                pass
            return None

    # -- crash wiring ----------------------------------------------------

    def install_crash_hook(self) -> None:
        """Register a dump with the fault injector's pre-``os._exit`` hooks
        (idempotent).  An injected hard-kill then leaves a postmortem on
        disk — the in-process stand-in for 'the replica died and we want to
        know what it was doing'."""
        if self._hook_installed:
            return
        from ..utils import faults

        faults.add_crash_hook(self._crash_dump)
        self._hook_installed = True

    def _crash_dump(self, site: str) -> None:
        self.dump(reason=f"fault_{site.replace('.', '_')}")


def _gc_dumps(directory: str) -> None:
    """Retention GC: chaos runs dump one file per worker death,
    so the flight dir grows without bound.  Keep the newest
    ``$DSTPU_FLIGHT_MAX_DUMPS`` (default 32) ``flight_*.json`` files and
    unlink the rest, oldest-first by mtime.  Runs on the dump path, so it
    must never raise."""
    try:
        keep = int(os.environ.get(_ENV_MAX_DUMPS, _DEFAULT_MAX_DUMPS))
        if keep <= 0:
            return
        dumps = []
        for fn in os.listdir(directory):
            if fn.startswith("flight_") and fn.endswith(".json"):
                p = os.path.join(directory, fn)
                try:
                    dumps.append((os.path.getmtime(p), p))
                except OSError:
                    continue  # concurrent GC from a sibling process
        dumps.sort()
        for _, p in dumps[:-keep]:
            try:
                os.unlink(p)
            except OSError:
                pass
    except Exception as e:  # noqa: BLE001 — crash path; never mask
        try:
            logger.error(f"flight recorder GC failed: {e!r}")
        except Exception:
            pass


#: process-wide recorder every subsystem records into
recorder = FlightRecorder()


def load_dump(path: str) -> Dict[str, Any]:
    """Read a dump back (CLI / tests)."""
    with open(path) as f:
        return json.load(f)
