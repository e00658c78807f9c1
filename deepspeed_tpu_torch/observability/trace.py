"""Span-based request tracer: a thread-safe ring buffer of host-side spans
(the port of ``deepspeed_tpu/observability/trace.py``).

The serving stack's aggregate gauges (``serving/metrics.py``) say *how much*;
this module says *where the time went* for one request or one engine step.
Every span is ``(name, trace_id, span_id, parent_id, t_start, t_end, attrs)``
— ``trace_id`` groups spans belonging to one request (the broker uses the
request's ``rid``), ``parent_id`` nests them.

Design constraints:

* **always-on and cheap** — recording a span is two ``time.monotonic()``
  calls, one small dict, and one deque append under a lock.  No sampling
  daemon, no network, no allocation spikes.  ``DSTPU_TRACE=0`` disables it
  entirely (context managers become no-ops).
* **host-side only** — nothing here touches a CUDA tensor or waits on the
  device, so enabling tracing changes no kernel launch and adds no host
  sync (a decode body stays free of syncs with tracing on).
* **bounded** — the ring keeps the most recent ``capacity`` spans; old spans
  fall off the back.  Postmortem durability is the flight recorder's job
  (``observability/recorder.py``), not the ring's.

Parenting: spans opened with the :meth:`Tracer.span` context manager nest
implicitly per-thread (a thread-local stack).  Cross-thread request spans
(the broker's engine thread finishing what an HTTP thread submitted) pass
``trace_id``/``parent_id`` explicitly, or record retroactively with
:meth:`Tracer.add_span` once both endpoints' timestamps are known.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Deque, Dict, Iterator, List, Optional

from ..utils.locks import named_lock

_ENV = "DSTPU_TRACE"


@dataclasses.dataclass
class Span:
    name: str
    trace_id: Optional[str]
    span_id: int
    parent_id: Optional[int]
    t_start: float          # time.monotonic()
    t_end: Optional[float]  # None while open
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    thread: str = ""
    # cross-process stitching: spans ingested from another
    # process carry that process's pid + display name; local spans leave
    # both unset.  ``seq`` is the ring-append sequence number — the export
    # cursor for shipping spans over the heartbeat channel (span_id order
    # is begin order, but a long-lived span lands in the ring late).
    pid: Optional[int] = None
    process: str = ""
    seq: int = 0

    @property
    def duration_s(self) -> float:
        return (self.t_end or self.t_start) - self.t_start

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "t_start": self.t_start, "t_end": self.t_end,
                "attrs": dict(self.attrs), "thread": self.thread}


class Tracer:
    """Process-wide span ring (module singleton ``tracer`` below)."""

    def __init__(self, capacity: int = 8192, enabled: Optional[bool] = None):
        self._lock = named_lock("trace.ring")
        self._ring: Deque[Span] = deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._seq = itertools.count(1)  # ring-append order (export cursor)
        self._local = threading.local()
        # monotonic↔wall anchor so dumps can be mapped to absolute times
        self.mono_zero = time.monotonic()
        self.wall_zero = time.time()
        if enabled is None:
            enabled = os.environ.get(_ENV, "1") != "0"
        self.enabled = enabled

    # -- recording -------------------------------------------------------

    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def begin(self, name: str, trace_id: Optional[str] = None,
              parent_id: Optional[int] = None, **attrs: Any) -> Optional[Span]:
        """Open a span (records ``t_start`` now); close with :meth:`end`.
        Inherits trace_id/parent from the current thread's open span unless
        given explicitly.  Returns None (and records nothing) when
        disabled."""
        if not self.enabled:
            return None
        stack = self._stack()
        if stack:
            top = stack[-1]
            if trace_id is None:
                trace_id = top.trace_id
            if parent_id is None:
                parent_id = top.span_id
        sp = Span(name=name, trace_id=trace_id,
                  span_id=next(self._ids), parent_id=parent_id,
                  t_start=time.monotonic(), t_end=None, attrs=attrs,
                  thread=threading.current_thread().name)
        stack.append(sp)
        return sp

    def end(self, sp: Optional[Span], **attrs: Any) -> None:
        if sp is None:
            return
        sp.t_end = time.monotonic()
        if attrs:
            sp.attrs.update(attrs)
        stack = self._stack()
        if stack and stack[-1] is sp:
            stack.pop()
        else:  # out-of-order end (cross-thread misuse): drop if present
            try:
                stack.remove(sp)
            except ValueError:
                pass
        with self._lock:
            sp.seq = next(self._seq)
            self._ring.append(sp)

    @contextmanager
    def span(self, name: str, trace_id: Optional[str] = None,
             **attrs: Any) -> Iterator[Optional[Span]]:
        sp = self.begin(name, trace_id=trace_id, **attrs)
        try:
            yield sp
        finally:
            self.end(sp)

    def add_span(self, name: str, t_start: float, t_end: float,
                 trace_id: Optional[str] = None,
                 parent_id: Optional[int] = None,
                 attrs: Optional[Dict[str, Any]] = None) -> Optional[Span]:
        """Record a retroactive (already-completed) span from known
        timestamps — how the broker emits request-phase spans whose
        endpoints were observed on different threads."""
        if not self.enabled:
            return None
        sp = Span(name=name, trace_id=trace_id, span_id=next(self._ids),
                  parent_id=parent_id, t_start=t_start, t_end=t_end,
                  attrs=dict(attrs or {}),
                  thread=threading.current_thread().name)
        with self._lock:
            sp.seq = next(self._seq)
            self._ring.append(sp)
        return sp

    def add_event(self, name: str, trace_id: Optional[str] = None,
                  attrs: Optional[Dict[str, Any]] = None) -> Optional[Span]:
        """Instant event (zero-duration span)."""
        now = time.monotonic()
        return self.add_span(name, now, now, trace_id=trace_id, attrs=attrs)

    # -- reading ---------------------------------------------------------

    def spans(self, trace_id: Optional[str] = None,
              name: Optional[str] = None) -> List[Span]:
        """Snapshot of the ring, oldest first, optionally filtered."""
        with self._lock:
            out = list(self._ring)
        if trace_id is not None:
            out = [s for s in out if s.trace_id == trace_id]
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    # -- cross-process stitching ------------------------------------------
    #
    # Workers ship their completed spans to the front over the heartbeat
    # channel.  Monotonic clocks are per-process, so the wire format uses
    # wall-clock endpoints: the sender converts via its own anchors
    # (``wall = wall_zero + (t - mono_zero)``), the receiver rebases onto
    # its anchors (``t = mono_zero + (wall - wall_zero)``).  NTP-grade skew
    # between processes on one host is microseconds — invisible next to
    # millisecond spans.

    def export_since(self, cursor: int, limit: int = 512) -> tuple:
        """Locally-recorded spans appended after ``cursor`` (a ring-append
        ``seq``), as wall-clock wire dicts.  Returns ``(new_cursor,
        dicts)``; feed ``new_cursor`` back on the next call.  Ingested
        remote spans are skipped — a front that is itself supervised must
        not re-export its workers' spans."""
        with self._lock:
            fresh = [s for s in self._ring if s.seq > cursor and s.pid is None]
        fresh.sort(key=lambda s: s.seq)
        fresh = fresh[:limit]
        if not fresh:
            return cursor, []
        off = self.wall_zero - self.mono_zero
        out = [{"name": s.name, "trace_id": s.trace_id,
                "wall_start": s.t_start + off,
                "wall_end": (s.t_end if s.t_end is not None else s.t_start)
                + off,
                "thread": s.thread, "attrs": dict(s.attrs)}
               for s in fresh]
        return fresh[-1].seq, out

    def ingest_remote(self, spans: List[Dict[str, Any]], pid: int,
                      process: str) -> int:
        """Merge wire dicts from :meth:`export_since` of another process's
        tracer into this ring, rebased onto this process's monotonic
        clock and tagged with the sender's pid / display name (they become
        a separate Perfetto process track).  Returns the count ingested;
        malformed entries are dropped, never raised — trace ingestion
        rides the heartbeat path."""
        if not self.enabled:
            return 0
        off = self.mono_zero - self.wall_zero
        n = 0
        for d in spans:
            try:
                sp = Span(name=str(d["name"]), trace_id=d.get("trace_id"),
                          span_id=next(self._ids), parent_id=None,
                          t_start=float(d["wall_start"]) + off,
                          t_end=float(d["wall_end"]) + off,
                          attrs=dict(d.get("attrs") or {}),
                          thread=str(d.get("thread") or "main"),
                          pid=int(pid), process=process)
            except (KeyError, TypeError, ValueError):
                continue
            with self._lock:
                sp.seq = next(self._seq)
                self._ring.append(sp)
            n += 1
        return n

    # -- export ----------------------------------------------------------

    def to_chrome_trace(self, spans: Optional[List[Span]] = None) -> dict:
        """Chrome/Perfetto trace-event JSON (``chrome://tracing`` "JSON
        Array Format"): complete events (``ph: "X"``) for spans, instants
        (``ph: "i"``) for zero-duration events; timestamps in µs relative
        to the tracer's monotonic zero."""
        if spans is None:
            spans = self.spans()
        pid = os.getpid()
        # one process_name metadata event per distinct pid: the local
        # process first, then every remote process seen in the spans —
        # Perfetto renders each as its own track group, which is what makes
        # a stitched fleet trace readable as front + workers.
        events = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "deepspeed_tpu_torch"},
        }]
        named = {pid}
        for s in spans:
            if s.pid is not None and s.pid not in named:
                named.add(s.pid)
                events.append({
                    "name": "process_name", "ph": "M", "pid": s.pid,
                    "tid": 0, "args": {"name": s.process
                                       or f"worker-{s.pid}"}})
        for s in spans:
            ts = (s.t_start - self.mono_zero) * 1e6
            args = {k: v for k, v in s.attrs.items()}
            if s.trace_id is not None:
                args["trace_id"] = s.trace_id
            base = {"name": s.name, "pid": (s.pid if s.pid is not None
                                            else pid),
                    "tid": s.thread or "main",
                    "ts": ts, "cat": (s.trace_id or "infra"), "args": args}
            if s.t_end is None or s.t_end == s.t_start:
                events.append({**base, "ph": "i", "s": "t"})
            else:
                events.append({**base, "ph": "X",
                               "dur": (s.t_end - s.t_start) * 1e6})
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"wall_zero": self.wall_zero,
                              "mono_zero": self.mono_zero}}

    def to_chrome_json(self) -> str:
        return json.dumps(self.to_chrome_trace())


#: process-wide tracer every subsystem records into
tracer = Tracer()


@contextmanager
def span(name: str, trace_id: Optional[str] = None,
         **attrs: Any) -> Iterator[Optional[Span]]:
    """Module-level shorthand for ``tracer.span(...)``."""
    with tracer.span(name, trace_id=trace_id, **attrs) as sp:
        yield sp


def add_span(name: str, t_start: float, t_end: float, **kw) -> Optional[Span]:
    return tracer.add_span(name, t_start, t_end, **kw)


def add_event(name: str, trace_id: Optional[str] = None,
              attrs: Optional[Dict[str, Any]] = None) -> Optional[Span]:
    return tracer.add_event(name, trace_id=trace_id, attrs=attrs)
