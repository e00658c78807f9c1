"""Replica transports: how the pool reaches a replica (the port of
``deepspeed_tpu/serving/transport.py``).

Capability analogue of DeepSpeed-MII's replica fan-out
(``mii/grpc_related/``): the reference load balancer fronts replica
**processes** over gRPC.  This module puts the same seam into our pool:
:class:`ReplicaPool` routes over :class:`ReplicaTransport` objects and
never touches an engine directly, so the same least-outstanding-tokens
routing and delivered-prefix failover drive every implementation:

* :class:`InProcessReplica` — the original arrangement: a
  :class:`~deepspeed_tpu_torch.serving.broker.RequestBroker` engine thread in
  this process, sharing one param pytree with its siblings.  Fast, zero
  copies — and zero fault isolation: one CUDA fault kills every replica.
* :class:`SubprocessReplica` — a worker **process**
  (``python -m deepspeed_tpu_torch.serving.worker``, spawned with
  ``start_new_session=True`` so teardown can ``os.killpg`` the whole
  group) that owns its own engine and its own CUDA context, reached over a
  local TCP socket with a length-prefixed JSON protocol.  A replica
  segfault, OOM, or hang is contained to that process; the supervisor
  (``serving/supervisor.py``) detects it by heartbeat and respawns it.
* :class:`~deepspeed_tpu_torch.serving.remote.RemoteReplica` — the same frame
  protocol over a real network: the worker **dials in** to the pool's
  registry with a versioned, authenticated hello carrying a fencing
  epoch (``serving/remote.py``).

The protocol-speaking core (reader thread, frame demux, stream failover,
swap control ops, liveness) lives in :class:`FramedReplica`; subprocess
and remote transports differ only in how the peer comes to exist and how
it is torn down — the ``_peer_*`` hook methods.

Wire protocol (4-byte big-endian length + UTF-8 JSON, both directions):

* pool → worker: ``{"op": "submit", "rid", "prompt", ...}``,
  ``{"op": "cancel", "rid"}``, ``{"op": "fault", "spec"}`` (chaos hook:
  arm ``utils/faults`` sites inside the worker), ``{"op": "swap",
  "ckpt_dir", "cid"}`` / ``{"op": "swap_rollback", "cid"}`` (rolling
  weight swaps — ``serving/rollout.py``), ``{"op": "adapter_register",
  "adapter", "ckpt_dir", "cid"}`` / ``{"op": "adapter_retire",
  "adapter", "cid"}`` (hot multi-adapter loads — ``serving/adapters.py``),
  ``{"op": "stop"}``.
* worker → pool: ``{"ev": "hb", "stats"}`` heartbeats (liveness + the
  stats the pool's routing and gauges need), ``accepted``/``rejected``
  submit acks, ``tok``/``done``/``err`` per-request stream frames,
  ``swap_ok``/``swap_err`` / ``adapter_ok``/``adapter_err`` control acks
  keyed by ``cid``.

Frame hardening: a corrupt or hostile peer must cost one connection,
never a traceback in the reader thread.  An oversized length prefix or
an undecodable payload raises :class:`ProtocolError` (a
``ConnectionError`` subclass, so every existing except-clause already
closes the connection cleanly); a mid-frame truncation raises plain
``ConnectionError``.  Garbage bytes (say an HTTP request hitting the
registry port) decode as an absurd length prefix and die the same way.

A dead worker fails its in-flight streams with ``replica_dead``; the
balancer resubmits on a surviving replica and skips the tokens the client
already received — token-identical under greedy decode, exactly the
in-process failover path.
"""

from __future__ import annotations

import abc
import itertools
import json
import os
import queue
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence

from ..observability.recorder import recorder
from ..observability.trace import tracer
from ..utils.locks import named_lock
from ..utils.logging import logger
from ..utils.proc import terminate_procs
from .broker import (BrokerStoppedError, InvalidRequestError, QueueFullError,
                     RequestBroker, RequestFailedError)
from .config import ServingConfig
from .metrics import ServingMetrics

READY_MARKER = "dstpu-worker listening on "

#: hello-frame magic + protocol version (serving/remote.py handshake);
#: a version bump is a fleet-wide flag day — the registry rejects
#: mismatches rather than guessing at frame semantics
FLEET_MAGIC = "dstpu-fleet"
PROTO_VERSION = 1

_LEN = struct.Struct(">I")
#: sanity cap on a single frame (a corrupt length prefix must not OOM us)
MAX_FRAME = 32 * 1024 * 1024


class ProtocolError(ConnectionError):
    """The peer sent bytes that cannot be a frame (oversized length
    prefix, undecodable payload, bad hello).  Subclasses
    ``ConnectionError`` so every reader already tears the connection
    down cleanly instead of leaking a raw struct/JSON traceback."""


def send_frame(sock: socket.socket, obj: Dict[str, Any],
               lock: Optional[threading.Lock] = None) -> None:
    payload = json.dumps(obj, separators=(",", ":")).encode()
    data = _LEN.pack(len(payload)) + payload
    if lock is not None:
        with lock:
            # waived (analysis/waivers.toml): serializing frames onto the
            # socket is this lock's purpose; close() unblocks, not writers
            sock.sendall(data)  # lint: allow(blocking-in-lock)
    else:
        sock.sendall(data)


def recv_frame(rfile) -> Optional[Dict[str, Any]]:
    """Read one frame from a buffered socket file; None on clean EOF.
    Raises :class:`ProtocolError` for frames that can never be valid
    (oversize, garbage payload) and plain ``ConnectionError`` for
    mid-frame truncation (the peer died mid-send)."""
    header = rfile.read(_LEN.size)
    if not header:
        return None
    if len(header) < _LEN.size:
        raise ConnectionError("truncated frame header")
    (n,) = _LEN.unpack(header)
    if n > MAX_FRAME:
        raise ProtocolError(f"frame of {n} bytes exceeds cap {MAX_FRAME}")
    payload = rfile.read(n)
    if len(payload) < n:
        raise ConnectionError("truncated frame payload")
    try:
        return json.loads(payload)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise ProtocolError(f"undecodable frame payload: {e}") from e


class ReplicaTransport(abc.ABC):
    """What the pool needs from a replica, wherever it runs.  All stats
    accessors must be non-blocking and must not raise on a dead replica —
    the pool's health endpoint and metrics pump call them unconditionally."""

    name: str
    #: phase class for disaggregated routing: "prefill" / "decode" /
    #: "mixed".  Pool-side assignment (``ServingConfig.replica_classes``)
    #: for local transports; confirmed by the hello / heartbeat for
    #: dial-in workers.
    replica_class: str = "mixed"

    @abc.abstractmethod
    def start(self) -> "ReplicaTransport": ...

    @abc.abstractmethod
    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None: ...

    @abc.abstractmethod
    def kill(self, reason: str = "replica_dead") -> None: ...

    @abc.abstractmethod
    def healthy(self) -> bool: ...

    @abc.abstractmethod
    def submit(self, **kwargs): ...

    @abc.abstractmethod
    def cancel(self, rid: str) -> bool: ...

    @abc.abstractmethod
    def queue_depth(self) -> int: ...

    @abc.abstractmethod
    def outstanding_tokens(self) -> int: ...

    @abc.abstractmethod
    def kv_utilization(self) -> float: ...

    @abc.abstractmethod
    def num_running(self) -> int: ...

    @abc.abstractmethod
    def prefix_stats(self) -> Dict[str, float]: ...

    @abc.abstractmethod
    def spec_stats(self) -> Dict[str, float]: ...

    def prefix_summary(self) -> Dict[str, Any]:
        """Radix-tree digest summary for cache-aware routing (see
        ``PrefixCache.summary``); empty when the replica has none."""
        return {}

    def adapter_stats(self) -> Dict[str, float]:
        """Adapter-registry stats (``serving/adapters.py``); empty when
        the replica serves no adapters."""
        return {}

    def adapter_summary(self) -> Dict[str, Any]:
        """Resident/registered adapter ids for adapter-aware routing;
        empty when the replica serves no adapters."""
        return {}

    def describe(self) -> Dict[str, Any]:
        """Transport-specific health extras (process ids, generations)."""
        return {}


class InProcessReplica(ReplicaTransport):
    """The pre-fleet arrangement behind the transport seam: an engine
    thread in this process.  Keeps the zero-copy param sharing (and the
    shared fate: no fault isolation)."""

    transport = "inprocess"

    def __init__(self, broker: RequestBroker):
        self.broker = broker
        self.name = broker.name
        self.replica_class = broker.cfg.replica_class

    # the serving tests and bench reach through to the engine for leak /
    # block-accounting assertions; only this transport can offer that
    @property
    def engine(self):
        return self.broker.engine

    def start(self) -> "InProcessReplica":
        self.broker.start()
        return self

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        self.broker.stop(drain=drain, timeout=timeout)

    def kill(self, reason: str = "replica_dead") -> None:
        self.broker.kill(reason)

    def healthy(self) -> bool:
        return self.broker.healthy()

    def submit(self, **kwargs):
        return self.broker.submit(**kwargs)

    def cancel(self, rid: str) -> bool:
        return self.broker.cancel(rid)

    def swap(self, ckpt_dir: str, timeout: Optional[float] = None) -> None:
        """Rolling-rollout hook: load a committed checkpoint and pointer-
        swap it into the engine (``serving/rollout.py`` quiesces first)."""
        from .rollout import load_swap_params  # avoid an import cycle

        self.broker.swap_params(
            load_swap_params(ckpt_dir, self.broker.engine))

    def swap_rollback(self, timeout: Optional[float] = None) -> None:
        self.broker.swap_rollback()

    def queue_depth(self) -> int:
        return self.broker.queue_depth()

    def outstanding_tokens(self) -> int:
        return self.broker.outstanding_tokens()

    def kv_utilization(self) -> float:
        return self.broker.kv_utilization()

    def num_running(self) -> int:
        return self.broker.engine.num_running

    def prefix_stats(self) -> Dict[str, float]:
        return self.broker.engine.prefix_stats()

    def spec_stats(self) -> Dict[str, float]:
        return self.broker.engine.spec_stats()

    def prefix_summary(self) -> Dict[str, Any]:
        return self.broker.engine.prefix_summary()

    def adapter_stats(self) -> Dict[str, float]:
        reg = self.broker.adapters
        return reg.stats() if reg is not None else {}

    def adapter_summary(self) -> Dict[str, Any]:
        reg = self.broker.adapters
        return reg.summary() if reg is not None else {}

    def adapter_register(self, adapter_id: str, ckpt_dir: str,
                         scaling: Optional[float] = None,
                         timeout: Optional[float] = None) -> None:
        """Hot-load an adapter checkpoint into this replica's registry
        (``serving/adapters.py`` fleet ops; no drain needed — registering
        only adds routable state)."""
        reg = self.broker.adapters
        if reg is None:
            raise RequestFailedError(
                "adapter_failed",
                f"replica {self.name} serves no adapters")
        reg.register(adapter_id, ckpt_dir=ckpt_dir, scaling=scaling)

    def adapter_retire(self, adapter_id: str,
                       timeout: Optional[float] = None) -> bool:
        reg = self.broker.adapters
        if reg is None:
            raise RequestFailedError(
                "adapter_failed",
                f"replica {self.name} serves no adapters")
        return reg.retire(adapter_id)


class RemoteHandle:
    """Client-side view of a request running in a worker process — same
    surface as :class:`~deepspeed_tpu_torch.serving.broker.RequestHandle`, fed
    by the transport's reader thread demultiplexing stream frames."""

    def __init__(self, transport: "FramedReplica", rid: str,
                 prompt: List[int]):
        self._transport = transport
        self.rid = rid
        self.prompt = list(prompt)
        self.finish_reason: Optional[str] = None
        self.q: "queue.Queue" = queue.Queue()

    def cancel(self) -> None:
        self._transport.cancel(self.rid)

    def tokens(self, timeout: Optional[float] = None) -> Iterator[int]:
        while True:
            kind, payload = self.q.get(timeout=timeout)
            if kind == "tok":
                yield payload
            elif kind == "done":
                self.finish_reason = payload
                return
            else:  # "err"
                self.finish_reason = payload[0]
                raise RequestFailedError(payload[0], payload[1])

    def result(self, timeout: Optional[float] = None) -> List[int]:
        return list(self.tokens(timeout=timeout))


class FramedReplica(ReplicaTransport):
    """Everything a frame-protocol replica shares, however the socket
    came to exist: the reader thread, stream/ack/control demux, the
    idempotent death transition, submit/cancel/fault/swap ops, heartbeat-
    carried stats, and the supervisor's liveness surface.

    Subclasses supply peer management through small hooks:

    * :meth:`_peer_alive` / :meth:`_peer_pid` — called UNDER ``_lock``,
      must not block (a ``proc.poll()``, a flag read);
    * :meth:`_disconnect_reason` — what a surprise EOF means
      (``replica_dead`` for a local child, ``connection_lost`` for a
      network peer — the supervisor treats them differently);
    * :meth:`_teardown_peer` / :meth:`_force_kill_peer` /
      :meth:`_await_peer_exit` — reaping;
    * :meth:`_lease_remaining` — None when liveness is process-identity
      (subprocess); a countdown for network peers whose connection loss
      is survivable until the lease runs out (``serving/remote.py``).
    """

    transport = "framed"
    #: False for registry slots whose workers are launched externally —
    #: the supervisor then waits for re-registration instead of respawning
    can_respawn = True

    def __init__(self, config: ServingConfig, name: str,
                 metrics: Optional[ServingMetrics] = None):
        self.cfg = config
        self.name = name
        self.replica_class = "mixed"  # pool-assigned; hb/hello confirms
        self.metrics = metrics
        # lock classes (utils/locks.py): "transport.state" guards the
        # replica's connection/stream maps, "transport.write" serializes
        # whole frames onto the socket.  Never hold state across a write.
        self._lock = named_lock("transport.state")
        self._wlock = named_lock("transport.write")
        self._sock: Optional[socket.socket] = None
        self._rfile = None
        self._pending: Dict[str, RemoteHandle] = {}
        self._acks: Dict[str, "queue.Queue"] = {}
        self._ctrl: Dict[str, "queue.Queue"] = {}
        self._stats: Dict[str, Any] = {}
        self._connected = threading.Event()
        self._down: Optional[str] = None
        self._stopping = False
        self._last_hb = 0.0
        self._hb_pid: Optional[int] = None
        self._rid_counter = itertools.count(1)
        # supervisor bookkeeping (serving/supervisor.py)
        self.generation = 0
        self.spawn_ts = 0.0
        self.consecutive_failures = 0
        self.circuit_open = False
        self.next_respawn_at = 0.0
        #: set once the supervisor has escalated an expired lease — so
        #: lease expiry triggers failover exactly once per outage
        self.lease_escalated = False

    # -- peer hooks (subclass responsibility) ----------------------------

    def _peer_alive(self) -> bool:
        """Is the peer still with us?  Called under ``_lock``."""
        return self._down is None and self._connected.is_set()

    def _peer_pid(self) -> Optional[int]:
        """Peer pid if known.  Called under ``_lock``."""
        return self._hb_pid

    def _disconnect_reason(self) -> str:
        """Down-reason for a surprise EOF / read error."""
        return "replica_dead"

    def _teardown_peer(self, reason: str) -> None:
        """Reap whatever backs the peer after a death declaration."""

    def _force_kill_peer(self) -> None:
        """SIGKILL-grade teardown for :meth:`kill` (chaos tests)."""

    def _await_peer_exit(self, timeout: float) -> None:
        """Wait for the peer to exit after a graceful stop frame."""

    def _lease_remaining(self, now: float) -> Optional[float]:
        """Seconds of lease left, or None when liveness needs no lease."""
        return None

    def respawn(self) -> "FramedReplica":
        """Next worker generation after a death (supervisor-driven)."""
        with self._lock:
            self.generation += 1
        return self.start()

    # -- stream wiring ---------------------------------------------------

    def _wire(self, sock: socket.socket, rfile, guard=None) -> bool:
        """Install a connected stream and start its reader thread.
        ``guard()`` runs under the lock; returning False aborts (the slot
        was torn down or moved on while we connected)."""
        with self._lock:
            if guard is not None and not guard():
                return False
            self._sock = sock
            self._rfile = rfile
            self._last_hb = time.monotonic()
        self._connected.set()
        threading.Thread(target=self._reader, args=(sock, rfile),
                         name=f"dstpu-reader-{self.name}",
                         daemon=True).start()
        return True

    def _reader(self, sock: socket.socket, rfile) -> None:
        try:
            while True:
                frame = recv_frame(rfile)
                if frame is None:
                    raise ConnectionError("peer closed the socket")
                self._dispatch(frame)
        except (ConnectionError, OSError, ValueError, json.JSONDecodeError) \
                as e:
            with self._lock:
                # a stop()/kill()/re-attach swapped the socket out from
                # under us: this reader's death is deliberate, not news
                deliberate = self._stopping or sock is not self._sock
                stopping = self._stopping
            if not deliberate:
                self._declare_down(self._disconnect_reason())
                logger.warning(f"serving transport: worker {self.name} "
                               f"connection lost: {e!r}")
            elif stopping:
                # graceful stop: the peer closing its side is the signal
                # _await_peer_exit waits on for dial-in workers
                self._connected.clear()

    def _dispatch(self, frame: Dict[str, Any]) -> None:
        ev = frame.get("ev")
        if ev == "hb":
            with self._lock:
                self._last_hb = time.monotonic()
                self._stats = frame.get("stats", {})
                pid = frame.get("pid")
                if pid:
                    self._hb_pid = int(pid)
                cls = self._stats.get("class")
                if cls:  # the worker's word wins over pool assignment
                    self.replica_class = str(cls)
            # trace stitching: heartbeats piggyback the worker's
            # freshly-completed spans and flight-recorder events; merge
            # them into THIS process's rings so /debug/trace and flight
            # dumps show the whole fleet.  Outside the transport lock —
            # ingestion takes the tracer/recorder locks.
            spans = frame.get("spans") or []
            events = frame.get("events") or []
            if spans or events:
                pid = int(frame.get("pid") or 0)
                proc_name = frame.get("proc") or f"worker-{self.name}"
                if spans:
                    tracer.ingest_remote(spans, pid, proc_name)
                if events:
                    recorder.ingest_events(events, pid)
            return
        if ev in ("swap_ok", "swap_err", "adapter_ok", "adapter_err"):
            with self._lock:
                ctrl_q = self._ctrl.get(frame.get("cid"))
            if ctrl_q is not None:
                ctrl_q.put(frame)
            return
        rid = frame.get("rid")
        if ev in ("accepted", "rejected"):
            with self._lock:
                ack_q = self._acks.get(rid)
            if ack_q is not None:
                ack_q.put(frame)
            return
        with self._lock:
            handle = self._pending.get(rid)
        if handle is None:
            return  # cancelled/failed-over request still streaming: drop
        if ev == "tok":
            for tok in frame["toks"]:
                handle.q.put(("tok", tok))
        elif ev == "done":
            with self._lock:
                self._pending.pop(rid, None)
            handle.q.put(("done", frame.get("reason")))
        elif ev == "err":
            with self._lock:
                self._pending.pop(rid, None)
            handle.q.put(("err", (frame.get("reason", "engine_error"),
                                  frame.get("detail", ""))))

    def _declare_down(self, reason: str, from_spawn: bool = False) -> None:
        """Idempotent death transition: fail in-flight streams (the
        balancer fails them over), tear the peer down, leave a
        flight-recorder dump.  Streams always fail with ``replica_dead``
        whatever ``reason`` says — that is the balancer's retryable set."""
        with self._lock:
            if self._down is not None or self._stopping:
                return
            self._down = reason
            self._connected.clear()
            pending = list(self._pending.values())
            acks = list(self._acks.values())
            ctrls = list(self._ctrl.values())
            self._pending = {}
            self._acks = {}
            self._ctrl = {}
            sock, self._sock = self._sock, None
            rfile, self._rfile = self._rfile, None
        for ack_q in acks:
            ack_q.put({"ev": "rejected", "etype": "stopped",
                       "detail": reason})
        for ctrl_q in ctrls:
            ctrl_q.put({"ev": "swap_err", "detail": reason})
        for h in pending:
            h.q.put(("err", ("replica_dead", reason)))
        self._close_io(sock, rfile)
        self._teardown_peer(reason)
        logger.error(f"serving transport: worker {self.name} gen "
                     f"{self.generation} DOWN ({reason}); "
                     f"{len(pending)} in-flight streams failing over")
        tracer.add_event("replica/death",
                         attrs={"replica": self.name, "reason": reason,
                                "generation": self.generation,
                                "in_flight": len(pending)})
        recorder.record_event("replica/death", replica=self.name,
                              reason=reason, generation=self.generation,
                              in_flight=len(pending))
        if self.metrics is not None:
            self.metrics.record_fleet("worker_deaths")
        if not from_spawn:
            recorder.dump(reason=f"worker_death_{self.name}")

    def kill(self, reason: str = "replica_dead") -> None:
        """Hard-kill the peer (SIGKILL, no grace) — the fault-injection-
        free way to simulate a worker crash."""
        self._force_kill_peer()
        self._declare_down(reason)

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        timeout = 30.0 if timeout is None else timeout
        with self._lock:
            self._stopping = True
            sock = self._sock
        if sock is not None:
            try:
                send_frame(sock, {"op": "stop", "drain": drain,
                                  "timeout": timeout}, self._wlock)
            except OSError:
                pass
        self._await_peer_exit(timeout)
        with self._lock:
            sock, self._sock = self._sock, None
            rfile, self._rfile = self._rfile, None
            pending = list(self._pending.values())
            ctrls = list(self._ctrl.values())
            self._pending = {}
            self._ctrl = {}
        for h in pending:
            h.q.put(("err", ("shutdown", "replica stopped")))
        for ctrl_q in ctrls:
            ctrl_q.put({"ev": "swap_err", "detail": "shutdown"})
        self._close_io(sock, rfile)
        self._connected.clear()

    @staticmethod
    def _close_io(sock, rfile) -> None:
        """Close the socket AND its buffered reader: ``makefile`` holds an
        io-ref on the fd, so closing only the socket object would leave
        the descriptor open until GC (the leak tests count fds).  Shut the
        socket down first: a reader thread blocked in ``recv`` holds the
        buffer lock that ``rfile.close()`` needs, and with a live peer
        (fencing severs a HEALTHY connection) nothing else would ever
        wake it — shutdown forces the EOF that releases the lock."""
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for f in (rfile, sock):
            if f is not None:
                try:
                    f.close()
                except OSError:
                    pass

    # -- client surface --------------------------------------------------

    def healthy(self) -> bool:
        with self._lock:
            return (self._down is None and not self._stopping
                    and self.circuit_open is False
                    and self._connected.is_set()
                    and self._peer_alive())

    def submit(self, prompt: Sequence[int], rid: Optional[str] = None,
               **kwargs):
        if not self.healthy():
            raise BrokerStoppedError(f"replica {self.name} not accepting")
        rid = rid or f"{self.name}.g{self.generation}-{next(self._rid_counter)}"
        handle = RemoteHandle(self, rid, list(prompt))
        ack_q: "queue.Queue" = queue.Queue()
        with self._lock:
            if self._down is not None or self._stopping or self._sock is None:
                raise BrokerStoppedError(f"replica {self.name} not accepting")
            self._pending[rid] = handle
            self._acks[rid] = ack_q
            sock = self._sock
        msg = {"op": "submit", "rid": rid, "prompt": list(prompt)}
        for key in ("max_new_tokens", "temperature", "deadline_s",
                    "stop_token_ids", "seed", "tenant", "slo_class",
                    "adapter"):
            if kwargs.get(key) is not None:
                msg[key] = kwargs[key] if key != "stop_token_ids" \
                    else list(kwargs[key])
        # trace context: the worker's broker records its spans
        # under the trace id minted by the FIRST process that saw the
        # request, so a failover resubmit (new rid, same trace_id) still
        # renders as one continuous request timeline.
        trace_id = kwargs.get("trace_id") or rid
        msg["trace"] = {"trace_id": trace_id}
        tracer.add_event("request/dispatch", trace_id=trace_id,
                         attrs={"replica": self.name, "rid": rid,
                                "generation": self.generation})
        try:
            send_frame(sock, msg, self._wlock)
            ack = ack_q.get(timeout=self.cfg.submit_timeout_s)
        except (OSError, queue.Empty) as e:
            with self._lock:
                self._pending.pop(rid, None)
                self._acks.pop(rid, None)
            raise BrokerStoppedError(
                f"replica {self.name} unreachable on submit: {e!r}")
        finally:
            with self._lock:
                self._acks.pop(rid, None)
        if ack.get("ev") == "accepted":
            return handle
        with self._lock:
            self._pending.pop(rid, None)
        etype = ack.get("etype")
        detail = ack.get("detail", "")
        if etype == "queue_full":
            raise QueueFullError(detail or "admission queue full")
        if etype == "invalid":
            raise InvalidRequestError(detail or "invalid request")
        raise BrokerStoppedError(detail or f"replica {self.name} rejected")

    def cancel(self, rid: str) -> bool:
        with self._lock:
            sock = self._sock
            known = rid in self._pending
        if sock is None:
            return False
        try:
            send_frame(sock, {"op": "cancel", "rid": rid}, self._wlock)
        except OSError:
            return False
        return known

    def inject_fault(self, spec: Dict[str, str]) -> bool:
        """Arm ``utils/faults`` sites inside the CURRENT worker process
        (chaos tests; respawned generations start clean — use
        ``extra_env={"DSTPU_FAULTS": ...}`` for persistent faults)."""
        with self._lock:
            sock = self._sock
        if sock is None:
            return False
        try:
            send_frame(sock, {"op": "fault", "spec": dict(spec)},
                       self._wlock)
        except OSError:
            return False
        return True

    # -- control ops (rolling rollout) -----------------------------------

    def _control(self, msg: Dict[str, Any],
                 timeout: Optional[float] = None) -> Dict[str, Any]:
        """Send a control op and wait for its ``cid``-keyed ack."""
        timeout = 60.0 if timeout is None else timeout
        cid = f"c{next(self._rid_counter)}"
        ctrl_q: "queue.Queue" = queue.Queue()
        with self._lock:
            if self._down is not None or self._stopping or self._sock is None:
                raise BrokerStoppedError(f"replica {self.name} not accepting")
            self._ctrl[cid] = ctrl_q
            sock = self._sock
        try:
            send_frame(sock, dict(msg, cid=cid), self._wlock)
            return ctrl_q.get(timeout=timeout)
        except (OSError, queue.Empty) as e:
            raise RequestFailedError(
                "swap_failed",
                f"replica {self.name} control {msg.get('op')!r}: {e!r}")
        finally:
            with self._lock:
                self._ctrl.pop(cid, None)

    def swap(self, ckpt_dir: str, timeout: Optional[float] = None) -> None:
        """Pointer-swap the worker's params to a committed checkpoint.
        The caller (``serving/rollout.py``) quiesces + drains first."""
        reply = self._control({"op": "swap", "ckpt_dir": ckpt_dir}, timeout)
        if reply.get("ev") != "swap_ok":
            raise RequestFailedError("swap_failed", reply.get("detail", ""))

    def swap_rollback(self, timeout: Optional[float] = None) -> None:
        reply = self._control({"op": "swap_rollback"}, timeout)
        if reply.get("ev") != "swap_ok":
            raise RequestFailedError("swap_failed", reply.get("detail", ""))

    def adapter_register(self, adapter_id: str, ckpt_dir: str,
                         scaling: Optional[float] = None,
                         timeout: Optional[float] = None) -> None:
        """Hot-load an adapter checkpoint into the worker's registry (no
        quiesce — registering only adds routable state)."""
        msg: Dict[str, Any] = {"op": "adapter_register",
                               "adapter": adapter_id, "ckpt_dir": ckpt_dir}
        if scaling is not None:
            msg["scaling"] = float(scaling)
        reply = self._control(msg, timeout)
        if reply.get("ev") != "adapter_ok":
            raise RequestFailedError("adapter_failed",
                                     reply.get("detail", ""))

    def adapter_retire(self, adapter_id: str,
                       timeout: Optional[float] = None) -> bool:
        reply = self._control({"op": "adapter_retire",
                               "adapter": adapter_id}, timeout)
        if reply.get("ev") != "adapter_ok":
            raise RequestFailedError("adapter_failed",
                                     reply.get("detail", ""))
        return bool(reply.get("drained", True))

    # -- stats (heartbeat-carried; never raises on a dead worker) --------

    def _stat(self, key: str, default=0):
        with self._lock:
            return self._stats.get(key, default)

    def queue_depth(self) -> int:
        return int(self._stat("queue_depth"))

    def outstanding_tokens(self) -> int:
        with self._lock:
            base = int(self._stats.get("outstanding_tokens", 0))
            n_pending = len(self._pending)
        # heartbeat stats lag by up to one interval: count locally-known
        # in-flight requests as a floor so burst routing still spreads
        return max(base, n_pending)

    def kv_utilization(self) -> float:
        return float(self._stat("kv_utilization", 0.0))

    def num_running(self) -> int:
        return int(self._stat("running"))

    def prefix_stats(self) -> Dict[str, float]:
        return dict(self._stat("prefix", {}))

    def spec_stats(self) -> Dict[str, float]:
        return dict(self._stat("spec", {}))

    def prefix_summary(self) -> Dict[str, Any]:
        return dict(self._stat("prefix_summary", {}))

    def adapter_stats(self) -> Dict[str, float]:
        return dict(self._stat("adapters", {}))

    def adapter_summary(self) -> Dict[str, Any]:
        return dict(self._stat("adapter_summary", {}))

    # -- supervisor surface ----------------------------------------------

    def liveness(self) -> Dict[str, Any]:
        now = time.monotonic()
        with self._lock:
            return {
                "down": self._down,
                "stopping": self._stopping,
                "connected": self._connected.is_set(),
                "alive": self._peer_alive(),
                "pid": self._peer_pid(),
                "hb_age": (now - self._last_hb) if self._last_hb else 0.0,
                "progress_age": float(self._stats.get("progress_age", 0.0)),
                "busy": bool(self._stats.get("busy", False)),
                "broker_healthy": bool(self._stats.get("healthy", True)),
                "spawn_age": now - self.spawn_ts,
                "lease_remaining": self._lease_remaining(now),
            }

    def mark_down(self, reason: str) -> None:
        """Supervisor verdict (heartbeat timeout / hung replica)."""
        self._declare_down(reason)

    def describe(self) -> Dict[str, Any]:
        live = self.liveness()
        d = {"transport": self.transport, "pid": live["pid"],
             "generation": self.generation,
             "consecutive_failures": self.consecutive_failures,
             "circuit_open": self.circuit_open,
             "down_reason": live["down"]}
        kernels = self._stat("kernels", None)
        if kernels is not None:  # the worker's kernel counts (port only)
            d["kernels"] = kernels
        return d


class SubprocessReplica(FramedReplica):
    """A replica living in its own process (its own CUDA context), reached
    over the length-prefixed socket protocol.  Restartable: after a death
    the supervisor calls :meth:`respawn` and the same object serves the
    next worker generation (the pool's routing indexes stay stable).

    ``worker_argv`` is the ``python -m deepspeed_tpu_torch.serving.worker``
    argument list describing the engine (model, geometry, caching/spec
    flags); ``extra_env`` is merged into the worker environment on every
    (re)spawn — chaos tests use it to arm persistent ``DSTPU_FAULTS``."""

    transport = "subprocess"

    def __init__(self, worker_argv: Sequence[str], config: ServingConfig,
                 name: str = "replica0",
                 metrics: Optional[ServingMetrics] = None,
                 extra_env: Optional[Dict[str, str]] = None):
        super().__init__(config, name, metrics=metrics)
        self.worker_argv = list(worker_argv)
        self.extra_env = dict(extra_env or {})
        self._proc: Optional[subprocess.Popen] = None

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "SubprocessReplica":
        """Spawn the worker and return immediately; a connector thread
        waits for the ready line and wires the socket.  ``healthy()``
        flips true once connected (use ``ReplicaPool.wait_ready``)."""
        with self._lock:
            if self._proc is not None and self._down is None:
                return self
            self._down = None
            self._stopping = False
            self._connected.clear()
            self._pending = {}
            self._acks = {}
            self._ctrl = {}
            self._stats = {}
            self.lease_escalated = False
            self.spawn_ts = time.monotonic()
        env = dict(os.environ)
        # the worker must import deepspeed_tpu regardless of caller cwd
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        prev = env.get("PYTHONPATH")
        env["PYTHONPATH"] = (pkg_root + os.pathsep + prev) if prev \
            else pkg_root
        env.update(self.extra_env)
        proc = subprocess.Popen(
            [sys.executable, "-m", "deepspeed_tpu_torch.serving.worker",
             "--name", f"{self.name}.g{self.generation}",
             "--heartbeat_interval_s", str(self.cfg.heartbeat_interval_s),
             *self.worker_argv],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, start_new_session=True)
        with self._lock:
            self._proc = proc
        logger.info(f"serving transport: spawned worker {self.name} "
                    f"gen {self.generation} pid {proc.pid}")
        tracer.add_event("replica/spawn",
                         attrs={"replica": self.name, "pid": proc.pid,
                                "generation": self.generation})
        recorder.record_event("replica/spawn", replica=self.name,
                              pid=proc.pid, generation=self.generation)
        if self.metrics is not None:
            self.metrics.record_fleet(
                "respawns" if self.generation else "spawns")
        threading.Thread(target=self._connector, args=(proc,),
                         name=f"dstpu-connect-{self.name}",
                         daemon=True).start()
        return self

    def respawn(self) -> "SubprocessReplica":
        """Next worker generation after a death (supervisor-driven)."""
        with self._lock:
            self.generation += 1
            self._proc = None  # previous generation already reaped
        return self.start()

    def _connector(self, proc: subprocess.Popen) -> None:
        """Wait for the worker's ready line, connect, then keep draining
        worker stdout (its logs) so the pipe can never fill and block it."""
        deadline = self.spawn_ts + self.cfg.spawn_timeout_s
        addr = None
        try:
            while time.monotonic() < deadline:
                line = proc.stdout.readline()
                if not line:
                    rc = proc.poll()
                    raise RuntimeError(f"worker exited rc={rc} before ready")
                if READY_MARKER in line:
                    addr = line.split(READY_MARKER, 1)[1].strip()
                    break
                logger.debug(f"worker[{self.name}]: {line.rstrip()}")
            if addr is None:
                raise TimeoutError(
                    f"worker not ready in {self.cfg.spawn_timeout_s:.0f}s")
            host, port = addr.rsplit(":", 1)
            sock = socket.create_connection((host, int(port)), timeout=30.0)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            rfile = sock.makefile("rb")
            if not self._wire(sock, rfile, guard=lambda: (
                    self._down is None and proc is self._proc)):
                self._close_io(sock, rfile)
                return
        except Exception as e:
            logger.error(f"serving transport: worker {self.name} spawn "
                         f"failed: {e!r}")
            self._declare_down(f"spawn_failed: {e}", from_spawn=True)
            return
        # stdout drain (post-ready): worker logs route to our logger
        try:
            for line in proc.stdout:
                logger.debug(f"worker[{self.name}]: {line.rstrip()}")
        except (OSError, ValueError):
            pass

    # -- peer hooks ------------------------------------------------------

    def _peer_alive(self) -> bool:
        proc = self._proc
        return proc is not None and proc.poll() is None

    def _peer_pid(self) -> Optional[int]:
        proc = self._proc
        return None if proc is None else proc.pid

    def _teardown_peer(self, reason: str) -> None:
        proc = self._proc
        if proc is not None:
            # the worker was started in its own session: reap the whole
            # group so engine helper processes can't outlive it
            terminate_procs([proc], term_timeout_s=2.0, process_group=True)
            self._close_stdout(proc)

    def _force_kill_peer(self) -> None:
        with self._lock:
            proc = self._proc
        if proc is not None and proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError, OSError):
                try:
                    proc.kill()
                except OSError:
                    pass

    def _await_peer_exit(self, timeout: float) -> None:
        with self._lock:
            proc = self._proc
        if proc is None:
            return
        deadline = time.monotonic() + timeout
        while proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.02)
        terminate_procs([proc], term_timeout_s=5.0, process_group=True)
        self._close_stdout(proc)

    def _close_stdout(self, proc: subprocess.Popen) -> None:
        """Release the worker's stdout pipe once it has exited (the
        connector's drain loop tolerates the close)."""
        if proc.stdout is not None:
            try:
                proc.stdout.close()
            except OSError:
                pass
