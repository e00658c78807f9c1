"""Multi-host fleet transport: dial-in workers with fenced registration (the
port of ``deepspeed_tpu/serving/remote.py``).

The subprocess transport forks workers and greps their stdout for
a ready line — a topology that stops at one machine.  This module turns
the same frame protocol outward: workers **dial in** to the pool's
:class:`WorkerRegistry` over TCP and register with a versioned,
authenticated hello; the pool never needs to reach, fork, or even name a
host.  Three pieces:

* :class:`RemoteReplica` — a :class:`~deepspeed_tpu_torch.serving.transport.
  FramedReplica` slot whose socket arrives by registration rather than
  by connect.  A slot may be **launcher-backed** (the pool spawns the
  worker process itself — loopback fleets, autoscaling, tests) or
  **externally managed** (``can_respawn`` False: some other agent runs
  the worker; the supervisor waits for re-registration instead of
  respawning).
* :class:`WorkerRegistry` — the accept loop + handshake.  Every
  registration carries a **fencing epoch**; the registry tracks the
  highest epoch granted per worker name and rejects anything older, so
  a partitioned-then-returning worker with stale in-flight streams is
  turned away (it exits) instead of double-serving — split-brain safety
  by monotonic epoch, the same discipline as the elasticity layer's
  generation counter.  A *newer* epoch fences the current holder: its
  streams fail over before the new connection is adopted.
* :class:`LocalWorkerLauncher` — spawns ``python -m
  deepspeed_tpu_torch.serving.worker --connect HOST:PORT --epoch N`` processes
  for launcher-backed slots (the loopback stand-in for a cluster
  scheduler; production deployments run the same command under their
  own process manager).

Handshake (worker → registry, first frame on the connection)::

    {"op": "hello", "magic": "dstpu-fleet", "version": 1,
     "token": <shared secret>, "name": "replica0", "pid": ...,
     "epoch": N}            # launcher-assigned fresh registration
    {"op": "hello", ..., "prev_epoch": N}   # reconnect after a blip

reply: ``{"ev": "hello_ok", "epoch": granted}`` or ``{"ev":
"hello_err", "reason": ...}`` — a rejected worker must exit, not retry:
its epoch can only get staler.

Epoch policy (``cur`` = highest epoch ever granted for the name):

* explicit ``epoch <  cur`` → ``stale_epoch`` (zombie from before a
  respawn decision);
* explicit ``epoch == cur`` → accepted only if the slot is not
  currently connected, else ``duplicate_epoch`` (two processes claiming
  one grant — split brain);
* explicit ``epoch >  cur`` → accepted, fencing any current holder;
* no ``epoch``: ``prev_epoch == cur`` → auto-granted ``cur + 1`` (the
  same worker reconnecting after a connection drop), anything else →
  ``stale_epoch``.

Deadlines: true socket timeouts apply only during the hello, on both
ends — a half-open connection cannot park the handshake thread forever.
Steady-state deadlines are application-layer (heartbeat timeout, lease
TTL, submit-ack timeout) because flipping ``settimeout`` on a socket
shared by a blocking reader thread and concurrent writers is racy;
``close()`` is what unblocks a stuck ``sendall``.  ``SO_KEEPALIVE`` +
``TCP_NODELAY`` are set as belt-and-braces.

The **lease** is what lets the supervisor tell network loss from worker
death: a remote slot whose connection dropped keeps its streams' slot
reserved for ``lease_ttl_s`` past its last heartbeat.  Re-registration
within the lease resumes the slot (fresh epoch, failover already done);
expiry escalates to the normal dead-worker path — respawn for
launcher-backed slots, patience for external ones.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from ..observability.recorder import recorder
from ..observability.trace import tracer
from ..utils.locks import named_lock
from ..utils.logging import logger
from .config import REPLICA_CLASSES, ServingConfig
from .metrics import ServingMetrics
from .transport import (FLEET_MAGIC, PROTO_VERSION, FramedReplica,
                        ProtocolError, recv_frame, send_frame)

#: env var the worker reads its shared-secret auth token from (never on
#: the command line: argv is world-readable in /proc)
TOKEN_ENV = "DSTPU_FLEET_TOKEN"


class RemoteReplica(FramedReplica):
    """A fleet slot filled by worker registration.  The socket comes and
    goes (registrations, fences, reconnects); the slot — its name, its
    routing index, its supervisor bookkeeping — is stable."""

    transport = "remote"

    def __init__(self, config: ServingConfig, name: str,
                 metrics: Optional[ServingMetrics] = None,
                 launcher: Optional["LocalWorkerLauncher"] = None,
                 replica_class: str = "mixed"):
        super().__init__(config, name, metrics=metrics)
        self.replica_class = replica_class
        self.launcher = launcher
        self.registry: Optional["WorkerRegistry"] = None  # set on register
        self.epoch = 0
        self._proc: Optional[subprocess.Popen] = None  # launcher-owned

    @property
    def can_respawn(self) -> bool:
        """Only launcher-backed slots can be respawned from here; an
        externally-managed worker must dial back in on its own."""
        return self.launcher is not None

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "RemoteReplica":
        with self._lock:
            self._down = None
            self._stopping = False
            self.lease_escalated = False
            self.spawn_ts = time.monotonic()
        if self.launcher is None or self.registry is None:
            return self  # externally managed: wait for the dial-in
        if self.healthy():
            return self
        # a hung previous generation must not come back and double-serve;
        # its stale epoch would be fenced anyway, but don't leak it
        self._force_kill_peer()
        epoch = self.registry.next_epoch(self.name)
        proc = self.launcher.spawn(self.name, self.registry.address, epoch,
                                   generation=self.generation,
                                   replica_class=self.replica_class)
        with self._lock:
            self._proc = proc
        logger.info(f"serving remote: launched worker {self.name} "
                    f"epoch {epoch} pid {proc.pid}")
        tracer.add_event("replica/spawn",
                         attrs={"replica": self.name, "pid": proc.pid,
                                "generation": self.generation,
                                "epoch": epoch})
        recorder.record_event("replica/spawn", replica=self.name,
                              pid=proc.pid, generation=self.generation,
                              epoch=epoch)
        if self.metrics is not None:
            self.metrics.record_fleet(
                "respawns" if self.generation else "spawns")
        return self

    def attach(self, sock: socket.socket, rfile, epoch: int) -> None:
        """Adopt a registry-accepted connection.  If the slot currently
        holds a live connection the new epoch fences it: the old streams
        fail over (balancer resubmits elsewhere) before the swap."""
        if self.healthy():
            self._declare_down("fenced")
        with self._lock:
            self._down = None
            self._stopping = False
            self._pending = {}
            self._acks = {}
            self._ctrl = {}
            self._stats = {}
            self.epoch = epoch
            self.next_respawn_at = 0.0
            self.lease_escalated = False
            self.spawn_ts = time.monotonic()
        self._wire(sock, rfile)
        logger.info(f"serving remote: {self.name} registered "
                    f"(epoch {epoch})")
        tracer.add_event("replica/registered",
                         attrs={"replica": self.name, "epoch": epoch})
        recorder.record_event("replica/registered", replica=self.name,
                              epoch=epoch)
        if self.metrics is not None:
            self.metrics.record_fleet("registrations")

    # -- peer hooks ------------------------------------------------------

    def _disconnect_reason(self) -> str:
        # the supervisor holds the slot's lease open on this reason —
        # a blip is survivable; worker death is decided by lease expiry
        return "connection_lost"

    def _lease_remaining(self, now: float) -> Optional[float]:
        if not self._last_hb:
            return None
        return max(0.0, (self._last_hb + self.cfg.lease_ttl_s) - now)

    def _teardown_peer(self, reason: str) -> None:
        # never kill a live launcher process on connection loss — it may
        # be mid-reconnect; just reap it if it already exited
        proc = self._proc
        if proc is not None:
            proc.poll()

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
        deadline = time.monotonic() + timeout
        if proc is not None:
            while proc.poll() is None and time.monotonic() < deadline:
                time.sleep(0.02)
            if proc.poll() is None:
                self._force_kill_peer()
        else:
            # externally launched: wait for the worker to close its side
            # after honouring the stop frame (the reader clears _connected)
            while self._connected.is_set() and time.monotonic() < deadline:
                time.sleep(0.02)

    def describe(self) -> Dict[str, Any]:
        d = super().describe()
        d["epoch"] = self.epoch
        d["externally_managed"] = self.launcher is None
        d["replica_class"] = self.replica_class
        return d


class WorkerRegistry:
    """Accept loop + authenticated, fenced handshake for dial-in workers.

    Owns the epoch book: the highest epoch granted per worker name, ever.
    ``next_epoch`` (used when the pool itself launches a worker) and the
    handshake's grant path both advance it under one lock, so no two
    live connections can ever hold the same slot."""

    def __init__(self, config: ServingConfig,
                 metrics: Optional[ServingMetrics] = None):
        self.cfg = config
        self.metrics = metrics
        self._lock = named_lock("registry.state")
        self._slots: Dict[str, RemoteReplica] = {}
        self._epochs: Dict[str, int] = {}
        self._lsock: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.address: Optional[str] = None  # "host:port" once listening

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "WorkerRegistry":
        if self._thread is not None:
            return self
        lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lsock.bind((self.cfg.registry_host, self.cfg.registry_port))
        lsock.listen(16)
        lsock.settimeout(0.25)  # accept-poll so stop() can land
        self._lsock = lsock
        host, port = lsock.getsockname()
        self.address = f"{host}:{port}"
        self._stop.clear()
        self._thread = threading.Thread(target=self._accept_loop,
                                        name="dstpu-registry", daemon=True)
        self._thread.start()
        logger.info(f"serving remote: registry listening on {self.address}"
                    f" (auth {'ON' if self.cfg.fleet_token else 'OFF'})")
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._lsock is not None:
            try:
                self._lsock.close()
            except OSError:
                pass
            self._lsock = None

    # -- slot book -------------------------------------------------------

    def register_slot(self, replica: RemoteReplica) -> RemoteReplica:
        with self._lock:
            if replica.name in self._slots:
                raise ValueError(f"slot {replica.name!r} already registered")
            self._slots[replica.name] = replica
            self._epochs.setdefault(replica.name, 0)
        replica.registry = self
        return replica

    def unregister_slot(self, name: str) -> None:
        with self._lock:
            self._slots.pop(name, None)
            # the epoch book entry stays: a late dial-in under a retired
            # name must still be recognizably stale, never a fresh slot

    def next_epoch(self, name: str) -> int:
        with self._lock:
            e = self._epochs.get(name, 0) + 1
            self._epochs[name] = e
            return e

    def membership(self) -> List[Dict[str, Any]]:
        """Per-slot view for the Prometheus membership gauge and /healthz."""
        with self._lock:
            slots = sorted(self._slots.items())
        out = []
        for name, slot in slots:
            live = slot.liveness()
            out.append({"worker": name, "epoch": slot.epoch,
                        "connected": live["connected"],
                        "lease_remaining": live["lease_remaining"]})
        return out

    # -- handshake -------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, addr = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._handshake, args=(conn, addr),
                             name="dstpu-registry-hello",
                             daemon=True).start()

    def _handshake(self, conn: socket.socket, addr) -> None:
        rfile = None
        try:
            conn.settimeout(self.cfg.hello_timeout_s)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
            rfile = conn.makefile("rb")
            hello = recv_frame(rfile)
        except ProtocolError as e:
            # garbage on the registry port (an HTTP probe, line noise):
            # one clean close, one counter, no traceback
            logger.warning(f"serving remote: protocol error in hello from "
                           f"{addr}: {e}")
            if self.metrics is not None:
                self.metrics.record_fleet("protocol_errors")
            FramedReplica._close_io(conn, rfile)
            return
        except (ConnectionError, OSError, socket.timeout):
            FramedReplica._close_io(conn, rfile)
            return
        reason, slot, granted = self._validate(hello)
        if reason is not None:
            self._reject(conn, rfile, addr, hello, reason)
            return
        wcls = hello.get("class")
        if wcls:  # the worker's declared class wins over pool assignment
            slot.replica_class = str(wcls)
        fenced = slot.healthy()  # live holder about to be severed
        try:
            send_frame(conn, {"ev": "hello_ok", "epoch": granted})
            conn.settimeout(None)  # steady state: app-layer deadlines only
        except OSError:
            FramedReplica._close_io(conn, rfile)
            return
        if fenced and self.metrics is not None:
            self.metrics.record_fleet("fenced")
        if fenced:
            tracer.add_event("replica/fenced",
                             attrs={"replica": slot.name, "epoch": granted})
            recorder.record_event("replica/fenced", replica=slot.name,
                                  epoch=granted)
        slot.attach(conn, rfile, granted)

    def _validate(self, hello):
        """Returns (reject_reason | None, slot, granted_epoch)."""
        if not isinstance(hello, dict) or hello.get("op") != "hello":
            return "bad_hello", None, 0
        if hello.get("magic") != FLEET_MAGIC:
            return "bad_magic", None, 0
        if hello.get("version") != PROTO_VERSION:
            return "version_mismatch", None, 0
        if self.cfg.fleet_token and \
                hello.get("token") != self.cfg.fleet_token:
            return "auth_failed", None, 0
        if hello.get("class", "mixed") not in REPLICA_CLASSES:
            return "bad_class", None, 0
        name = hello.get("name")
        with self._lock:
            slot = self._slots.get(name)
            if slot is None:
                return "unknown_worker", None, 0
            cur = self._epochs.get(name, 0)
            epoch = hello.get("epoch")
            if epoch is None:
                # reconnect path: the worker proves it held the current
                # epoch; anything else is a zombie from before a decision
                if int(hello.get("prev_epoch") or 0) != cur:
                    return "stale_epoch", slot, 0
                granted = cur + 1
            else:
                epoch = int(epoch)
                if epoch < cur:
                    return "stale_epoch", slot, 0
                if epoch == cur and slot.healthy():
                    return "duplicate_epoch", slot, 0
                granted = epoch
            self._epochs[name] = granted
        return None, slot, granted

    def _reject(self, conn, rfile, addr, hello, reason: str) -> None:
        name = hello.get("name") if isinstance(hello, dict) else None
        logger.warning(f"serving remote: rejecting registration from "
                       f"{addr} (worker {name!r}): {reason}")
        if self.metrics is not None and \
                reason in ("stale_epoch", "duplicate_epoch"):
            self.metrics.record_fleet("stale_epoch_rejects")
        tracer.add_event("replica/registration_rejected",
                         attrs={"replica": str(name), "reason": reason})
        recorder.record_event("replica/registration_rejected",
                              replica=str(name), reason=reason)
        try:
            send_frame(conn, {"ev": "hello_err", "reason": reason})
        except OSError:
            pass
        FramedReplica._close_io(conn, rfile)


class LocalWorkerLauncher:
    """Spawn dial-in workers on THIS host (loopback fleets, autoscaler
    scale-ups, tests).  Production topologies run the identical command
    line under their own scheduler; the registry cannot tell the
    difference — that is the point.

    Durable-state note: any --kv_coldstore_dir / --adapter_coldstore_dir
    roots on worker_argv ride every spawn unchanged; each worker derives
    a per-replica subdir from its --name with the generation suffix
    stripped, so a re-registered generation of the same replica lands on
    its predecessor's cold store and rehydrates warm state at boot."""

    def __init__(self, worker_argv: Sequence[str], config: ServingConfig,
                 extra_env: Optional[Dict[str, str]] = None):
        self.worker_argv = list(worker_argv)
        self.cfg = config
        self.extra_env = dict(extra_env or {})

    def spawn(self, name: str, address: str, epoch: int,
              generation: int = 0,
              replica_class: str = "mixed") -> subprocess.Popen:
        env = dict(os.environ)
        # the worker must import deepspeed_tpu_torch regardless of caller cwd
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        prev = env.get("PYTHONPATH")
        env["PYTHONPATH"] = (pkg_root + os.pathsep + prev) if prev \
            else pkg_root
        if self.cfg.fleet_token:
            env[TOKEN_ENV] = self.cfg.fleet_token
        env.update(self.extra_env)
        return subprocess.Popen(
            [sys.executable, "-m", "deepspeed_tpu_torch.serving.worker",
             "--name", name, "--connect", address, "--epoch", str(epoch),
             "--heartbeat_interval_s", str(self.cfg.heartbeat_interval_s),
             "--replica_class", replica_class,
             *self.worker_argv],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            env=env, start_new_session=True)
