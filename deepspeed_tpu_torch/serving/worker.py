"""Out-of-process replica worker: one engine, one process, one socket (the
port of ``deepspeed_tpu/serving/worker.py``).

The fault-isolation unit of the serving fleet.  Each worker owns a full
:class:`~deepspeed_tpu_torch.inference.v2.engine.InferenceEngineV2` behind a
:class:`~deepspeed_tpu_torch.serving.broker.RequestBroker` — its own params,
its own paged KV, its own CUDA context — so a segfault, OOM, wedged
compile, or injected chaos fault costs exactly one replica.  Two ways a
worker meets its pool:

* **listen mode** (``--replica_transport subprocess``): bind
  ``127.0.0.1:<ephemeral>``, print ``dstpu-worker listening on
  HOST:PORT`` (the parent greps for it), accept exactly one connection.
  The pool side is :class:`~deepspeed_tpu_torch.serving.transport.
  SubprocessReplica`; the supervisor respawns us as ``<name>.g<N+1>``.
* **connect mode** (``--connect HOST:PORT``, the multi-host fleet): dial
  the pool's registry and send an authenticated hello carrying our
  fencing ``--epoch`` (token from ``$DSTPU_FLEET_TOKEN``, never argv).
  On a dropped connection we reconnect with decorrelated-jitter backoff,
  proving continuity with ``prev_epoch``; a ``hello_err`` means our
  epoch is stale — some newer registration owns the slot — and the only
  correct move is to **exit** (rc 3), because a fenced zombie's epoch
  only gets staler.  The pool side is :class:`~deepspeed_tpu_torch.serving.
  remote.RemoteReplica`.

The worker runs its engine on the card unless ``--device cpu`` is passed.

Per-connection thread roles (both modes):

* **reader**: op loop over ``submit`` / ``cancel`` / ``fault`` /
  ``swap`` / ``swap_rollback`` / ``adapter_register`` /
  ``adapter_retire`` / ``stop`` (frame format: ``serving/transport.py``);
* **heartbeat**: every ``--heartbeat_interval_s``, one ``hb`` frame with
  the stats the pool's routing, gauges, and hung-replica detection need
  (plus piggybacked trace spans / flight events — cursors persist
  across reconnects, so nothing is re-sent or lost on a blip);
* **pump** (per request): forwards the broker's token stream as ``tok``
  frames, then ``done`` / ``err``.

Chaos sites (``utils/faults``), all reachable via the parent's
``inject_fault`` protocol op or a persistent ``DSTPU_FAULTS`` env:

* ``serving.worker.start`` — spawn-time crash (crash-loop / circuit-
  breaker tests; fires before the engine builds, so loops are cheap);
* ``serving.worker.hardkill`` — hard ``os._exit`` from the heartbeat
  thread (mid-decode worker loss);
* ``serving.worker.hang`` — the heartbeat thread sleeps forever: beats
  stop while the process stays alive (missed-beat detection);
* ``serving.worker.heartbeat`` — ``delay`` kind: slow heartbeats;
* ``serving.worker.swap`` — fires inside the swap op (mid-rollout crash
  tests);
* ``serving.step`` (in the broker loop) — ``hang`` kind wedges the
  engine thread itself: beats keep flowing but ``progress_age`` grows
  while ``busy`` (hung-replica detection).
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import sys
import threading
from typing import Optional

from ..accelerator import resolve_device
from ..observability.recorder import recorder
from ..observability.trace import tracer
from ..utils import faults
from ..utils.backoff import decorrelated_jitter
from ..utils.locks import named_lock
from ..utils.logging import logger
from .broker import (BrokerStoppedError, InvalidRequestError, QueueFullError,
                     RequestBroker, RequestFailedError)
from .config import ServingConfig, parse_slo_classes
from .transport import (FLEET_MAGIC, PROTO_VERSION, READY_MARKER,
                        recv_frame, send_frame)

#: dial-in reconnect pacing (decorrelated jitter; resets after a healthy
#: connection) — fast enough to ride out a blip inside the lease TTL
_RECONNECT_BASE_S = 0.2
_RECONNECT_CAP_S = 5.0
#: hello send → reply budget on the worker side (the registry has its own)
_HELLO_TIMEOUT_S = 10.0
#: exit code for a fenced/stale registration (deliberate, non-respawnable)
EXIT_FENCED = 3

def _stats(broker: RequestBroker) -> dict:
    eng = broker.engine
    stats = {
        "healthy": broker.healthy(),
        "busy": broker.busy(),
        "progress_age": broker.progress_age(),
        "queue_depth": broker.queue_depth(),
        "outstanding_tokens": broker.outstanding_tokens(),
        "kv_utilization": broker.kv_utilization(),
        "running": eng.num_running,
        "waiting": eng.num_waiting,
        "class": broker.cfg.replica_class,
        "prefix": eng.prefix_stats(),
        "spec": eng.spec_stats(),
        # radix-tree digest summary for the pool's cache-aware routing;
        # capped so a hot cache can't bloat the heartbeat frame
        "prefix_summary": eng.prefix_summary(max_digests=256),
    }
    if broker.adapters is not None:
        # registry digest for the pool's adapter-aware routing + gauges
        stats["adapters"] = broker.adapters.stats()
        stats["adapter_summary"] = broker.adapters.summary()
    stats["kernels"] = _kernel_counts(eng)
    return stats


def _kernel_counts(eng) -> dict:
    """This process's paged-attention launches and plain calls beside its
    engine's steps by kind: a caller holds them to one B4 launch per layer
    per mixed step and one B5 per layer per decode body (the port's own
    heartbeat field, shown under the replica in ``/healthz``)."""
    from ..ops.hopper import paged_attention as pa

    return {"launches": dict(pa.LAUNCHES),
            "plain_calls": dict(pa.PLAIN_CALLS),
            "steps": dict(eng.steps_by_kind)}


def _pump(conn: socket.socket, wlock: threading.Lock, rid: str,
          handle) -> None:
    """Forward one request's token stream to the parent.  A send failure
    means the parent is gone — cancel the request so it stops holding KV."""
    try:
        try:
            for tok in handle.tokens():
                send_frame(conn, {"ev": "tok", "rid": rid, "toks": [tok]},
                           wlock)
            send_frame(conn, {"ev": "done", "rid": rid,
                              "reason": handle.finish_reason}, wlock)
        except RequestFailedError as e:
            send_frame(conn, {"ev": "err", "rid": rid, "reason": e.reason,
                              "detail": str(e)}, wlock)
    except OSError:
        handle.cancel()


class _HeartbeatState:
    """Cursors for the span / flight-event batches piggybacked on
    heartbeat frames (trace stitching).  One instance per worker
    PROCESS, shared across reconnects, so the cursors keep advancing and
    a blip neither re-sends nor drops telemetry; the final graceful-stop
    flush shares it with the heartbeat thread, so frame building is
    serialized."""

    def __init__(self, name: str):
        self.name = name
        self.pid = os.getpid()
        self.span_cursor = 0
        self.event_cursor = 0
        self._lock = named_lock("worker.hb_state")

    def frame(self, broker: RequestBroker) -> dict:
        hb = {"ev": "hb", "stats": _stats(broker),
              "pid": self.pid, "proc": self.name}
        with self._lock:
            self.span_cursor, spans = tracer.export_since(self.span_cursor)
            self.event_cursor, events = recorder.events_since(
                self.event_cursor)
        if spans:
            hb["spans"] = spans
        if events:
            hb["events"] = events
        return hb


def _heartbeat_loop(conn: socket.socket, wlock: threading.Lock,
                    broker: RequestBroker, interval_s: float,
                    stop_evt: threading.Event,
                    hb_state: _HeartbeatState) -> None:
    while not stop_evt.wait(interval_s):
        faults.maybe_fail("serving.worker.hardkill")
        faults.maybe_fail("serving.worker.hang")
        faults.maybe_fail("serving.worker.heartbeat")
        try:
            send_frame(conn, hb_state.frame(broker), wlock)
        except OSError:
            return  # parent gone; the reader loop handles shutdown


def _handle_swap(conn: socket.socket, wlock: threading.Lock,
                 broker: RequestBroker, frame: dict, name: str) -> None:
    """Run a swap / swap_rollback control op inline on the reader thread
    (the pool quiesced + drained us first; the heartbeat thread keeps
    beating while the checkpoint loads)."""
    cid = frame.get("cid")
    op = frame.get("op")
    try:
        faults.maybe_fail("serving.worker.swap")
        if op == "swap":
            from .rollout import load_swap_params  # lazy: import cycle

            logger.info(f"worker {name}: swapping params from "
                        f"{frame.get('ckpt_dir')}")
            broker.swap_params(
                load_swap_params(frame["ckpt_dir"], broker.engine))
        else:
            logger.info(f"worker {name}: rolling params back")
            broker.swap_rollback()
    except Exception as e:  # noqa: BLE001 — a failed swap must reach the
        # rollout controller as a typed ack, not kill the worker
        logger.error(f"worker {name}: {op} failed: {e!r}")
        try:
            send_frame(conn, {"ev": "swap_err", "cid": cid,
                              "detail": repr(e)}, wlock)
        except OSError:
            pass
    else:
        try:
            send_frame(conn, {"ev": "swap_ok", "cid": cid}, wlock)
        except OSError:
            pass


def _handle_adapter(conn: socket.socket, wlock: threading.Lock,
                    broker: RequestBroker, frame: dict, name: str) -> None:
    """Run an adapter_register / adapter_retire control op inline on the
    reader thread (no quiesce: registering only adds routable state, and
    retire drains in-flight refs on its own)."""
    cid = frame.get("cid")
    op = frame.get("op")
    reply: dict = {"ev": "adapter_ok", "cid": cid}
    try:
        if broker.adapters is None:
            raise RuntimeError(
                f"worker {name} serves no adapters (--adapter_slots 0)")
        adapter = frame["adapter"]
        if op == "adapter_register":
            logger.info(f"worker {name}: registering adapter {adapter!r} "
                        f"from {frame.get('ckpt_dir')}")
            broker.adapters.register(adapter, ckpt_dir=frame["ckpt_dir"],
                                     scaling=frame.get("scaling"))
        else:
            logger.info(f"worker {name}: retiring adapter {adapter!r}")
            reply["drained"] = broker.adapters.retire(adapter)
    except Exception as e:  # noqa: BLE001 — a failed load must reach the
        # fleet controller as a typed ack, not kill the worker
        logger.error(f"worker {name}: {op} failed: {e!r}")
        reply = {"ev": "adapter_err", "cid": cid, "detail": repr(e)}
    try:
        send_frame(conn, reply, wlock)
    except OSError:
        pass


def _serve_conn(conn: socket.socket, broker: RequestBroker, name: str,
                heartbeat_interval_s: float, stop_evt: threading.Event,
                hb_state: _HeartbeatState, rfile=None) -> dict:
    """Op loop over one established connection until EOF / stop / SIGTERM.
    Returns ``{"exit": bool, "drain": ..., "timeout": ...}`` — ``exit``
    True means the pool told us to stop; False means the connection
    dropped (connect mode reconnects).  ``rfile`` is the connection's
    buffered reader when the caller already made one (the dial-in hello
    may have buffered op frames past the reply — a second ``makefile``
    would drop them)."""
    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    if rfile is None:
        rfile = conn.makefile("rb")
    wlock = named_lock("worker.write")
    hb_stop = threading.Event()
    hb_thread = threading.Thread(
        target=_heartbeat_loop,
        args=(conn, wlock, broker, heartbeat_interval_s, hb_stop, hb_state),
        name="dstpu-worker-hb", daemon=True)
    hb_thread.start()
    result = {"exit": False, "drain": False, "timeout": 5.0}
    try:
        while not stop_evt.is_set():
            try:
                frame = recv_frame(rfile)
            except (ConnectionError, OSError):
                frame = None
            if frame is None:
                break  # peer closed (or died)
            op = frame.get("op")
            if op == "submit":
                rid = frame["rid"]
                trace_ctx = frame.get("trace") or {}
                try:
                    handle = broker.submit(
                        prompt=frame["prompt"],
                        max_new_tokens=frame.get("max_new_tokens"),
                        temperature=frame.get("temperature"),
                        deadline_s=frame.get("deadline_s"),
                        stop_token_ids=frame.get("stop_token_ids", ()),
                        rid=rid,
                        trace_id=trace_ctx.get("trace_id"),
                        seed=frame.get("seed"),
                        tenant=frame.get("tenant"),
                        slo_class=frame.get("slo_class"),
                        adapter=frame.get("adapter"))
                except QueueFullError as e:
                    send_frame(conn, {"ev": "rejected", "rid": rid,
                                      "etype": "queue_full",
                                      "detail": str(e)}, wlock)
                except InvalidRequestError as e:
                    send_frame(conn, {"ev": "rejected", "rid": rid,
                                      "etype": "invalid",
                                      "detail": str(e)}, wlock)
                except BrokerStoppedError as e:
                    send_frame(conn, {"ev": "rejected", "rid": rid,
                                      "etype": "stopped",
                                      "detail": str(e)}, wlock)
                else:
                    send_frame(conn, {"ev": "accepted", "rid": rid}, wlock)
                    threading.Thread(target=_pump,
                                     args=(conn, wlock, rid, handle),
                                     name=f"dstpu-pump-{rid}",
                                     daemon=True).start()
            elif op == "cancel":
                broker.cancel(frame.get("rid", ""))
            elif op == "fault":
                # chaos hook: arm fault sites inside THIS worker process
                spec = frame.get("spec") or {}
                logger.warning(f"worker {name}: arming faults {spec}")
                faults.configure(spec)
            elif op in ("swap", "swap_rollback"):
                _handle_swap(conn, wlock, broker, frame, name)
            elif op in ("adapter_register", "adapter_retire"):
                _handle_adapter(conn, wlock, broker, frame, name)
            elif op == "stop":
                result = {"exit": True,
                          "drain": bool(frame.get("drain", True)),
                          "timeout": frame.get("timeout", 30.0)}
                break
            else:
                logger.warning(f"worker {name}: unknown op {op!r}")
    finally:
        hb_stop.set()
    if stop_evt.is_set():
        result["exit"] = True  # SIGTERM: treat like a no-drain stop
    return result


def _finish(conn: socket.socket, broker: RequestBroker,
            hb_state: _HeartbeatState, result: dict, name: str) -> int:
    """Graceful exit: drain per the stop op, flush telemetry, close."""
    broker.stop(drain=result["drain"], timeout=result["timeout"])
    # final span/event flush: drained requests finalize during stop(), and
    # their timelines must reach the front before the socket closes
    try:
        send_frame(conn, hb_state.frame(broker), named_lock("worker.write"))
    except OSError:
        pass
    try:
        conn.close()
    except OSError:
        pass
    logger.info(f"worker {name}: exited cleanly")
    return 0


def _install_sigterm(holder: dict, stop_evt: threading.Event) -> None:
    def _sigterm(signum, frame):
        # group-wide teardown (os.killpg from the parent): unblock the
        # reader by shutting the read side down; teardown runs in main
        stop_evt.set()
        conn = holder.get("conn")
        if conn is not None:
            try:
                conn.shutdown(socket.SHUT_RD)
            except OSError:
                pass

    signal.signal(signal.SIGTERM, _sigterm)


def _run_listen(args, broker: RequestBroker) -> int:
    """Subprocess transport: accept exactly one connection from the
    parent that forked us."""
    lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lsock.bind((args.host, 0))
    lsock.listen(1)
    lsock.settimeout(300.0)
    host, port = lsock.getsockname()
    # the parent transport greps worker stdout for this line
    print(f"{READY_MARKER}{host}:{port}", flush=True)
    try:
        conn, _ = lsock.accept()
    except socket.timeout:
        logger.error(f"worker {args.name}: parent never connected")
        broker.stop(drain=False, timeout=5.0)
        return 1
    finally:
        lsock.close()
    stop_evt = threading.Event()
    _install_sigterm({"conn": conn}, stop_evt)
    hb_state = _HeartbeatState(args.name)
    logger.info(f"worker {args.name}: serving on {host}:{port}")
    result = _serve_conn(conn, broker, args.name,
                         args.heartbeat_interval_s, stop_evt, hb_state)
    return _finish(conn, broker, hb_state, result, args.name)


def _dial(args, epoch: Optional[int], prev_epoch: Optional[int]):
    """One registration attempt: connect, hello, await the verdict.
    Returns ``(conn, rfile, granted_epoch)``; raises ``ConnectionError``
    on transport trouble (retryable) and ``PermissionError`` on an
    explicit rejection (fatal: our epoch can only get staler)."""
    host, port = args.connect.rsplit(":", 1)
    conn = socket.create_connection((host, int(port)), timeout=10.0)
    try:
        conn.settimeout(_HELLO_TIMEOUT_S)
        # "class" is the only wire change for phase disaggregation: the
        # registry validates it and the pool routes by it
        hello = {"op": "hello", "magic": FLEET_MAGIC,
                 "version": PROTO_VERSION, "name": args.name,
                 "pid": os.getpid(), "class": args.replica_class}
        token = os.environ.get("DSTPU_FLEET_TOKEN")
        if token:
            hello["token"] = token
        if prev_epoch is not None:
            hello["prev_epoch"] = prev_epoch
        elif epoch is not None:
            hello["epoch"] = epoch
        send_frame(conn, hello)
        rfile = conn.makefile("rb")
        reply = recv_frame(rfile)
    except socket.timeout as e:
        conn.close()
        raise ConnectionError(f"hello timed out: {e}")
    except (ConnectionError, OSError):
        conn.close()
        raise
    if reply is None:
        conn.close()
        raise ConnectionError("registry closed during hello")
    ev = reply.get("ev")
    if ev == "hello_err":
        conn.close()
        raise PermissionError(reply.get("reason", "rejected"))
    if ev != "hello_ok":
        # neither verdict frame: a corrupted or foreign peer — as fatal
        # as a rejection (retrying cannot make it speak the protocol)
        conn.close()
        raise PermissionError(f"unexpected hello reply: {ev!r}")
    conn.settimeout(None)
    return conn, rfile, int(reply["epoch"])


def _run_connect(args, broker: RequestBroker) -> int:
    """Fleet transport: dial the registry, serve, reconnect on blips,
    exit for good on a stop op or a fencing rejection."""
    stop_evt = threading.Event()
    holder: dict = {"conn": None}
    _install_sigterm(holder, stop_evt)
    hb_state = _HeartbeatState(args.name)
    granted: Optional[int] = None  # last epoch the registry gave us
    sleep_s = _RECONNECT_BASE_S
    while not stop_evt.is_set():
        try:
            conn, rfile, granted = _dial(
                args, epoch=args.epoch if granted is None else None,
                prev_epoch=granted)
        except PermissionError as e:
            logger.error(f"worker {args.name}: registration rejected "
                         f"({e}) — exiting, not retrying")
            broker.stop(drain=False, timeout=5.0)
            return EXIT_FENCED
        except (ConnectionError, OSError) as e:
            sleep_s = decorrelated_jitter(_RECONNECT_BASE_S,
                                          _RECONNECT_CAP_S, sleep_s)
            logger.warning(f"worker {args.name}: registry unreachable "
                           f"({e!r}); retrying in {sleep_s:.2f}s")
            if stop_evt.wait(sleep_s):
                break
            continue
        sleep_s = _RECONNECT_BASE_S  # healthy connection: reset pacing
        holder["conn"] = conn
        logger.info(f"worker {args.name}: registered with {args.connect} "
                    f"(epoch {granted})")
        result = _serve_conn(conn, broker, args.name,
                             args.heartbeat_interval_s, stop_evt, hb_state,
                             rfile=rfile)
        holder["conn"] = None
        if result["exit"]:
            return _finish(conn, broker, hb_state, result, args.name)
        # connection dropped: keep the engine hot and dial back in — the
        # pool holds our lease open for lease_ttl_s
        try:
            conn.close()
        except OSError:
            pass
        logger.warning(f"worker {args.name}: connection to pool lost; "
                       f"reconnecting")
    broker.stop(drain=False, timeout=5.0)
    return 0


def main(argv: Optional[list] = None) -> int:
    from .server import add_engine_cli_args, add_serving_cli_args, \
        build_engine_factory

    p = argparse.ArgumentParser(
        prog="dstpu-worker",
        description="deepspeed_tpu_torch out-of-process replica worker")
    p.add_argument("--name", default="replica0.g0")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--connect", default=None, metavar="HOST:PORT",
                   help="dial in to a pool registry instead of listening "
                        "(multi-host fleet mode)")
    p.add_argument("--epoch", type=int, default=None,
                   help="fencing epoch for the first registration "
                        "(launcher-assigned; reconnects negotiate)")
    p.add_argument("--heartbeat_interval_s", type=float, default=0.25)
    p.add_argument("--replica_class", default="mixed",
                   choices=("prefill", "decode", "mixed"),
                   help="phase class for disaggregated routing")
    add_engine_cli_args(p)
    add_serving_cli_args(p)
    args = p.parse_args(argv)
    resolve_device(args.device)  # the card unless --device cpu

    # chaos: spawn-time crash site — BEFORE the engine builds, so a
    # crash-looping worker (persistent DSTPU_FAULTS) fails fast and the
    # supervisor's circuit breaker sees a tight loop, not compile waits
    faults.maybe_fail("serving.worker.start")
    recorder.install_crash_hook()  # injected hard-kills leave a dump

    scfg = ServingConfig(
        max_queue=args.max_queue,
        default_max_tokens=args.default_max_tokens,
        temperature=args.temperature,
        deadline_s=args.deadline_s,
        stop_token_ids=tuple(int(t) for t in args.stop_token_ids.split(","))
        if args.stop_token_ids else (),
        idle_wait_s=args.idle_wait_s,
        num_replicas=1,
        heartbeat_interval_s=args.heartbeat_interval_s,
        replica_class=args.replica_class,
        slo_classes=parse_slo_classes(args.slo_classes),
        default_slo_class=args.default_slo_class)
    logger.info(f"worker {args.name}: building engine (model={args.model})")
    from .server import build_adapter_factory, replica_state_subdir

    # Namespace durable state per replica: the launcher passes the RAW
    # roots on argv (unchanged across respawns) and each worker derives
    # its own subdir from --name.  Generations of the same replica
    # ("replica0.g0", "replica0.g1") map to the same subdir, so a
    # respawned worker finds its predecessor's cold store and can
    # rehydrate.  adapter_coldstore_dir is NOT rewritten here — the
    # adapter factory namespaces it internally (it also serves the
    # in-process path).
    for attr in ("kv_coldstore_dir", "kv_spill_dir", "adapter_spill_dir"):
        root = getattr(args, attr, "") or ""
        if root:
            setattr(args, attr, replica_state_subdir(root, args.name))

    engine = build_engine_factory(args)()
    rehydrated = engine.rehydrate_coldstore()
    if rehydrated.get("adopted") or rehydrated.get("skipped"):
        logger.info(f"worker {args.name}: cold-store rehydrate "
                    f"{rehydrated}")
    adapter_factory = build_adapter_factory(args)
    adapters = (adapter_factory(engine, args.name)
                if adapter_factory is not None else None)
    broker = RequestBroker(engine, scfg, name=args.name, adapters=adapters)
    broker.start()

    if args.connect:
        rc = _run_connect(args, broker)
        if rc == EXIT_FENCED:
            # a fenced zombie: its streams already failed over, so it
            # leaves at once — interpreter teardown could otherwise race
            # an engine thread still in device work and abort the exit
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(rc)
        return rc
    return _run_listen(args, broker)


if __name__ == "__main__":
    sys.exit(main())
