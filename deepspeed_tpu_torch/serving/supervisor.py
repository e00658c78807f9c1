"""Replica supervisor: detect dead / hung workers, respawn with backoff
(the port of ``deepspeed_tpu/serving/supervisor.py``).

The control loop over :class:`~deepspeed_tpu_torch.serving.transport.
FramedReplica` slots, structurally the serving-side sibling of the
elastic agent's generation loop (``elasticity/elastic_agent.py``): watch,
declare failure, restart, and stop restarting when restarts stop helping.

Detection hierarchy, cheapest signal first (each tick, per replica):

1. **socket EOF** — handled by the transport's reader thread the instant
   the worker dies; the supervisor only sees the aftermath (``down``).
2. **process exit** without EOF (shouldn't happen; belt and braces).
3. **missed beats** — no heartbeat for ``heartbeat_timeout_s``: the
   worker process is alive but its heartbeat thread is not (e.g. the
   ``serving.worker.hang`` chaos site), or the host is so wedged that
   nothing runs.  Either way the replica is useless: declare it down.
4. **hung replica** — beats still flowing but the engine loop has not
   stamped progress for ``hung_replica_timeout_s`` WHILE work is
   outstanding (``busy``): a stuck compile / wedged device
   (``serving.step`` hang site).  Idle replicas never trip this.
5. **dead broker** — the worker reports its own engine thread died
   (``broker_healthy`` false in the heartbeat): the process is fine but
   the replica can't serve; recycle it.

Network loss vs worker death (remote transport): a remote slot that
goes down for a *network* reason (``connection_lost``, heartbeat
timeout) keeps a **lease** for ``lease_ttl_s`` past its last heartbeat
— its streams already failed over, but the slot waits for the worker to
dial back in before anything is respawned.  Only lease expiry escalates
to the dead-worker path (counted once, ``lease_expiries``); and a slot
whose worker is launched externally (``can_respawn`` False) never
respawns at all — it just waits for re-registration.

Declaring down fails the in-flight streams with ``replica_dead`` → the
balancer resubmits on a surviving replica, skipping the delivered prefix
(token-identical under greedy decode).

Respawn policy: exponential backoff ``min(respawn_backoff_max_s,
respawn_backoff_s * 2**(fails-1))`` in the consecutive-failure count; a
worker that stays healthy ``respawn_reset_s`` clears its streak.  At
``circuit_breaker_threshold`` consecutive failures the slot's breaker
opens and it stops respawning — a persistently crashing worker (bad
model flags, poisoned host, persistent ``DSTPU_FAULTS``) must not burn
the fleet's capacity on spawn loops.  The pool keeps serving on the
survivors (graceful degradation); ``kv_utilization`` across healthy
replicas is the live-capacity signal.

Every transition lands in the tracer, the flight recorder, and the
``dstpu_serving_replica_*`` fleet counters.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence

from ..observability.recorder import recorder
from ..observability.trace import tracer
from ..utils.backoff import exponential_backoff
from ..utils.locks import named_lock
from ..utils.logging import logger
from .config import ServingConfig
from .metrics import ServingMetrics
from .transport import FramedReplica

#: down-reasons that may mean the NETWORK died, not the worker — a remote
#: slot holds its lease open on these and waits for re-registration
_NETWORK_LOSS = ("connection_lost", "heartbeat_timeout")


class ReplicaSupervisor:
    """Health-check + respawn loop over framed replica slots (subprocess
    and remote).  Membership is dynamic: the autoscaler adds and removes
    slots while the loop runs."""

    def __init__(self, replicas: Sequence[FramedReplica],
                 config: ServingConfig,
                 metrics: Optional[ServingMetrics] = None):
        self.replicas: List[FramedReplica] = list(replicas)
        self.cfg = config
        self.metrics = metrics
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._members_lock = named_lock("supervisor.members")

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "ReplicaSupervisor":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._run,
                                        name="dstpu-supervisor", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def add(self, r: FramedReplica) -> None:
        """Adopt a slot mid-flight (autoscaler scale-up)."""
        with self._members_lock:
            if r not in self.replicas:
                self.replicas = self.replicas + [r]

    def discard(self, r: FramedReplica) -> None:
        """Stop watching a slot (scale-down retire) — call BEFORE the
        drain so a crash mid-drain can't race a respawn."""
        with self._members_lock:
            self.replicas = [x for x in self.replicas if x is not r]

    def _run(self) -> None:
        while not self._stop.wait(self.cfg.supervise_interval_s):
            with self._members_lock:
                snapshot = list(self.replicas)
            for r in snapshot:
                try:
                    self._tick(r)
                except Exception as e:  # noqa: BLE001 — one bad slot must
                    # not stop supervision of the others
                    logger.error(f"supervisor: tick failed for {r.name}: "
                                 f"{e!r}")

    # -- per-replica state machine ---------------------------------------

    def _tick(self, r: FramedReplica) -> None:
        live = r.liveness()
        if live["stopping"]:
            return
        if live["down"] is None:
            self._check_health(r, live)
            return
        # down: before respawning, give a network-lossy remote slot its
        # lease — the worker may dial back in with its engine still hot
        lease = live.get("lease_remaining")
        if live["down"] in _NETWORK_LOSS and lease is not None:
            if lease > 0:
                return  # streams failed over already; wait out the lease
            if not r.lease_escalated:
                r.lease_escalated = True
                logger.warning(f"supervisor: {r.name} lease expired "
                               f"({live['down']}) — escalating to death")
                if self.metrics is not None:
                    self.metrics.record_fleet("lease_expiries")
                tracer.add_event("replica/lease_expired",
                                 attrs={"replica": r.name,
                                        "reason": live["down"]})
                recorder.record_event("replica/lease_expired",
                                      replica=r.name, reason=live["down"])
        if not getattr(r, "can_respawn", True):
            return  # externally-managed: only re-registration revives it
        self._maybe_respawn(r)

    def _check_health(self, r: FramedReplica, live: dict) -> None:
        if not live["connected"]:
            return  # still spawning; the connector enforces spawn_timeout_s
        if not live["alive"]:
            self._declare(r, "worker_exited", "worker_deaths")
        elif live["hb_age"] > self.cfg.heartbeat_timeout_s:
            self._declare(r, "heartbeat_timeout", "heartbeat_misses",
                          hb_age=round(live["hb_age"], 3))
        elif live["busy"] and \
                live["progress_age"] > self.cfg.hung_replica_timeout_s:
            self._declare(r, "hung_replica", "hung_detected",
                          progress_age=round(live["progress_age"], 3))
        elif not live["broker_healthy"]:
            self._declare(r, "broker_dead", "worker_deaths")
        elif r.consecutive_failures and \
                live["spawn_age"] > self.cfg.respawn_reset_s:
            logger.info(f"supervisor: {r.name} healthy for "
                        f"{live['spawn_age']:.1f}s — crash streak "
                        f"({r.consecutive_failures}) cleared")
            r.consecutive_failures = 0

    def _declare(self, r: FramedReplica, reason: str, counter: str,
                 **attrs) -> None:
        logger.warning(f"supervisor: declaring {r.name} gen {r.generation} "
                       f"down: {reason} {attrs or ''}")
        if self.metrics is not None:
            self.metrics.record_fleet(counter)
        tracer.add_event(f"replica/{reason}",
                         attrs={"replica": r.name,
                                "generation": r.generation, **attrs})
        recorder.record_event(f"replica/{reason}", replica=r.name,
                              generation=r.generation, **attrs)
        r.mark_down(reason)

    def _maybe_respawn(self, r: FramedReplica) -> None:
        if r.circuit_open:
            return
        now = time.monotonic()
        if r.next_respawn_at == 0.0:
            # fresh death: count it, then either open the breaker or
            # schedule the next generation
            r.consecutive_failures += 1
            if r.consecutive_failures >= self.cfg.circuit_breaker_threshold:
                r.circuit_open = True
                logger.error(
                    f"supervisor: circuit breaker OPEN for {r.name} after "
                    f"{r.consecutive_failures} consecutive failures — slot "
                    "retired; pool degrades to surviving replicas")
                if self.metrics is not None:
                    self.metrics.record_fleet("circuit_opens")
                tracer.add_event("replica/circuit_open",
                                 attrs={"replica": r.name,
                                        "failures": r.consecutive_failures})
                recorder.record_event("replica/circuit_open",
                                      replica=r.name,
                                      failures=r.consecutive_failures)
                return
            backoff = exponential_backoff(self.cfg.respawn_backoff_s,
                                          self.cfg.respawn_backoff_max_s,
                                          r.consecutive_failures)
            r.next_respawn_at = now + backoff
            logger.info(f"supervisor: respawning {r.name} in {backoff:.2f}s "
                        f"(failure #{r.consecutive_failures})")
            tracer.add_event("replica/respawn_scheduled",
                             attrs={"replica": r.name,
                                    "backoff_s": round(backoff, 3),
                                    "failures": r.consecutive_failures})
            return
        if now >= r.next_respawn_at:
            r.next_respawn_at = 0.0
            argv = getattr(r, "worker_argv", None) or ()
            if "--kv_coldstore_dir" in argv:
                # the new generation inherits its predecessor's cold-store
                # root on argv and rehydrates surviving warm state at boot
                logger.info(f"supervisor: respawning {r.name} with "
                            "crash-durable warm state (cold-store "
                            "rehydration)")
                tracer.add_event("replica/respawn_rehydrate",
                                 attrs={"replica": r.name,
                                        "generation": r.generation + 1})
            r.respawn()
