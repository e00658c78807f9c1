"""Goodput-driven autoscaler: grow and shrink the remote fleet (the port of
``deepspeed_tpu/serving/autoscaler.py``).

The serving-side sibling of the elastic agent's membership loop
(``elasticity/elastic_agent.py``): a single control thread samples fleet
**pressure** every ``autoscale_interval_s`` and converges the healthy
replica count into ``[autoscale_min, autoscale_max]``.

Pressure is ``(queued requests + outstanding generation tokens) /
healthy replicas`` — the per-replica backlog measured in the unit that
actually costs decode steps, not request count.  Decisions:

* **floor** — healthy count below ``autoscale_min`` → spawn immediately
  (no debounce: the floor is an availability promise, not an
  optimization).
* **scale up** — pressure above ``scale_up_pressure`` sustained for
  ``scale_up_debounce_s`` → spawn one slot, then cool down one debounce
  window before growing again (a cold worker pays a torch import, a CUDA
  context and drawing its weights before it absorbs load; spawning more
  during that window overshoots).
  At ``autoscale_max`` a hot fleet records ``autoscale_blocked`` once
  per hot episode instead.
* **scale down** — pressure below ``scale_down_pressure`` sustained for
  ``scale_down_idle_s`` and count above the floor → quiesce the
  highest-index replica, drain it (zero-drop), retire it.
* **ban** — ``autoscale_max_spawn_fails`` consecutive spawn failures
  bans growth (elastic-agent ban discipline for flapping hosts), with
  exponential backoff between strikes; one successful spawn clears the
  strikes.

Every decision lands in the tracer, the flight recorder, and the
``dstpu_serving_autoscale_{up,down,blocked}`` counters.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

from ..observability.recorder import recorder
from ..observability.trace import tracer
from ..utils.backoff import exponential_backoff
from ..utils.logging import logger
from .config import ServingConfig
from .metrics import ServingMetrics


class _ScaleGroup:
    """Per-class debounce state.  ``cls`` None means "every replica" —
    the single group of the pre-disaggregation autoscaler."""

    def __init__(self, cls: Optional[str], lo: int, hi: int):
        self.cls = cls
        self.min = lo
        self.max = hi
        self.hot_since: Optional[float] = None
        self.cold_since: Optional[float] = None
        self.blocked_noted = False
        self.cooldown_until = 0.0


class Autoscaler:
    """Control loop over a remote :class:`~deepspeed_tpu_torch.serving.balancer.
    ReplicaPool`: spawn via ``pool.spawn_remote_replica``, retire via
    ``pool.retire_replica``.

    With ``config.autoscale_class_bounds`` set, each listed replica class
    scales independently off the same pressure signal (class-filtered),
    within its own (min, max); replicas of unlisted classes share one
    residual group under the global ``autoscale_min``/``autoscale_max``.
    An empty table is the pre-disaggregation behaviour: one group, every
    replica, global bounds."""

    def __init__(self, pool, config: ServingConfig,
                 metrics: Optional[ServingMetrics] = None):
        self.pool = pool
        self.cfg = config
        self.metrics = metrics or pool.metrics
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # per-class (or single-group) debounce state
        if config.autoscale_class_bounds:
            self._groups = [
                _ScaleGroup(cls, lo, hi) for cls, (lo, hi)
                in sorted(config.autoscale_class_bounds.items())]
            self._groups.append(_ScaleGroup(
                None, config.autoscale_min, config.autoscale_max))
        else:
            self._groups = [_ScaleGroup(None, config.autoscale_min,
                                        config.autoscale_max)]
        # ban discipline (launcher-level: one ban covers every class)
        self._spawn_fails = 0
        self.banned = False
        #: decision mirror for quick assertions/bench reporting
        self.decisions = {"up": 0, "down": 0, "blocked": 0}

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "Autoscaler":
        if self._thread is not None:
            return self
        self.pool.autoscaler = self
        self._thread = threading.Thread(target=self._run,
                                        name="dstpu-autoscaler", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)
        self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.cfg.autoscale_interval_s):
            try:
                self._tick()
            except Exception as e:  # noqa: BLE001 — the control loop must
                # outlive any single bad decision
                logger.error(f"autoscaler: tick failed: {e!r}")

    # -- control law -----------------------------------------------------

    def _members(self, g: _ScaleGroup) -> List[int]:
        """Healthy replica indices this group governs."""
        healthy = self.pool.healthy_replicas()
        if g.cls is None:
            if len(self._groups) == 1:
                return healthy  # single group: everyone
            # residual group: classes without their own bounds entry
            bounded = set(self.cfg.autoscale_class_bounds)
            return [i for i in healthy
                    if self.pool.replicas[i].replica_class not in bounded]
        return [i for i in healthy
                if self.pool.replicas[i].replica_class == g.cls]

    def pressure(self, replica_class: Optional[str] = None) -> float:
        """Per-replica backlog (queued requests + outstanding generation
        tokens), optionally filtered to one replica class — the SAME
        signal, narrowed to the replicas that can absorb it."""
        if replica_class is None:
            reps = list(self.pool.replicas)
        else:
            reps = [self.pool.replicas[i]
                    for i in self.pool.replicas_of_class(replica_class)]
        n = sum(1 for t in reps if t.healthy())
        backlog = sum(t.queue_depth() + t.outstanding_tokens()
                      for t in reps)
        return backlog / max(1, n)

    def _group_pressure(self, members: List[int]) -> float:
        backlog = sum(self.pool.replicas[i].queue_depth() +
                      self.pool.replicas[i].outstanding_tokens()
                      for i in members)
        return backlog / max(1, len(members))

    def _tick(self) -> None:
        now = time.monotonic()
        for g in self._groups:
            self._tick_group(g, now)

    def _tick_group(self, g: _ScaleGroup, now: float) -> None:
        members = self._members(g)
        n = len(members)
        p = self._group_pressure(members)

        if g.cls is None and len(self._groups) > 1 and n == 0:
            # residual group with nothing deployed: a class-bounded fleet
            # that never launched a mixed replica must not have one
            # invented by the global floor
            return

        if n < g.min:
            # availability floor: restore immediately (no debounce)
            self._scale_up(g, now, n, p, reason="below_min")
            return

        if p > self.cfg.scale_up_pressure:
            g.cold_since = None
            if g.hot_since is None:
                g.hot_since = now
            if now - g.hot_since < self.cfg.scale_up_debounce_s:
                return
            if g.max and n >= g.max:
                if not g.blocked_noted:
                    g.blocked_noted = True
                    self._record("blocked", n=n, pressure=p,
                                 replica_class=g.cls or "all")
                return
            if self.banned or now < g.cooldown_until:
                return
            self._scale_up(g, now, n, p, reason="pressure")
            return

        g.hot_since = None
        g.blocked_noted = False

        if p < self.cfg.scale_down_pressure and n > g.min:
            if g.cold_since is None:
                g.cold_since = now
            if now - g.cold_since < self.cfg.scale_down_idle_s:
                return
            g.cold_since = None
            self._scale_down(g, members, n, p)
        else:
            g.cold_since = None

    def _scale_up(self, g: _ScaleGroup, now: float, n: int, p: float,
                  reason: str) -> None:
        if self.banned:
            return
        try:
            name = self.pool.spawn_remote_replica(
                replica_class=g.cls or "mixed")
        except Exception as e:  # noqa: BLE001 — spawn failure is a strike
            self._spawn_fails += 1
            backoff = exponential_backoff(self.cfg.autoscale_backoff_s,
                                          self.cfg.autoscale_backoff_max_s,
                                          self._spawn_fails)
            g.cooldown_until = now + backoff
            logger.warning(f"autoscaler: spawn failed ({e!r}), strike "
                           f"{self._spawn_fails}, backoff {backoff:.1f}s")
            if self._spawn_fails >= self.cfg.autoscale_max_spawn_fails:
                self.banned = True
                logger.error("autoscaler: BANNED from scaling up after "
                             f"{self._spawn_fails} consecutive spawn "
                             "failures")
                self._record("blocked", n=n, pressure=p, banned=True,
                             replica_class=g.cls or "all")
            return
        self._spawn_fails = 0
        g.hot_since = None
        g.cooldown_until = now + self.cfg.scale_up_debounce_s
        self._record("up", n=n, pressure=p, replica=name, reason=reason,
                     replica_class=g.cls or "all")

    def _scale_down(self, g: _ScaleGroup, members: List[int], n: int,
                    p: float) -> None:
        # retire the newest (highest-index) routable replica so the
        # stable core of the fleet keeps its warm engines
        victims = [self.pool.replicas[i].name for i in members
                   if self.pool.replicas[i].name not in self.pool._quiesced]
        if len(victims) <= g.min:
            return
        victim = victims[-1]
        if self.pool.retire_replica(victim, self.cfg.drain_timeout_s):
            self._record("down", n=n, pressure=p, replica=victim,
                         replica_class=g.cls or "all")

    def _record(self, decision: str, **attrs) -> None:
        self.decisions[decision] += 1
        self.metrics.record_autoscale(decision)
        logger.info(f"autoscaler: {decision} {attrs}")
        tracer.add_event(f"autoscale/{decision}", attrs=attrs)
        recorder.record_event(f"autoscale/{decision}", **attrs)
