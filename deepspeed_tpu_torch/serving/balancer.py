"""Replica load balancer: MII-style deployment over N replicas (the port
of ``deepspeed_tpu/serving/balancer.py``).

Capability analogue of DeepSpeed-MII's ``LoadBalancer`` process
(``mii/grpc_related/``: a front that round-robins REST/gRPC requests over
replica processes).  The pool routes over :class:`~deepspeed_tpu_torch.serving.
transport.ReplicaTransport` objects and never touches an engine directly,
so the same routing and failover drive both deployments:

* ``inprocess`` — :class:`~deepspeed_tpu_torch.serving.broker.RequestBroker`
  engine threads sharing one parameter tree: the engines only read the
  weight tensors, so one card serves N independent continuous-batching
  engines without N copies of the weights (``server.build_engine_factory``
  draws them once, on the engine's device and in its dtype).
* ``subprocess`` — out-of-process workers (their own CUDA contexts) behind
  :class:`~deepspeed_tpu_torch.serving.transport.SubprocessReplica`, watched by
  the :class:`~deepspeed_tpu_torch.serving.supervisor.ReplicaSupervisor` — this
  matches the reference architecture (MII fronts replica *processes*) and
  buys fault isolation: a replica crash/hang costs one worker, never the
  front.

Routing is **least-outstanding-tokens** (queued prompt tokens + undelivered
generation budget), a closer proxy for engine load than request count when
lengths are mixed.  A replica that dies mid-request fails its streams with
``replica_dead``; the pool transparently resubmits on a surviving replica
with decorrelated-jitter backoff, replaying the (deterministic, greedy)
prefix and skipping the tokens the client already received.
"""

from __future__ import annotations

import threading
import time
from typing import (Callable, Dict, FrozenSet, Iterator, List, Optional,
                    Sequence, Set, Tuple)

from ..inference.v2.prefix_cache import prefix_digests
from ..monitor.monitor import Monitor
from ..observability.recorder import recorder
from ..observability.trace import tracer
from ..utils.backoff import decorrelated_jitter
from ..utils.locks import named_lock
from ..utils.logging import logger, request_logger
from .broker import (BrokerStoppedError, QueueFullError, RequestBroker,
                     RequestFailedError)
from .config import ServingConfig
from .metrics import ServingMetrics
from .transport import (FramedReplica, InProcessReplica, ReplicaTransport,
                        SubprocessReplica)


class NoReplicaError(RuntimeError):
    """No healthy replica available — surface as HTTP 503."""


_RETRYABLE = ("replica_dead", "engine_error", "shutdown")


def _slot_class(config: ServingConfig, i: int) -> str:
    """Per-slot replica class from ``config.replica_classes`` (index-
    aligned with the slot number; slots past the tuple are "mixed")."""
    if i < len(config.replica_classes):
        return config.replica_classes[i]
    return "mixed"


class BalancedHandle:
    """A request handle that survives replica death: wraps the current
    replica's handle and, on a retryable failure, resubmits to another
    healthy replica, skipping already-delivered tokens (greedy decode
    replays deterministically; with temperature > 0 the retried suffix is
    a fresh sample)."""

    def __init__(self, pool: "ReplicaPool", handle, replica_index: int,
                 submit_kwargs: dict):
        self._pool = pool
        self._handle = handle
        self.replica_index = replica_index
        self._kwargs = submit_kwargs
        self._delivered = 0
        self._cancelled = False
        self._past_versions: Set[Tuple[int, int]] = set()

    @property
    def rid(self) -> str:
        return self._handle.rid

    @property
    def weight_versions(self) -> Optional[FrozenSet[Tuple[int, int]]]:
        """``(replica index, params_version)`` of every engine step that
        gave this request tokens, across failovers; ``None`` where the
        transport does not report versions (port only)."""
        cur = getattr(self._handle, "weight_versions", None)
        if cur is None:
            return None
        return frozenset(self._past_versions
                         | {(self.replica_index, v) for v in cur})

    @property
    def finish_reason(self) -> Optional[str]:
        return self._handle.finish_reason

    @property
    def prompt(self) -> List[int]:
        return self._handle.prompt

    def cancel(self) -> None:
        self._cancelled = True
        self._handle.cancel()

    def _backoff(self, prev: float) -> float:
        """Decorrelated-jitter failover backoff: ``min(cap, uniform(base,
        3 * prev))``.  When a replica dies, every stream it carried fails
        over at once — jitter de-synchronizes the stampede onto the
        survivors, and the cap bounds worst-case added latency."""
        cfg = self._pool.cfg
        return decorrelated_jitter(cfg.retry_backoff_s,
                                   cfg.retry_backoff_max_s, prev)

    def tokens(self, timeout: Optional[float] = None) -> Iterator[int]:
        attempts = 0
        sleep_s = self._pool.cfg.retry_backoff_s
        while True:
            seen_this_handle = 0
            try:
                for tok in self._handle.tokens(timeout=timeout):
                    seen_this_handle += 1
                    if seen_this_handle <= self._delivered:
                        continue  # replayed prefix after a retry
                    self._delivered += 1
                    yield tok
                return
            except RequestFailedError as e:
                if (self._cancelled or e.reason not in _RETRYABLE
                        or attempts >= self._pool.cfg.retry_limit):
                    if e.reason in _RETRYABLE:  # gave up: now it's a failure
                        self._pool.metrics.record_finish("error")
                    raise
                attempts += 1
                sleep_s = self._backoff(sleep_s)
                time.sleep(sleep_s)
                request_logger(self._handle.rid).warning(
                    f"serving: retrying after {e.reason} "
                    f"(attempt {attempts}, backoff {sleep_s * 1e3:.0f}ms)")
                trace_id = self._kwargs.get("trace_id") or self._handle.rid
                tracer.add_event("request/failover",
                                 trace_id=trace_id,
                                 attrs={"reason": e.reason,
                                        "attempt": attempts,
                                        "rid": self._handle.rid,
                                        "from_replica": self.replica_index})
                recorder.record_event("request/failover",
                                      rid=self._handle.rid,
                                      trace_id=trace_id, reason=e.reason,
                                      attempt=attempts,
                                      from_replica=self.replica_index)
                self._past_versions = set(self.weight_versions or ())
                self._handle, self.replica_index = \
                    self._pool._resubmit(self._kwargs)

    def result(self, timeout: Optional[float] = None) -> List[int]:
        return list(self.tokens(timeout=timeout))


class ReplicaPool:
    """Owns the replica transports, routes requests, pumps metrics/health,
    and (for subprocess replicas) runs the supervisor."""

    def __init__(self, replicas: Sequence, config: ServingConfig,
                 metrics: Optional[ServingMetrics] = None,
                 monitor: Optional[Monitor] = None):
        if not replicas:
            raise ValueError("need at least one replica")
        # bare brokers (pre-transport callers, tests) get wrapped in place
        self.replicas: List[ReplicaTransport] = [
            InProcessReplica(r) if isinstance(r, RequestBroker) else r
            for r in replicas]
        self.cfg = config
        self.metrics = metrics or ServingMetrics()
        self.monitor = monitor
        self._accepting = False
        self._rr = 0  # round-robin tiebreak cursor
        self._lock = named_lock("pool.state")
        self._pump: Optional[threading.Thread] = None
        self._pump_stop = threading.Event()
        self._emit_step = 0
        # last-known per-replica health entries: the health endpoint must
        # answer (with a stale flag) even when a replica can't
        self._last_health: Dict[int, dict] = {}
        # fleet plumbing (remote transport): set by build_remote
        self.registry = None
        self.autoscaler = None
        self._launcher = None
        #: replicas excluded from routing (rollout drains, scale-down) —
        #: they stay healthy and finish their in-flight work
        self._quiesced: set = set()
        #: monotonically-increasing suffix for autoscaler-minted slot
        #: names; never reused so traces/metrics stay unambiguous
        self._slot_seq = len(self.replicas)
        # per-slot phase classes (Splitwise/DistServe disaggregation):
        # pool-side assignment; a dial-in worker's declared class wins
        for i, t in enumerate(self.replicas):
            cls = _slot_class(config, i)
            if cls != "mixed":
                t.replica_class = cls
        #: routing-decision ledger: requests routed per phase, plus how
        #: often cache-aware routing found a replica with a warm prefix
        self.route_stats: Dict[str, int] = {
            "prefill": 0, "decode": 0, "cache_hits": 0, "adapter_hits": 0}
        self.supervisor = None
        if any(isinstance(t, FramedReplica) for t in self.replicas):
            from .supervisor import ReplicaSupervisor

            self.supervisor = ReplicaSupervisor(
                [t for t in self.replicas
                 if isinstance(t, FramedReplica)],
                config, metrics=self.metrics)

    @classmethod
    def build(cls, engine_factory: Callable[[], "object"],
              config: ServingConfig,
              metrics: Optional[ServingMetrics] = None,
              monitor: Optional[Monitor] = None,
              adapter_factory: Optional[Callable] = None) -> "ReplicaPool":
        """In-process pool: ``config.num_replicas`` brokers from an engine
        factory (each call must return a FRESH InferenceEngineV2 over
        shared params).  ``adapter_factory(engine, name)`` builds each
        replica's :class:`~deepspeed_tpu_torch.serving.adapters.AdapterRegistry`
        (None = the deployment serves no adapters)."""
        metrics = metrics or ServingMetrics()
        brokers = []
        for i in range(config.num_replicas):
            engine = engine_factory()
            adapters = (adapter_factory(engine, f"replica{i}")
                        if adapter_factory is not None else None)
            brokers.append(RequestBroker(engine, config, metrics=metrics,
                                         name=f"replica{i}",
                                         own_gauges=False, adapters=adapters))
        return cls(brokers, config, metrics=metrics, monitor=monitor)

    @classmethod
    def build_subprocess(cls, worker_argv: Sequence[str],
                         config: ServingConfig,
                         metrics: Optional[ServingMetrics] = None,
                         monitor: Optional[Monitor] = None,
                         extra_env: Optional[Dict[str, str]] = None,
                         ) -> "ReplicaPool":
        """Fault-isolated pool: ``config.num_replicas`` worker processes
        (``python -m deepspeed_tpu_torch.serving.worker <worker_argv>``), each
        with its own engine and CUDA context, under supervision.
        ``extra_env`` is merged into every worker's environment on each
        (re)spawn — chaos tests arm persistent ``DSTPU_FAULTS`` there."""
        metrics = metrics or ServingMetrics()
        # per-slot --replica_class rides the worker argv (appended last,
        # so it wins over any class already present in worker_argv)
        transports = [SubprocessReplica(
            list(worker_argv) + ["--replica_class", _slot_class(config, i)],
            config, name=f"replica{i}", metrics=metrics, extra_env=extra_env)
            for i in range(config.num_replicas)]
        return cls(transports, config, metrics=metrics, monitor=monitor)

    @classmethod
    def build_remote(cls, worker_argv: Sequence[str],
                     config: ServingConfig,
                     metrics: Optional[ServingMetrics] = None,
                     monitor: Optional[Monitor] = None,
                     extra_env: Optional[Dict[str, str]] = None,
                     launch_workers: bool = True) -> "ReplicaPool":
        """Multi-host fleet: ``config.num_replicas`` registry slots that
        workers claim by dialing in over TCP with fenced epochs
        (``serving/remote.py``).  With ``launch_workers`` the pool also
        spawns local worker processes pointed at its own registry (the
        single-host deployment and the test harness); with it off the
        slots wait for externally-launched workers and never respawn."""
        from .remote import (LocalWorkerLauncher, RemoteReplica,
                             WorkerRegistry)
        metrics = metrics or ServingMetrics()
        registry = WorkerRegistry(config, metrics)
        launcher = (LocalWorkerLauncher(worker_argv, config, extra_env)
                    if launch_workers else None)
        slots = [RemoteReplica(config, f"replica{i}", metrics, launcher,
                               replica_class=_slot_class(config, i))
                 for i in range(config.num_replicas)]
        for s in slots:
            registry.register_slot(s)
        pool = cls(slots, config, metrics=metrics, monitor=monitor)
        pool.registry = registry
        pool._launcher = launcher
        return pool

    # -- lifecycle -------------------------------------------------------

    def start(self, paused: bool = False) -> "ReplicaPool":
        """Start accepting; ``paused=True`` accepts (and queues) requests
        without starting the engine threads — deterministic backpressure in
        tests; call ``start_engines()`` to begin serving them."""
        self._accepting = True
        if not paused:
            self.start_engines()
        self._pump_stop.clear()
        self._pump = threading.Thread(target=self._pump_loop,
                                      name="dstpu-serving-metrics",
                                      daemon=True)
        self._pump.start()
        return self

    def start_engines(self) -> None:
        if self.registry is not None:  # listen before workers dial in
            self.registry.start()
        for t in self.replicas:
            t.start()
        if self.supervisor is not None:
            self.supervisor.start()

    def wait_ready(self, timeout: Optional[float] = None,
                   min_replicas: int = 1) -> int:
        """Block until every replica is healthy (or ``timeout``); returns
        the healthy count.  Subprocess workers pay torch import + engine
        build after ``start()`` — the HTTP front waits here before
        printing its ready line.  Raises :class:`NoReplicaError` when
        fewer than ``min_replicas`` came up."""
        timeout = self.cfg.spawn_timeout_s if timeout is None else timeout
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            n = len(self.healthy_replicas())
            if n >= len(self.replicas):
                return n
            # slots retired by the circuit breaker will never come up:
            # don't wait for them (degraded but serving)
            retired = sum(1 for t in self.replicas
                          if getattr(t, "circuit_open", False))
            if retired and n >= max(min_replicas,
                                    len(self.replicas) - retired):
                return n
            time.sleep(0.02)
        n = len(self.healthy_replicas())
        if n < min_replicas:
            raise NoReplicaError(
                f"only {n}/{len(self.replicas)} replicas ready "
                f"after {timeout:.0f}s")
        return n

    def healthy_replicas(self) -> List[int]:
        return [i for i, t in enumerate(self.replicas) if t.healthy()]

    def kill_replica(self, index: int, reason: str = "replica_dead") -> None:
        self.replicas[index].kill(reason)

    # -- elastic membership (autoscaler, rolling swaps) ------------------

    def quiesce(self, name: str) -> None:
        """Exclude ``name`` from routing; in-flight work keeps running."""
        with self._lock:
            self._quiesced.add(name)

    def resume_replica(self, name: str) -> None:
        with self._lock:
            self._quiesced.discard(name)

    def _by_name(self, name: str) -> Optional[ReplicaTransport]:
        for t in self.replicas:
            if t.name == name:
                return t
        return None

    def wait_drained(self, name: str, timeout: float) -> bool:
        """Wait for a (quiesced) replica's in-flight work to finish.
        True when it drained OR stopped being healthy (nothing left to
        wait for — its streams already failed over); False on timeout."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            t = self._by_name(name)
            if t is None or not t.healthy():
                return True
            try:
                if (t.num_running() == 0 and t.queue_depth() == 0
                        and t.outstanding_tokens() == 0):
                    return True
            except Exception:  # noqa: BLE001 — dying mid-poll == drained
                return True
            time.sleep(0.05)
        return False

    def add_replica(self, transport: ReplicaTransport) -> None:
        """Adopt and start a new replica slot mid-flight (scale-up)."""
        with self._lock:
            if any(t.name == transport.name for t in self.replicas):
                raise ValueError(f"duplicate replica name {transport.name}")
            # the pump/health threads iterate without the lock: publish a
            # NEW list instead of mutating the one they may be walking
            self.replicas = self.replicas + [transport]
        if self.supervisor is not None and \
                isinstance(transport, FramedReplica):
            self.supervisor.add(transport)
        transport.start()

    def remove_replica(self, name: str) -> bool:
        """Drop a slot from the pool and stop it.  Idempotent; returns
        True only for the call that actually removed it — a simultaneous
        scale-down and crash-cleanup can both call this, and exactly one
        of them owns releasing the slot."""
        with self._lock:
            t = self._by_name(name)
            if t is None:
                return False
            self.replicas = [x for x in self.replicas if x is not t]
            self._quiesced.discard(name)
            self._last_health = {}  # indices shifted; drop stale cache
        if self.supervisor is not None and isinstance(t, FramedReplica):
            self.supervisor.discard(t)
        if self.registry is not None:
            try:
                self.registry.unregister_slot(name)
            except Exception as e:  # noqa: BLE001
                logger.warning(f"serving: unregister {name} failed: {e!r}")
        try:
            t.stop(drain=False, timeout=5.0)
        except Exception as e:  # noqa: BLE001
            logger.warning(f"serving: stop of removed {name} failed: {e!r}")
        return True

    def retire_replica(self, name: str, drain_timeout_s: float) -> bool:
        """Graceful scale-down: stop routing to ``name``, let its work
        finish, then remove it.  The supervisor is detached FIRST so a
        crash mid-drain can't race a respawn against the removal."""
        t = self._by_name(name)
        if t is None:
            return False
        self.quiesce(name)
        if self.supervisor is not None and isinstance(t, FramedReplica):
            self.supervisor.discard(t)
        self.wait_drained(name, drain_timeout_s)
        return self.remove_replica(name)

    def spawn_remote_replica(self, name: Optional[str] = None,
                             replica_class: str = "mixed") -> str:
        """Mint, register, and start a fresh remote slot (scale-up);
        ``replica_class`` rides the launcher argv so the worker dials in
        already wearing its phase class."""
        if self.registry is None:
            raise RuntimeError("spawn_remote_replica needs a remote pool")
        from .remote import RemoteReplica
        with self._lock:
            if name is None:
                name = f"replica{self._slot_seq}"
            self._slot_seq += 1
        slot = RemoteReplica(self.cfg, name, self.metrics, self._launcher,
                             replica_class=replica_class)
        self.registry.register_slot(slot)
        try:
            self.add_replica(slot)
        except Exception:
            self.registry.unregister_slot(name)
            raise
        return name

    def replicas_of_class(self, replica_class: str) -> List[int]:
        """Indices of replicas wearing ``replica_class`` (autoscaler's
        per-class census; "mixed" replicas count only as "mixed")."""
        return [i for i, t in enumerate(self.replicas)
                if t.replica_class == replica_class]

    def handoff_prefix(self, src_name: str, dst_name: str,
                       tokens: Sequence[int]) -> int:
        """Move the cached KV blocks covering ``tokens`` from one
        replica's radix tree to another's — the prefix-subtree unit of
        transfer for prefill→decode handoff.  Serialized through the
        blocked-KV safetensors payload (``engine.export_prefix`` /
        ``import_prefix``), so the bytes are exactly what the io layer
        would put on disk.  Both replicas must expose an engine
        (in-process transports) and should be idle or quiesced — the
        engine is single-threaded by its broker.  Returns tokens now
        cached on the destination (0 when nothing was cached)."""
        src, dst = self._by_name(src_name), self._by_name(dst_name)
        if src is None or dst is None:
            raise ValueError(f"unknown replica {src_name!r} or {dst_name!r}")
        src_eng = getattr(src, "engine", None)
        dst_eng = getattr(dst, "engine", None)
        if src_eng is None or dst_eng is None:
            raise RuntimeError(
                "prefix handoff needs engine access (in-process replicas); "
                "remote workers exchange prefixes via their own hand-off op")
        payload = src_eng.export_prefix(list(tokens))
        if payload is None:
            return 0
        covered = dst_eng.import_prefix(payload)
        tracer.add_event("replica/prefix_handoff",
                         attrs={"src": src_name, "dst": dst_name,
                                "tokens": covered,
                                "payload_bytes": len(payload)})
        recorder.record_event("replica/prefix_handoff", src=src_name,
                              dst=dst_name, tokens=covered)
        return covered

    def drain(self, timeout: Optional[float] = None) -> None:
        """Graceful shutdown: stop accepting, let outstanding requests
        finish inside the grace window, then stop the replicas."""
        self._accepting = False
        if self.autoscaler is not None:  # no scaling during teardown
            self.autoscaler.stop()
        if self.supervisor is not None:  # no respawns during teardown
            self.supervisor.stop()
        timeout = self.cfg.drain_timeout_s if timeout is None else timeout
        deadline = time.monotonic() + timeout
        for t in self.replicas:
            try:
                t.stop(drain=True,
                       timeout=max(0.0, deadline - time.monotonic()))
            except Exception as e:  # noqa: BLE001 — a dead replica must
                # not block draining the healthy ones
                logger.warning(f"serving drain: {t.name} stop failed: {e!r}")
        if self.registry is not None:
            self.registry.stop()
        self._stop_pump()

    def shutdown(self) -> None:
        """Immediate shutdown: outstanding requests fail with ``shutdown``."""
        self._accepting = False
        if self.autoscaler is not None:
            self.autoscaler.stop()
        if self.supervisor is not None:
            self.supervisor.stop()
        for t in self.replicas:
            try:
                t.stop(drain=False, timeout=10.0)
            except Exception as e:  # noqa: BLE001
                logger.warning(f"serving shutdown: {t.name} stop failed: "
                               f"{e!r}")
        if self.registry is not None:
            self.registry.stop()
        self._stop_pump()

    def _stop_pump(self) -> None:
        self._pump_stop.set()
        if self._pump is not None:
            self._pump.join(timeout=5.0)
            self._pump = None
        if self.monitor is not None:
            try:
                self.monitor.close()
            except Exception as e:  # pragma: no cover
                logger.warning(f"serving monitor close failed: {e!r}")

    # -- routing ---------------------------------------------------------

    def _request_phase(self, prompt_len: int,
                       max_new_tokens: Optional[int]) -> str:
        """Classify a REQUEST by its dominant phase: prompt-heavy work
        belongs on "prefill"-class replicas, generation-heavy on "decode".
        The request runs to completion wherever it lands — the class is a
        routing preference, not a migration."""
        mnt = max_new_tokens if max_new_tokens else self.cfg.default_max_tokens
        if prompt_len >= self.cfg.phase_prefill_ratio * max(1, mnt):
            return "prefill"
        return "decode"

    def _digest_overlap(self, i: int, prompt: Sequence[int]) -> int:
        """Leading radix-tree blocks of ``prompt`` that replica ``i``
        already holds, by digest comparison against its heartbeated
        summary (never raises; an unreachable replica scores 0)."""
        try:
            s = self.replicas[i].prefix_summary()
        except Exception:  # noqa: BLE001 — routing must not die with a replica
            return 0
        digs = s.get("digests")
        bs = int(s.get("block_size", 0) or 0)
        if not digs or bs <= 0:
            return 0
        have = frozenset(digs)
        n = 0
        for d in prefix_digests(prompt, bs, max_chunks=64):
            if d not in have:
                break
            n += 1
        return n

    def _adapter_score(self, i: int, adapter: str) -> int:
        """Adapter-residency score of replica ``i`` for ``adapter`` from
        its heartbeated registry summary: device-resident (2) beats
        registered-but-paged-out (1) beats unknown (0).  Never raises —
        an unreachable replica scores 0."""
        try:
            s = self.replicas[i].adapter_summary()
        except Exception:  # noqa: BLE001 — routing must not die with a replica
            return 0
        if adapter in (s.get("resident") or ()):
            return 2
        if adapter in (s.get("registered") or ()):
            return 1
        return 0

    def _pick(self, exclude: Sequence[int] = (),
              phase: Optional[str] = None,
              prompt: Optional[Sequence[int]] = None,
              adapter: Optional[str] = None) -> int:
        healthy = [i for i in self.healthy_replicas()
                   if i not in exclude
                   and self.replicas[i].name not in self._quiesced]
        if not healthy:
            raise NoReplicaError("no healthy replica")
        cache_hit = False
        adapter_hit = False
        if phase is not None:
            # prefer the exact class, then "mixed"; an all-wrong-class
            # pool still serves (degraded placement beats a 503)
            exact = [i for i in healthy
                     if self.replicas[i].replica_class == phase]
            compat = exact or [i for i in healthy
                               if self.replicas[i].replica_class == "mixed"]
            healthy = compat or healthy
        if adapter is not None and len(healthy) > 1:
            # adapter-aware: a replica with the adapter device-resident
            # skips the promote entirely; one that at least knows it skips
            # the checkpoint load.  Applied before prefix overlap — a slot
            # re-load costs more than a prefill replay.
            scores = {i: self._adapter_score(i, adapter) for i in healthy}
            best = max(scores.values())
            if best > 0:
                healthy = [i for i in healthy if scores[i] == best]
                adapter_hit = best == 2
        if prompt is not None and self.cfg.cache_aware_routing \
                and len(healthy) > 1:
            # cache-aware: the replica whose radix tree already holds the
            # longest leading prefix wins outright; load only tiebreaks
            scores = {i: self._digest_overlap(i, prompt) for i in healthy}
            best = max(scores.values())
            if best > 0:
                healthy = [i for i in healthy if scores[i] == best]
                cache_hit = True
        with self._lock:
            self._rr += 1
            rr = self._rr
            if phase is not None:
                self.route_stats[phase] = self.route_stats.get(phase, 0) + 1
            if cache_hit:
                self.route_stats["cache_hits"] += 1
            if adapter_hit:
                self.route_stats["adapter_hits"] += 1
        # least outstanding tokens; stable round-robin among ties
        return min(healthy,
                   key=lambda i: (self.replicas[i].outstanding_tokens(),
                                  (i - rr) % len(self.replicas)))

    def submit(self, prompt: Sequence[int], **kwargs) -> BalancedHandle:
        if not self._accepting:
            raise NoReplicaError("pool not accepting (draining/stopped)")
        kwargs = dict(kwargs, prompt=list(prompt))
        handle, idx = self._resubmit(kwargs, fresh=True)
        # pin the trace identity to the first placement's rid: a failover
        # resubmit mints a new rid on the new replica but keeps this
        # trace_id, so the stitched /debug/trace shows one continuous
        # request timeline across both workers
        kwargs.setdefault("trace_id", handle.rid)
        return BalancedHandle(self, handle, idx, kwargs)

    def _resubmit(self, kwargs: dict, fresh: bool = False):
        """Place (or re-place after replica death) a request; tries every
        healthy replica before giving up. Queue-full only counts as
        backpressure when EVERY healthy replica's queue is full.

        A FRESH submit with no healthy replica fails fast (503
        backpressure); a failover resubmit waits up to ``failover_wait_s``
        for the supervisor to respawn one — the in-flight stream rides out
        a total-outage window instead of dying with its last replica."""
        deadline = (None if fresh
                    else time.monotonic() + self.cfg.failover_wait_s)
        tried: List[int] = []
        last: Optional[Exception] = None
        prompt = kwargs.get("prompt") or []
        phase = self._request_phase(len(prompt),
                                    kwargs.get("max_new_tokens"))
        while True:
            try:
                idx = self._pick(exclude=tried, phase=phase, prompt=prompt,
                                 adapter=kwargs.get("adapter"))
            except NoReplicaError:
                if isinstance(last, QueueFullError):
                    raise last
                if (deadline is not None and self._accepting
                        and time.monotonic() < deadline):
                    # a respawned generation gets a clean retry slate
                    tried, last = [], None
                    time.sleep(0.1)
                    continue
                raise
            tried.append(idx)
            try:
                return self.replicas[idx].submit(**kwargs), idx
            except (QueueFullError, BrokerStoppedError) as e:
                last = e

    # -- observability ---------------------------------------------------

    def queue_depth(self) -> int:
        return sum(t.queue_depth() for t in self.replicas)

    def _replica_health(self, i: int, t: ReplicaTransport) -> dict:
        """One replica's health entry; never raises.  A replica that can't
        answer (dead engine, unreachable worker) gets its last-known entry
        back with ``stale: true`` — the endpoint's contract is to always
        describe the whole fleet."""
        try:
            entry = {
                "index": i, "name": t.name, "healthy": t.healthy(),
                "replica_class": t.replica_class,
                "queue_depth": t.queue_depth(),
                "outstanding_tokens": t.outstanding_tokens(),
                "running": t.num_running(),
                "kv_utilization": round(t.kv_utilization(), 4),
                "prefix": t.prefix_stats(),
                "spec": t.spec_stats(),
                "adapters": t.adapter_stats(),
                "stale": False,
            }
            entry.update(t.describe())
            self._last_health[i] = entry
            return entry
        except Exception as e:  # noqa: BLE001 — dead replicas still report
            prev = dict(self._last_health.get(i, {"index": i,
                                                  "name": t.name}))
            prev.update({"healthy": False, "stale": True,
                         "error": repr(e)})
            return prev

    def health(self) -> dict:
        reps = [self._replica_health(i, t)
                for i, t in enumerate(self.replicas)]
        healthy = [r for r in reps if r.get("healthy")]
        kv = [r.get("kv_utilization", 0.0) for r in healthy]
        return {"status": "ok" if healthy else "down",
                "accepting": self._accepting,
                "healthy_replicas": len(healthy),
                "num_replicas": len(self.replicas),
                # live capacity signal for graceful degradation: mean KV
                # pressure across the replicas actually taking traffic
                "kv_utilization": round(sum(kv) / len(kv), 4) if kv else 0.0,
                "route_stats": dict(self.route_stats),
                "replicas": reps}

    def _aggregate_prefix_stats(self) -> Dict[str, float]:
        """Sum engine prefix-cache stats over replicas; hit_rate is
        recomputed from the pooled counts."""
        agg: Dict[str, float] = {}
        for t in self.replicas:
            for k, v in t.prefix_stats().items():
                agg[k] = agg.get(k, 0.0) + v
        agg["enabled"] = float(bool(agg.get("enabled")))
        lookups = agg.get("lookups", 0.0)
        agg["hit_rate"] = agg.get("hits", 0.0) / lookups if lookups else 0.0
        return agg

    def _aggregate_spec_stats(self) -> Dict[str, float]:
        """Sum engine speculative-decoding stats over replicas;
        acceptance_rate is recomputed from the pooled token counts and ``k``
        is reported once (replicas share one config), not summed."""
        agg: Dict[str, float] = {}
        for t in self.replicas:
            for k, v in t.spec_stats().items():
                agg[k] = agg.get(k, 0.0) + v
        agg["enabled"] = float(bool(agg.get("enabled")))
        if self.replicas:
            agg["k"] = self.replicas[0].spec_stats().get("k", 0)
        proposed = agg.get("proposed_tokens", 0.0)
        agg["acceptance_rate"] = (agg.get("accepted_tokens", 0.0) / proposed
                                  if proposed else 0.0)
        return agg

    def _aggregate_adapter_stats(self) -> Dict[str, float]:
        """Sum adapter-registry stats over replicas; ``promote_wait_ms``
        (a p95, not a count) is reported as the fleet max, the honest
        tail for a latency gauge."""
        agg: Dict[str, float] = {}
        waits: List[float] = []
        for t in self.replicas:
            for k, v in t.adapter_stats().items():
                if k == "promote_wait_ms":
                    waits.append(float(v))
                else:
                    agg[k] = agg.get(k, 0.0) + v
        agg["promote_wait_ms"] = max(waits) if waits else 0.0
        return agg

    def _update_gauges(self) -> None:
        running = sum(t.num_running() for t in self.replicas)
        kv = [t.kv_utilization() for t in self.replicas if t.healthy()]
        self.metrics.set_gauges(self.queue_depth(), running,
                                sum(kv) / len(kv) if kv else 0.0)
        self.metrics.set_prefix_stats(self._aggregate_prefix_stats())
        self.metrics.set_spec_stats(self._aggregate_spec_stats())
        self.metrics.set_adapter_stats(self._aggregate_adapter_stats())
        # a dead replica's stats accessors return last-known (frozen)
        # values: mark its gauge series stale so dashboards can tell
        # frozen-but-reported from live
        self.metrics.set_replica_stats([
            {"name": t.name, "healthy": float(t.healthy()),
             "queue_depth": float(t.queue_depth()),
             "running": float(t.num_running()),
             "outstanding_tokens": float(t.outstanding_tokens()),
             "kv_utilization": t.kv_utilization(),
             "stale": not t.healthy()}
            for t in self.replicas])
        if self.registry is not None:
            self.metrics.set_registry_members(self.registry.membership())

    def _pump_loop(self) -> None:
        while not self._pump_stop.wait(self.cfg.metrics_interval_s):
            try:
                self._update_gauges()
            except Exception as e:  # a dying replica must not kill the pump
                logger.warning(f"serving gauge update failed: {e!r}")
            self._emit_step += 1
            try:
                self.metrics.emit_to(self.monitor, self._emit_step)
            except Exception as e:  # sink failure must not kill serving
                logger.warning(f"serving metrics emit failed: {e!r}")
