"""Serving metrics: TTFT, TPOT, queue depth, KV utilization, goodput (the
port of ``deepspeed_tpu/serving/metrics.py``).

Counters and latency reservoirs shared by every replica's broker (one
instance per deployment, thread-safe), surfaced three ways:

* ``to_events(step)`` — ``monitor.Event`` tuples for the CSV / TensorBoard /
  wandb sinks (``deepspeed_tpu/monitor/monitor.py``), same pipeline the
  training engine uses;
* ``to_prometheus()`` — full text exposition for the HTTP ``/metrics``
  endpoint (``observability/prometheus.py``: ``# HELP``/``# TYPE``
  metadata, native histograms for TTFT/TPOT/queue-wait, per-replica
  labeled gauges);
* ``snapshot()`` — a plain dict (healthz, bench, tests).

Rates (``goodput_rps``, ``tokens_per_s``) are computed over a **sliding
window** (default 60 s), not process lifetime — a long-lived idle
deployment decays to zero instead of averaging its history away; and
goodput counts only completions that landed **within their SLO deadline**.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence

from ..monitor.monitor import Event, Monitor
from ..observability.prometheus import (DEFAULT_MS_BUCKETS,
                                        ExpositionBuilder, Histogram)
from ..utils.locks import named_lock


def _percentile(samples: List[float], q: float) -> float:
    if not samples:
        return 0.0
    s = sorted(samples)
    idx = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
    return s[idx]


class _Reservoir:
    """Sliding window of the most recent N latency samples."""

    def __init__(self, cap: int = 2048):
        self._buf: Deque[float] = deque(maxlen=cap)

    def add(self, x: float) -> None:
        self._buf.append(x)

    def percentiles(self) -> Dict[str, float]:
        s = list(self._buf)
        return {"p50": _percentile(s, 0.50), "p95": _percentile(s, 0.95),
                "p99": _percentile(s, 0.99),
                "mean": (sum(s) / len(s)) if s else 0.0,
                "count": float(len(s))}


class _WindowRate:
    """Events-per-second over a sliding window of 1-second buckets.

    ``rate()`` divides the windowed sum by the window actually covered
    (elapsed time when the process is younger than the window), so a fresh
    deployment reports its true rate and an idle one decays to zero within
    ``window_s`` — unlike the old lifetime average, which decayed toward
    zero forever on any long-lived deployment."""

    def __init__(self, window_s: float = 60.0):
        self.window_s = float(window_s)
        n = int(self.window_s) + 1
        self._epochs = [-1] * n       # absolute 1s-bucket index per slot
        self._sums = [0.0] * n
        self._t0: Optional[float] = None

    def add(self, value: float, now: float) -> None:
        if self._t0 is None:
            self._t0 = now
        idx = int(now)
        slot = idx % len(self._sums)
        if self._epochs[slot] != idx:
            self._epochs[slot] = idx
            self._sums[slot] = 0.0
        self._sums[slot] += value

    def rate(self, now: float) -> float:
        if self._t0 is None:
            return 0.0
        idx = int(now)
        lo = idx - int(self.window_s)
        total = sum(s for e, s in zip(self._epochs, self._sums) if lo < e <= idx)
        covered = min(self.window_s, max(now - self._t0, 1.0))
        return total / covered


class ServingMetrics:
    def __init__(self, rate_window_s: float = 60.0,
                 now_fn: Callable[[], float] = time.monotonic):
        self._lock = named_lock("metrics.state")
        self._now = now_fn
        self.ttft_ms = _Reservoir()   # submit → first generated token
        self.tpot_ms = _Reservoir()   # inter-token gap during decode
        self.queue_wait_ms = _Reservoir()  # submit → engine admission
        # native histograms (full distributions for /metrics exposition)
        self.ttft_hist = Histogram(DEFAULT_MS_BUCKETS)
        self.tpot_hist = Histogram(DEFAULT_MS_BUCKETS)
        self.queue_wait_hist = Histogram(DEFAULT_MS_BUCKETS)
        # counters (monotonic)
        self.submitted = 0
        self.rejected = 0        # queue-cap backpressure (429)
        self.completed = 0
        self.completed_in_slo = 0  # completions within their deadline
        self.cancelled = 0
        self.failed = 0
        self.deadline_missed = 0  # shed by SLO deadline
        self.failovers = 0        # replica died mid-request; balancer retried
        self.tokens_out = 0
        # sliding-window rates
        self._win_goodput = _WindowRate(rate_window_s)
        self._win_tokens = _WindowRate(rate_window_s)
        self._rate_window_s = rate_window_s
        # per-tenant accounting: (tenant, slo_class) -> counters + windows.
        # Bounded by the tenant population (operator-configured), not by
        # request volume.
        self._tenants: Dict[tuple, Dict] = {}
        # gauges (set by the pool's metrics pump / broker loop)
        self.queue_depth = 0
        self.running = 0
        self.kv_utilization = 0.0
        # per-replica labeled series for /metrics (set by the pool pump)
        self.replica_stats: List[Dict[str, float]] = []
        # fleet lifecycle counters (transports + supervisor + registry):
        # spawns/respawns/deaths/detections — the robustness ledger
        self.fleet: Dict[str, int] = {
            "spawns": 0, "respawns": 0, "worker_deaths": 0,
            "heartbeat_misses": 0, "hung_detected": 0, "circuit_opens": 0,
            "registrations": 0, "fenced": 0, "stale_epoch_rejects": 0,
            "lease_expiries": 0, "protocol_errors": 0,
        }
        # autoscaler decision counters (serving/autoscaler.py)
        self.autoscale: Dict[str, int] = {"up": 0, "down": 0, "blocked": 0}
        # registry membership (remote transport; set by the pool pump)
        self.registry_members: List[Dict[str, float]] = []
        # prefix-cache mirror (engine-owned counters, summed over replicas
        # by the pump; all zero when the cache is disabled)
        self.prefix: Dict[str, float] = {
            "enabled": 0, "lookups": 0, "hits": 0, "hit_rate": 0.0,
            "prefill_tokens_skipped": 0, "evictions": 0, "cow_copies": 0,
            "cached_blocks": 0, "shared_blocks": 0, "evictable_blocks": 0,
            "pinned_blocks": 0,
        }
        # serving memory hierarchy mirror (engine-owned tier gauges +
        # demote/promote counters from inference/v2/paging.py, summed over
        # replicas by the pump; all zero without --kv_host_pool_mb).  A
        # separate family from ``prefix`` so the tier gauges get their own
        # dstpu_serving_kv_* names without double-emitting prefix_* keys.
        self.kv: Dict[str, float] = {
            "tier_device_blocks": 0, "tier_host_blocks": 0,
            "tier_spill_blocks": 0, "tier_cold_blocks": 0,
            "demotions": 0, "promotions": 0,
            "promote_wait_ms": 0.0, "rehydrated_blocks": 0,
            "gc_spill_files": 0,
        }
        # crash-durable cold tier mirror (manifest-verified checkpoint
        # store below the host pool, inference/v2/coldstore.py; summed
        # over replicas by the pump; all zero without --kv_coldstore_dir)
        self.coldstore: Dict[str, float] = {
            "entries": 0, "bytes": 0, "writes": 0,
            "corrupt_dropped": 0, "gc_tmp": 0,
        }
        # multi-adapter serving mirror (registry-owned gauges + paging
        # counters from serving/adapters.py, summed over replicas by the
        # pump; all zero without --adapter_slots)
        self.adapters: Dict[str, float] = {
            "resident": 0, "host": 0, "registered": 0, "refs": 0,
            "loads": 0, "evictions": 0, "hits": 0,
            "capacity_deferrals": 0, "promote_wait_ms": 0.0,
            "host_bytes_used": 0, "spill_blocks": 0,
            "cold_blocks": 0, "rehydrated": 0, "coldstore_entries": 0,
        }
        # speculative-decoding mirror (engine-owned counters, summed over
        # replicas by the pump; all zero when spec_mode is "off")
        self.spec: Dict[str, float] = {
            "enabled": 0, "k": 0, "steps": 0, "proposed_tokens": 0,
            "accepted_tokens": 0, "emitted_tokens": 0,
            "acceptance_rate": 0.0, "fallback_steps": 0,
        }
        self._t0 = self._now()

    # -- recording hooks (broker/balancer/server) ----------------------

    def record_submit(self) -> None:
        with self._lock:
            self.submitted += 1

    def record_reject(self) -> None:
        with self._lock:
            self.rejected += 1

    def record_admit(self, queue_wait_s: float) -> None:
        with self._lock:
            self.queue_wait_ms.add(queue_wait_s * 1e3)
            self.queue_wait_hist.observe(queue_wait_s * 1e3)

    def record_first_token(self, ttft_s: float) -> None:
        with self._lock:
            self.ttft_ms.add(ttft_s * 1e3)
            self.ttft_hist.observe(ttft_s * 1e3)
            self.tokens_out += 1
            self._win_tokens.add(1.0, self._now())

    def record_token(self, gap_s: float) -> None:
        with self._lock:
            self.tpot_ms.add(gap_s * 1e3)
            self.tpot_hist.observe(gap_s * 1e3)
            self.tokens_out += 1
            self._win_tokens.add(1.0, self._now())

    def record_failover(self) -> None:
        with self._lock:
            self.failovers += 1

    def record_fleet(self, key: str, n: int = 1) -> None:
        """Replica lifecycle counter (transport + supervisor + registry):
        e.g. ``spawns``, ``respawns``, ``worker_deaths``,
        ``heartbeat_misses``, ``hung_detected``, ``circuit_opens``,
        ``registrations``, ``fenced``, ``stale_epoch_rejects``,
        ``lease_expiries``."""
        with self._lock:
            self.fleet[key] = self.fleet.get(key, 0) + n

    def record_autoscale(self, key: str, n: int = 1) -> None:
        """Autoscaler decision counter: ``up``, ``down``, or ``blocked``
        (wanted to grow but the max bound / ban said no)."""
        with self._lock:
            self.autoscale[key] = self.autoscale.get(key, 0) + n

    def set_registry_members(self, members: Sequence[Dict]) -> None:
        """Registry membership for /metrics: one entry per fleet slot with
        ``worker``, ``epoch``, ``connected`` (see
        ``WorkerRegistry.membership``)."""
        with self._lock:
            self.registry_members = [dict(m) for m in members]

    def record_finish(self, reason: str, within_deadline: bool = True) -> None:
        """Terminal disposition.  ``within_deadline`` is the broker's
        verdict (finish time vs the request's SLO deadline; True when no
        deadline was set) — only those completions count toward goodput."""
        with self._lock:
            if reason in ("length", "stop"):
                self.completed += 1
                if within_deadline:
                    self.completed_in_slo += 1
                    self._win_goodput.add(1.0, self._now())
            elif reason == "cancelled":
                self.cancelled += 1
            elif reason == "deadline":
                self.deadline_missed += 1
                self.failed += 1
            else:
                self.failed += 1

    def record_tenant_finish(self, tenant: str, slo_class: str, reason: str,
                             tokens: int, within_deadline: bool = True) -> None:
        """Per-tenant disposition: goodput counts length/stop completions
        within deadline; ``deadline`` sheds move the tenant's shed counter
        (the per-tenant SLO ledger behind ``dstpu_serving_tenant_*``)."""
        with self._lock:
            key = (tenant, slo_class)
            ent = self._tenants.get(key)
            if ent is None:
                ent = self._tenants[key] = {
                    "completed": 0, "shed": 0, "tokens": 0,
                    "win_goodput": _WindowRate(self._rate_window_s),
                    "win_tokens": _WindowRate(self._rate_window_s),
                }
            now = self._now()
            if reason in ("length", "stop"):
                ent["completed"] += 1
                ent["tokens"] += int(tokens)
                ent["win_tokens"].add(float(tokens), now)
                if within_deadline:
                    ent["win_goodput"].add(1.0, now)
            elif reason == "deadline":
                ent["shed"] += 1

    def tenant_snapshot(self) -> List[Dict[str, float]]:
        """One row per (tenant, SLO class): sliding-window goodput and
        token rates plus the monotonic shed counter."""
        with self._lock:
            now = self._now()
            return [{"tenant": t, "slo_class": c,
                     "goodput_rps": ent["win_goodput"].rate(now),
                     "tokens_per_s": ent["win_tokens"].rate(now),
                     "completed": float(ent["completed"]),
                     "shed_total": float(ent["shed"])}
                    for (t, c), ent in sorted(self._tenants.items())]

    def set_gauges(self, queue_depth: int, running: int,
                   kv_utilization: float) -> None:
        with self._lock:
            self.queue_depth = queue_depth
            self.running = running
            self.kv_utilization = kv_utilization

    def set_replica_stats(self, stats: Sequence[Dict[str, float]]) -> None:
        """Per-replica gauge series for /metrics labels; each entry carries
        ``name`` plus numeric gauges (healthy, queue_depth, running,
        outstanding_tokens, kv_utilization)."""
        with self._lock:
            self.replica_stats = [dict(s) for s in stats]

    def set_prefix_stats(self, stats: Dict[str, float]) -> None:
        """Mirror engine prefix-cache stats (see
        ``InferenceEngineV2.prefix_stats``); pools pass the sum over
        replicas, with ``hit_rate`` recomputed from the summed counts."""
        with self._lock:
            for k in self.prefix:
                if k in stats:
                    self.prefix[k] = stats[k]
            for k in self.kv:
                if k in stats:
                    self.kv[k] = stats[k]
            for k in self.coldstore:
                if "coldstore_" + k in stats:
                    self.coldstore[k] = stats["coldstore_" + k]

    def set_adapter_stats(self, stats: Dict[str, float]) -> None:
        """Mirror adapter-registry stats (see
        ``serving.adapters.AdapterRegistry.stats``); pools pass the sum
        over replicas, brokers pass their own registry's view."""
        with self._lock:
            for k in self.adapters:
                if k in stats:
                    self.adapters[k] = stats[k]

    def set_spec_stats(self, stats: Dict[str, float]) -> None:
        """Mirror engine speculative-decoding stats (see
        ``InferenceEngineV2.spec_stats``); pools pass the sum over replicas,
        with ``acceptance_rate`` recomputed from the summed counts."""
        with self._lock:
            for k in self.spec:
                if k in stats:
                    self.spec[k] = stats[k]

    # -- exposition ----------------------------------------------------

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            now = self._now()
            out: Dict[str, float] = {
                "submitted": self.submitted, "rejected": self.rejected,
                "completed": self.completed,
                "completed_in_slo": self.completed_in_slo,
                "cancelled": self.cancelled,
                "failed": self.failed,
                "deadline_missed": self.deadline_missed,
                "failovers": self.failovers,
                "tokens_out": self.tokens_out,
                "queue_depth": self.queue_depth, "running": self.running,
                "kv_utilization": self.kv_utilization,
                # goodput: within-SLO completions per second over the
                # sliding rate window (not process lifetime)
                "goodput_rps": self._win_goodput.rate(now),
                "tokens_per_s": self._win_tokens.rate(now),
            }
            for name, res in (("ttft_ms", self.ttft_ms),
                              ("tpot_ms", self.tpot_ms),
                              ("queue_wait_ms", self.queue_wait_ms)):
                for k, v in res.percentiles().items():
                    out[f"{name}_{k}"] = v
            for k, v in self.prefix.items():
                out[f"prefix_{k}"] = float(v)
            for k, v in self.kv.items():
                out[f"kv_{k}"] = float(v)
            for k, v in self.coldstore.items():
                out[f"coldstore_{k}"] = float(v)
            for k, v in self.adapters.items():
                out[f"adapter_{k}"] = float(v)
            for k, v in self.spec.items():
                out[f"spec_{k}"] = float(v)
            for k, v in self.fleet.items():
                out[f"replica_{k}"] = float(v)
            for k, v in self.autoscale.items():
                out[f"autoscale_{k}"] = float(v)
            return out

    def to_events(self, step: int) -> List[Event]:
        return [(f"serving/{k}", float(v), step)
                for k, v in self.snapshot().items()]

    _COUNTER_HELP = {
        "submitted": "Requests accepted into an admission queue.",
        "rejected": "Requests rejected by queue backpressure (HTTP 429).",
        "completed": "Requests finished with reason length/stop.",
        "completed_in_slo": "Completions within their SLO deadline.",
        "cancelled": "Requests cancelled by the client.",
        "failed": "Requests that terminally failed (incl. deadline sheds).",
        "deadline_missed": "Requests shed past their SLO deadline.",
        "failovers": "Mid-request replica deaths retried by the balancer.",
        "tokens_out": "Generated tokens delivered to clients.",
    }
    _GAUGE_HELP = {
        "queue_depth": "Requests queued (accepted, not yet admitted).",
        "running": "Sequences running in the engines.",
        "kv_utilization": "Fraction of KV blocks unavailable to new work.",
        "goodput_rps": "Within-SLO completions/s over the sliding window.",
        "tokens_per_s": "Delivered tokens/s over the sliding window.",
    }

    def to_prometheus(self) -> str:
        """Text exposition (version 0.0.4) with HELP/TYPE metadata, native
        histograms, and per-replica labeled gauges; validated by the strict
        parser in ``observability/prometheus.py``."""
        snap = self.snapshot()
        with self._lock:
            replica_stats = [dict(s) for s in self.replica_stats]
            registry_members = [dict(m) for m in self.registry_members]
        b = ExpositionBuilder()
        pre = "dstpu_serving_"
        for k, help_text in self._COUNTER_HELP.items():
            b.counter(pre + k, help_text, snap[k])
        for k, help_text in self._GAUGE_HELP.items():
            b.gauge(pre + k, help_text, snap[k])
        # latency summaries: percentile gauges (dashboards) + histograms
        # (aggregation); the reservoir's windowed count/mean stay
        # snapshot()-only — the histogram _count/_sum are authoritative here
        for fam, res, hist, what in (
                ("ttft_ms", self.ttft_ms, self.ttft_hist,
                 "submit to first generated token"),
                ("tpot_ms", self.tpot_ms, self.tpot_hist,
                 "inter-token gap during decode"),
                ("queue_wait_ms", self.queue_wait_ms, self.queue_wait_hist,
                 "submit to engine admission")):
            for q in ("p50", "p95", "p99"):
                b.gauge(f"{pre}{fam}_{q}",
                        f"{q} {what} (ms, recent-sample reservoir).",
                        snap[f"{fam}_{q}"])
            b.histogram(pre + fam, f"Histogram of {what} (ms).", hist)
        for k in self.prefix:
            b.gauge(f"{pre}prefix_{k}",
                    f"Prefix cache: {k.replace('_', ' ')}.",
                    snap[f"prefix_{k}"])
        for k in self.kv:
            b.gauge(f"{pre}kv_{k}",
                    f"KV memory hierarchy: {k.replace('_', ' ')}.",
                    snap[f"kv_{k}"])
        for k in self.coldstore:
            b.gauge(f"{pre}coldstore_{k}",
                    f"Crash-durable cold tier: {k.replace('_', ' ')}.",
                    snap[f"coldstore_{k}"])
        for k in self.adapters:
            b.gauge(f"{pre}adapter_{k}",
                    f"Multi-adapter serving: {k.replace('_', ' ')}.",
                    snap[f"adapter_{k}"])
        for k in self.spec:
            b.gauge(f"{pre}spec_{k}",
                    f"Speculative decoding: {k.replace('_', ' ')}.",
                    snap[f"spec_{k}"])
        _FLEET_HELP = {
            "spawns": "Replica worker processes spawned (first generations).",
            "respawns": "Replica worker processes respawned after a death.",
            "worker_deaths": "Replica worker deaths (crash, exit, EOF, "
                             "dead broker).",
            "heartbeat_misses": "Replicas declared down by heartbeat "
                                "timeout.",
            "hung_detected": "Replicas declared down as hung (busy with "
                             "stale progress).",
            "circuit_opens": "Replica slots retired by the crash-loop "
                             "circuit breaker.",
            "registrations": "Worker registrations accepted by the "
                             "fleet registry.",
            "fenced": "Live connections severed by a newer-epoch "
                      "registration.",
            "stale_epoch_rejects": "Registrations rejected for a stale "
                                   "or duplicate fencing epoch.",
            "lease_expiries": "Remote slots whose lease expired after a "
                              "connection loss (escalated to death).",
            "protocol_errors": "Connections dropped for unparseable "
                               "frames (bad magic, oversize, garbage).",
        }
        for k in self.fleet:
            b.counter(f"{pre}replica_{k}",
                      _FLEET_HELP.get(k, f"Fleet: {k.replace('_', ' ')}."),
                      snap[f"replica_{k}"])
        _AUTOSCALE_HELP = {
            "up": "Autoscaler scale-up decisions (replica spawned).",
            "down": "Autoscaler scale-down decisions (replica drained "
                    "and retired).",
            "blocked": "Scale-ups wanted but blocked by the max bound "
                       "or the spawn-failure ban.",
        }
        for k in self.autoscale:
            b.counter(f"{pre}autoscale_{k}",
                      _AUTOSCALE_HELP.get(k,
                                          f"Autoscale: {k}."),
                      snap[f"autoscale_{k}"])
        if registry_members:
            b.gauge_series(
                f"{pre}registry_member",
                "Fleet registry membership: 1 connected / 0 not, "
                "labeled by worker and fencing epoch.",
                [({"worker": str(m.get("worker", i)),
                   "epoch": str(m.get("epoch", 0))},
                  1.0 if m.get("connected") else 0.0)
                 for i, m in enumerate(registry_members)])
        tenants = self.tenant_snapshot()
        if tenants:
            _TENANT_HELP = {
                "goodput_rps": "Per-tenant within-SLO completions/s over "
                               "the sliding window.",
                "tokens_per_s": "Per-tenant delivered tokens/s over the "
                                "sliding window.",
                "shed_total": "Per-tenant requests shed past their SLO "
                              "class deadline.",
                "completed": "Per-tenant requests finished with reason "
                             "length/stop.",
            }
            for k, help_text in _TENANT_HELP.items():
                b.gauge_series(
                    f"{pre}tenant_{k}", help_text,
                    [({"tenant": str(row["tenant"]),
                       "slo_class": str(row["slo_class"])}, float(row[k]))
                     for row in tenants])
        if replica_stats:
            # "stale" is a label, not a gauge: a dead replica's series keep
            # their last-known values but carry stale="true" so dashboards
            # can tell frozen-but-reported from live
            def _labels(s, i):
                labels = {"replica": str(s.get("name", i))}
                if s.get("stale"):
                    labels["stale"] = "true"
                return labels

            keys = [k for k in replica_stats[0]
                    if k not in ("name", "stale")]
            for k in keys:
                b.gauge_series(
                    f"{pre}replica_{k}",
                    f"Per-replica {k.replace('_', ' ')}.",
                    [(_labels(s, i), float(s.get(k, 0.0)))
                     for i, s in enumerate(replica_stats)])
        return b.render()

    def emit_to(self, monitor: Monitor, step: int) -> None:
        if monitor is not None and getattr(monitor, "enabled", False):
            monitor.write_events(self.to_events(step))
