"""Serving-layer configuration (the port of
``deepspeed_tpu/serving/config.py``).

Capability analogue of DeepSpeed-MII's deployment config (``mii/config.py``
``ModelConfig``/``MIIConfig``: replica counts, queue sizes, ports). A plain
dataclass like :class:`inference.v2.engine.V2Config` — the serving layer sits
outside the pydantic training-config tree.

Engine-side knobs (geometry, prefix cache, speculative decoding, and the
serving memory hierarchy ``--kv_host_pool_mb`` / ``--kv_spill_dir`` /
``--kv_promote_ahead``) are NOT here: they live in ``V2Config`` and are
registered by ``server.add_engine_cli_args`` so the in-process front and
the out-of-process worker build bit-identical engines from one flag set.
The paging tier still shapes serving behaviour through this layer's
numbers: demoted blocks stay reclaimable, so ``broker.kv_utilization``
(deferral/shedding) and heartbeat ``prefix_summary`` digests (cache-aware
routing) keep counting sessions whose KV currently lives off-device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

#: replica classes for phase-disaggregated serving (Splitwise/DistServe):
#: "prefill" replicas take prompt-heavy requests, "decode" replicas take
#: generation-heavy ones, "mixed" takes anything.
REPLICA_CLASSES = ("prefill", "decode", "mixed")


@dataclasses.dataclass
class ServingConfig:
    #: bounded admission queue PER REPLICA (requests accepted but not yet
    #: admitted into the engine). Overflow raises QueueFullError → HTTP 429:
    #: the SLO-backpressure knob — queue depth is the latency you promise.
    max_queue: int = 64
    #: applied when a request omits max_tokens
    default_max_tokens: int = 64
    #: engine-wide sampling temperature (one ragged batch shares one
    #: temperature; per-request overrides must match — see broker docstring)
    temperature: float = 0.0
    #: per-request SLO deadline (seconds from submit to completion); None
    #: disables shedding. Queued requests past deadline fail without ever
    #: occupying KV; running ones are cancelled and their blocks freed.
    deadline_s: Optional[float] = None
    #: emitting any of these tokens ends the request (finish_reason "stop")
    stop_token_ids: Tuple[int, ...] = ()
    #: engine-thread idle wait between polls when there is no work
    idle_wait_s: float = 0.005
    #: replica pool size (in-process engine instances sharing params, or
    #: out-of-process workers — see ``replica_transport``)
    num_replicas: int = 1
    #: transparent retries when a replica dies mid-request
    retry_limit: int = 2
    #: failover backoff: exponential with decorrelated jitter —
    #: sleep_n = min(retry_backoff_max_s, uniform(retry_backoff_s,
    #: 3 * sleep_{n-1})) — so simultaneous failovers from a dead replica
    #: don't stampede the survivor in lockstep.
    retry_backoff_s: float = 0.05
    retry_backoff_max_s: float = 2.0
    #: how long a failing-over request will wait for SOME replica to come
    #: back before giving up.  Covers the window where every replica is
    #: down at once (e.g. the last survivor died while the others respawn):
    #: in-flight streams ride out a respawn instead of failing.  Fresh
    #: submits never wait — they fail fast to 503 for backpressure.
    failover_wait_s: float = 60.0
    #: graceful-drain window on shutdown (SIGTERM → finish outstanding)
    drain_timeout_s: float = 30.0
    #: metrics pump: emit monitor Events every this many seconds
    metrics_interval_s: float = 2.0

    # -- fault isolation (out-of-process replica workers) ---------------
    #: "inprocess": replicas are engine threads sharing one param pytree
    #: (fast, one CUDA context — a replica crash kills the host process).
    #: "subprocess": each replica is a worker process with its OWN CUDA
    #: runtime (``serving/worker.py``) — a segfault/OOM/hang is contained
    #: to one replica and the supervisor respawns it.
    replica_transport: str = "inprocess"
    #: worker → pool heartbeat period (carries live stats)
    heartbeat_interval_s: float = 0.25
    #: no heartbeat for this long → the worker is declared down
    #: (missed-beat detection; socket EOF is detected immediately)
    heartbeat_timeout_s: float = 5.0
    #: heartbeats flowing but the engine loop has not progressed for this
    #: long WHILE work is outstanding → the worker is wedged (hung-replica
    #: detection). Must exceed the worst-case first-request compile time.
    hung_replica_timeout_s: float = 120.0
    #: worker spawn → ready (socket up, first heartbeat) budget; a worker
    #: pays its own torch import + engine build inside this window
    spawn_timeout_s: float = 180.0
    #: submit → worker ack budget (the ack is queue admission, not decode)
    submit_timeout_s: float = 30.0
    #: supervisor poll period
    supervise_interval_s: float = 0.1
    #: respawn backoff: exponential in the consecutive-failure count,
    #: capped — base * 2**(fails-1), at most respawn_backoff_max_s
    respawn_backoff_s: float = 0.5
    respawn_backoff_max_s: float = 30.0
    #: consecutive spawn/crash failures before the circuit breaker opens
    #: and the slot stops respawning (the pool keeps serving at reduced
    #: capacity on the surviving replicas)
    circuit_breaker_threshold: int = 3
    #: a worker that stays healthy this long resets its crash streak
    respawn_reset_s: float = 5.0

    # -- multi-host fleet (remote transport — serving/remote.py) ---------
    #: shared-secret auth token for worker registration hellos; None
    #: disables auth (loopback/dev).  Workers read it from
    #: ``$DSTPU_FLEET_TOKEN``, never argv.
    fleet_token: Optional[str] = None
    #: registry bind address; port 0 picks an ephemeral port (tests)
    registry_host: str = "127.0.0.1"
    registry_port: int = 0
    #: hello send → reply budget per registration attempt (the only true
    #: socket timeout; steady-state deadlines are application-layer)
    hello_timeout_s: float = 5.0
    #: how long a remote slot whose CONNECTION dropped keeps its place
    #: past its last heartbeat before the supervisor escalates to the
    #: dead-worker path — the knob that tells network loss from death
    lease_ttl_s: float = 10.0

    # -- autoscaler (serving/autoscaler.py) ------------------------------
    #: replica count floor the autoscaler restores immediately
    autoscale_min: int = 1
    #: ceiling; 0 disables autoscaling entirely
    autoscale_max: int = 0
    #: control-loop period
    autoscale_interval_s: float = 0.5
    #: pressure = (queued requests + outstanding tokens) / healthy
    #: replicas; above this, sustained scale_up_debounce_s → scale up
    scale_up_pressure: float = 32.0
    scale_up_debounce_s: float = 1.0
    #: below this, sustained scale_down_idle_s → drain + retire one
    scale_down_pressure: float = 2.0
    scale_down_idle_s: float = 3.0
    #: consecutive spawn failures before the autoscaler bans itself from
    #: growing (elastic-agent ban discipline for flapping hosts)
    autoscale_max_spawn_fails: int = 3
    autoscale_backoff_s: float = 1.0
    autoscale_backoff_max_s: float = 30.0

    # -- phase disaggregation (Splitwise/DistServe-shaped) ---------------
    #: class of THIS worker when run standalone (``serving/worker.py
    #: --replica_class``); pool-side builds use ``replica_classes``
    replica_class: str = "mixed"
    #: class per replica slot, index-aligned with ``num_replicas``; empty
    #: means every slot is "mixed" (the pre-disaggregation behaviour).
    #: Slots beyond the tuple's length default to "mixed".
    replica_classes: Tuple[str, ...] = ()
    #: request phase classification: a request whose prompt length is at
    #: least ``phase_prefill_ratio * max_new_tokens`` is prefill-heavy and
    #: prefers "prefill"-class replicas; everything else prefers "decode".
    phase_prefill_ratio: float = 4.0
    #: consult per-replica radix-tree digest summaries (heartbeated) and
    #: route a request to the replica already holding the longest cached
    #: prefix of its prompt, overriding the load tiebreak
    cache_aware_routing: bool = True
    #: per-class autoscale bounds, e.g. {"decode": (1, 4)}; classes not
    #: listed fall back to the global ``autoscale_min``/``autoscale_max``.
    #: Only meaningful with ``autoscale_max > 0``.
    autoscale_class_bounds: Dict[str, Tuple[int, int]] = dataclasses.field(
        default_factory=dict)

    # -- per-tenant SLO classes ------------------------------------------
    #: SLO class table: name -> (priority, deadline_s).  Lower priority
    #: number = more important (admitted first under pressure, shed last).
    #: ``deadline_s`` of 0 means "inherit the global deadline_s".
    slo_classes: Dict[str, Tuple[int, float]] = dataclasses.field(
        default_factory=dict)
    #: SLO class applied when a request names none (must be a key of
    #: ``slo_classes`` when that table is non-empty)
    default_slo_class: str = "standard"

    # -- rolling weight swaps (serving/rollout.py) -----------------------
    #: per-replica drain budget before its swap
    rollout_drain_timeout_s: float = 30.0
    #: post-swap health-probe decode budget (greedy, token-checked)
    rollout_probe_tokens: int = 4
    rollout_probe_timeout_s: float = 120.0


# -- CLI spec parsers (shared by the HTTP front and the worker) -------------


def parse_replica_classes(text: Optional[str]) -> Tuple[str, ...]:
    """``"prefill,decode,mixed"`` → per-slot class tuple."""
    if not text:
        return ()
    classes = tuple(c.strip() for c in text.split(",") if c.strip())
    for c in classes:
        if c not in REPLICA_CLASSES:
            raise ValueError(
                f"unknown replica class {c!r}; valid: {REPLICA_CLASSES}")
    return classes


def parse_slo_classes(text: Optional[str]) -> Dict[str, Tuple[int, float]]:
    """``"interactive:0:2.5,batch:1:0"`` → {name: (priority, deadline_s)}.
    Deadline 0 inherits the global ``deadline_s``."""
    table: Dict[str, Tuple[int, float]] = {}
    for part in (text or "").split(","):
        part = part.strip()
        if not part:
            continue
        try:
            name, prio, deadline = part.split(":")
            table[name.strip()] = (int(prio), float(deadline))
        except ValueError:
            raise ValueError(
                f"malformed SLO class {part!r} "
                "(want NAME:PRIORITY:DEADLINE_S, deadline 0 = inherit)")
    return table


def format_slo_classes(table: Dict[str, Tuple[int, float]]) -> str:
    """Inverse of :func:`parse_slo_classes` (worker argv serialization)."""
    return ",".join(f"{name}:{prio}:{deadline}"
                    for name, (prio, deadline) in sorted(table.items()))


def parse_class_bounds(text: Optional[str]
                       ) -> Dict[str, Tuple[int, int]]:
    """``"prefill=1:2,decode=1:4"`` → {class: (min, max)} autoscale
    bounds."""
    bounds: Dict[str, Tuple[int, int]] = {}
    for part in (text or "").split(","):
        part = part.strip()
        if not part:
            continue
        try:
            cls, span = part.split("=")
            lo, hi = span.split(":")
            cls = cls.strip()
        except ValueError:
            raise ValueError(f"malformed class bounds {part!r} "
                             "(want CLASS=MIN:MAX)")
        if cls not in REPLICA_CLASSES:
            raise ValueError(
                f"unknown replica class {cls!r}; valid: {REPLICA_CLASSES}")
        bounds[cls] = (int(lo), int(hi))
    return bounds
