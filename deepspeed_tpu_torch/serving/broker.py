"""Request broker: the persistent-serving request lifecycle over one
:class:`~deepspeed_tpu_torch.inference.v2.engine.InferenceEngineV2` (the
port of ``deepspeed_tpu/serving/broker.py``).

Capability analogue of DeepSpeed-MII's async server stack
(``mii/batching/ragged_batching.py`` ``RaggedRequestBatch`` /
``MIIAsyncPipeline``: request queues feeding the persistent FastGen engine
thread, per-request streaming back through result queues).

Lifecycle::

    QUEUED --admit--> PREFILL --first token--> DECODE --budget/stop--> DONE
       \\--deadline/cancel--> CANCELLED / FAILED (any pre-terminal state)

One dedicated **engine thread** owns every engine call: it admits queued
requests with ``engine.put(strict=True)`` — an :class:`AdmissionError`
(pool or slot exhaustion) defers admission instead of failing the request —
runs the continuous-batching ``step()`` loop, fans tokens out to per-request
delivery queues, sheds requests past their SLO deadline, and executes
cancellations (returning the sequence's KV blocks to the pool).  HTTP
threads only touch the bounded admission queue and the delivery queues, so
the engine needs no internal locking.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import queue
import threading
import time
import zlib
from collections import deque
from typing import (Deque, Dict, FrozenSet, Iterator, List, Optional, Sequence,
                    Set, Tuple)

from ..inference.v2.engine import AdmissionError, InferenceEngineV2
from ..observability import replay as workload
from .adapters import AdapterCapacityError, AdapterError, AdapterRegistry
from ..observability.recorder import recorder
from ..observability.trace import tracer
from ..utils import faults
from ..utils.locks import named_lock
from ..utils.logging import logger, request_logger
from .config import ServingConfig
from .metrics import ServingMetrics


class QueueFullError(RuntimeError):
    """Bounded admission queue is full — surface as HTTP 429 backpressure."""


class InvalidRequestError(ValueError):
    """Malformed request (empty prompt, impossible budget, bad params)."""


class BrokerStoppedError(RuntimeError):
    """Broker is shutting down / dead and not accepting requests."""


class RequestFailedError(RuntimeError):
    """Terminal failure delivered through the token stream (deadline shed,
    replica death, engine error). ``reason`` is machine-readable."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(detail or reason)
        self.reason = reason


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"
    CANCELLED = "cancelled"
    FAILED = "failed"


_TERMINAL = (RequestState.DONE, RequestState.CANCELLED, RequestState.FAILED)
_rid_counter = itertools.count(1)


@dataclasses.dataclass
class _Request:
    rid: str
    prompt: List[int]
    max_new_tokens: int
    stop_ids: frozenset
    deadline: Optional[float]  # absolute monotonic, None = no SLO
    submit_ts: float
    #: per-request sampling temperature; None inherits the deployment
    #: scalar (``ServingConfig.temperature``).  Rows mix freely in one
    #: ragged batch now that sampling is per-row inside the engine step.
    temperature: Optional[float] = None
    #: per-request sampling seed (derived from the rid when not given, so
    #: a failover resubmit reproduces the same stream)
    seed: int = 0
    tenant: str = "default"
    slo_class: str = "standard"
    #: admission priority from the SLO class table; lower admits first
    priority: int = 0
    #: registry adapter id this request decodes through (None = base model)
    adapter: Optional[str] = None
    #: a registry slot ref is held between admission and finalize
    adapter_ref: bool = False
    state: RequestState = RequestState.QUEUED
    uid: Optional[int] = None
    delivered: int = 0
    admit_ts: Optional[float] = None
    first_token_ts: Optional[float] = None
    last_token_ts: Optional[float] = None
    finish_ts: Optional[float] = None
    finish_reason: Optional[str] = None
    error: Optional[str] = None
    out_q: "queue.Queue" = dataclasses.field(default_factory=queue.Queue)
    #: the engine's ``params_version`` at every step that gave this
    #: request tokens: one element unless a swap split the stream (port)
    weight_versions: Set[int] = dataclasses.field(default_factory=set)
    # fleet-wide trace identity: the trace id minted by the
    # FIRST process that saw the request.  A failover resubmit mints a new
    # rid on the new replica but keeps the original trace_id, so the
    # stitched timeline shows one request across two workers.
    trace_id: Optional[str] = None


class RequestHandle:
    """Client-side view of one request: a blocking token iterator, a
    collecting ``result()``, and ``cancel()``."""

    def __init__(self, broker: "RequestBroker", req: _Request):
        self._broker = broker
        self._req = req

    @property
    def rid(self) -> str:
        return self._req.rid

    @property
    def state(self) -> RequestState:
        return self._req.state

    @property
    def finish_reason(self) -> Optional[str]:
        return self._req.finish_reason

    @property
    def prompt(self) -> List[int]:
        return self._req.prompt

    @property
    def weight_versions(self) -> FrozenSet[int]:
        """The weight generations (``InferenceEngineV2.params_version``)
        that produced this request's tokens."""
        return frozenset(self._req.weight_versions)

    def cancel(self) -> None:
        self._broker.cancel(self._req.rid)

    def tokens(self, timeout: Optional[float] = None) -> Iterator[int]:
        """Yield generated tokens as they stream; ends cleanly on completion
        or cancellation, raises :class:`RequestFailedError` on deadline shed,
        replica death, or engine failure."""
        while True:
            kind, payload = self._req.out_q.get(timeout=timeout)
            if kind == "tok":
                yield payload
            elif kind == "done":
                return
            else:  # "err"
                raise RequestFailedError(payload[0], payload[1])

    def result(self, timeout: Optional[float] = None) -> List[int]:
        return list(self.tokens(timeout=timeout))


class RequestBroker:
    """See module docstring.  ``engine`` must be a fresh
    :class:`InferenceEngineV2`; the broker's engine thread becomes its sole
    driver.  Construct, (optionally) ``submit()`` while paused, then
    ``start()``."""

    def __init__(self, engine: InferenceEngineV2, config: ServingConfig,
                 metrics: Optional[ServingMetrics] = None,
                 name: str = "replica0", own_gauges: bool = True,
                 adapters: Optional[AdapterRegistry] = None):
        self.engine = engine
        self.cfg = config
        self.metrics = metrics or ServingMetrics()
        self.name = name
        #: multi-tenant LoRA registry; None = base-model-only deployment
        self.adapters = adapters
        self._own_gauges = own_gauges  # pool-managed brokers leave gauges to the pump
        self._lock = named_lock("broker.state")
        self._wake = threading.Condition(self._lock)
        self._queue: Deque[_Request] = deque()
        # tenant -> monotonic ts of its last admission (fairness ordering)
        self._tenant_last_admit: Dict[str, float] = {}
        self._by_uid: Dict[int, _Request] = {}
        self._by_rid: Dict[str, _Request] = {}
        self._cancels: List[str] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._drain = False
        self._dead: Optional[str] = None  # kill/crash reason
        # liveness for out-of-process supervision: the engine loop stamps
        # this every iteration, so a wedged step() (hung compile, stuck
        # device) shows up as a growing progress age while busy() is True
        self.last_progress_ts = time.monotonic()
        self._busy = False

    # -- client surface (any thread) ------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: Optional[int] = None,
               temperature: Optional[float] = None,
               deadline_s: Optional[float] = None,
               stop_token_ids: Sequence[int] = (),
               rid: Optional[str] = None,
               trace_id: Optional[str] = None,
               seed: Optional[int] = None,
               tenant: Optional[str] = None,
               slo_class: Optional[str] = None,
               adapter: Optional[str] = None) -> RequestHandle:
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise InvalidRequestError("prompt must be a non-empty token list")
        if adapter is not None:
            if self.adapters is None:
                raise InvalidRequestError(
                    "this deployment serves no adapters (engine built "
                    "without --adapter_slots)")
            if not self.adapters.known(adapter):
                raise InvalidRequestError(
                    f"unknown adapter {adapter!r} (have "
                    f"{self.adapters.ids()})")
        mnt = self.cfg.default_max_tokens if max_new_tokens is None \
            else int(max_new_tokens)
        if mnt <= 0:
            raise InvalidRequestError("max_tokens must be positive")
        max_ctx = (self.engine.cfg.max_blocks_per_seq *
                   self.engine.cfg.block_size)
        if len(prompt) + mnt > max_ctx:
            raise InvalidRequestError(
                f"prompt ({len(prompt)}) + max_tokens ({mnt}) exceeds the "
                f"replica's max context {max_ctx}")
        if temperature is not None and temperature < 0.0:
            raise InvalidRequestError(
                f"temperature must be >= 0, got {temperature}")
        # per-tenant SLO class: resolve priority + class deadline
        cls = slo_class or self.cfg.default_slo_class
        priority, cls_deadline = 0, None
        if self.cfg.slo_classes:
            if cls not in self.cfg.slo_classes:
                raise InvalidRequestError(
                    f"unknown SLO class {cls!r} (have "
                    f"{sorted(self.cfg.slo_classes)})")
            priority, d = self.cfg.slo_classes[cls]
            cls_deadline = float(d) if d > 0 else None
        if deadline_s is None:
            deadline_s = cls_deadline if cls_deadline is not None \
                else self.cfg.deadline_s
        now = time.monotonic()
        req = _Request(
            rid=rid or f"req-{next(_rid_counter)}",
            prompt=prompt, max_new_tokens=mnt,
            stop_ids=frozenset(self.cfg.stop_token_ids) | frozenset(
                int(t) for t in stop_token_ids),
            deadline=None if deadline_s is None else now + deadline_s,
            submit_ts=now, temperature=temperature,
            tenant=tenant or "default", slo_class=cls, priority=priority,
            adapter=adapter)
        # rid-derived seed: deterministic across failover resubmits (the
        # balancer keeps the rid), unique-enough across requests
        req.seed = int(seed) if seed is not None \
            else zlib.crc32(req.rid.encode())
        req.trace_id = trace_id or req.rid
        with self._wake:
            if self._stop or self._dead:
                raise BrokerStoppedError(f"broker {self.name} not accepting")
            if len(self._queue) >= self.cfg.max_queue:
                self.metrics.record_reject()
                raise QueueFullError(
                    f"admission queue full ({self.cfg.max_queue})")
            self.metrics.record_submit()
            self._queue.append(req)
            self._by_rid[req.rid] = req
            self._wake.notify_all()
        tracer.add_event("request/submit", trace_id=req.trace_id,
                         attrs={"replica": self.name, "rid": req.rid,
                                "prompt_tokens": len(prompt),
                                "max_new_tokens": mnt})
        workload.note_submit(rid=req.rid, t=now, prompt=prompt,
                             max_new_tokens=mnt,
                             stop_token_ids=[int(t) for t in stop_token_ids],
                             deadline_s=deadline_s,
                             temperature=temperature,
                             tenant=req.tenant, slo_class=cls,
                             adapter=adapter)
        if adapter is not None:
            # promote-ahead: overlap the spill→host half of the adapter's
            # promotion with its time in the admission queue
            self.adapters.prefetch([adapter])
        request_logger(req.rid).info(
            f"serving: submitted to {self.name} "
            f"(prompt={len(prompt)} tok, budget={mnt})")
        return RequestHandle(self, req)

    def cancel(self, rid: str) -> bool:
        with self._wake:
            req = self._by_rid.get(rid)
            if req is None or req.state in _TERMINAL:
                return False
            self._cancels.append(rid)
            if self._thread is None or not self._thread.is_alive():
                self._apply_cancels_locked()  # paused/dead broker
            else:
                self._wake.notify_all()
        workload.note_cancel(rid, time.monotonic())
        return True

    # -- pool surface ----------------------------------------------------

    def start(self) -> "RequestBroker":
        if self._thread is not None:
            return self
        # injected hard-kills (utils/faults.py) leave a postmortem dump
        recorder.install_crash_hook()
        self._thread = threading.Thread(
            target=self._run, name=f"dstpu-serving-{self.name}", daemon=True)
        self._thread.start()
        return self

    def healthy(self) -> bool:
        return (self._dead is None and not self._stop and
                (self._thread is None or self._thread.is_alive()))

    def queue_depth(self) -> int:
        return len(self._queue)

    def progress_age(self) -> float:
        """Seconds since the engine loop last completed an iteration."""
        return time.monotonic() - self.last_progress_ts

    def busy(self) -> bool:
        """True while the engine loop has admitted/queued work — a large
        ``progress_age`` is only a hang symptom when there IS work."""
        return self._busy

    def outstanding(self) -> int:
        """Live (non-terminal) requests."""
        with self._lock:
            return sum(1 for r in self._by_rid.values()
                       if r.state not in _TERMINAL)

    def outstanding_tokens(self) -> int:
        """Routing weight: tokens of work still owed (prompt not yet
        prefilled + generation budget not yet delivered)."""
        with self._lock:
            total = 0
            for r in self._by_rid.values():
                if r.state in _TERMINAL:
                    continue
                total += r.max_new_tokens - r.delivered
                if r.state == RequestState.QUEUED:
                    total += len(r.prompt)
            return total

    def kv_utilization(self) -> float:
        """Fraction of KV blocks NOT available to new work.  Evictable
        prefix-cache blocks count as free — a warm cache must not look
        like pool pressure to deferral / shedding logic.  With the paging
        tier attached (``--kv_host_pool_mb``), cached blocks stay
        recoverable even under ``prefix_eviction="none"``: demotion to
        host DRAM is lossless, so ``reclaimable_blocks`` includes them and
        admission keeps counting them as capacity."""
        e = self.engine
        reclaimable = e.free_blocks + e.reclaimable_blocks
        return 1.0 - reclaimable / max(e.total_blocks, 1)

    def kill(self, reason: str = "replica_dead") -> None:
        """Simulate/execute hard replica death: the engine thread exits and
        every outstanding request fails with ``reason`` (the balancer
        retries those on surviving replicas)."""
        recorder.record_event("broker/kill", replica=self.name, reason=reason)
        tracer.add_event("broker/kill",
                         attrs={"replica": self.name, "reason": reason})
        with self._wake:
            self._dead = reason
            self._wake.notify_all()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=30.0)
        else:
            with self._wake:
                self._fail_all_locked(reason)

    def swap_params(self, raw_params, wait_idle_s: float = 5.0) -> None:
        """Rolling weight swap: point the engine at new params between
        steps.  The caller (``serving/rollout.py`` or a worker ``swap``
        op) quiesces and drains this replica first; we still wait
        briefly for the engine loop to go idle — drain checks read
        cross-thread stats that can lag by one iteration — then swap
        under the broker lock so no admit races the pointer move."""
        deadline = time.monotonic() + wait_idle_s
        while True:
            with self._wake:
                if self._dead or self._stop:
                    raise BrokerStoppedError(
                        f"broker {self.name} not serving")
                if not (self.engine.running or self.engine.waiting
                        or self._queue):
                    self.engine.swap_params(raw_params)
                    break
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    f"swap_params: {self.name} still busy after "
                    f"{wait_idle_s:.1f}s — drain before swapping")
            time.sleep(0.01)
        tracer.add_event("broker/swap", attrs={"replica": self.name})
        recorder.record_event("broker/swap", replica=self.name)

    def swap_rollback(self) -> None:
        """Restore the pre-swap weights (failed post-swap probe)."""
        with self._wake:
            if self._dead:
                raise BrokerStoppedError(f"broker {self.name} dead")
            self.engine.swap_rollback()
        tracer.add_event("broker/swap_rollback",
                         attrs={"replica": self.name})
        recorder.record_event("broker/swap_rollback", replica=self.name)

    def stop(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        with self._wake:
            self._stop = True
            self._drain = drain
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                # drain overran its window: hard-stop
                with self._wake:
                    self._dead = "shutdown"
                    self._wake.notify_all()
                self._thread.join(timeout=10.0)

    # -- engine thread ---------------------------------------------------

    def _finalize_locked(self, req: _Request, reason: str,
                         detail: str = "") -> None:
        if req.adapter_ref:
            self.adapters.release(req.adapter)
            req.adapter_ref = False
        req.finish_reason = reason
        req.finish_ts = time.monotonic()
        if reason in ("length", "stop"):
            req.state = RequestState.DONE
        elif reason == "cancelled":
            req.state = RequestState.CANCELLED
        else:
            req.state = RequestState.FAILED
            req.error = detail or reason
        if reason in ("replica_dead", "engine_error", "shutdown"):
            # infra failure, not a request disposition: the balancer retries
            # these and records the final outcome (completed or error)
            self.metrics.record_failover()
        else:
            within = (req.deadline is None or req.finish_ts <= req.deadline)
            self.metrics.record_finish(reason, within_deadline=within)
            self.metrics.record_tenant_finish(
                req.tenant, req.slo_class, reason, req.delivered,
                within_deadline=within)
        if req.uid is not None:
            self._by_uid.pop(req.uid, None)
        self._record_timeline(req)
        request_logger(req.rid, req.uid).info(
            f"serving: finished on {self.name} reason={reason} "
            f"tokens={req.delivered}"
            + (f" detail={detail}" if detail else ""))
        if req.state == RequestState.FAILED:
            req.out_q.put(("err", (reason, detail or reason)))
        else:
            req.out_q.put(("done", reason))

    def _record_timeline(self, req: _Request) -> None:
        """Emit the request's phase spans (queue → prefill → decode) to the
        tracer and its full timeline to the flight recorder.  Retroactive:
        the phase boundaries were observed across HTTP / engine threads, so
        spans are recorded once all timestamps are known."""
        spans = []
        if req.admit_ts is not None:
            spans.append(("request/queue", req.submit_ts, req.admit_ts))
            if req.first_token_ts is not None:
                spans.append(("request/prefill", req.admit_ts,
                              req.first_token_ts))
                spans.append(("request/decode", req.first_token_ts,
                              req.finish_ts))
            else:  # shed/cancelled before the first token came back
                spans.append(("request/prefill", req.admit_ts, req.finish_ts))
        else:  # never admitted: the whole life was queueing
            spans.append(("request/queue", req.submit_ts, req.finish_ts))
        tid = req.trace_id or req.rid
        root = tracer.add_span(
            "request", req.submit_ts, req.finish_ts, trace_id=tid,
            attrs={"replica": self.name, "uid": req.uid, "rid": req.rid,
                   "reason": req.finish_reason, "tokens_out": req.delivered})
        parent = root.span_id if root is not None else None
        for name, t0, t1 in spans:
            tracer.add_span(name, t0, t1, trace_id=tid, parent_id=parent)
        ttft_ms = (None if req.first_token_ts is None
                   else (req.first_token_ts - req.submit_ts) * 1e3)
        recorder.record_request({
            "rid": req.rid, "trace_id": req.trace_id,
            "uid": req.uid, "replica": self.name,
            "submit_ts": req.submit_ts, "admit_ts": req.admit_ts,
            "first_token_ts": req.first_token_ts, "finish_ts": req.finish_ts,
            "finish_reason": req.finish_reason, "tokens_out": req.delivered,
            "ttft_ms": ttft_ms,
            "spans": [{"name": n, "t_start": t0, "t_end": t1}
                      for n, t0, t1 in spans],
        })

    def _apply_cancels_locked(self) -> None:
        for rid in self._cancels:
            req = self._by_rid.get(rid)
            if req is None or req.state in _TERMINAL:
                continue
            if req.state == RequestState.QUEUED:
                try:
                    self._queue.remove(req)
                except ValueError:
                    pass
            elif req.uid is not None:
                self.engine.cancel(req.uid)
            self._finalize_locked(req, "cancelled")
        self._cancels.clear()

    def _shed_deadlines_locked(self, now: float) -> None:
        for req in list(self._by_rid.values()):
            if req.state in _TERMINAL or req.deadline is None \
                    or now < req.deadline:
                continue
            if req.state == RequestState.QUEUED:
                try:
                    self._queue.remove(req)
                except ValueError:
                    pass
            elif req.uid is not None:
                self.engine.cancel(req.uid)
            self._finalize_locked(req, "deadline",
                                  f"SLO deadline exceeded after "
                                  f"{now - req.submit_ts:.3f}s")

    def _next_admit_locked(self) -> Optional[_Request]:
        """Admission order: SLO-class priority first (lower number wins),
        then tenant fairness — among equal-priority candidates the tenant
        that was admitted longest ago goes next — then FIFO.  Plain FIFO
        when no SLO classes are configured (single implicit class)."""
        if not self._queue:
            return None
        if not self.cfg.slo_classes:
            return self._queue[0]
        return min(self._queue, key=lambda r: (
            r.priority, self._tenant_last_admit.get(r.tenant, 0.0),
            r.submit_ts))

    def _admit_locked(self, now: float) -> None:
        while True:
            req = self._next_admit_locked()
            if req is None:
                break
            try:
                slot = 0
                if req.adapter is not None:
                    try:
                        slot = self.adapters.acquire(req.adapter)
                    except AdapterError:
                        # retired between submit and admission: a request
                        # disposition, not a capacity event
                        self._queue.remove(req)
                        self._finalize_locked(
                            req, "adapter_retired",
                            f"adapter {req.adapter!r} was retired while "
                            "this request was queued")
                        continue
                    req.adapter_ref = True
                try:
                    uid = self.engine.put(req.prompt, req.max_new_tokens,
                                          strict=True,
                                          temperature=req.temperature,
                                          seed=req.seed, adapter_slot=slot)
                except AdmissionError:
                    if req.adapter_ref:
                        self.adapters.release(req.adapter)
                        req.adapter_ref = False
                    raise
            except (AdmissionError, AdapterCapacityError):
                break  # defer: capacity frees as running requests finish
            self._queue.remove(req)
            self._tenant_last_admit[req.tenant] = now
            req.uid = uid
            req.state = RequestState.PREFILL
            req.admit_ts = now
            self._by_uid[uid] = req
            self.metrics.record_admit(now - req.submit_ts)
            request_logger(req.rid, uid).info(
                f"serving: admitted to {self.name} after "
                f"{(now - req.submit_ts) * 1e3:.1f}ms in queue")
        if self._queue and self.adapters is not None:
            # admission lookahead: the requests that will land in the next
            # few batches stage their spilled adapter bytes host-side now
            look = [r.adapter for r in itertools.islice(
                iter(self._queue), self.engine.cfg.max_seqs) if r.adapter]
            if look:
                self.adapters.prefetch(look)

    def _fail_all_locked(self, reason: str) -> None:
        for req in list(self._by_rid.values()):
            if req.state not in _TERMINAL:
                self._finalize_locked(req, reason)
        self._queue.clear()

    def _reap_terminal_locked(self) -> None:
        # keep the registry bounded in long-lived deployments
        if len(self._by_rid) > 4 * self.cfg.max_queue:
            for rid in [r.rid for r in self._by_rid.values()
                        if r.state in _TERMINAL]:
                del self._by_rid[rid]

    def _dispatch(self, out: Dict[int, List[int]], now: float,
                  versions: Set[int]) -> None:
        # engine steps deliver token LISTS: one entry normally, up to
        # spec_k+1 from a speculative step.  A stop token mid-list cancels
        # the request and drops the speculative suffix after it.
        for uid, toks in out.items():
            with self._lock:
                req = self._by_uid.get(uid)
            if req is None:
                continue
            for tok in toks:
                if tok in req.stop_ids:
                    with self._wake:
                        self.engine.cancel(uid)
                        self._finalize_locked(req, "stop")
                    break
                req.delivered += 1
                if req.first_token_ts is None:
                    req.first_token_ts = now
                    req.state = RequestState.DECODE
                    self.metrics.record_first_token(now - req.submit_ts)
                else:
                    self.metrics.record_token(now - req.last_token_ts)
                req.last_token_ts = now
                req.weight_versions |= versions
                req.out_q.put(("tok", tok))
            else:
                if uid not in self.engine.running:  # budget exhausted
                    with self._wake:
                        self._finalize_locked(req, "length")

    def _run(self) -> None:
        try:
            while True:
                with self._wake:
                    if self._dead:
                        self._fail_all_locked(self._dead)
                        return
                    now = time.monotonic()
                    self._apply_cancels_locked()
                    self._shed_deadlines_locked(now)
                    if not (self._stop and not self._drain):
                        self._admit_locked(now)
                    self._reap_terminal_locked()
                    has_work = bool(self.engine.running or
                                    self.engine.waiting or self._queue)
                    self.last_progress_ts = now
                    self._busy = has_work
                    if self._stop and (not self._drain or not has_work):
                        if not self._drain:
                            self._fail_all_locked("shutdown")
                        return
                    if not has_work:
                        if self._own_gauges:
                            self.metrics.set_gauges(len(self._queue), 0,
                                                    self.kv_utilization())
                            self.metrics.set_prefix_stats(
                                self.engine.prefix_stats())
                            self.metrics.set_spec_stats(
                                self.engine.spec_stats())
                            if self.adapters is not None:
                                self.metrics.set_adapter_stats(
                                    self.adapters.stats())
                        self._wake.wait(self.cfg.idle_wait_s)
                        continue
                # engine work outside the lock: submit/cancel stay non-blocking
                faults.maybe_fail("serving.step")
                version = self.engine.params_version
                out = self.engine.step(temperature=self.cfg.temperature)
                self._dispatch(out, time.monotonic(),
                               {version, self.engine.params_version})
                if self._own_gauges:
                    self.metrics.set_gauges(
                        len(self._queue), self.engine.num_running,
                        self.kv_utilization())
                    self.metrics.set_prefix_stats(self.engine.prefix_stats())
                    self.metrics.set_spec_stats(self.engine.spec_stats())
                    if self.adapters is not None:
                        self.metrics.set_adapter_stats(self.adapters.stats())
        except Exception as e:  # engine fault → fail outstanding, die
            logger.error(f"serving broker {self.name} engine fault: {e!r}")
            recorder.record_event("broker/engine_fault", replica=self.name,
                                  error=repr(e))
            recorder.dump(reason="engine_fault")
            with self._wake:
                self._dead = f"engine_error: {e!r}"
                self._fail_all_locked("engine_error")
        finally:
            # release paging-tier resources (promote-ahead thread, spill
            # writer) with the engine thread — nobody else owns the engine
            close = getattr(self.engine, "close", None)
            if close is not None:
                close()
            if self.adapters is not None:
                self.adapters.close()
