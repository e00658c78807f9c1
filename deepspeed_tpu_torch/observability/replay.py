"""Trace-driven workload replay: capture, synthesize, replay, gate (the
port of ``deepspeed_tpu/observability/replay.py``).

Turn "does disagg / autoscaling / spec-tuning help under
production traffic?" into a regression-gated number, the way
``analysis/budgets.toml`` did for compile-time properties.  The
evaluation methodology follows Splitwise (Patel et al., 2024): replay a
*recorded or synthesized arrival process* open-loop against the serving
fleet and gate tail percentiles, instead of trusting closed-loop
microbenchmarks that hide queueing.

Four pieces:

* **capture** — :class:`WorkloadCapture` records every ``broker.submit``
  / ``cancel`` (the broker calls the module-level :func:`note_submit` /
  :func:`note_cancel` hooks, no-ops unless a capture is installed) into
  the canonical workload schema: arrival offsets, prompt token lists
  (prefix-sharing structure survives verbatim), generation budgets,
  deadlines, cancels.
* **synthesis** — :func:`synthesize_workload` builds seeded heavy-tail
  workloads: Gamma interarrivals (CV > 1 burstiness), bounded-Zipf
  prompt-template reuse (prefix-cache-relevant sharing), geometric
  generation budgets, optional cancels.  Same seed → identical workload.
* **replay** — :func:`replay_workload` drives a live
  ``serving.ReplicaPool`` (in-process or subprocess fleet) open-loop on
  the workload's arrival schedule (optionally time-scaled), with optional
  mid-run chaos events (``utils/faults`` specs delivered to workers), and
  measures client-observed TTFT / TPOT / e2e / goodput plus sampled
  queue depth.
* **SLO gate** — declarative ceilings in ``slo.toml`` (same contract as
  ``analysis/budgets.py``: unknown keys are a hard error, a gate whose
  metric is missing fails loudly instead of passing vacuously), checked
  by :func:`check_slo` and reported as named-key
  :class:`SLOViolation` diffs.

The workload file format is JSONL: a header record
``{"kind": "dstpu-workload", "version": 1, "meta": {...}}`` followed by
one record per request.

Nothing here imports the serving stack at module level — the broker
imports this module for the capture hooks, and the replay driver only
needs serving types at call time.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..utils.locks import named_lock

__all__ = [
    "ChaosEvent",
    "SLOError",
    "SLOViolation",
    "WorkloadCapture",
    "WorkloadError",
    "WorkloadRequest",
    "check_slo",
    "default_slo_path",
    "load_slos",
    "load_workload",
    "note_cancel",
    "note_submit",
    "parse_chaos",
    "replay_workload",
    "save_workload",
    "summarize_replay",
    "synthesize_workload",
]

WORKLOAD_KIND = "dstpu-workload"
WORKLOAD_VERSION = 1

_RECORD_KEYS = {
    "offset_s", "prompt", "max_new_tokens", "stop_token_ids",
    "deadline_s", "cancel_after_s", "rid", "template",
    "temperature", "tenant", "slo_class", "adapter",
}


class WorkloadError(ValueError):
    """Malformed workload file (bad header, unknown key, bad record)."""


@dataclasses.dataclass
class WorkloadRequest:
    """One request of a workload trace.  ``offset_s`` is the arrival time
    relative to the first request; ``template`` (synthesis only) records
    which prompt template the prefix came from — the prefix-sharing
    structure a prefix-cache experiment wants to preserve."""

    offset_s: float
    prompt: List[int]
    max_new_tokens: Optional[int] = None
    stop_token_ids: Tuple[int, ...] = ()
    deadline_s: Optional[float] = None
    cancel_after_s: Optional[float] = None
    rid: Optional[str] = None
    template: Optional[int] = None
    temperature: Optional[float] = None
    tenant: Optional[str] = None
    slo_class: Optional[str] = None
    adapter: Optional[str] = None

    def to_record(self) -> Dict[str, Any]:
        rec: Dict[str, Any] = {"offset_s": round(self.offset_s, 6),
                               "prompt": list(self.prompt)}
        if self.max_new_tokens is not None:
            rec["max_new_tokens"] = int(self.max_new_tokens)
        if self.stop_token_ids:
            rec["stop_token_ids"] = [int(t) for t in self.stop_token_ids]
        if self.deadline_s is not None:
            rec["deadline_s"] = float(self.deadline_s)
        if self.cancel_after_s is not None:
            rec["cancel_after_s"] = round(float(self.cancel_after_s), 6)
        if self.rid is not None:
            rec["rid"] = self.rid
        if self.template is not None:
            rec["template"] = int(self.template)
        if self.temperature is not None:
            rec["temperature"] = float(self.temperature)
        if self.tenant is not None:
            rec["tenant"] = self.tenant
        if self.slo_class is not None:
            rec["slo_class"] = self.slo_class
        if self.adapter is not None:
            rec["adapter"] = self.adapter
        return rec

    @classmethod
    def from_record(cls, rec: Dict[str, Any], lineno: int
                    ) -> "WorkloadRequest":
        unknown = set(rec) - _RECORD_KEYS
        if unknown:
            raise WorkloadError(
                f"line {lineno}: unknown workload record key(s) "
                f"{sorted(unknown)}; known keys: {sorted(_RECORD_KEYS)}")
        if "offset_s" not in rec or "prompt" not in rec:
            raise WorkloadError(
                f"line {lineno}: workload record needs offset_s and prompt")
        prompt = rec["prompt"]
        if not isinstance(prompt, list) or not prompt or not all(
                isinstance(t, int) and not isinstance(t, bool)
                for t in prompt):
            raise WorkloadError(
                f"line {lineno}: prompt must be a non-empty token id list")
        return cls(
            offset_s=float(rec["offset_s"]), prompt=[int(t) for t in prompt],
            max_new_tokens=rec.get("max_new_tokens"),
            stop_token_ids=tuple(rec.get("stop_token_ids", ())),
            deadline_s=rec.get("deadline_s"),
            cancel_after_s=rec.get("cancel_after_s"),
            rid=rec.get("rid"), template=rec.get("template"),
            temperature=rec.get("temperature"), tenant=rec.get("tenant"),
            slo_class=rec.get("slo_class"), adapter=rec.get("adapter"))


# ---------------------------------------------------------------------------
# save / load (canonical JSONL schema)
# ---------------------------------------------------------------------------


def save_workload(path: str, requests: Sequence[WorkloadRequest],
                  meta: Optional[Dict[str, Any]] = None) -> str:
    """Write the canonical JSONL: header record, then one per request."""
    header = {"kind": WORKLOAD_KIND, "version": WORKLOAD_VERSION,
              "meta": dict(meta or {})}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(json.dumps(header, separators=(",", ":")) + "\n")
        for r in requests:
            f.write(json.dumps(r.to_record(), separators=(",", ":")) + "\n")
    os.replace(tmp, path)
    return path


def load_workload(path: str
                  ) -> Tuple[Dict[str, Any], List[WorkloadRequest]]:
    """Read and validate a workload file; returns ``(meta, requests)``
    sorted by arrival offset.  Hard-errors on schema violations — a
    silently-misread workload would gate the wrong numbers."""
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    if not lines:
        raise WorkloadError(f"{path}: empty workload file")
    try:
        header = json.loads(lines[0])
    except json.JSONDecodeError as e:
        raise WorkloadError(f"{path}: header is not JSON: {e}")
    if not isinstance(header, dict) or header.get("kind") != WORKLOAD_KIND:
        raise WorkloadError(
            f"{path}: not a workload trace (want header kind="
            f"{WORKLOAD_KIND!r}, got {header!r})")
    if header.get("version") != WORKLOAD_VERSION:
        raise WorkloadError(
            f"{path}: workload version {header.get('version')!r} != "
            f"{WORKLOAD_VERSION}")
    requests: List[WorkloadRequest] = []
    for lineno, ln in enumerate(lines[1:], 2):
        try:
            rec = json.loads(ln)
        except json.JSONDecodeError as e:
            raise WorkloadError(f"{path}: line {lineno}: not JSON: {e}")
        requests.append(WorkloadRequest.from_record(rec, lineno))
    requests.sort(key=lambda r: r.offset_s)
    return dict(header.get("meta") or {}), requests


# ---------------------------------------------------------------------------
# capture at the broker
# ---------------------------------------------------------------------------

_capture_lock = named_lock("replay.capture_install")
_capture: Optional["WorkloadCapture"] = None


class WorkloadCapture:
    """Records live broker traffic into the workload schema.  Use as a
    context manager; while installed, every ``RequestBroker.submit`` /
    ``cancel`` in this process lands here via the module hooks::

        with WorkloadCapture() as cap:
            ... serve traffic ...
        save_workload(path, cap.to_workload(), cap.meta())
    """

    def __init__(self) -> None:
        self._lock = named_lock("replay.capture")
        self._t0: Optional[float] = None
        self._by_rid: Dict[str, Dict[str, Any]] = {}
        self._order: List[str] = []

    # hook targets — must never raise (they ride the submit path)

    def _note_submit(self, rid: str, t: float, prompt: Sequence[int],
                     max_new_tokens: Optional[int],
                     stop_token_ids: Sequence[int],
                     deadline_s: Optional[float],
                     temperature: Optional[float] = None,
                     tenant: Optional[str] = None,
                     slo_class: Optional[str] = None,
                     adapter: Optional[str] = None) -> None:
        with self._lock:
            if rid in self._by_rid:
                return  # failover resubmit of a captured request
            if self._t0 is None:
                self._t0 = t
            self._by_rid[rid] = {
                "offset_s": t - self._t0, "t": t,
                "prompt": [int(x) for x in prompt],
                "max_new_tokens": max_new_tokens,
                "stop_token_ids": tuple(int(x) for x in stop_token_ids),
                "deadline_s": deadline_s, "cancel_after_s": None,
                "temperature": temperature, "tenant": tenant,
                "slo_class": slo_class, "adapter": adapter,
            }
            self._order.append(rid)

    def _note_cancel(self, rid: str, t: float) -> None:
        with self._lock:
            rec = self._by_rid.get(rid)
            if rec is not None and rec["cancel_after_s"] is None:
                rec["cancel_after_s"] = max(0.0, t - rec["t"])

    # reading

    def __len__(self) -> int:
        with self._lock:
            return len(self._order)

    def to_workload(self) -> List[WorkloadRequest]:
        with self._lock:
            return [WorkloadRequest(
                offset_s=rec["offset_s"], prompt=list(rec["prompt"]),
                max_new_tokens=rec["max_new_tokens"],
                stop_token_ids=rec["stop_token_ids"],
                deadline_s=rec["deadline_s"],
                cancel_after_s=rec["cancel_after_s"], rid=rid,
                temperature=rec["temperature"], tenant=rec["tenant"],
                slo_class=rec["slo_class"], adapter=rec["adapter"])
                for rid in self._order
                for rec in (self._by_rid[rid],)]

    def meta(self) -> Dict[str, Any]:
        with self._lock:
            return {"source": "capture", "requests": len(self._order),
                    "captured_wall": time.time()}

    # installation

    def __enter__(self) -> "WorkloadCapture":
        global _capture
        with _capture_lock:
            if _capture is not None:
                raise RuntimeError("a WorkloadCapture is already installed")
            _capture = self
        return self

    def __exit__(self, *exc) -> None:
        global _capture
        with _capture_lock:
            if _capture is self:
                _capture = None


def note_submit(rid: str, t: float, prompt: Sequence[int],
                max_new_tokens: Optional[int],
                stop_token_ids: Sequence[int],
                deadline_s: Optional[float],
                temperature: Optional[float] = None,
                tenant: Optional[str] = None,
                slo_class: Optional[str] = None,
                adapter: Optional[str] = None) -> None:
    """Broker hook: record a submit into the installed capture (no-op —
    one dict lookup — when no capture is running)."""
    cap = _capture
    if cap is not None:
        try:
            cap._note_submit(rid, t, prompt, max_new_tokens,
                             stop_token_ids, deadline_s,
                             temperature=temperature, tenant=tenant,
                             slo_class=slo_class, adapter=adapter)
        except Exception:  # noqa: BLE001 — must never break the submit path
            pass


def note_cancel(rid: str, t: float) -> None:
    """Broker hook: record a cancel against a captured submit."""
    cap = _capture
    if cap is not None:
        try:
            cap._note_cancel(rid, t)
        except Exception:  # noqa: BLE001
            pass


# ---------------------------------------------------------------------------
# seeded heavy-tail synthesis
# ---------------------------------------------------------------------------


def synthesize_workload(seed: int = 0, num_requests: int = 32,
                        mean_rate_rps: float = 8.0,
                        gamma_shape: float = 0.5,
                        num_templates: int = 4, template_len: int = 12,
                        suffix_len: int = 4, zipf_a: float = 1.5,
                        vocab: int = 250,
                        max_new_tokens: int = 8,
                        cancel_fraction: float = 0.0,
                        deadline_s: Optional[float] = None,
                        tenants: int = 0,
                        sampled_fraction: float = 0.0,
                        sampled_temperature: float = 0.7,
                        resume_fraction: float = 0.0,
                        idle_gap_s: float = 0.0,
                        adapters: int = 0,
                        adapter_zipf_a: float = 1.2,
                        adapter_base_fraction: float = 0.0
                        ) -> Tuple[Dict[str, Any], List[WorkloadRequest]]:
    """Seeded synthetic workload with production-shaped structure:

    * **Gamma(shape < 1) interarrivals** — burstier than Poisson (CV =
      1/sqrt(shape)), the heavy-tail arrival process serving tails come
      from;
    * **bounded-Zipf template reuse** — each prompt is a shared template
      prefix (picked with probability ∝ 1/rank^a) plus a unique suffix,
      so prefix-cache hit structure is part of the workload;
    * **geometric generation budgets** capped at ``max_new_tokens``;
    * optional **cancels** on a seeded fraction of requests;
    * optional **tenants** — requests carry a uniform ``tenant{i}`` label
      (per-tenant goodput accounting needs labeled traffic);
    * optional **per-request sampling** — a seeded ``sampled_fraction``
      of requests carries ``sampled_temperature`` while the rest stays
      greedy, so one batch mixes both lanes of the per-row sampler;
    * optional **session idle/resume** — ``resume_fraction`` appends a
      second wave of requests, each re-issuing an earlier request's full
      prompt (plus a fresh suffix) after an ``idle_gap_s`` quiet period.
      This is the memory-pressure shape the paging tier exists for: the
      first wave's prefixes go cold during the gap (demoted under
      pressure), and the resume wave's hit rate measures whether
      demote-instead-of-evict kept those sessions resident.
    * optional **multi-adapter population** — ``adapters > 0`` assigns
      every request a bounded-Zipf-popular ``adapter{i}`` label (rank-1
      hot tenants dominate, a long tail stays cold — the S-LoRA paging
      shape), except a seeded ``adapter_base_fraction`` that stays on the
      shared base model (``adapter=None``).

    Deterministic: same arguments → identical workload.
    """
    import numpy as np

    if num_requests <= 0:
        raise WorkloadError("num_requests must be positive")
    rng = np.random.default_rng(seed)
    gaps = rng.gamma(gamma_shape, 1.0 / (mean_rate_rps * gamma_shape),
                     size=num_requests)
    offsets = np.concatenate([[0.0], np.cumsum(gaps[:-1])])
    templates = rng.integers(1, vocab + 1,
                             size=(num_templates, template_len))
    ranks = np.arange(1, num_templates + 1, dtype=float)
    weights = ranks ** (-zipf_a)
    weights /= weights.sum()
    picks = rng.choice(num_templates, size=num_requests, p=weights)
    # geometric budgets: mean ≈ max/2, clipped into [1, max] — a bounded
    # heavy-ish tail so batches mix short and long decodes
    budgets = np.minimum(
        max_new_tokens,
        1 + rng.geometric(min(1.0, 2.0 / max(2, max_new_tokens)),
                          size=num_requests))
    cancel_mask = rng.random(num_requests) < cancel_fraction
    tenant_picks = rng.integers(0, max(1, tenants), size=num_requests)
    sampled_mask = rng.random(num_requests) < sampled_fraction
    requests: List[WorkloadRequest] = []
    for i in range(num_requests):
        tpl = int(picks[i])
        suffix = rng.integers(1, vocab + 1, size=suffix_len)
        requests.append(WorkloadRequest(
            offset_s=float(offsets[i]),
            prompt=[int(t) for t in templates[tpl]] + [int(t)
                                                       for t in suffix],
            max_new_tokens=int(budgets[i]),
            deadline_s=deadline_s,
            cancel_after_s=(float(0.05 + 0.1 * rng.random())
                            if cancel_mask[i] else None),
            template=tpl,
            temperature=(float(sampled_temperature)
                         if sampled_mask[i] else None),
            tenant=(f"tenant{int(tenant_picks[i])}" if tenants else None)))
    # session idle/resume wave (all extra rng draws happen AFTER the base
    # wave's, so resume_fraction=0.0 reproduces historical workloads
    # byte-identically)
    num_resumes = int(round(resume_fraction * num_requests))
    if num_resumes > 0:
        last = float(offsets[-1])
        rgaps = rng.gamma(gamma_shape, 1.0 / (mean_rate_rps * gamma_shape),
                          size=num_resumes)
        roffsets = last + idle_gap_s + np.cumsum(rgaps)
        parents = rng.integers(0, num_requests, size=num_resumes)
        rbudgets = np.minimum(
            max_new_tokens,
            1 + rng.geometric(min(1.0, 2.0 / max(2, max_new_tokens)),
                              size=num_resumes))
        for j in range(num_resumes):
            parent = requests[int(parents[j])]
            suffix = rng.integers(1, vocab + 1, size=suffix_len)
            requests.append(WorkloadRequest(
                offset_s=float(roffsets[j]),
                prompt=list(parent.prompt) + [int(t) for t in suffix],
                max_new_tokens=int(rbudgets[j]),
                deadline_s=deadline_s,
                template=parent.template))
    # multi-adapter population (again all rng draws AFTER every prior
    # wave's, so adapters=0 reproduces historical workloads byte-
    # identically).  Popularity is bounded-Zipf over adapter rank, same
    # construction as the template reuse above.
    if adapters > 0:
        aranks = np.arange(1, adapters + 1, dtype=float)
        aweights = aranks ** (-adapter_zipf_a)
        aweights /= aweights.sum()
        apicks = rng.choice(adapters, size=len(requests), p=aweights)
        base_mask = rng.random(len(requests)) < adapter_base_fraction
        for i, req in enumerate(requests):
            if not base_mask[i]:
                req.adapter = f"adapter{int(apicks[i])}"
    meta = {"source": "synthetic", "seed": seed,
            "requests": num_requests, "mean_rate_rps": mean_rate_rps,
            "gamma_shape": gamma_shape, "num_templates": num_templates,
            "template_len": template_len, "suffix_len": suffix_len,
            "zipf_a": zipf_a, "vocab": vocab,
            "max_new_tokens": max_new_tokens,
            "cancel_fraction": cancel_fraction, "tenants": tenants,
            "sampled_fraction": sampled_fraction,
            "resume_fraction": resume_fraction, "idle_gap_s": idle_gap_s,
            "adapters": adapters, "adapter_zipf_a": adapter_zipf_a,
            "adapter_base_fraction": adapter_base_fraction}
    return meta, requests


# ---------------------------------------------------------------------------
# chaos schedules
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """Arm a ``utils/faults`` spec inside one replica mid-replay."""

    at_s: float
    replica: int
    spec: Dict[str, str]


def parse_chaos(text: Optional[str]) -> List[ChaosEvent]:
    """Parse ``AT_S:REPLICA:SITE=KIND[:ARG][@HIT][;SITE=...]`` events,
    comma-separated — e.g. ``"0.5:0:serving.worker.hardkill=exit"`` kills
    replica 0's worker at its first heartbeat after t=0.5s."""
    events: List[ChaosEvent] = []
    for part in (text or "").split(","):
        part = part.strip()
        if not part:
            continue
        try:
            at, replica, spec_text = part.split(":", 2)
            pairs = (p for p in spec_text.split(";") if p.strip())
            spec = dict(p.split("=", 1) for p in pairs)
            events.append(ChaosEvent(at_s=float(at), replica=int(replica),
                                     spec={k.strip(): v.strip()
                                           for k, v in spec.items()}))
        except (ValueError, TypeError):
            raise WorkloadError(
                f"malformed chaos event {part!r} "
                "(want AT_S:REPLICA:SITE=KIND[;SITE=KIND])")
    return sorted(events, key=lambda e: e.at_s)


def _deliver_chaos(pool, event: ChaosEvent) -> None:
    """Arm the event's fault spec: subprocess replicas get it over the
    ``fault`` protocol op (fires inside the worker), in-process replicas
    arm the process-wide injector."""
    replica = pool.replicas[event.replica]
    inject = getattr(replica, "inject_fault", None)
    if inject is not None:
        inject(event.spec)
    else:
        from ..utils import faults

        faults.configure(event.spec)


# ---------------------------------------------------------------------------
# open-loop replay driver
# ---------------------------------------------------------------------------


def _pct(samples: Sequence[float], q: float) -> Optional[float]:
    if not samples:
        return None
    xs = sorted(samples)
    idx = min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))
    return xs[idx]


_TERMINAL_OK = ("length", "stop")


def replay_workload(pool, workload: Sequence[WorkloadRequest],
                    time_scale: float = 1.0,
                    chaos: Sequence[ChaosEvent] = (),
                    queue_sample_interval_s: float = 0.05,
                    token_timeout_s: float = 300.0) -> Dict[str, Any]:
    """Replay a workload open-loop against a started ``ReplicaPool``.

    Arrivals follow the workload's offsets scaled by ``time_scale``
    (0.5 → twice as fast) regardless of completions — the honest way to
    observe queueing.  Returns ``{"summary": ..., "requests": [...]}``
    where each request record carries its delivered token list (the
    determinism oracle: same seed + greedy decode → identical streams).
    """
    from ..serving.broker import RequestFailedError

    reqs = sorted(workload, key=lambda r: r.offset_s)
    n = len(reqs)
    results: List[Optional[Dict[str, Any]]] = [None] * n
    qdepth: List[int] = []
    stop_sampling = threading.Event()

    def _sampler() -> None:
        while not stop_sampling.wait(queue_sample_interval_s):
            try:
                qdepth.append(int(pool.queue_depth()))
            except Exception:  # noqa: BLE001 — a dying replica mid-chaos
                pass

    def _consume(i: int, handle, submit_t: float) -> None:
        toks: List[int] = []
        ttft: Optional[float] = None
        tpots: List[float] = []
        last = submit_t
        outcome, ok = "done", True
        try:
            for tok in handle.tokens(timeout=token_timeout_s):
                now = time.monotonic()
                if ttft is None:
                    ttft = now - submit_t
                else:
                    tpots.append(now - last)
                last = now
                toks.append(int(tok))
            outcome = handle.finish_reason or "done"
        except RequestFailedError as e:
            outcome, ok = e.reason, False
        except Exception as e:  # noqa: BLE001 — queue.Empty timeout etc.
            outcome, ok = f"error: {type(e).__name__}", False
        results[i] = {
            "index": i, "rid": handle.rid, "outcome": outcome,
            "ok": ok and outcome in _TERMINAL_OK + ("cancelled", "done"),
            "tokens": toks, "ttft_s": ttft,
            "tpot_s": tpots, "e2e_s": time.monotonic() - submit_t,
        }

    sampler = threading.Thread(target=_sampler, name="dstpu-replay-qdepth",
                               daemon=True)
    sampler.start()
    consumers: List[threading.Thread] = []
    timers: List[threading.Timer] = []
    chaos_left = list(chaos)
    t0 = time.monotonic()
    try:
        for i, r in enumerate(reqs):
            target = t0 + r.offset_s * time_scale
            while chaos_left and \
                    t0 + chaos_left[0].at_s * time_scale <= target:
                ev = chaos_left.pop(0)
                delay = t0 + ev.at_s * time_scale - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                _deliver_chaos(pool, ev)
            delay = target - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            submit_t = time.monotonic()
            try:
                # adapter only when labeled, so adapter-free workloads
                # keep working against pools without adapter support
                extra = {"adapter": r.adapter} if r.adapter else {}
                handle = pool.submit(
                    r.prompt, max_new_tokens=r.max_new_tokens,
                    deadline_s=r.deadline_s,
                    stop_token_ids=r.stop_token_ids,
                    temperature=r.temperature,
                    tenant=r.tenant, slo_class=r.slo_class, **extra)
            except Exception as e:  # noqa: BLE001 — QueueFull/NoReplica
                results[i] = {
                    "index": i, "rid": None,
                    "outcome": f"rejected: {type(e).__name__}", "ok": False,
                    "tokens": [], "ttft_s": None, "tpot_s": [],
                    "e2e_s": 0.0, "rejected": True,
                }
                continue
            th = threading.Thread(target=_consume,
                                  args=(i, handle, submit_t),
                                  name=f"dstpu-replay-{i}", daemon=True)
            th.start()
            consumers.append(th)
            if r.cancel_after_s is not None:
                timer = threading.Timer(r.cancel_after_s * time_scale,
                                        handle.cancel)
                timer.daemon = True
                timer.start()
                timers.append(timer)
        # any chaos scheduled after the last arrival still fires
        for ev in chaos_left:
            delay = t0 + ev.at_s * time_scale - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            _deliver_chaos(pool, ev)
        for th in consumers:
            th.join(timeout=token_timeout_s)
    finally:
        for timer in timers:
            timer.cancel()
        stop_sampling.set()
        sampler.join(timeout=5.0)
    wall_s = time.monotonic() - t0
    recs = [r if r is not None else
            {"index": i, "rid": None, "outcome": "lost", "ok": False,
             "tokens": [], "ttft_s": None, "tpot_s": [], "e2e_s": wall_s}
            for i, r in enumerate(results)]
    return {"summary": summarize_replay(recs, qdepth, wall_s),
            "requests": recs}


def summarize_replay(records: Sequence[Dict[str, Any]],
                     qdepth: Sequence[int],
                     wall_s: float) -> Dict[str, Any]:
    """TTFT/TPOT/e2e/goodput/queue-depth percentile summary — the metric
    dict the SLO gate checks.  Percentiles over empty sample sets are
    ``None`` (and gating them is an :class:`SLOError`, never a pass)."""
    n = len(records)
    completed = [r for r in records if r["outcome"] in _TERMINAL_OK]
    cancelled = [r for r in records if r["outcome"] == "cancelled"]
    rejected = [r for r in records if r.get("rejected")]
    failed = [r for r in records
              if not r["ok"] and not r.get("rejected")]
    ttfts = [r["ttft_s"] for r in records if r["ttft_s"] is not None]
    tpots = [t for r in records for t in r["tpot_s"]]
    e2es = [r["e2e_s"] for r in completed]
    tokens_out = sum(len(r["tokens"]) for r in records)

    def _ms(v: Optional[float]) -> Optional[float]:
        return None if v is None else round(v * 1e3, 3)

    return {
        "requests": n,
        "completed": len(completed),
        "cancelled": len(cancelled),
        "rejected": len(rejected),
        "failed": len(failed),
        "completed_fraction": round(len(completed) / n, 4) if n else 0.0,
        "wall_s": round(wall_s, 3),
        "goodput_rps": round(len(completed) / wall_s, 3) if wall_s else 0.0,
        "tokens_out": tokens_out,
        "tokens_per_s": round(tokens_out / wall_s, 2) if wall_s else 0.0,
        "ttft_ms_p50": _ms(_pct(ttfts, 0.50)),
        "ttft_ms_p95": _ms(_pct(ttfts, 0.95)),
        "ttft_ms_p99": _ms(_pct(ttfts, 0.99)),
        "tpot_ms_p50": _ms(_pct(tpots, 0.50)),
        "tpot_ms_p95": _ms(_pct(tpots, 0.95)),
        "tpot_ms_p99": _ms(_pct(tpots, 0.99)),
        "e2e_ms_p50": _ms(_pct(e2es, 0.50)),
        "e2e_ms_p95": _ms(_pct(e2es, 0.95)),
        "queue_depth_p50": _pct(list(qdepth), 0.50),
        "queue_depth_p95": _pct(list(qdepth), 0.95),
        "queue_depth_max": max(qdepth) if qdepth else None,
    }


# ---------------------------------------------------------------------------
# SLO gate (contract modeled on analysis/budgets.py)
# ---------------------------------------------------------------------------


class SLOError(ValueError):
    """Malformed SLO file or vacuous gate (metric missing from summary)."""


@dataclasses.dataclass(frozen=True)
class SLOViolation:
    workload: str
    check: str
    limit: Any
    actual: Any

    def __str__(self) -> str:
        return (f"[{self.workload}] {self.check}: actual {self.actual} "
                f"violates SLO {self.limit}")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


#: ``max_<metric>`` is a ceiling on summary[<metric>], ``min_<metric>`` a
#: floor; ``description`` is a context anchor.  Anything else is a typo —
#: and a typo'd gate that never fires is worse than no gate.
_SLO_KEYS = {
    "description",
    "max_ttft_ms_p50", "max_ttft_ms_p95", "max_ttft_ms_p99",
    "max_tpot_ms_p50", "max_tpot_ms_p95", "max_tpot_ms_p99",
    "max_e2e_ms_p50", "max_e2e_ms_p95",
    "min_goodput_rps", "min_tokens_per_s",
    "min_completed_fraction", "max_failed", "max_rejected",
    "max_queue_depth_p95", "max_queue_depth_max",
    # memory-pressure paging scenario (bench --mode replay --paging):
    # resume-wave hit rate with the pager on, its gain over the evict-only
    # baseline on the identical seeded workload, sessions still resident
    # across the idle gap, promote latency, and the leak gate
    "min_hit_rate_under_pressure", "min_hit_rate_gain",
    "min_sessions_resident", "max_promote_ms_p95", "max_leaked_blocks",
    # multi-adapter serving scenario (bench --mode adapters): mixed-batch
    # token identity vs dedicated single-adapter engines, adapter promote
    # latency, device residency ceiling, and the registry leak gate
    "max_token_mismatches", "max_adapter_promote_ms_p95",
    "max_resident_adapters", "max_leaked_adapters", "min_adapter_hit_rate",
    # crash-durable warm-state scenario (bench --mode replay --restart):
    # blocks the respawned generation adopted from its predecessor's cold
    # store, resume-wave hit rate and its gain over the cold-respawn arm
    # on the identical seeded workload, and the worker-process leak gate
    "min_rehydrated_blocks", "min_restart_hit_rate", "min_restart_hit_gain",
    "max_leaked_procs",
}


def default_slo_path() -> str:
    return os.path.join(os.path.dirname(__file__), "slo.toml")


def load_slos(path: Optional[str] = None) -> Dict[str, Dict[str, Any]]:
    """Load and validate ``slo.toml``; returns {workload: slo table}."""
    import tomllib

    path = path or default_slo_path()
    with open(path, "rb") as f:
        data = tomllib.load(f)
    workloads = data.get("workloads")
    if not isinstance(workloads, dict) or not workloads:
        raise SLOError(f"{path}: missing [workloads.\"<name>\"] tables")
    for name, table in workloads.items():
        if not isinstance(table, dict):
            raise SLOError(f"{path}: workloads.{name} is not a table")
        unknown = set(table) - _SLO_KEYS
        if unknown:
            raise SLOError(
                f"{path}: unknown SLO key(s) {sorted(unknown)} for "
                f"workload {name!r}; known keys: {sorted(_SLO_KEYS)}")
        for key, limit in table.items():
            if key == "description":
                continue
            if isinstance(limit, bool) or not isinstance(limit, (int, float)):
                raise SLOError(
                    f"{path}: workloads.{name}.{key} must be a number")
    return workloads


def check_slo(summary: Dict[str, Any], slo: Dict[str, Any],
              workload: str) -> List[SLOViolation]:
    """Compare a replay summary against one workload's SLO table.  A
    gated metric that is absent or ``None`` (e.g. no TTFT samples) raises
    :class:`SLOError` — an SLO must never pass vacuously."""
    violations: List[SLOViolation] = []
    for key, limit in slo.items():
        if key == "description":
            continue
        metric = key[4:]
        if metric not in summary or summary[metric] is None:
            raise SLOError(
                f"SLO for {workload!r} gates {metric!r} but the replay "
                f"summary has {summary.get(metric)!r} — an SLO must never "
                f"pass vacuously")
        actual = summary[metric]
        if key.startswith("max_"):
            if actual > limit:
                violations.append(
                    SLOViolation(workload, metric, limit, actual))
        else:  # min_
            if actual < limit:
                violations.append(
                    SLOViolation(workload, metric, limit, actual))
    return violations
