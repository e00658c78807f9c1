"""Offered-load sweep against the HTTP serving front (the port of
``deepspeed_tpu/serving/bench.py``).

Drives the real deployment end to end — server subprocess (via
``launch_server_subprocess``), HTTP clients, streaming responses — at a
ladder of offered request rates, and records client-observed p50/p95 TTFT,
end-to-end latency, delivered tokens/s, and 429 backpressure counts.  The
other modes replay seeded workloads at a replica pool (prefix, spec,
paging, restart, adapters, replica classes, the autoscaled remote fleet)
and time the mixed-GEMM kernel against the dequantize-then-matmul path it
replaces.  Every engine, in-process or in a server subprocess, runs on
the card unless ``--device cpu`` is given.  Results merge into a JSON file
under ``build/`` (git-ignored) unless ``--out`` names another path.

    python -m deepspeed_tpu_torch.serving.bench --mode serving --rates 2,8
    python -m deepspeed_tpu_torch.serving.bench --mode gemm --device cpu
"""

from __future__ import annotations

import http.client
import json
import os
import shlex
import threading
import time
from typing import List, Optional, Sequence

from ..utils.locks import named_lock
from .metrics import _percentile
from .server import launch_server_subprocess, stop_server

#: kernel vs dequantize-then-matmul in its numerics, per element:
#: |k - p| <= atol * max|p| + rtol * |p|.  Both sum the same bf16 products
#: in f32 in another order and round to bf16, so an element may round one
#: bf16 ulp (at most 2**-7 of its size) the other way, and an element
#: near 0 keeps the sums' f32 rounding, which scales with the output's
#: magnitude (unit-normal weights, as the sweep draws, make outputs ~sqrt(K))
GEMM_TOL = (1e-4, 1e-2)
#: a server subprocess's budget to come up: its replicas import torch,
#: create a CUDA context and draw their weights (an 8B model: ~20 s)
SPAWN_S = 600.0
#: where results merge unless ``--out`` says otherwise: the checkout's
#: git-ignored ``build/``
DEFAULT_OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "serving_bench.json")


def _one_request(host: str, port: int, prompt: List[int], max_tokens: int,
                 out: dict, lock: threading.Lock) -> None:
    t0 = time.monotonic()
    try:
        conn = http.client.HTTPConnection(host, port, timeout=120)
        conn.request("POST", "/v1/completions",
                     json.dumps({"prompt": prompt, "max_tokens": max_tokens,
                                 "stream": True}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status == 429:
            resp.read()
            with lock:
                out["rejected"] += 1
            return
        if resp.status != 200:
            resp.read()
            with lock:
                out["failed"] += 1
            return
        ttft = None
        ntok = 0
        for raw in resp:
            raw = raw.strip()
            if not raw.startswith(b"data: "):
                continue
            data = raw[6:]
            if data == b"[DONE]":
                break
            if json.loads(data)["choices"][0].get("token") is not None:
                if ttft is None:
                    ttft = time.monotonic() - t0
                ntok += 1
        conn.close()
        with lock:
            out["completed"] += 1
            out["tokens"] += ntok
            if ttft is not None:
                out["ttft_s"].append(ttft)
            out["e2e_s"].append(time.monotonic() - t0)
    except Exception:
        with lock:
            out["failed"] += 1


def sweep_point(host: str, port: int, rate_rps: float, duration_s: float,
                max_tokens: int, prompt_len: int,
                prompt_fn=None) -> dict:
    """Open-loop offered load: launch requests on a fixed arrival schedule
    regardless of completions (the honest way to observe backpressure).
    ``prompt_fn(i)`` overrides prompt construction (prefix-heavy mode)."""
    out = {"completed": 0, "rejected": 0, "failed": 0, "tokens": 0,
           "ttft_s": [], "e2e_s": []}
    lock = named_lock("bench.stats")
    threads = []
    n = int(rate_rps * duration_s)
    t0 = time.monotonic()
    for i in range(n):
        target = t0 + i / rate_rps
        delay = target - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        prompt = prompt_fn(i) if prompt_fn is not None else \
            [1 + (7 * i + j) % 250 for j in range(prompt_len)]
        th = threading.Thread(target=_one_request,
                              args=(host, port, prompt, max_tokens, out, lock))
        th.start()
        threads.append(th)
    for th in threads:
        th.join(timeout=180)
    wall = time.monotonic() - t0
    return {
        "offered_rps": rate_rps,
        "requests": n,
        "completed": out["completed"],
        "rejected_429": out["rejected"],
        "failed": out["failed"],
        "goodput_rps": round(out["completed"] / wall, 2),
        "tokens_per_s": round(out["tokens"] / wall, 1),
        "ttft_s_p50": round(_percentile(out["ttft_s"], 0.50), 4),
        "ttft_s_p95": round(_percentile(out["ttft_s"], 0.95), 4),
        "e2e_s_p50": round(_percentile(out["e2e_s"], 0.50), 4),
        "e2e_s_p95": round(_percentile(out["e2e_s"], 0.95), 4),
    }


def run_sweep(rates: List[float], duration_s: float = 8.0,
              max_tokens: int = 8, prompt_len: int = 6,
              replicas: int = 2, max_queue: int = 16,
              env: Optional[dict] = None, device: str = "cuda",
              engine_argv: Sequence[str] = ("--model", "tiny")) -> dict:
    """``engine_argv``: the server's engine flags (model, dtype, engine
    geometry), run on ``device``.  The server gets SPAWN_S to come up."""
    proc, base_url = launch_server_subprocess(
        [*engine_argv, "--device", device, "--port", "0", "--replicas",
         str(replicas), "--max_queue", str(max_queue)], env=env,
        timeout_s=SPAWN_S)
    host, port = base_url.rsplit("//", 1)[1].rsplit(":", 1)
    port = int(port)
    try:
        # warm the first launches so the sweep measures serving
        warm = {"completed": 0, "rejected": 0, "failed": 0, "tokens": 0,
                "ttft_s": [], "e2e_s": []}
        _one_request(host, port, [1, 2, 3], 4, warm, named_lock("bench.stats"))
        points = [sweep_point(host, port, r, duration_s, max_tokens,
                              prompt_len) for r in rates]
    finally:
        rc = stop_server(proc)
    return {
        "subject": f"{' '.join(engine_argv)} on {device}, streaming "
                   "/v1/completions",
        "replicas": replicas, "max_queue": max_queue,
        "max_tokens": max_tokens, "prompt_len": prompt_len,
        "duration_s_per_point": duration_s,
        "graceful_shutdown_rc": rc,
        "sweep": points,
    }


# -- prefix-heavy traffic mode ---------------------------------------------


def _get_json(host: str, port: int, path: str) -> dict:
    conn = http.client.HTTPConnection(host, port, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    return json.loads(body)


def _prefix_health(host: str, port: int) -> dict:
    """Sum the per-replica prefix stats + load gauges off /healthz."""
    health = _get_json(host, port, "/healthz")
    agg = {"running": 0, "queue_depth": 0}
    for rep in health.get("replicas", []):
        agg["running"] += rep["running"]
        agg["queue_depth"] += rep["queue_depth"]
        for k, v in rep.get("prefix", {}).items():
            agg[k] = agg.get(k, 0) + v
    return agg


def _await_idle(host: str, port: int, timeout_s: float = 90.0) -> dict:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        h = _prefix_health(host, port)
        if h["running"] == 0 and h["queue_depth"] == 0:
            return h
        time.sleep(0.2)
    return _prefix_health(host, port)


def run_prefix_sweep(rates: List[float], duration_s: float = 6.0,
                     max_tokens: int = 8, shared_prefix_len: int = 192,
                     suffix_len: int = 4, tenants: int = 2,
                     replicas: int = 1, max_queue: int = 32,
                     repeats: int = 6, env: Optional[dict] = None,
                     device: str = "cuda") -> dict:
    """Prefix-heavy traffic (tenant templates sharing a long prefix + a
    short unique suffix) with the cache on vs off.  Records the TTFT
    sweep per mode, the TTFT of a fully-cached prompt (same prompt
    repeated sequentially — the cache-on side skips its whole prefill),
    server-side hit/eviction stats, and the post-drain leak check."""
    templates = [[1 + (17 * t + 3 * j) % 250
                  for j in range(shared_prefix_len)] for t in range(tenants)]
    probe = templates[0] + [251 + t % 2 for t in range(suffix_len)]
    modes = {}
    for mode, extra in (("cache_off", []),
                        ("cache_on", ["--enable_prefix_cache"])):
        proc, base_url = launch_server_subprocess(
            ["--model", "tiny", "--device", device, "--port", "0",
             "--replicas", str(replicas), "--max_queue", str(max_queue),
             "--max_tokens_per_step", "32", *extra], env=env)
        host, port = base_url.rsplit("//", 1)[1].rsplit(":", 1)
        port = int(port)
        try:
            # warm + (cache_on) populate the radix tree per template
            warm = {"completed": 0, "rejected": 0, "failed": 0, "tokens": 0,
                    "ttft_s": [], "e2e_s": []}
            _one_request(host, port, probe, max_tokens, warm,
                         named_lock("bench.stats"))
            for tpl in templates:
                _one_request(host, port, tpl + [252] * suffix_len, max_tokens,
                             warm, named_lock("bench.stats"))
            ttfts: List[float] = []
            for _ in range(repeats):
                m = {"completed": 0, "rejected": 0, "failed": 0, "tokens": 0,
                     "ttft_s": [], "e2e_s": []}
                _one_request(host, port, probe, max_tokens, m,
                             named_lock("bench.stats"))
                ttfts.extend(m["ttft_s"])

            def prompt_fn(i):
                tpl = templates[i % len(templates)]
                return tpl + [1 + (13 * i + j) % 250
                              for j in range(suffix_len)]

            points = [sweep_point(host, port, r, duration_s, max_tokens,
                                  shared_prefix_len + suffix_len,
                                  prompt_fn=prompt_fn) for r in rates]
            idle = _await_idle(host, port)
        finally:
            rc = stop_server(proc)
        modes[mode] = {
            "fully_cached_ttft_s_p50": round(_percentile(ttfts, 0.50), 4),
            "fully_cached_ttft_s_mean": round(sum(ttfts) / len(ttfts), 4)
            if ttfts else 0.0,
            "sweep": points,
            "server_prefix_stats_after": {
                k: round(float(v), 4) for k, v in idle.items()},
            "leaked_blocks_after_drain": idle.get("pinned_blocks", 0),
            "graceful_shutdown_rc": rc,
        }
    off = modes["cache_off"]["fully_cached_ttft_s_p50"]
    on = modes["cache_on"]["fully_cached_ttft_s_p50"]
    return {
        "subject": f"tiny model on {device}, streaming /v1/completions,"
                   " tenant-template prefix-heavy traffic",
        "replicas": replicas, "max_queue": max_queue,
        "max_tokens": max_tokens, "shared_prefix_len": shared_prefix_len,
        "suffix_len": suffix_len, "tenants": tenants,
        "duration_s_per_point": duration_s,
        "fully_cached_ttft_speedup": round(off / on, 2) if on else 0.0,
        "modes": modes,
    }


# -- speculative-decoding mode ---------------------------------------------


def _stream_probe(host: str, port: int, prompt: List[int],
                  max_tokens: int) -> Optional[dict]:
    """One streaming request; returns client-observed TTFT, token count and
    the first→last token interval (the decode phase TPOT window)."""
    try:
        conn = http.client.HTTPConnection(host, port, timeout=300)
        t0 = time.monotonic()
        conn.request("POST", "/v1/completions",
                     json.dumps({"prompt": prompt, "max_tokens": max_tokens,
                                 "stream": True}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            resp.read()
            return None
        t_first = t_last = None
        ntok = 0
        for raw in resp:
            raw = raw.strip()
            if not raw.startswith(b"data: "):
                continue
            data = raw[6:]
            if data == b"[DONE]":
                break
            if json.loads(data)["choices"][0].get("token") is not None:
                t_last = time.monotonic()
                if t_first is None:
                    t_first = t_last
                ntok += 1
        conn.close()
        if t_first is None:
            return None
        return {"ttft_s": t_first - t0, "ntok": ntok,
                "decode_s": t_last - t_first}
    except Exception:
        return None


def _decode_rate_point(host: str, port: int, streams: int, max_tokens: int,
                       prompt_len: int, repeats: int) -> dict:
    """Closed-loop decode throughput at a fixed concurrency: ``streams``
    simultaneous streaming requests, repeated; decode tokens/s excludes the
    prefill phase (first→last token window), so this is the number
    speculation is supposed to multiply."""
    agg_rates: List[float] = []
    tpots: List[float] = []
    ttfts: List[float] = []
    for rep in range(repeats):
        results: List[Optional[dict]] = [None] * streams
        threads = []
        for i in range(streams):
            prompt = [1 + (7 * (i + streams * rep) + j) % 250
                      for j in range(prompt_len)]

            def worker(i=i, prompt=prompt):
                results[i] = _stream_probe(host, port, prompt, max_tokens)

            th = threading.Thread(target=worker)
            th.start()
            threads.append(th)
        for th in threads:
            th.join(timeout=300)
        good = [r for r in results if r is not None and r["ntok"] > 1
                and r["decode_s"] > 0]
        if good:
            agg_rates.append(sum((r["ntok"] - 1) / r["decode_s"]
                                 for r in good))
            tpots.extend(r["decode_s"] / (r["ntok"] - 1) for r in good)
            ttfts.extend(r["ttft_s"] for r in good)
    return {
        "streams": streams,
        "decode_tokens_per_s": round(
            sum(agg_rates) / len(agg_rates), 1) if agg_rates else 0.0,
        "tpot_s_p50": round(_percentile(tpots, 0.50), 5),
        "ttft_s_p50": round(_percentile(ttfts, 0.50), 4),
    }


def _spec_health(host: str, port: int) -> dict:
    """Sum the per-replica speculative-decoding stats off /healthz."""
    health = _get_json(host, port, "/healthz")
    agg: dict = {}
    for rep in health.get("replicas", []):
        for k, v in rep.get("spec", {}).items():
            agg[k] = agg.get(k, 0) + v
    proposed = agg.get("proposed_tokens", 0)
    agg["acceptance_rate"] = round(
        agg.get("accepted_tokens", 0) / proposed, 4) if proposed else 0.0
    return agg


def run_spec_sweep(rates: List[float], duration_s: float = 6.0,
                   max_tokens: int = 48, prompt_len: int = 6,
                   spec_k: int = 4, spec_train_steps: int = 0,
                   batch_sizes: List[int] = (1, 4, 8),
                   repeats: int = 4, max_queue: int = 32,
                   env: Optional[dict] = None, device: str = "cuda") -> dict:
    """Speculation on vs off, one replica (speedups must not hide behind
    replica parallelism).  Per mode: closed-loop decode tokens/s at batch
    1..8, plus an offered-load sweep.  The draft mode runs with draft ==
    target (same preset + seed) — the acceptance-rate UPPER BOUND for a
    draft of this architecture.  self_draft defaults to UNTRAINED
    lm-head-seeded heads: the bench subject is a random-init tiny model, so
    its greedy continuations are self-repeating attractors that the
    next-token warm start already proposes near-optimally, while startup
    self-distillation can only memorize the rollout set (measured: trained
    0.30-0.39 acceptance vs 0.58 untrained).  On a real checkpoint pass
    ``spec_train_steps`` > 0."""
    mode_flags = {
        "off": [],
        "self_draft": ["--spec_mode", "self_draft", "--spec_k", str(spec_k),
                       "--spec_train_steps", str(spec_train_steps)],
        "draft": ["--spec_mode", "draft", "--spec_k", str(spec_k)],
    }
    modes = {}
    for mode, extra in mode_flags.items():
        proc, base_url = launch_server_subprocess(
            ["--model", "tiny", "--device", device, "--port", "0",
             "--replicas", "1", "--max_queue", str(max_queue),
             "--max_seqs", "8", *extra], env=env)
        host, port = base_url.rsplit("//", 1)[1].rsplit(":", 1)
        port = int(port)
        try:
            # warm: one request per distinct path (prefill + spec)
            _stream_probe(host, port, [1, 2, 3], 8)
            batches = [_decode_rate_point(host, port, b, max_tokens,
                                          prompt_len, repeats)
                       for b in batch_sizes]
            points = [sweep_point(host, port, r, duration_s, max_tokens,
                                  prompt_len) for r in rates]
            _await_idle(host, port)
            spec_stats = _spec_health(host, port)
        finally:
            rc = stop_server(proc)
        modes[mode] = {
            "batch": batches,
            "sweep": points,
            "server_spec_stats_after": {
                k: round(float(v), 4) for k, v in spec_stats.items()},
            "graceful_shutdown_rc": rc,
        }
    speedups = {}
    for mode in ("self_draft", "draft"):
        speedups[mode] = {
            f"batch_{b['streams']}": round(
                b["decode_tokens_per_s"] / off_b["decode_tokens_per_s"], 2)
            if off_b["decode_tokens_per_s"] else 0.0
            for b, off_b in zip(modes[mode]["batch"], modes["off"]["batch"])}
    return {
        "subject": f"tiny model on {device}, streaming /v1/completions,"
                   " decode tokens/s measured over the first->last token"
                   " window (prefill excluded), 1 replica",
        "spec_k": spec_k, "spec_train_steps": spec_train_steps,
        "max_tokens": max_tokens, "prompt_len": prompt_len,
        "duration_s_per_point": duration_s,
        "draft_model_note": "draft == target (same preset+seed): acceptance "
                            "upper bound for this architecture",
        "self_draft_note": "untrained lm-head-seeded heads (spec_train_steps"
                           f"={spec_train_steps}): optimal for the "
                           "random-init tiny subject whose continuations "
                           "are self-repeating; distill on real checkpoints",
        "decode_speedup_vs_off": speedups,
        "modes": modes,
    }


# -- trace-driven replay with SLO gates -------------------------------------


def run_replay(workload_trace: Optional[str] = None, seed: int = 0,
               requests: int = 24, rate_rps: float = 8.0,
               cancel_fraction: float = 0.0,
               transport: str = "inprocess", replicas: int = 2,
               time_scale: float = 1.0, chaos: Optional[str] = None,
               slo_path: Optional[str] = None,
               slo_workload: Optional[str] = None,
               model: str = "tiny", max_queue: int = 64,
               save_trace: Optional[str] = None,
               autoscale_min: int = 0, autoscale_max: int = 0,
               replica_classes: Optional[str] = None,
               tenants: int = 0, template_len: int = 12,
               max_new_tokens: int = 8, ab_repeats: int = 1,
               device: str = "cuda") -> dict:
    """Replay a workload trace (recorded JSONL or seeded synthesis) against
    a fresh replica pool — driven at the pool, not over HTTP, so the same
    seed reproduces arrival schedule AND token streams exactly — then gate
    the TTFT/TPOT/goodput/queue-depth summary against ``slo.toml``.

    ``transport="remote"`` runs the loopback-TCP fleet (dial-in workers
    against the registry); with ``autoscale_max > 0`` it also runs the
    goodput autoscaler between ``autoscale_min`` and ``autoscale_max``
    replicas and reports its decisions in the result's ``autoscale`` key
    (the load phase should show >=1 scale-up, the post-drain idle >=1
    scale-down).

    ``replica_classes`` (e.g. ``"prefill,decode"``) runs the SAME workload
    twice — once phase-disaggregated, once all-mixed at equal replica
    count — and records the decode TPOT p99 delta (disagg − mixed; the
    number Splitwise-style splitting is supposed to push ≤ 0, since decode
    steps no longer queue behind prompt-heavy prefills); ``ab_repeats``
    repeats the disagg/mixed pair and reports the per-pair median delta
    (single-run p99s on shared CI machines are noise-dominated).
    ``tenants`` > 0 labels synthesized traffic ``tenant0..N-1`` and
    reports the per-tenant goodput ledger; ``template_len`` /
    ``max_new_tokens`` shape the synthesized prompts and budgets (long
    templates + bimodal budgets make the prefill/decode phase split
    non-trivial).

    The result carries ``slo_violations`` (named-key diffs); ``main``
    turns a non-empty list into a nonzero exit."""
    import argparse

    from ..observability import replay as rp
    from .balancer import ReplicaPool
    from .config import ServingConfig, parse_replica_classes
    from .server import (add_engine_cli_args, add_serving_cli_args,
                         build_engine_factory, engine_argv_from_args,
                         serving_argv_from_config)

    if workload_trace:
        meta, wl = rp.load_workload(workload_trace)
        slo_workload = slo_workload or "replay-default"
    else:
        meta, wl = rp.synthesize_workload(seed=seed, num_requests=requests,
                                          mean_rate_rps=rate_rps,
                                          cancel_fraction=cancel_fraction,
                                          tenants=tenants,
                                          template_len=template_len,
                                          max_new_tokens=max_new_tokens)
        slo_workload = slo_workload or "synthetic-smoke"
    if save_trace:
        rp.save_workload(save_trace, wl, meta)
    slos = rp.load_slos(slo_path)
    if slo_workload not in slos:
        raise rp.SLOError(f"no [workloads.\"{slo_workload}\"] table in "
                          f"{slo_path or rp.default_slo_path()}; have "
                          f"{sorted(slos)}")
    slot_classes = parse_replica_classes(replica_classes)

    # small fixed engine geometry: big enough for the synthetic prompts
    # (16 tok) + budgets (≤8 tok), small enough to build fast on the CPU
    ep = argparse.ArgumentParser()
    add_engine_cli_args(ep)
    add_serving_cli_args(ep)
    eargs = ep.parse_args([
        "--model", model, "--device", device, "--seed", "0", "--num_blocks", "64",
        "--max_tokens_per_step", "32", "--max_seqs", "4",
        "--block_size", "8", "--max_blocks_per_seq", "8",
        "--max_queue", str(max_queue)])
    autoscaling = transport == "remote" and autoscale_max > 0
    start_replicas = max(1, autoscale_min) if autoscaling else replicas

    def one_run(classes) -> dict:
        cfg = ServingConfig(max_queue=max_queue,
                            num_replicas=start_replicas,
                            replica_transport=transport,
                            replica_classes=tuple(classes),
                            heartbeat_interval_s=0.2,
                            heartbeat_timeout_s=2.0,
                            respawn_backoff_s=0.2, submit_timeout_s=120.0,
                            spawn_timeout_s=300.0,
                            autoscale_min=max(1, autoscale_min),
                            autoscale_max=autoscale_max,
                            # replay load phases last seconds, so the
                            # scaling thresholds must react inside one
                            # phase: low pressure bar, sub-second
                            # debounce, short idle
                            autoscale_interval_s=0.25,
                            scale_up_pressure=6.0, scale_up_debounce_s=0.5,
                            scale_down_pressure=1.0, scale_down_idle_s=2.0)
        if transport in ("subprocess", "remote"):
            worker_argv = (engine_argv_from_args(eargs)
                           + serving_argv_from_config(cfg))
            if transport == "remote":
                pool = ReplicaPool.build_remote(worker_argv, cfg)
            else:
                pool = ReplicaPool.build_subprocess(worker_argv, cfg)
        else:
            pool = ReplicaPool.build(build_engine_factory(eargs), cfg)
        pool.start()
        pool.wait_ready()
        autoscaler = None
        if autoscaling:
            from .autoscaler import Autoscaler
            autoscaler = Autoscaler(pool, cfg).start()
        leaked_blocks = leaked_procs = 0
        autoscale_report = None
        try:
            # warm every replica (one concurrent request per replica:
            # least-outstanding routing spreads them) so the replay's TTFT
            # percentiles measure serving, not first launches
            warm = [pool.submit([1, 2, 3], max_new_tokens=2)
                    for _ in range(len(pool.replicas))]
            for h in warm:
                h.result(timeout=300)
            out = rp.replay_workload(pool, wl, time_scale=time_scale,
                                     chaos=rp.parse_chaos(chaos))
            # decode-phase TPOT: filter by the SAME classifier the router
            # uses, over the SAME workload in both A/B arms.  Aggregate
            # TPOT mixes in prefill-phase requests, whose inter-token
            # tail is prefill queueing — the traffic disaggregation
            # deliberately trades away, not the tail it protects
            decode_tpots = [
                t for i, r in enumerate(wl)
                if pool._request_phase(len(r.prompt),
                                       r.max_new_tokens) == "decode"
                for t in out["requests"][i]["tpot_s"]]
            # post-replay leak check while the pool is still up: any
            # pinned KV blocks left once nothing is running is a leak
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                if sum(t.num_running() for t in pool.replicas
                       if t.healthy()) == 0 and pool.queue_depth() == 0:
                    break
                time.sleep(0.2)
            leaked_blocks = int(sum(
                t.prefix_stats().get("pinned_blocks", 0)
                for t in pool.replicas if t.healthy()))
            if autoscaler is not None:
                # the fleet is idle now; give the autoscaler its idle
                # window so the post-drain scale-down shows up
                deadline = time.monotonic() + 30
                while time.monotonic() < deadline:
                    if autoscaler.decisions["down"] >= 1:
                        break
                    time.sleep(0.25)
                autoscale_report = {
                    "min": cfg.autoscale_min, "max": cfg.autoscale_max,
                    "decisions": dict(autoscaler.decisions),
                    "final_replicas": sum(
                        1 for t in pool.replicas if t.healthy()),
                }
        finally:
            pool.drain()
        if transport in ("subprocess", "remote"):
            leaked_procs = sum(
                1 for t in pool.replicas
                if getattr(t, "_proc", None) is not None
                and t._proc.poll() is None)
        return {
            "summary": out["summary"],
            "decode_tpot_ms_p99": round(
                _percentile(decode_tpots, 0.99) * 1e3, 3)
            if decode_tpots else None,
            "route_stats": dict(pool.route_stats),
            "autoscale": autoscale_report,
            "leaked_blocks": leaked_blocks,
            "leaked_procs": leaked_procs,
            "tenant_goodput": pool.metrics.tenant_snapshot(),
            "outcomes": {
                r["outcome"]: sum(1 for q in out["requests"]
                                  if q["outcome"] == r["outcome"])
                for r in out["requests"]},
        }

    disagg = one_run(slot_classes)
    summary = disagg["summary"]
    violations = rp.check_slo(summary, slos[slo_workload], slo_workload)
    result = {
        "subject": f"{model} model on {device}, open-loop replay "
                   f"driven at the ReplicaPool ({transport}, "
                   f"{start_replicas} replicas"
                   + (f", classes {','.join(slot_classes)}"
                      if slot_classes else "") + ")",
        "workload_meta": meta,
        "time_scale": time_scale,
        "chaos": chaos or None,
        "slo_workload": slo_workload,
        "summary": summary,
        "route_stats": disagg["route_stats"],
        "autoscale": disagg["autoscale"],
        "leaked_blocks_after_idle": disagg["leaked_blocks"],
        "leaked_worker_processes_after_drain": disagg["leaked_procs"],
        "slo_violations": [v.to_dict() for v in violations],
        "outcomes": disagg["outcomes"],
    }
    if tenants:
        result["tenant_goodput"] = disagg["tenant_goodput"]
    if slot_classes:
        # A/B on the identical workload: disagg already ran above; pair it
        # with an all-mixed run at equal replica count, and (ab_repeats > 1)
        # repeat the whole pair — a single p99 over a few dozen requests on
        # a shared CI box is one bad scheduler quantum away from either
        # sign, the per-pair median is the reportable number
        pairs = [(disagg, one_run(()))]
        for _ in range(max(1, ab_repeats) - 1):
            pairs.append((one_run(slot_classes), one_run(())))
        deltas = [round(d["decode_tpot_ms_p99"] - m["decode_tpot_ms_p99"], 3)
                  for d, m in pairs
                  if d["decode_tpot_ms_p99"] is not None
                  and m["decode_tpot_ms_p99"] is not None]
        result["replica_classes"] = list(slot_classes)
        result["mixed_baseline_summary"] = pairs[0][1]["summary"]
        result["decode_tpot_ms_p99"] = disagg["decode_tpot_ms_p99"]
        result["mixed_decode_tpot_ms_p99"] = pairs[0][1]["decode_tpot_ms_p99"]
        result["disagg_tpot_ms_p99_deltas"] = deltas
        result["disagg_tpot_ms_p99_delta"] = (
            sorted(deltas)[len(deltas) // 2] if deltas else None)
    return result


# -- serving memory hierarchy: paging under memory pressure ----------------


def run_paging_replay(seed: int = 0, requests: int = 24,
                      rate_rps: float = 8.0,
                      resume_fraction: float = 0.5,
                      idle_gap_s: float = 0.5,
                      time_scale: float = 1.0,
                      slo_path: Optional[str] = None,
                      slo_workload: str = "paging-smoke",
                      model: str = "tiny", max_queue: int = 64,
                      num_blocks: int = 28,
                      kv_host_pool_mb: int = 8,
                      kv_spill_dir: str = "",
                      kv_promote_ahead: bool = True,
                      device: str = "cuda") -> dict:
    """Memory-pressure A/B for the host-DRAM paging tier (``--paging``).

    One seeded session-idle/resume workload (``synthesize_workload`` with
    ``resume_fraction``: a base wave of sessions, a quiet gap, then a
    resume wave re-issuing earlier sessions' full prompts) replayed twice
    against a deliberately tiny device pool — once with the pager on
    (cold blocks demote to host DRAM / spill), once evict-only.  The
    device pool is sized well below the base wave's working set, so the
    baseline MUST forget sessions while the pager may not.

    Geometry is chosen so each session's prompt (template 20 + suffix 4
    tokens, block size 8) fills exactly 3 blocks: blocks 1-2 are the
    shared template head (hot in both legs), block 3 is unique per
    session (the cold tail the pager exists to keep).  Hit rate is
    therefore measured in TOKENS — resume-wave ``prefill_tokens_skipped``
    over resume-wave prompt tokens — because block-granular binary hits
    cannot distinguish "matched the shared template" from "matched the
    whole session".

    Records ``hit_rate_under_pressure`` (paging leg), ``hit_rate_gain``
    (paging − evict-only, the strictly-positive tentpole gate),
    ``sessions_resident`` (sessions' worth of KV blocks still held across
    all tiers at the idle point), promote-latency percentiles, leak
    counts, and a decode identity bit (paging is host-side only: a greedy
    request on a fresh engine emits the same tokens through the same
    kernel launches on/off) — gated by the ``paging-smoke`` table in
    slo.toml.
    """
    import argparse
    import dataclasses as _dc

    from ..observability import replay as rp
    from .balancer import ReplicaPool
    from .config import ServingConfig
    from .server import (add_engine_cli_args, add_serving_cli_args,
                         build_engine_factory)

    template_len, suffix_len, block_size = 20, 4, 8
    blocks_per_session = (template_len + suffix_len) // block_size
    meta, wl = rp.synthesize_workload(seed=seed, num_requests=requests,
                                      mean_rate_rps=rate_rps,
                                      num_templates=6,
                                      template_len=template_len,
                                      suffix_len=suffix_len,
                                      max_new_tokens=8,
                                      resume_fraction=resume_fraction,
                                      idle_gap_s=idle_gap_s)
    base, resume = wl[:requests], wl[requests:]
    if not resume:
        raise rp.WorkloadError("resume_fraction produced no resume wave")
    # the waves replay back to back with an explicit drain between them
    # (that drain IS the idle gap), so rebase the resume offsets to zero
    t_first = resume[0].offset_s
    resume = [_dc.replace(r, offset_s=r.offset_s - t_first) for r in resume]
    resume_prompt_tokens = sum(len(r.prompt) for r in resume)
    slos = rp.load_slos(slo_path)
    if slo_workload not in slos:
        raise rp.SLOError(f"no [workloads.\"{slo_workload}\"] table in "
                          f"{slo_path or rp.default_slo_path()}; have "
                          f"{sorted(slos)}")

    def eargs_for(paging: bool):
        argv = ["--model", model, "--device", device, "--seed", "0",
                "--num_blocks", str(num_blocks),
                "--max_tokens_per_step", "32", "--max_seqs", "4",
                "--block_size", str(block_size),
                "--max_blocks_per_seq", "8",
                "--max_queue", str(max_queue), "--enable_prefix_cache"]
        if paging:
            argv += ["--kv_host_pool_mb", str(kv_host_pool_mb)]
            if kv_spill_dir:
                argv += ["--kv_spill_dir", kv_spill_dir]
            if kv_promote_ahead:
                argv.append("--kv_promote_ahead")
        ep = argparse.ArgumentParser()
        add_engine_cli_args(ep)
        add_serving_cli_args(ep)
        return ep.parse_args(argv)

    def _wait_idle(pool, budget_s: float = 60.0) -> None:
        deadline = time.monotonic() + budget_s
        while time.monotonic() < deadline:
            if sum(t.num_running() for t in pool.replicas
                   if t.healthy()) == 0 and pool.queue_depth() == 0:
                return
            time.sleep(0.2)

    def one_leg(paging: bool) -> dict:
        # ONE replica: the A/B contrasts one engine's memory hierarchy,
        # not routing — splitting the waves over replicas would dilute
        # the pressure and make hits depend on the router
        cfg = ServingConfig(max_queue=max_queue, num_replicas=1,
                            replica_transport="inprocess",
                            submit_timeout_s=120.0)
        pool = ReplicaPool.build(build_engine_factory(eargs_for(paging)),
                                 cfg)
        pool.start()
        pool.wait_ready()
        try:
            pool.submit([1, 2, 3], max_new_tokens=2).result(timeout=300)
            out_base = rp.replay_workload(pool, base,
                                          time_scale=time_scale)
            _wait_idle(pool)
            s0 = pool.replicas[0].prefix_stats()
            resident = int(s0.get("tier_device_blocks", 0)
                           + s0.get("tier_host_blocks", 0)
                           + s0.get("tier_spill_blocks", 0))
            out_resume = rp.replay_workload(pool, resume,
                                            time_scale=time_scale)
            _wait_idle(pool)
            s1 = pool.replicas[0].prefix_stats()
            eng = pool.replicas[0].broker.engine
            if eng.prefix_cache is not None:
                eng.prefix_cache.check_consistency()
            promote_ms = (eng.pager.promote_wait_percentiles()
                          if eng.pager is not None
                          else {"p50": 0.0, "p95": 0.0, "p99": 0.0})
            pager_stats = (eng.pager.stats()
                           if eng.pager is not None else None)
            leaked = int(s1.get("pinned_blocks", 0))
        finally:
            pool.drain()
        recs = out_base["requests"] + out_resume["requests"]
        wall = (out_base["summary"]["wall_s"]
                + out_resume["summary"]["wall_s"])
        skipped = s1.get("prefill_tokens_skipped", 0) \
            - s0.get("prefill_tokens_skipped", 0)
        return {
            "summary": rp.summarize_replay(recs, [], wall),
            "resume_hit_token_rate": round(
                float(skipped) / max(1, resume_prompt_tokens), 6),
            "resume_tokens_skipped": int(skipped),
            "sessions_resident_at_idle": resident // blocks_per_session,
            "promote_ms": promote_ms,
            "pager": pager_stats,
            "leaked_blocks": leaked,
            "demotions": int(s1.get("demotions", 0)),
            "promotions": int(s1.get("promotions", 0)),
        }

    def _decode_trace(paging: bool) -> tuple:
        # the identity half of the acceptance bar: paging is entirely
        # host-side bookkeeping, so a greedy request through a fresh
        # engine must emit the same tokens through the same kernel
        # launches (and plain calls, on the CPU) with it on or off
        from ..ops.hopper import paged_attention as pa

        eng = build_engine_factory(eargs_for(paging))()
        pa.reset_counts()
        uid = eng.put(list(range(1, template_len + suffix_len + 1)),
                      max_new_tokens=8)
        toks = eng.generate_all()[uid]
        trace = (list(toks), dict(pa.LAUNCHES), dict(pa.PLAIN_CALLS))
        eng.close()
        return trace

    paging_leg = one_leg(True)
    evict_leg = one_leg(False)
    decode_identical = _decode_trace(True) == _decode_trace(False)

    summary = dict(paging_leg["summary"])
    summary["hit_rate_under_pressure"] = paging_leg["resume_hit_token_rate"]
    summary["hit_rate_gain"] = round(
        paging_leg["resume_hit_token_rate"]
        - evict_leg["resume_hit_token_rate"], 6)
    summary["sessions_resident"] = paging_leg["sessions_resident_at_idle"]
    summary["promote_ms_p95"] = paging_leg["promote_ms"]["p95"]
    summary["leaked_blocks"] = (paging_leg["leaked_blocks"]
                                + evict_leg["leaked_blocks"])
    violations = rp.check_slo(summary, slos[slo_workload], slo_workload)
    if not decode_identical:
        violations = list(violations) + [rp.SLOViolation(
            slo_workload, "decode_identical", True, False)]
    return {
        "subject": f"{model} model on {device}, session idle/resume "
                   f"replay, {num_blocks}-block device pool (~"
                   f"{num_blocks // blocks_per_session} sessions) vs "
                   f"{requests} base sessions — paging "
                   f"(host {kv_host_pool_mb} MiB"
                   + (f", spill {kv_spill_dir}" if kv_spill_dir else "")
                   + ") A/B evict-only on the identical seeded workload",
        "workload_meta": meta,
        "time_scale": time_scale,
        "slo_workload": slo_workload,
        "summary": summary,
        "hit_rate_under_pressure": summary["hit_rate_under_pressure"],
        "hit_rate_evict_only": evict_leg["resume_hit_token_rate"],
        "hit_rate_gain": summary["hit_rate_gain"],
        "sessions_resident": summary["sessions_resident"],
        "sessions_resident_evict_only":
            evict_leg["sessions_resident_at_idle"],
        "promote_ms": paging_leg["promote_ms"],
        "pager": paging_leg["pager"],
        "demotions": paging_leg["demotions"],
        "promotions": paging_leg["promotions"],
        "decode_identical": decode_identical,
        "evict_only_summary": evict_leg["summary"],
        "leaked_blocks_after_idle": summary["leaked_blocks"],
        "slo_violations": [v.to_dict() for v in violations],
    }


# -- crash-durable warm state: restart rehydration A/B ---------------------


def run_restart_replay(seed: int = 0, requests: int = 12,
                       rate_rps: float = 8.0,
                       resume_fraction: float = 0.5,
                       idle_gap_s: float = 0.5,
                       time_scale: float = 1.0,
                       slo_path: Optional[str] = None,
                       slo_workload: str = "rehydrate-smoke",
                       model: str = "tiny", max_queue: int = 64,
                       num_blocks: int = 20,
                       kv_host_pool_bytes: int = 65536,
                       state_root: str = "", device: str = "cuda") -> dict:
    """Restart-rehydration A/B for the crash-durable cold tier
    (``--restart``).

    The same seeded session/resume workload runs twice against a ONE-
    replica subprocess pool under device+host memory pressure (tiny
    device pool, a host pool of a few blocks, so demoted blocks overflow
    into the bottom tier).  Between the base and resume waves the worker process
    is SIGKILLed — no unwinding, no flush — and the supervisor respawns
    it.  The rehydrate arm gives the worker a ``--kv_coldstore_dir``
    root, so the respawned generation re-adopts its predecessor's
    manifest-verified cold entries before serving; the cold-respawn arm
    has no durable tier and comes back empty.

    Records ``rehydrated_blocks`` (adopted by the new generation, the
    tentpole gate), resume-wave hit-token rates for both arms and their
    gain (rehydrate − cold respawn), resume-wave ``token_mismatches``
    between the arms (greedy decode: a rehydrated prefix must never
    change tokens, only skip prefill), and the post-drain process leak
    count — gated by the ``rehydrate-smoke`` table in slo.toml.
    """
    import argparse
    import dataclasses as _dc
    import shutil
    import tempfile

    from ..observability import replay as rp
    from .balancer import ReplicaPool
    from .config import ServingConfig
    from .server import (add_engine_cli_args, add_serving_cli_args,
                         engine_argv_from_args, serving_argv_from_config)

    template_len, suffix_len, block_size = 20, 4, 8
    meta, wl = rp.synthesize_workload(seed=seed, num_requests=requests,
                                      mean_rate_rps=rate_rps,
                                      num_templates=6,
                                      template_len=template_len,
                                      suffix_len=suffix_len,
                                      max_new_tokens=8,
                                      resume_fraction=resume_fraction,
                                      idle_gap_s=idle_gap_s)
    base, resume = wl[:requests], wl[requests:]
    if not resume:
        raise rp.WorkloadError("resume_fraction produced no resume wave")
    t_first = resume[0].offset_s
    resume = [_dc.replace(r, offset_s=r.offset_s - t_first) for r in resume]
    resume_prompt_tokens = sum(len(r.prompt) for r in resume)
    slos = rp.load_slos(slo_path)
    if slo_workload not in slos:
        raise rp.SLOError(f"no [workloads.\"{slo_workload}\"] table in "
                          f"{slo_path or rp.default_slo_path()}; have "
                          f"{sorted(slos)}")

    def _eargs(coldstore_dir: str):
        argv = ["--model", model, "--device", device, "--seed", "0",
                "--num_blocks", str(num_blocks),
                "--max_tokens_per_step", "32", "--max_seqs", "4",
                "--block_size", str(block_size),
                "--max_blocks_per_seq", "8",
                "--max_queue", str(max_queue), "--enable_prefix_cache",
                "--kv_host_pool_bytes", str(kv_host_pool_bytes),
                "--kv_promote_ahead"]
        if coldstore_dir:
            argv += ["--kv_coldstore_dir", coldstore_dir]
        ep = argparse.ArgumentParser()
        add_engine_cli_args(ep)
        add_serving_cli_args(ep)
        return ep.parse_args(argv)

    def _wait_idle(pool, budget_s: float = 60.0) -> None:
        deadline = time.monotonic() + budget_s
        while time.monotonic() < deadline:
            if sum(t.num_running() for t in pool.replicas
                   if t.healthy()) == 0 and pool.queue_depth() == 0:
                return
            time.sleep(0.2)

    def one_leg(coldstore_dir: str) -> dict:
        # ONE subprocess replica: the A/B contrasts what one worker's
        # warm state survives across a hard kill, not routing — and the
        # kill must be a real SIGKILL against a real process
        cfg = ServingConfig(max_queue=max_queue, num_replicas=1,
                            replica_transport="subprocess",
                            heartbeat_interval_s=0.2,
                            heartbeat_timeout_s=2.0,
                            respawn_backoff_s=0.2,
                            submit_timeout_s=120.0,
                            spawn_timeout_s=300.0)
        worker_argv = (engine_argv_from_args(_eargs(coldstore_dir))
                       + serving_argv_from_config(cfg))
        pool = ReplicaPool.build_subprocess(worker_argv, cfg)
        pool.start()
        pool.wait_ready()
        leaked_procs = 0
        try:
            pool.submit([1, 2, 3], max_new_tokens=2).result(timeout=300)
            out_base = rp.replay_workload(pool, base,
                                          time_scale=time_scale)
            _wait_idle(pool)
            t = pool.replicas[0]
            gen0 = t.generation
            t._proc.kill()  # SIGKILL: no atexit, no flush, no unwinding
            deadline = time.monotonic() + 300
            while time.monotonic() < deadline:
                if t.generation > gen0 and t.healthy():
                    break
                time.sleep(0.2)
            else:
                raise RuntimeError(
                    f"replica did not respawn within budget "
                    f"(generation {t.generation}, healthy {t.healthy()})")
            # warm the new process's first launches so resume latencies
            # measure serving, then snapshot the post-respawn stats
            pool.submit([1, 2, 3], max_new_tokens=2).result(timeout=300)
            s0 = t.prefix_stats()
            out_resume = rp.replay_workload(pool, resume,
                                            time_scale=time_scale)
            _wait_idle(pool)
            s1 = t.prefix_stats()
        finally:
            pool.drain()
        leaked_procs = sum(
            1 for r in pool.replicas
            if getattr(r, "_proc", None) is not None
            and r._proc.poll() is None)
        skipped = s1.get("prefill_tokens_skipped", 0) \
            - s0.get("prefill_tokens_skipped", 0)
        return {
            "base_summary": out_base["summary"],
            "resume_summary": out_resume["summary"],
            "resume_tokens": [r["tokens"] for r in out_resume["requests"]],
            "resume_ok": [bool(r["ok"]) for r in out_resume["requests"]],
            "resume_hit_token_rate": round(
                float(skipped) / max(1, resume_prompt_tokens), 6),
            "rehydrated_blocks": int(s0.get("rehydrated_blocks", 0)),
            "coldstore_entries": int(s1.get("coldstore_entries", 0)),
            "coldstore_corrupt_dropped":
                int(s1.get("coldstore_corrupt_dropped", 0)),
            "generations": t.generation + 1,
            "leaked_procs": leaked_procs,
        }

    root = state_root or tempfile.mkdtemp(prefix="dstpu-rehydrate-bench-")
    try:
        rehydrate_leg = one_leg(root)
        cold_leg = one_leg("")
    finally:
        if not state_root:
            shutil.rmtree(root, ignore_errors=True)

    # greedy decode: a rehydrated prefix may only SKIP prefill, never
    # change tokens — compare resume streams pairwise where both arms
    # delivered a terminal-ok stream
    mismatches = sum(
        1 for a, b, oka, okb in zip(rehydrate_leg["resume_tokens"],
                                    cold_leg["resume_tokens"],
                                    rehydrate_leg["resume_ok"],
                                    cold_leg["resume_ok"])
        if oka and okb and a != b)

    summary = dict(rehydrate_leg["resume_summary"])
    summary["rehydrated_blocks"] = rehydrate_leg["rehydrated_blocks"]
    summary["restart_hit_rate"] = rehydrate_leg["resume_hit_token_rate"]
    summary["restart_hit_gain"] = round(
        rehydrate_leg["resume_hit_token_rate"]
        - cold_leg["resume_hit_token_rate"], 6)
    summary["token_mismatches"] = mismatches
    summary["leaked_procs"] = (rehydrate_leg["leaked_procs"]
                               + cold_leg["leaked_procs"])
    violations = rp.check_slo(summary, slos[slo_workload], slo_workload)
    return {
        "subject": f"{model} model on {device}, session kill/respawn "
                   f"replay: SIGKILL the single subprocess replica between "
                   f"the base and resume waves ({num_blocks}-block device "
                   f"pool, host {kv_host_pool_bytes} B) — cold-store "
                   "rehydration A/B cold respawn on the identical seeded "
                   "workload",
        "workload_meta": meta,
        "time_scale": time_scale,
        "slo_workload": slo_workload,
        "summary": summary,
        "rehydrated_blocks": summary["rehydrated_blocks"],
        "restart_hit_rate": summary["restart_hit_rate"],
        "restart_hit_rate_cold_respawn": cold_leg["resume_hit_token_rate"],
        "restart_hit_gain": summary["restart_hit_gain"],
        "token_mismatches": mismatches,
        "coldstore_entries": rehydrate_leg["coldstore_entries"],
        "coldstore_corrupt_dropped":
            rehydrate_leg["coldstore_corrupt_dropped"],
        "generations": rehydrate_leg["generations"],
        "base_summary": rehydrate_leg["base_summary"],
        "cold_respawn_summary": cold_leg["resume_summary"],
        "leaked_worker_processes_after_drain": summary["leaked_procs"],
        "slo_violations": [v.to_dict() for v in violations],
    }


# -- multi-tenant adapter serving ------------------------------------------


def run_adapter_bench(seed: int = 0, requests: int = 32,
                      rate_rps: float = 8.0,
                      num_adapters: int = 5, adapter_slots: int = 4,
                      adapter_rank: int = 4,
                      adapter_base_fraction: float = 0.25,
                      time_scale: float = 1.0,
                      slo_path: Optional[str] = None,
                      slo_workload: str = "adapters-smoke",
                      model: str = "tiny", max_queue: int = 64,
                      device: str = "cuda") -> dict:
    """Multi-tenant adapter serving A/B (``--mode adapters``).

    One seeded Zipf-popular ``num_adapters``-adapter workload (long-tail
    tenants over one shared base, a seeded fraction staying on the base)
    replayed against a single mixed-adapter replica whose registry has
    MORE adapters registered than device slots — so the run must page
    (resident count bounded by ``adapter_slots - 1``) and must not leak a
    ref after drain.  Every request's greedy token stream is then compared
    against a dedicated **always-merged** engine for its adapter — the
    deployment you'd run without multi-adapter serving: one engine per
    tenant with the adapter folded into the weights
    (``runtime/checkpoint/engine.merge_adapter_pack``, the registry-pack
    export path) — and base-labeled requests against the plain base
    engine.  ``token_mismatches`` counts requests whose streams differ;
    the ``adapters-smoke`` SLO table gates it at zero alongside promote
    p95, resident-adapter count, hit rate, and the leak check.
    """
    import argparse
    import dataclasses as _dc
    import shutil
    import tempfile

    import numpy as np

    from ..inference.v2.engine import (InferenceEngineV2,
                                       adapter_target_shapes)
    from ..models import transformer as tfm
    from ..observability import replay as rp
    from ..runtime.checkpoint.engine import merge_adapter_pack
    from .adapters import load_adapter_pack, publish_adapter
    from .balancer import ReplicaPool
    from .config import ServingConfig
    from .server import (add_engine_cli_args, add_serving_cli_args,
                         build_adapter_factory, build_engine_factory)

    meta, wl = rp.synthesize_workload(
        seed=seed, num_requests=requests, mean_rate_rps=rate_rps,
        max_new_tokens=8, adapters=num_adapters,
        adapter_base_fraction=adapter_base_fraction)
    slos = rp.load_slos(slo_path)
    if slo_workload not in slos:
        raise rp.SLOError(f"no [workloads.\"{slo_workload}\"] table in "
                          f"{slo_path or rp.default_slo_path()}; have "
                          f"{sorted(slos)}")

    # publish one adapter-only checkpoint per tenant — random factors big
    # enough (0.5-ish deltas) that each adapter's greedy continuations
    # demonstrably differ from the base's, with the LoRA scaling carried
    # by the manifest exactly as a PEFT training run would leave it
    model_cfg = tfm.get_config(model, dtype="bfloat16")
    shapes = adapter_target_shapes(model_cfg)
    L = model_cfg.num_layers
    store = tempfile.mkdtemp(prefix="dstpu-adapter-bench-")
    ckpts = {}
    for i in range(num_adapters):
        arng = np.random.default_rng(seed * 1000 + 17 + i)
        tree = {}
        for target, (K, N) in shapes.items():
            tree[target] = {
                "lora_a": (arng.standard_normal((L, K, adapter_rank))
                           / np.sqrt(K)).astype(np.float32),
                "lora_b": arng.standard_normal(
                    (L, adapter_rank, N)).astype(np.float32),
            }
        aid = f"adapter{i}"
        ckpts[aid] = publish_adapter(tree, store, aid, scaling=0.5)

    geometry = ["--model", model, "--device", device, "--seed", "0",
                "--num_blocks", "64",
                "--max_tokens_per_step", "32", "--max_seqs", "4",
                "--block_size", "8", "--max_blocks_per_seq", "8",
                "--max_queue", str(max_queue)]

    def parse(argv):
        ep = argparse.ArgumentParser()
        add_engine_cli_args(ep)
        add_serving_cli_args(ep)
        return ep.parse_args(argv)

    def _wait_idle(pool, budget_s: float = 60.0) -> None:
        deadline = time.monotonic() + budget_s
        while time.monotonic() < deadline:
            if sum(t.num_running() for t in pool.replicas
                   if t.healthy()) == 0 and pool.queue_depth() == 0:
                return
            time.sleep(0.2)

    # -- mixed-adapter leg: ONE replica, every tenant --------------------
    eargs = parse(geometry + [
        "--adapter_slots", str(adapter_slots),
        "--adapter_rank", str(adapter_rank),
        "--adapter_host_pool_mb", "64",
        "--adapter_preload",
        ",".join(f"{aid}={d}" for aid, d in sorted(ckpts.items()))])
    cfg = ServingConfig(max_queue=max_queue, num_replicas=1,
                        replica_transport="inprocess",
                        submit_timeout_s=120.0)
    pool = ReplicaPool.build(build_engine_factory(eargs), cfg,
                             adapter_factory=build_adapter_factory(eargs))
    pool.start()
    pool.wait_ready()
    try:
        pool.submit([1, 2, 3], max_new_tokens=2).result(timeout=300)
        out = rp.replay_workload(pool, wl, time_scale=time_scale)
        _wait_idle(pool)
        reg = pool.replicas[0].broker.adapters
        stats = reg.stats()
        promote_ms = reg.promote_wait_percentiles()
        summary_after = reg.summary()
        try:
            reg.check_leaks()
            leak_check_ok = True
        except AssertionError:
            leak_check_ok = False
        route_stats = dict(pool.route_stats)
    finally:
        pool.drain()

    # -- dedicated always-merged engines ---------------------------------
    # one engine per tenant, built from the SAME flag set as the mixed
    # replica minus the adapter machinery, so the base geometry is what an
    # adapter-free deployment runs; the base weights are the ones every
    # engine of the flag set draws (the factory's seeded draw)
    base_eng = build_engine_factory(parse(list(geometry)))()
    base_params = base_eng.params
    v2_plain = base_eng.cfg

    def dedicated_tokens(adapter_id, reqs) -> dict:
        if adapter_id is None:
            eng = base_eng
        else:
            pack = load_adapter_pack(ckpts[adapter_id], model_cfg,
                                     adapter_rank)
            params = merge_adapter_pack(base_params, pack)
            eng = InferenceEngineV2(base_eng.model_cfg, params, v2_plain,
                                    device=device)
        dpool = ReplicaPool.build(lambda: eng, _dc.replace(cfg))
        dpool.start()
        dpool.wait_ready()
        try:
            toks = {}
            for i, r in reqs:
                h = dpool.submit(r.prompt,
                                 max_new_tokens=r.max_new_tokens)
                toks[i] = [int(t) for t in h.tokens(timeout=300)]
        finally:
            dpool.drain()
        return toks

    by_adapter: dict = {}
    for i, r in enumerate(wl):
        by_adapter.setdefault(r.adapter, []).append((i, r))
    mismatches = []
    for adapter_id, reqs in sorted(by_adapter.items(),
                                   key=lambda kv: kv[0] or ""):
        oracle = dedicated_tokens(adapter_id, reqs)
        for i, _ in reqs:
            if out["requests"][i]["tokens"] != oracle[i]:
                mismatches.append({
                    "index": i, "adapter": adapter_id,
                    "mixed": out["requests"][i]["tokens"],
                    "dedicated": oracle[i]})
    shutil.rmtree(store, ignore_errors=True)

    hits, loads = stats["hits"], stats["loads"]
    summary = dict(out["summary"])
    summary["token_mismatches"] = len(mismatches)
    summary["adapter_promote_ms_p95"] = promote_ms["p95"]
    summary["resident_adapters"] = int(stats["resident"])
    summary["leaked_adapters"] = (int(stats["refs"])
                                  + (0 if leak_check_ok else 1))
    summary["adapter_hit_rate"] = round(
        hits / (hits + loads), 6) if (hits + loads) else 0.0
    violations = rp.check_slo(summary, slos[slo_workload], slo_workload)
    return {
        "subject": f"{model} model on {device}, {num_adapters} "
                   f"Zipf-popular adapters over {adapter_slots - 1} device "
                   "slots on 1 replica, greedy streams A/B'd per-request "
                   "against dedicated always-merged single-adapter engines",
        "workload_meta": meta,
        "slo_workload": slo_workload,
        "summary": summary,
        "token_mismatches": mismatches[:8],
        "adapter_requests": {a or "base": len(reqs)
                             for a, reqs in sorted(
                                 by_adapter.items(),
                                 key=lambda kv: kv[0] or "")},
        "registry_stats_after": {k: round(float(v), 4)
                                 for k, v in stats.items()},
        "registry_summary_after": summary_after,
        "promote_ms": promote_ms,
        "route_stats": route_stats,
        "leak_check_ok": leak_check_ok,
        "slo_violations": [v.to_dict() for v in violations],
    }


# -- mixed-GEMM kernel microbench ------------------------------------------


def _time_fn(fn, args, warmup: int, iters: int) -> float:
    """Mean seconds per call: CUDA events on the card (after ``warmup``
    calls), the host clock on the CPU."""
    import torch

    for _ in range(max(1, warmup)):
        fn(*args)
    on_card = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)
    if on_card:
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(max(1, iters)):
            fn(*args)
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / 1e3 / max(1, iters)
    t0 = time.perf_counter()
    for _ in range(max(1, iters)):
        fn(*args)
    return (time.perf_counter() - t0) / max(1, iters)


def run_gemm_sweep(ms=(1, 2, 4, 8, 64),
                   shapes=((256, 256), (256, 704), (704, 256)),
                   bits_list=(8, 4, 6), groups=(0, 128),
                   warmup=1, iters=3, tune_tiles=False, seed=0,
                   device: str = "cuda") -> dict:
    """Kernel-vs-fallback microbench for the port's mixed GEMM (B6).

    Sweeps bits × group × (M, N, K) — decode-shaped M=1..8 plus a prefill
    point — timing the in-kernel-dequant path (``mixed_gemm``: the CUDA
    kernel on the card, its plain version on the CPU) against the
    dequantize-then-``torch.matmul`` path it replaces (which materializes
    the full (K, N) weight every call).  Parity columns record
    kernel-vs-fallback max abs/rel error (the fallback rounds the whole
    weight to x's dtype; cuBLAS sums in its own order), and
    ``within_tol`` whether every element lies within ``GEMM_TOL`` (atol of
    the largest output, rtol) of dequantize-then-matmul in the kernel's
    numerics
    (``mixed_gemm_plain``: bf16 operands, f32 sums) — the portable
    signal; CPU timings only sanity-check plumbing, never perf.
    ``tune_tiles`` (the measured tile search) is ROADMAP.md A14's
    autotuner and refuses.

    The (N, K) defaults are the tiny flagship subject's projections:
    attention 256×256, MLP up 256→704, MLP down 704→256.
    """
    import numpy as np
    import torch

    from ..accelerator import resolve_device
    from ..ops.hopper import mixed_gemm as mg

    if tune_tiles:
        raise NotImplementedError(
            "tune_tiles: the measured GEMM tile search (autotuning/) "
            "arrives with ROADMAP.md A14")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    atol, rtol = GEMM_TOL
    cells = []
    # the fallback's bf16 matmul accumulates in f32, as the kernel does
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        for (k, n) in shapes:
            for bits in bits_list:
                for g in groups:
                    group = k if g == 0 else g
                    if k % group:
                        continue  # quantizer would shrink it: no new cell
                    w = torch.from_numpy(rng.standard_normal(
                        (k, n)).astype(np.float32)).to(dev)
                    qw = mg.quantize_gemm_weight(w, bits=bits, group=group)
                    del w
                    for m in ms:
                        x = torch.from_numpy(rng.standard_normal(
                            (m, k)).astype(np.float32)).to(
                                dev, torch.bfloat16)

                        def kern(xx, q):
                            return mg.mixed_gemm(xx, q)

                        def orac(xx, q):
                            return xx @ mg.dequantize_gemm_weight(q).to(
                                xx.dtype)

                        y_k = kern(x, qw).float()
                        y_o = orac(x, qw).float()
                        y_p = mg.mixed_gemm_plain(x, qw).float()
                        err = float((y_k - y_o).abs().max())
                        ref = float(y_o.abs().max()) or 1.0
                        cell = {
                            "m": m, "n": n, "k": k, "bits": bits,
                            "group": int(qw.group),
                            "kernel_s": round(
                                _time_fn(kern, (x, qw), warmup, iters), 6),
                            "dequant_dot_s": round(
                                _time_fn(orac, (x, qw), warmup, iters), 6),
                            "max_abs_err": round(err, 6),
                            "rel_err": round(err / ref, 6),
                            "within_tol": bool(
                                ((y_k - y_p).abs()
                                 <= atol * y_p.abs().max()
                                 + rtol * y_p.abs()).all()),
                        }
                        cell["kernel_speedup"] = round(
                            cell["dequant_dot_s"] / cell["kernel_s"], 3) \
                            if cell["kernel_s"] else 0.0
                        cells.append(cell)
                    del qw
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            reduced
    return {
        "subject": f"random W{{bits}}A16 problems on {dev.type}; x bf16, "
                   "scales f32",
        "note": "on the CPU mixed_gemm runs its plain version — CPU timings "
                "check plumbing only; the parity columns (kernel vs "
                "dequantize-then-matmul) are the portable signal, speedups "
                "are only meaningful on the card",
        "tol": [atol, rtol],
        "warmup": warmup, "iters": iters, "tile_tuning": False,
        "cells": cells,
    }


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="dstpu-serving-bench")
    p.add_argument("--out", default=DEFAULT_OUT,
                   help="merge results into this JSON file (default: "
                        f"{DEFAULT_OUT}, git-ignored)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where every engine runs, in-process or in a "
                        "server subprocess: the card by default (an error "
                        "without CUDA), or the CPU")
    p.add_argument("--server_args", default="--model tiny",
                   help="serving: the server subprocess's engine flags "
                        "(model, dtype, geometry), shell-split")
    p.add_argument("--mode",
                   choices=["serving", "prefix", "spec", "gemm", "replay",
                            "adapters"],
                   default="serving")
    p.add_argument("--rates", default="2,8,24")
    p.add_argument("--duration_s", type=float, default=8.0)
    p.add_argument("--replicas", type=int, default=None)
    p.add_argument("--max_queue", type=int, default=None)
    p.add_argument("--shared_prefix_len", type=int, default=192)
    p.add_argument("--tenants", type=int, default=2)
    p.add_argument("--spec_k", type=int, default=4)
    p.add_argument("--spec_train_steps", type=int, default=0)
    p.add_argument("--gemm_ms", default="1,2,4,8,64",
                   help="comma-separated M values for --mode gemm")
    p.add_argument("--gemm_bits", default="8,4,6")
    p.add_argument("--gemm_iters", type=int, default=3)
    p.add_argument("--tune_tiles", action="store_true",
                   help="run the measured tile search per gemm cell "
                        "(the autotuner: ROADMAP.md A14, refused)")
    p.add_argument("--workload_trace", default=None,
                   help="replay: recorded workload JSONL (default: seeded "
                        "synthesis)")
    p.add_argument("--seed", type=int, default=0,
                   help="replay: synthesis seed")
    p.add_argument("--requests", type=int, default=24,
                   help="replay: synthesized request count")
    p.add_argument("--cancel_fraction", type=float, default=0.0,
                   help="replay: synthesized cancel fraction")
    p.add_argument("--transport",
                   choices=["inprocess", "subprocess", "remote"],
                   default="inprocess", help="replay: replica transport "
                   "(remote = loopback-TCP dial-in fleet)")
    p.add_argument("--autoscale_min", type=int, default=0,
                   help="replay --transport remote: autoscaler floor")
    p.add_argument("--autoscale_max", type=int, default=0,
                   help="replay --transport remote: autoscaler ceiling "
                        "(0 disables the autoscaler)")
    p.add_argument("--time_scale", type=float, default=1.0,
                   help="replay: arrival-schedule scale (0.5 = 2x faster)")
    p.add_argument("--chaos", default=None,
                   help="replay: chaos schedule, comma-separated "
                        "AT_S:REPLICA:SITE=KIND[;SITE=KIND] events")
    p.add_argument("--slo", default=None,
                   help="replay: slo.toml path (default: the packaged one)")
    p.add_argument("--slo_workload", default=None,
                   help="replay: [workloads.\"<name>\"] table to gate "
                        "against")
    p.add_argument("--save_trace", default=None,
                   help="replay: also save the replayed workload as JSONL")
    p.add_argument("--replica_classes", default=None,
                   help="replay: per-slot classes (e.g. 'prefill,decode') — "
                        "runs the workload disaggregated AND all-mixed and "
                        "records the decode TPOT p99 delta")
    p.add_argument("--ab_repeats", type=int, default=1,
                   help="replay --replica_classes: repeat the disagg/mixed "
                        "pair this many times and report the median delta")
    p.add_argument("--template_len", type=int, default=12,
                   help="replay: synthesized prompt-template length")
    p.add_argument("--max_new_tokens", type=int, default=8,
                   help="replay: synthesized generation-budget cap")
    p.add_argument("--paging", action="store_true",
                   help="replay: memory-pressure session-resume A/B for "
                        "the host-DRAM paging tier (tiny device pool; "
                        "paging vs evict-only on the identical seeded "
                        "workload, gated by the paging-smoke SLO table)")
    p.add_argument("--restart", action="store_true",
                   help="replay: kill/respawn A/B for the crash-durable "
                        "cold tier (SIGKILL the subprocess replica between "
                        "the base and resume waves; rehydrate vs cold "
                        "respawn on the identical seeded workload, gated "
                        "by the rehydrate-smoke SLO table)")
    p.add_argument("--state_root", default="",
                   help="replay --restart: cold-store root for the "
                        "rehydrate arm (default: a temp dir, removed "
                        "afterwards)")
    p.add_argument("--resume_fraction", type=float, default=0.5,
                   help="replay --paging: resume-wave size as a fraction "
                        "of the base wave")
    p.add_argument("--idle_gap_s", type=float, default=0.5,
                   help="replay --paging: quiet period between the base "
                        "and resume waves")
    p.add_argument("--kv_host_pool_mb", type=int, default=8,
                   help="replay --paging: host-DRAM pool for the paging "
                        "leg")
    p.add_argument("--kv_spill_dir", default="",
                   help="replay --paging: also exercise the disk spill "
                        "tier (safetensors files in this directory)")
    p.add_argument("--num_adapters", type=int, default=5,
                   help="adapters: distinct Zipf-popular adapters in the "
                        "synthesized workload")
    p.add_argument("--adapter_slots", type=int, default=4,
                   help="adapters: device adapter slots (incl. the null "
                        "slot) — fewer usable slots than adapters forces "
                        "paging")
    p.add_argument("--adapter_rank", type=int, default=4,
                   help="adapters: LoRA rank of the published adapters")
    p.add_argument("--adapter_base_fraction", type=float, default=0.25,
                   help="adapters: fraction of requests staying on the "
                        "shared base model")
    args = p.parse_args(argv)
    if os.path.basename(args.out) == "BENCH_EVIDENCE.json":
        p.error("--out: BENCH_EVIDENCE.json is the reference's evidence "
                "file; write the port's results elsewhere")
    dev = args.device

    rates = [float(r) for r in args.rates.split(",")]
    if args.mode == "adapters":
        result = run_adapter_bench(
            seed=args.seed, requests=args.requests, rate_rps=rates[0],
            num_adapters=args.num_adapters,
            adapter_slots=args.adapter_slots,
            adapter_rank=args.adapter_rank,
            adapter_base_fraction=args.adapter_base_fraction,
            time_scale=args.time_scale, slo_path=args.slo,
            slo_workload=args.slo_workload or "adapters-smoke",
            max_queue=args.max_queue or 64, device=dev)
        key = "adapters"
    elif args.mode == "replay" and args.restart:
        result = run_restart_replay(
            seed=args.seed, requests=args.requests, rate_rps=rates[0],
            resume_fraction=args.resume_fraction,
            idle_gap_s=args.idle_gap_s, time_scale=args.time_scale,
            slo_path=args.slo,
            slo_workload=args.slo_workload or "rehydrate-smoke",
            max_queue=args.max_queue or 64,
            state_root=args.state_root, device=dev)
        key = "rehydrate"
    elif args.mode == "replay" and args.paging:
        result = run_paging_replay(
            seed=args.seed, requests=args.requests, rate_rps=rates[0],
            resume_fraction=args.resume_fraction,
            idle_gap_s=args.idle_gap_s, time_scale=args.time_scale,
            slo_path=args.slo,
            slo_workload=args.slo_workload or "paging-smoke",
            max_queue=args.max_queue or 64,
            kv_host_pool_mb=args.kv_host_pool_mb,
            kv_spill_dir=args.kv_spill_dir, device=dev)
        key = "paging"
    elif args.mode == "replay":
        result = run_replay(
            workload_trace=args.workload_trace, seed=args.seed,
            requests=args.requests, rate_rps=rates[0],
            cancel_fraction=args.cancel_fraction, transport=args.transport,
            replicas=args.replicas or 2, time_scale=args.time_scale,
            chaos=args.chaos, slo_path=args.slo,
            slo_workload=args.slo_workload,
            max_queue=args.max_queue or 64, save_trace=args.save_trace,
            autoscale_min=args.autoscale_min,
            autoscale_max=args.autoscale_max,
            replica_classes=args.replica_classes, tenants=args.tenants,
            template_len=args.template_len,
            max_new_tokens=args.max_new_tokens,
            ab_repeats=args.ab_repeats, device=dev)
        key = "replay"
    elif args.mode == "gemm":
        result = run_gemm_sweep(
            ms=tuple(int(m) for m in args.gemm_ms.split(",")),
            bits_list=tuple(int(b) for b in args.gemm_bits.split(",")),
            iters=args.gemm_iters, tune_tiles=args.tune_tiles, device=dev)
        key = "mixed_gemm"
    elif args.mode == "spec":
        result = run_spec_sweep(
            rates, duration_s=args.duration_s, spec_k=args.spec_k,
            spec_train_steps=args.spec_train_steps,
            max_queue=args.max_queue or 32, device=dev)
        key = "spec_decode"
    elif args.mode == "prefix":
        result = run_prefix_sweep(
            rates, duration_s=args.duration_s,
            shared_prefix_len=args.shared_prefix_len, tenants=args.tenants,
            replicas=args.replicas or 1, max_queue=args.max_queue or 32,
            device=dev)
        key = "prefix_cache"
    else:
        result = run_sweep(rates, duration_s=args.duration_s,
                           replicas=args.replicas or 2,
                           max_queue=args.max_queue or 16, device=dev,
                           engine_argv=shlex.split(args.server_args))
        key = "serving"
    print(json.dumps(result, indent=2))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        try:
            with open(args.out) as f:
                evidence = json.load(f)
        except FileNotFoundError:
            evidence = {}
        evidence[key] = result
        with open(args.out, "w") as f:
            json.dump(evidence, f, indent=1)
            f.write("\n")
    if args.mode in ("replay", "adapters") and result["slo_violations"]:
        for v in result["slo_violations"]:
            print(f"SLO VIOLATION: [{v['workload']}] {v['check']}: "
                  f"actual {v['actual']} violates SLO {v['limit']}")
        return 1
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
