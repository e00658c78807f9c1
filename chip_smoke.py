#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--profile] [--out results.json]

In order it prints:

1. the card's name and power limit, as ``nvidia-smi`` gives them;
2. the kernels' build from ``deepspeed_tpu_torch/csrc`` (seconds, and
   ptxas' register / spill report);
3. each paged-attention kernel against its plain PyTorch version at
   llama3-8b attention shapes (H=32, KV=8, D=128, block 64): in bf16, max
   abs error and kernel / plain / library (SDPA) / bound times; then the
   same inputs in f32, max abs error only;
4. the engine: ``InferenceEngineV2`` at full llama3-8b width and depth with
   random bf16 weights from a seed, serving 8 requests (SplitFuse prefill,
   then burst decode), checking tokens, finiteness, kernel launch counts
   and determinism; and a small f32 model served on the card and on the
   CPU, whose greedy tokens must agree;
5. a JSON line with every kernel's numbers;
6. last, ``{"ok": true, "device": {...}}``.

Any failure exits non-zero without the last line.  Without CUDA, or
without the rest of the repository beside it, it fails at once.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time

SEED = 0
H, KV, D, BS = 32, 8, 128, 64  # llama3-8b attention
MB = 32  # max_blocks_per_seq of the engine phase: 2048 positions
NB = 512  # num_blocks of the engine phase
DECODE_CTX = [0, 1, 63, 64, 65, 700, 1500, 2048]
PREFILL_QP = 256
PREFILL_START = [0, 0, 17, 64, 100, 256, 700, 1000]
PREFILL_LEN = [256, 0, 100, 256, 1, 255, 37, 200]
PROMPT_LENS = [17, 64, 130, 256, 300, 511, 700, 1000]
NEW_TOKENS = 32
# kernel vs plain, |kernel - plain| <= atol + rtol * |plain| per element.
# bf16 output: both sides accumulate in f32 and differ only in summation
# order, so an element may round one ulp (at most 2**-7 of its size) the
# other way; a kernel that dropped one K/V block of a 2048-token chain would
# move outputs of size ~0.05 by ~5e-3, far past this.  f32: order only.
TOL_BF16 = (1e-4, 1e-2)
TOL_F32 = (1e-4, 0.0)
TOL_LOGITS_F32 = 1e-3  # small f32 model: card vs CPU first-step logits
# H100 SXM data sheet: HBM3 rate and dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, torch, flush, iters: int = 30, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``iters`` runs, CUDA events
    around each run, with the 50 MB L2 flushed before each one (in the
    engine a layer's KV is cold: 31 other layers ran since)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(out, ref, tol, what: str) -> float:
    """Max abs error of ``out`` against ``ref``; fails unless every element
    is within ``atol + rtol * |ref|``."""
    atol, rtol = tol
    ref = ref.float()
    diff = (out.float() - ref).abs()
    err = diff.max().item()
    over = (diff - atol - rtol * ref.abs()).max().item()
    if not math.isfinite(err) or over > 0:
        fail(f"{what} disagrees with its plain version: max abs err {err}, "
             f"past |k - p| <= {atol} + {rtol} |p| by {over}")
    return err


def check_f32(torch, kernel, plain, args, what: str) -> float:
    """The kernel against its plain version on ``args`` cast to f32."""
    args = [a.float() if a.dtype == torch.bfloat16 else a for a in args]
    out, ref = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    return compare(out, ref, TOL_F32, f"{what} (f32)")


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def paged_inputs(torch, S: int, gen):
    """A (NB, BS, KV, D) bf16 K and V pool and S disjoint block chains."""
    kc = torch.randn((NB, BS, KV, D), generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    vc = torch.randn((NB, BS, KV, D), generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    perm = torch.randperm(NB - 1, generator=gen, device="cuda")
    bt = perm[: S * MB].reshape(S, MB).to(torch.int32).contiguous()
    return kc, vc, bt


def check_decode(torch, pa, flush) -> dict:
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    S = len(DECODE_CTX)
    kc, vc, bt = paged_inputs(torch, S, gen)
    q = torch.randn((S, H, D), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    ctx = torch.tensor(DECODE_CTX, dtype=torch.int32, device="cuda")
    out = pa.paged_decode_attention(q, kc, vc, bt, ctx)
    ref = pa.decode_attention_plain(q, kc, vc, bt, ctx)
    torch.cuda.synchronize()
    err = compare(out, ref, TOL_BF16, "decode kernel")
    if out[0].abs().max().item() != 0.0:
        fail("decode kernel: the ctx=0 row is not zero")
    err_f32 = check_f32(torch, pa.paged_decode_attention,
                        pa.decode_attention_plain, (q, kc, vc, bt, ctx),
                        "decode kernel")
    # yardstick: one SDPA call over the same contexts, pre-gathered into
    # contiguous (S, KV, T, D) K/V with a padding mask (gather excluded;
    # the ctx=0 row attends to position 0 here)
    T = max(DECODE_CTX)
    kg = kc[bt.long()].reshape(S, MB * BS, KV, D)[:, :T].transpose(1, 2) \
        .contiguous()
    vg = vc[bt.long()].reshape(S, MB * BS, KV, D)[:, :T].transpose(1, 2) \
        .contiguous()
    mask = torch.arange(T, device="cuda")[None, :] < ctx.clamp(min=1)[:, None]
    mask = mask[:, None, None, :]
    qs = q[:, :, None, :]

    def library():
        return F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask,
                                              enable_gqa=True)

    # bytes the function must move: q of the rows with ctx > 0, each context
    # position's K and V once, the block-table columns those positions use,
    # the context lengths, and the whole output
    n_pos = sum(DECODE_CTX)
    live = sum(1 for c in DECODE_CTX if c > 0)
    cols = sum(-(-c // BS) for c in DECODE_CTX)
    nbytes = (live * H * D * 2 + n_pos * KV * D * 2 * 2 + cols * 4
              + S * 4 + q.numel() * 2)
    flops = 4 * n_pos * H * D
    b_ms, b_by = bound(nbytes, flops)
    return {
        "name": "paged_decode_attention", "max_abs_err": err,
        "max_abs_err_f32": err_f32,
        "ms": time_ms(lambda: pa.paged_decode_attention(q, kc, vc, bt, ctx),
                      torch, flush),
        "plain_ms": time_ms(lambda: pa.decode_attention_plain(
            q, kc, vc, bt, ctx), torch, flush),
        "library_ms": time_ms(library, torch, flush),
        "bound_ms": b_ms, "bound_by": b_by,
    }


def check_prefill(torch, pa, flush) -> dict:
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    S = len(PREFILL_START)
    kc, vc, bt = paged_inputs(torch, S, gen)
    q = torch.randn((S, PREFILL_QP, H, D), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    cs = torch.tensor(PREFILL_START, dtype=torch.int32, device="cuda")
    cl = torch.tensor(PREFILL_LEN, dtype=torch.int32, device="cuda")
    out = pa.paged_prefill_attention(q, kc, vc, bt, cs, cl)
    ref = pa.prefill_attention_plain(q, kc, vc, bt, cs, cl)
    torch.cuda.synchronize()
    err = compare(out, ref, TOL_BF16, "prefill kernel")
    for s, n in enumerate(PREFILL_LEN):
        if n < PREFILL_QP and out[s, n:].abs().max().item() != 0.0:
            fail(f"prefill kernel: padding rows of sequence {s} not zero")
    err_f32 = check_f32(torch, pa.paged_prefill_attention,
                        pa.prefill_attention_plain, (q, kc, vc, bt, cs, cl),
                        "prefill kernel")
    # yardstick: one SDPA call over the same contexts pre-gathered into
    # contiguous K/V (gather excluded), with the causal + chunk-end mask;
    # padding rows attend to position 0 here
    ends = [a + n for a, n in zip(PREFILL_START, PREFILL_LEN)]
    T = max(ends)
    kg = kc[bt.long()].reshape(S, MB * BS, KV, D)[:, :T].transpose(1, 2) \
        .contiguous()
    vg = vc[bt.long()].reshape(S, MB * BS, KV, D)[:, :T].transpose(1, 2) \
        .contiguous()
    rows = torch.arange(PREFILL_QP, device="cuda")
    t_pos = torch.arange(T, device="cuda")
    q_pos = cs.long()[:, None] + rows[None, :]
    mask = ((t_pos[None, None, :] <= q_pos[:, :, None])
            & (t_pos[None, None, :] < (cs + cl).long()[:, None, None]))
    mask[:, :, 0] = True
    mask = mask[:, None]
    qs = q.transpose(1, 2).contiguous()

    def library():
        return F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask,
                                              enable_gqa=True)

    # bytes the function must move: q of the rows below chunk_len (padding
    # rows and inactive tiles are written as zeros unread), K and V of each
    # position below a live chunk's end once, the block-table columns those
    # positions use, chunk_start and chunk_len, and the whole output
    live_ends = [e for e, n in zip(ends, PREFILL_LEN) if n > 0]
    n_pos = sum(live_ends)
    cols = sum(-(-e // BS) for e in live_ends)
    pairs = sum(a + i + 1 for a, n in zip(PREFILL_START, PREFILL_LEN)
                for i in range(n))
    nbytes = (sum(PREFILL_LEN) * H * D * 2 + n_pos * KV * D * 2 * 2
              + cols * 4 + 2 * S * 4 + q.numel() * 2)
    flops = 4 * pairs * H * D
    b_ms, b_by = bound(nbytes, flops)
    return {
        "name": "paged_prefill_attention", "max_abs_err": err,
        "max_abs_err_f32": err_f32,
        "ms": time_ms(lambda: pa.paged_prefill_attention(
            q, kc, vc, bt, cs, cl), torch, flush),
        "plain_ms": time_ms(lambda: pa.prefill_attention_plain(
            q, kc, vc, bt, cs, cl), torch, flush, iters=20),
        "library_ms": time_ms(library, torch, flush),
        "bound_ms": b_ms, "bound_by": b_by,
    }


def serve(torch, eng, prompts, trace=None) -> dict:
    """Queue every prompt, run SplitFuse steps until no request is still
    prefilling (timed as the prefill phase), then ``generate_all`` with
    greedy burst-8 decode (timed as the decode phase).  With ``trace`` (a
    factory of ``torch.profiler`` contexts) each phase runs under its own
    profiler."""
    uids = [eng.put(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    phase = trace or contextlib.nullcontext
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps, probes = 0, []
    with phase() as prof_prefill:
        while eng.num_waiting or eng._prefilling:
            eng.step()
            steps += 1
            probes.append(bool(torch.isfinite(eng.last_logits).all().item()))
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    emitted = sum(len(s.tokens) for s in eng.running.values()) \
        - sum(len(p) for p in prompts)
    with phase() as prof_decode:
        results = eng.generate_all(burst=8)
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"uids": uids, "results": results, "mixed_steps": steps,
            "probes_finite": probes, "prefill_s": t1 - t0,
            "prefill_emitted": emitted, "decode_s": t2 - t1,
            "profiles": (prof_prefill, prof_decode)}


def device_breakdown(torch, prof, wall_s: float) -> dict:
    """Device time by kernel from a ``torch.profiler`` run: only the
    kernels themselves count (not the operators that launched them), summed
    as busy time (one stream, so kernels do not overlap) and grouped into
    the port's attention kernels, matrix products and the rest.  The idle
    share is taken against ``wall_s``, an unprofiled run of the same phase
    (the profiler's own host cost would inflate the profiled wall)."""
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        rows.append((us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    groups = {"paged_attention": 0.0, "gemm": 0.0, "other": 0.0}
    for ms, _, name in rows:
        if "paged_" in name:
            groups["paged_attention"] += ms
        elif any(k in name for k in ("nvjet", "gemm", "cutlass", "xmma")):
            groups["gemm"] += ms
        else:
            groups["other"] += ms
    return {"wall_ms": wall_s * 1e3, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / (wall_s * 1e3), "by_group_ms": groups,
            "top": [[name[:70], ms, n] for ms, n, name in rows[:10]]}


def run_engine(torch, pa, profile: bool) -> dict:
    import numpy as np

    from deepspeed_tpu_torch.inference.v2.engine import (InferenceEngineV2,
                                                         V2Config)
    from deepspeed_tpu_torch.models import transformer as tfm

    cfg = tfm.get_config("llama3-8b")
    t0 = time.perf_counter()
    params = tfm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    v2 = V2Config(max_tokens_per_step=256, max_seqs=8, block_size=BS,
                  num_blocks=NB, max_blocks_per_seq=MB, dtype="bfloat16")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in PROMPT_LENS]

    def trace():
        from torch.profiler import ProfilerActivity
        return torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA])

    # run 0 is cold (first cuBLAS heuristics, first kernel loads), run 1
    # warm; run 2, with --profile, traces each phase
    runs = []
    for attempt in range(3 if profile else 2):
        eng = InferenceEngineV2(cfg, params, v2)
        pa.reset_counts()
        run = serve(torch, eng, prompts, trace if attempt == 2 else None)
        run["launches"] = dict(pa.LAUNCHES)
        run["plain_calls"] = dict(pa.PLAIN_CALLS)
        run["burst_steps"] = eng.burst_steps
        runs.append(run)
        del eng
        torch.cuda.empty_cache()
    run = runs[0]
    gen_tokens = []
    for uid, prompt in zip(run["uids"], prompts):
        toks = run["results"][uid]
        new = toks[len(prompt):]
        if toks[:len(prompt)] != prompt or len(new) != NEW_TOKENS:
            fail(f"request {uid}: {len(new)} new tokens, want {NEW_TOKENS}")
        if not all(0 <= t < cfg.vocab_size for t in new):
            fail(f"request {uid}: token outside the vocab")
        gen_tokens.append(new)
    if not run["probes_finite"] or not all(run["probes_finite"]):
        fail("a mixed step's logits were not finite")
    for name, n in run["launches"].items():
        if n <= 0:
            fail(f"{name} was never launched on the main path")
    if any(run["plain_calls"].values()):
        fail(f"plain attention ran on the main path: {run['plain_calls']}")
    second = [runs[1]["results"][u][len(p):]
              for u, p in zip(runs[1]["uids"], prompts)]
    if second != gen_tokens:
        fail("a second run from the same seed gave other tokens")
    prompt_tokens = sum(PROMPT_LENS)

    def rates(r):
        decode_tokens = len(prompts) * NEW_TOKENS - r["prefill_emitted"]
        return {"mixed_steps": r["mixed_steps"],
                "burst_steps": r["burst_steps"],
                "prefill_s": r["prefill_s"],
                "prefill_tokens_per_s": prompt_tokens / r["prefill_s"],
                "decode_s": r["decode_s"], "decode_tokens": decode_tokens,
                "decode_tokens_per_s": decode_tokens / r["decode_s"]}

    out = {"model": "llama3-8b", "layers": cfg.num_layers,
           "params": cfg.num_params(), "init_s": init_s,
           "prompt_tokens": prompt_tokens, "cold": rates(runs[0]),
           "warm": rates(runs[1]), "launches": run["launches"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if profile:
        r, warm = runs[2], runs[1]
        out["profile"] = {
            "prefill": device_breakdown(torch, r["profiles"][0],
                                        warm["prefill_s"]),
            "decode": device_breakdown(torch, r["profiles"][1],
                                       warm["decode_s"])}
    return out


def small_model_agreement(torch) -> dict:
    """A small llama-shaped f32 model (head dim 64, GQA) served on the card
    (kernels) and on the CPU (plain versions) from the same weights: the
    first mixed step's logits agree within TOL_LOGITS_F32 and every greedy
    token matches."""
    import numpy as np

    from deepspeed_tpu_torch.inference.v2.engine import (InferenceEngineV2,
                                                         V2Config)
    from deepspeed_tpu_torch.models import transformer as tfm

    cfg = tfm.get_config("tiny", hidden_size=256, intermediate_size=512,
                         num_heads=4, num_kv_heads=2, dtype="float32")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(SEED),
                             device="cpu")
    v2 = V2Config(max_tokens_per_step=32, max_seqs=4, block_size=16,
                  num_blocks=64, max_blocks_per_seq=8, dtype="float32")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (5, 40, 17, 70)]
    out = {}
    for dev in ("cuda", "cpu"):
        eng = InferenceEngineV2(cfg, params, v2, device=dev)
        uids = [eng.put(p, max_new_tokens=12) for p in prompts]
        eng.step()
        first = eng.last_logits.cpu()
        res = eng.generate_all(burst=4)
        out[dev] = (first, [res[u] for u in uids])
    diff = (out["cuda"][0] - out["cpu"][0]).abs().max().item()
    if not diff <= TOL_LOGITS_F32:
        fail(f"small model: card vs CPU logits differ by {diff}")
    if out["cuda"][1] != out["cpu"][1]:
        fail("small model: greedy tokens on the card differ from the CPU's")
    return {"logits_max_abs_diff": diff, "requests": len(prompts)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace a third engine run's phases with "
                    "torch.profiler and print where the device time goes")
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    try:
        from deepspeed_tpu_torch.ops.hopper import build
        from deepspeed_tpu_torch.ops.hopper import paged_attention as pa
    except ImportError as e:
        fail(f"run from the root of the repository ({e})")
    for mod in list(sys.modules):
        if mod == "jax" or mod.startswith(("jax.", "deepspeed_tpu.")):
            fail(f"{mod} was imported")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    secs, log = build.build()
    print(f"build: {secs:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    kernels = [check_decode(torch, pa, flush), check_prefill(torch, pa, flush)]
    del flush
    for k in kernels:
        print(f"{k['name']}: max_abs_err {k['max_abs_err']:.3e} "
              f"(bf16, limit atol+rtol {TOL_BF16}), "
              f"{k['max_abs_err_f32']:.3e} (f32, limit {TOL_F32}) "
              f"kernel_ms {k['ms']:.4f} plain_ms "
              f"{k['plain_ms']:.4f} library_ms {k['library_ms']:.4f} "
              f"bound_ms {k['bound_ms']:.5f} ({k['bound_by']})")

    engine = run_engine(torch, pa, args.profile)
    launches = engine["launches"]
    print("engine: " + json.dumps(engine))
    small = small_model_agreement(torch)
    print("small model card vs CPU: " + json.dumps(small))
    result = {"card": card, "torch": torch.__version__, "engine": engine,
              "small_model": small}

    source = "deepspeed_tpu_torch/csrc/paged_attention.cu"
    replaces = {"paged_decode_attention":
                "deepspeed_tpu/ops/pallas/paged_attention.py:77",
                "paged_prefill_attention":
                "deepspeed_tpu/ops/pallas/paged_attention.py:255"}
    line = {"kernels": [
        {"name": k["name"], "route": "cuda", "source": source,
         "replaces": replaces[k["name"]], "status": "ok",
         "launches": launches[k["name"]], "max_abs_err": k["max_abs_err"],
         "max_abs_err_f32": k["max_abs_err_f32"],
         "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
         "bound_by": k["bound_by"], "library_ms": k["library_ms"]}
        for k in kernels]}
    result.update(line)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
