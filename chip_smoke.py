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
   same inputs in f32, max abs error only; decode also at contexts on its
   split-KV edges (bf16 and f32) and once under
   ``torch.cuda.set_sync_debug_mode("error")``; prefill also in bf16 on
   pools of block size 16 and 128;
4. the engine: ``InferenceEngineV2`` at full llama3-8b width and depth with
   random bf16 weights from a seed, serving 8 requests (SplitFuse prefill,
   then burst decode), checking tokens, finiteness, kernel launch counts
   and determinism; and a small f32 model served on the card and on the
   CPU, whose greedy tokens must agree;
5. each flash-attention kernel (forward, dK/dV, dQ) against its plain
   PyTorch version at the training shape (B=4, S=2048, H=32, KV=8, D=128,
   causal): in bf16 and in f32, max abs error (and in bf16 how far inside
   its limit the worst element lies) and kernel / plain / library (SDPA
   forward; SDPA backward for dK/dV and dQ together) / bound times;
6. training: ``deepspeed_tpu_torch.initialize`` + ``train_batch`` on
   llama3-8b at full width with its depth cut to 8 layers (bf16
   parameters, f32 AdamW state, flash attention, tiled loss), 2 warm-up
   and 5 timed steps on one fixed batch: tokens/s, step ms, MFU, peak
   memory, finite and falling loss, and exact flash launch counts; then a
   small f32 model trained 3 steps on the card and on the CPU, whose
   losses and parameters must agree;
7. the mixed GEMM (W8A16 / W4A16 / W6A16) and W8A8 kernels against their
   plain versions at llama3-8b's four projection shapes, at M = 8 (a decode
   body) and M = 256 (a mixed step), in bf16 and f32: max abs error and
   kernel / plain / library (bf16 ``torch.matmul`` by the dequantized
   weight) / bound times (M = 8 runs ``mixed_gemm_kernel`` and
   ``int8_gemm_mma_kernel``, M = 256 ``mixed_gemm_wgmma_kernel`` and
   ``int8_gemm_wgmma_kernel``; the W8A8 dispatch is checked);
8. quantized serving: the engine of 4. with ``quantize_bits=8`` (cold and
   warm), then 4 and 6, at full width and depth: tokens, finiteness,
   ``mixed_gemm`` launches = 7 x paged launches with no plain or envelope
   call, ``mixed_gemm_wgmma_kernel`` launches = 7 x prefill launches,
   determinism, tokens/s and memory; the seven projections of one
   quantized layer through ``int8_gemm`` (each M = 256 call on
   ``int8_gemm_wgmma_kernel``); and the small f32 model of 4.
   quantized at each width, card against CPU;
9. the grouped matmul (dropless MoE) kernel against its plain version at
   Mixtral-8x7B's expert shapes (E = 8, (K, N) = (4096, 14336) and
   (14336, 4096)), for a decode body's 16 assignments and a 256-token
   mixed step's 512, forward and on transposed weights (the backward's
   dlhs), in bf16 and f32: max abs error and kernel / plain / library
   (``torch._grouped_mm``) / bound times (the bf16 forward at T = 512 runs
   ``grouped_matmul_wgmma_kernel``, the rest the mma.sync and CUDA-core
   kernels; the dispatch is checked);
10. dropless MoE serving: the engine of 4. on Mixtral-8x7B at full width
   with its depth cut to 16 of 32 layers (bf16 weights from a seed),
   cold and warm: tokens, grouped-GEMM launches = 3 x paged launches (of
   which ``grouped_matmul_wgmma_kernel`` = 3 x prefill launches), no
   plain call, no host sync inside a decode body, tokens/s, peak memory
   and engine build time; then a small f32 MoE model served card against
   CPU (dropless and capacity routing) and trained 3 steps card against
   CPU (dropless: the grouped GEMM forward and on transposed weights);
11. fused AdamW against its plain version on one llama3-8b layer's
   parameter count (two steps, weight decay): max abs error and kernel /
   plain / library (``torch.optim.AdamW(fused=True)``) / bound times; then
   ``fused_adamw_tree`` over the small model's parameters, one launch per
   call;
12. the evoformer path (``ops/evoformer.py``) at OpenFold's three attention
   calls (MSA row attention with pair bias and one padded MSA sequence,
   triangle attention, MSA column attention; D = 32, bf16):
   ``evoformer_attention`` forward and backward with exactly one biased
   flash-forward launch per call and no plain call; the bias kernel's o and
   lse against ``flash_fwd_plain``, the padded sequence's o against the
   mean of V, the output and all five gradients against the plain path
   (bf16, with the op's output shared; and end to end in f32 at the MSA
   row shape, with the f32 kernel); kernel / plain / library (SDPA with
   the biases as its float mask) / bound times and the op's forward +
   backward time; then ``sparse_attention`` with a causal Fixed layout at
   llama3-8b's attention width (S = 4096, block 128): one launch of each
   flash kernel, output and gradients against the plain versions;
13. a JSON line with every kernel's numbers;
14. last, ``{"ok": true, "device": {...}}``.

Any failure exits non-zero without the last line.  Without CUDA, or
without the rest of the repository beside it, it fails at once.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import re
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
PREFILL_BLOCKS = (16, 128)  # other pool block sizes the prefill check runs
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
# flash dq/dk/dv against their plain versions: each element sums over up to
# S * H/KV = 8192 rows, in another order on each side, so the f32 limit is
# relative to the tensor's largest magnitude; one dropped 64-key or
# 64-row tile moves a gradient row by a few percent of its size, far past
# this.  bf16 adds one output ulp per element (rtol 1e-2).
GRAD_REL = 1e-4
# flash training shape (bench.py's micro-batch and sequence, llama3-8b heads)
FB, FS = 4, 2048
TRAIN_LAYERS, TRAIN_WARMUP, TRAIN_STEPS, TILE = 8, 2, 5, 512
TOL_TRAIN = 1e-4  # small f32 training, card vs CPU: loss rel, params abs
# mixed GEMM: llama3-8b's projection shapes (K, N) and rows per call
GEMM_SHAPES = {"wq/wo": (4096, 4096), "wk/wv": (4096, 1024),
               "w_gate/w_in": (4096, 14336), "w_out": (14336, 4096)}
GEMM_MS = (8, 256)  # a decode body at max_seqs=8, a mixed step's 256 tokens
# the shape and the M of the kernels JSON line's mixed-GEMM and W8A8 rows:
# a decode body's rows (mixed_gemm_kernel) and a mixed step's (wgmma)
GEMM_JSON = (("w_gate/w_in", 8), ("w_gate/w_in", 256))
QUANT_GROUP = 256
PROJECTIONS = 7  # wq, wk, wv, wo, w_gate, w_in, w_out per layer
# mixed GEMM in f32: kernel and plain both sum the same exact bf16 products
# in f32, K = 4096 or 14336 terms per output, in another order; the tensor
# cores' accumulation also truncates where IEEE addition rounds, so the
# difference grows with K (on an H100 80GB HBM3 at 700 W, unsplit: 2.5e-5 of
# the largest output at K = 4096, 8.8e-5 at K = 14336): 5e-4 of the
# largest output.  One dropped 256-row group of 56 moves outputs by ~13% of
# their size, far past this
GEMM_F32_REL = 5e-4
# small quantized f32 model, card vs CPU: the mixed GEMM rounds every
# activation to bf16 (the reference's numerics), so a last-bit f32
# difference upstream can move an activation by one bf16 ulp (2**-8 of its
# size); on the CPU alone, summing the GEMMs in f64 instead of f32 moves the
# first step's logits (max ~3.3) by 3.6e-3, and an H100 measured 4.8e-3
# card vs CPU.  Greedy tokens must still be identical
TOL_LOGITS_QUANT = 2e-2
# dropless MoE: Mixtral-8x7B's experts, (K, N) of each grouped GEMM, and
# assignments per call (a decode body's 8 rows x top-2, a 256-token mixed
# step's 512); serving cut to MOE_LAYERS of 32 layers (92.9 GB of experts
# at full depth; 16 layers hold 46.4 GB)
MOE_E = 8
MOE_SHAPES = {"w_gate/w_in": (4096, 14336), "w_out": (14336, 4096)}
MOE_T = (16, 512)
# the shape and the T of the kernels JSON line's grouped-GEMM rows: a decode
# body's (grouped_matmul_bf16_kernel) and a mixed step's (wgmma)
MOE_JSON = (("w_gate/w_in", 16), ("w_gate/w_in", 512))
MOE_LAYERS = 16
# grouped matmul in f32: CUDA-core sums of up to 14336 terms in another
# order than the plain version's: 1e-4 of the largest output
GMM_F32_REL = 1e-4
# fused AdamW: one llama3-8b layer's parameters (not a multiple of the
# reference's 65536 block); every f32 operation rounds once on both sides,
# only b ** step may differ by an ulp: 1e-6 of each tensor's largest element
ADAM_N = 218_112_000
ADAM_REL = 1e-6
ADAM_HYPER = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.1)
# DS4Science evoformer attention at OpenFold's widths (openfold/config.py,
# evoformer_stack: c_hidden_msa_att 32, no_heads_msa 8, c_hidden_pair_att
# 32, no_heads_pair 4; initial training: crop_size 256, max_msa_clusters
# 128): q/k/v (B, N, L, H, D), with the mask bias (B, N, 1, 1, L) and the
# pair bias (B, 1, H, L, L) or not
EVO_CALLS = {"msa_row": ((1, 128, 256, 8, 32), True, True),
             "triangle": ((1, 256, 256, 4, 32), True, True),
             "msa_column": ((1, 256, 128, 8, 32), True, False)}
EVO_PADDED = 127  # msa_row's padded MSA sequence: all its keys at -1e9
EVO_JSON = "msa_row"  # the shape of the kernels JSON line's bias row (and f32)
# block-sparse attention at llama3-8b's attention width: a causal Fixed
# layout (4 local blocks, 1 global) of 128-token blocks over 4096 tokens
SPARSE_S, SPARSE_BLOCK = 4096, 128
# H100 SXM data sheet: HBM3 rate and dense bf16 / int8 tensor-core rates
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
F32_FLOPS_PER_S = 67e12  # outside the tensor cores


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def kernel_name(line: str) -> str:
    """The kernel's name and template arguments in a ptxas line that names
    its mangled entry function, as ``flash_fwd_tc_kernelILi128E``."""
    found = re.search(r"_ZN(\w+)", line)
    if not found:
        return line.strip()
    rest, name = found.group(1), ""
    while rest[:1].isdigit():  # length-prefixed nested names
        digits = re.match(r"\d+", rest).group()
        n = int(digits)
        name, rest = rest[len(digits):len(digits) + n], rest[len(digits) + n:]
    args = re.match(r"I\w*?E(?=E)", rest)
    return name + (args.group() if args else "")


def time_ms(fn, torch, flush, iters: int = 30, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``iters`` runs, CUDA events
    around each run, with the 50 MB L2 flushed before each one (in the
    engine a layer's KV is cold: 31 other layers ran since).  The device
    then spins for ~0.5 ms, so that ``fn``'s launches are queued before it
    reaches the start event and the host's launch cost stays out of the
    time."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def excess(out, ref, atol: float, rtol: float):
    """``(max |out - ref|, max(|out - ref| - atol - rtol |ref|))``: the
    error, and how far the worst element lies past its limit (negative:
    inside it)."""
    ref = ref.float()
    diff = (out.float() - ref).abs()
    return (diff.max().item(),
            (diff - atol - rtol * ref.abs()).max().item())


def compare(out, ref, tol, what: str) -> float:
    """Max abs error of ``out`` against ``ref``; fails unless every element
    is within ``atol + rtol * |ref|``."""
    atol, rtol = tol
    err, over = excess(out, ref, atol, rtol)
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


def bound(nbytes: float, flops: float, peak: float = BF16_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def paged_inputs(torch, S: int, gen, bs: int = BS):
    """A bf16 K and V pool of block size ``bs`` holding NB * BS positions,
    and S disjoint block chains of MB * BS positions each."""
    nb, mb = NB * BS // bs, MB * BS // bs
    kc = torch.randn((nb, bs, KV, D), generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    vc = torch.randn((nb, bs, KV, D), generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    perm = torch.randperm(nb - 1, generator=gen, device="cuda")
    bt = perm[: S * mb].reshape(S, mb).to(torch.int32).contiguous()
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
    # the split-KV edges: contexts at, one below and one past a split's
    # end, a partial last split and the whole chain, in bf16 and f32
    split = pa.decode_split(MB * BS)
    edges = torch.tensor([0, 1, split - 1, split, split + 1, 1000,
                          MB * BS - 1, MB * BS], dtype=torch.int32,
                         device="cuda")
    err_edges = compare(pa.paged_decode_attention(q, kc, vc, bt, edges),
                        pa.decode_attention_plain(q, kc, vc, bt, edges),
                        TOL_BF16, "decode kernel at split edges")
    err_edges = max(err_edges, check_f32(
        torch, pa.paged_decode_attention, pa.decode_attention_plain,
        (q, kc, vc, bt, edges), "decode kernel at split edges"))
    # a decode call waits on nothing (its splits follow from the shapes)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pa.paged_decode_attention(q, kc, vc, bt, ctx)
    except RuntimeError as e:
        fail(f"decode kernel: the call waited for the device: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
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
        "max_abs_err_f32": err_f32, "split": split,
        "max_abs_err_split_edges": err_edges,
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
    # the bf16 kernel gathers its 64-key tiles through the block table:
    # pools of smaller and larger blocks, the same queries and chunks
    err_blocks = {}
    for bs in PREFILL_BLOCKS:
        kb, vb, btb = paged_inputs(torch, S, gen, bs)
        out_b = pa.paged_prefill_attention(q, kb, vb, btb, cs, cl)
        err_blocks[bs] = compare(
            out_b, pa.prefill_attention_plain(q, kb, vb, btb, cs, cl),
            TOL_BF16, f"prefill kernel, block size {bs}")
        for s, n in enumerate(PREFILL_LEN):
            if n < PREFILL_QP and out_b[s, n:].abs().max().item() != 0.0:
                fail(f"prefill kernel, block size {bs}: padding rows of "
                     f"sequence {s} not zero")
        del kb, vb, btb, out_b
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
        "max_abs_err_f32": err_f32, "max_abs_err_block_sizes": err_blocks,
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
    steps, probes, first = 0, [], None
    with phase() as prof_prefill:
        while eng.num_waiting or eng._prefilling:
            eng.step()
            steps += 1
            probes.append(bool(torch.isfinite(eng.last_logits).all().item()))
            if first is None:
                first = eng.last_logits.clone()
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    emitted = sum(len(s.tokens) for s in eng.running.values()) \
        - sum(len(p) for p in prompts)
    with phase() as prof_decode:
        results = eng.generate_all(burst=8)
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"uids": uids, "results": results, "mixed_steps": steps,
            "probes_finite": probes, "first_logits": first,
            "prefill_s": t1 - t0,
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
    groups = {"paged_attention": 0.0, "flash_attention": 0.0,
              "mixed_gemm": 0.0, "grouped_matmul": 0.0, "gemm": 0.0,
              "other": 0.0}
    for ms, _, name in rows:
        if "mixed_gemm" in name or "int8_gemm" in name:
            groups["mixed_gemm"] += ms
        elif "grouped_matmul" in name:
            groups["grouped_matmul"] += ms
        elif "paged_" in name or "decode_merge" in name:
            groups["paged_attention"] += ms
        elif "flash_" in name:
            groups["flash_attention"] += ms
        elif any(k in name for k in ("nvjet", "gemm", "cutlass", "xmma")):
            groups["gemm"] += ms
        else:
            groups["other"] += ms
    # the port's own kernels by name (the text before the template or
    # function arguments), e.g. flash_dq_tc_kernel
    port = {}
    for ms, _, name in rows:
        found = re.search(r"(\w+_kernel)[<(]", name)
        if found and "anonymous namespace" in name:
            port[found.group(1)] = port.get(found.group(1), 0.0) + ms
    return {"wall_ms": wall_s * 1e3, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / (wall_s * 1e3), "by_group_ms": groups,
            "port_kernels_ms": port,
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
        if "paged_prefill_tc_kernel" not in \
                out["profile"]["prefill"]["port_kernels_ms"]:
            fail("bf16 engine prefill: no paged_prefill_tc_kernel in the "
                 "trace")
    return out


def small_model_agreement(torch, bits: int = 0, cfg=None,
                          kernel=None) -> dict:
    """A small llama-shaped f32 model (head dim 64, GQA; ``cfg`` when
    given) served on the card (kernels) and on the CPU (plain versions)
    from the same weights, quantized to ``bits`` when non-zero: the first
    mixed step's logits agree within TOL_LOGITS_F32 (TOL_LOGITS_QUANT when
    quantized) and every greedy token matches.  ``kernel``: a kernel module
    whose launches the card run must show, with no plain call."""
    import numpy as np

    from deepspeed_tpu_torch.inference.v2.engine import (InferenceEngineV2,
                                                         V2Config)
    from deepspeed_tpu_torch.models import transformer as tfm

    cfg = cfg or tfm.get_config("tiny", hidden_size=256,
                                intermediate_size=512, num_heads=4,
                                num_kv_heads=2, dtype="float32")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(SEED),
                             device="cpu")
    v2 = V2Config(max_tokens_per_step=32, max_seqs=4, block_size=16,
                  num_blocks=64, max_blocks_per_seq=8, dtype="float32",
                  quantize_bits=bits)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (5, 40, 17, 70)]
    out = {}
    tag = f"small model (quantize_bits={bits})" if bits else "small model"
    for dev in ("cuda", "cpu"):
        eng = InferenceEngineV2(cfg, params, v2, device=dev)
        uids = [eng.put(p, max_new_tokens=12) for p in prompts]
        if kernel is not None:
            kernel.reset_counts()
        eng.step()
        first = eng.last_logits.cpu()
        res = eng.generate_all(burst=4)
        out[dev] = (first, [res[u] for u in uids])
        if kernel is not None and dev == "cuda" and (
                not all(kernel.LAUNCHES.values())
                or any(kernel.PLAIN_CALLS.values())):
            fail(f"{tag}: the card run did not go through the kernel: "
                 f"{kernel.LAUNCHES} {kernel.PLAIN_CALLS}")
    diff = (out["cuda"][0] - out["cpu"][0]).abs().max().item()
    if not diff <= (TOL_LOGITS_QUANT if bits else TOL_LOGITS_F32):
        fail(f"{tag}: card vs CPU logits differ by {diff}")
    if out["cuda"][1] != out["cpu"][1]:
        fail(f"{tag}: greedy tokens on the card differ from the CPU's")
    return {"quantize_bits": bits, "logits_max_abs_diff": diff,
            "requests": len(prompts)}


def grad_tol(ref, f32: bool, rel: float = GRAD_REL):
    """(atol, rtol) of a gradient: rel of its largest element, plus one
    output ulp (1e-2 |ref|) in bf16."""
    return rel * ref.float().abs().max().item(), 0.0 if f32 else 1e-2


def compare_grad(out, ref, f32: bool, what: str, rel: float = GRAD_REL
                 ) -> float:
    """Max abs error of a gradient (or another sum over many terms) against
    its plain version; fails unless every element is within rel * max|ref|
    (+ 1e-2 |ref| in bf16)."""
    atol, rtol = grad_tol(ref, f32, rel)
    err, over = excess(out, ref, atol, rtol)
    if not math.isfinite(err) or over > 0:
        fail(f"{what} disagrees with its plain version: max abs err {err}, "
             f"past |k - p| <= {atol:.3e} + {rtol} |p| by {over}")
    return err


def check_flash(torch, fa, flush) -> list:
    """B1-B3 against their plain versions at the training shape, bf16 then
    f32, with kernel / plain / SDPA / bound times of the bf16 run."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    q, k, v, do = rnd(FB, FS, H, D), rnd(FB, FS, KV, D), rnd(FB, FS, KV, D), \
        rnd(FB, FS, H, D)
    mask = fa.AttnMask(causal=True)
    scale = 1.0 / math.sqrt(D)
    errs = {}
    for f32 in (False, True):
        args = [t.float() if f32 else t for t in (q, k, v, do)]
        qa, ka, va, da = args
        o, lse = fa.flash_fwd(qa, ka, va, mask, scale)
        o_p, lse_p = fa.flash_fwd_plain(qa, ka, va, mask, scale)
        torch.cuda.synchronize()
        tag = "f32" if f32 else "bf16"
        e_o = compare(o, o_p, TOL_F32 if f32 else TOL_BF16,
                      f"flash_fwd o ({tag})")
        e_l = compare(lse, lse_p, TOL_F32, f"flash_fwd lse ({tag})")
        delta = fa.attention_delta(da, o_p)
        dk, dv = fa.flash_bwd_dkdv(qa, ka, va, da, lse_p, delta, mask, scale)
        dk_p, dv_p = fa.flash_bwd_dkdv_plain(qa, ka, va, da, lse_p, delta,
                                             mask, scale)
        dq = fa.flash_bwd_dq(qa, ka, va, da, lse_p, delta, mask, scale)
        dq_p = fa.flash_bwd_dq_plain(qa, ka, va, da, lse_p, delta, mask,
                                     scale)
        torch.cuda.synchronize()
        if not f32:  # how far inside its limits each bf16 kernel lies
            margins = {
                "flash_fwd": max(excess(o, o_p, *TOL_BF16)[1],
                                 excess(lse, lse_p, *TOL_F32)[1]),
                "flash_bwd_dkdv": max(
                    excess(dk, dk_p, *grad_tol(dk_p, False))[1],
                    excess(dv, dv_p, *grad_tol(dv_p, False))[1]),
                "flash_bwd_dq": excess(dq, dq_p, *grad_tol(dq_p, False))[1]}
        errs[tag] = {
            "flash_fwd": max(e_o, e_l),
            "flash_bwd_dkdv": max(
                compare_grad(dk, dk_p, f32, f"flash_bwd_dkdv dk ({tag})"),
                compare_grad(dv, dv_p, f32, f"flash_bwd_dkdv dv ({tag})")),
            "flash_bwd_dq": compare_grad(dq, dq_p, f32,
                                         f"flash_bwd_dq dq ({tag})")}
        del o, o_p, dk, dv, dk_p, dv_p, dq, dq_p
    # the timed backward runs take the bf16 forward's lse and delta
    o, lse = fa.flash_fwd_plain(q, k, v, mask, scale)
    delta = fa.attention_delta(do, o)
    del o

    # yardstick: SDPA on (B, H, S, D), causal, GQA; its backward computes
    # dq, dk and dv in one call, the work of B2 and B3 together
    qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dos = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                              enable_gqa=True)

    out = sdpa()

    def sdpa_bwd():
        torch.autograd.grad(out, (qs, ks, vs), dos, retain_graph=True)

    lib_fwd = time_ms(sdpa, torch, flush)
    lib_bwd = time_ms(sdpa_bwd, torch, flush)
    pairs = FS * (FS + 1) // 2  # kept (row, key) pairs per (b, h), causal
    el = 2  # bf16 bytes
    qb = FB * FS * H * D * el
    kvb = FB * FS * KV * D * el
    rowb = FB * H * FS * 4  # one f32 per (b, h, row): lse or delta
    work = {  # bytes each function must move, operations it must do
        "flash_fwd": (qb + 2 * kvb + qb + rowb, 4 * FB * H * D * pairs),
        "flash_bwd_dkdv": (2 * qb + 2 * kvb + 2 * rowb + 2 * kvb,
                           8 * FB * H * D * pairs),
        "flash_bwd_dq": (2 * qb + 2 * kvb + 2 * rowb + qb,
                         6 * FB * H * D * pairs),
    }
    calls = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, mask, scale),
                      lambda: fa.flash_fwd_plain(q, k, v, mask, scale),
                      lib_fwd),
        "flash_bwd_dkdv": (
            lambda: fa.flash_bwd_dkdv(q, k, v, do, lse, delta, mask, scale),
            lambda: fa.flash_bwd_dkdv_plain(q, k, v, do, lse, delta, mask,
                                            scale), lib_bwd),
        "flash_bwd_dq": (
            lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, mask, scale),
            lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, mask,
                                          scale), lib_bwd),
    }
    rows = []
    for name, (kernel, plain, lib_ms) in calls.items():
        b_ms, b_by = bound(*work[name])
        rows.append({"name": name, "max_abs_err": errs["bf16"][name],
                     "max_abs_err_f32": errs["f32"][name],
                     "margin_bf16": margins[name],
                     "ms": time_ms(kernel, torch, flush, iters=10),
                     "plain_ms": time_ms(plain, torch, flush, iters=5,
                                         warmup=1),
                     "library_ms": lib_ms, "bound_ms": b_ms,
                     "bound_by": b_by})
    return rows


def evoformer_inputs(torch, shape, has_b1: bool, has_b2: bool, gen,
                     padded=None):
    """bf16 q, k, v, the cotangent g and the biases of one evoformer call:
    bias1 a 0 / -1e9 mask bias with 10% of keys masked (and every key of
    sequence ``padded``), bias2 a normal pair bias."""
    B, N, L, Hh, Dh = shape

    def rnd(*dims):
        return torch.randn(dims, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    q, k, v, g = (rnd(*shape) for _ in range(4))
    b1 = b2 = None
    if has_b1:
        keep = torch.rand((B, N, 1, 1, L), generator=gen, device="cuda") < 0.9
        if padded is not None:
            keep[:, padded] = False
        b1 = torch.where(keep, 0.0, -1e9).to(torch.bfloat16)
    if has_b2:
        b2 = rnd(B, 1, Hh, L, L)
    return q, k, v, g, b1, b2


def check_evoformer(torch, fa, ev, flush) -> dict:
    """The evoformer path at OpenFold's three attention calls, bf16:
    ``evoformer_attention`` forward and backward on the card (the main path:
    exactly one bias launch per call, no plain call); then per call the bias
    kernel's o and lse against ``flash_fwd_plain`` (TOL_BF16), the padded
    MSA sequence's o against the mean of V, the output against the plain
    path's, the five gradients against ``evoformer_bwd`` given the plain
    lse (within GRAD_REL), and kernel / plain / library (SDPA with b1 + b2
    as its float mask) / bound times.  The bf16 gradients share the op's
    output: delta = rowsum(g o) reads o in bf16, so where kernel and plain
    round an element of o to neighbouring bf16 values (both inside
    TOL_BF16) delta moves, and the backward amplifies that to a few bf16
    ulps of dq in some rows; the plain path is held to the op end to end
    in f32 instead, at EVO_JSON's shape (forward within TOL_F32, the five
    gradients within GRAD_REL)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    inputs = {name: evoformer_inputs(
        torch, shape, h1, h2, gen, EVO_PADDED if name == "msa_row" else None)
        for name, (shape, h1, h2) in EVO_CALLS.items()}
    results = {}
    torch.cuda.synchronize()
    fa.reset_counts()
    for name, (q, k, v, g, b1, b2) in inputs.items():  # the main path
        leaves = [t.requires_grad_() for t in (q, k, v, b1, b2)
                  if t is not None]
        out = ev.evoformer_attention(q, k, v, [b1, b2])
        grads = torch.autograd.grad(out, leaves, g)
        results[name] = (out.detach(), [t.detach() for t in grads])
        for t in leaves:
            t.requires_grad_(False)
    torch.cuda.synchronize()
    launches, bias_launches = dict(fa.LAUNCHES), dict(fa.BIAS_LAUNCHES)
    plain_calls = dict(fa.PLAIN_CALLS)
    want = len(EVO_CALLS)
    if bias_launches["flash_fwd_bias"] != want or \
            launches != {"flash_fwd": want, "flash_bwd_dkdv": 0,
                         "flash_bwd_dq": 0} or any(plain_calls.values()):
        fail(f"evoformer: launches {launches}, bias {bias_launches}, plain "
             f"{plain_calls}; want {want} biased forwards and nothing else")

    calls = {}
    for name, (q, k, v, g, b1, b2) in inputs.items():
        shape = EVO_CALLS[name][0]
        B, N, L, Hh, Dh = shape
        qf, kf, vf, mask, scale, bkv, bqk = ev.flash_args(q, k, v, b1, b2)
        o, lse = fa.flash_fwd(qf, kf, vf, mask, scale, bkv, bqk)
        o_p, lse_p = fa.flash_fwd_plain(qf, kf, vf, mask, scale, bkv, bqk)
        torch.cuda.synchronize()
        err = max(compare(o, o_p, TOL_BF16, f"evoformer {name} o"),
                  compare(lse, lse_p, TOL_BF16, f"evoformer {name} lse"))
        row = {"shape": list(shape), "bias1": b1 is not None,
               "bias2": b2 is not None, "max_abs_err": err,
               "margin_bf16": max(excess(o, o_p, *TOL_BF16)[1],
                                  excess(lse, lse_p, *TOL_BF16)[1])}
        if name == "msa_row":  # the padded sequence: o is the mean of V
            o5 = o.reshape(shape)[:, EVO_PADDED]
            mean_v = v[:, EVO_PADDED].float().mean(1, keepdim=True)
            row["max_abs_err_padded_vs_mean_v"] = compare(
                o5, mean_v.expand(o5.shape), TOL_BF16,
                f"evoformer {name} padded sequence vs mean of V")
        del o, lse, o_p, lse_p
        names = ["dq", "dk", "dv"] + (["db1"] if b1 is not None else []) \
            + (["db2"] if b2 is not None else [])
        out, grads = results[name]
        out_p, lse5_p = ev.evoformer_fwd_plain(q, k, v, b1, b2)
        grads_p = [t for t in ev.evoformer_bwd(q, k, v, b1, b2, out,
                                               lse5_p, g) if t is not None]
        row["max_abs_err_out"] = compare(out, out_p, TOL_BF16,
                                         f"evoformer {name} output")
        row["max_abs_err_grads"] = {
            gn: compare_grad(gk, gp, False, f"evoformer {name} {gn}")
            for gn, gk, gp in zip(names, grads, grads_p)}
        del out_p, lse5_p, grads_p
        if name == EVO_JSON:  # the f32 kernel, and the op end to end in f32
            f32 = [t.float() if t is not None else None
                   for t in (qf, kf, vf, bkv, bqk)]
            o32, lse32 = fa.flash_fwd(*f32[:3], mask, scale, *f32[3:])
            o32_p, lse32_p = fa.flash_fwd_plain(*f32[:3], mask, scale,
                                                *f32[3:])
            torch.cuda.synchronize()
            row["max_abs_err_f32"] = max(
                compare(o32, o32_p, TOL_F32, f"evoformer {name} o (f32)"),
                compare(lse32, lse32_p, TOL_F32,
                        f"evoformer {name} lse (f32)"))
            del o32, lse32, o32_p, lse32_p, f32
            args = [t.float().requires_grad_() if t is not None else None
                    for t in (q, k, v, b1, b2)]
            leaves = [t for t in args if t is not None]
            grads32 = torch.autograd.grad(
                ev.evoformer_attention(*args[:3], args[3:]), leaves,
                g.float())
            args = [t.detach() if t is not None else None for t in args]
            out32_p, lse32_p = ev.evoformer_fwd_plain(*args)
            grads32_p = [t for t in ev.evoformer_bwd(
                *args, out32_p, lse32_p, g.float()) if t is not None]
            row["max_abs_err_grads_f32"] = {
                gn: compare_grad(gk, gp, True, f"evoformer {name} {gn} (f32)")
                for gn, gk, gp in zip(names, grads32, grads32_p)}
            del args, leaves, grads32, out32_p, lse32_p, grads32_p

        # times: the bias kernel, its plain version, SDPA with the biases
        # as one float mask on (B N, H, L, D), and the step's fwd + bwd
        qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (qf, kf, vf))
        am = None
        if b1 is not None:
            am = b1.reshape(B * N, 1, 1, L)
        if b2 is not None:
            pair = b2.reshape(B, 1, Hh, L, L).expand(B, N, Hh, L, L) \
                .reshape(B * N, Hh, L, L)
            am = pair if am is None else am + pair

        def evo_step():
            leaves = [t.detach().requires_grad_() for t in (q, k, v, b1, b2)
                      if t is not None]
            it = iter(leaves)
            lq, lk, lv = next(it), next(it), next(it)
            lb = [next(it) if t is not None else None for t in (b1, b2)]
            torch.autograd.grad(ev.evoformer_attention(lq, lk, lv, lb),
                                leaves, g)

        el = 2
        nbytes = (4 * q.numel() * el + (0 if bkv is None else bkv.numel() * el)
                  + (0 if bqk is None else bqk.numel() * el)
                  + B * N * Hh * L * 4)
        b_ms, b_by = bound(nbytes, 4 * Dh * L * L * Hh * B * N)
        row.update({
            "ms": time_ms(lambda: fa.flash_fwd(qf, kf, vf, mask, scale, bkv,
                                               bqk), torch, flush),
            "plain_ms": time_ms(lambda: fa.flash_fwd_plain(
                qf, kf, vf, mask, scale, bkv, bqk), torch, flush, iters=5,
                warmup=1),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=am), torch, flush),
            "fwd_bwd_ms": time_ms(evo_step, torch, flush, iters=3,
                                  warmup=1),
            "bound_ms": b_ms, "bound_by": b_by})
        del qs, ks, vs, am
        calls[name] = row
    del results, inputs
    return {"calls": calls, "launches": bias_launches["flash_fwd_bias"]}


def run_sparse(torch, fa, sa) -> dict:
    """``sparse_attention`` once with a causal Fixed layout at llama3-8b's
    attention width (B=1, S=SPARSE_S, H=32, KV=8, D=128, bf16): one launch
    of each flash kernel and no plain call; output and gradients against
    the plain versions (TOL_BF16, GRAD_REL)."""
    cfg = sa.FixedSparsityConfig(block=SPARSE_BLOCK,
                                 attention="unidirectional")
    layout = cfg.make_layout(SPARSE_S)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    q, k, v, do = rnd(1, SPARSE_S, H, D), rnd(1, SPARSE_S, KV, D), \
        rnd(1, SPARSE_S, KV, D), rnd(1, SPARSE_S, H, D)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    torch.cuda.synchronize()
    fa.reset_counts()
    out = sa.sparse_attention(q, k, v, cfg)
    dq, dk, dv = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    launches, plain = dict(fa.LAUNCHES), dict(fa.PLAIN_CALLS)
    if launches != {"flash_fwd": 1, "flash_bwd_dkdv": 1,
                    "flash_bwd_dq": 1} or any(plain.values()):
        fail(f"sparse attention: launches {launches}, plain {plain}")
    q, k, v = (t.detach() for t in leaves)
    mask = fa.AttnMask(True, 0, None, torch.as_tensor(
        layout, device="cuda").to(torch.int32), SPARSE_BLOCK, SPARSE_BLOCK)
    scale = 1.0 / math.sqrt(D)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, mask, scale)
    delta = fa.attention_delta(do, o_p)
    dk_p, dv_p = fa.flash_bwd_dkdv_plain(q, k, v, do, lse_p, delta, mask,
                                         scale)
    dq_p = fa.flash_bwd_dq_plain(q, k, v, do, lse_p, delta, mask, scale)
    torch.cuda.synchronize()
    return {"S": SPARSE_S, "block": SPARSE_BLOCK,
            "kept_blocks": int(layout.sum()), "blocks": int(layout.size),
            "max_abs_err": compare(out, o_p, TOL_BF16, "sparse attention o"),
            "max_abs_err_grads": {
                "dq": compare_grad(dq, dq_p, False, "sparse attention dq"),
                "dk": compare_grad(dk, dk_p, False, "sparse attention dk"),
                "dv": compare_grad(dv, dv_p, False, "sparse attention dv")},
            "launches": launches}


def run_training(torch, fa, profile: bool) -> dict:
    """bench.py's training step on the port: llama3-8b at full width, depth
    cut to TRAIN_LAYERS, bf16 parameters, AdamW, flash attention, tiled
    loss; TRAIN_WARMUP + TRAIN_STEPS steps on one fixed batch.  With
    ``profile``, one more step runs under ``torch.profiler``."""
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer as tfm
    from deepspeed_tpu_torch.runtime.engine import ModelSpec
    from deepspeed_tpu_torch.sequence.tiled_compute import tiled_loss_fn

    cfg = tfm.get_config("llama3-8b", num_layers=TRAIN_LAYERS,
                         param_dtype="bfloat16", attn_impl="flash")
    params = tfm.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), device="cuda", dtype=tfm.param_dtype(cfg))

    def loss_fn(p, batch, rng):
        return tiled_loss_fn(p, batch, cfg, tile_size=TILE)

    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=ModelSpec(loss_fn=loss_fn, params=params), config={
            "train_micro_batch_size_per_gpu": FB,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-4}},
            "zero_optimization": {"stage": 0},
            "steps_per_print": 10_000})
    del params  # the engine trains its own copy
    torch.cuda.empty_cache()
    batch = {"input_ids": np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, size=(engine.train_batch_size, FS)).astype(
            np.int32)}
    placed = engine.place_batch(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_counts()
    metrics = []
    t0 = time.perf_counter()
    for step in range(TRAIN_WARMUP + TRAIN_STEPS):
        if step == TRAIN_WARMUP:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        metrics.append(engine.train_batch(placed))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches, plain = dict(fa.LAUNCHES), dict(fa.PLAIN_CALLS)
    losses = [m["loss"] for m in metrics]
    steps = TRAIN_WARMUP + TRAIN_STEPS
    L = cfg.num_layers
    want = {"flash_fwd": 2 * L * steps, "flash_bwd_dkdv": L * steps,
            "flash_bwd_dq": L * steps}
    if not all(math.isfinite(x) for x in losses):
        fail(f"training: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"training: the loss did not fall on a fixed batch: {losses}")
    if launches != want:
        fail(f"training: flash launches {launches}, want {want} "
             f"(2L forward with the remat recompute, L each backward)")
    if any(plain.values()):
        fail(f"training: a plain attention version ran: {plain}")
    dt = (t2 - t1) / TRAIN_STEPS
    tokens_per_step = engine.train_batch_size * (FS - 1)
    # bench.py's count: 6 N (no embedding) + attention, per token
    flops_per_token = 6 * cfg.num_params(include_embed=False) \
        + 12 * cfg.num_layers * cfg.hidden_size * FS
    tps = tokens_per_step / dt
    from deepspeed_tpu_torch.accelerator import get_accelerator

    peak = get_accelerator().peak_tflops("bfloat16") * 1e12
    out = {"model": "llama3-8b", "layers": L, "params": cfg.num_params(),
           "micro_batch": FB, "seq": FS, "losses": losses,
           "warmup_s": t1 - t0, "step_ms": dt * 1e3, "tokens_per_s": tps,
           "mfu": tps * flops_per_token / peak,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches, "launches_per_step": {
               k: n // steps for k, n in launches.items()}}
    if profile:
        from torch.profiler import ProfilerActivity

        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            engine.train_batch(placed)
            torch.cuda.synchronize()
        out["profile"] = device_breakdown(torch, prof, dt)
    del engine, placed, metrics
    torch.cuda.empty_cache()
    return out


def small_training_agreement(torch, fa, cfg=None, kernels=None) -> dict:
    """A small llama-shaped f32 model (head dim 64, GQA, flash attention;
    ``cfg`` when given) trained 3 steps on the card (kernels) and on the
    CPU (plain versions) from the same weights: losses within TOL_TRAIN
    relative, final parameters within TOL_TRAIN.  ``kernels``: more kernel
    modules whose launches the card run must show, with no plain call."""
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer as tfm
    from deepspeed_tpu_torch.runtime.engine import ModelSpec
    from deepspeed_tpu_torch.runtime.optimizers import leaves
    from deepspeed_tpu_torch.sequence.tiled_compute import tiled_loss_fn

    cfg = cfg or tfm.get_config("tiny", hidden_size=256,
                                intermediate_size=512, num_heads=4,
                                num_kv_heads=2, dtype="float32",
                                param_dtype="float32", attn_impl="flash")
    mods = [fa, *(kernels or ())]
    params = tfm.init_params(cfg, torch.Generator().manual_seed(SEED),
                             device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(SEED)
    batches = [{"input_ids": rng.integers(0, cfg.vocab_size, size=(
        4, cfg.max_seq_len)).astype(np.int32)} for _ in range(3)]
    out = {}
    for dev in ("cuda", "cpu"):
        engine, _, _, _ = deepspeed_tpu_torch.initialize(
            model=ModelSpec(loss_fn=lambda p, b, r: tiled_loss_fn(
                p, b, cfg, tile_size=64), params=params), config={
                "train_micro_batch_size_per_gpu": 4,
                # bench.py's lr: Adam's first steps move each weight by
                # ~lr * g / |g|, so where |g| is near eps the card's and the
                # CPU's f32 rounding of g shows up in proportion to lr
                "optimizer": {"type": "adamw", "params": {
                    "lr": 1e-4, "weight_decay": 0.01}},
                "gradient_clipping": 1.0, "steps_per_print": 10_000},
            device=dev)
        for mod in mods:
            mod.reset_counts()
        losses = [engine.train_batch(b)["loss"] for b in batches]
        if dev == "cuda" and any(not all(m.LAUNCHES.values())
                                 or any(m.PLAIN_CALLS.values())
                                 for m in mods):
            fail(f"small training: the card run did not go through the "
                 f"kernels: {[(m.LAUNCHES, m.PLAIN_CALLS) for m in mods]}")
        out[dev] = (losses, [p.detach().cpu() for p in leaves(engine.params)])
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(out["cuda"][0],
                                                       out["cpu"][0]))
    param_diff = max((a - b).abs().max().item() for a, b in zip(
        out["cuda"][1], out["cpu"][1]))
    if not loss_rel <= TOL_TRAIN or not param_diff <= TOL_TRAIN:
        fail(f"small training: card vs CPU losses differ by {loss_rel} "
             f"(relative), parameters by {param_diff}")
    return {"losses_cuda": out["cuda"][0], "losses_cpu": out["cpu"][0],
            "loss_max_rel_diff": loss_rel, "param_max_abs_diff": param_diff}


# ---------------------------------------------------------------------------
# quantized serving: mixed GEMM (B6) and W8A8 (B7)
# ---------------------------------------------------------------------------

GEMM_KERNELS = {"mixed_gemm_int8": 8, "mixed_gemm_int4": 4,
                "mixed_gemm_fp6": 6, "int8_gemm": 8}


def check_mixed_gemm(torch, mg, flush) -> list:
    """B6 (bits 8, 4, 6) and B7 against their plain versions at llama3-8b's
    projection shapes, M = 8 and 256, group 256: bf16 x per element within
    TOL_BF16, f32 x within GEMM_F32_REL of the largest output; kernel /
    plain / library / bound ms of the bf16 call.  The library call is one
    bf16 ``torch.matmul`` of x by the dequantized bf16 weight (the
    dequantization excluded): the stock path the kernel replaces."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows = []
    for shape_name, (K, N) in GEMM_SHAPES.items():
        w = torch.randn((K, N), generator=gen, device="cuda") / math.sqrt(K)
        for name, bits in GEMM_KERNELS.items():
            qw = mg.quantize_gemm_weight(w, bits=bits, group=QUANT_GROUP)
            if not mg.mixed_gemm_on_kernel_path(qw):
                fail(f"{name} {shape_name}: off the reference's kernel path")
            w_lib = mg.dequantize_gemm_weight(qw).to(torch.bfloat16)
            code_bytes = qw.codes.numel() + qw.scales.numel() * 4
            for M in GEMM_MS:
                x = torch.randn((M, K), generator=gen, device="cuda",
                                dtype=torch.bfloat16)
                errs = {}
                for xd in (x, x.float()):
                    if name == "int8_gemm":
                        xc, xs = mg.quantize_activations_rowwise(
                            xd, QUANT_GROUP)
                        out = mg.int8_gemm_quantized(xc, xs, qw, xd.dtype)
                        ref = mg.int8_gemm_quantized_plain(xc, xs, qw,
                                                           xd.dtype)
                    else:
                        out, ref = mg.mixed_gemm(xd, qw), \
                            mg.mixed_gemm_plain(xd, qw)
                    torch.cuda.synchronize()
                    what = f"{name} {shape_name} M={M}"
                    if xd.dtype == torch.bfloat16:
                        errs["bf16"] = compare(out, ref, TOL_BF16,
                                               f"{what} (bf16)")
                    else:
                        errs["f32"] = compare_grad(out, ref, True,
                                                   f"{what} (f32)",
                                                   rel=GEMM_F32_REL)
                cuda_kernel = None
                if name == "int8_gemm":
                    xc, xs = mg.quantize_activations_rowwise(x, QUANT_GROUP)
                    # M = 8 runs the mma.sync kernel, M = 256 the wgmma one
                    wgmma = mg.int8_uses_wgmma(xc, qw)
                    if wgmma != (M > 16):
                        fail(f"int8_gemm {shape_name} M={M}: dispatched to "
                             f"the {'wgmma' if wgmma else 'mma.sync'} "
                             "kernel")
                    cuda_kernel = ("int8_gemm_wgmma_kernel" if wgmma
                                   else "int8_gemm_mma_kernel")

                    def kernel():
                        return mg.int8_gemm_quantized(xc, xs, qw, x.dtype)

                    def plain():
                        return mg.int8_gemm_quantized_plain(xc, xs, qw,
                                                            x.dtype)

                    in_bytes = M * K + xs.numel() * 4  # int8 codes, scales
                    peak = INT8_OPS_PER_S
                else:
                    def kernel():
                        return mg.mixed_gemm(x, qw)

                    def plain():
                        return mg.mixed_gemm_plain(x, qw)

                    in_bytes = M * K * 2
                    peak = BF16_FLOPS_PER_S
                b_ms, b_by = bound(code_bytes + in_bytes + M * N * 2,
                                   2 * M * K * N, peak)
                rows.append({
                    "name": name, "shape": shape_name, "K": K, "N": N,
                    "M": M, **({"kernel": cuda_kernel} if cuda_kernel else {}),
                    "max_abs_err": errs["bf16"],
                    "max_abs_err_f32": errs["f32"],
                    "ms": time_ms(kernel, torch, flush),
                    "plain_ms": time_ms(plain, torch, flush, iters=5,
                                        warmup=1),
                    "library_ms": time_ms(lambda: torch.matmul(x, w_lib),
                                          torch, flush),
                    "bound_ms": b_ms, "bound_by": b_by})
            del qw, w_lib
        del w
    return rows


def int8_gemm_path(torch, mg, params) -> dict:
    """``int8_gemm`` as a caller uses it: the seven projections of layer 0
    of a bits=8 quantized llama3-8b, each at M = 8 and 256, bf16 x.  The
    output must be finite and int8-grade against x @ dequant(W): mean
    relative error below 5% (the reference's own check)."""
    from deepspeed_tpu_torch.models import transformer as tfm

    layer = tfm.layer_params(params, 0)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    mg.reset_counts()
    worst = 0.0
    for part, keys in (("attn", ("wq", "wk", "wv", "wo")),
                       ("mlp", ("w_gate", "w_in", "w_out"))):
        for key in keys:
            qw = layer[part][key]
            for M in GEMM_MS:
                x = torch.randn((M, qw.k_features), generator=gen,
                                device="cuda", dtype=torch.bfloat16)
                out = mg.int8_gemm(x, qw)
                exact = x.float() @ mg.dequantize_gemm_weight(qw)
                if not torch.isfinite(out).all().item():
                    fail(f"int8_gemm {key} M={M}: output not finite")
                rel = ((out.float() - exact).abs().mean()
                       / exact.abs().mean()).item()
                if not rel < 0.05:
                    fail(f"int8_gemm {key} M={M}: mean relative error {rel}")
                worst = max(worst, rel)
    launches = mg.LAUNCHES["int8_gemm"]
    wgmma = mg.WGMMA_LAUNCHES["int8_gemm"]
    if launches != 2 * PROJECTIONS or any(mg.PLAIN_CALLS.values()) \
            or any(mg.DEQUANT_CALLS.values()):
        fail(f"int8_gemm path: {mg.LAUNCHES} {mg.PLAIN_CALLS} "
             f"{mg.DEQUANT_CALLS}, want {2 * PROJECTIONS} kernel launches")
    # each projection's M = 256 call runs int8_gemm_wgmma_kernel, its M = 8
    # call int8_gemm_mma_kernel
    if wgmma != PROJECTIONS:
        fail(f"int8_gemm path: {wgmma} int8_gemm_wgmma_kernel launches, "
             f"want {PROJECTIONS} (the M = 256 calls)")
    return {"launches": launches, "wgmma_launches": wgmma,
            "worst_mean_rel_err": worst}


def run_quantized_engine(torch, pa, mg, profile: bool) -> dict:
    """The engine phase's model, V2Config, prompts and new tokens, served
    quantized: W8A16 cold and warm (and, with ``profile``, traced), then
    W4A16 and W6A16, each engine freed before the next is built."""
    import numpy as np

    from deepspeed_tpu_torch.inference.quantization import quantized_bytes
    from deepspeed_tpu_torch.inference.v2.engine import (InferenceEngineV2,
                                                         V2Config)
    from deepspeed_tpu_torch.models import transformer as tfm

    cfg = tfm.get_config("llama3-8b")
    params = tfm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in PROMPT_LENS]

    def v2(bits):
        return V2Config(max_tokens_per_step=256, max_seqs=8, block_size=BS,
                        num_blocks=NB, max_blocks_per_seq=MB,
                        dtype="bfloat16", quantize_bits=bits,
                        quantize_group=QUANT_GROUP)

    # the bf16 engine's first mixed step, for the W8A16 logits delta
    eng = InferenceEngineV2(cfg, params, v2(0))
    for p in prompts:
        eng.put(p, max_new_tokens=NEW_TOKENS)
    eng.step()
    bf16_logits = eng.last_logits.clone()
    del eng
    torch.cuda.empty_cache()

    def trace():
        from torch.profiler import ProfilerActivity
        return torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA])

    out = {"model": "llama3-8b", "layers": cfg.num_layers,
           "group": QUANT_GROUP}
    prompt_tokens = sum(PROMPT_LENS)
    for bits in (8, 4, 6):
        kernel = {8: "mixed_gemm_int8", 4: "mixed_gemm_int4",
                  6: "mixed_gemm_fp6"}[bits]
        n_runs = (3 if profile else 2) if bits == 8 else 1
        runs = []
        for attempt in range(n_runs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            eng = InferenceEngineV2(cfg, params, v2(bits))
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            pa.reset_counts()
            mg.reset_counts()
            run = serve(torch, eng, prompts, trace if attempt == 2 else None)
            run.update(build_s=build_s, launches=dict(pa.LAUNCHES),
                       mixed=dict(mg.LAUNCHES), wgmma=dict(mg.WGMMA_LAUNCHES),
                       plain=dict(mg.PLAIN_CALLS),
                       dequant=dict(mg.DEQUANT_CALLS),
                       attn_plain=dict(pa.PLAIN_CALLS),
                       qbytes=quantized_bytes(eng.params),
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9)
            if bits == 8 and attempt == 0:
                run["int8_gemm_path"] = int8_gemm_path(torch, mg,
                                                       eng.params)
            runs.append(run)
            del eng
            torch.cuda.empty_cache()
        tag = f"quantized engine (quantize_bits={bits})"
        for run in runs:
            paged = sum(run["launches"].values())
            if run["mixed"][kernel] != PROJECTIONS * paged or paged == 0:
                fail(f"{tag}: {kernel} launched {run['mixed'][kernel]} "
                     f"times for {paged} paged-attention launches, want "
                     f"{PROJECTIONS} per paged launch")
            # every mixed step has more than 16 rows: its projections run
            # the wgmma kernel, one per prefill-attention launch
            prefill = run["launches"]["paged_prefill_attention"]
            if run["wgmma"][kernel] != PROJECTIONS * prefill or prefill == 0:
                fail(f"{tag}: mixed_gemm_wgmma_kernel launched "
                     f"{run['wgmma'][kernel]} times for {prefill} prefill "
                     f"launches, want {PROJECTIONS} per prefill launch")
            if any(run["plain"].values()) or any(run["dequant"].values()) \
                    or any(run["attn_plain"].values()):
                fail(f"{tag}: a plain or dequantize path ran: {run['plain']}"
                     f" {run['dequant']} {run['attn_plain']}")
            if not run["probes_finite"] or not all(run["probes_finite"]):
                fail(f"{tag}: a mixed step's logits were not finite")
            for uid, prompt in zip(run["uids"], prompts):
                toks = run["results"][uid]
                new = toks[len(prompt):]
                if toks[:len(prompt)] != prompt or len(new) != NEW_TOKENS:
                    fail(f"{tag}: request {uid}: {len(new)} new tokens")
                if not all(0 <= t < cfg.vocab_size for t in new):
                    fail(f"{tag}: request {uid}: token outside the vocab")
        if bits == 8:
            first = [runs[0]["results"][u][len(p):]
                     for u, p in zip(runs[0]["uids"], prompts)]
            second = [runs[1]["results"][u][len(p):]
                      for u, p in zip(runs[1]["uids"], prompts)]
            if second != first:
                fail(f"{tag}: the warm run gave other tokens than the cold")

        def rates(r):
            decode_tokens = len(prompts) * NEW_TOKENS - r["prefill_emitted"]
            return {"build_s": r["build_s"], "mixed_steps": r["mixed_steps"],
                    "prefill_s": r["prefill_s"],
                    "prefill_tokens_per_s": prompt_tokens / r["prefill_s"],
                    "decode_s": r["decode_s"],
                    "decode_tokens_per_s": decode_tokens / r["decode_s"],
                    "peak_mem_gb": r["peak_gb"]}

        res = {"runs": [rates(r) for r in runs[:2]],
               "launches": {kernel: runs[0]["mixed"][kernel],
                            f"{kernel}_wgmma": runs[0]["wgmma"][kernel],
                            **runs[0]["launches"]},
               "quantized_bytes": runs[0]["qbytes"]}
        if bits == 8:
            res["first_step_max_abs_dlogits_vs_bf16"] = (
                runs[0]["first_logits"] - bf16_logits).abs().max().item()
            res["int8_gemm_path"] = runs[0]["int8_gemm_path"]
            if profile:
                r, warm = runs[2], runs[1]
                res["profile"] = {
                    "prefill": device_breakdown(torch, r["profiles"][0],
                                                warm["prefill_s"]),
                    "decode": device_breakdown(torch, r["profiles"][1],
                                               warm["decode_s"])}
                if "mixed_gemm_wgmma_kernel" not in \
                        res["profile"]["prefill"]["port_kernels_ms"]:
                    fail(f"{tag}: no mixed_gemm_wgmma_kernel in the "
                         "prefill trace")
        out[f"w{bits}a16"] = res
        del runs
    del params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# dropless MoE: grouped matmul (B8), Mixtral serving; fused AdamW (B9)
# ---------------------------------------------------------------------------


def grouped_inputs(torch, gm, K: int, N: int, T: int, gen, dtype):
    """Seeded top-2 routing of T assignments over MOE_E experts, planned
    into the tile-aligned layout with the dropless block's own m-tile; lhs
    (M_pad, K) with random real rows and zero padding rows, as the block
    scatters them; rhs (E, K, N)."""
    from deepspeed_tpu_torch.moe.dropless import default_tile_m

    tile_m = default_tile_m(T, MOE_E)
    ef = torch.randint(0, MOE_E, (T,), generator=gen, device="cuda")
    pos, tg, sizes, M_pad, used = gm.tile_aligned_layout(
        ef, MOE_E, T, tile_m, with_used_tiles=True)
    lhs = torch.zeros((M_pad, K), device="cuda", dtype=dtype)
    lhs[pos.long()] = torch.randn((T, K), generator=gen, device="cuda",
                                  dtype=dtype)
    rhs = torch.randn((MOE_E, K, N), generator=gen, device="cuda",
                      dtype=dtype).mul_(1.0 / math.sqrt(K))
    touched = int((torch.bincount(ef, minlength=MOE_E) > 0).sum().item())
    return lhs, rhs, tg, sizes, used, tile_m, pos, touched


def library_grouped_mm(torch, lhs, rhs, sizes):
    """One PyTorch call computing the same grouped product on the same
    padded rows: ``torch._grouped_mm`` with each group's end row as its
    offset where the installed torch has it (and takes these shapes), else
    a loop of ``torch.matmul`` over the experts.  Returns (name, fn)."""
    offs = torch.cumsum(sizes, 0).to(torch.int32)
    bounds = [0] + offs.tolist()
    if hasattr(torch, "_grouped_mm"):
        try:
            out = torch._grouped_mm(lhs, rhs, offs=offs)
            torch.cuda.synchronize()
            if out.shape == (lhs.shape[0], rhs.shape[2]):
                return "torch._grouped_mm", lambda: torch._grouped_mm(
                    lhs, rhs, offs=offs)
        except (RuntimeError, TypeError, ValueError) as e:
            print(f"  torch._grouped_mm refused these shapes: "
                  f"{str(e).splitlines()[0][:160]}")

    def loop():
        return torch.cat([lhs[a:b] @ rhs[e] for e, (a, b) in
                          enumerate(zip(bounds[:-1], bounds[1:]))])
    return "matmul loop over experts", loop


def check_grouped_matmul(torch, gm, flush) -> list:
    """B8 against its plain version at Mixtral's expert shapes, for T = 16
    and 512 assignments: forward and on transposed weights (dlhs), bf16
    per element within TOL_BF16, f32 within GMM_F32_REL of the largest
    output; the all-padding tail must be zeros.  Kernel / plain / library /
    bound ms of the bf16 forward.  Bound: the touched experts' weights, the
    real lhs rows and the real output rows once, against 2 T K N flops."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    rows = []
    for shape_name, (K, N) in MOE_SHAPES.items():
        for T in MOE_T:
            lhs, rhs, tg, sizes, used, tile_m, pos, touched = grouped_inputs(
                torch, gm, K, N, T, gen, torch.bfloat16)
            # dlhs's g: random rows where the forward's output is real
            g = torch.zeros((lhs.shape[0], N), device="cuda",
                            dtype=torch.bfloat16)
            g[pos.long()] = torch.randn((T, N), generator=gen, device="cuda",
                                        dtype=torch.bfloat16)
            tail = int(used.item()) * tile_m
            errs = {}
            for f32 in (False, True):
                a, w, gg = ((t.float() for t in (lhs, rhs, g)) if f32
                            else (lhs, rhs, g))
                tag = f"grouped_matmul {shape_name} T={T}"
                gm.reset_counts()
                outs = {
                    "fwd": (gm.grouped_matmul(a, w, tg, sizes, tile_m=tile_m,
                                              num_used_tiles=used),
                            gm.grouped_matmul_plain(a, w, tg, tile_m)),
                    "dlhs": (gm.grouped_matmul(gg, w, tg, sizes,
                                               tile_m=tile_m,
                                               num_used_tiles=used,
                                               rhs_transposed=True),
                             gm.grouped_matmul_plain(gg, w, tg, tile_m,
                                                     rhs_transposed=True))}
                torch.cuda.synchronize()
                # bf16 forward at tile_m 64 (T = 512): the wgmma kernel,
                # once; everything else the mma.sync / CUDA-core kernels
                want = int(not f32 and T > 16 * MOE_E)
                if gm.WGMMA_LAUNCHES["grouped_matmul"] != want:
                    fail(f"{tag}: {gm.WGMMA_LAUNCHES} wgmma launches, want "
                         f"{want}")
                for part, (out, ref) in outs.items():
                    what = f"{tag} {part} ({'f32' if f32 else 'bf16'})"
                    if out[tail:].abs().max().item() != 0.0:
                        fail(f"{what}: the all-padding tiles are not zero")
                    errs[(part, f32)] = (
                        compare_grad(out, ref, True, what, rel=GMM_F32_REL)
                        if f32 else compare(out, ref, TOL_BF16, what))
                del a, w, gg, outs
            lib_name, library = library_grouped_mm(torch, lhs, rhs, sizes)
            nbytes = touched * K * N * 2 + T * K * 2 + T * N * 2
            b_ms, b_by = bound(nbytes, 2 * T * K * N)
            rows.append({
                "name": "grouped_matmul", "shape": shape_name, "K": K,
                "N": N, "T": T, "tile_m": tile_m, "M_pad": lhs.shape[0],
                "kernel": ("grouped_matmul_wgmma_kernel" if gm.uses_wgmma(
                    lhs.dtype, tile_m, False)
                    else "grouped_matmul_bf16_kernel"),
                "used_tiles": int(used.item()), "experts_touched": touched,
                "max_abs_err": errs[("fwd", False)],
                "max_abs_err_f32": errs[("fwd", True)],
                "max_abs_err_dlhs": errs[("dlhs", False)],
                "max_abs_err_dlhs_f32": errs[("dlhs", True)],
                "ms": time_ms(lambda: gm.grouped_matmul(
                    lhs, rhs, tg, sizes, tile_m=tile_m,
                    num_used_tiles=used), torch, flush),
                "dlhs_ms": time_ms(lambda: gm.grouped_matmul(
                    g, rhs, tg, sizes, tile_m=tile_m, num_used_tiles=used,
                    rhs_transposed=True), torch, flush),
                "plain_ms": time_ms(lambda: gm.grouped_matmul_plain(
                    lhs, rhs, tg, tile_m), torch, flush, iters=5, warmup=1),
                "library": lib_name,
                "library_ms": time_ms(library, torch, flush),
                "bound_ms": b_ms, "bound_by": b_by})
            del lhs, rhs, g
            torch.cuda.empty_cache()
    return rows


def decode_body_syncs(torch, eng) -> str:
    """Run one decode body of ``eng`` (every request in decode) under
    ``torch.cuda.set_sync_debug_mode("error")``: any operation that waits
    for the device from inside the body raises.  The inputs are placed
    before, as the engine places them."""
    tok, pos, bt, ctx = eng._table_inputs()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits = eng._decode(tok, pos, bt, ctx)
    except RuntimeError as e:
        return str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if not torch.isfinite(logits).all().item():
        return "decode body logits not finite"
    return ""


def run_moe_engine(torch, pa, gm, profile: bool) -> dict:
    """Dropless Mixtral-8x7B, full width, MOE_LAYERS of 32 layers, bf16
    weights drawn on the card, served with the bf16 phase's V2Config,
    prompt lengths and new tokens (ids below Mixtral's vocabulary): cold
    and warm (and, with ``profile``, traced).  Then one decode body runs
    under the sync check."""
    import numpy as np

    from deepspeed_tpu_torch.inference.v2.engine import (InferenceEngineV2,
                                                         V2Config)
    from deepspeed_tpu_torch.models import transformer as tfm

    cfg = tfm.get_config("mixtral-8x7b", moe_routing="dropless",
                         num_layers=MOE_LAYERS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tfm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_gb = torch.cuda.memory_allocated() / 1e9
    v2 = V2Config(max_tokens_per_step=256, max_seqs=8, block_size=BS,
                  num_blocks=NB, max_blocks_per_seq=MB, dtype="bfloat16")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in PROMPT_LENS]

    def trace():
        from torch.profiler import ProfilerActivity
        return torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA])

    tag = "dropless Mixtral engine"
    runs = []
    for attempt in range(3 if profile else 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = InferenceEngineV2(cfg, params, v2)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        pa.reset_counts()
        gm.reset_counts()
        run = serve(torch, eng, prompts, trace if attempt == 2 else None)
        run.update(build_s=build_s, launches=dict(pa.LAUNCHES),
                   gmm=dict(gm.LAUNCHES), gmm_wgmma=dict(gm.WGMMA_LAUNCHES),
                   gmm_plain=dict(gm.PLAIN_CALLS),
                   attn_plain=dict(pa.PLAIN_CALLS),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        runs.append(run)
        del eng
        torch.cuda.empty_cache()
    for run in runs:
        paged = sum(run["launches"].values())
        if paged == 0 or run["gmm"]["grouped_matmul"] != 3 * paged:
            fail(f"{tag}: grouped_matmul launched "
                 f"{run['gmm']['grouped_matmul']} times for {paged} "
                 f"paged-attention launches, want 3 per paged launch")
        # a mixed step routes more than 128 assignments (tile_m 64): its
        # grouped GEMMs run the wgmma kernel, one per prefill launch; a
        # decode body's 16 (tile_m 16) the mma.sync kernel
        prefill = run["launches"]["paged_prefill_attention"]
        wgmma = run["gmm_wgmma"]["grouped_matmul"]
        if prefill == 0 or wgmma != 3 * prefill:
            fail(f"{tag}: grouped_matmul_wgmma_kernel launched {wgmma} "
                 f"times for {prefill} prefill launches, want 3 per prefill "
                 "launch")
        if run["gmm"]["grouped_matmul"] - wgmma != \
                3 * run["launches"]["paged_decode_attention"]:
            fail(f"{tag}: {run['gmm']['grouped_matmul'] - wgmma} mma.sync "
                 "grouped launches, want 3 per decode launch")
        if any(run["gmm_plain"].values()) or any(run["attn_plain"].values()):
            fail(f"{tag}: a plain version ran: {run['gmm_plain']} "
                 f"{run['attn_plain']}")
        if not run["probes_finite"] or not all(run["probes_finite"]):
            fail(f"{tag}: a mixed step's logits were not finite")
        for uid, prompt in zip(run["uids"], prompts):
            toks = run["results"][uid]
            new = toks[len(prompt):]
            if toks[:len(prompt)] != prompt or len(new) != NEW_TOKENS:
                fail(f"{tag}: request {uid}: {len(new)} new tokens")
            if not all(0 <= t < cfg.vocab_size for t in new):
                fail(f"{tag}: request {uid}: token outside the vocab")
    first = [runs[0]["results"][u][len(p):]
             for u, p in zip(runs[0]["uids"], prompts)]
    second = [runs[1]["results"][u][len(p):]
              for u, p in zip(runs[1]["uids"], prompts)]
    if second != first:
        fail(f"{tag}: the warm run gave other tokens than the cold")

    # one decode body, every request in decode, under the sync check
    eng = InferenceEngineV2(cfg, params, v2)
    for p in prompts:
        eng.put(p, max_new_tokens=NEW_TOKENS)
    while eng.num_waiting or eng._prefilling:
        eng.step()
    sync = decode_body_syncs(torch, eng)
    if sync:
        fail(f"{tag}: a decode body waited for the device: {sync}")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()

    prompt_tokens = sum(PROMPT_LENS)

    def rates(r):
        decode_tokens = len(prompts) * NEW_TOKENS - r["prefill_emitted"]
        return {"build_s": r["build_s"], "mixed_steps": r["mixed_steps"],
                "prefill_s": r["prefill_s"],
                "prefill_tokens_per_s": prompt_tokens / r["prefill_s"],
                "decode_s": r["decode_s"], "decode_tokens": decode_tokens,
                "decode_tokens_per_s": decode_tokens / r["decode_s"],
                "peak_mem_gb": r["peak_gb"]}

    out = {"model": "mixtral-8x7b", "moe_routing": "dropless",
           "layers": cfg.num_layers, "params": cfg.num_params(),
           "param_gb": param_gb, "init_s": init_s,
           "prompt_tokens": prompt_tokens,
           "cold": rates(runs[0]), "warm": rates(runs[1]),
           "launches": {**runs[0]["gmm"], **runs[0]["launches"],
                        "grouped_matmul_wgmma":
                        runs[0]["gmm_wgmma"]["grouped_matmul"]},
           "decode_body_host_syncs": 0}
    if profile:
        r, warm = runs[2], runs[1]
        out["profile"] = {
            "prefill": device_breakdown(torch, r["profiles"][0],
                                        warm["prefill_s"]),
            "decode": device_breakdown(torch, r["profiles"][1],
                                       warm["decode_s"])}
        if "grouped_matmul_wgmma_kernel" not in \
                out["profile"]["prefill"]["port_kernels_ms"]:
            fail(f"{tag}: no grouped_matmul_wgmma_kernel in the prefill "
                 "trace")
    return out


def small_moe_cfg(tfm, routing: str, **kw):
    """A small f32 MoE model in the tiny-moe family: head dim 64, GQA."""
    return tfm.get_config("tiny-moe", hidden_size=256, intermediate_size=512,
                          num_heads=4, num_kv_heads=2, dtype="float32",
                          moe_routing=routing, **kw)


def check_fused_adam(torch, fo, flush) -> dict:
    """B9 against its plain version on ADAM_N f32 parameters, two steps
    with weight decay, each side from its own outputs: p, m and v within
    ADAM_REL of each tensor's largest element.  Kernel / plain / library
    (``torch.optim.AdamW(fused=True)`` on the same flat tensor: decay
    folded as p (1 - lr wd) and eps outside sqrt(v)/sqrt(bc2), the same
    update algebraically, not bit for bit) / bound ms of one step: 28 bytes
    per element (read p, g, m, v; write p, m, v) at 3.35 TB/s."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    n = ADAM_N
    p = torch.randn(n, generator=gen, device="cuda")
    m = torch.zeros(n, device="cuda")
    v = torch.zeros(n, device="cuda")
    k_state = p_state = (p, m, v)
    for step in (1, 2):
        g = torch.randn(n, generator=gen, device="cuda")
        st = torch.tensor(step, dtype=torch.int32, device="cuda")
        k_state = fo.fused_adamw_flat(*k_state[:1], g, *k_state[1:], st,
                                      **ADAM_HYPER)
        p_state = fo.adamw_plain(*p_state[:1], g, *p_state[1:], st,
                                 **ADAM_HYPER)
    torch.cuda.synchronize()
    errs = [compare_grad(a, b, True, f"fused_adamw {name}", rel=ADAM_REL)
            for name, a, b in zip("pmv", k_state, p_state)]
    del p_state
    pk, mk, vk = k_state
    st = torch.tensor(3, dtype=torch.int32, device="cuda")
    out = {"name": "fused_adamw", "n": n, "max_abs_err": max(errs),
           "max_abs_err_f32": max(errs),
           "ms": time_ms(lambda: fo.fused_adamw_flat(
               pk, g, mk, vk, st, **ADAM_HYPER), torch, flush),
           "plain_ms": time_ms(lambda: fo.adamw_plain(
               pk, g, mk, vk, st, **ADAM_HYPER), torch, flush, iters=5,
               warmup=1)}
    param = torch.nn.Parameter(pk.clone())
    param.grad = g
    opt = torch.optim.AdamW([param], lr=ADAM_HYPER["lr"],
                            betas=(ADAM_HYPER["b1"], ADAM_HYPER["b2"]),
                            eps=ADAM_HYPER["eps"],
                            weight_decay=ADAM_HYPER["weight_decay"],
                            fused=True)
    out["library_ms"] = time_ms(opt.step, torch, flush)
    out["bound_ms"], out["bound_by"] = bound(28 * n, 18 * n, F32_FLOPS_PER_S)
    del param, opt, k_state, pk, mk, vk, g, p, m, v
    torch.cuda.empty_cache()
    return out


def fused_adam_tree_path(torch, fo, tfm) -> dict:
    """``fused_adamw_tree`` as a caller uses it: the small MoE model's
    parameters, 3 steps on the card, each one kernel launch, against the
    same steps on the CPU (plain version): parameters within ADAM_REL of
    each leaf's largest element."""
    params = tfm.init_params(small_moe_cfg(tfm, "dropless"),
                             torch.Generator().manual_seed(SEED),
                             device="cpu", dtype=torch.float32)
    gen = torch.Generator().manual_seed(SEED + 7)

    def tree_map(fn, tree):
        if isinstance(tree, dict):
            return {k: tree_map(fn, v) for k, v in tree.items()}
        return fn(tree)

    def flat(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in flat(v)]
        return [tree]

    grads = [tree_map(lambda x: torch.randn(x.shape, generator=gen), params)
             for _ in range(3)]
    out = {}
    for dev in ("cuda", "cpu"):
        ps = tree_map(lambda x: x.to(dev), params)
        state = fo.init_fused_adam_state(ps)
        fo.reset_counts()
        for g in grads:
            ps, state = fo.fused_adamw_tree(
                ps, tree_map(lambda x: x.to(dev), g), state, **ADAM_HYPER)
        out[dev] = ([x.cpu() for x in flat(ps)], dict(fo.LAUNCHES),
                    dict(fo.PLAIN_CALLS))
    _, launches, plain = out["cuda"]
    if launches != {"fused_adamw": len(grads)} or any(plain.values()):
        fail(f"fused_adamw_tree: {launches} {plain}, want one launch per "
             f"call for {len(grads)} calls")
    worst = max(compare_grad(a, b, True, "fused_adamw_tree", rel=ADAM_REL)
                for a, b in zip(out["cuda"][0], out["cpu"][0]))
    return {"launches": launches["fused_adamw"], "calls": len(grads),
            "leaves": len(out["cpu"][0]),
            "elements": sum(x.numel() for x in out["cpu"][0]),
            "param_max_abs_diff": worst}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace a third run's phases of the bf16, W8A16 and "
                    "dropless MoE engines and one more training step with "
                    "torch.profiler and print where the device time goes")
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    try:
        from deepspeed_tpu_torch.models import transformer as tfm
        from deepspeed_tpu_torch.ops import evoformer as ev
        from deepspeed_tpu_torch.ops import fused_optimizers as fo
        from deepspeed_tpu_torch.ops import sparse_attention as sa
        from deepspeed_tpu_torch.ops.hopper import build
        from deepspeed_tpu_torch.ops.hopper import flash_attention as fa
        from deepspeed_tpu_torch.ops.hopper import grouped_matmul as gm
        from deepspeed_tpu_torch.ops.hopper import mixed_gemm as mg
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
    kernel = ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = kernel_name(line)
        elif "registers" in line or "spill" in line:
            print(f"  ptxas: {kernel}: {line.strip()}")

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    kernels = [check_decode(torch, pa, flush), check_prefill(torch, pa, flush)]
    del flush
    for k in kernels:
        edges = (f"split {k['split']}, split edges max_abs_err "
                 f"{k['max_abs_err_split_edges']:.3e}, "
                 if "split" in k else "")
        edges += "".join(f"block size {bs} max_abs_err {e:.3e}, " for bs, e
                         in k.get("max_abs_err_block_sizes", {}).items())
        print(f"{k['name']}: max_abs_err {k['max_abs_err']:.3e} "
              f"(bf16, limit atol+rtol {TOL_BF16}), "
              f"{k['max_abs_err_f32']:.3e} (f32, limit {TOL_F32}) {edges}"
              f"kernel_ms {k['ms']:.4f} plain_ms "
              f"{k['plain_ms']:.4f} library_ms {k['library_ms']:.4f} "
              f"bound_ms {k['bound_ms']:.5f} ({k['bound_by']})")

    engine = run_engine(torch, pa, args.profile)
    launches = engine["launches"]
    print("engine: " + json.dumps(engine))
    small = small_model_agreement(torch)
    print("small model card vs CPU: " + json.dumps(small))
    gc.collect()
    torch.cuda.empty_cache()

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    flash = check_flash(torch, fa, flush)
    del flush
    gc.collect()
    torch.cuda.empty_cache()
    for k in flash:
        print(f"{k['name']}: max_abs_err {k['max_abs_err']:.3e} (bf16, "
              f"{k['margin_bf16']:.3e} past its limit), "
              f"{k['max_abs_err_f32']:.3e} (f32; o/lse limit {TOL_F32}, "
              f"grads {GRAD_REL} of max) kernel_ms {k['ms']:.4f} plain_ms "
              f"{k['plain_ms']:.4f} library_ms {k['library_ms']:.4f} "
              f"bound_ms {k['bound_ms']:.5f} ({k['bound_by']})")
    training = run_training(torch, fa, args.profile)
    launches.update(training["launches"])
    print("training: " + json.dumps(training))
    small_train = small_training_agreement(torch, fa)
    print("small training card vs CPU: " + json.dumps(small_train))
    gc.collect()
    torch.cuda.empty_cache()

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    gemm = check_mixed_gemm(torch, mg, flush)
    del flush
    gc.collect()
    torch.cuda.empty_cache()
    for k in gemm:
        print(f"{k['name']} {k['shape']} (K={k['K']}, N={k['N']}) M={k['M']}:"
              f" max_abs_err {k['max_abs_err']:.3e} (bf16, limit atol+rtol "
              f"{TOL_BF16}), {k['max_abs_err_f32']:.3e} (f32, limit "
              f"{GEMM_F32_REL} of max) kernel_ms {k['ms']:.4f} plain_ms "
              f"{k['plain_ms']:.4f} library_ms {k['library_ms']:.4f} "
              f"bound_ms {k['bound_ms']:.5f} ({k['bound_by']})")
    quant = run_quantized_engine(torch, pa, mg, args.profile)
    print("quantized engine: " + json.dumps(quant))
    small_quant = [small_model_agreement(torch, bits) for bits in (8, 4, 6)]
    print("small quantized model card vs CPU: " + json.dumps(small_quant))
    # mixed-GEMM launches by row count: a decode body's M = 8 calls run
    # mixed_gemm_kernel, a mixed step's (M > 16) mixed_gemm_wgmma_kernel;
    # int8_gemm's own path runs M = 8 and 256 once per projection each (M =
    # 8 on int8_gemm_mma_kernel, M = 256 on int8_gemm_wgmma_kernel)
    decode_m, step_m = GEMM_MS
    gemm_launches = {}
    for name, bits in GEMM_KERNELS.items():
        if name == "int8_gemm":
            continue
        counts = quant[f"w{bits}a16"]["launches"]
        gemm_launches[name, step_m] = counts[f"{name}_wgmma"]
        gemm_launches[name, decode_m] = counts[name] - counts[f"{name}_wgmma"]
    int8_path = quant["w8a16"]["int8_gemm_path"]
    gemm_launches["int8_gemm", step_m] = int8_path["wgmma_launches"]
    gemm_launches["int8_gemm", decode_m] = \
        int8_path["launches"] - int8_path["wgmma_launches"]
    gc.collect()
    torch.cuda.empty_cache()

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    gmm = check_grouped_matmul(torch, gm, flush)
    del flush
    gc.collect()
    torch.cuda.empty_cache()
    for k in gmm:
        print(f"grouped_matmul {k['shape']} (K={k['K']}, N={k['N']}) "
              f"T={k['T']} tile_m={k['tile_m']}: max_abs_err "
              f"{k['max_abs_err']:.3e} / dlhs {k['max_abs_err_dlhs']:.3e} "
              f"(bf16, limit atol+rtol {TOL_BF16}), "
              f"{k['max_abs_err_f32']:.3e} / {k['max_abs_err_dlhs_f32']:.3e}"
              f" (f32, limit {GMM_F32_REL} of max) kernel_ms {k['ms']:.4f} "
              f"dlhs_ms {k['dlhs_ms']:.4f} plain_ms {k['plain_ms']:.4f} "
              f"library_ms {k['library_ms']:.4f} ({k['library']}) "
              f"bound_ms {k['bound_ms']:.5f} ({k['bound_by']})")
    moe = run_moe_engine(torch, pa, gm, args.profile)
    print("dropless MoE engine: " + json.dumps(moe))
    small_moe = [small_model_agreement(
        torch, cfg=small_moe_cfg(tfm, routing),
        kernel=gm if routing == "dropless" else None)
        for routing in ("dropless", "capacity")]
    print("small MoE model card vs CPU (dropless, capacity): "
          + json.dumps(small_moe))
    small_moe_train = small_training_agreement(
        torch, fa, cfg=small_moe_cfg(tfm, "dropless", param_dtype="float32",
                                     attn_impl="flash"), kernels=[gm])
    print("small MoE training card vs CPU: " + json.dumps(small_moe_train))
    gc.collect()
    torch.cuda.empty_cache()

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    adam = check_fused_adam(torch, fo, flush)
    del flush
    gc.collect()
    torch.cuda.empty_cache()
    print(f"fused_adamw n={adam['n']}: max_abs_err {adam['max_abs_err']:.3e}"
          f" (f32, limit {ADAM_REL} of max) kernel_ms {adam['ms']:.4f} "
          f"plain_ms {adam['plain_ms']:.4f} library_ms "
          f"{adam['library_ms']:.4f} (torch.optim.AdamW fused) bound_ms "
          f"{adam['bound_ms']:.5f} ({adam['bound_by']})")
    adam_tree = fused_adam_tree_path(torch, fo, tfm)
    print("fused_adamw_tree: " + json.dumps(adam_tree))
    gc.collect()
    torch.cuda.empty_cache()

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    evo = check_evoformer(torch, fa, ev, flush)
    del flush
    gc.collect()
    torch.cuda.empty_cache()
    for name, k in evo["calls"].items():
        f32 = (f", {k['max_abs_err_f32']:.3e} (f32, limit {TOL_F32}; "
               "evoformer f32 grads "
               + json.dumps(k["max_abs_err_grads_f32"]) + ")"
               if "max_abs_err_f32" in k else "")
        print(f"flash_fwd_bias {name} {k['shape']} (bias1 {k['bias1']}, "
              f"bias2 {k['bias2']}): max_abs_err {k['max_abs_err']:.3e} "
              f"(bf16, {k['margin_bf16']:.3e} past its limit){f32}; "
              f"evoformer output {k['max_abs_err_out']:.3e}, grads "
              + json.dumps(k["max_abs_err_grads"])
              + f" (limit {GRAD_REL} of max + 1e-2 |p|) kernel_ms "
              f"{k['ms']:.4f} plain_ms {k['plain_ms']:.4f} library_ms "
              f"{k['library_ms']:.4f} bound_ms {k['bound_ms']:.5f} "
              f"({k['bound_by']}) evoformer fwd+bwd ms {k['fwd_bwd_ms']:.4f}")
    sparse = run_sparse(torch, fa, sa)
    print("sparse attention: " + json.dumps(sparse))
    gc.collect()
    torch.cuda.empty_cache()
    launches.update({"grouped_matmul": moe["launches"]["grouped_matmul"],
                     "fused_adamw": adam_tree["launches"],
                     "flash_fwd_bias": evo["launches"]})
    result = {"card": card, "torch": torch.__version__, "engine": engine,
              "small_model": small, "flash": flash, "training": training,
              "small_training": small_train, "mixed_gemm": gemm,
              "quantized_engine": quant, "small_quantized": small_quant,
              "grouped_matmul": gmm, "moe_engine": moe,
              "small_moe": small_moe, "small_moe_training": small_moe_train,
              "fused_adamw": adam, "fused_adamw_tree": adam_tree,
              "evoformer": evo, "sparse_attention": sparse}

    sources = {"paged_decode_attention": "paged_attention.cu",
               "paged_prefill_attention": "paged_attention.cu",
               "flash_fwd": "flash_attention.cu",
               "flash_bwd_dkdv": "flash_attention.cu",
               "flash_bwd_dq": "flash_attention.cu",
               "flash_fwd_bias": "flash_attention.cu",
               **{name: "mixed_gemm.cu" for name in GEMM_KERNELS},
               "grouped_matmul": "grouped_matmul.cu",
               "fused_adamw": "fused_adam.cu"}
    replaces = {"paged_decode_attention":
                "deepspeed_tpu/ops/pallas/paged_attention.py:77",
                "paged_prefill_attention":
                "deepspeed_tpu/ops/pallas/paged_attention.py:255",
                "flash_fwd": "deepspeed_tpu/ops/pallas/flash_attention.py:155",
                "flash_fwd_bias":
                "deepspeed_tpu/ops/pallas/flash_attention.py:155",
                "flash_bwd_dkdv":
                "deepspeed_tpu/ops/pallas/flash_attention.py:307",
                "flash_bwd_dq":
                "deepspeed_tpu/ops/pallas/flash_attention.py:361",
                **{name: "deepspeed_tpu/ops/pallas/mixed_gemm.py:184"
                   for name in GEMM_KERNELS if name != "int8_gemm"},
                "int8_gemm": "deepspeed_tpu/ops/pallas/mixed_gemm.py:253",
                "grouped_matmul":
                "deepspeed_tpu/ops/pallas/grouped_matmul.py:47",
                "fused_adamw": "deepspeed_tpu/ops/fused_optimizers.py:31"}
    at_shape = [k for k in gemm if (k["shape"], k["M"]) in GEMM_JSON]
    at_shape += [k for k in gmm if (k["shape"], k["T"]) in MOE_JSON]
    # grouped-GEMM launches by T: the MoE engine's mixed steps (T = 512) on
    # the wgmma kernel, its decode bodies (T = 16) on the mma.sync kernel
    moe_wgmma = moe["launches"]["grouped_matmul_wgmma"]
    gemm_launches["grouped_matmul", MOE_T[1]] = moe_wgmma
    gemm_launches["grouped_matmul", MOE_T[0]] = \
        moe["launches"]["grouped_matmul"] - moe_wgmma

    def row(k):
        return {"name": k["name"], "route": "cuda",
                "source": f"deepspeed_tpu_torch/csrc/{sources[k['name']]}",
                "replaces": replaces[k["name"]], "status": "ok",
                **{d: k[d] for d in ("M", "T", "kernel") if d in k},
                "launches": (gemm_launches[k["name"], k["M"]] if "M" in k
                             else gemm_launches[k["name"], k["T"]] if "T" in k
                             else launches[k["name"]]),
                "max_abs_err": k["max_abs_err"],
                "max_abs_err_f32": k["max_abs_err_f32"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"], "library_ms": k["library_ms"]}

    evo_row = dict(evo["calls"][EVO_JSON], name="flash_fwd_bias")
    line = {"kernels": [row(k) for k in
                        kernels + flash + [evo_row] + at_shape + [adam]]}
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
