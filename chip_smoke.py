#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--profile] [--out results.json]
    python3 chip_smoke.py --spec-rates   # one process's decode rates

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
   pools of block size 16 and 128; then both kernels again at the draft
   model's head dim (D = 64, H = 32, KV = 8), and the prefill kernel at a
   speculative verify's k + 1 = 5 query positions per row (D = 128); then
   warm decode tokens/s of the plain, draft-model, self-draft and adapter
   engines at llama3-8b's width (16 of its 32 layers), each from three
   processes of its own
   (``--spec-rates``);
4. the engine: ``InferenceEngineV2`` at full llama3-8b width and depth with
   random bf16 weights from a seed, serving 8 requests (SplitFuse prefill,
   then burst decode), checking tokens, finiteness, kernel launch counts
   and determinism; and a small f32 model served on the card and on the
   CPU, whose greedy tokens must agree; then the serving memory hierarchy
   on the same weights (prefix cache, host pool, cold store, restart
   rehydration) in five stages: a cold request with a 1000-token prefix
   P; seven hits on P (three take all of it, four leave it inside its
   16th block: copy-on-write); pressure that demotes P's chain into the
   host pool and on into the cold store; P's return, promoted from both;
   and a fresh engine on the same cold store that rehydrates it.  It
   checks the counters, the tier identity after each stage, bitwise
   equal blocks across every tier, that each hit prefilled only its
   uncached tokens, B4/B5 launches with no plain call, no host sync in a
   decode body, one ``engine/step`` span per ``step()`` and the first
   tokens' logits against a cache-off engine; it prints TTFTs, ms per
   demote and promote, cold-store MB/s, the rehydrate time, the tracer's
   host cost and decode tokens/s with tracing off and on; and the same
   five stages on the small f32 model, card vs CPU vs cache-off, whose
   greedy tokens must be identical; then speculative decoding and adapters
   on the same weights (spec_k = 4): the draft-model engine (a
   Llama-3.2-1B-shaped draft, D = 64, on its own mirrored pool), the
   self-draft engine (heads seeded from the lm head), an adapter engine (8
   slots, rank 16, four packs through ``AdapterRegistry``, the requests
   over slots 0-4) and adapters with self-draft, each with exact paged
   launch counts by head dim, no plain call, first-token logits against
   the plain engine (slot-0 rows bit for bit) and, per speculative mode,
   one greedy step with no host sync before its read-back; and a small
   f32 model speculative in both modes and with adapters, card vs CPU vs
   non-speculative (tokens identical; the model as its own draft accepts
   every draft its budget allows);
5. each flash-attention kernel (forward, dK/dV, dQ) against its plain
   PyTorch version at the training shape (B=4, S=2048, H=32, KV=8, D=128,
   causal): in bf16 and in f32, max abs error (and in bf16 how far inside
   its limit the worst element lies) and kernel / plain / library (SDPA
   forward; SDPA backward for dK/dV and dQ together) / bound times; then
   the f16 kernels the same way against fp16 SDPA, also where the
   loss-scaled dS passes 65504 and falls under 6.1e-5, and where the
   gradients overflow (inf where the plain versions' are);
6. training: ``deepspeed_tpu_torch.initialize`` + ``train_batch`` on
   llama3-8b at full width with its depth cut to 8 layers (bf16
   parameters, f32 AdamW state, flash attention, tiled loss), 2 warm-up
   and 5 timed steps on one fixed batch: tokens/s, step ms, MFU, peak
   memory, finite and falling loss, and exact flash launch counts; then a
   small f32 model trained 3 steps on the card and on the CPU, whose
   losses and parameters must agree; then the rest of the training
   engine: fp16 on the same model (f16 compute, f32 master weights) from
   a loss scale of 2**32 (overflowed steps leave the state bit for bit,
   the scale follows the reference's state machine replayed from the
   flags, the loss falls, B1-B3 f16 launches exact), the six remat
   policies (fwd + bwd ms, peak GB, B1-B3 launches per policy, gradients
   against ``nothing_saveable``'s), the seven other optimizers card vs
   CPU on the small model, checkpoints at full width and 2 layers
   (an async native save with sha256 and a fast one: the fast tag loaded
   bit for bit, equal resumed losses; the async tag holds the state at its
   save, loaded past the truncated fast tag; GB/s), and
   each optimizer's step at full width;
7. the mixed GEMM (W8A16 / W4A16 / W6A16) and W8A8 kernels against their
   plain versions at llama3-8b's four projection shapes, at M = 8 (a decode
   body) and M = 256 (a mixed step), the mixed GEMM also at M = 1 and 16
   (one and two n8 tiles of the decode kernel), in bf16 and f32: max abs
   error and kernel / plain / library (bf16 ``torch.matmul`` by the
   dequantized weight) / bound times (M <= 16 runs
   ``mixed_gemm_decode_kernel`` and ``int8_gemm_mma_kernel``, M = 256
   ``mixed_gemm_wgmma_kernel`` and ``int8_gemm_wgmma_kernel``; both
   dispatches are checked); the int8 mixed GEMM also at M = 4096, the v1
   prefill's rows (13.);
8. quantized serving: the engine of 4. with ``quantize_bits=8`` (cold and
   warm), then 4 and 6, at full width and depth: tokens, finiteness,
   ``mixed_gemm`` launches = 7 x paged launches with no plain or envelope
   call, ``mixed_gemm_wgmma_kernel`` launches = 7 x prefill launches,
   ``mixed_gemm_decode_kernel`` launches = 7 x decode launches (with
   ``--profile``: the W8A16 decode trace shows it and no
   ``splitk_reduce_kernel``),
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
13. the v1 engine through ``init_inference``, right after 4.'s
   speculative phase on its weights: llama3-8b bf16 at full width and
   depth on 8 x 512 prompt tokens, 32 new (tokens, determinism, first-
   token logits against the v2 engine's; prefill s, decode tokens/s, peak
   memory), the same W8A16 (mixed-GEMM launches exact: 7 per layer per
   forward, the prefill's on ``mixed_gemm_wgmma_kernel``; first-token
   logits against a W8A16 v2 engine's), ALiBi at
   BLOOM-7b1's width and depth (which v2 refuses), the BERT-base encoder
   card against CPU; small f32 rope, ALiBi and dropless MoE models card
   against CPU; then, after the hierarchy's small model, the serving
   front: llama3-8b bf16 (nothing cut) behind the HTTP server from the
   CLI's own flags, 16 requests from 8 client threads (half streamed):
   every answer, B4/B5 launches exactly 32 per ``engine/step`` span of
   their kind, ``/healthz``, ``/metrics``, three requests one at a time
   against a lone engine, TTFT / TPOT and HTTP against ``generate_all``
   tokens/s; two in-process replicas (one more KV pool, no weight copy);
   the CLI as a subprocess with two workers, one SIGKILLed mid-stream (the
   stream completes as the lone engine's), its respawn timed, no process
   left after the drain; a small f32 model served card against CPU;
14. the serving fleet at llama3-8b bf16 (nothing cut but the rollout's
   depth): dial-in workers (``--replica_transport remote``) under the
   autoscaler from 1 to 2 (a load scales up, B4/B5 exactly 32 per engine
   step in every worker, a SIGKILLed worker's lone stream completes, its
   lease expires once and it re-registers under a higher epoch, idle
   scales down with every request answered, an externally managed worker
   SIGSTOPped past its lease is replaced under a newer epoch and fenced
   when it resumes, no worker left after the drain); disaggregated
   prefill/decode replicas (both classes routed, a 1000-token prefix
   handed off bit for bit, the decode replica prefilling only the tail,
   its first-token logits against a cache-off engine); a rolling swap at 2
   layers (publish, a halted rollout rolled back, a swap under 8 streams);
   fleet adapter register / retire over HTTP against merged weights; and
   ``serving/bench.py`` (the mixed-GEMM sweep at llama3-8b's projections
   against dequantize-then-matmul, an offered-load sweep against a server
   subprocess); lone requests everywhere against a lone engine;
15. fp16 serving: each f16 kernel against its plain version within the f16
   limit (B7 bit for bit) and timed against its fp16 library call and
   bound at the bf16 rows' shapes (B5 with its split-KV edges, B4 also on
   pools of block size 16 and 128, B6 at the four projection shapes, M =
   1, 8, 16, 256 (split-K at wq/wo, wk/wv and w_out) and 4096, B7 at M = 8
   and 256, B8 at both expert shapes, T = 16 and 512, B1 with f16 biases
   at OpenFold's three calls, B9 with f16 parameters at ADAM_N); then
   ``V2Config(dtype="float16")`` at llama3-8b full width and depth on the
   engine phase's traffic, plain and W8A16 (exact B4 / B5 / B6 launches,
   B4 per mixed step and B5 per decode body, no plain call, first-token
   logits against an f32 engine on the same seeded f16 weights), W4A16
   and W6A16, W8A8 with f16 output on one quantized layer, the v1 engine
   in fp16 W8A16 (exact B6 launches, first-token logits against v2),
   dropless Mixtral-8x7B at MOE_LAYERS layers (exact B8 launches), small
   f16 models card against CPU and ``fused_adamw_flat`` on f16
   parameters; the phase's seconds;
16. PEFT / LoRA training: (a) QLoRA llama3-8b at full width and all 32
   layers (an int4 base of group 512 quantized on the card layer by layer,
   r 64, alpha 16, the seven projections, f32 adapters; bf16, flash,
   remat, ``tiled_loss_fn(512)``, 4 x 2048, AdamW), 2 warm-up and 5 timed
   steps: step ms, tokens/s, MFU, device peak GB, base, adapter and
   optimizer-state bytes, the engine's build seconds; gates: B6
   (``mixed_gemm_wgmma_kernel``) exactly 2 x 7 x L launches a step and
   B1-B3 2L / L / L, no plain or off-envelope call, the loss falls, the
   frozen leaves bit for bit, gradients and optimizer state for the
   adapters alone; (b) int8, fp6, fp8 and dense bases at 2 layers, the
   adapters' gradients with B6 against B6's plain version and one step
   each (fp8 and dense launch no B6); (c) B6 alone at the step's M = 8192
   at the four projection shapes, bits 4, 8 and 6: against its plain
   version, kernel / plain / library / bound ms and the backward's dx ms;
   (d) an adapter-only checkpoint of (a): save and load seconds and bytes
   against a full checkpoint's computed bytes, two resumed steps equal to
   the uninterrupted run's; (e) the merged export at 2 layers served by
   the v2 engine beside the unmerged LoRA tree (first-token logits within
   5e-2 of max |logit|, continuations counted); (f) a small f32 QLoRA
   model card against CPU; the phase's seconds by part;
17. ZeRO-Offload / ZeRO-Infinity (each number beside the card's name,
   power limit and the host's MemTotal): llama3-8b at full width (the
   training phase's model and batch) with ``offload_optimizer: cpu`` at
   4 layers (OFFLOAD_DEPTHS, cut for the smoke's time; it fails where the
   host bytes, 16 a parameter, plus 10 GB do not fit MemAvailable), a
   warm-up and 3 timed steps, then on
   the same engine with ``delayed_update`` a step that applies nothing and
   3 timed ones (finite falling losses, ``applied_lr``, exact B1-B3 launches,
   no plain call; step ms, tokens/s, MFU, device peak GB, the card's
   fwd+bwd alone, host update, D2H and H2D ms, host and page-locked GB);
   the streamed engine (``offload_param``, the whole stack) at that depth
   for a step and a forward (the stack page-locked on the host and never
   on the card, 2L stream-ins a step, the loss falls; device peak against
   the optimizer-offload engine's); the NVMe tiers (moments and f32 master
   under ``build/``) at 2 layers for a step (read / write GB/s); ZenFlow
   at 4 layers for 4 steps (hot-step against flush-step ms, cold bytes
   exact against plain offload's, compact state bytes); a small f32 model offloaded (plain, delayed,
   streamed) card against CPU and against the on-device engine;
   ``cpu_checkpointing`` at full width over 2 layers (loss and gradients
   against ``nothing_saveable``'s, peak GB of each); a ``ds_io`` read and
   write sweep of 256 MB on ``build/``; the host's AdamW on a 512 MB leaf,
   plain PyTorch against the offloaded optimizer's one-pass loop (ns an
   element); the phase's seconds by part;
18. a JSON line with every kernel's numbers (the f16 rows with
   ``"dtype": "float16"`` and their launches on the fp16 paths; the flash
   rows also ``launches_offload``, on the optimizer-offload steps; B6 at
   M = 8192 with ``launches_peft``, on the peft phase's steps);
19. last, ``{"ok": true, "device": {...}}``.

Each phase's wall seconds stand on a line of their own, ``phase NAME: S
s``.

Any failure exits non-zero without the last line.  Without CUDA, or
without the rest of the repository beside it, it fails at once.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
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
# f16 flash outputs against their plain versions (stated before the kernels'
# first run on the card): both sides compute in f32 and round once to f16,
# so an element may round one f16 ulp the other way (2**-10 of its size, or
# 2**-24 under f16's normal range); o, dq, dk and dv also carry F16_REL of
# the tensor's largest element (summation order, as GRAD_REL):
# |k - p| <= 2**-24 + F16_REL max|p| + F16_RTOL |p|
F16_ABS, F16_REL, F16_RTOL = 2.0 ** -24, 1e-4, 2e-3
# the f16 check's (dO, V) scales: dO 2**13 and V 16 push the loss-scaled dS
# past 65504 (f16's largest; dO 2**13 alone reached 6740 on an NVIDIA H100
# 80GB HBM3), dO 2**-20 pulls it under 6.1e-5 (f16's smallest normal)
F16_DS_SCALES = {"dS past 65504": (2.0 ** 13, 16.0),
                 "dS under 6.1e-5": (2.0 ** -20, 1.0)}
F16_MAX = 65504.0
# flash training shape (bench.py's micro-batch and sequence, llama3-8b heads)
FB, FS = 4, 2048
TRAIN_LAYERS, TRAIN_WARMUP, TRAIN_STEPS, TILE = 8, 2, 5, 512
TOL_TRAIN = 1e-4  # small f32 training, card vs CPU: loss rel, params abs
# the training engine's phase: fp16 with a dynamic loss scale started high
# enough that the first steps overflow, each overflow halving it
# (hysteresis 1; the reference's default 2 halves it every second one)
FP16_SCALE_POWER, FP16_HYSTERESIS = 32, 1
FP16_MAX_STEPS, FP16_FINITE_AFTER, FP16_TIMED = 30, 4, 3
REMAT_POLICIES = ("nothing_saveable", "everything", "dots_saveable",
                  "dots_with_no_batch_dims_saveable", "save_attn",
                  "save_attn_mlp")
# checkpoints at full width, depth cut from 32 to 2 layers: bf16 params and
# f32 moments, 9.62 GB a checkpoint (the preset ties its embeddings: 525 M
# of its 961 M parameters); the optimizers' full-width step on the same
# model
CKPT_LAYERS = 2
CKPT_DIR = os.path.join("build", "ckpt_smoke")
# the other optimizers, card vs CPU on the small model (TOL_TRAIN): learning
# rates at which one f32 rounding of a gradient near zero, which a sign
# (Lion, 1-bit Adam) or Adam's normalization turns into a full step, stays
# inside TOL_TRAIN; Muon's Newton-Schulz iterations (x 3.4445 each on a
# direction whose singular value is near zero) moved a parameter by 2.4e-4
# card vs CPU at lr 1e-3 (NVIDIA H100 80GB HBM3): 1e-4
OPT_SMALL = {
    "lamb": {"lr": 1e-4, "weight_decay": 0.01},
    "lion": {"lr": 1e-5, "weight_decay": 0.01},
    "sgd": {"lr": 1e-2, "momentum": 0.9, "nesterov": True},
    "adagrad": {"lr": 1e-3},
    "adafactor": {"lr": 1e-3},
    "muon": {"lr": 1e-4},
    "onebitadam": {"lr": 1e-5, "freeze_step": 2, "weight_decay": 0.01},
}
# mixed GEMM: llama3-8b's projection shapes (K, N) and rows per call
GEMM_SHAPES = {"wq/wo": (4096, 4096), "wk/wv": (4096, 1024),
               "w_gate/w_in": (4096, 14336), "w_out": (14336, 4096)}
GEMM_MS = (8, 256)  # a decode body at max_seqs=8, a mixed step's 256 tokens
# B6 at decode rows: a lone request, a decode body, and the decode kernel's
# two n8 tiles of x rows
GEMM_DECODE_MS = (1, 8, 16)
V1_BATCH, V1_PROMPT = 8, 512  # v1 traffic: 8 x 512 prompt tokens, greedy
# v1's W8A16 prefill runs every projection at M = B * T (int8 only)
GEMM_V1_M = V1_BATCH * V1_PROMPT
# the shape and the M of the kernels JSON line's mixed-GEMM and W8A8 rows:
# a decode body's rows (mixed_gemm_decode_kernel; W8A8 int8_gemm_mma_kernel),
# a mixed step's (wgmma), and for the mixed GEMM a lone request's and 16
# rows (the bench's M = 1 and 16 calls) and, for int8, v1's prefill (wgmma)
GEMM_JSON = (("w_gate/w_in", 1), ("w_gate/w_in", 8), ("w_gate/w_in", 16),
             ("w_gate/w_in", 256), ("w_gate/w_in", GEMM_V1_M))
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


class PhaseClock:
    """Wall seconds of the smoke's phases: ``clock(name)`` prints the
    seconds since the previous call on a line of its own."""

    def __init__(self):
        self.last, self.seconds = time.perf_counter(), {}

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.last
        self.last = now
        print(f"phase {name}: {self.seconds[name]:.1f} s", flush=True)


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


def paged_inputs(torch, S: int, gen, bs: int = BS, d: int = D, dtype=None):
    """A K and V pool (bf16, or ``dtype``) of block size ``bs`` and head dim
    ``d`` holding NB * BS positions, and S disjoint block chains of MB * BS
    positions each."""
    dtype = dtype or torch.bfloat16
    nb, mb = NB * BS // bs, MB * BS // bs
    kc = torch.randn((nb, bs, KV, d), generator=gen, device="cuda",
                     dtype=dtype)
    vc = torch.randn((nb, bs, KV, d), generator=gen, device="cuda",
                     dtype=dtype)
    perm = torch.randperm(nb - 1, generator=gen, device="cuda")
    bt = perm[: S * mb].reshape(S, mb).to(torch.int32).contiguous()
    return kc, vc, bt


def half_check(torch, dtype):
    """The kernel-against-plain check of a 2-byte dtype: bf16 within
    TOL_BF16, f16 within the F16 limit (``compare_f16``)."""
    if dtype == torch.float16:
        return lambda out, ref, what: compare_f16(out, ref, f"{what} (f16)")
    return lambda out, ref, what: compare(out, ref, TOL_BF16, what)


def check_decode(torch, pa, flush, d: int = D, dtype=None) -> dict:
    """B5 in bf16 (and f32), or in ``dtype`` (f16) alone."""
    import torch.nn.functional as F

    dtype = dtype or torch.bfloat16
    cmp = half_check(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    S = len(DECODE_CTX)
    kc, vc, bt = paged_inputs(torch, S, gen, d=d, dtype=dtype)
    q = torch.randn((S, H, d), generator=gen, device="cuda", dtype=dtype)
    ctx = torch.tensor(DECODE_CTX, dtype=torch.int32, device="cuda")
    out = pa.paged_decode_attention(q, kc, vc, bt, ctx)
    ref = pa.decode_attention_plain(q, kc, vc, bt, ctx)
    torch.cuda.synchronize()
    err = cmp(out, ref, "decode kernel")
    if out[0].abs().max().item() != 0.0:
        fail("decode kernel: the ctx=0 row is not zero")
    bf16 = dtype == torch.bfloat16
    err_f32 = check_f32(torch, pa.paged_decode_attention,
                        pa.decode_attention_plain, (q, kc, vc, bt, ctx),
                        "decode kernel") if bf16 else None
    # the split-KV edges: contexts at, one below and one past a split's
    # end, a partial last split and the whole chain, in bf16 and f32 (f16)
    split = pa.decode_split(MB * BS)
    edges = torch.tensor([0, 1, split - 1, split, split + 1, 1000,
                          MB * BS - 1, MB * BS], dtype=torch.int32,
                         device="cuda")
    err_edges = cmp(pa.paged_decode_attention(q, kc, vc, bt, edges),
                    pa.decode_attention_plain(q, kc, vc, bt, edges),
                    "decode kernel at split edges")
    if bf16:
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
    kg = kc[bt.long()].reshape(S, MB * BS, KV, d)[:, :T].transpose(1, 2) \
        .contiguous()
    vg = vc[bt.long()].reshape(S, MB * BS, KV, d)[:, :T].transpose(1, 2) \
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
    nbytes = (live * H * d * 2 + n_pos * KV * d * 2 * 2 + cols * 4
              + S * 4 + q.numel() * 2)
    flops = 4 * n_pos * H * d
    b_ms, b_by = bound(nbytes, flops)
    return {
        "name": "paged_decode_attention", "D": d,
        **({} if bf16 else {"dtype": "float16",
                            "kernel": "paged_decode_kernel<__half>"}),
        "max_abs_err": err,
        "max_abs_err_f32": err_f32, "split": split,
        "max_abs_err_split_edges": err_edges,
        "ms": time_ms(lambda: pa.paged_decode_attention(q, kc, vc, bt, ctx),
                      torch, flush),
        "plain_ms": time_ms(lambda: pa.decode_attention_plain(
            q, kc, vc, bt, ctx), torch, flush),
        "library_ms": time_ms(library, torch, flush),
        "bound_ms": b_ms, "bound_by": b_by,
    }


def sdpa_on_gathered(torch, q, kc, vc, bt, cs, cl):
    """B4's yardstick: one SDPA call over the same contexts pre-gathered
    into contiguous K/V (the gather excluded), with the causal and
    chunk-end mask; padding rows attend to position 0 here."""
    import torch.nn.functional as F

    S, qp, _, d = q.shape
    T = int((cs + cl).max().item())
    kg = kc[bt.long()].reshape(S, -1, KV, d)[:, :T].transpose(1, 2) \
        .contiguous()
    vg = vc[bt.long()].reshape(S, -1, KV, d)[:, :T].transpose(1, 2) \
        .contiguous()
    rows = torch.arange(qp, device=q.device)
    t_pos = torch.arange(T, device=q.device)
    q_pos = cs.long()[:, None] + rows[None, :]
    mask = ((t_pos[None, None, :] <= q_pos[:, :, None])
            & (t_pos[None, None, :] < (cs + cl).long()[:, None, None]))
    mask[:, :, 0] = True
    mask = mask[:, None]
    qs = q.transpose(1, 2).contiguous()
    return lambda: F.scaled_dot_product_attention(
        qs, kg, vg, attn_mask=mask, enable_gqa=True)


def check_prefill(torch, pa, flush, d: int = D, dtype=None) -> dict:
    """B4 in bf16 (and f32), or in ``dtype`` (f16) alone."""
    dtype = dtype or torch.bfloat16
    cmp = half_check(torch, dtype)
    bf16 = dtype == torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    S = len(PREFILL_START)
    kc, vc, bt = paged_inputs(torch, S, gen, d=d, dtype=dtype)
    q = torch.randn((S, PREFILL_QP, H, d), generator=gen, device="cuda",
                    dtype=dtype)
    cs = torch.tensor(PREFILL_START, dtype=torch.int32, device="cuda")
    cl = torch.tensor(PREFILL_LEN, dtype=torch.int32, device="cuda")
    out = pa.paged_prefill_attention(q, kc, vc, bt, cs, cl)
    ref = pa.prefill_attention_plain(q, kc, vc, bt, cs, cl)
    torch.cuda.synchronize()
    err = cmp(out, ref, "prefill kernel")
    for s, n in enumerate(PREFILL_LEN):
        if n < PREFILL_QP and out[s, n:].abs().max().item() != 0.0:
            fail(f"prefill kernel: padding rows of sequence {s} not zero")
    err_f32 = check_f32(torch, pa.paged_prefill_attention,
                        pa.prefill_attention_plain, (q, kc, vc, bt, cs, cl),
                        "prefill kernel") if bf16 else None
    # the tensor-core kernel gathers its 64-key tiles through the block
    # table: pools of smaller and larger blocks, the same queries and chunks
    err_blocks = {}
    for bs in PREFILL_BLOCKS:
        kb, vb, btb = paged_inputs(torch, S, gen, bs, d, dtype)
        out_b = pa.paged_prefill_attention(q, kb, vb, btb, cs, cl)
        err_blocks[bs] = cmp(
            out_b, pa.prefill_attention_plain(q, kb, vb, btb, cs, cl),
            f"prefill kernel, block size {bs}")
        for s, n in enumerate(PREFILL_LEN):
            if n < PREFILL_QP and out_b[s, n:].abs().max().item() != 0.0:
                fail(f"prefill kernel, block size {bs}: padding rows of "
                     f"sequence {s} not zero")
        del kb, vb, btb, out_b
    library = sdpa_on_gathered(torch, q, kc, vc, bt, cs, cl)
    ends = [a + n for a, n in zip(PREFILL_START, PREFILL_LEN)]

    # bytes the function must move: q of the rows below chunk_len (padding
    # rows and inactive tiles are written as zeros unread), K and V of each
    # position below a live chunk's end once, the block-table columns those
    # positions use, chunk_start and chunk_len, and the whole output
    live_ends = [e for e, n in zip(ends, PREFILL_LEN) if n > 0]
    n_pos = sum(live_ends)
    cols = sum(-(-e // BS) for e in live_ends)
    pairs = sum(a + i + 1 for a, n in zip(PREFILL_START, PREFILL_LEN)
                for i in range(n))
    nbytes = (sum(PREFILL_LEN) * H * d * 2 + n_pos * KV * d * 2 * 2
              + cols * 4 + 2 * S * 4 + q.numel() * 2)
    flops = 4 * pairs * H * d
    b_ms, b_by = bound(nbytes, flops)
    return {
        "name": "paged_prefill_attention", "D": d,
        **({} if bf16 else {"dtype": "float16",
                            "kernel": "paged_prefill_tc_kernel<__half>"}),
        "max_abs_err": err,
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
    # every decode body advances each running request by one token, so the
    # decode phase runs as many bodies as the most tokens one still needs
    prompt_of = dict(zip(uids, prompts))
    needed = max((NEW_TOKENS - len(s.tokens) + len(prompt_of[u])
                  for u, s in eng.running.items()), default=0)
    with phase() as prof_decode:
        results = eng.generate_all(burst=8)
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"uids": uids, "results": results, "mixed_steps": steps,
            "probes_finite": probes, "first_logits": first,
            "prefill_s": t1 - t0,
            "prefill_emitted": emitted, "decode_bodies_needed": needed,
            "decode_s": t2 - t1,
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


def run_engine(torch, pa, profile: bool, keep: dict = None) -> dict:
    """``keep``: receives the weights under ``"params"``, for the
    hierarchy phase that follows."""
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
    if keep is not None:
        keep["params"] = params
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


def f16_excess(out, ref, rel: float = F16_REL) -> tuple:
    """``(max |out - ref|, how far the worst element lies past the f16
    limit)`` (F16_ABS, ``rel`` (F16_REL) of the largest element, F16_RTOL).
    inf must meet inf, or the largest finite f16 of its sign: f32 values
    either side of 65520 round to inf and to 65504, one f16 ulp apart."""
    ref, out = ref.float(), out.float()
    if not same_infs(out, ref) or bool(ref.isnan().any()):
        return math.inf, math.inf
    inf = out.isinf() | ref.isinf()
    fin = ~inf
    if not bool(fin.any()):
        return 0.0, -math.inf
    r, o = ref[fin], out[fin]
    diff = (o - r).abs()
    limit = F16_ABS + rel * r.abs().max() + F16_RTOL * r.abs()
    return diff.max().item(), (diff - limit).max().item()


def same_infs(out, ref) -> bool:
    """inf where ``ref`` is inf (or, one f16 ulp away, the largest finite
    f16 of its sign), nowhere else, and no NaN."""
    one = out.isinf() ^ ref.isinf()
    fin, inf = torch_where_inf(out.float(), ref.float())
    return bool(((fin[one].abs() == F16_MAX)
                 & (fin[one].sign() == inf[one].sign())).all()) and \
        not bool(out.isnan().any())


def torch_where_inf(a, b):
    """(the finite one, the infinite one) of a and b, elementwise where
    exactly one is inf."""
    fin = a.where(b.isinf(), b)
    return fin, a.where(a.isinf(), b)


def compare_f16(out, ref, what: str, rel: float = F16_REL) -> float:
    err, over = f16_excess(out, ref, rel)
    if not math.isfinite(err) or over > 0:
        fail(f"{what} disagrees with its plain version: max abs err {err}, "
             f"past |k - p| <= {F16_ABS} + {rel} max|p| + {F16_RTOL} "
             f"|p| by {over}")
    return err


def check_flash_f16(torch, fa, flush) -> list:
    """B1-B3's f16 kernels against their plain versions at the training
    shape: normal inputs, then dO scaled so that the loss-scaled dS passes
    65504 and falls under 6.1e-5 (max |dS| read from the plain version's
    recompute on the first batch row), and a dO whose gradients overflow
    (inf where the plain version's are inf); times of each kernel against
    its plain version, fp16 SDPA and its bound."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float16)

    q, k, v, do = rnd(FB, FS, H, D), rnd(FB, FS, KV, D), rnd(FB, FS, KV, D), \
        rnd(FB, FS, H, D)
    mask = fa.AttnMask(causal=True)
    scale = 1.0 / math.sqrt(D)
    o, lse = fa.flash_fwd(q, k, v, mask, scale)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, mask, scale)
    torch.cuda.synchronize()
    errs = {"flash_fwd": max(compare_f16(o, o_p, "flash_fwd o (f16)"),
                             compare(lse, lse_p, TOL_F32,
                                     "flash_fwd lse (f16)"))}
    cases = {}
    for case, (s, vs) in [("normal", (1.0, 1.0)), *F16_DS_SCALES.items()]:
        dd = (do.float() * s).half()
        vv = (v.float() * vs).half()
        op, lp = (o_p, lse_p) if vs == 1.0 else fa.flash_fwd_plain(
            q, k, vv, mask, scale)
        delta = fa.attention_delta(dd, op)
        dk, dv = fa.flash_bwd_dkdv(q, k, vv, dd, lp, delta, mask, scale)
        dk_p, dv_p = fa.flash_bwd_dkdv_plain(q, k, vv, dd, lp, delta,
                                             mask, scale)
        dq = fa.flash_bwd_dq(q, k, vv, dd, lp, delta, mask, scale)
        dq_p = fa.flash_bwd_dq_plain(q, k, vv, dd, lp, delta, mask, scale)
        torch.cuda.synchronize()
        ds = fa._recompute(q[:1], k[:1], vv[:1], dd[:1], lp[:1],
                           delta[:1], mask, scale)[3].abs()
        kept = ds[ds > 0]
        cases[case] = {
            "dO_scale": s, "V_scale": vs,
            "finite_share": float(torch.stack([
                t.isfinite().float().mean() for t in (dk_p, dv_p, dq_p)]
                ).mean()),
            "max_abs_ds": ds.max().item(), "min_abs_ds": kept.min().item(),
            "flash_bwd_dkdv": max(compare_f16(dk, dk_p, f"dk (f16, {case})"),
                                  compare_f16(dv, dv_p, f"dv (f16, {case})")),
            "flash_bwd_dq": compare_f16(dq, dq_p, f"dq (f16, {case})")}
        del ds, kept, dk, dv, dk_p, dv_p, dq, dq_p, vv, op, lp
    if not cases["dS past 65504"]["max_abs_ds"] > 65504:
        fail(f"f16 flash check: dS reached only "
             f"{cases['dS past 65504']['max_abs_ds']}, not past 65504")
    if not cases["dS under 6.1e-5"]["max_abs_ds"] < 6.1e-5:
        fail(f"f16 flash check: dS reached "
             f"{cases['dS under 6.1e-5']['max_abs_ds']}, not under 6.1e-5")
    # an overflowed gradient stays visible: inf where the plain one is inf
    # (its finite elements are sums of terms near 1e7 that cancel, so they
    # are held to the inf pattern only, not to the f16 limit)
    big = torch.full_like(do, 60000.0)
    vv = (v.float() * 64).half()
    o2, lse2 = fa.flash_fwd_plain(q, k, vv, mask, scale)
    delta = fa.attention_delta(big, o2)
    dk, dv = fa.flash_bwd_dkdv(q, k, vv, big, lse2, delta, mask, scale)
    dk_p, dv_p = fa.flash_bwd_dkdv_plain(q, k, vv, big, lse2, delta, mask,
                                         scale)
    dq = fa.flash_bwd_dq(q, k, vv, big, lse2, delta, mask, scale)
    dq_p = fa.flash_bwd_dq_plain(q, k, vv, big, lse2, delta, mask, scale)
    torch.cuda.synchronize()
    overflow = {}
    for name, a, b in (("dk", dk, dk_p), ("dv", dv, dv_p), ("dq", dq, dq_p)):
        if not same_infs(a, b):
            fail(f"f16 flash overflow case: {name}'s inf elements differ "
                 "from the plain version's (or it holds a NaN)")
        overflow[name] = int(b.isinf().sum())
    if not sum(overflow.values()):
        fail("f16 flash overflow case: no gradient overflowed")
    del o2, lse2, big, vv, dk, dv, dk_p, dv_p, dq, dq_p
    delta = fa.attention_delta(do, o_p)
    lse = lse_p
    del o, o_p

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
    pairs = FS * (FS + 1) // 2
    qb, kvb, rowb = FB * FS * H * D * 2, FB * FS * KV * D * 2, FB * H * FS * 4
    work = {"flash_fwd": (qb + 2 * kvb + qb + rowb, 4 * FB * H * D * pairs),
            "flash_bwd_dkdv": (2 * qb + 2 * kvb + 2 * rowb + 2 * kvb,
                               8 * FB * H * D * pairs),
            "flash_bwd_dq": (2 * qb + 2 * kvb + 2 * rowb + qb,
                             6 * FB * H * D * pairs)}
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
                                          scale), lib_bwd)}
    rows = []
    for name, (kernel, plain, lib_ms) in calls.items():
        b_ms, b_by = bound(*work[name])  # f16 tensor cores: bf16's rate
        err = errs.get(name, max(c.get(name, 0.0) for c in cases.values()))
        rows.append({"name": name, "dtype": "float16",
                     "kernel": name.replace("bwd_", "") + "_tc_kernel<__half>",
                     "max_abs_err": err, "max_abs_err_f32": None,
                     "ds_cases": cases, "overflow_infs": overflow,
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


def small_training_agreement(torch, fa, cfg=None, kernels=None,
                             optimizer=None, peft=None) -> dict:
    """A small llama-shaped f32 model (head dim 64, GQA, flash attention;
    ``cfg`` when given) trained 3 steps on the card (kernels) and on the
    CPU (plain versions) from the same weights: losses within TOL_TRAIN
    relative, final parameters within TOL_TRAIN.  ``kernels``: more kernel
    modules whose launches the card run must show, with no plain call;
    ``optimizer``: the optimizer section (AdamW by default); ``peft``: a
    ``peft.lora`` section (each engine wraps the same weights, drawn from
    the config's seed on its own device: the tree is wrapped on the CPU
    first, and both engines take it)."""
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
    if peft is not None:
        from deepspeed_tpu_torch.linear.config import LoRAConfig
        from deepspeed_tpu_torch.linear.optimized_linear import apply_lora

        params = apply_lora(params, torch.Generator().manual_seed(SEED + 1),
                            LoRAConfig.from_dict(peft))
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
                "optimizer": optimizer or {"type": "adamw", "params": {
                    "lr": 1e-4, "weight_decay": 0.01}},
                "gradient_clipping": 1.0, "steps_per_print": 10_000,
                **({"peft": {"lora": peft}} if peft else {})},
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
        fail(f"small training{' ' + optimizer['type'] if optimizer else ''}"
             f": card vs CPU losses differ by {loss_rel} (relative), "
             f"parameters by {param_diff}")
    return {"losses_cuda": out["cuda"][0], "losses_cpu": out["cpu"][0],
            "loss_max_rel_diff": loss_rel, "param_max_abs_diff": param_diff}


# ---------------------------------------------------------------------------
# the training engine: fp16, remat policies, checkpoints, optimizers
# ---------------------------------------------------------------------------


def replay_loss_scale(flags, power: int, hysteresis: int,
                      window: int = 1000, min_scale: float = 1.0) -> list:
    """The scale each step ran under, from the overflow flags alone: the
    reference's ``DynamicLossScaler`` state machine
    (``deepspeed_tpu/runtime/loss_scaler.py``), replayed on the host."""
    scale, good, hys, out = 2.0 ** power, 0, hysteresis, []
    for overflow in flags:
        out.append(scale)
        if overflow:
            hys -= 1
            if hys <= 0:
                scale, hys = max(scale / 2.0, min_scale), hysteresis
            good = 0
        else:
            good += 1
            if good >= window:
                scale, good = scale * 2.0, 0
            hys = hysteresis
    return out


def bit_sums(torch, tensors) -> list:
    """An int64 sum of the bit patterns of each tensor (2 or 4 bytes an
    element): a changed element changes it (the bit-for-bit check of
    full-width state, which a copy would not fit beside)."""
    ints = {2: torch.int16, 4: torch.int32}
    return torch.stack([torch.sum(t.detach().view(ints[t.element_size()]),
                                  dtype=torch.int64) for t in tensors]
                       ).tolist()


def fp16_training(torch, fa) -> dict:
    """fp16 on the card: llama3-8b at full width, TRAIN_LAYERS layers, f16
    compute with f32 master weights, AdamW, flash attention through the
    f16 B1-B3 kernels, a dynamic loss scale from 2**FP16_SCALE_POWER.
    Gates: at least one skipped step, each leaving parameters and moments
    bit for bit; the scale each step ran under equal to the reference's
    state machine replayed from the flags; the loss falling after the scale
    settles; B1-B3 launches exact, no plain call.  Then FP16_TIMED steps
    timed."""
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer as tfm
    from deepspeed_tpu_torch.runtime.engine import ModelSpec
    from deepspeed_tpu_torch.sequence.tiled_compute import tiled_loss_fn

    cfg = tfm.get_config("llama3-8b", num_layers=TRAIN_LAYERS,
                         dtype="float16", param_dtype="float32",
                         attn_impl="flash")
    params = tfm.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), device="cuda", dtype=torch.float32)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=ModelSpec(loss_fn=lambda p, b, r: tiled_loss_fn(
            p, b, cfg, tile_size=TILE), params=params), config={
            "train_micro_batch_size_per_gpu": FB,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-4}},
            "fp16": {"enabled": True,
                     "initial_scale_power": FP16_SCALE_POWER,
                     "hysteresis": FP16_HYSTERESIS},
            "steps_per_print": 10_000})
    del params
    torch.cuda.empty_cache()
    placed = engine.place_batch({"input_ids": np.random.default_rng(
        SEED).integers(0, cfg.vocab_size, size=(
            engine.train_batch_size, FS)).astype(np.int32)})
    opt = engine.optimizer
    state = list(engine._leaves) + opt.mu + opt.nu
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_counts()
    flags, scales, losses, first = [], [], [], None
    while len(flags) < FP16_MAX_STEPS:
        before = bit_sums(torch, state)
        m = engine.train_batch(placed)
        flags.append(m["overflow"])
        scales.append(m["loss_scale"])
        losses.append(m["loss"])
        if m["overflow"]:
            if bit_sums(torch, state) != before:
                fail(f"fp16: overflowed step {len(flags) - 1} changed the "
                     "parameters or the optimizer state")
        elif first is None:
            first = len(flags) - 1
        if first is not None and len(flags) - 1 - first >= FP16_FINITE_AFTER:
            break
    launches, plain = dict(fa.LAUNCHES), dict(fa.PLAIN_CALLS)
    steps, L = len(flags), cfg.num_layers
    skipped = int(sum(flags))
    want = replay_loss_scale(flags, FP16_SCALE_POWER, FP16_HYSTERESIS)
    if first is None or not skipped:
        fail(f"fp16: want overflowed steps, then finite ones: {flags}")
    if scales != want:
        fail(f"fp16: loss scales {scales}, the reference's state machine "
             f"gives {want}")
    finite = [x for x, f in zip(losses, flags) if not f]
    if not all(math.isfinite(x) for x in finite) or \
            not finite[-1] < finite[0]:
        fail(f"fp16: the loss did not fall after the scale settled: "
             f"{finite}")
    if launches != {"flash_fwd": 2 * L * steps, "flash_bwd_dkdv": L * steps,
                    "flash_bwd_dq": L * steps} or any(plain.values()):
        fail(f"fp16: flash launches {launches} over {steps} steps, plain "
             f"calls {plain}")
    if int(engine.skipped_steps) != skipped or \
            int(opt.count) != steps - skipped:
        fail(f"fp16: skipped {int(engine.skipped_steps)} / count "
             f"{int(opt.count)}, want {skipped} / {steps - skipped}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FP16_TIMED):
        engine.train_batch(placed)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / FP16_TIMED
    out = {"model": "llama3-8b", "layers": L, "dtype": "float16",
           "param_dtype": "float32", "steps": steps, "skipped": skipped,
           "flags": flags, "loss_scales": scales, "losses": losses,
           "launches": launches, "launches_per_step": {
               k: n // steps for k, n in launches.items()},
           "step_ms": dt * 1e3,
           "tokens_per_s": engine.train_batch_size * (FS - 1) / dt,
           "final_loss_scale": engine.get_loss_scale(),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del engine, placed, state, opt
    torch.cuda.empty_cache()
    return out


def remat_policies(torch, fa) -> dict:
    """The bf16 training phase's model (TRAIN_LAYERS layers), one loss and
    gradient per remat policy after a warm one: step ms, peak GB and
    B1-B3 launches (gated: B1 2L, or L under ``everything``; B2 = B3 = L);
    each policy's loss and gradients against ``nothing_saveable``'s within
    TOL_BF16, and whether bit for bit."""
    import dataclasses

    import numpy as np

    from deepspeed_tpu_torch.models import transformer as tfm
    from deepspeed_tpu_torch.runtime.optimizers import leaves
    from deepspeed_tpu_torch.sequence.tiled_compute import tiled_loss_fn

    cfg = tfm.get_config("llama3-8b", num_layers=TRAIN_LAYERS,
                         param_dtype="bfloat16", attn_impl="flash")
    params = tfm.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), device="cuda", dtype=tfm.param_dtype(cfg))
    flat = leaves(params)
    for t in flat:
        t.requires_grad_(True)
    batch = {"input_ids": torch.from_numpy(np.random.default_rng(
        SEED).integers(0, cfg.vocab_size, size=(FB, FS)).astype(
            np.int32)).cuda()}
    L, ref, out = cfg.num_layers, None, {}
    for policy in REMAT_POLICIES:
        pc = dataclasses.replace(cfg, remat_policy=policy)

        def run():
            loss, _ = tiled_loss_fn(params, batch, pc, tile_size=TILE)
            return loss.detach(), torch.autograd.grad(loss, flat)

        run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_counts()
        t0 = time.perf_counter()
        loss, grads = run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches, plain = dict(fa.LAUNCHES), dict(fa.PLAIN_CALLS)
        want = {"flash_fwd": L if policy == "everything" else 2 * L,
                "flash_bwd_dkdv": L, "flash_bwd_dq": L}
        if launches != want or any(plain.values()):
            fail(f"remat {policy}: flash launches {launches}, want {want}; "
                 f"plain {plain}")
        row = {"fwd_bwd_ms": dt * 1e3,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches_per_step": launches, "loss": loss.item()}
        if ref is None:
            ref = (loss, grads)
        else:
            compare(loss, ref[0], TOL_BF16, f"remat {policy} loss")
            row["max_abs_err_grads"] = max(
                compare(g, r, TOL_BF16, f"remat {policy} gradient")
                for g, r in zip(grads, ref[1]))
            row["bit_for_bit"] = bool(torch.equal(loss, ref[0])) and all(
                torch.equal(g, r) for g, r in zip(grads, ref[1]))
        out[policy] = row
        del grads
    del params, flat, ref
    torch.cuda.empty_cache()
    return out


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def checkpoint_roundtrips(torch) -> dict:
    """Checkpoints at full width, CKPT_LAYERS layers (bf16 parameters,
    AdamW), two writers and two loads into one directory: 2 steps, then an
    async native save with sha256, whose files hold the state at save time
    although a step ran during the write; a newer tag from the ``fast``
    writer, loaded (verified, bit for bit) into a fresh engine, 2 more
    steps on both with equal losses; then that tag truncated, past which a
    native engine falls back to the async one and resumes as the run did
    after it.  Save and load GB/s and seconds (the disk under the
    checkout; reads warm).  Each writer saves once and each tag loads
    once: a load runs the same code whichever engine wrote the tag."""
    import shutil

    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer as tfm
    from deepspeed_tpu_torch.runtime.checkpoint import engine as ce
    from deepspeed_tpu_torch.runtime.engine import ModelSpec
    from deepspeed_tpu_torch.sequence.tiled_compute import tiled_loss_fn

    cfg = tfm.get_config("llama3-8b", num_layers=CKPT_LAYERS,
                         param_dtype="bfloat16", attn_impl="flash")
    params = tfm.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), device="cuda", dtype=tfm.param_dtype(cfg))

    def new(**ckpt):
        return deepspeed_tpu_torch.initialize(
            model=ModelSpec(loss_fn=lambda p, b, r: tiled_loss_fn(
                p, b, cfg, tile_size=TILE), params=params), config={
                "train_micro_batch_size_per_gpu": FB,
                "optimizer": {"type": "adamw", "params": {
                    "lr": 1e-4, "weight_decay": 0.01}},
                "checkpoint": ckpt, "steps_per_print": 10_000})[0]

    def state(eng):
        return list(eng._leaves) + list(eng.optimizer_state_flat().values())

    def loss(eng, i):
        return eng.train_batch(batches[i])["loss"]

    rng = np.random.default_rng(SEED + 9)
    a = new()
    batches = [a.place_batch({"input_ids": rng.integers(
        0, cfg.vocab_size, size=(FB, FS)).astype(np.int32)})
        for _ in range(5)]
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    out = {"layers": CKPT_LAYERS}
    losses = [loss(a, i) for i in range(2)]
    # native, async: the snapshot is taken before save_checkpoint returns
    a.config.checkpoint.async_save = True
    a.config.checkpoint.integrity = "sha256"
    at_save, step_at_save = bit_sums(torch, state(a)), a.get_global_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    native = a.save_checkpoint(CKPT_DIR)
    t1 = time.perf_counter()
    losses.append(loss(a, 2))  # in place, while the thread writes
    ce.wait_for_async_saves()
    t2 = time.perf_counter()
    gb = dir_bytes(native) / 1e9
    out["async"] = {"return_s": t1 - t0, "until_written_s": t2 - t0,
                    "step_during_write": True}
    # fast: a newer tag, loaded into a fresh engine
    a.config.checkpoint.async_save = False
    a.config.checkpoint.engine = "fast"
    t0 = time.perf_counter()
    fast = a.save_checkpoint(CKPT_DIR)
    t1 = time.perf_counter()
    b = new(engine="fast", integrity="sha256")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    path, _ = b.load_checkpoint(CKPT_DIR)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    sa, sb = state(a), state(b)
    if path != fast or len(sa) != len(sb) or not all(
            x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(sa, sb)):
        fail(f"checkpoints (fast): loaded {path}, not the saved state of "
             f"{fast} bit for bit")
    if a.get_global_step() != b.get_global_step():
        fail(f"checkpoints (fast): step {b.get_global_step()} != "
             f"{a.get_global_step()}")
    del sa, sb
    la = [loss(a, i) for i in (3, 4)]
    lb = [loss(b, i) for i in (3, 4)]
    if la != lb:
        fail(f"checkpoints (fast): resumed losses {lb} != the uninterrupted "
             f"run's {la}")
    fgb = dir_bytes(fast) / 1e9
    out["fast"] = {"gb": fgb, "save_s": t1 - t0, "save_gb_s": fgb / (t1 - t0),
                   "load_s": t3 - t2, "load_gb_s": fgb / (t3 - t2),
                   "resumed_losses": lb, "losses_equal": True}
    del b
    torch.cuda.empty_cache()
    # the fast tag truncated: the load falls back to the async native tag,
    # which holds the state at its save and resumes as the run did
    model = os.path.join(fast, "model.safetensors")
    with open(model, "rb+") as f:
        f.truncate(os.path.getsize(model) // 2)
    c = new(integrity="none")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path, _ = c.load_checkpoint(CKPT_DIR)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if path != native or c.get_global_step() != step_at_save:
        fail(f"checkpoints: the load did not fall back past the truncated "
             f"tag {fast} ({path})")
    if bit_sums(torch, state(c)) != at_save:
        fail("checkpoints (async): the loaded state is not the state at "
             "save time")
    lc = [loss(c, i) for i in (2, 3)]
    if lc != [losses[2], la[0]]:
        fail(f"checkpoints (native): resumed losses {lc} != the "
             f"uninterrupted run's {[losses[2], la[0]]}")
    out["native"] = {"gb": gb, "save_s": out["async"]["until_written_s"],
                     "save_gb_s": gb / out["async"]["until_written_s"],
                     "load_s": t1 - t0, "load_gb_s": gb / (t1 - t0),
                     "resumed_losses": lc, "losses_equal": True}
    out["fallback"] = {"truncated": os.path.basename(fast),
                       "loaded": os.path.basename(path)}
    del c, a, batches
    torch.cuda.empty_cache()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    out["params"] = params
    return out


def optimizer_steps(torch, params) -> dict:
    """Each optimizer's device ms for one step at full width (CKPT_LAYERS
    layers, bf16 parameters, f32 gradients drawn from a seed), after a warm
    step, CUDA events around ``step``."""
    from deepspeed_tpu_torch.runtime.config import OptimizerConfig
    from deepspeed_tpu_torch.runtime.optimizers import (
        create_optimizer, default_weight_decay_mask, leaves)

    flat = [t.detach() for t in leaves(params)]
    mask = leaves(default_weight_decay_mask(params))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    grads = [torch.randn(t.shape, generator=gen, device="cuda") * 1e-3
             for t in flat]
    out = {}
    for name, hp in {"adamw": {"lr": 1e-4, "weight_decay": 0.01},
                     **OPT_SMALL}.items():
        opt = create_optimizer(OptimizerConfig(type=name, params=hp),
                               lambda c: hp["lr"], mask)
        opt.init(flat)
        opt.step(flat, grads)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        opt.step(flat, grads)
        end.record()
        end.synchronize()
        out[name] = start.elapsed_time(end)
        if not all(bool(torch.isfinite(t).all()) for t in flat):
            fail(f"optimizer {name}: a parameter is not finite")
        del opt
        torch.cuda.empty_cache()
    del grads, flat
    return out


def run_training_engine_phase(torch, fa) -> dict:
    """fp16, the remat policies, checkpoints and the other optimizers: the
    rest of the training engine on the card."""
    out = {"fp16": fp16_training(torch, fa)}
    gc.collect()
    torch.cuda.empty_cache()
    out["remat"] = remat_policies(torch, fa)
    gc.collect()
    torch.cuda.empty_cache()
    out["optimizers_small"] = {
        name: small_training_agreement(torch, fa, optimizer={
            "type": name, "params": hp})
        for name, hp in OPT_SMALL.items()}
    ck = checkpoint_roundtrips(torch)
    params = ck.pop("params")
    out["checkpoints"] = ck
    out["optimizer_step_ms"] = optimizer_steps(torch, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def training_engine_line(te: dict) -> str:
    fp, ck = te["fp16"], te["checkpoints"]
    remat = "; ".join(
        f"{p} {r['fwd_bwd_ms']:.2f} ms {r['peak_mem_gb']:.2f} GB B1 "
        f"{r['launches_per_step']['flash_fwd']}" for p, r in
        te["remat"].items())
    opt = ", ".join(f"{k} {v:.2f}" for k, v in
                    te["optimizer_step_ms"].items())
    return (f"training engine: fp16 llama3-8b x{fp['layers']} "
            f"{fp['step_ms']:.2f} ms/step {fp['tokens_per_s']:.2f} tokens/s, "
            f"{fp['skipped']} of {fp['steps']} steps skipped, scale "
            f"{fp['loss_scales'][0]:.0f} -> {fp['final_loss_scale']:.0f}, "
            f"peak {fp['peak_mem_gb']:.2f} GB | remat (fwd+bwd): {remat} | "
            f"checkpoints x{ck['layers']}: native {ck['native']['gb']:.2f} "
            f"GB async save written at {ck['native']['save_gb_s']:.3f} GB/s,"
            f" fallback load {ck['native']['load_gb_s']:.3f} GB/s, fast save "
            f"{ck['fast']['save_gb_s']:.3f} load {ck['fast']['load_gb_s']:.3f}"
            f" GB/s, async returned in {ck['async']['return_s']:.2f} s | "
            f"optimizer step ms x{CKPT_LAYERS}: {opt}")


# ---------------------------------------------------------------------------
# ZeRO-Offload / ZeRO-Infinity: host optimizer, streaming, NVMe, ZenFlow
# ---------------------------------------------------------------------------

# llama3-8b with the training cell's model and batch, as deep as the host
# allows: OFFLOAD_HOST_B bytes of host memory a parameter (f32 master, m, v
# and the f32 gradient buffer) plus OFFLOAD_HOST_MARGIN must fit in
# MemAvailable; the streamed engine adds its bf16 layer stack.  Cut to 4
# layers, with ZenFlow's, and the NVMe tiers to one step, to keep the smoke
# in its time limit (16 layers, the host's deepest, took the phase 182.4 s,
# 32-49 s of it page-faulting 64 GB of host tensors; 8 layers 157.1-176.7
# s, of which the optimizer-offload engine 43.3 s, ZenFlow's 35.5, the
# streamed one 36.7 and the NVMe one 48.2 at two steps; NVIDIA H100 80GB
# HBM3, 700 W)
OFFLOAD_DEPTHS = (4,)
OFFLOAD_HOST_B, OFFLOAD_HOST_MARGIN = 16, 10e9
OFFLOAD_WARMUP, OFFLOAD_TIMED = 1, 3
NVME_LAYERS, NVME_STEPS = CKPT_LAYERS, 1
ZENFLOW_LAYERS, ZENFLOW_RATIO, ZENFLOW_INTERVAL, ZENFLOW_STEPS = 4, 0.1, 4, 4
OFFLOAD_DIR = os.path.join("build", "offload_smoke")
DS_IO_MB = 256
TOL_OFFLOAD = 1e-5  # small f32 model: offloaded vs on-device, on the card


def meminfo() -> dict:
    """MemTotal and MemAvailable of ``/proc/meminfo``, in bytes."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                out[key] = int(val.split()[0]) * 1024
    return out


def llama_cfg(layers: int, **over):
    from deepspeed_tpu_torch.models import transformer as tfm

    return tfm.get_config("llama3-8b", num_layers=layers,
                          param_dtype="bfloat16", attn_impl="flash", **over)


def offload_engine(torch, cfg, zero: dict, extra: dict = None):
    """The training phase's engine (bf16, flash, tiled loss, AdamW at lr
    1e-4, micro-batch FB) on ``cfg`` with ``zero`` as its
    ``zero_optimization`` at stage 0."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer as tfm
    from deepspeed_tpu_torch.runtime.engine import ModelSpec
    from deepspeed_tpu_torch.sequence.tiled_compute import tiled_loss_fn

    params = tfm.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), device="cuda", dtype=tfm.param_dtype(cfg))
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=ModelSpec(loss_fn=lambda p, b, r: tiled_loss_fn(
            p, b, cfg, tile_size=TILE), params=params),
        config={"train_micro_batch_size_per_gpu": FB,
                "optimizer": {"type": "adamw", "params": {"lr": 1e-4}},
                "zero_optimization": {"stage": 0, **zero},
                "steps_per_print": 10_000, **(extra or {})})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return engine


def offload_batch(engine, cfg):
    import numpy as np

    return engine.place_batch({"input_ids": np.random.default_rng(
        SEED).integers(0, cfg.vocab_size, size=(
            engine.train_batch_size, FS)).astype(np.int32)})


def close_engine(torch, engine) -> None:
    """Drop an offloaded engine's page-locked host memory (the caller drops
    the engine, then waits in ``settle_host_memory``)."""
    if engine.offloaded_optimizer is not None:
        engine.offloaded_optimizer.close()
    gc.collect()
    torch.cuda.empty_cache()


def settle_host_memory(need: float = 0.0, limit_s: float = 120.0) -> float:
    """MemAvailable in bytes once it reaches ``need``, or (``need`` 0) once
    it stops rising: the H100 machine hands freed host memory back over
    seconds (16 GiB took ~4 s, measured on one H100 machine)."""
    gc.collect()
    t0, last = time.perf_counter(), meminfo()["MemAvailable"]
    while time.perf_counter() - t0 < limit_s and (not need or last < need):
        time.sleep(1.0 if need else 2.0)
        now = meminfo()["MemAvailable"]
        if not need and now - last < 0.5e9:
            return now
        last = now
    return last


def run_steps(torch, fa, engine, placed, steps: int, layers: int,
              what: str) -> dict:
    """``steps`` steps of ``engine`` on one batch, each timed to the card's
    end: losses (finite), exact B1-B3 launches (2L / L / L a step, no
    plain call), device peak GB, stream-ins and the host optimizer's
    phases of the last step."""
    from deepspeed_tpu_torch.runtime.zero import param_offload as tpo

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_counts()
    tpo.reset_counts()
    times, losses, applied = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        m = engine.train_batch(placed)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"])
        applied.append(m.get("applied_lr"))
    L = layers
    want = {"flash_fwd": 2 * L * steps, "flash_bwd_dkdv": L * steps,
            "flash_bwd_dq": L * steps}
    launches, plain = dict(fa.LAUNCHES), dict(fa.PLAIN_CALLS)
    if not all(math.isfinite(x) for x in losses):
        fail(f"{what}: a loss is not finite: {losses}")
    if launches != want or any(plain.values()):
        fail(f"{what}: flash launches {launches}, want {want}; plain "
             f"{plain}")
    opt = engine.offloaded_optimizer
    return {"step_ms": times, "losses": losses, "applied_lr": applied,
            "launches": launches,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "stream_ins": tpo.COUNTS["stream_in"],
            "host_ms": opt.read_timings() if opt is not None else {}}


def offload_depth(cfg_of, per_param: float, avail: int) -> int:
    for layers in OFFLOAD_DEPTHS:
        if per_param * cfg_of(layers).num_params() + OFFLOAD_HOST_MARGIN \
                <= avail:
            return layers
    fail(f"offload: even {OFFLOAD_DEPTHS[-1]} layers need more host memory "
         f"than MemAvailable {avail / 1e9:.2f} GB")


def optimizer_offload(torch, fa, cfg_of=llama_cfg, card: str = "") -> dict:
    """(a) ``offload_optimizer: cpu`` on llama3-8b at the deepest of
    OFFLOAD_DEPTHS the host holds: OFFLOAD_WARMUP + OFFLOAD_TIMED plain
    steps, the card's forward and backward alone, then ``delayed_update``
    on the same engine (its first step applies nothing, then
    OFFLOAD_TIMED steps that each apply the previous one's update while the
    card runs); gates on finite losses that fall, ``applied_lr`` and exact
    B1-B3 launches.  One engine for both: building one pins 16 B of host
    memory a parameter, 39-49 s at 16 layers on the H100 machine's host."""
    from deepspeed_tpu_torch.accelerator import get_accelerator

    mem = meminfo()
    mem["MemAvailable"] = settle_host_memory()
    layers = offload_depth(cfg_of, OFFLOAD_HOST_B, mem["MemAvailable"])
    cfg = cfg_of(layers)
    out = {"card": card, "mem_total_gb": mem["MemTotal"] / 1e9,
           "mem_available_gb": mem["MemAvailable"] / 1e9, "layers": layers,
           "params": cfg.num_params(),
           "host_bytes_need_gb": OFFLOAD_HOST_B * cfg.num_params() / 1e9}
    tokens_per_step = FB * (FS - 1)
    flops_per_token = 6 * cfg.num_params(include_embed=False) \
        + 12 * cfg.num_layers * cfg.hidden_size * FS
    peak = get_accelerator().peak_tflops("bfloat16") * 1e12
    t0 = time.perf_counter()
    engine = offload_engine(torch, cfg, {"offload_optimizer": {
        "device": "cpu"}})
    out["init_s"] = time.perf_counter() - t0
    placed = offload_batch(engine, cfg)
    opt = engine.offloaded_optimizer
    out.update(host_tensor_gb=opt.arena.tensor_bytes / 1e9,
               host_pinned_gb=opt.arena.pinned_bytes / 1e9)
    for mode in ("plain", "delayed"):
        # delayed_update as its config sets it: the engine's schedule flag
        engine._delayed_update = mode == "delayed"
        run = run_steps(torch, fa, engine, placed, OFFLOAD_WARMUP
                        + OFFLOAD_TIMED, layers, f"offload {mode}")
        losses = run["losses"]
        if mode == "plain":
            if not losses[-1] < losses[0]:
                fail(f"offload plain: the loss did not fall: {losses}")
            # the card's half alone: forward, backward, f32 sums, norm
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            grads = engine._grad_step(placed.placed)
            torch.cuda.synchronize()
            run["device_ms"] = (time.perf_counter() - t1) * 1e3
            del grads
            first = losses[0]
        else:
            if run["applied_lr"][0] is not None or \
                    run["applied_lr"][1] is None:
                fail(f"offload delayed: applied_lr {run['applied_lr']}")
            if not losses[-1] < first:
                fail(f"offload delayed: the loss did not fall: {losses}")
        step = statistics.median(run["step_ms"][OFFLOAD_WARMUP:])
        tps = tokens_per_step / (step / 1e3)
        run.update(step_ms_timed=step, tokens_per_s=tps,
                   mfu=tps * flops_per_token / peak)
        out[mode] = run
    out["launches"] = out["plain"]["launches"]
    del placed, opt
    close_engine(torch, engine)  # the delayed update's last one is dropped
    return out


def param_offload(torch, fa, layers: int, ref_peak_gb: float,
                  cfg_of=llama_cfg) -> dict:
    """(b) ``offload_param: cpu`` (every leaf of the stack, threshold 0) at
    (a)'s depth: the layer leaves are page-locked host tensors and no
    leaf of the stack is on the card between steps; L forward + L
    recompute stream-ins a step; the loss falls; the card's peak against
    (a)'s."""
    from deepspeed_tpu_torch.runtime.zero import param_offload as tpo

    cfg = cfg_of(layers)
    need = (OFFLOAD_HOST_B + 2) * cfg.num_params() + OFFLOAD_HOST_MARGIN
    avail = settle_host_memory(need)
    if need > avail:
        fail(f"param offload: {need / 1e9:.2f} GB of host memory needed at "
             f"{layers} layers, {avail / 1e9:.2f} available")
    engine = offload_engine(torch, cfg, {
        "offload_param": {"device": "cpu"},
        "stage3_param_persistence_threshold": 0})
    stack = [engine._leaves[j] for j, path in enumerate(engine._paths)
             if path.startswith("layers/")]
    if not stack or not all(tpo.is_page_locked(t) for t in stack):
        fail("param offload: a layer leaf is not a page-locked host tensor")
    placed = offload_batch(engine, cfg)
    run = run_steps(torch, fa, engine, placed, 1, layers, "param offload")
    if any(t.device.type != "cpu" for t in stack):
        fail("param offload: a leaf of the stack is on the card")
    if run["stream_ins"] != 2 * layers:
        fail(f"param offload: {run['stream_ins']} stream-ins, want "
             f"{2 * layers} (L forward + L recompute a step)")
    # the loss after the update, one forward over the same batch (L more
    # stream-ins, no host update)
    tpo.reset_counts()
    after = engine.eval_batch(placed)["loss"]
    if tpo.COUNTS["stream_in"] != layers or not after < run["losses"][0]:
        fail(f"param offload: eval after the step streamed "
             f"{tpo.COUNTS['stream_in']} layers, loss {run['losses'][0]} -> "
             f"{after}")
    opt = engine.offloaded_optimizer
    run.update(layers=layers, peak_mem_gb_optimizer_offload=ref_peak_gb,
               loss_after=after, step_ms_timed=run["step_ms"][0],
               host_tensor_gb=opt.arena.tensor_bytes / 1e9,
               host_pinned_gb=opt.arena.pinned_bytes / 1e9)
    del placed, stack, opt
    close_engine(torch, engine)
    return run


def nvme_tiers(torch, fa, cfg_of=llama_cfg, layers: int = NVME_LAYERS
               ) -> dict:
    """(c) the NVMe tiers under ``build/``: the moments (``offload_
    optimizer: nvme``) and the f32 master (``offload_param: nvme``), at
    ``layers`` layers for NVME_STEPS steps; then one timed read and write
    of each tier."""
    import shutil

    cfg = cfg_of(layers)
    settle_host_memory(OFFLOAD_HOST_B * cfg.num_params()
                       + OFFLOAD_HOST_MARGIN)
    path = os.path.join(OFFLOAD_DIR, "nvme")
    shutil.rmtree(path, ignore_errors=True)
    engine = offload_engine(torch, cfg, {
        "offload_optimizer": {"device": "nvme", "nvme_path": path},
        "offload_param": {"device": "nvme", "nvme_path": path}})
    placed = offload_batch(engine, cfg)
    run = run_steps(torch, fa, engine, placed, NVME_STEPS, layers,
                    "nvme offload")
    opt = engine.offloaded_optimizer
    opt.drain()
    state_bytes = sum(os.path.getsize(os.path.join(path, f))
                      for f in os.listdir(path) if f.endswith(".bin"))
    master_dir = os.path.join(path, "master")
    master_bytes = sum(os.path.getsize(os.path.join(master_dir, f))
                       for f in os.listdir(master_dir))
    t0 = time.perf_counter()
    opt.prefetch()
    opt.swap_in()
    opt._master_in()
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    opt.swap_out_async()
    opt._master_out()
    opt.drain()
    write_s = time.perf_counter() - t0
    nbytes = state_bytes + master_bytes
    run.update(layers=layers, state_gb=state_bytes / 1e9,
               master_gb=master_bytes / 1e9,
               read_gb_s=nbytes / read_s / 1e9,
               write_gb_s=nbytes / write_s / 1e9)
    del placed, opt
    close_engine(torch, engine)
    shutil.rmtree(path, ignore_errors=True)
    return run


def zenflow_run(torch, fa, cfg_of=llama_cfg, layers: int = ZENFLOW_LAYERS,
                steps: int = ZENFLOW_STEPS) -> dict:
    """(d) ZenFlow (topk_ratio ZENFLOW_RATIO, update_interval
    ZENFLOW_INTERVAL) at ``layers`` layers: hot-step against flush-step
    ms, ``cold_bytes_transferred`` against the gradient bytes that plain
    offload moves, and the compact state's bytes."""
    cfg = cfg_of(layers)
    settle_host_memory(OFFLOAD_HOST_B * cfg.num_params()
                       + OFFLOAD_HOST_MARGIN)
    engine = offload_engine(torch, cfg, {"offload_optimizer": {
        "device": "cpu"}}, {"zenflow": {
            "enabled": True, "topk_ratio": ZENFLOW_RATIO,
            "update_interval": ZENFLOW_INTERVAL}})
    placed = offload_batch(engine, cfg)
    run = run_steps(torch, fa, engine, placed, steps, layers, "zenflow")
    zf = engine.zenflow_optimizer
    grad_bytes = sum(p.numel() * 4 for p in engine._leaves)
    flushes = steps // ZENFLOW_INTERVAL
    if zf.cold_bytes_transferred != flushes * grad_bytes:
        fail(f"zenflow: {zf.cold_bytes_transferred} cold bytes, want "
             f"{flushes} flushes of {grad_bytes}")
    if not run["losses"][-1] < run["losses"][0]:
        fail(f"zenflow: the loss did not fall: {run['losses']}")
    flush_steps = [i for i in range(steps) if (i + 1) % ZENFLOW_INTERVAL == 0]
    hot = [t for i, t in enumerate(run["step_ms"])
           if i not in flush_steps and i > 0]
    compact = sum(t.numel() * t.element_size() for t in zf._hot_master)
    compact += sum(t.numel() * t.element_size()
                   for lst in zf.optimizer._leaf_state() for t in lst
                   if t is not None)
    run.update(layers=layers, hot_step_ms=statistics.median(hot),
               flush_step_ms=statistics.median(
                   [run["step_ms"][i] for i in flush_steps]),
               cold_bytes_transferred=zf.cold_bytes_transferred,
               plain_offload_grad_bytes=steps * grad_bytes,
               compact_state_gb=compact / 1e9)
    del placed, zf
    close_engine(torch, engine)
    return run


def small_offload_agreement(torch, fa) -> dict:
    """(e) the small f32 model of ``small_training_agreement``, 3 steps:
    each offloaded engine on the card against the same engine on the CPU
    (TOL_TRAIN), and the offloaded engine against the on-device one on the
    card (TOL_OFFLOAD)."""
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer as tfm
    from deepspeed_tpu_torch.runtime.engine import ModelSpec
    from deepspeed_tpu_torch.runtime.optimizers import leaves
    from deepspeed_tpu_torch.sequence.tiled_compute import tiled_loss_fn

    cfg = tfm.get_config("tiny", hidden_size=256, intermediate_size=512,
                         num_heads=4, num_kv_heads=2, dtype="float32",
                         param_dtype="float32", attn_impl="flash")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(SEED),
                             device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(SEED)
    batches = [{"input_ids": rng.integers(0, cfg.vocab_size, size=(
        4, cfg.max_seq_len)).astype(np.int32)} for _ in range(3)]

    def train(zero, dev):
        engine, _, _, _ = deepspeed_tpu_torch.initialize(
            model=ModelSpec(loss_fn=lambda p, b, r: tiled_loss_fn(
                p, b, cfg, tile_size=64), params=params), config={
                "train_micro_batch_size_per_gpu": 4,
                "optimizer": {"type": "adamw", "params": {
                    "lr": 1e-4, "weight_decay": 0.01}},
                "gradient_clipping": 1.0, "steps_per_print": 10_000,
                "zero_optimization": {"stage": 0, **zero}}, device=dev)
        fa.reset_counts()
        losses = [engine.train_batch(b)["loss"] for b in batches]
        if engine.offload_enabled and engine._delayed_update:
            engine.flush_delayed_update()
        if dev == "cuda" and (not all(fa.LAUNCHES.values())
                              or any(fa.PLAIN_CALLS.values())):
            fail(f"small offload {zero}: the card run did not go through "
                 f"the kernels: {fa.LAUNCHES} {fa.PLAIN_CALLS}")
        out = (losses, [p.detach().cpu().float() for p in
                        leaves(engine.params)])
        if engine.offloaded_optimizer is not None:
            engine.offloaded_optimizer.close()
        return out

    def diff(a, b):
        return (max(abs(x - y) / abs(y) for x, y in zip(a[0], b[0])),
                max((x - y).abs().max().item() for x, y in zip(a[1], b[1])))

    on_card = train({}, "cuda")
    out = {}
    for name, zero in (
            ("optimizer", {"offload_optimizer": {"device": "cpu"}}),
            ("delayed", {"offload_optimizer": {"device": "cpu",
                                               "delayed_update": True}}),
            ("param", {"offload_param": {"device": "cpu"},
                       "stage3_param_persistence_threshold": 0})):
        card, cpu = train(zero, "cuda"), train(zero, "cpu")
        loss_rel, param_diff = diff(card, cpu)
        if not loss_rel <= TOL_TRAIN or not param_diff <= TOL_TRAIN:
            fail(f"small offload {name}: card vs CPU losses differ by "
                 f"{loss_rel} (relative), parameters by {param_diff}")
        row = {"loss_max_rel_diff": loss_rel,
               "param_max_abs_diff": param_diff}
        if name != "delayed":  # the delayed run is one update behind
            loss_rel, param_diff = diff(card, on_card)
            if not loss_rel <= TOL_OFFLOAD or not param_diff <= TOL_OFFLOAD:
                fail(f"small offload {name}: offloaded vs on-device on the "
                     f"card differ by {loss_rel} (losses, relative), "
                     f"{param_diff} (parameters)")
            row.update(vs_device_loss_rel=loss_rel,
                       vs_device_param_abs=param_diff)
        out[name] = row
    return out


def cpu_checkpointing_run(torch, fa, cfg_of=llama_cfg,
                          layers: int = CKPT_LAYERS) -> dict:
    """(f) ``cpu_checkpointing`` at full width over ``layers`` layers: each
    layer through ``checkpointing.checkpoint`` (its tagged ``attn_out`` and
    ``mlp_out`` feed only residual adds, so the host keeps what a backward
    reads of them: nothing); loss and gradients held to the model's
    ``nothing_saveable`` within TOL_BF16, peak GB and host bytes beside
    it."""
    import numpy as np

    from deepspeed_tpu_torch.models import transformer as tfm
    from deepspeed_tpu_torch.runtime import config as tconfig
    from deepspeed_tpu_torch.runtime.activation_checkpointing import \
        checkpointing as tck
    from deepspeed_tpu_torch.runtime.optimizers import leaves
    from deepspeed_tpu_torch.sequence.tiled_compute import (
        tiled_logits_loss, tiled_loss_fn)

    cfg = cfg_of(layers)
    params = tfm.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), device="cuda", dtype=tfm.param_dtype(cfg))
    flat = leaves(params)
    for t in flat:
        t.requires_grad_(True)
    batch = {"input_ids": torch.from_numpy(np.random.default_rng(
        SEED).integers(0, cfg.vocab_size, size=(FB, FS)).astype(
            np.int32)).cuda()}
    host_cfg = tconfig.ActivationCheckpointingConfig(cpu_checkpointing=True)
    attn_fn = tfm.resolve_attention(cfg.attn_impl)

    def cpu_loss():
        labels, mask = tfm.shift_labels(batch)
        x = tfm.embed_tokens(params, batch["input_ids"].long(), cfg)
        cos, sin = tfm.rope_table(FS, cfg.rot_dim, cfg.rope_theta, x.device)
        for i in range(cfg.num_layers):
            lp = tfm.layer_params(params, i)
            keys = list(lp)

            def layer(h, *parts, i=i, keys=keys):
                return tfm.layer_forward(h, dict(zip(keys, parts)), cfg,
                                         cos, sin, attn_fn, i=i)

            x = tck.checkpoint(layer, x, *lp.values(), cfg=host_cfg)
        x = tfm._norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
        w, tied, hb = tfm.lm_head(params, cfg, x.dtype)
        nll, _ = tiled_logits_loss(x, w, labels, TILE, mask=mask,
                                   transpose_head=tied, head_bias=hb)
        return nll / mask.sum().clamp(min=1.0)

    runs = {}
    for name, fn in (("nothing_saveable",
                      lambda: tiled_loss_fn(params, batch, cfg,
                                            tile_size=TILE)[0]),
                     ("cpu_checkpointing", cpu_loss)):
        fn()  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = dict(tck.HOST_SAVED)
        t0 = time.perf_counter()
        loss = fn()
        grads = torch.autograd.grad(loss, flat)
        torch.cuda.synchronize()
        runs[name] = {"loss": loss.detach(), "grads": grads,
                      "fwd_bwd_ms": (time.perf_counter() - t0) * 1e3,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "host_saved_gb": (tck.HOST_SAVED["bytes"]
                                        - before["bytes"]) / 1e9,
                      "host_saved_tensors": tck.HOST_SAVED["tensors"]
                      - before["tensors"]}
    ref, got = runs["nothing_saveable"], runs["cpu_checkpointing"]
    compare(got["loss"], ref["loss"], TOL_BF16, "cpu_checkpointing loss")
    err = max(compare(g, r, TOL_BF16, "cpu_checkpointing gradient")
              for g, r in zip(got["grads"], ref["grads"]))
    out = {"layers": layers, "max_abs_err_grads": err}
    for name, r in runs.items():
        out[name] = {k: v for k, v in r.items() if k not in ("loss",
                                                           "grads")}
    del params, flat, runs, ref, got
    torch.cuda.empty_cache()
    return out


def ds_io_sweep(size_mb: int = DS_IO_MB) -> dict:
    """(g) ``nvme/ds_io`` read and write sweeps of ``size_mb`` on
    ``build/``: the best point of each and the aio block it generates."""
    from deepspeed_tpu_torch.nvme import ds_io

    path = os.path.join(OFFLOAD_DIR, "io")
    out = {}
    for op in ("read", "write"):
        res = ds_io.run_sweep(path, op=op, size_mb=size_mb,
                              block_sizes=(1 << 20, 4 << 20),
                              queue_depths=(8, 32), thread_counts=(1, 4))
        if not res:
            fail(f"ds_io {op} sweep: every point failed")
        out[op] = {"best_gb_s": res[0].gbps, "points": len(res),
                   "aio": ds_io.generate_aio_config(res)["aio"]}
    return out


def host_adam_times(torch, n: int = 1 << 27) -> dict:
    """The host's AdamW on one f32 leaf of ``n`` elements (a 512 MB
    leaf), ns an element: the plain PyTorch update (``runtime/
    optimizers.py``, 14 passes) against the one-pass loop the offloaded
    optimizer runs (``ops/cpu_adam.py``)."""
    from deepspeed_tpu_torch.ops import cpu_adam
    from deepspeed_tpu_torch.runtime.optimizers import Adam, Optimizer

    gen = torch.Generator().manual_seed(SEED)
    p = [torch.randn(n, generator=gen)]
    g = [torch.randn(n, generator=gen)]
    out = {"n": n}
    for name, step in (("plain", Optimizer.step),
                       ("one_pass", cpu_adam.adam_step)):
        opt = Adam(1e-4, weight_decay=0.1, mask=[True])
        opt.init(p)
        step(opt, p, g)  # the moments' pages and the threads warm
        t0 = time.perf_counter()
        step(opt, p, g)
        out[f"{name}_ns"] = (time.perf_counter() - t0) / n * 1e9
    return out


def run_offload_phase(torch, fa, card: str, cfg_of=llama_cfg) -> dict:
    """ZeRO-Offload / ZeRO-Infinity on the card, (a)-(g).  The streamed
    engine (b) needs the most host memory, so it runs after the smaller
    engines, while the host takes (a)'s memory back; ``seconds`` holds
    each part's."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out, secs = {}, {}

    def part(name, fn, *args):
        t = time.perf_counter()
        out[name] = fn(*args)
        secs[name] = time.perf_counter() - t

    part("optimizer", optimizer_offload, torch, fa, cfg_of, card)
    part("zenflow", zenflow_run, torch, fa, cfg_of)
    part("nvme", nvme_tiers, torch, fa, cfg_of)
    part("param", param_offload, torch, fa, out["optimizer"]["layers"],
         out["optimizer"]["plain"]["peak_mem_gb"], cfg_of)
    part("small", small_offload_agreement, torch, fa)
    part("cpu_checkpointing", cpu_checkpointing_run, torch, fa, cfg_of)
    part("ds_io", ds_io_sweep)
    part("host_adam", host_adam_times, torch)
    out["part_seconds"] = secs
    out["seconds"] = time.perf_counter() - t0
    return out


def offload_line(off: dict, card: str) -> str:
    a, b, c, d = (off[k] for k in ("optimizer", "param", "nvme", "zenflow"))
    f, g, h = off["cpu_checkpointing"], off["ds_io"], off["host_adam"]
    pl, dl = a["plain"], a["delayed"]
    hm = pl["host_ms"]
    return (f"offload phase ({card}, MemTotal {a['mem_total_gb']:.2f} GB, "
            f"{off['seconds']:.1f} s): llama3-8b trained at {a['layers']} "
            f"layers with optimizer offload ({a['host_bytes_need_gb']:.2f} GB"
            f" of host tensors needed, MemAvailable "
            f"{a['mem_available_gb']:.2f} GB): step {pl['step_ms_timed']:.2f}"
            f" ms, {pl['tokens_per_s']:.2f} tokens/s, MFU {pl['mfu']:.4f}, "
            f"device peak {pl['peak_mem_gb']:.2f} GB, card fwd+bwd "
            f"{pl['device_ms']:.2f} ms, host update {hm['update_ms']:.2f} ms,"
            f" D2H {hm['d2h_ms']:.2f} ms, H2D {hm['h2d_ms']:.2f} ms, host "
            f"tensors {a['host_tensor_gb']:.2f} GB page-locked "
            f"{a['host_pinned_gb']:.2f} GB, engine built in "
            f"{a['init_s']:.1f} s | delayed_update step "
            f"{dl['step_ms_timed']:.2f} ms (max(device, host) "
            f"{max(pl['device_ms'], hm['update_ms']):.2f}, sum "
            f"{pl['device_ms'] + hm['update_ms']:.2f}) | param offload x"
            f"{b['layers']}: step {b['step_ms_timed']:.2f} ms, device peak "
            f"{b['peak_mem_gb']:.2f} GB (optimizer offload "
            f"{b['peak_mem_gb_optimizer_offload']:.2f}), stream-ins "
            f"{b['stream_ins']} | nvme x{c['layers']}: step "
            f"{statistics.median(c['step_ms']):.2f} ms, read "
            f"{c['read_gb_s']:.3f} GB/s write {c['write_gb_s']:.3f} GB/s "
            f"({c['state_gb'] + c['master_gb']:.2f} GB) | zenflow x"
            f"{d['layers']}: hot step {d['hot_step_ms']:.2f} ms, flush step "
            f"{d['flush_step_ms']:.2f} ms, cold bytes "
            f"{d['cold_bytes_transferred'] / 1e9:.2f} GB of "
            f"{d['plain_offload_grad_bytes'] / 1e9:.2f}, compact state "
            f"{d['compact_state_gb']:.3f} GB | cpu_checkpointing x"
            f"{f['layers']}: peak {f['cpu_checkpointing']['peak_mem_gb']:.2f}"
            f" GB (nothing_saveable {f['nothing_saveable']['peak_mem_gb']:.2f}"
            f"), {f['cpu_checkpointing']['host_saved_gb']:.3f} GB on the "
            f"host | ds_io {DS_IO_MB} MB: read {g['read']['best_gb_s']:.3f} "
            f"write {g['write']['best_gb_s']:.3f} GB/s | host AdamW on "
            f"{h['n']} elements: plain {h['plain_ns']:.3f} ns an element, "
            f"one pass {h['one_pass_ns']:.3f}")


# ---------------------------------------------------------------------------
# PEFT / LoRA training: QLoRA at full depth, B6 under autograd
# ---------------------------------------------------------------------------

# (a) QLoRA on llama3-8b at full width and depth: the reference's LoRA
# defaults (r 64, alpha 16, the seven projections) over an int4 base of
# group 512; the training cell's settings otherwise.  The adapters are
# drawn in f32 (the base's codes are the same from an f32 or bf16 weight):
# a bf16 A of ~2**-6 would drop updates under its ulp, 2**-13.  lr 2e-4:
# the QLoRA paper's for 7B / 13B models
PEFT_LAYERS, PEFT_WARMUP, PEFT_STEPS = 32, 2, 5
PEFT_LORA = {"enabled": True, "lora_r": 64, "lora_alpha": 16.0,
             "quantize_base": True,
             "quantization": {"q_bits": 4, "mantissa_bits": 0,
                              "group_size": 512}}
PEFT_LR = 2e-4
PEFT_RESUMED = 2  # (d): steps after the adapter-only checkpoint's load
PEFT_DIR = os.path.join("build", "peft_smoke")
# (b): the other bases at CKPT_LAYERS layers, one step each; int8 and fp6
# run B6 and hold the adapters' gradients against B6's plain version
PEFT_BASES = {"int8": (8, 0), "fp6": (6, 2), "fp8": (8, 3), "dense": None}
# (b)'s gradients, B6 against its plain version.  The two forwards differ
# only where an f32 sum of the same exact bf16 products rounds to the other
# bf16 neighbour, but from such a flip on, every bf16 rounding of the
# backward (2**-8 an operation) falls elsewhere: measured on an NVIDIA
# H100 80GB HBM3 at 700 W, every adapter's gradient differed from the plain
# version's by 0.97-1.18e-2 of its norm at 2 layers, int8 and fp6 alike,
# the loss by 4e-6 of itself, while B6 and cuBLAS on the dequantized weight
# gave the same gradients bit for bit.  The limit is 5e-2 of the norm, 4x
# that noise; a dropped K-group (one of 8 of a projection) moves the
# projection's output, and its gradients, by ~1/8.  The loss: 1e-4
PEFT_GRAD_REL = 5e-2
PEFT_LOSS_REL = 1e-4
# (c): B6 at the training step's rows
B6_TRAIN_M = FB * FS
B6_TRAIN_BITS = {"mixed_gemm_int4": 4, "mixed_gemm_int8": 8,
                 "mixed_gemm_fp6": 6}
B6_TRAIN_GROUP = 512
# (e): the merged export's serving check, prompts of the engine phase's
# lengths cut to four, PEFT_NEW greedy tokens each
PEFT_PROMPTS, PEFT_NEW = PROMPT_LENS[::2], 8


def peft_lora_cfg(base):
    """The PEFT phase's ``peft.lora`` section over ``base`` ((q_bits,
    mantissa_bits), or None for a dense base)."""
    lora = dict(PEFT_LORA)
    if base is None:
        lora["quantize_base"] = False
    else:
        lora["quantization"] = dict(lora["quantization"], q_bits=base[0],
                                    mantissa_bits=base[1])
    return lora


def qlora_tree(torch, cfg, lora: dict, seed: int = SEED):
    """Seeded llama3-8b weights at ``cfg``'s depth as a LoRA tree built on
    the card one layer at a time (the bf16 layer is drawn, quantized and
    dropped, so the whole bf16 tree never exists beside its codes), the
    adapters in f32.  Returns (tree, seconds)."""
    import dataclasses as dc

    from deepspeed_tpu_torch.linear.config import LoRAConfig
    from deepspeed_tpu_torch.linear.optimized_linear import (
        init_lora_weight, tree_map)
    from deepspeed_tpu_torch.models import transformer as tfm

    t0 = time.perf_counter()
    lcfg = LoRAConfig.from_dict(lora)
    one = dc.replace(cfg, num_layers=1)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    L = cfg.num_layers
    stacked = None
    for i in range(L):
        p = tfm.init_params(one, gen, device="cuda",
                            dtype=tfm.param_dtype(cfg))
        layer = p.pop("layers")
        if i == 0:
            rest = p
        for grp in ("attn", "mlp"):
            for k in lcfg.target_modules:
                if k in layer[grp]:
                    layer[grp][k] = init_lora_weight(
                        gen, layer[grp][k].float(), lcfg)
        if stacked is None:  # (L, ...) of every leaf
            stacked = tree_map(lambda t: t.new_empty((L,) + t.shape[1:]),
                               layer)
        tree_map(lambda s, t: s[i].copy_(t[0]), stacked, layer)
        del layer, p
    rest["layers"] = stacked
    torch.cuda.synchronize()
    return rest, time.perf_counter() - t0


def peft_engine(cfg, tree, lora: dict):
    """The PEFT engine (bf16, flash, tiled loss, AdamW at PEFT_LR, micro-batch
    FB) on ``tree``, which already holds the LoRA nodes."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.runtime.engine import ModelSpec
    from deepspeed_tpu_torch.sequence.tiled_compute import tiled_loss_fn

    return deepspeed_tpu_torch.initialize(
        model=ModelSpec(loss_fn=lambda p, b, r: tiled_loss_fn(
            p, b, cfg, tile_size=TILE), params=tree),
        config={"train_micro_batch_size_per_gpu": FB,
                "optimizer": {"type": "adamw", "params": {"lr": PEFT_LR}},
                "zero_optimization": {"stage": 0}, "peft": {"lora": lora},
                "steps_per_print": 10_000})[0]


def frozen_state(torch, engine) -> tuple:
    """(the frozen leaves, their bit sums: 1-byte codes viewed as int32)."""
    from deepspeed_tpu_torch.linear.optimized_linear import ADAPTER_LEAF_KEYS

    frozen = [p for p, path in zip(engine._all_leaves, engine._all_paths)
              if path.split("/")[-1] not in ADAPTER_LEAF_KEYS]
    return frozen, bit_sums(torch, [
        t.view(torch.int32) if t.element_size() == 1 else t for t in frozen])


def check_adapters_only(torch, engine, what: str) -> dict:
    """Gradients and optimizer state exist for the LoRA factors alone:
    the trainable leaves are exactly the ``lora_a`` / ``lora_b`` leaves,
    every other leaf takes no gradient and has none, and every optimizer
    state leaf names an adapter."""
    from deepspeed_tpu_torch.linear.optimized_linear import ADAPTER_LEAF_KEYS

    adapters = [p for p in engine._all_paths
                if p.split("/")[-1] in ADAPTER_LEAF_KEYS]
    frozen, _ = frozen_state(torch, engine)
    state = engine.optimizer_state_flat()
    bad = [k for k in state if k.split("/")[-1] not in ADAPTER_LEAF_KEYS
           and not k.endswith("count")]
    if engine._paths != adapters or any(
            p.requires_grad or p.grad is not None for p in frozen) or bad:
        fail(f"{what}: a frozen leaf trains or has state (trainable "
             f"{len(engine._paths)} of {len(adapters)} adapter leaves; "
             f"state of {bad[:3]})")
    nbytes = [sum(t.numel() * t.element_size() for t in ts)
              for ts in (engine._leaves, frozen, state.values())]
    return {"adapter_gb": nbytes[0] / 1e9, "frozen_gb": nbytes[1] / 1e9,
            "optimizer_state_gb": nbytes[2] / 1e9}


def peft_qlora(torch, fa, mg) -> dict:
    """(a) and (d): QLoRA llama3-8b at PEFT_LAYERS layers, PEFT_WARMUP +
    PEFT_STEPS steps on one batch (exact B6 wgmma and B1-B3 launches, no
    plain or off-envelope call, falling loss, codes and scales bit for bit,
    adapters alone trained); then an adapter-only checkpoint, PEFT_RESUMED
    steps, its load and the same steps again (equal losses)."""
    import shutil

    import numpy as np

    cfg = llama_cfg(PEFT_LAYERS)
    tree, build_s = qlora_tree(torch, cfg, PEFT_LORA)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine = peft_engine(cfg, tree, PEFT_LORA)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    if not engine.peft_enabled:
        fail("peft: the engine did not take the LoRA tree")
    base = check_adapters_only(torch, engine, "peft")
    frozen, sums = frozen_state(torch, engine)
    placed = engine.place_batch({"input_ids": np.random.default_rng(
        SEED).integers(0, cfg.vocab_size, size=(
            engine.train_batch_size, FS)).astype(np.int32)})
    steps = PEFT_WARMUP + PEFT_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_counts()
    mg.reset_counts()
    losses, times = [], []
    for _ in range(steps):
        t = time.perf_counter()
        losses.append(engine.train_batch(placed)["loss"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    L = cfg.num_layers
    launches = {**fa.LAUNCHES, **{f"{k}_wgmma": v for k, v in
                                  mg.WGMMA_LAUNCHES.items()}}
    # B6: each of the seven projections in the forward and again in the
    # remat recompute; B1 forward and recompute, B2, B3 once a layer
    want_b6 = 2 * PROJECTIONS * L * steps
    want = {"flash_fwd": 2 * L * steps, "flash_bwd_dkdv": L * steps,
            "flash_bwd_dq": L * steps}
    got_fa = {k: fa.LAUNCHES[k] for k in want}
    if got_fa != want or any(fa.PLAIN_CALLS.values()):
        fail(f"peft: flash launches {got_fa}, want {want}; plain "
             f"{fa.PLAIN_CALLS}")
    if (mg.LAUNCHES["mixed_gemm_int4"] != want_b6
            or mg.WGMMA_LAUNCHES["mixed_gemm_int4"] != want_b6
            or any(v for k, v in mg.LAUNCHES.items()
                   if k != "mixed_gemm_int4")
            or any(mg.PLAIN_CALLS.values())
            or any(mg.DEQUANT_CALLS.values())):
        fail(f"peft: B6 launches {mg.LAUNCHES} (wgmma {mg.WGMMA_LAUNCHES}),"
             f" want {want_b6} int4 on mixed_gemm_wgmma_kernel; plain "
             f"{mg.PLAIN_CALLS}, off-envelope {mg.DEQUANT_CALLS}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail(f"peft: the loss did not fall on a fixed batch: {losses}")
    if frozen_state(torch, engine)[1] != sums:
        fail("peft: a frozen leaf (codes, scales, embedding, norms) "
             "changed")
    check_adapters_only(torch, engine, "peft after the steps")
    dt = statistics.median(times[PEFT_WARMUP:]) / 1e3
    tokens = engine.train_batch_size * (FS - 1)
    # per token: the frozen base's forward and dx (4 N), the adapters'
    # forward, dx and dW (6 N_adapter), attention as the training cell
    n_base = cfg.num_params(include_embed=False)
    n_adapter = sum(p.numel() for p in engine._leaves)
    flops_per_token = 4 * n_base + 6 * n_adapter \
        + 12 * L * cfg.hidden_size * FS
    from deepspeed_tpu_torch.accelerator import get_accelerator

    peak = get_accelerator().peak_tflops("bfloat16") * 1e12
    out = {"model": "llama3-8b", "layers": L, "lora": PEFT_LORA,
           "lr": PEFT_LR, "tree_build_s": build_s, "engine_init_s": init_s,
           "losses": losses, "step_ms": times, "step_ms_timed": dt * 1e3,
           "tokens_per_s": tokens / dt,
           "mfu": tokens / dt * flops_per_token / peak,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "adapter_params": n_adapter, **base, "launches": launches,
           "launches_per_step": {k: v // steps for k, v in launches.items()},
           "frozen_bits_equal": True}
    # (d): an adapter-only checkpoint; the steps after it, then its load
    # and the same steps again
    shutil.rmtree(PEFT_DIR, ignore_errors=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = engine.save_checkpoint(PEFT_DIR)
    save_s = time.perf_counter() - t0
    after = [engine.train_batch(placed)["loss"] for _ in range(PEFT_RESUMED)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.load_checkpoint(PEFT_DIR)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    resumed = [engine.train_batch(placed)["loss"]
               for _ in range(PEFT_RESUMED)]
    if resumed != after:
        fail(f"peft: resumed losses {resumed} != the uninterrupted run's "
             f"{after}")
    files = sorted(os.listdir(path))
    if "model.safetensors" in files or "adapter_model.safetensors" \
            not in files:
        fail(f"peft: the checkpoint is not adapter-only: {files}")
    gb = dir_bytes(path) / 1e9
    full_gb = (base["adapter_gb"] + base["frozen_gb"]
               + base["optimizer_state_gb"])
    out["checkpoint"] = {"gb": gb, "full_gb_computed": full_gb,
                         "save_s": save_s, "load_s": load_s,
                         "save_gb_s": gb / save_s, "load_gb_s": gb / load_s,
                         "files": files, "losses_after": after,
                         "losses_resumed": resumed}
    shutil.rmtree(PEFT_DIR, ignore_errors=True)
    del engine, placed, frozen
    gc.collect()
    torch.cuda.empty_cache()
    return out


class _PlainFrozen:
    """``mixed_gemm_frozen`` with B6's plain version in the forward (the
    same backward): the oracle of (b)'s gradients; ``library``: cuBLAS on
    the dequantized bf16 weight instead."""

    def __init__(self, torch, mg, library: bool = False):
        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, qw):
                ctx.qw = qw
                if library:
                    return x @ mg.dequantize_gemm_weight(qw).to(x.dtype)
                x2 = x.reshape(-1, x.shape[-1])
                return mg.mixed_gemm_plain(x2, qw).reshape(
                    *x.shape[:-1], qw.out_features)

            @staticmethod
            def backward(ctx, g):
                w = mg.dequantize_gemm_weight(ctx.qw).to(g.dtype)
                return g @ w.transpose(-1, -2), None

        self.apply = Fn.apply

    def __call__(self, x, qw):
        return self.apply(x, qw)


def peft_bases(torch, fa, mg) -> dict:
    """(b): int8, fp6, fp8 and dense bases at CKPT_LAYERS layers.  For the
    B6 bases the adapters' gradients of one batch (B6) against the same
    with B6's plain version (within the bf16 gradient limit); then one
    engine step each, B6 launched exactly 2 x 7 x L times for int8 / fp6
    and never for fp8 and dense."""
    import numpy as np

    from deepspeed_tpu_torch.linear import optimized_linear as tl
    from deepspeed_tpu_torch.sequence.tiled_compute import tiled_loss_fn

    cfg = llama_cfg(CKPT_LAYERS)
    batch = np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, size=(FB, FS)).astype(np.int32)
    out = {}
    for name, fmt in PEFT_BASES.items():
        lora = peft_lora_cfg(fmt)
        tree, _ = qlora_tree(torch, cfg, lora, SEED + 1)
        # give the adapters a real contribution: B from the seed
        gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
        for grp in ("attn", "mlp"):
            for node in tree["layers"][grp].values():
                if isinstance(node, tl.LoRAWeight):
                    node.lora_b.normal_(0.0, 1e-2, generator=gen)
        engine = peft_engine(cfg, tree, lora)
        del tree
        rec = {"base": name}
        b6 = fmt in ((8, 0), (6, 2))
        if b6:
            tokens = torch.from_numpy(batch).cuda()

            def grads(frozen=None):
                kernel_fn = tl.mixed_gemm_frozen
                tl.mixed_gemm_frozen = frozen or kernel_fn
                try:
                    loss, _ = tiled_loss_fn(engine.params, {
                        "input_ids": tokens}, cfg, tile_size=TILE)
                    return loss.item(), torch.autograd.grad(
                        loss, engine._leaves)
                finally:
                    tl.mixed_gemm_frozen = kernel_fn

            mg.reset_counts()
            loss_k, got = grads()
            n_kernel = sum(mg.WGMMA_LAUNCHES.values())
            loss_p, ref = grads(_PlainFrozen(torch, mg))
            _, lib = grads(_PlainFrozen(torch, mg, library=True))
            if n_kernel != 2 * PROJECTIONS * CKPT_LAYERS:
                fail(f"peft {name}: {n_kernel} B6 launches in one forward "
                     f"and backward, want {2 * PROJECTIONS * CKPT_LAYERS}")

            def rel(a, b):
                return max(((x - y).norm() / y.norm()).item()
                           for x, y in zip(a, b))

            rec.update(loss_rel_err=abs(loss_k - loss_p) / abs(loss_p),
                       grads_rel_norm_err=rel(got, ref),
                       grads_rel_norm_err_library=rel(got, lib),
                       library_rel_norm_err=rel(lib, ref))
            if not (rec["grads_rel_norm_err"] <= PEFT_GRAD_REL
                    and rec["loss_rel_err"] <= PEFT_LOSS_REL):
                fail(f"peft {name}: with B6 the adapters' gradients differ "
                     f"from B6's plain version's by "
                     f"{rec['grads_rel_norm_err']} of their norm (limit "
                     f"{PEFT_GRAD_REL}), the loss by {rec['loss_rel_err']} "
                     f"(limit {PEFT_LOSS_REL})")
            del got, ref, lib
        mg.reset_counts()
        fa.reset_counts()
        loss = engine.train_batch({"input_ids": batch})["loss"]
        n = sum(mg.LAUNCHES.values())
        want = 2 * PROJECTIONS * CKPT_LAYERS if b6 else 0
        if n != want or any(mg.PLAIN_CALLS.values()) or not math.isfinite(
                loss):
            fail(f"peft {name}: {n} B6 launches in one step, want {want} "
                 f"(plain {mg.PLAIN_CALLS}); loss {loss}")
        rec.update(loss=loss, b6_launches=n, launches=dict(mg.LAUNCHES),
                   **check_adapters_only(torch, engine, f"peft {name}"))
        out[name] = rec
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return out


def b6_training_rows(torch, mg, flush) -> list:
    """(c): B6 at the training step's M = FB * FS rows, at llama3-8b's four
    projection shapes, bits 4, 8 and 6 (group B6_TRAIN_GROUP), bf16 x:
    held against its plain version (TOL_BF16); kernel, plain, library
    (``torch.matmul`` by the dequantized weight, as row 6; also with the
    dequantization) and bound ms, and the backward's dx (dequantize, then
    ``torch.matmul`` by its transpose)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    rows = []
    M = B6_TRAIN_M
    for shape_name, (K, N) in GEMM_SHAPES.items():
        w = torch.randn((K, N), generator=gen, device="cuda") / math.sqrt(K)
        x = torch.randn((M, K), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        g = torch.randn((M, N), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        for name, bits in B6_TRAIN_BITS.items():
            qw = mg.quantize_gemm_weight(w, bits=bits, group=B6_TRAIN_GROUP)
            if not mg.mixed_gemm_on_kernel_path(qw):
                fail(f"{name} {shape_name} M={M}: off the kernel path")
            before = mg.WGMMA_LAUNCHES[name]
            out = mg.mixed_gemm_frozen(x, qw)
            if mg.WGMMA_LAUNCHES[name] != before + 1:
                fail(f"{name} {shape_name} M={M}: not on "
                     "mixed_gemm_wgmma_kernel")
            ref = mg.mixed_gemm_plain(x, qw)
            torch.cuda.synchronize()
            err = compare(out, ref, TOL_BF16, f"{name} {shape_name} M={M}")
            del out, ref
            w_lib = mg.dequantize_gemm_weight(qw).to(torch.bfloat16)
            code_bytes = qw.codes.numel() + qw.scales.numel() * 4
            b_ms, b_by = bound(code_bytes + M * K * 2 + M * N * 2,
                               2 * M * K * N)
            rows.append({
                "name": name, "shape": shape_name, "K": K, "N": N, "M": M,
                "group": B6_TRAIN_GROUP, "kernel": "mixed_gemm_wgmma_kernel",
                "splits": mg.mixed_gemm_splits(
                    M, N, K // B6_TRAIN_GROUP,
                    torch.cuda.get_device_properties(0).multi_processor_count),
                "max_abs_err": err, "max_abs_err_f32": None,
                "ms": time_ms(lambda: mg.mixed_gemm(x, qw), torch, flush,
                              iters=10),
                "plain_ms": time_ms(lambda: mg.mixed_gemm_plain(x, qw),
                                    torch, flush, iters=3, warmup=1),
                "library_ms": time_ms(lambda: torch.matmul(x, w_lib), torch,
                                      flush, iters=10),
                "library_dequant_ms": time_ms(lambda: torch.matmul(
                    x, mg.dequantize_gemm_weight(qw).to(torch.bfloat16)),
                    torch, flush, iters=10),
                "bwd_dx_ms": time_ms(lambda: g @ mg.dequantize_gemm_weight(
                    qw).to(torch.bfloat16).transpose(-1, -2), torch, flush,
                    iters=10),
                "bound_ms": b_ms, "bound_by": b_by})
            del qw, w_lib
        del w, x, g
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def peft_merged_export(torch, mg) -> dict:
    """(e): the int4 QLoRA tree at CKPT_LAYERS layers with seeded adapters
    (B random), exported merged (``export_merged_weights``) and served by
    the v2 engine beside the unmerged LoRA tree: first-token logits within
    TOL_SPEC_LOGITS_REL of max |logit| per request, greedy continuations
    counted; the unmerged engine runs B6 on its LoRA bases."""
    import shutil

    import numpy as np

    from deepspeed_tpu_torch.inference.v2.engine import InferenceEngineV2
    from deepspeed_tpu_torch.linear import optimized_linear as tl
    from deepspeed_tpu_torch.runtime.checkpoint import engine as ce

    cfg = llama_cfg(CKPT_LAYERS)
    tree, _ = qlora_tree(torch, cfg, PEFT_LORA, SEED + 5)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    for grp in ("attn", "mlp"):
        for node in tree["layers"][grp].values():
            if isinstance(node, tl.LoRAWeight):
                node.lora_b.normal_(0.0, 1e-2, generator=gen)
    engine = peft_engine(cfg, tree, PEFT_LORA)
    del tree
    shutil.rmtree(PEFT_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    path = engine.export_merged_weights(PEFT_DIR)
    export_s = time.perf_counter() - t0
    merged = ce.load_merged_params(path, tl.merge_lora_weights(
        engine.params))
    if tl.has_lora(merged):
        fail("peft export: the merged tree still holds LoRA nodes")
    prompts = [list(np.random.default_rng(SEED + i).integers(
        0, cfg.vocab_size, n)) for i, n in enumerate(PEFT_PROMPTS)]
    scfg = dataclasses.replace(cfg, dtype="bfloat16")
    res = {}
    lora = tl.tree_map(lambda t: t.detach(), engine.params)
    for kind, params in (("merged", merged), ("lora", lora)):
        mg.reset_counts()
        eng = InferenceEngineV2(scfg, params, spec_v2())
        first = first_token_logits(torch, eng, prompts)
        uids = [eng.put(p, max_new_tokens=PEFT_NEW) for p in prompts]
        done = eng.generate_all()
        res[kind] = (first, [done[u][len(p):] for u, p in zip(uids, prompts)],
                     sum(mg.LAUNCHES.values()))
        del eng
        free_cache(torch)
    rel = [logits_rel(a, b) for a, b in zip(res["lora"][0],
                                            res["merged"][0])]
    if not max(rel) <= TOL_SPEC_LOGITS_REL:
        fail(f"peft export: first-token logits of the LoRA tree differ "
             f"from the merged weights' by {rel} of max |logit|")
    if not res["lora"][2] > 0 or res["merged"][2]:
        fail(f"peft export: B6 launches lora {res['lora'][2]}, merged "
             f"{res['merged'][2]}")
    same = sum(a == b for a, b in zip(res["lora"][1], res["merged"][1]))
    gb = dir_bytes(path) / 1e9
    shutil.rmtree(PEFT_DIR, ignore_errors=True)
    del engine, merged, lora
    free_cache(torch)
    return {"layers": CKPT_LAYERS, "export_s": export_s, "export_gb": gb,
            "first_logits_rel": rel, "b6_launches_lora": res["lora"][2],
            "continuations_identical": same, "requests": len(prompts)}


def small_peft_agreement(torch, fa) -> dict:
    """(f): a small f32 llama-shaped model with an int4 LoRA base, three
    PEFT steps on the card and on the CPU (``small_training_agreement``:
    TOL_TRAIN); f32 x dequantizes the base, as the reference does."""
    lora = dict(PEFT_LORA, lora_r=8,
                quantization=dict(PEFT_LORA["quantization"], group_size=64))
    return small_training_agreement(torch, fa, peft=lora)


def run_peft_phase(torch, fa, mg) -> dict:
    t0 = time.perf_counter()
    free_cache(torch)
    out, secs = {}, {}

    def part(name, fn, *args):
        t = time.perf_counter()
        out[name] = fn(*args)
        secs[name] = time.perf_counter() - t
        print(f"peft {name} ({secs[name]:.1f} s): "
              + json.dumps(out[name], default=str), flush=True)

    part("qlora", peft_qlora, torch, fa, mg)
    part("bases", peft_bases, torch, fa, mg)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    part("b6", b6_training_rows, torch, mg, flush)
    del flush
    part("export", peft_merged_export, torch, mg)
    part("small", small_peft_agreement, torch, fa)
    out["part_seconds"] = secs
    out["seconds"] = time.perf_counter() - t0
    return out


def peft_line(pf: dict, card: str) -> str:
    a, ck, e = pf["qlora"], pf["qlora"]["checkpoint"], pf["export"]
    b6 = "; ".join(
        f"{r['name'][11:]} {r['shape']} {r['ms']:.4f} ms (plain "
        f"{r['plain_ms']:.3f}, library {r['library_ms']:.4f}, with dequant "
        f"{r['library_dequant_ms']:.4f}, bound {r['bound_ms']:.4f} "
        f"{r['bound_by']}, dx {r['bwd_dx_ms']:.4f})" for r in pf["b6"])
    bases = ", ".join(
        f"{k} loss {v['loss']:.4f} B6 {v['b6_launches']}"
        + (f" grads vs plain {v['grads_rel_norm_err']:.3e} (norm; vs "
           f"cuBLAS {v['grads_rel_norm_err_library']:.3e})"
           if "grads_rel_norm_err" in v else "")
        for k, v in pf["bases"].items())
    return (f"peft phase ({card}, {pf['seconds']:.1f} s): QLoRA llama3-8b "
            f"x{a['layers']} (int4 base, r 64): step "
            f"{a['step_ms_timed']:.2f} ms, {a['tokens_per_s']:.2f} tokens/s,"
            f" MFU {a['mfu']:.4f}, device peak {a['peak_mem_gb']:.2f} GB, "
            f"base {a['frozen_gb']:.2f} GB, adapters {a['adapter_gb']:.3f} "
            f"GB ({a['adapter_params']} params), optimizer state "
            f"{a['optimizer_state_gb']:.3f} GB, tree {a['tree_build_s']:.1f}"
            f" s, engine {a['engine_init_s']:.1f} s, B6 a step "
            f"{a['launches_per_step']['mixed_gemm_int4_wgmma']}, losses "
            f"{a['losses'][0]:.4f} -> {a['losses'][-1]:.4f} | adapter-only "
            f"checkpoint {ck['gb']:.3f} GB (full {ck['full_gb_computed']:.2f}"
            f" GB computed) save {ck['save_s']:.2f} s load {ck['load_s']:.2f}"
            f" s | x{CKPT_LAYERS}: {bases} | export {e['export_s']:.1f} s "
            f"{e['export_gb']:.2f} GB, logits rel "
            f"{max(e['first_logits_rel']):.3e}, continuations "
            f"{e['continuations_identical']}/{e['requests']} | small card vs "
            f"CPU {pf['small']['loss_max_rel_diff']:.2e} | B6 at M="
            f"{B6_TRAIN_M}: {b6}")


# ---------------------------------------------------------------------------
# quantized serving: mixed GEMM (B6) and W8A8 (B7)
# ---------------------------------------------------------------------------

GEMM_KERNELS = {"mixed_gemm_int8": 8, "mixed_gemm_int4": 4,
                "mixed_gemm_fp6": 6, "int8_gemm": 8}


def check_mixed_gemm(torch, mg, flush, dtype=None) -> list:
    """B6 (bits 8, 4, 6) and B7 against their plain versions at llama3-8b's
    four projection shapes, M = 8 and 256 (B6 also at M = 1 and 16 and,
    for int8 B6, v1's prefill M = GEMM_V1_M), group 256: bf16 x per
    element within TOL_BF16, f32 x within GEMM_F32_REL of the largest
    output; with ``dtype`` f16, f16 x alone: B6 within the f16 limit with
    GEMM_F32_REL of the largest output for the f32 sums' order (both sides
    round x to bf16: the same exact products), B7 bit for bit; each B6
    call at M <= 16 on ``mixed_gemm_decode_kernel``, and above 16 rows its
    split count (``splits``); kernel / plain / library / bound ms of the
    2-byte call.  The library call is one ``torch.matmul`` of x by the
    dequantized weight in x's dtype (the dequantization excluded): the
    stock path the kernel replaces."""
    dtype = dtype or torch.bfloat16
    bf16 = dtype == torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows = []
    for shape_name, (K, N) in GEMM_SHAPES.items():
        w = torch.randn((K, N), generator=gen, device="cuda") / math.sqrt(K)
        for name, bits in GEMM_KERNELS.items():
            qw = mg.quantize_gemm_weight(w, bits=bits, group=QUANT_GROUP)
            if not mg.mixed_gemm_on_kernel_path(qw):
                fail(f"{name} {shape_name}: off the reference's kernel path")
            w_lib = mg.dequantize_gemm_weight(qw).to(dtype)
            code_bytes = qw.codes.numel() + qw.scales.numel() * 4
            if name == "int8_gemm":
                ms = GEMM_MS
            else:
                ms = GEMM_DECODE_MS + GEMM_MS[1:] + (
                    (GEMM_V1_M,) if name == "mixed_gemm_int8" else ())
            for M in ms:
                x = torch.randn((M, K), generator=gen, device="cuda",
                                dtype=dtype)
                errs = {"f32": None}
                for xd in ((x, x.float()) if bf16 else (x,)):
                    if name == "int8_gemm":
                        xc, xs = mg.quantize_activations_rowwise(
                            xd, QUANT_GROUP)
                        out = mg.int8_gemm_quantized(xc, xs, qw, xd.dtype)
                        ref = mg.int8_gemm_quantized_plain(xc, xs, qw,
                                                           xd.dtype)
                    else:
                        before = mg.DECODE_LAUNCHES[name]
                        out, ref = mg.mixed_gemm(xd, qw), \
                            mg.mixed_gemm_plain(xd, qw)
                        if mg.DECODE_LAUNCHES[name] - before != int(M <= 16):
                            fail(f"{name} {shape_name} M={M}: "
                                 f"mixed_gemm_decode_kernel launched "
                                 f"{mg.DECODE_LAUNCHES[name] - before} "
                                 "times")
                    torch.cuda.synchronize()
                    what = f"{name} {shape_name} M={M}"
                    if xd.dtype == torch.bfloat16:
                        errs["half"] = compare(out, ref, TOL_BF16,
                                               f"{what} (bf16)")
                    elif xd.dtype == torch.float16 and name == "int8_gemm":
                        if not torch.equal(out, ref):
                            fail(f"{what} (f16): not bit for bit the plain "
                                 "version")
                        errs["half"] = 0.0
                    elif xd.dtype == torch.float16:
                        errs["half"] = compare_f16(out, ref, f"{what} (f16)",
                                                   rel=GEMM_F32_REL)
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
                    cuda_kernel = ("mixed_gemm_decode_kernel" if M <= 16
                                   else "mixed_gemm_wgmma_kernel")

                    def kernel():
                        return mg.mixed_gemm(x, qw)

                    def plain():
                        return mg.mixed_gemm_plain(x, qw)

                    in_bytes = M * K * 2
                    peak = BF16_FLOPS_PER_S
                b_ms, b_by = bound(code_bytes + in_bytes + M * N * 2,
                                   2 * M * K * N, peak)
                if not bf16:
                    cuda_kernel += "<__half>"
                    if cuda_kernel.startswith("mixed_gemm_wgmma"):
                        cuda_kernel = "round_x_bf16_kernel + " + cuda_kernel
                rows.append({
                    "name": name, "shape": shape_name, "K": K, "N": N,
                    "M": M, **({"kernel": cuda_kernel} if cuda_kernel else {}),
                    **({"splits": mg.mixed_gemm_splits(
                        M, N, K // QUANT_GROUP, sms)}
                       if name != "int8_gemm" and M > 16 else {}),
                    **({} if bf16 else {"dtype": "float16"}),
                    "max_abs_err": errs["half"],
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


def int8_gemm_path(torch, mg, params, dtype=None) -> dict:
    """``int8_gemm`` as a caller uses it: the seven projections of layer 0
    of a bits=8 quantized llama3-8b, each at M = 8 and 256, bf16 x (or
    ``dtype``).  The output must be finite and int8-grade against x @
    dequant(W): mean relative error below 5% (the reference's own
    check)."""
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
                                device="cuda", dtype=dtype or torch.bfloat16)
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
                       decode=dict(mg.DECODE_LAUNCHES),
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
            # every decode body has 8 rows: its projections run the decode
            # kernel, one per decode-attention launch
            decode = run["launches"]["paged_decode_attention"]
            if run["decode"][kernel] != PROJECTIONS * decode or decode == 0:
                fail(f"{tag}: mixed_gemm_decode_kernel launched "
                     f"{run['decode'][kernel]} times for {decode} decode "
                     f"launches, want {PROJECTIONS} per decode launch")
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
                            f"{kernel}_decode": runs[0]["decode"][kernel],
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
                # decode bodies add their split-K sums inside the decode
                # kernel: no second pass
                dec = res["profile"]["decode"]["port_kernels_ms"]
                if "mixed_gemm_decode_kernel" not in dec or \
                        "splitk_reduce_kernel" in dec:
                    fail(f"{tag}: the decode trace's kernels {sorted(dec)}: "
                         "want mixed_gemm_decode_kernel and no "
                         "splitk_reduce_kernel")
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


def check_grouped_matmul(torch, gm, flush, dtype=None) -> list:
    """B8 against its plain version at Mixtral's two expert shapes, for T =
    16 and 512 assignments: forward and
    on transposed weights (dlhs), bf16 per element within TOL_BF16, f32
    within GMM_F32_REL of the largest output; with ``dtype`` f16, f16 alone
    within the f16 limit with GMM_F32_REL of the largest output (exact f16
    products, f32 sums in another order); the all-padding tail must be
    zeros.  Kernel / plain / library / bound ms of the 2-byte forward.
    Bound: the touched experts' weights, the real lhs rows and the real
    output rows once, against 2 T K N flops."""
    dtype = dtype or torch.bfloat16
    bf16 = dtype == torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    rows = []
    for shape_name, (K, N) in MOE_SHAPES.items():
        for T in MOE_T:
            lhs, rhs, tg, sizes, used, tile_m, pos, touched = grouped_inputs(
                torch, gm, K, N, T, gen, dtype)
            # dlhs's g: random rows where the forward's output is real
            g = torch.zeros((lhs.shape[0], N), device="cuda", dtype=dtype)
            g[pos.long()] = torch.randn((T, N), generator=gen, device="cuda",
                                        dtype=dtype)
            tail = int(used.item()) * tile_m
            errs = {("fwd", True): None, ("dlhs", True): None}
            for f32 in ((False, True) if bf16 else (False,)):
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
                    what = f"{tag} {part} ({'f32' if f32 else a.dtype})"
                    if out[tail:].abs().max().item() != 0.0:
                        fail(f"{what}: the all-padding tiles are not zero")
                    errs[(part, f32)] = (
                        compare_grad(out, ref, True, what, rel=GMM_F32_REL)
                        if f32 else compare(out, ref, TOL_BF16, what) if bf16
                        else compare_f16(out, ref, what, rel=GMM_F32_REL))
                del a, w, gg, outs
            lib_name, library = library_grouped_mm(torch, lhs, rhs, sizes)
            nbytes = touched * K * N * 2 + T * K * 2 + T * N * 2
            b_ms, b_by = bound(nbytes, 2 * T * K * N)
            rows.append({
                "name": "grouped_matmul", "shape": shape_name, "K": K,
                "N": N, "T": T, "tile_m": tile_m, "M_pad": lhs.shape[0],
                "kernel": ("grouped_matmul_wgmma_kernel" if gm.uses_wgmma(
                    lhs.dtype, tile_m, False)
                    else "grouped_matmul_bf16_kernel")
                + ("" if bf16 else "<__half>"),
                **({} if bf16 else {"dtype": "float16"}),
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


def check_fused_adam(torch, fo, flush, dtype=None) -> dict:
    """B9 against its plain version on ADAM_N f32 parameters (``dtype``:
    f16 parameters and gradients), two steps with weight decay, each side
    from its own outputs: p, m and v within ADAM_REL of each tensor's
    largest element (f16 p within the f16 limit: an f32 p' an ulp apart
    may round to the other f16 neighbour).  Kernel / plain / library
    (``torch.optim.AdamW(fused=True)`` on the same flat tensor: decay
    folded as p (1 - lr wd) and eps outside sqrt(v)/sqrt(bc2), the same
    update algebraically, not bit for bit; its moments in p's dtype) /
    bound ms of one step: 28 bytes per element with f32 p and g, 22 with
    f16 (read p, g, m, v; write p, m, v) at 3.35 TB/s."""
    dtype = dtype or torch.float32
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    n = ADAM_N
    p = torch.randn(n, generator=gen, device="cuda").to(dtype)
    m = torch.zeros(n, device="cuda")
    v = torch.zeros(n, device="cuda")
    k_state = p_state = (p, m, v)
    for step in (1, 2):
        g = torch.randn(n, generator=gen, device="cuda").to(dtype)
        st = torch.tensor(step, dtype=torch.int32, device="cuda")
        k_state = fo.fused_adamw_flat(*k_state[:1], g, *k_state[1:], st,
                                      **ADAM_HYPER)
        p_state = fo.adamw_plain(*p_state[:1], g, *p_state[1:], st,
                                 **ADAM_HYPER)
    torch.cuda.synchronize()
    errs = [compare_f16(a, b, f"fused_adamw {name} (f16)", rel=ADAM_REL)
            if a.dtype == torch.float16 else
            compare_grad(a, b, True, f"fused_adamw {name}", rel=ADAM_REL)
            for name, a, b in zip("pmv", k_state, p_state)]
    del p_state
    pk, mk, vk = k_state
    st = torch.tensor(3, dtype=torch.int32, device="cuda")
    f32 = dtype == torch.float32
    out = {"name": "fused_adamw", "n": n, "max_abs_err": max(errs),
           "max_abs_err_f32": max(errs) if f32 else None,
           **({} if f32 else {"dtype": "float16",
                              "kernel": "fused_adamw_kernel<__half, __half>"}),
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
    per = 28 if f32 else 22
    out["bound_ms"], out["bound_by"] = bound(per * n, 18 * n, F32_FLOPS_PER_S)
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


# ---------------------------------------------------------------------------
# the serving memory hierarchy: prefix cache, host paging, cold store
# ---------------------------------------------------------------------------

# traffic of the hierarchy phase, in tokens (block size BS = 64): P, the
# shared prefix, is 15 full blocks and 40 tokens of its 16th
HIER_PREFIX = 1000
HIER_FIRST = 24  # the cold request's own suffix after P
HIER_HIT_SUFFIX = (17, 100, 500)  # three hits: all of P, then these
HIER_DIVERGE_AT = (5, 18, 29, 39)  # four hits leave P inside its 16th block
HIER_DIVERGE_TAIL = 30  # ... followed by tokens of their own
HIER_PRESSURE_LEN = 1200  # unrelated prompts that push P's chain down
HIER_RETURN = 48  # the returning session's new suffix after P
HIER_NEW = 32  # new tokens of every request, greedy
# pool and host pool in KV blocks (a llama3-8b block is 8 MiB): small
# enough that three pressure requests demote P's whole chain, the host pool
# overflows into the cold store, and the returning session promotes P's
# chain from both (4 demotions follow P's root: 8 blocks come back from the
# host pool, 7 from the cold store).  The block arithmetic depends on the
# token counts only, so the small f32 model crosses the tiers alike
HIER_NB = 88
HIER_HOST_BLOCKS = 12
HIER_PRESSURE = 3  # unrelated requests of stage 3
HIER_DRAIN = 2  # unrelated requests served after the return, before the drain
# the hierarchy's first-token logits at full width (bf16) against a
# cache-off engine on the same prompts: max |diff| <= this * max |logit|
# of the cache-off engine, per request (PERF.md section 2)
TOL_HIER_LOGITS_REL = 5e-2


def hier_traffic(vocab: int) -> dict:
    """The five stages' prompts from a seed.  Every suffix starts with a
    token the cache does not hold at that position, so the cached prefix of
    each request is known exactly."""
    import numpy as np

    rng = np.random.default_rng(SEED + 10)

    def tokens(n, avoid=()):
        out = rng.integers(0, vocab, size=n).tolist()
        while out and out[0] in avoid:
            out[0] = int(rng.integers(0, vocab))
        return out

    p = tokens(HIER_PREFIX)
    first = tokens(HIER_FIRST)
    hits = [p + tokens(n, avoid=(first[0],)) for n in HIER_HIT_SUFFIX]
    nfull = HIER_PREFIX // BS * BS  # 960
    hits += [p[:nfull + d] + tokens(HIER_DIVERGE_TAIL, avoid=(p[nfull + d],))
             for d in HIER_DIVERGE_AT]
    heads = {h[HIER_PREFIX] for h in hits[:3]} | {first[0]}
    return {"p": p, "cold": [p + first], "hits": hits,
            "hit_cached": [HIER_PREFIX] * 3
            + [nfull + d for d in HIER_DIVERGE_AT],
            "pressure": [tokens(HIER_PRESSURE_LEN)
                         for _ in range(HIER_PRESSURE)],
            "ret": [p + tokens(HIER_RETURN, avoid=heads)],
            "drain": [tokens(HIER_PRESSURE_LEN) for _ in range(HIER_DRAIN)]}


def hier_v2(cfg, dtype: str, cache: bool, cold_dir: str = "", nb=None):
    """The phase's V2Config: the engine phase's geometry on a pool of
    ``nb`` blocks, with the whole hierarchy on when ``cache``.  The host
    pool holds HIER_HOST_BLOCKS payloads of this model (a payload is the
    block plus a header of at most ~12 KB of chain tokens) and not one
    more."""
    from deepspeed_tpu_torch.inference.v2.engine import V2Config

    item = 4 if dtype == "float32" else 2
    block = 2 * cfg.num_layers * BS * cfg.kv_heads * cfg.head_dim * item
    host = HIER_HOST_BLOCKS * block + block // 2
    return V2Config(max_tokens_per_step=256, max_seqs=8, block_size=BS,
                    num_blocks=nb or HIER_NB, max_blocks_per_seq=MB,
                    dtype=dtype,
                    enable_prefix_cache=cache,
                    kv_host_pool_bytes=host if cache else 0,
                    kv_coldstore_dir=cold_dir if cache else "")


class HierProbe:
    """Wraps an engine's ``builder.build`` and ``step``: per request the
    chunks its batches scheduled (start, tokens), the host time and f32
    logits row of its first token, and the ``step()`` calls.  With
    ``sync_check`` the first all-decode state runs one decode body under
    the host-sync check."""

    def __init__(self, torch, eng, keep_logits: bool, sync_check: bool):
        self.picks, self.first, self.calls = {}, {}, 0
        self.rows, self.syncs = [], None
        build, step = eng.builder.build, eng.step

        def build_(picks):
            for seq, n in picks:
                self.picks.setdefault(seq.uid, []).append(
                    (seq.seen_tokens, n))
            batch = build(picks)
            self.rows = batch.uids
            return batch

        def step_(*args, **kw):
            self.calls += 1
            out = step(*args, **kw)
            now = time.perf_counter()
            for uid in out:
                if uid not in self.first:  # first tokens: mixed steps only
                    row = self.rows.index(uid)
                    self.first[uid] = (now, eng.last_logits[row].cpu()
                                       if keep_logits else None)
            if (sync_check and self.syncs is None and eng.running
                    and not eng.waiting and eng._prefilling == 0):
                self.syncs = decode_body_syncs(torch, eng)
            return out

        eng.builder.build, eng.step = build_, step_


def hier_serve(eng, probe, prompts, what: str) -> list:
    """Queue ``prompts`` together, drive them to completion (burst-8
    greedy decode), and return per request its new tokens, the tokens its
    batches prefilled, where its first chunk started (the cached prefix),
    its TTFT and first-token logits.  Fails unless the batches prefilled
    exactly the uncached tokens, in contiguous chunks."""
    t0 = time.perf_counter()
    uids = [eng.put(p, max_new_tokens=HIER_NEW) for p in prompts]
    res = eng.generate_all(burst=8)
    out = []
    for uid, p in zip(uids, prompts):
        chunks = [(s, n) for s, n in probe.picks[uid] if s < len(p)]
        starts = [s for s, _ in chunks]
        ends = [s + n for s, n in chunks]
        if (res[uid][:len(p)] != p or len(res[uid]) != len(p) + HIER_NEW
                or starts[1:] != ends[:-1] or ends[-1] != len(p)):
            fail(f"hierarchy {what}: request {uid} scheduled {chunks} for "
                 f"a {len(p)}-token prompt, or lost tokens")
        t, logits = probe.first[uid]
        out.append({"tokens": res[uid][len(p):], "cached": starts[0],
                    "prefilled": sum(n for _, n in chunks),
                    "ttft_s": t - t0, "logits": logits})
    return out


def hier_chain(eng, p) -> list:
    """The radix nodes of P's full blocks, root first."""
    node, out = eng.prefix_cache._root, []
    for i in range(HIER_PREFIX // BS):
        node = node.children.get(tuple(p[i * BS:(i + 1) * BS]))
        if node is None:
            break
        out.append(node)
    return out


def hier_idle_checks(eng, what: str) -> None:
    """The tier identity and the allocator's check, and no block leaked:
    with no request live, free + evictable accounts for the whole pool and
    the demoted count agrees three ways (allocator, pager, tree)."""
    try:
        eng.prefix_cache.check_consistency()
    except AssertionError as e:
        fail(f"hierarchy {what}: {e}")
    if (eng.pinned_blocks != 0 or eng.free_blocks + eng.evictable_blocks
            != eng.total_blocks):
        fail(f"hierarchy {what}: {eng.free_blocks} free + "
             f"{eng.evictable_blocks} evictable + {eng.pinned_blocks} "
             f"pinned != {eng.total_blocks} blocks")


def hier_same_bytes(eng, chain, ref, what: str) -> None:
    """P's chain on the device holds, bit for bit, the bytes it held
    before its first demotion."""
    import torch

    if len(chain) != len(ref) or any(n.tier != "device" for n in chain):
        fail(f"hierarchy {what}: P's chain is not back on the device")
    for i, node in enumerate(chain):
        got = eng._read_kv_block(node.block)
        for name in ("k", "v"):
            if not torch.equal(got[name].view(torch.uint8),
                               ref[i][name].view(torch.uint8)):
                fail(f"hierarchy {what}: block {i} of P's chain differs "
                     "bitwise from its bytes before demotion")


def run_hierarchy(torch, cfg, params, device: str, dtype: str, pa=None,
                  keep_logits: bool = False) -> dict:
    """The five stages on one model: cold, hits, pressure, return, and a
    restart on the same cold store.  Returns every request's results, the
    counters, the spans' times, and the checks' outcomes; fails on any
    broken check.  ``pa``: count the paged kernels' launches (card)."""
    import shutil
    import tempfile

    from deepspeed_tpu_torch.inference.v2.engine import InferenceEngineV2
    from deepspeed_tpu_torch.observability import recorder, tracer

    tr = hier_traffic(cfg.vocab_size)
    # the cold store lives in the checkout's git-ignored build/ directory
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="hier_coldstore_", dir=build)
    out = {"stages": {}, "tiers": {}}
    writes = [0, 0.0]  # cold-store bytes written, seconds

    def engine():
        eng = InferenceEngineV2(cfg, params, hier_v2(cfg, dtype, True, root),
                                device=device)
        cs = eng.pager.coldstore
        write = cs.write

        def timed_write(key, payload, meta=None):
            t = time.perf_counter()
            path = write(key, payload, meta)
            writes[0] += len(payload)
            writes[1] += time.perf_counter() - t
            return path

        cs.write = timed_write
        return eng

    def promotes_since(n):
        return [sp for sp in tracer.spans(name="paging/promote")[n:]
                if sp.attrs.get("ok")]

    try:
        tracer.clear()
        recorder.clear()
        if pa is not None:
            pa.reset_counts()
        eng = engine()
        probe = HierProbe(torch, eng, keep_logits, device == "cuda")
        st = out["stages"]
        st["cold"] = hier_serve(eng, probe, tr["cold"], "cold")
        hier_idle_checks(eng, "after the cold request")
        chain = hier_chain(eng, tr["p"])
        ref = [eng._read_kv_block(n.block) for n in chain]
        if len(chain) != HIER_PREFIX // BS:
            fail("hierarchy: the cold request did not cache P's blocks")
        st["hits"] = hier_serve(eng, probe, tr["hits"], "hits")
        hier_idle_checks(eng, "after the hits")
        got = [r["cached"] for r in st["hits"]]
        if got != tr["hit_cached"]:
            fail(f"hierarchy hits: cached prefixes {got}, want "
                 f"{tr['hit_cached']}")
        st["pressure"] = hier_serve(eng, probe, tr["pressure"], "pressure")
        hier_idle_checks(eng, "after the pressure")
        if any(n.tier == "device" for n in chain):
            fail("hierarchy pressure: P's chain was not demoted")
        # where each block of P's chain lies now (a node keeps the tier it
        # was demoted to; the pager knows which host entries spilled since)
        source = {n.handle: "cold" if n.handle in eng.pager._spill
                  else "host" for n in chain}
        from_tier = [source[n.handle] for n in chain]
        out["tiers"]["return"] = from_tier
        n_promote = len(tracer.spans(name="paging/promote"))
        st["ret"] = hier_serve(eng, probe, tr["ret"], "return")
        hier_idle_checks(eng, "after the return")
        promote_ms = {"host": [], "cold": []}
        for sp in promotes_since(n_promote):
            if sp.attrs["handle"] in source:
                promote_ms[source[sp.attrs["handle"]]].append(
                    sp.duration_s * 1e3)
        chain = hier_chain(eng, tr["p"])
        if "host" not in from_tier or "cold" not in from_tier:
            fail(f"hierarchy return: P's chain came back from {from_tier}, "
                 "want both the host pool and the cold store")
        hier_same_bytes(eng, chain, ref, "return")
        if device == "cuda" and probe.syncs != "":
            fail("hierarchy: a decode body with the cache on waited on the "
                 f"device (or never ran): {probe.syncs}")
        # the restart's predecessor: two more sessions, then the drain a
        # stopping worker does (every cached block demoted); the host tier
        # dies with the process
        st["drain"] = hier_serve(eng, probe, tr["drain"], "drain")
        eng.prefix_cache.evict(eng.total_blocks)
        hier_idle_checks(eng, "after the drain")
        spilled = set(eng.pager._spill)
        if any(n.handle not in spilled for n in chain):
            fail("hierarchy drain: P's chain is not in the cold store")
        out["stats"] = eng.prefix_stats()
        write_s = writes[1]
        calls = probe.calls
        eng.close()
        del eng, probe
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

        eng = engine()
        probe = HierProbe(torch, eng, keep_logits, False)
        t = time.perf_counter()
        out["rehydrate"] = eng.rehydrate_coldstore()
        out["rehydrate_s"] = time.perf_counter() - t
        n_promote = len(tracer.spans(name="paging/promote"))
        st["restart"] = hier_serve(eng, probe, tr["ret"], "restart")
        hier_idle_checks(eng, "after the restart")
        chain = hier_chain(eng, tr["p"])
        promoted = promotes_since(n_promote)
        tier_of = {sp.attrs["block"]: sp.attrs["tier"] for sp in promoted}
        out["tiers"]["restart"] = [tier_of.get(n.block) for n in chain]
        rehydrated_ms = [sp.duration_s * 1e3 for sp in promoted]
        if out["tiers"]["restart"] != ["cold"] * len(chain):
            fail("hierarchy restart: P's chain did not come back from the "
                 f"rehydrated cold store: {out['tiers']['restart']}")
        hier_same_bytes(eng, chain, ref, "restart")
        out["stats_restart"] = eng.prefix_stats()
        calls += probe.calls
        eng.close()
        del eng, probe
    finally:
        shutil.rmtree(root, ignore_errors=True)

    s, s2 = out["stats"], out["stats_restart"]
    demotes = tracer.spans(name="paging/demote")
    need = {"hits": s["hits"], "prefill_tokens_skipped":
            s["prefill_tokens_skipped"], "cow_copies": s["cow_copies"],
            "demotes_to_host": sum(1 for d in demotes
                                   if d.attrs.get("tier") == "host"),
            "coldstore_writes": s["coldstore_writes"],
            "promotions": s["promotions"],
            "rehydrated_blocks": s2["rehydrated_blocks"],
            "restart_promotions": s2["promotions"]}
    if not all(v > 0 for v in need.values()):
        fail(f"hierarchy: a counter stayed at 0: {need}")
    out["counters"] = need
    # one engine/step span per step() call, the reference's kinds, and as
    # many flight-recorder steps as spans (the recorder keeps 512)
    steps = tracer.spans(name="engine/step")
    kinds = {sp.attrs["kind"] for sp in steps}
    n_rec = len(recorder.snapshot()["steps"])
    if (len(steps) != calls or not kinds <= {"mixed", "decode"}
            or "mixed" not in kinds or n_rec != min(calls, 512)):
        fail(f"hierarchy: {len(steps)} engine/step spans ({kinds}) and "
             f"{n_rec} recorder steps for {calls} step() calls")
    for name in ("paging/demote", "paging/promote", "coldstore/rehydrate_kv"):
        if not tracer.spans(name=name):
            fail(f"hierarchy: no {name} span")
    out["spans"] = {"engine_step": len(steps), "recorder_steps": n_rec,
                    "kinds": sorted(kinds)}

    def median(d):
        return statistics.median(d) if d else None

    out["times"] = {
        "ttft_s": {k: [r["ttft_s"] for r in st[k]]
                   for k in ("cold", "hits", "ret", "restart")},
        # a demote (its put may spill the host pool's oldest entry to the
        # cold store); a promote of P's chain from each tier, and after
        # the restart
        "demote_ms": median([d.duration_s * 1e3 for d in demotes
                             if d.attrs.get("ok")]),
        "demote_ms_max": max(d.duration_s * 1e3 for d in demotes),
        # every cold-store write of the first engine happens inside a
        # demote (its put spills the host pool's oldest entry): the rest of
        # a demote, on average, is the D2H copy and the host-pool put
        "demote_ms_without_cold_writes": (
            sum(d.duration_s for d in demotes) - write_s) * 1e3
        / len(demotes),
        "promote_ms": {"host": median(promote_ms["host"]),
                       "cold": median(promote_ms["cold"]),
                       "rehydrated": median(rehydrated_ms)},
        "coldstore_write_mb_per_s": writes[0] / 2**20 / max(writes[1], 1e-9),
        "coldstore_write_mb": writes[0] / 2**20,
        "rehydrate_s": out["rehydrate_s"]}
    if pa is not None:
        out["launches"] = dict(pa.LAUNCHES)
        out["plain_calls"] = dict(pa.PLAIN_CALLS)
    return out


HIER_DECODE_STEPS = 48  # timed decode steps per turn, tracing off or on
HIER_TRACE_TURNS = (False, True, True, False, False, True, True, False)


def sync(torch, device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def tracer_cost_us(n: int = 200_000) -> dict:
    """Host cost of one ``begin``/``end`` pair of a private tracer, on and
    off (the engine makes one pair per ``step()``)."""
    from deepspeed_tpu_torch.observability.trace import Tracer

    out = {}
    for enabled in (True, False):
        tr = Tracer(enabled=enabled)
        t = time.perf_counter()
        for _ in range(n):
            tr.end(tr.begin("engine/step", kind="decode"), emitted=8)
        out["on" if enabled else "off"] = (time.perf_counter() - t) / n * 1e6
    return out


def traced_decode_rates(torch, eng, vocab: int, device: str) -> dict:
    """Warm decode through ``step()`` (a span and a recorder step each) at
    8 rows, with the tracer off and on in turns (HIER_TRACE_TURNS):
    tokens/s of HIER_DECODE_STEPS steps per turn.  A traced turn records
    one ``engine/step`` span of kind "decode" per step, an untraced one
    none."""
    import numpy as np

    from deepspeed_tpu_torch.observability import tracer

    rng = np.random.default_rng(SEED + 11)
    rates = {"off": [], "on": []}
    was = tracer.enabled
    try:
        for enabled in HIER_TRACE_TURNS:
            for _ in range(8):
                eng.put(rng.integers(0, vocab, size=64).tolist(),
                        max_new_tokens=HIER_DECODE_STEPS + 1)
            while eng.waiting or eng._prefilling:
                eng.step()
            tracer.enabled = enabled
            tracer.clear()
            sync(torch, device)
            t = time.perf_counter()
            n = sum(len(v) for _ in range(HIER_DECODE_STEPS)
                    for v in eng.step().values())
            sync(torch, device)
            rates["on" if enabled else "off"].append(
                n / (time.perf_counter() - t))
            tracer.enabled = was
            kinds = [sp.attrs["kind"] for sp in
                     tracer.spans(name="engine/step")]
            if kinds != ["decode"] * (HIER_DECODE_STEPS if enabled else 0):
                fail(f"traced decode: {len(kinds)} engine/step spans "
                     f"{set(kinds)} over {HIER_DECODE_STEPS} decode steps "
                     f"with the tracer {'on' if enabled else 'off'}")
            eng.generate_all()
    finally:
        tracer.enabled = was
    return rates


def run_hierarchy_phase(torch, pa, params, card: str, cfg=None,
                        device: str = "cuda", dtype: str = "bfloat16"
                        ) -> dict:
    """llama3-8b at full width and depth, bf16, the engine phase's weights
    (``cfg``/``device``/``dtype``: another model, as the GPU test's small
    one): the five stages (``run_hierarchy``), then the same hits, return
    and restart prompts on a cache-off engine: each request's first-token
    logits within TOL_HIER_LOGITS_REL of the cache-off engine's, and the
    count of identical greedy continuations; the tracer's host cost and
    warm decode tokens/s with tracing off and on."""
    from deepspeed_tpu_torch.inference.v2.engine import InferenceEngineV2
    from deepspeed_tpu_torch.models import transformer as tfm

    model = "llama3-8b" if cfg is None else "small"
    cfg = cfg or tfm.get_config("llama3-8b")
    t0 = time.perf_counter()
    run = run_hierarchy(torch, cfg, params, device, dtype,
                        pa=pa if device == "cuda" else None,
                        keep_logits=True)
    wall = time.perf_counter() - t0
    if device == "cuda" and (not all(run["launches"].values())
                             or any(run["plain_calls"].values())):
        fail(f"hierarchy: the paged kernels did not carry the phase: "
             f"{run['launches']} {run['plain_calls']}")
    tr = hier_traffic(cfg.vocab_size)
    off = InferenceEngineV2(cfg, params, hier_v2(cfg, dtype, False, nb=NB),
                            device=device)
    probe = HierProbe(torch, off, True, False)
    ref = {"hits": hier_serve(off, probe, tr["hits"], "cache-off hits"),
           "ret": hier_serve(off, probe, tr["ret"], "cache-off return")}
    st = run["stages"]
    pairs = ([("hit", a, b) for a, b in zip(st["hits"], ref["hits"])]
             + [("promoted", st["ret"][0], ref["ret"][0]),
                ("rehydrated", st["restart"][0], ref["ret"][0])])
    rel, same = [], 0
    for what, a, b in pairs:
        diff = (a["logits"] - b["logits"]).abs().max().item()
        scale = b["logits"].abs().max().item()
        rel.append(diff / scale)
        if not math.isfinite(diff) or diff > TOL_HIER_LOGITS_REL * scale:
            fail(f"hierarchy: a {what} request's first-token logits differ "
                 f"from the cache-off engine's by {diff} (max |logit| "
                 f"{scale}, limit {TOL_HIER_LOGITS_REL} of it)")
        same += a["tokens"] == b["tokens"]
    decode = traced_decode_rates(torch, off, cfg.vocab_size, device)
    del off, probe
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    for r in run["stages"].values():
        for q in r:
            q.pop("logits")
    return {"card": card, "model": model, "dtype": dtype,
            "num_blocks": HIER_NB, "host_blocks": HIER_HOST_BLOCKS,
            "wall_s": wall, "counters": run["counters"],
            "stats": run["stats"], "stats_restart": run["stats_restart"],
            "rehydrate": run["rehydrate"], "tiers": run["tiers"],
            "spans": run["spans"], "times": run["times"],
            "cached_tokens": {k: [q["cached"] for q in v]
                              for k, v in st.items()},
            "prefilled_tokens": {k: [q["prefilled"] for q in v]
                                 for k, v in st.items()},
            "launches": run.get("launches"),
            "decode_body_host_syncs": 0,
            "logits_max_abs_diff_rel": max(rel), "logits_rel": rel,
            "identical_continuations": f"{same} of {len(pairs)}",
            "tracer_us_per_pair": tracer_cost_us(),
            "decode_tokens_per_s_trace": decode}


def hierarchy_line(hier: dict) -> str:
    """The hierarchy phase's times, on one line beside the card."""
    t, tr = hier["times"], hier["decode_tokens_per_s_trace"]

    def f(xs):
        return ", ".join(f"{x:.4f}" for x in xs)

    return (
        f"hierarchy ({hier['card']}): TTFT s cold {f(t['ttft_s']['cold'])}, "
        f"hits {f(t['ttft_s']['hits'])}, promoted {f(t['ttft_s']['ret'])}, "
        f"rehydrated {f(t['ttft_s']['restart'])}; ms per KV block: demote "
        f"{t['demote_ms']:.3f} (median; mean without its cold-store writes "
        f"{t['demote_ms_without_cold_writes']:.3f}), promote from host "
        f"{t['promote_ms']['host']:.3f}, from the cold store "
        f"{t['promote_ms']['cold']:.3f}, rehydrated "
        f"{t['promote_ms']['rehydrated']:.3f}; cold-store writes "
        f"{t['coldstore_write_mb_per_s']:.1f} MB/s over "
        f"{t['coldstore_write_mb']:.1f} MB; rehydrate {t['rehydrate_s']:.4f}"
        f" s; tracer {hier['tracer_us_per_pair']['on']:.3f} us per "
        f"begin/end pair (off {hier['tracer_us_per_pair']['off']:.3f}); "
        f"decode tokens/s at 8 rows, tracing off (DSTPU_TRACE=0) "
        f"{f(tr['off'])}, on {f(tr['on'])}; first-token logits max |diff| "
        f"{hier['logits_max_abs_diff_rel']:.3e} of max |logit| (limit "
        f"{TOL_HIER_LOGITS_REL}); identical greedy continuations "
        f"{hier['identical_continuations']}")


def small_hierarchy_agreement(torch, pa) -> dict:
    """The five stages on the small f32 model: on the card (kernels), on
    the CPU (plain versions), and the same prompts in the same groups on a
    cache-off engine on the card.  Every greedy token must be identical."""
    from deepspeed_tpu_torch.inference.v2.engine import InferenceEngineV2
    from deepspeed_tpu_torch.models import transformer as tfm

    cfg = tfm.get_config("tiny", hidden_size=256, intermediate_size=512,
                         num_heads=4, num_kv_heads=2, dtype="float32")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(SEED),
                             device="cpu")
    tokens = {}
    for dev in ("cuda", "cpu"):
        run = run_hierarchy(torch, cfg, params, dev, "float32",
                            pa=pa if dev == "cuda" else None)
        if dev == "cuda" and (not all(run["launches"].values())
                              or any(run["plain_calls"].values())):
            fail(f"small model hierarchy: the card run did not go through "
                 f"the kernels: {run['launches']} {run['plain_calls']}")
        tokens[dev] = {k: [q["tokens"] for q in v]
                       for k, v in run["stages"].items()}
    tr = hier_traffic(cfg.vocab_size)
    off = InferenceEngineV2(cfg, params, hier_v2(cfg, "float32", False,
                                                 nb=NB), device="cuda")
    probe = HierProbe(torch, off, False, False)
    tokens["cache_off"] = {
        stage: [q["tokens"] for q in hier_serve(off, probe, tr[key], stage)]
        for stage, key in (("cold", "cold"), ("hits", "hits"),
                           ("pressure", "pressure"), ("ret", "ret"),
                           ("drain", "drain"), ("restart", "ret"))}
    for other in ("cpu", "cache_off"):
        if tokens["cuda"] != tokens[other]:
            bad = [k for k in tokens["cuda"]
                   if tokens["cuda"][k] != tokens[other][k]]
            fail(f"small model hierarchy: greedy tokens on the card differ "
                 f"from the {other} run's in stages {bad}")
    return {"requests": sum(len(v) for v in tokens["cuda"].values()),
            "tokens_identical": ["cpu", "cache_off"]}


# ---------------------------------------------------------------------------
# speculative decoding and multi-tenant adapters
# ---------------------------------------------------------------------------

SPEC_K = 4  # tokens proposed per speculative step
# the draft model: meta-llama/Llama-3.2-1B's shape (its config.json: hidden
# 2048, intermediate 8192, 16 layers, 32 heads, 8 KV heads so head dim 64,
# vocab 128256, tied embeddings, rope_theta 500000); its rope_scaling is not
# modelled, which random weights make immaterial
DRAFT_SHAPE = dict(hidden_size=2048, intermediate_size=8192, num_layers=16,
                   tie_embeddings=True)
DRAFT_D = 64
ADAPTER_SLOTS, ADAPTER_RANK, ADAPTER_PACKS = 8, 16, 4
# the registry's host tier: four rank-16 packs of llama3-8b's attention
# projections take ~218 MB of f32 factors, near the 256 MB default
ADAPTER_HOST_BYTES = 1 << 30
# decode tokens/s of warm engines varies by up to 61% between processes:
# the rates come from this many processes, each its own warm-up
SPEC_RATE_PROCS = 3
# bf16 speculative / adapter engines against the plain engine on the same
# batch (adapter rows against an engine serving the merged weights): the
# first tokens' logits, and the next-token logits of the first steady step
# (a decode body's, or a verify's position 0, over the same KV), are held
# to the hierarchy phase's limit.  ROADMAP.md C4: a verify runs B4 over
# k+1 positions where plain decode runs B5, in other GEMM shapes, so bf16
# rounds otherwise there (0.078 of max |logit| 4.28 between the two paths)
# and later continuations are counted, not gated
TOL_SPEC_LOGITS_REL = 5e-2


def spec_v2(**over):
    """The bf16 serving cell's V2Config, with ``over``."""
    from deepspeed_tpu_torch.inference.v2.engine import V2Config

    return V2Config(max_tokens_per_step=256, max_seqs=8, block_size=BS,
                    num_blocks=NB, max_blocks_per_seq=MB, dtype="bfloat16",
                    **over)


def draft_model(torch, tfm, cfg=None, shape=None):
    """(config, weights from the seed) of the draft: ``cfg`` (default
    llama3-8b) cut to ``shape`` (default the Llama-3.2-1B shape)."""
    dcfg = dataclasses.replace(cfg or tfm.get_config("llama3-8b"),
                               **(shape or DRAFT_SHAPE))
    return dcfg, tfm.init_params(
        dcfg, torch.Generator(device="cuda").manual_seed(SEED + 2),
        device="cuda")


def adapter_packs(model_cfg, n: int, rank: int) -> list:
    """``n`` seeded adapter packs over the four attention projections: a
    ~ N(0, 1/K), b ~ 0.1 N(0, 1) (scaling folded in; a delta of ~0.4 on
    projection outputs of ~1, so a served adapter moves the logits well
    past TOL_SPEC_LOGITS_REL), f32 numpy."""
    import numpy as np

    from deepspeed_tpu_torch.inference.v2.engine import adapter_target_shapes

    packs = []
    for i in range(n):
        rng = np.random.default_rng(1000 + i)
        L = model_cfg.num_layers
        packs.append({t: (
            rng.standard_normal((L, K, rank), np.float32)
            / np.float32(np.sqrt(K)),
            np.float32(0.1) * rng.standard_normal((L, rank, N), np.float32))
            for t, (K, N) in adapter_target_shapes(model_cfg).items()})
    return packs


class SteadyProbe:
    """Wraps ``eng``'s decode body and the speculative verify
    (``inference/v2/spec.verify_body``) until :meth:`close`: ``logits``
    maps each request uid active at the first steady step to its
    next-token logits there (a decode body's row, or a verify's position
    0: the same function of the same KV), kept on the device, and
    ``after`` to the number of tokens it had emitted before that step."""

    def __init__(self, eng):
        import numpy as np

        from deepspeed_tpu_torch.inference.v2 import spec as spec_mod

        self.logits, self.after, self.eng, self.spec = {}, {}, eng, spec_mod
        self.seen = False
        decode, self.verify = eng._decode, spec_mod.verify_body

        def keep(rows):
            if not self.seen:
                self.seen = True
                t = eng.table
                for r in np.nonzero(t.active)[0]:
                    uid = t.seq_at[int(r)].uid
                    self.logits[uid] = rows[int(r)].clone()
                    self.after[uid] = int(t.gen[r])

        def decode_(*a, **kw):
            logits = decode(*a, **kw)
            keep(logits)
            return logits

        def verify_(*a, **kw):
            logits, hidden = self.verify(*a, **kw)
            keep(logits[:, 0])
            return logits, hidden

        eng._decode, spec_mod.verify_body = decode_, verify_

    def close(self) -> None:
        del self.eng._decode
        self.spec.verify_body = self.verify


def spec_run(torch, eng, prompts, slots=None) -> dict:
    """Queue ``prompts`` (request i on adapter slot ``slots[i]``), run
    SplitFuse steps until none is prefilling (the prefill phase), then
    ``generate_all`` (the decode phase): per request its new tokens, the
    f32 logits row of its first token and that of its first steady step
    (:class:`SteadyProbe`; None for a request no longer running there)
    with the count of tokens it had emitted before that step; the mixed
    steps, the spec steps, and decode tokens/s."""
    probe = HierProbe(torch, eng, True, False)
    uids = [eng.put(p, max_new_tokens=NEW_TOKENS,
                    adapter_slot=slots[i] if slots else 0)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mixed = 0
    while eng.num_waiting or eng._prefilling:
        eng.step()
        mixed += 1
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    emitted = sum(len(s.tokens) for s in eng.running.values()) \
        - sum(len(p) for p in prompts)
    steady = SteadyProbe(eng)
    try:
        res = eng.generate_all(burst=8)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        steady.close()
    tokens = [res[u][len(p):] for u, p in zip(uids, prompts)]
    if any(len(t) != NEW_TOKENS for t in tokens):
        fail("a request ended with the wrong number of tokens")
    stats = eng.spec_stats()
    return {"tokens": tokens,
            "first_logits": [probe.first[u][1] for u in uids],
            "steady_logits": [steady.logits[u].float().cpu()
                              if u in steady.logits else None for u in uids],
            "steady_after": [steady.after.get(u) for u in uids],
            "mixed_steps": mixed, "spec_steps": eng.spec_steps,
            "spec_stats": stats, "prefill_s": t1 - t0, "decode_s": t2 - t1,
            "decode_tokens_per_s": (len(prompts) * NEW_TOKENS - emitted)
            / (t2 - t1)}


def first_token_logits(torch, eng, prompts) -> list:
    """The f32 logits row of each of ``prompts``' first token, the
    prompts served together on ``eng``, one new token each."""
    probe = HierProbe(torch, eng, True, False)
    uids = [eng.put(p, max_new_tokens=1) for p in prompts]
    eng.generate_all(burst=1)
    return [probe.first[u][1] for u in uids]


def spec_step_syncs(torch, eng, prompts) -> str:
    """Bring ``eng`` to steady speculative decode on ``prompts``, then run
    one greedy speculative step's device work (the draft iterations, the
    verify, the accept) under ``torch.cuda.set_sync_debug_mode("error")``
    up to its single read-back of emitted tokens and accept lengths.  The
    inputs are placed before, as the engine places them."""
    for p in prompts:
        eng.put(p, max_new_tokens=NEW_TOKENS)
    while eng.num_waiting or eng._prefilling:
        eng.step()
    inputs = eng._spec_inputs()
    temps, rng = eng._row_temps(0.0), eng._step_rng(None)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        emitted, alen = eng._spec_device(inputs, rng, temps, eng.table.seed)
    except RuntimeError as e:
        return str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    back = torch.cat([emitted, alen[:, None]], dim=1).cpu()
    if not ((back[:, -1] >= 0) & (back[:, -1] <= SPEC_K)).all():
        return f"accept lengths out of range: {back[:, -1].tolist()}"
    return ""


def spec_launch_check(pa, what: str, want: dict, positive=()) -> dict:
    """The paged kernels' launches by head dim since the last reset: each
    exactly ``want``, or more than zero for a key in ``positive``, or zero;
    and no plain call."""
    got = {f"{n}_d{d}": c for (n, d), c in pa.LAUNCHES_BY_HEAD_DIM.items()}
    ok = all(c > 0 if k in positive else c == want.get(k, 0)
             for k, c in got.items())
    if not ok or any(pa.PLAIN_CALLS.values()):
        fail(f"{what}: paged launches {got}, want exactly {want} and "
             f"{list(positive)} launched; plain calls {pa.PLAIN_CALLS}")
    return got


def logits_rel(a, b) -> float:
    """max |a - b| over max |b|: one request's logits row against the
    reference engine's."""
    return (a - b).abs().max().item() / b.abs().max().item()


def spec_compare(ref: dict, run: dict, what: str, rows=None,
                 bitwise_rows=(), steady_ref=None) -> dict:
    """For ``run``'s requests ``rows`` (default: all), the first-token
    logits against ``ref``'s and those of the first steady step against
    ``steady_ref[i]`` (default: ``ref``'s first steady step, which must
    follow the same tokens), each within TOL_SPEC_LOGITS_REL of the
    reference's max |logit| per request (the first token's bit for bit on
    ``bitwise_rows``); and the count of identical greedy continuations
    among them."""
    rows = range(len(ref["tokens"])) if rows is None else rows
    rel = {"first_logits": [], "steady_logits": []}
    for i in rows:
        if steady_ref is None:
            n = run["steady_after"][i]
            if (n != ref["steady_after"][i]
                    or run["tokens"][i][:n] != ref["tokens"][i][:n]):
                fail(f"{what}: request {i} reached its first steady step "
                     "after other tokens than in the reference engine")
            want = ref["steady_logits"][i]
        else:
            want = steady_ref[i]
        for key, a, b in (("first_logits", run["first_logits"][i],
                           ref["first_logits"][i]),
                          ("steady_logits", run["steady_logits"][i], want)):
            if (a is None) != (b is None):
                fail(f"{what}: request {i} ran in the first steady step of "
                     "one engine only")
            if a is None:
                continue
            rel[key].append(logits_rel(a, b))
            if not rel[key][-1] <= TOL_SPEC_LOGITS_REL:
                fail(f"{what}: request {i}'s {key} differ from the "
                     f"reference's by {rel[key][-1]} of its max |logit| "
                     f"(limit {TOL_SPEC_LOGITS_REL})")
        if i in bitwise_rows and not bool(
                (run["first_logits"][i] == ref["first_logits"][i]).all()):
            fail(f"{what}: slot-0 request {i}'s first-token logits are not "
                 "bit for bit the adapterless engine's")
    if not rel["steady_logits"]:
        fail(f"{what}: no request of {list(rows)} ran in the first steady "
             "step")
    same = sum(run["tokens"][i] == ref["tokens"][i] for i in rows)
    return {"logits_max_abs_diff_rel": max(rel["first_logits"]),
            "steady_logits_max_abs_diff_rel": max(rel["steady_logits"]),
            "identical_continuations":
                f"{same} of {len(rel['first_logits'])}"}


def spec_rates(torch) -> dict:
    """One process's warm decode tokens/s of the bf16 serving cell at
    llama3-8b: plain, draft-model and self-draft speculation, and with
    adapters (slots 1-4 over the 8 requests).  Each engine serves the
    traffic once to warm up, then once timed."""
    import numpy as np

    from deepspeed_tpu_torch.inference.v2.engine import InferenceEngineV2
    from deepspeed_tpu_torch.linear.spec_heads import init_spec_heads
    from deepspeed_tpu_torch.models import transformer as tfm
    from deepspeed_tpu_torch.serving.adapters import AdapterRegistry

    cfg = tfm.get_config("llama3-8b")
    params = tfm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    draft = draft_model(torch, tfm)
    heads = init_spec_heads(torch.Generator(device="cuda").manual_seed(1),
                            cfg, SPEC_K, base_params=params)
    packs = adapter_packs(cfg, ADAPTER_PACKS, ADAPTER_RANK)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in PROMPT_LENS]

    def adapters():
        eng = InferenceEngineV2(cfg, params, spec_v2(
            adapter_slots=ADAPTER_SLOTS, adapter_rank=ADAPTER_RANK))
        reg = AdapterRegistry(eng, host_bytes=ADAPTER_HOST_BYTES)
        for i, pack in enumerate(packs):
            reg.register(f"a{i}", pack=pack)
        slots = [0] + [reg.acquire(f"a{i}") for i in range(ADAPTER_PACKS)]
        return eng, [slots[i % len(slots)] for i in range(len(prompts))]

    makers = {
        "plain": lambda: (InferenceEngineV2(cfg, params, spec_v2()), None),
        "draft": lambda: (InferenceEngineV2(
            cfg, params, spec_v2(spec_mode="draft", spec_k=SPEC_K),
            draft_params=draft[1], draft_config=draft[0]), None),
        "self_draft": lambda: (InferenceEngineV2(
            cfg, params, spec_v2(spec_mode="self_draft", spec_k=SPEC_K),
            spec_heads=heads), None),
        "adapters": adapters}
    out = {}
    for name, make in makers.items():
        for timed in (False, True):
            eng, slots = make()
            r = spec_run(torch, eng, prompts, slots)
            del eng
            torch.cuda.empty_cache()
        s = r["spec_stats"]
        out[name] = {"decode_tokens_per_s": r["decode_tokens_per_s"],
                     "acceptance_rate": s["acceptance_rate"],
                     "tokens_per_row_step": (
                         s["emitted_tokens"] / (s["proposed_tokens"] / SPEC_K)
                         if s["proposed_tokens"] else 0.0)}
    return out


def spec_rates_over_processes(torch) -> dict:
    """:func:`spec_rates` in SPEC_RATE_PROCS fresh processes (each one
    ``chip_smoke.py --spec-rates``), in turn."""
    runs = []
    for _ in range(SPEC_RATE_PROCS):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--spec-rates"],
            capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            fail(f"a --spec-rates process failed: {res.stderr[-2000:]}")
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    out = {}
    for name in runs[0]:
        rates = [r[name]["decode_tokens_per_s"] for r in runs]
        out[name] = {"decode_tokens_per_s": rates,
                     "median": statistics.median(rates),
                     "acceptance_rate": [r[name]["acceptance_rate"]
                                         for r in runs],
                     "tokens_per_row_step": [r[name]["tokens_per_row_step"]
                                             for r in runs]}
    return out


def verify_prefill_timing(torch, pa, flush) -> dict:
    """B4 at a verify's shape (llama3-8b, Qp = SPEC_K + 1 positions per
    row from each request's context) against its plain version: bf16 max
    abs error and kernel / plain / library (SDPA on the gathered contexts)
    / bound times, beside the Qp = 256 row."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    S = len(PROMPT_LENS)
    kc, vc, bt = paged_inputs(torch, S, gen)
    qp = SPEC_K + 1
    q = torch.randn((S, qp, H, D), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    starts = [n + NEW_TOKENS // 2 for n in PROMPT_LENS]
    cs = torch.tensor(starts, dtype=torch.int32, device="cuda")
    cl = torch.full((S,), qp, dtype=torch.int32, device="cuda")
    err = compare(pa.paged_prefill_attention(q, kc, vc, bt, cs, cl),
                  pa.prefill_attention_plain(q, kc, vc, bt, cs, cl),
                  TOL_BF16, "prefill kernel at the verify shape")
    ends = [a + qp for a in starts]
    n_pos = sum(ends)
    cols = sum(-(-e // BS) for e in ends)
    pairs = sum(a + i + 1 for a in starts for i in range(qp))
    nbytes = (2 * q.numel() * 2 + n_pos * KV * D * 2 * 2 + cols * 4
              + 2 * S * 4)
    b_ms, b_by = bound(nbytes, 4 * pairs * H * D)
    return {"Qp": qp, "max_abs_err": err,
            "ms": time_ms(lambda: pa.paged_prefill_attention(
                q, kc, vc, bt, cs, cl), torch, flush),
            "plain_ms": time_ms(lambda: pa.prefill_attention_plain(
                q, kc, vc, bt, cs, cl), torch, flush, iters=10),
            "library_ms": time_ms(sdpa_on_gathered(torch, q, kc, vc, bt, cs,
                                                   cl), torch, flush),
            "bound_ms": b_ms, "bound_by": b_by}


def run_spec_phase(torch, pa, params, card: str, cfg=None,
                   draft_shape=None) -> dict:
    """Speculative decoding and adapters at llama3-8b full width and depth
    (bf16, the serving cell's V2Config and traffic, spec_k = 4), on the
    engine phase's weights: a plain run (the reference logits and tokens);
    the draft-model engine (the Llama-3.2-1B-shaped draft on its own pool)
    with B4 = 32 x (mixed + spec steps) + 16 x mixed steps and B5 = 16 x
    (k+1) x spec steps, exactly; self-draft (heads seeded from the lm
    head) with B4 = 32 x (mixed + spec steps) and no B5; adapters (8 slots,
    rank 16, four packs through ``AdapterRegistry``, the requests over
    slots 0-4), then adapters with self-draft.  Each: no plain call;
    the first-token logits and those of the first steady step (a decode
    body's, or a verify's position 0) against the plain run (slot-0
    rows' first token bit for bit), adapter rows against an engine
    serving that adapter's merged weights, and with self-draft against
    the adapter engine; for each speculative mode one greedy step with no
    host sync.
    ``cfg``/``draft_shape``: a smaller model and draft (the GPU tests)."""
    import numpy as np

    from deepspeed_tpu_torch.inference.v2.engine import InferenceEngineV2
    from deepspeed_tpu_torch.linear.spec_heads import init_spec_heads
    from deepspeed_tpu_torch.models import transformer as tfm
    from deepspeed_tpu_torch.linear.optimized_linear import (
        graft_adapter_pack, merge_lora_weights)
    from deepspeed_tpu_torch.serving.adapters import AdapterRegistry

    cfg = cfg or tfm.get_config("llama3-8b")
    draft_shape = draft_shape or DRAFT_SHAPE
    L, DL = cfg.num_layers, draft_shape["num_layers"]
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in PROMPT_LENS]
    out = {"card": card, "spec_k": SPEC_K}

    def done(eng):
        del eng
        gc.collect()
        torch.cuda.empty_cache()

    eng = InferenceEngineV2(cfg, params, spec_v2())
    plain = spec_run(torch, eng, prompts)
    done(eng)

    draft = draft_model(torch, tfm, cfg, draft_shape)
    make_draft = lambda: InferenceEngineV2(  # noqa: E731
        cfg, params, spec_v2(spec_mode="draft", spec_k=SPEC_K),
        draft_params=draft[1], draft_config=draft[0])
    eng = make_draft()
    pa.reset_counts()
    r = spec_run(torch, eng, prompts)
    m, s = r["mixed_steps"], r["spec_steps"]
    launches = spec_launch_check(pa, "draft-model engine", {
        f"paged_prefill_attention_d{D}": L * (m + s),
        f"paged_prefill_attention_d{DRAFT_D}": DL * m,
        f"paged_decode_attention_d{DRAFT_D}": DL * (SPEC_K + 1) * s})
    out["draft"] = {"mixed_steps": m, "spec_steps": s, "launches": launches,
                    "spec_stats": r["spec_stats"],
                    "draft_pool_gb": sum(t.numel() * t.element_size()
                                         for t in eng._draft_caches.values())
                    / 1e9, **spec_compare(plain, r, "draft-model engine")}
    done(eng)
    eng = make_draft()
    out["draft"]["spec_step_host_syncs"] = spec_step_syncs(torch, eng,
                                                           prompts)
    if out["draft"]["spec_step_host_syncs"]:
        fail("draft-model spec step waited for the device: "
             + out["draft"]["spec_step_host_syncs"])
    done(eng)
    del draft
    done(None)

    heads = init_spec_heads(torch.Generator(device="cuda").manual_seed(1),
                            cfg, SPEC_K, base_params=params)
    out["heads_bytes"] = sum(t.numel() * t.element_size()
                             for t in heads.values())
    make_self = lambda **kw: InferenceEngineV2(  # noqa: E731
        cfg, params, spec_v2(spec_mode="self_draft", spec_k=SPEC_K, **kw),
        spec_heads=heads)
    eng = make_self()
    pa.reset_counts()
    r = spec_run(torch, eng, prompts)
    m, s = r["mixed_steps"], r["spec_steps"]
    launches = spec_launch_check(pa, "self-draft engine", {
        f"paged_prefill_attention_d{D}": L * (m + s)})
    out["self_draft"] = {"mixed_steps": m, "spec_steps": s,
                         "launches": launches, "spec_stats": r["spec_stats"],
                         **spec_compare(plain, r, "self-draft engine")}
    done(eng)
    eng = make_self()
    out["self_draft"]["spec_step_host_syncs"] = spec_step_syncs(
        torch, eng, prompts)
    if out["self_draft"]["spec_step_host_syncs"]:
        fail("self-draft spec step waited for the device: "
             + out["self_draft"]["spec_step_host_syncs"])
    done(eng)

    packs = adapter_packs(cfg, ADAPTER_PACKS, ADAPTER_RANK)
    runs = {}
    for name, make in (("adapters", lambda: InferenceEngineV2(
            cfg, params, spec_v2(adapter_slots=ADAPTER_SLOTS,
                                 adapter_rank=ADAPTER_RANK))),
            ("adapters_self_draft", lambda: make_self(
                adapter_slots=ADAPTER_SLOTS, adapter_rank=ADAPTER_RANK))):
        eng = make()
        reg = AdapterRegistry(eng, host_bytes=ADAPTER_HOST_BYTES)
        for i, pack in enumerate(packs):
            reg.register(f"a{i}", pack=pack)
        lanes = [None] + [f"a{i}" for i in range(ADAPTER_PACKS)]
        ids = [lanes[i % len(lanes)] for i in range(len(prompts))]
        slots = [reg.acquire(a) if a else 0 for a in ids]
        pa.reset_counts()
        r = spec_run(torch, eng, prompts, slots)
        m, s = r["mixed_steps"], r["spec_steps"]
        # plain decode runs bursts of decode bodies (B5, any number)
        launches = spec_launch_check(
            pa, name, {f"paged_prefill_attention_d{D}": L * (m + s)},
            positive=() if s else (f"paged_decode_attention_d{D}",))
        for a in ids:
            if a:
                reg.release(a)
        reg.check_leaks()
        base_rows = [i for i, a in enumerate(ids) if a is None]
        # slot-0 rows against the adapterless engine (the first token bit
        # for bit), each adapter's rows against an engine serving its
        # merged weights on the same batch; with self-draft, every row
        # against the adapter engine's
        vs = spec_compare(plain, r, name, rows=base_rows,
                          bitwise_rows=base_rows)
        if s:
            vs = spec_compare(runs["adapters"], r, name)
        else:
            # the merged comparison tells a served adapter from none only
            # where the adapter moves the logits past the limit
            moved = min(logits_rel(r["first_logits"][i],
                                   plain["first_logits"][i])
                        for i, a in enumerate(ids) if a)
            if not moved > TOL_SPEC_LOGITS_REL:
                fail(f"{name}: an adapter moved first-token logits by only "
                     f"{moved} of max |logit|, inside the limit "
                     f"{TOL_SPEC_LOGITS_REL} that holds it to its merged "
                     "weights")
            vs["adapter_rows_vs_plain_rel_min"] = moved
            # each adapter's rows against its merged weights: the first
            # tokens on the same batch; the first steady step after the
            # same tokens (greedy tokens part between the two engines in
            # the mixed steps before it, C4), so against the first token
            # of the row's prompt and the tokens it had emitted there
            vs["merged"] = {}
            for a in lanes[1:]:
                rows = [i for i, b in enumerate(ids) if b == a]
                m_params = merge_lora_weights(graft_adapter_pack(
                    params, reg.get_pack(a)))
                m_eng = InferenceEngineV2(cfg, m_params, spec_v2())
                merged = spec_run(torch, m_eng, prompts)
                done(m_eng)
                m_eng = InferenceEngineV2(cfg, m_params, spec_v2())
                forced = first_token_logits(torch, m_eng, [
                    prompts[i] + r["tokens"][i][:r["steady_after"][i]]
                    for i in rows])
                done(m_eng)
                del m_params
                vs["merged"][a] = spec_compare(
                    merged, r, f"{name}, adapter {a} against its merged "
                    "weights", rows=rows, steady_ref=dict(zip(rows, forced)))
                vs["merged"][a]["parted_before_steady_step"] = sum(
                    merged["tokens"][i][:r["steady_after"][i]]
                    != r["tokens"][i][:r["steady_after"][i]] for i in rows)
        runs[name] = r
        out[name] = {"mixed_steps": m, "spec_steps": s, "slots": slots,
                     "launches": launches, "registry": reg.stats(), **vs}
        reg.close()
        done(eng)
    del heads
    done(None)
    return out


def small_spec_agreement(torch, pa) -> dict:
    """A small f32 model (head dim 64) served speculatively — draft model
    (itself as its draft), self-draft, and self-draft with three adapters
    — on the card and on the CPU: greedy tokens identical card vs CPU vs
    the non-speculative engine, and with the model as its own draft every
    draft that its budget lets count is accepted (on the card and the
    CPU)."""
    import numpy as np

    from deepspeed_tpu_torch.inference.v2.engine import (InferenceEngineV2,
                                                         V2Config)
    from deepspeed_tpu_torch.models import transformer as tfm

    cfg = tfm.get_config("tiny", hidden_size=256, intermediate_size=512,
                         num_heads=4, num_kv_heads=2, dtype="float32")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(SEED),
                             device="cpu")
    base = V2Config(max_tokens_per_step=32, max_seqs=4, block_size=16,
                    num_blocks=64, max_blocks_per_seq=8, dtype="float32")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (5, 40, 17, 70)]
    packs = adapter_packs(cfg, 3, 4)
    slots = [i % 4 for i in range(len(prompts))]
    out = {}

    def serve(dev, v2, with_slots):
        eng = InferenceEngineV2(cfg, params, v2, draft_params=params,
                                draft_config=cfg, device=dev)
        if with_slots:
            for j, pack in enumerate(packs):
                eng.set_adapter_slot(j + 1, pack)
        short = []
        if v2.spec_mode == "draft":  # accept lengths vs the budget
            device_step = eng._spec_device

            def spec_device(inputs, *a):
                t = eng.table
                rows = np.nonzero(t.active)[0]
                left = (t.budget - t.gen)[rows]
                emitted, alen = device_step(inputs, *a)
                got = alen.cpu().numpy()[rows]
                short.extend(int(x) for x in
                             np.minimum(SPEC_K, left) - got if x > 0)
                return emitted, alen

            eng._spec_device = spec_device
        uids = [eng.put(p, max_new_tokens=12,
                        adapter_slot=slots[i] if with_slots else 0)
                for i, p in enumerate(prompts)]
        res = eng.generate_all(burst=4)
        return [res[u] for u in uids], eng.spec_stats(), short

    for name, over, with_slots in (
            ("draft", dict(spec_mode="draft", spec_k=SPEC_K), False),
            ("self_draft", dict(spec_mode="self_draft", spec_k=SPEC_K),
             False),
            ("self_draft_adapters", dict(spec_mode="self_draft",
                                         spec_k=SPEC_K, adapter_slots=4,
                                         adapter_rank=4), True)):
        v2 = dataclasses.replace(base, **over)
        plain = dataclasses.replace(v2, spec_mode="off")
        pa.reset_counts()
        card, stats, short = serve("cuda", v2, with_slots)
        need = ["paged_prefill_attention"]
        if name == "draft":
            need.append("paged_decode_attention")
        if not all(pa.LAUNCHES[k] for k in need) or any(
                pa.PLAIN_CALLS.values()):
            fail(f"small spec {name}: the card run did not go through the "
                 f"kernels: {pa.LAUNCHES} {pa.PLAIN_CALLS}")
        cpu, _, short_cpu = serve("cpu", v2, with_slots)
        ref, _, _ = serve("cpu", plain, with_slots)
        if not card == cpu == ref:
            fail(f"small spec {name}: greedy tokens differ: card vs CPU "
                 f"{card == cpu}, card vs non-speculative {card == ref}")
        if short or short_cpu:
            fail(f"small spec {name}: the model as its own draft rejected "
                 f"drafts its budget allowed: {short} (card), {short_cpu} "
                 "(CPU)")
        out[name] = {"spec_steps": stats["steps"],
                     "acceptance_rate": stats["acceptance_rate"]}
    return out


# ---------------------------------------------------------------------------
# the v1 engine and init_inference
# ---------------------------------------------------------------------------

# bigscience/bloom-7b1's config.json: n_embed 4096, n_layer 30, n_head 32,
# vocab_size 250880, the 4 x n_embed GELU MLP, layer_norm_epsilon 1e-5,
# word-embedding layernorm, tied embeddings, ALiBi (weights random, bf16)
BLOOM_7B1 = dict(vocab_size=250880, hidden_size=4096, intermediate_size=16384,
                 num_layers=30, num_heads=32, max_seq_len=2048,
                 norm="layernorm", activation="gelu", position="alibi",
                 embed_norm=True, tie_embeddings=True, norm_eps=1e-5)
# v1 against v2, first-token logits at llama3-8b in bf16: the two engines
# round different programs (v1 attends over a dense cache in plain torch,
# v2 through B4's tensor-core tiles), as the engine phase's mixed steps and
# decode bodies do (ROADMAP C4): max |diff| <= this * max |logit|
TOL_V1_LOGITS_REL = 5e-2
# the encoder at BERT-base width in f32, card against CPU: every sum is f32
# on both sides (TF32 off) in another order, over K = 768 or 3072 terms
TOL_ENCODER_REL = 1e-4
# real tokens per row of the encoder's 8 x 512 batch, the rest padding
ENCODER_LENS = [512, 500, 384, 300, 256, 128, 64, 17]


def free_cache(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


def v1_prompts(vocab: int):
    import numpy as np

    return np.random.default_rng(SEED).integers(0, vocab,
                                                (V1_BATCH, V1_PROMPT))


def v1_run(torch, cfg, params, icfg: dict, prompts, what: str,
           kernels=()) -> tuple:
    """``init_inference`` on ``params``, then two rounds of a 1-token and a
    NEW_TOKENS-token greedy ``generate`` (the first round cold).  Fails
    unless the tokens are in the vocab, the prefill logits finite and the
    second round's tokens the first's.  ``kernels``: modules whose counts
    are reset just before the first full generate and read just after.
    Returns (numbers, engine, tokens, prefill logits, counts)."""
    import deepspeed_tpu_torch

    eng = deepspeed_tpu_torch.init_inference(model_config=cfg, params=params,
                                             config=icfg)
    torch.cuda.reset_peak_memory_stats()
    rounds, counts = [], {}
    B, T = prompts.shape
    for r in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.generate(prompts, max_new_tokens=1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for k in kernels if r == 0 else ():
            k.reset_counts()
        toks = eng.generate(prompts, max_new_tokens=NEW_TOKENS)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for k in kernels if r == 0 else ():
            short = k.__name__.rsplit(".", 1)[1]
            counts.update({f"{short}.{name}": dict(getattr(k, name))
                           for name in ("LAUNCHES", "WGMMA_LAUNCHES",
                                        "DECODE_LAUNCHES", "PLAIN_CALLS",
                                        "DEQUANT_CALLS")
                           if hasattr(k, name)})
        rounds.append((toks, t1 - t0, t2 - t1, eng.first_logits))
    toks, first = rounds[0][0], rounds[0][3]
    if toks.shape != (B, T + NEW_TOKENS) or (toks[:, :T] != prompts).any():
        fail(f"{what}: generate gave {toks.shape}, want {(B, T + NEW_TOKENS)}"
             " starting with the prompts")
    if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        fail(f"{what}: a token outside the vocab")
    if not bool(torch.isfinite(first).all()):
        fail(f"{what}: the prefill's logits are not finite")
    if (rounds[1][0] != toks).any():
        fail(f"{what}: a second run on the same prompts gave other tokens")
    warm = rounds[1]
    out = {"prefill_s": warm[1], "prefill_tokens_per_s": B * T / warm[1],
           "generate_s": warm[2], "cold_generate_s": rounds[0][2],
           "decode_tokens_per_s": B * (NEW_TOKENS - 1) / (warm[2] - warm[1]),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    return out, eng, toks, first, counts


def v2_first_logits(torch, cfg, params, prompts, v2) -> "torch.Tensor":
    """f32 first-token logits of each prompt through ``InferenceEngineV2``,
    one request at a time (row 0 of its last mixed step)."""
    from deepspeed_tpu_torch.inference.v2.engine import InferenceEngineV2

    eng = InferenceEngineV2(cfg, params, v2)
    rows = []
    for p in prompts.tolist():
        uid = eng.put(p, max_new_tokens=1)
        while uid not in eng.step():
            pass
        rows.append(eng.last_logits[0].float().clone())
    del eng
    return torch.stack(rows)


def v1_quantized_counts(counts: dict, cfg, what: str) -> dict:
    """The mixed GEMM's launches over one quantized ``generate``: every
    projection of every layer once per forward (one prefill at M = B * T on
    ``mixed_gemm_wgmma_kernel`` when bf16 or f16, NEW_TOKENS - 1 decodes at
    M = B on ``mixed_gemm_decode_kernel``), no plain or envelope call."""
    launches = counts["mixed_gemm.LAUNCHES"]["mixed_gemm_int8"]
    wgmma = counts["mixed_gemm.WGMMA_LAUNCHES"]["mixed_gemm_int8"]
    decode = counts["mixed_gemm.DECODE_LAUNCHES"]["mixed_gemm_int8"]
    want = PROJECTIONS * cfg.num_layers * NEW_TOKENS
    want_wgmma = PROJECTIONS * cfg.num_layers \
        if cfg.dtype in ("bfloat16", "float16") else 0
    want_decode = PROJECTIONS * cfg.num_layers * (NEW_TOKENS - 1)
    if launches != want or wgmma != want_wgmma or decode != want_decode:
        fail(f"{what}: {launches} mixed_gemm launches ({wgmma} on wgmma, "
             f"{decode} on the decode kernel), want {want} ({want_wgmma}, "
             f"{want_decode})")
    if any(counts["mixed_gemm.PLAIN_CALLS"].values()) or any(
            counts["mixed_gemm.DEQUANT_CALLS"].values()):
        fail(f"{what}: a plain or envelope call: "
             f"{counts['mixed_gemm.PLAIN_CALLS']} "
             f"{counts['mixed_gemm.DEQUANT_CALLS']}")
    return {"mixed_gemm_int8": launches, "mixed_gemm_wgmma": wgmma,
            "mixed_gemm_decode": decode}


def v1_against_v2(first, ref, what: str) -> float:
    """The largest per-prompt max |v1 - v2| of the first-token logits, over
    that prompt's max |logit|; fails past TOL_V1_LOGITS_REL."""
    rel = ((first - ref).abs().amax(-1) / ref.abs().amax(-1)).max().item()
    if not rel <= TOL_V1_LOGITS_REL:
        fail(f"{what}: first-token logits differ from v2's by {rel} of max "
             f"|logit| (limit {TOL_V1_LOGITS_REL})")
    return rel


def run_v1_phase(torch, mg, params, card: str) -> dict:
    """The v1 engine through ``init_inference`` on the card: (a) llama3-8b
    at full width and depth in bf16 on the engine phase's weights, against
    the v2 engine's first-token logits; (b) the same quantized to int8,
    with exact mixed-GEMM launches, against a v2 engine quantized to int8;
    (c) ALiBi at BLOOM-7b1's width and depth (which v2 refuses); (d) the
    encoder at BERT-base width, card against CPU."""
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.v2.engine import (InferenceEngineV2,
                                                         V2Config)
    from deepspeed_tpu_torch.models import encoder as enc
    from deepspeed_tpu_torch.models import transformer as tfm

    cfg = tfm.get_config("llama3-8b")
    icfg = {"dtype": "bfloat16", "max_seq_len": V1_PROMPT + NEW_TOKENS}
    prompts = v1_prompts(cfg.vocab_size)
    out = {}
    bf16, eng, toks, first, _ = v1_run(torch, cfg, params, icfg, prompts,
                                       "v1 bf16")
    shared = eng.params["layers"]["attn"]["wq"] is \
        params["layers"]["attn"]["wq"]
    del eng
    v2 = V2Config(max_tokens_per_step=256, max_seqs=8, block_size=BS,
                  num_blocks=NB, max_blocks_per_seq=MB, dtype="bfloat16")
    ref = v2_first_logits(torch, cfg, params, prompts, v2)
    rel = v1_against_v2(first, ref, "v1 bf16")
    agree = (toks[:, V1_PROMPT] == ref.argmax(-1).cpu().numpy()).sum()
    out["bf16"] = dict(bf16, first_logits_rel_diff_vs_v2=rel,
                       first_tokens_equal_v2=int(agree),
                       weights_shared=shared)
    del ref
    free_cache(torch)

    quant, eng, toks, first, counts = v1_run(
        torch, cfg, params, dict(icfg, quantize_bits=8), prompts,
        "v1 W8A16", kernels=[mg])
    del eng
    free_cache(torch)
    # v2 quantizes the same raw weights itself: the same codes and scales
    ref = v2_first_logits(torch, cfg, params, prompts,
                          dataclasses.replace(v2, quantize_bits=8))
    rel = v1_against_v2(first, ref, "v1 W8A16")
    agree = (toks[:, V1_PROMPT] == ref.argmax(-1).cpu().numpy()).sum()
    out["w8a16"] = dict(quant, launches=v1_quantized_counts(
        counts, dataclasses.replace(cfg, dtype="bfloat16"), "v1 W8A16"),
        first_logits_rel_diff_vs_v2=rel, first_tokens_equal_v2=int(agree))
    del ref
    free_cache(torch)

    bcfg = tfm.TransformerConfig(dtype="bfloat16", **BLOOM_7B1)
    try:
        InferenceEngineV2(bcfg, {}, v2)
        fail("v2 took an ALiBi model")
    except NotImplementedError:
        pass
    t0 = time.perf_counter()
    bparams = tfm.init_params(bcfg, torch.Generator(
        device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    bprompts = v1_prompts(bcfg.vocab_size)
    res, eng, _, _, _ = v1_run(torch, bcfg, bparams, icfg, bprompts,
                               "v1 ALiBi")
    out["alibi"] = dict(res, params=bcfg.num_params(), init_s=init_s,
                        layers=bcfg.num_layers)
    del eng, bparams
    free_cache(torch)

    ecfg = enc.EncoderConfig()
    eparams = enc.init_params(ecfg, torch.Generator().manual_seed(SEED),
                              device="cpu")
    rng = np.random.default_rng(SEED)
    S = ecfg.max_seq_len
    ids = rng.integers(0, ecfg.vocab_size, (len(ENCODER_LENS), S))
    mask = (np.arange(S)[None, :] <
            np.minimum(ENCODER_LENS, S)[:, None]).astype(np.int32)
    hidden = {}
    for dev in ("cuda", "cpu"):
        e = deepspeed_tpu_torch.init_inference(
            model_config=ecfg, params=eparams, config={"dtype": "float32"},
            device=dev)
        e.encode(ids, mask)  # warm
        sync(torch, dev)
        t0 = time.perf_counter()
        hidden[dev] = e.encode(ids, mask)
        sync(torch, dev)
        hidden[dev + "_s"] = time.perf_counter() - t0
        del e
    err = float(np.abs(hidden["cuda"] - hidden["cpu"]).max())
    scale = float(np.abs(hidden["cpu"]).max())
    if not (np.isfinite(hidden["cuda"]).all() and
            err <= TOL_ENCODER_REL * scale):
        fail(f"encoder: card against CPU {err} (limit {TOL_ENCODER_REL} of "
             f"{scale})")
    out["encoder"] = {"shape": list(hidden["cuda"].shape),
                      "max_abs_err_vs_cpu": err, "max_abs": scale,
                      "card_s": hidden["cuda_s"],
                      "cpu_s": hidden["cpu_s"], "params": ecfg.num_params()}
    out["card"] = card
    return out


def small_v1_agreement(torch, gm) -> dict:
    """Small f32 models through the v1 engine on the card and on the CPU
    from the same weights: rope, ALiBi (bloom-shaped) and dropless MoE
    (the grouped GEMM on the card, no plain call); greedy tokens
    identical."""
    import numpy as np

    from deepspeed_tpu_torch.models import transformer as tfm

    small = dict(hidden_size=256, intermediate_size=512, num_heads=4,
                 dtype="float32")
    cfgs = {"rope": tfm.get_config("tiny", num_kv_heads=2, **small),
            "alibi": tfm.TransformerConfig(**dict(
                BLOOM_7B1, **small, vocab_size=256, num_layers=2,
                max_seq_len=128)),
            "moe_dropless": small_moe_cfg(tfm, "dropless")}
    prompts = np.random.default_rng(SEED).integers(0, 256, (4, 24))
    icfg = {"dtype": "float32", "max_seq_len": 64}
    out = {}
    for name, cfg in cfgs.items():
        params = tfm.init_params(cfg, torch.Generator().manual_seed(SEED),
                                 device="cpu")
        toks = {}
        for dev in ("cuda", "cpu"):
            gm.reset_counts()
            import deepspeed_tpu_torch

            eng = deepspeed_tpu_torch.init_inference(
                model_config=cfg, params=params, config=icfg, device=dev)
            toks[dev] = eng.generate(prompts, max_new_tokens=12)
            if dev == "cuda" and name == "moe_dropless" and (
                    not all(gm.LAUNCHES.values())
                    or any(gm.PLAIN_CALLS.values())):
                fail(f"small v1 {name}: the card run did not go through "
                     f"the grouped GEMM: {gm.LAUNCHES} {gm.PLAIN_CALLS}")
        if (toks["cuda"] != toks["cpu"]).any():
            fail(f"small v1 {name}: greedy tokens on the card differ from "
                 "the CPU's")
        out[name] = {"tokens": int(toks["cuda"].size)}
    return out


# ---------------------------------------------------------------------------
# the serving front: broker, HTTP server, in-process and subprocess replicas
# ---------------------------------------------------------------------------

# the engine cell's V2Config as the server's CLI flags
SERVE_ARGV = ["--model", "llama3-8b", "--dtype", "bfloat16",
              "--max_tokens_per_step", "256", "--max_seqs", "8",
              "--block_size", str(BS), "--num_blocks", str(NB),
              "--max_blocks_per_seq", str(MB)]
SERVE_REQUESTS, SERVE_CLIENTS = 16, 8  # requests, client threads
SERVE_LEN = (17, 1000)  # prompt lengths drawn from this range
SERVE_LONE = 3  # requests sent one at a time, against a lone engine
SERVE_SPAWN_S = 600.0  # a worker imports torch and draws llama3-8b
SERVE_HTTP_S = 600.0  # any one HTTP call


def serve_traffic(vocab: int, n: int = SERVE_REQUESTS, lens=SERVE_LEN,
                  seed: int = SEED + 1):
    """``n`` (prompt, stream) pairs from a seed: prompt lengths in
    ``lens``, every other request streamed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sizes = rng.integers(lens[0], lens[1] + 1, size=n)
    return [(rng.integers(0, vocab, size=int(s)).tolist(), i % 2 == 1)
            for i, s in enumerate(sizes)]


def http_complete(port: int, prompt, stream: bool, on_first=None,
                  max_tokens: int = 0, extra=None) -> dict:
    """One greedy ``/v1/completions`` call: status, tokens, the text,
    finish reason, the request id, seconds to the first token (streams)
    and in all.  ``on_first(rid)`` runs when a stream's first token
    arrives.  ``max_tokens``: NEW_TOKENS when 0; ``extra``: more body
    fields (an adapter id)."""
    import http.client

    max_tokens = max_tokens or NEW_TOKENS
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=SERVE_HTTP_S)
    conn.request("POST", "/v1/completions", json.dumps(
        {"prompt": prompt, "max_tokens": max_tokens, "stream": stream,
         "temperature": 0.0, **(extra or {})}),
        {"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = {"status": resp.status, "stream": stream, "ttft_s": None}
    if not stream or resp.status != 200:
        body = json.loads(resp.read())
        conn.close()
        out["total_s"] = time.perf_counter() - t0
        if resp.status != 200:
            out["error"] = body
            return out
        choice = body["choices"][0]
        out.update(tokens=choice["tokens"], text=choice["text"],
                   finish=choice["finish_reason"], rid=body["id"],
                   completion_tokens=body["usage"]["completion_tokens"])
        return out
    toks, text, finish, done = [], [], None, False
    for raw in resp:
        raw = raw.strip()
        if not raw.startswith(b"data: "):
            continue
        if raw == b"data: [DONE]":
            done = True
            break
        obj = json.loads(raw[6:])
        choice = obj["choices"][0]
        if choice.get("token") is not None:
            if not toks:
                out["ttft_s"] = time.perf_counter() - t0
                out["rid"] = obj["id"]
                if on_first is not None:
                    on_first(obj["id"])
            toks.append(choice["token"])
            text.append(choice["text"])
        else:
            finish = choice["finish_reason"]
            if "error" in obj:
                out["error"] = obj["error"]
    conn.close()
    out.update(tokens=toks, text="".join(text), finish=finish, done=done,
               total_s=time.perf_counter() - t0)
    return out


def http_get(port: int, path: str):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read().decode()
    conn.close()
    return resp.status, body


def run_clients(port: int, traffic, clients: int = SERVE_CLIENTS) -> tuple:
    """``traffic`` from ``clients`` threads at once: (results in traffic
    order, wall seconds)."""
    import queue
    import threading

    jobs = queue.Queue()
    for i, job in enumerate(traffic):
        jobs.put((i, job))
    results, errors = [None] * len(traffic), []

    def client():
        while True:
            try:
                i, (prompt, stream) = jobs.get_nowait()
            except queue.Empty:
                return
            try:
                results[i] = http_complete(port, prompt, stream)
            except Exception as e:  # noqa: BLE001 — gated below
                errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client) for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=SERVE_HTTP_S)
        if t.is_alive():
            fail("serving: an HTTP client never finished")
    if errors:
        fail(f"serving: HTTP clients failed: {errors[:3]}")
    return results, time.perf_counter() - t0


def check_answers(results, traffic, what: str, max_tokens: int = 0) -> int:
    """Every request answered 200 with ``max_tokens`` tokens and finish
    reason "length"; a stream ended with ``[DONE]`` and its chunks' texts
    concatenate to the completion's text.  Returns the completion
    tokens.  ``max_tokens``: NEW_TOKENS when 0."""
    max_tokens = max_tokens or NEW_TOKENS
    n = 0
    for i, (r, (prompt, stream)) in enumerate(zip(results, traffic)):
        if r["status"] != 200 or r.get("error"):
            fail(f"{what}: request {i} answered {r['status']} "
                 f"{r.get('error')}")
        toks = r["tokens"]
        if len(toks) != max_tokens or r["finish"] != "length":
            fail(f"{what}: request {i}: {len(toks)} tokens, finish "
                 f"{r['finish']!r}")
        if stream and (not r["done"] or r["text"] !=
                       "".join(f" {t}" for t in toks)):
            fail(f"{what}: stream {i}'s chunks do not make its completion")
        n += len(toks)
    return n


def lone_tokens(eng, prompts) -> list:
    """Each prompt served alone through ``step()``, as a replica's broker
    drives its engine: the greedy new tokens."""
    out = []
    for p in prompts:
        uid = eng.put(p, max_new_tokens=NEW_TOKENS)
        toks = []
        while eng.num_running or eng.num_waiting:
            toks += eng.step().get(uid, [])
        out.append(toks)
    return out


def step_launch_check(pa) -> dict:
    """B4 and B5 launches against the ``engine/step`` spans recorded since
    the tracer was cleared: one B4 launch per layer per mixed step, one B5
    per layer per decode body, no plain call.  Exact for one replica."""
    from deepspeed_tpu_torch.observability import tracer

    spans = tracer.spans(name="engine/step")
    kinds = [sp.attrs["kind"] for sp in spans]
    mixed, decode = kinds.count("mixed"), kinds.count("decode")
    return {"mixed_steps": mixed, "decode_bodies": decode,
            "launches": dict(pa.LAUNCHES),
            "plain_calls": dict(pa.PLAIN_CALLS)}


def start_server(pool, scfg, name: str):
    import threading

    from deepspeed_tpu_torch.serving import create_server

    srv = create_server(pool, pool.metrics, scfg, model_name=name)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def run_serving_phase(torch, pa, card: str, argv=SERVE_ARGV,
                      traffic_lens=SERVE_LEN) -> dict:
    """The serving front over the port's v2 engine on the card: (a) one
    in-process replica at llama3-8b bf16, nothing cut, behind the HTTP
    server, built from the CLI's own flags (``build_engine_factory``); (b)
    two in-process replicas on the same weights; (c) the server CLI as a
    subprocess with two worker processes, one of them killed mid-stream.
    ``argv``/``traffic_lens``: a smaller model (the GPU tests)."""
    import argparse
    import signal

    from deepspeed_tpu_torch.inference.v2.engine import InferenceEngineV2
    from deepspeed_tpu_torch.observability import tracer
    from deepspeed_tpu_torch.observability.prometheus import parse_exposition
    from deepspeed_tpu_torch.serving import ReplicaPool, ServingConfig
    from deepspeed_tpu_torch.serving.server import (add_engine_cli_args,
                                                    build_engine_factory,
                                                    launch_server_subprocess,
                                                    stop_server)

    ap = argparse.ArgumentParser()
    add_engine_cli_args(ap)
    args = ap.parse_args(argv)
    out = {"card": card, "model": args.model}
    free_cache(torch)
    t0 = time.perf_counter()
    factory = build_engine_factory(args)  # draws the weights once
    torch.cuda.synchronize()
    out["weights_init_s"] = time.perf_counter() - t0

    # (a) one in-process replica behind the HTTP server
    scfg = ServingConfig(num_replicas=1, max_queue=64)
    pool = ReplicaPool.build(factory, scfg).start()
    pool.wait_ready(timeout=60)
    rep = pool.replicas[0].engine
    traffic = serve_traffic(rep.model_cfg.vocab_size, lens=traffic_lens)
    srv = start_server(pool, scfg, args.model)
    port = srv.server_port
    pa.reset_counts()
    tracer.clear()
    results, wall = run_clients(port, traffic)
    steps = step_launch_check(pa)
    L = rep.model_cfg.num_layers
    calls, plain = steps["launches"], steps["plain_calls"]
    if (calls["paged_prefill_attention"] != L * steps["mixed_steps"]
            or calls["paged_decode_attention"] != L * steps["decode_bodies"]
            or any(plain.values())
            or not steps["mixed_steps"] or not steps["decode_bodies"]):
        fail(f"serving (a): paged launches {steps['launches']} (plain "
             f"{plain}) for {steps['mixed_steps']} mixed steps and "
             f"{steps['decode_bodies']} decode bodies of {L} layers")
    tokens = check_answers(results, traffic, "serving (a)")
    status, health = http_get(port, "/healthz")
    if status != 200 or json.loads(health)["status"] != "ok":
        fail(f"serving (a): /healthz answered {status} {health[:200]}")
    status, text = http_get(port, "/metrics")
    fam = parse_exposition(text)
    counted = {k: fam[f"dstpu_serving_{k}"]["samples"][0][2]
               for k in ("submitted", "completed", "tokens_out")}
    if status != 200 or counted["completed"] != SERVE_REQUESTS or \
            counted["submitted"] != SERVE_REQUESTS:
        fail(f"serving (a): /metrics counts {counted}, want "
             f"{SERVE_REQUESTS} requests")
    snap = pool.metrics.snapshot()
    ttft = sorted(r["ttft_s"] for r in results if r["ttft_s"] is not None)
    # three requests one at a time, against a lone engine on the same
    # weights (the replica's own tensors: no copy)
    lone_prompts = [p for p, _ in traffic[:SERVE_LONE]]
    via_http = [http_complete(port, p, False)["tokens"]
                for p in lone_prompts]
    lone = InferenceEngineV2(rep.model_cfg, rep.params, rep.cfg)
    want = lone_tokens(lone, lone_prompts)
    if via_http != want:
        fail("serving (a): requests sent one at a time differ from a lone "
             "engine's tokens")
    # the hard-kill request of (c), served alone here first
    kill_prompt = serve_traffic(rep.model_cfg.vocab_size, 1,
                                lens=traffic_lens, seed=SEED + 2)[0][0]
    kill_want = lone_tokens(lone, [kill_prompt])[0]
    pool.shutdown()
    srv.shutdown()
    del srv  # it holds the pool
    # generate_all on the same 16 prompts: the engine without the front
    for p, _ in traffic:
        lone.put(p, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lone.generate_all(burst=8)
    torch.cuda.synchronize()
    gen_all_s = time.perf_counter() - t0
    # concurrent bf16 continuations may part from a lone run's (ROADMAP
    # C4): counted, not gated
    same = sum(r["tokens"] == w for r, w in zip(
        results[:SERVE_LONE], want))
    out["inprocess"] = {
        "requests": SERVE_REQUESTS, "clients": SERVE_CLIENTS,
        "prompt_tokens": sum(len(p) for p, _ in traffic),
        "completion_tokens": tokens, "wall_s": wall,
        "http_tokens_per_s": tokens / wall,
        "generate_all_s": gen_all_s,
        "generate_all_tokens_per_s": SERVE_REQUESTS * NEW_TOKENS / gen_all_s,
        "ttft_s_p50_client": statistics.median(ttft),
        "ttft_ms_p50": snap["ttft_ms_p50"], "ttft_ms_p99": snap["ttft_ms_p99"],
        "tpot_ms_p50": snap["tpot_ms_p50"], "metrics_counts": counted,
        "mixed_steps": steps["mixed_steps"],
        "decode_bodies": steps["decode_bodies"],
        "launches": steps["launches"], "lone_equal": SERVE_LONE,
        "concurrent_equal_lone": f"{same}/{SERVE_LONE}"}
    del lone, pool, rep
    free_cache(torch)

    # (b) two in-process replicas: one more KV pool, not a weight copy
    def allocated() -> int:
        free_cache(torch)
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    grown = {}
    for n in (1, 2):
        pool = None
        m0 = allocated()
        pool = ReplicaPool.build(factory, ServingConfig(num_replicas=n,
                                                        max_queue=64))
        grown[n] = allocated() - m0
    kv = sum(t.numel() * t.element_size()
             for t in pool.replicas[0].engine.caches.values())
    if abs(grown[2] - grown[1] - kv) > 0.1 * kv:
        fail(f"serving (b): a second replica took {grown[2] - grown[1]} "
             f"bytes, want one KV pool ({kv})")
    pool.start()
    srv = start_server(pool, ServingConfig(num_replicas=2), args.model)
    pa.reset_counts()
    results, wall = run_clients(srv.server_port, traffic[:SERVE_CLIENTS])
    tokens = check_answers(results, traffic[:SERVE_CLIENTS], "serving (b)")
    out["two_replicas"] = {
        "first_replica_bytes": grown[1], "second_replica_bytes":
        grown[2] - grown[1], "kv_pool_bytes": kv,
        "requests": SERVE_CLIENTS, "completion_tokens": tokens,
        "wall_s": wall, "http_tokens_per_s": tokens / wall,
        # two engine threads update the counters: reported, not gated
        "launches": dict(pa.LAUNCHES)}
    pool.shutdown()
    srv.shutdown()
    del srv, pool, factory  # the server holds the pool, the pool the weights
    out["front_bytes_before_workers"] = allocated()

    # (c) the CLI as a subprocess over two worker processes
    t0 = time.perf_counter()
    proc, url = launch_server_subprocess(
        ["--port", "0", "--replica_transport", "subprocess", "--replicas",
         "2", *argv], timeout_s=SERVE_SPAWN_S)
    spawn_s = time.perf_counter() - t0
    port = int(url.rsplit(":", 1)[1])
    pids = set()
    try:
        results, wall = run_clients(port, traffic)
        tokens = check_answers(results, traffic, "serving (c)")

        def workers():
            reps = json.loads(http_get(port, "/healthz")[1])["replicas"]
            pids.update(r["pid"] for r in reps if r.get("pid"))
            return {r["name"]: r for r in reps}

        reps = workers()
        if len(reps) != 2 or not all(r.get("healthy") for r in
                                     reps.values()):
            fail(f"serving (c): /healthz shows {reps}")
        killed = {}

        def kill(rid):
            # "cmpl-replica1.g0-3": the replica serving this stream
            name = rid.split("-")[1].split(".")[0]
            killed.update(name=name, pid=reps[name]["pid"],
                          generation=reps[name]["generation"],
                          t=time.perf_counter())
            os.kill(killed["pid"], signal.SIGKILL)

        res = http_complete(port, kill_prompt, True, on_first=kill)
        if not killed:
            fail("serving (c): the stream never started")
        if res["tokens"] != kill_want or res["finish"] != "length":
            fail(f"serving (c): the stream whose worker was killed gave "
                 f"{len(res['tokens'])} tokens (finish {res['finish']}), "
                 "not the lone engine's")
        while True:
            reps = workers()
            r = reps[killed["name"]]
            if r.get("healthy") and r["generation"] > killed["generation"]:
                break
            if time.perf_counter() - killed["t"] > SERVE_SPAWN_S:
                fail(f"serving (c): {killed['name']} never respawned")
            time.sleep(0.5)
        respawn_s = time.perf_counter() - killed["t"]
        again = http_complete(port, kill_prompt, False)
        if again["status"] != 200 or len(again["tokens"]) != NEW_TOKENS:
            fail("serving (c): the fleet did not serve after the respawn")
    finally:
        rc = stop_server(proc, term_timeout_s=120.0)
        proc.stdout.close()
    left = []
    for pid in pids:
        try:
            os.kill(pid, 0)
            left.append(pid)
        except ProcessLookupError:
            pass
    try:
        os.killpg(proc.pid, 0)
        left.append(f"group {proc.pid}")
    except ProcessLookupError:
        pass
    if left:
        fail(f"serving (c): processes left after the drain: {left}")
    out["subprocess"] = {
        "spawn_to_ready_s": spawn_s, "requests": SERVE_REQUESTS,
        "completion_tokens": tokens, "wall_s": wall,
        "http_tokens_per_s": tokens / wall, "killed": killed["name"],
        "respawn_s": respawn_s, "stop_rc": rc,
        "worker_pids_seen": len(pids)}
    return out


def small_serving_agreement(torch, pa) -> dict:
    """A small f32 model (head dim 64) behind the HTTP server on the card
    and on the CPU, the same traffic sent one request at a time to each:
    tokens identical, the card through the paged kernels with no plain
    call."""
    from deepspeed_tpu_torch.inference.v2.engine import (InferenceEngineV2,
                                                         V2Config)
    from deepspeed_tpu_torch.models import transformer as tfm
    from deepspeed_tpu_torch.serving import ReplicaPool, ServingConfig

    cfg = tfm.get_config("tiny", hidden_size=256, intermediate_size=512,
                         num_heads=4, num_kv_heads=2, dtype="float32")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(SEED),
                             device="cpu")
    v2 = V2Config(max_tokens_per_step=32, max_seqs=4, block_size=16,
                  num_blocks=64, max_blocks_per_seq=8, dtype="float32")
    traffic = serve_traffic(cfg.vocab_size, 8, lens=(5, 70))
    toks = {}
    for dev in ("cuda", "cpu"):
        scfg = ServingConfig(num_replicas=1)
        pool = ReplicaPool.build(
            lambda: InferenceEngineV2(cfg, params, v2, device=dev),
            scfg).start()
        srv = start_server(pool, scfg, "small")
        pa.reset_counts()
        try:
            res = [http_complete(srv.server_port, p, s, max_tokens=12)
                   for p, s in traffic]
        finally:
            pool.shutdown()
            srv.shutdown()
        check_answers(res, traffic, f"small serving ({dev})", 12)
        toks[dev] = [r["tokens"] for r in res]
        if dev == "cuda" and (not all(pa.LAUNCHES.values())
                              or any(pa.PLAIN_CALLS.values())):
            fail(f"small serving: the card did not go through the paged "
                 f"kernels: {pa.LAUNCHES} {pa.PLAIN_CALLS}")
    if toks["cuda"] != toks["cpu"]:
        fail("small serving: tokens on the card differ from the CPU's")
    return {"requests": len(traffic),
            "tokens": sum(len(t) for t in toks["cuda"])}


# ---------------------------------------------------------------------------
# the serving fleet: dial-in workers, the autoscaler, replica classes,
# rolling weight swaps, fleet adapter ops and the bench
# ---------------------------------------------------------------------------

# the stage's own autoscaler debounce, which is also its cool-down after a
# scale-up: above a cold worker's spawn (a torch import, a CUDA context and
# 8B weights drawn on the card: 16.00-19.18 s to ready on an H100), so a
# second spawn never starts while the first is still coming up.  Every
# other autoscaler knob keeps the reference's default.
FLEET_DEBOUNCE_S = 25.0
# the stage's lease TTL, half the reference's 10 s default, to keep the smoke
# in its time limit: the SIGKILL and SIGSTOP parts each wait out a lease,
# and the SIGKILL part half a lease more (the lease still outlives the 5 s
# heartbeat timeout that declares a silent worker down)
FLEET_LEASE_S = 5.0
FLEET_LOAD_S = 300.0  # the load's budget to scale the fleet up
HANDOFF_LEN = 1000  # the prompt whose prefix the prefill replica hands off
# the rolling swap's depth, cut from 8 to CKPT_LAYERS to keep the smoke in
# its time limit: at 8 layers (a 4.54 GB checkpoint) the publish and the two
# rollouts took 39.6 s of the fleet phase's 239.0 (NVIDIA H100 80GB HBM3,
# 700 W)
ROLLOUT_LAYERS = CKPT_LAYERS
ROLLOUT_STREAMS = 8  # streams in flight while the fleet rolls
ADAPTER_ARGV = ["--adapter_slots", "8", "--adapter_rank", "16"]
BENCH_GEMM_MS = (1, 8, 16, 256)
BENCH_RATES = "2,8"
BENCH_DURATION_S = 4.0  # each rate's offered load (the bench's default 8)
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")


def http_post(port: int, path: str, body: dict) -> tuple:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=SERVE_HTTP_S)
    conn.request("POST", path, json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = json.loads(resp.read())
    conn.close()
    return resp.status, out


def wait_for(pred, timeout: float, what: str, interval: float = 0.1) -> float:
    """Seconds until ``pred()`` held; fails after ``timeout``."""
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            fail(what)
        time.sleep(interval)
    return time.perf_counter() - t0


def pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def fleet_kernels(pool, layers: int, seen: dict, what: str) -> None:
    """Each live worker's kernel counts from its heartbeat (``/healthz``'s
    ``kernels``): one B4 launch per layer per mixed step and one B5 per
    layer per decode body since the worker started, no plain call.  Keeps
    the newest counts per pid in ``seen``; a healthy worker that reports
    no counts or no pid fails.  Read with the fleet idle."""
    time.sleep(1.0)  # a heartbeat after the last step
    for t in list(pool.replicas):
        if not t.healthy():
            continue
        d = t.describe()
        k, pid = d.get("kernels"), d.get("pid")
        if k is None or not pid:
            fail(f"fleet {what}: healthy worker {t.name} reports kernels "
                 f"{k} and pid {pid}")
        steps, calls = k["steps"], k["launches"]
        if (calls["paged_prefill_attention"] != layers * steps.get("mixed", 0)
                or calls["paged_decode_attention"]
                != layers * steps.get("decode", 0)
                or any(k["plain_calls"].values())):
            fail(f"fleet {what}: worker {t.name} (pid {pid}) launched "
                 f"{calls} (plain {k['plain_calls']}) for steps {steps} of "
                 f"{layers} layers")
        seen[pid] = k


def worker_steps(t) -> int:
    """Engine steps a live worker's heartbeat reports (0 before any)."""
    k = t.describe().get("kernels") or {}
    return sum(k.get("steps", {}).values())


def fleet_remote_stage(torch, args, argv, traffic_lens) -> dict:
    """Stage 1: ``--replica_transport remote`` with the autoscaler between
    1 and 2 launcher-backed dial-in workers (``serving/remote.py``), the
    front holding no engine: (a) the pool starts the floor's worker and a
    load scales the fleet to two; (b) a worker is SIGKILLed under a lone
    stream: the stream completes, its lease expires once and the slot
    comes back under a higher epoch; (c) idle scales the fleet down to one
    with every request answered; (d) an externally managed worker is
    SIGSTOPped past its lease, declared dead and replaced by its agent
    under a newer epoch; SIGCONT, it is fenced (stale epoch) and exits 3;
    no request is answered twice; (e) the drain leaves no worker.  Every
    worker the fleet had reports its kernel counts (``fleet_kernels``),
    and each that served in (a), (b) or (d) reports engine steps: the
    load runs until the scaled-up worker has served, and (d) places a
    whole request on the external worker and on its replacement.
    Returns the numbers and, apart, the lone requests' (prompt, tokens)
    that stage 2 holds against a lone engine."""
    import signal
    import threading

    from deepspeed_tpu_torch.models import transformer as tfm
    from deepspeed_tpu_torch.serving import (Autoscaler, ReplicaPool,
                                             ServingConfig)
    from deepspeed_tpu_torch.serving.remote import (LocalWorkerLauncher,
                                                    RemoteReplica)
    from deepspeed_tpu_torch.serving.server import (engine_argv_from_args,
                                                    serving_argv_from_config)
    from deepspeed_tpu_torch.serving.worker import EXIT_FENCED

    mcfg = tfm.get_config(args.model, dtype=args.dtype)
    L, vocab = mcfg.num_layers, mcfg.vocab_size
    cfg = ServingConfig(num_replicas=1, replica_transport="remote",
                        max_queue=64, autoscale_min=1, autoscale_max=2,
                        scale_up_debounce_s=FLEET_DEBOUNCE_S,
                        lease_ttl_s=FLEET_LEASE_S,
                        spawn_timeout_s=SERVE_SPAWN_S)
    worker_argv = engine_argv_from_args(args) + serving_argv_from_config(cfg)
    pool = ReplicaPool.build_remote(worker_argv, cfg)
    fleet = pool.metrics.fleet
    # seen: pid -> newest kernel counts; pids: every worker the fleet
    # had; served: the workers that must have served (steps > 0)
    seen, pids, served = {}, set(), set()
    out = {"lease_ttl_s": cfg.lease_ttl_s, "debounce_s": FLEET_DEBOUNCE_S}

    def note_pids():
        for t in pool.replicas:
            pid = t.liveness()["pid"]
            if pid:
                pids.add(pid)

    t0 = time.perf_counter()
    pool.start()
    pool.wait_ready(timeout=SERVE_SPAWN_S)
    out["spawn_to_registered_s"] = time.perf_counter() - t0
    srv = start_server(pool, cfg, args.model)
    port = srv.server_port
    ext_procs = []
    try:
        # (a) the load scales the fleet up to two
        asc = Autoscaler(pool, cfg).start()
        traffic = serve_traffic(vocab, lens=traffic_lens)
        stop = threading.Event()
        load = {"tokens": 0, "requests": 0, "error": None}

        def client(jobs):
            # loops over its share of the traffic until stopped: no round
            # barrier, so the backlog never dips between rounds
            try:
                while not stop.is_set():
                    for job in jobs:
                        res = [http_complete(port, job[0], job[1])]
                        n = check_answers(res, [job], "fleet (a) load")
                        with lock:
                            load["tokens"] += n
                            load["requests"] += 1
                        if stop.is_set():
                            break
            except BaseException as e:  # noqa: BLE001 — reported below
                load["error"] = repr(e)

        lock = threading.Lock()

        def loader():
            t = time.perf_counter()
            clients = [threading.Thread(target=client,
                                        args=(traffic[i::SERVE_CLIENTS],))
                       for i in range(SERVE_CLIENTS)]
            for c in clients:
                c.start()
            for c in clients:
                c.join()
            load["wall_s"] = time.perf_counter() - t

        th = threading.Thread(target=loader)
        th.start()
        t_load = time.perf_counter()
        out["scale_up_decision_s"] = wait_for(
            lambda: asc.decisions["up"] >= 1 or load["error"], FLEET_LOAD_S,
            "fleet (a): the load never scaled the fleet up")
        out["scale_up_ready_s"] = wait_for(
            lambda: len(pool.healthy_replicas()) == 2 or load["error"],
            SERVE_SPAWN_S, "fleet (a): the scaled-up worker never registered")
        out["load_to_two_s"] = time.perf_counter() - t_load
        # the load runs on until the scaled-up worker has served too
        wait_for(lambda: load["error"] or all(
            worker_steps(pool.replicas[i]) for i in pool.healthy_replicas()),
            SERVE_HTTP_S, "fleet (a): the scaled-up worker served nothing")
        stop.set()
        th.join(timeout=SERVE_HTTP_S)
        asc.stop()  # (b)-(d) need both workers: no scale-down meanwhile
        if load["error"] or th.is_alive():
            fail(f"fleet (a): the load failed: {load['error']}")
        up = dict(pool.metrics.autoscale)
        if up["up"] < 1 or len(pool.replicas) != 2:
            fail(f"fleet (a): autoscale counters {up}, "
                 f"{len(pool.replicas)} slots")
        out.update(load_requests=load["requests"],
                   load_tokens=load["tokens"],
                   http_tokens_per_s=load["tokens"] / load["wall_s"],
                   autoscale_after_load=up)
        note_pids()
        served.update(pids)
        fleet_kernels(pool, L, seen, "(a)")

        # lone requests through HTTP, one at a time (stage 2 holds them
        # against a lone engine)
        lone_prompts = [p for p, _ in traffic[:SERVE_LONE]]
        checks = {"lone": [(p, http_complete(port, p, False)["tokens"])
                           for p in lone_prompts]}

        # (b) SIGKILL a worker under a lone stream
        kill_prompt = serve_traffic(vocab, 1, lens=traffic_lens,
                                    seed=SEED + 2)[0][0]
        epochs = {t.name: t.epoch for t in pool.replicas}
        expiries = fleet["lease_expiries"]
        h = pool.submit(kill_prompt, max_new_tokens=NEW_TOKENS)
        it = iter(h.tokens(timeout=SERVE_HTTP_S))
        toks = [next(it)]
        victim = pool.replicas[h.replica_index]
        vpid = victim.liveness()["pid"]
        t_kill = time.perf_counter()
        os.kill(vpid, signal.SIGKILL)
        first_after = None
        for tok in it:
            first_after = first_after or time.perf_counter()
            toks.append(tok)
        if len(toks) != NEW_TOKENS or first_after is None:
            fail(f"fleet (b): the killed worker's stream gave {len(toks)} "
                 "tokens")
        out["failover_s"] = first_after - t_kill
        checks["killed"] = [(kill_prompt, toks)]
        wait_for(lambda: fleet["lease_expiries"] > expiries,
                 cfg.lease_ttl_s + SERVE_SPAWN_S,
                 "fleet (b): the killed worker's lease never expired")
        out["lease_expiry_s"] = time.perf_counter() - t_kill
        wait_for(lambda: victim.healthy() and victim.epoch >
                 epochs[victim.name], SERVE_SPAWN_S,
                 "fleet (b): the killed worker's slot never re-registered")
        out["reregistered_s"] = time.perf_counter() - t_kill
        time.sleep(cfg.lease_ttl_s / 2)
        if fleet["lease_expiries"] != expiries + 1 or pid_alive(vpid):
            fail(f"fleet (b): {fleet['lease_expiries'] - expiries} lease "
                 f"expiries (want 1), killed pid alive {pid_alive(vpid)}")
        out["epochs"] = {"before": epochs[victim.name],
                         "after": victim.epoch}
        note_pids()
        fleet_kernels(pool, L, seen, "(b)")

        # (c) idle scales the fleet down to one; every request answered
        asc = Autoscaler(pool, cfg).start()
        t_idle, trickle = time.perf_counter(), 0
        while len(pool.replicas) > 1:
            if time.perf_counter() - t_idle > SERVE_SPAWN_S:
                fail("fleet (c): idle never scaled the fleet down")
            r = http_complete(port, kill_prompt[:17], False, max_tokens=2)
            if r["status"] != 200 or len(r["tokens"]) != 2:
                fail(f"fleet (c): a request during the scale-down answered "
                     f"{r['status']} {r.get('error')}")
            trickle += 1
            time.sleep(0.5)
        out["scale_down_s"] = time.perf_counter() - t_idle
        asc.stop()
        out["scale_down_requests"] = trickle
        out["autoscale"] = dict(pool.metrics.autoscale)
        if out["autoscale"]["down"] < 1:
            fail(f"fleet (c): autoscale counters {out['autoscale']}")

        # (d) an externally managed worker: SIGSTOP past its lease, the
        # agent replaces it under a newer epoch, SIGCONT fences it
        ext = RemoteReplica(cfg, "external0", pool.metrics)
        pool.registry.register_slot(ext)
        pool.add_replica(ext)
        agent = LocalWorkerLauncher(worker_argv, cfg)
        addr = pool.registry.address
        t0 = time.perf_counter()
        ext_procs.append(agent.spawn("external0", addr,
                                     pool.registry.next_epoch("external0")))
        wait_for(ext.healthy, SERVE_SPAWN_S,
                 "fleet (d): the external worker never registered")
        out["external_spawn_s"] = time.perf_counter() - t0
        first_epoch = ext.epoch
        stop_prompt = serve_traffic(vocab, 1, lens=traffic_lens,
                                    seed=SEED + 3)[0][0]
        others = [t.name for t in pool.replicas if t is not ext]
        for name in others:  # place the requests on the external worker
            pool.quiesce(name)
        # one whole answer from it first, its counts read idle
        h = pool.submit(stop_prompt, max_new_tokens=NEW_TOKENS)
        ext_answer = h.result(timeout=SERVE_HTTP_S)
        if pool.replicas[h.replica_index] is not ext:
            fail("fleet (d): the request was not placed on the external "
                 "worker")
        fleet_kernels(pool, L, seen, "(d) external")
        served.add(ext_procs[0].pid)
        expiries = fleet["lease_expiries"]
        h = pool.submit(stop_prompt, max_new_tokens=NEW_TOKENS)
        it = iter(h.tokens(timeout=SERVE_HTTP_S))
        toks = [next(it)]
        for name in others:
            pool.resume_replica(name)
        if pool.replicas[h.replica_index] is not ext:
            fail("fleet (d): the stream was not placed on the external "
                 "worker")
        stopped = ext_procs[0]
        t_stop = time.perf_counter()
        os.kill(stopped.pid, signal.SIGSTOP)
        toks += list(it)
        out["stopped_stream_s"] = time.perf_counter() - t_stop
        checks["stopped"] = [(stop_prompt, toks)]
        if toks != ext_answer:
            fail(f"fleet (d): the stopped worker's stream gave {len(toks)} "
                 "tokens, not the external worker's whole answer")
        wait_for(lambda: fleet["lease_expiries"] > expiries,
                 cfg.heartbeat_timeout_s + cfg.lease_ttl_s + 30,
                 "fleet (d): the stopped worker's lease never expired")
        out["stop_declared_dead_s"] = time.perf_counter() - t_stop
        if ext.healthy() or stopped.poll() is not None:
            fail("fleet (d): the stopped worker's slot is healthy or its "
                 "process gone")
        t0 = time.perf_counter()
        ext_procs.append(agent.spawn("external0", addr,
                                     pool.registry.next_epoch("external0")))
        wait_for(lambda: ext.healthy() and ext.epoch > first_epoch,
                 SERVE_SPAWN_S, "fleet (d): the replacement never registered")
        out["replacement_s"] = time.perf_counter() - t0
        free, total = torch.cuda.mem_get_info()
        out["device_used_gb_three_workers"] = (total - free) / 1e9
        stale = fleet["stale_epoch_rejects"]
        os.kill(stopped.pid, signal.SIGCONT)
        try:
            rc = stopped.wait(timeout=120)
        except subprocess.TimeoutExpired:
            fail("fleet (d): the returning worker did not exit")
        if rc != EXIT_FENCED or fleet["stale_epoch_rejects"] != stale + 1:
            fail(f"fleet (d): the returning worker exited {rc} (want "
                 f"{EXIT_FENCED}), stale-epoch rejects "
                 f"{fleet['stale_epoch_rejects'] - stale}")
        if h.finish_reason != "length":
            fail(f"fleet (d): the stopped worker's stream finished "
                 f"{h.finish_reason!r}")
        out["epochs_external"] = {"stopped": first_epoch,
                                  "replacement": ext.epoch}
        out["returnee_rc"] = rc
        for name in others:  # the replacement answers the prompt
            pool.quiesce(name)
        r = http_complete(port, stop_prompt, False)
        for name in others:
            pool.resume_replica(name)
        if r["status"] != 200 or r["tokens"] != toks:
            fail("fleet (d): the replacement answers the stopped stream's "
                 "prompt differently")
        note_pids()
        served.add(ext_procs[1].pid)
        fleet_kernels(pool, L, seen, "(d)")
        out["fleet_counters"] = dict(fleet)
    finally:
        t0 = time.perf_counter()
        pool.drain(timeout=120.0)
        srv.shutdown()
        for p in ext_procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
        out["drain_s"] = time.perf_counter() - t0
    pids.update(p.pid for p in ext_procs)
    left = [pid for pid in pids if pid_alive(pid)]
    if left:
        fail(f"fleet (e): worker processes left after the drain: {left}")
    unread = sorted(pid for pid in pids if pid not in seen)
    idle = sorted(pid for pid in served
                  if not sum(seen.get(pid, {}).get("steps", {}).values()))
    if unread or idle:
        fail(f"fleet: workers {unread} never reported kernel counts, "
             f"workers {idle} that served report no engine step")
    out["worker_pids_seen"] = len(pids)
    out["worker_pids_served"] = len(served)
    out["launches"] = {
        name: sum(k["launches"][name] for k in seen.values())
        for name in ("paged_prefill_attention", "paged_decode_attention")}
    out["steps"] = {kind: sum(k["steps"].get(kind, 0) for k in seen.values())
                    for kind in ("mixed", "decode")}
    del srv, pool
    return out, checks


def parse_engine_argv(argv):
    import argparse

    from deepspeed_tpu_torch.serving.server import (add_engine_cli_args,
                                                    add_serving_cli_args)

    ap = argparse.ArgumentParser()
    add_engine_cli_args(ap)
    add_serving_cli_args(ap)
    return ap.parse_args(argv)


def walk_blocks(eng, tokens) -> list:
    """The cached full blocks of ``tokens`` on ``eng``, root first (the
    walk's pins released)."""
    blocks, _ = eng.prefix_cache.walk_full_blocks(list(tokens))
    eng.kv.allocator.free(blocks)
    return blocks


def fleet_disagg_stage(torch, pa, argv, traffic_lens, handoff_len: int,
                       remote_checks: dict) -> dict:
    """Stage 2: two in-process replicas, ``--replica_classes
    prefill,decode``, with the prefix cache on: the serving traffic plus
    prompt-heavy and decode-heavy requests through HTTP (``route_stats``
    must count both classes); then the ``handoff_len``-token request's
    prefix, prefilled on the prefill replica, handed to the decode
    replica (``handoff_prefix``): the imported blocks equal the source's
    bit for bit, the decode replica prefills only the uncovered tail (one
    mixed step from ``chunk_start`` = the covered tokens, B4 exactly one
    launch per layer for it), its first-token logits lie within
    TOL_SPEC_LOGITS_REL of max |logit| of a cache-off engine's, and its
    continuation is counted.  A lone cache-off engine on the same weights
    also holds stage 1's lone requests (the remote workers drew the same
    weights from the same seed): their tokens must be equal."""
    import numpy as np

    from deepspeed_tpu_torch.inference.v2.engine import InferenceEngineV2
    from deepspeed_tpu_torch.observability import tracer
    from deepspeed_tpu_torch.serving import ReplicaPool, ServingConfig
    from deepspeed_tpu_torch.serving.server import build_engine_factory

    args = parse_engine_argv(list(argv) + ["--enable_prefix_cache"])
    factory = build_engine_factory(args)
    scfg = ServingConfig(num_replicas=2, max_queue=64,
                         replica_classes=("prefill", "decode"))
    pool = ReplicaPool.build(factory, scfg).start()
    pool.wait_ready(timeout=60)
    pre, dec = pool.replicas
    if (pre.replica_class, dec.replica_class) != ("prefill", "decode"):
        fail(f"disagg: replica classes {pre.replica_class}, "
             f"{dec.replica_class}")
    eng = pre.engine
    mcfg, L, bs = eng.model_cfg, eng.model_cfg.num_layers, eng.cfg.block_size
    lone = InferenceEngineV2(mcfg, eng.params, dataclasses.replace(
        eng.cfg, enable_prefix_cache=False))
    out = {}
    # stage 1's lone requests against the lone engine
    for key, pairs in remote_checks.items():
        want = lone_tokens(lone, [p for p, _ in pairs])
        if [t for _, t in pairs] != want:
            fail(f"fleet: the remote workers' {key} requests differ from a "
                 "lone engine's tokens")
        out[f"remote_{key}_equal_lone"] = len(pairs)
    srv = start_server(pool, scfg, args.model)
    port = srv.server_port
    try:
        vocab = mcfg.vocab_size
        rng = np.random.default_rng(SEED + 4)
        heavy = [(rng.integers(0, vocab, size=n).tolist(), False)
                 for n in (traffic_lens[1], traffic_lens[1] * 9 // 10, 16,
                           24)]
        traffic = serve_traffic(vocab, lens=traffic_lens) + heavy
        route0 = dict(pool.route_stats)
        results, wall = run_clients(port, traffic)
        tokens = check_answers(results, traffic, "disagg")
        routed = {k: pool.route_stats[k] - route0.get(k, 0)
                  for k in ("prefill", "decode", "cache_hits")}
        if routed["prefill"] < 1 or routed["decode"] < 1:
            fail(f"disagg: route_stats counted {routed}")
        out.update(requests=len(traffic), completion_tokens=tokens,
                   wall_s=wall, http_tokens_per_s=tokens / wall,
                   routed=routed)

        # the handoff of one prefill-heavy request's prefix
        prompt = np.random.default_rng(SEED + 5).integers(
            0, vocab, size=handoff_len).tolist()
        cold = http_complete(port, prompt, True)
        if cold["status"] != 200 or len(cold["tokens"]) != NEW_TOKENS:
            fail(f"disagg: the handoff request answered {cold['status']}")
        full = (handoff_len // bs) * bs
        src = walk_blocks(eng, prompt)
        if len(src) * bs != full:
            fail(f"disagg: the prefill replica caches {len(src)} blocks of "
                 f"the {handoff_len}-token prompt, want {full // bs}")
        wait_for(lambda: pool.queue_depth() == 0 and all(
            t.num_running() == 0 for t in pool.replicas), 60,
            "disagg: the pool never went idle")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        covered = pool.handoff_prefix(pre.name, dec.name, prompt)
        torch.cuda.synchronize()
        handoff_s = time.perf_counter() - t0
        deng = dec.engine
        dst = walk_blocks(deng, prompt)
        if covered != full or len(dst) != len(src):
            fail(f"disagg: the handoff covered {covered} tokens in "
                 f"{len(dst)} blocks, want {full}")
        for a, b in zip(src, dst):
            ka, kb = eng._read_kv_block(a), deng._read_kv_block(b)
            if not all(torch.equal(ka[n], kb[n]) for n in ("k", "v")):
                fail(f"disagg: imported block {b} differs from the source's "
                     f"block {a}")
        # the decode replica serves the prompt from the imported prefix
        probe = HierProbe(torch, deng, True, False)
        before = deng.prefix_stats()
        pa.reset_counts()
        tracer.clear()
        got = dec.broker.submit(prompt, max_new_tokens=NEW_TOKENS).result(
            timeout=SERVE_HTTP_S)
        after = deng.prefix_stats()
        kinds = [sp.attrs["kind"] for sp in tracer.spans(name="engine/step")]
        (uid,) = probe.picks
        chunks = [(s, n) for s, n in probe.picks[uid] if s < handoff_len]
        skipped = (after["prefill_tokens_skipped"]
                   - before["prefill_tokens_skipped"])
        if (chunks != [(covered, handoff_len - covered)] or skipped != covered
                or pa.LAUNCHES["paged_prefill_attention"]
                != L * kinds.count("mixed") or kinds.count("mixed") != 1
                or pa.LAUNCHES["paged_decode_attention"]
                != L * kinds.count("decode")
                or any(pa.PLAIN_CALLS.values())):
            fail(f"disagg: the decode replica prefilled {chunks} (skipped "
                 f"{skipped}) in steps {kinds} with launches "
                 f"{dict(pa.LAUNCHES)}, plain {dict(pa.PLAIN_CALLS)}")
        ref_logits = first_token_logits(torch, lone, [prompt])[0]
        rel = logits_rel(probe.first[uid][1], ref_logits)
        if rel > TOL_SPEC_LOGITS_REL:
            fail(f"disagg: the decode replica's first-token logits are "
                 f"{rel:.3e} of max |logit| from a cache-off engine's "
                 f"(limit {TOL_SPEC_LOGITS_REL})")
        want = lone_tokens(lone, [prompt])[0]
        out.update(
            handoff_len=handoff_len, handoff_tokens=covered,
            handoff_blocks=len(dst), handoff_ms=handoff_s * 1e3,
            handoff_ms_per_block=handoff_s * 1e3 / len(dst),
            cold_ttft_ms=cold["ttft_s"] * 1e3,
            first_logits_rel_vs_cache_off=rel,
            decode_replica_prefilled=handoff_len - covered,
            decode_replica_launches=dict(pa.LAUNCHES),
            continuation_equal=f"{int(got == want)}/1")
    finally:
        pool.shutdown()
        srv.shutdown()
    del srv, pool, factory, eng, lone, pre, dec
    free_cache(torch)
    return out


def fleet_rollout_stage(torch, argv, layers: int) -> dict:
    """Stage 3: two in-process replicas of the model cut to ``layers``
    layers (0: not cut) on weights A; ``publish_params`` of weights B
    (another seed) into ``build/``; a rollout with a wrong
    ``probe_expected`` halts (``RolloutHalted``) and leaves both replicas
    on A (their tokens equal a lone engine on A); then ``rolling_swap``
    while ROLLOUT_STREAMS streams are in flight (run once before alone, so
    that ``device_gb`` accounts for the swap's peak): no stream fails, each
    stream's tokens all come from one weight generation (the engine's
    ``params_version`` at each step that gave it tokens, recorded by the
    broker), its first token is that generation's lone engine's (its
    continuation counted: concurrent bf16 rows may part from a lone
    run's, ROADMAP C4), the probe's tokens are B's, and each replica then
    serves B's tokens."""
    import shutil
    import threading

    from deepspeed_tpu_torch.inference.v2.engine import (InferenceEngineV2,
                                                         V2Config)
    from deepspeed_tpu_torch.models import transformer as tfm
    from deepspeed_tpu_torch.observability import tracer
    from deepspeed_tpu_torch.runtime.checkpoint.engine import \
        flatten_with_paths
    from deepspeed_tpu_torch.serving import (ReplicaPool, RolloutHalted,
                                             ServingConfig, publish_params,
                                             rolling_swap)

    args = parse_engine_argv(argv)
    over = {"num_layers": layers} if layers else {}
    mcfg = tfm.get_config(args.model, dtype=args.dtype, **over)
    v2 = V2Config(max_tokens_per_step=args.max_tokens_per_step,
                  max_seqs=args.max_seqs, block_size=args.block_size,
                  num_blocks=args.num_blocks,
                  max_blocks_per_seq=args.max_blocks_per_seq,
                  dtype=args.dtype)

    def weights(seed):
        return tfm.init_params(mcfg, torch.Generator(
            device="cuda").manual_seed(seed), device="cuda")

    def gb():
        return torch.cuda.memory_allocated() / 1e9

    # the card's memory at each step, to account for the swap's peak
    mem = {"front_before": gb()}
    params_a, params_b = weights(SEED), weights(SEED + 7)
    mem["weights_a_b"] = gb()
    scfg = ServingConfig(num_replicas=2, max_queue=64,
                         rollout_drain_timeout_s=SERVE_HTTP_S,
                         rollout_probe_timeout_s=SERVE_HTTP_S)
    pool = ReplicaPool.build(
        lambda: InferenceEngineV2(mcfg, params_a, v2), scfg).start()
    pool.wait_ready(timeout=60)
    lone_a = InferenceEngineV2(mcfg, params_a, v2)
    lone_b = InferenceEngineV2(mcfg, params_b, v2)
    mem["four_engines"] = gb()
    traffic = serve_traffic(mcfg.vocab_size, ROLLOUT_STREAMS + 1,
                            lens=(17, 200), seed=SEED + 8)
    prompts = [p for p, _ in traffic]
    probe = prompts.pop()
    want_a, want_b = lone_tokens(lone_a, prompts + [probe]), \
        lone_tokens(lone_b, prompts + [probe])
    n_probe = scfg.rollout_probe_tokens
    out = {"layers": mcfg.num_layers}
    root = os.path.join(BUILD_DIR, "fleet_rollout")
    shutil.rmtree(root, ignore_errors=True)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt = publish_params(params_b, root, "weights_b")
        out["publish_s"] = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(ckpt, f))
                     for f in os.listdir(ckpt))
        out.update(checkpoint_gb=nbytes / 1e9,
                   publish_gb_per_s=nbytes / 1e9 / out["publish_s"])

        def each_replica(want, what):
            for t in pool.replicas:
                got = t.submit(prompt=prompts[0],
                               max_new_tokens=NEW_TOKENS).result(
                                   timeout=SERVE_HTTP_S)
                if got != want[0]:
                    fail(f"rollout: {t.name} {what}")

        # a rollout whose probe cannot match halts and rolls back
        t0 = time.perf_counter()
        try:
            rolling_swap(pool, ckpt, probe,
                         probe_expected=[-1] * n_probe)
        except RolloutHalted:
            pass
        else:
            fail("rollout: a wrong probe_expected did not halt the rollout")
        out["halted_rollout_s"] = time.perf_counter() - t0
        if pool._quiesced:
            fail(f"rollout: {pool._quiesced} left out of rotation")
        each_replica(want_a, "does not serve the old weights after the "
                     "halted rollout's rollback")

        # the rollout under load; each replica's weight generation
        # (``params_version``) on A, then on B
        ver_a = {i: t.engine.params_version
                 for i, t in enumerate(pool.replicas)}
        results, versions, errors = [None] * len(prompts), \
            [None] * len(prompts), []

        def stream(i):
            try:
                h = pool.submit(prompts[i], max_new_tokens=NEW_TOKENS)
                results[i] = h.result(timeout=SERVE_HTTP_S)
                versions[i] = h.weight_versions
            except Exception as e:  # noqa: BLE001 — gated below
                errors.append(repr(e))

        def streams(during):
            threads = [threading.Thread(target=stream, args=(i,))
                       for i in range(len(prompts))]
            for th in threads:
                th.start()
            res = during()
            for th in threads:
                th.join(timeout=SERVE_HTTP_S)
            return res

        # the streams alone, for the memory they take beside the swap
        mem["before_swap"] = gb()
        torch.cuda.reset_peak_memory_stats()
        streams(lambda: None)
        mem["peak_streams_alone"] = torch.cuda.max_memory_allocated() / 1e9
        tracer.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        summary = streams(lambda: rolling_swap(pool, ckpt, probe))
        out["rollout_s"] = time.perf_counter() - t0
        mem["peak_during_swap"] = torch.cuda.max_memory_allocated() / 1e9
        mem["after_swap"] = gb()
        out["peak_gb_during_swap"] = mem["peak_during_swap"]
        out["params_gb"] = sum(
            v.numel() * v.element_size() for v in
            flatten_with_paths(params_b).values()) / 1e9
        out["device_gb"] = mem
        if errors or any(r is None or len(r) != NEW_TOKENS
                         for r in results):
            fail(f"rollout: streams failed during the swap: {errors[:3]}")
        ver_b = {i: t.engine.params_version
                 for i, t in enumerate(pool.replicas)}
        gens = []
        for r, vs, a, b in zip(results, versions, want_a, want_b):
            # one engine step's generation for every token of the stream
            if vs is None or len(vs) != 1:
                fail(f"rollout: a stream's tokens came from weight "
                     f"generations {vs} (replica, version)")
            (i, v), = vs
            gen, want = (("a", a) if v == ver_a[i] != ver_b[i]
                         else ("b", b) if v == ver_b[i] else (None, None))
            if gen is None or r[0] != want[0]:
                fail(f"rollout: a stream on replica {i} at version {v} "
                     f"(A {ver_a[i]}, B {ver_b[i]}) starts with {r[0]}, "
                     f"A's lone engine {a[0]}, B's {b[0]}")
            gens.append(gen)
        if summary["probe_tokens"] != want_b[-1][:n_probe] or \
                sorted(summary["swapped"]) != sorted(
                    t.name for t in pool.replicas):
            fail(f"rollout: probe tokens {summary['probe_tokens']}, want "
                 f"{want_b[-1][:n_probe]}; swapped {summary['swapped']}")
        each_replica(want_b, "does not serve the new weights after the "
                     "rollout")
        ev = {}
        for sp in tracer.spans():
            if sp.name.startswith("rollout/") and "replica" in sp.attrs:
                ev[sp.attrs["replica"], sp.name] = sp.t_start
        out["swap_s"] = {t.name: ev[t.name, "rollout/swap"]
                         - ev[t.name, "rollout/drain"]
                         for t in pool.replicas}
        out["probe_s"] = {t.name: ev[t.name, "rollout/probe_ok"]
                          - ev[t.name, "rollout/swap"]
                          for t in pool.replicas}
        out.update(streams=len(prompts), stream_generations="".join(gens),
                   streams_equal_lone=sum(
                       r == (a if g == "a" else b) for r, g, a, b in
                       zip(results, gens, want_a, want_b)))
    finally:
        pool.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    del pool, lone_a, lone_b, params_a, params_b
    free_cache(torch)
    return out


def fleet_adapter_stage(torch, argv, traffic_lens, rank: int) -> dict:
    """Stage 4: two in-process replicas with adapter slots; ``POST
    /v1/adapters`` registers one of ``adapter_packs``' seeded packs
    (published with ``publish_adapter``) on both; requests naming it, one
    at a time, have first-token logits within TOL_SPEC_LOGITS_REL of max
    |logit| of an engine on the pack's merged weights, and past that
    limit from the base engine's; after ``retire`` a request naming it is
    refused (400)."""
    import shutil

    from deepspeed_tpu_torch.inference.v2.engine import InferenceEngineV2
    from deepspeed_tpu_torch.linear.optimized_linear import (
        graft_adapter_pack, merge_lora_weights)
    from deepspeed_tpu_torch.serving import ReplicaPool, ServingConfig
    from deepspeed_tpu_torch.serving.adapters import (load_adapter_pack,
                                                      publish_adapter)
    from deepspeed_tpu_torch.serving.server import (build_adapter_factory,
                                                    build_engine_factory)

    args = parse_engine_argv(list(argv) + ["--adapter_slots", "8",
                                           "--adapter_rank", str(rank)])
    scfg = ServingConfig(num_replicas=2, max_queue=64)
    pool = ReplicaPool.build(build_engine_factory(args), scfg,
                             adapter_factory=build_adapter_factory(args))
    pool.start()
    pool.wait_ready(timeout=60)
    engines = [t.engine for t in pool.replicas]
    mcfg, params = engines[0].model_cfg, engines[0].params
    root = os.path.join(BUILD_DIR, "fleet_adapters")
    shutil.rmtree(root, ignore_errors=True)
    pack = adapter_packs(mcfg, 1, rank)[0]
    ckpt = publish_adapter({t: {"lora_a": a, "lora_b": b}
                            for t, (a, b) in pack.items()}, root, "tenant0")
    v2 = dataclasses.replace(engines[0].cfg, adapter_slots=0,
                             adapter_rank=0)
    srv = start_server(pool, scfg, args.model)
    port = srv.server_port
    out = {"rank": rank}
    try:
        status, body = http_post(port, "/v1/adapters", {
            "op": "register", "adapter": "tenant0", "ckpt_dir": ckpt})
        names = sorted(t.name for t in pool.replicas)
        if status != 200 or sorted(body["registered"]) != names \
                or body["failed"]:
            fail(f"fleet adapters: register answered {status} {body}")
        probes = [HierProbe(torch, e, True, False) for e in engines]
        prompts = [p for p, _ in serve_traffic(mcfg.vocab_size, 3,
                                               lens=traffic_lens,
                                               seed=SEED + 10)]
        served = []
        for p in prompts:
            seen = [set(pr.first) for pr in probes]
            r = http_complete(port, p, False, extra={"adapter": "tenant0"})
            if r["status"] != 200 or len(r["tokens"]) != NEW_TOKENS:
                fail(f"fleet adapters: a request naming the adapter "
                     f"answered {r['status']} {r.get('error')}")
            new = [(pr, u) for pr, s in zip(probes, seen)
                   for u in pr.first if u not in s]
            (pr, u), = new
            served.append(pr.first[u][1])
        merged = InferenceEngineV2(mcfg, merge_lora_weights(
            graft_adapter_pack(params, load_adapter_pack(ckpt, mcfg, rank))),
            v2)
        ref = first_token_logits(torch, merged, prompts)
        del merged
        base = first_token_logits(torch, InferenceEngineV2(mcfg, params, v2),
                                  prompts)
        rel = [logits_rel(s, m) for s, m in zip(served, ref)]
        moved = [logits_rel(s, b) for s, b in zip(served, base)]
        if max(rel) > TOL_SPEC_LOGITS_REL or \
                min(moved) <= TOL_SPEC_LOGITS_REL:
            fail(f"fleet adapters: first-token logits {rel} of max |logit| "
                 f"from merged weights, {moved} from the base (limit "
                 f"{TOL_SPEC_LOGITS_REL})")
        status, body = http_post(port, "/v1/adapters", {
            "op": "retire", "adapter": "tenant0"})
        if status != 200 or sorted(body["retired"]) != names:
            fail(f"fleet adapters: retire answered {status} {body}")
        r = http_complete(port, prompts[0], False,
                          extra={"adapter": "tenant0"})
        if r["status"] != 400:
            fail(f"fleet adapters: a request naming the retired adapter "
                 f"answered {r['status']}")
        out.update(registered=len(names), requests=len(prompts),
                   logits_rel_vs_merged=rel, logits_rel_vs_base=moved,
                   retired_refusal=r["error"]["error"]["type"])
    finally:
        pool.shutdown()
        srv.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    del srv, pool, engines, params
    free_cache(torch)
    return out


def fleet_bench_stage(torch, mg, argv, gemm_shapes) -> dict:
    """Stage 5: ``serving/bench.py``.  ``run_gemm_sweep`` (``--mode gemm``)
    at ``gemm_shapes``, M in BENCH_GEMM_MS, bits 8/4/6, group QUANT_GROUP:
    every cell of the kernel within ``bench.GEMM_TOL`` (TOL_BF16's limits,
    the absolute one taken of the largest output: the sweep's weights are
    unit normal) of dequantize-then-matmul in the kernel's numerics (its
    max error against the timed bf16 fallback is reported);
    then ``--mode serving --rates BENCH_RATES`` (BENCH_DURATION_S each)
    against a server
    subprocess on ``argv``, results written under ``build/``: no request
    failed."""
    import io

    from deepspeed_tpu_torch.serving import bench

    warmup, iters = 1, 10
    before, before_wgmma = dict(mg.LAUNCHES), dict(mg.WGMMA_LAUNCHES)
    before_decode = dict(mg.DECODE_LAUNCHES)
    sweep = bench.run_gemm_sweep(
        ms=BENCH_GEMM_MS, shapes=tuple(gemm_shapes), bits_list=(8, 4, 6),
        groups=(QUANT_GROUP,), warmup=warmup, iters=iters, device="cuda")
    launches = {k: mg.LAUNCHES[k] - before[k] for k in before}
    wgmma = {k: mg.WGMMA_LAUNCHES[k] - before_wgmma[k] for k in before_wgmma}
    decode = {k: mg.DECODE_LAUNCHES[k] - before_decode[k]
              for k in before_decode}
    # launches by M: each cell calls the kernel once to check it, then
    # warm-up and timed calls; held against the counted totals (M > 16
    # runs mixed_gemm_wgmma_kernel, M <= 16 mixed_gemm_decode_kernel)
    per_cell = 1 + warmup + iters
    by_m = {}
    for name, bits in GEMM_KERNELS.items():
        if not name.startswith("mixed_gemm"):
            continue
        want = {m: per_cell * sum(c["m"] == m and c["bits"] == bits
                                  for c in sweep["cells"])
                for m in BENCH_GEMM_MS}
        if (launches[name] != sum(want.values())
                or wgmma[name] != sum(n for m, n in want.items() if m > 16)
                or decode[name] != sum(n for m, n in want.items()
                                       if m <= 16)):
            fail(f"bench gemm: {name} launched {launches[name]} "
                 f"({wgmma[name]} wgmma, {decode[name]} decode), want "
                 f"{want} by M")
        by_m[name] = want
    bad = [c for c in sweep["cells"] if not c["within_tol"]]
    if bad:
        fail(f"bench gemm: {len(bad)} cells outside {bench.GEMM_TOL} of "
             f"dequantize-then-matmul, first {bad[0]}")
    free_cache(torch)
    path = os.path.join(BUILD_DIR, "fleet_bench.json")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = bench.main(["--mode", "serving", "--rates", BENCH_RATES,
                         "--duration_s", str(BENCH_DURATION_S),
                         "--replicas", "1", "--server_args", " ".join(argv),
                         "--out", path])
    with open(path) as f:
        serving = json.load(f)["serving"]
    if rc != 0 or any(p["failed"] or not p["completed"]
                      for p in serving["sweep"]):
        fail(f"bench serving: rc {rc}, points {serving['sweep']}")
    return {"gemm_cells": len(sweep["cells"]), "gemm_launches": launches,
            "gemm_wgmma_launches": wgmma, "gemm_launches_by_m": by_m,
            "gemm": [{k: c[k] for k in ("m", "n", "k", "bits", "kernel_s",
                                        "dequant_dot_s", "rel_err")}
                     for c in sweep["cells"]],
            "serving": serving["sweep"], "serving_out": path}


def run_fleet_phase(torch, pa, mg, card: str, argv=SERVE_ARGV,
                    traffic_lens=SERVE_LEN, handoff_len: int = HANDOFF_LEN,
                    rollout_layers: int = ROLLOUT_LAYERS,
                    adapter_rank: int = 16, gemm_shapes=None) -> dict:
    """The serving fleet on the card (A9's second half), five stages:
    remote workers with the autoscaler, disaggregated replicas, a rolling
    swap, fleet adapter ops and the bench (each function's docstring has
    its gates).  Fails unless the front process holds no pool when the
    phase starts and after each stage (a stage's engines can outlive it
    in a reference cycle until the next collection: its memory would be
    counted in the next stage's).  ``argv`` etc.: a smaller model (the
    GPU tests)."""
    def front_bytes(when: str) -> int:
        free_cache(torch)
        held = torch.cuda.memory_allocated()
        if held > 2**30:
            fail(f"fleet: the front process still holds {held / 1e9:.2f} "
                 f"GB {when}")
        return held

    held = front_bytes("before its workers start")
    free, total = torch.cuda.mem_get_info()
    out = {"card": card, "front_bytes": held, "device_free_gb": free / 1e9,
           "device_total_gb": total / 1e9}
    args = parse_engine_argv(argv)

    def stage(name, result):
        out[name] = result
        print(f"fleet {name} ({card}): " + json.dumps(result), flush=True)
        front_bytes(f"after the {name} stage")

    remote, checks = fleet_remote_stage(torch, args, argv, traffic_lens)
    stage("remote", remote)
    stage("disagg", fleet_disagg_stage(torch, pa, argv, traffic_lens,
                                       handoff_len, checks))
    launches = dict(out["remote"]["launches"])
    for k, v in out["disagg"]["decode_replica_launches"].items():
        launches[k] += v
    stage("rollout", fleet_rollout_stage(torch, argv, rollout_layers))
    stage("adapters", fleet_adapter_stage(torch, argv, traffic_lens,
                                          adapter_rank))
    stage("bench", fleet_bench_stage(
        torch, mg, argv, gemm_shapes or GEMM_SHAPES.values()))
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# fp16 serving: B4, B5, B6, B7, B8 in f16, and B1's biases and B9 in f16
# ---------------------------------------------------------------------------

# An fp16 engine's first-token logits against an f32 engine's on the same
# seeded f16 weights (the f32 engine reads them exactly), and a small f16
# model's card against CPU: max |a - b| over max |b| per request.  Stated
# before the phase's first chip run: the bf16 gate (5e-2) holds two bf16
# engines whose activations both round at 2**-8; here one side rounds at
# 2**-11 and the other not at all, so the expected difference is ~8x
# smaller (~0.3%), and 2e-2 leaves a 5x margin while a lost block, head or
# layer still moves logits by their own size.  W8A16: both engines round
# every projection's x to bf16 (the reference's numerics), so an f16
# difference upstream flips bf16 roundings: the bf16 gate.
TOL_LOGITS_F16_REL = 2e-2
TOL_LOGITS_F16_QUANT_REL = 5e-2
# OpenFold's mask value in low precision (openfold/config.py, low_prec:
# inf = 1e4): -1e9 is -inf in f16
EVO_F16_MASK = -1e4


def check_evoformer_f16(torch, fa, ev, flush) -> dict:
    """B1's f16 forward with its biases at OpenFold's three attention calls
    (f16 q, k, v and biases; the mask bias at EVO_F16_MASK):
    ``evoformer_attention`` forward and backward on the card (one biased
    launch per call, no plain call, finite output and gradients); per call
    the kernel's o against ``flash_fwd_plain`` within the f16 limit (the
    padded sequence's within the f32 spacing of its scores: see below) and
    its lse within 1e-4 + 1e-5 |lse| (f32 on both sides; the padded
    sequence's lse lies near -1e4, where the f32 spacing is 1e-3); kernel /
    plain / library (fp16 SDPA with b1 + b2 as its mask) / bound ms."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    inputs = {}
    for name, (shape, h1, h2) in EVO_CALLS.items():
        q, k, v, g, b1, b2 = evoformer_inputs(
            torch, shape, h1, h2, gen, EVO_PADDED if name == "msa_row"
            else None)
        half = [None if t is None else t.float().clamp(min=EVO_F16_MASK)
                .half() for t in (q, k, v, g, b1, b2)]
        inputs[name] = half
        del q, k, v, g, b1, b2
    torch.cuda.synchronize()
    fa.reset_counts()
    for name, (q, k, v, g, b1, b2) in inputs.items():  # the main path
        leaves = [t.requires_grad_() for t in (q, k, v, b1, b2)
                  if t is not None]
        out = ev.evoformer_attention(q, k, v, [b1, b2])
        grads = torch.autograd.grad(out, leaves, g)
        if not all(bool(torch.isfinite(t).all()) for t in (out, *grads)):
            fail(f"evoformer {name} (f16): output or gradients not finite")
        for t in leaves:
            t.requires_grad_(False)
    torch.cuda.synchronize()
    launches, bias_launches = dict(fa.LAUNCHES), dict(fa.BIAS_LAUNCHES)
    want = len(EVO_CALLS)
    if bias_launches["flash_fwd_bias"] != want or \
            launches != {"flash_fwd": want, "flash_bwd_dkdv": 0,
                         "flash_bwd_dq": 0} or any(fa.PLAIN_CALLS.values()):
        fail(f"evoformer (f16): launches {launches}, bias {bias_launches}, "
             f"plain {fa.PLAIN_CALLS}; want {want} biased forwards only")
    calls = {}
    for name, (q, k, v, g, b1, b2) in inputs.items():
        shape = EVO_CALLS[name][0]
        B, N, L, Hh, Dh = shape
        qf, kf, vf, mask, scale, bkv, bqk = ev.flash_args(q, k, v, b1, b2)
        o, lse = fa.flash_fwd(qf, kf, vf, mask, scale, bkv, bqk)
        o_p, lse_p = fa.flash_fwd_plain(qf, kf, vf, mask, scale, bkv, bqk)
        torch.cuda.synchronize()
        err = compare(lse, lse_p, (1e-4, 1e-5), f"evoformer {name} lse (f16)")
        if name == "msa_row":
            # the padded sequence: every score sits near EVO_F16_MASK,
            # where f32's spacing is 2**-10 on both sides, so each p
            # carries a relative error up to |EVO_F16_MASK| 2**-24 and o
            # may move by twice that times max |v| (the others: f16 limit)
            o5, o5_p = o.reshape(shape), o_p.reshape(shape)
            keep = [n for n in range(N) if n != EVO_PADDED]
            pad_atol = 2 * -EVO_F16_MASK * 2.0 ** -24 * \
                v[:, EVO_PADDED].float().abs().max().item()
            err = max(err, compare_f16(o5[:, keep], o5_p[:, keep],
                                       f"evoformer {name} o (f16)"),
                      compare(o5[:, EVO_PADDED], o5_p[:, EVO_PADDED],
                              (pad_atol, F16_RTOL),
                              f"evoformer {name} padded sequence o (f16)"))
            del o5, o5_p
        else:
            err = max(err, compare_f16(o, o_p, f"evoformer {name} o (f16)"))
        del o, lse, o_p, lse_p
        qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (qf, kf, vf))
        am = None
        if b1 is not None:
            am = b1.reshape(B * N, 1, 1, L)
        if b2 is not None:
            pair = b2.reshape(B, 1, Hh, L, L).expand(B, N, Hh, L, L) \
                .reshape(B * N, Hh, L, L)
            am = pair if am is None else am + pair
        nbytes = (4 * q.numel() * 2 + (0 if bkv is None else bkv.numel() * 2)
                  + (0 if bqk is None else bqk.numel() * 2)
                  + B * N * Hh * L * 4)
        b_ms, b_by = bound(nbytes, 4 * Dh * L * L * Hh * B * N)
        calls[name] = {
            "name": "flash_fwd_bias", "dtype": "float16",
            "kernel": "flash_fwd_tc_kernel<__half, D, B1, B2>",
            "shape": list(shape), "bias1": b1 is not None,
            "bias2": b2 is not None, "max_abs_err": err,
            "max_abs_err_f32": None,
            "ms": time_ms(lambda: fa.flash_fwd(qf, kf, vf, mask, scale, bkv,
                                               bqk), torch, flush),
            "plain_ms": time_ms(lambda: fa.flash_fwd_plain(
                qf, kf, vf, mask, scale, bkv, bqk), torch, flush, iters=5,
                warmup=1),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=am), torch, flush),
            "bound_ms": b_ms, "bound_by": b_by}
        del qs, ks, vs, am
    del inputs
    return {"calls": calls, "launches": bias_launches["flash_fwd_bias"]}


def f16_serve(torch, pa, mg, gm, cfg, params, v2, prompts, what) -> dict:
    """One engine of the fp16 phase: ``serve`` on ``prompts``, then the
    gates: NEW_TOKENS in-vocab tokens per request, finite mixed-step
    logits, B4 launched once per layer and mixed step and B5 a positive
    multiple of the layers, no plain call; quantized, B6 exactly 7 x the
    paged launches (``mixed_gemm_wgmma_kernel`` 7 x prefill,
    ``mixed_gemm_decode_kernel`` 7 x decode) and no envelope call; dropless
    MoE, B8 exactly 3 x the paged launches (``grouped_matmul_wgmma_kernel``
    3 x prefill).  B4 and B5 are held to the steps the engine ran: B4 to
    the layers times the ``engine/step`` spans of kind mixed, B5 to the
    layers times the decode bodies, counted here around the engine's
    decode body and equal to the most tokens a request still needed when
    the prefill phase ended.  Counts are reset just before the requests
    are queued and read just after the last token."""
    from deepspeed_tpu_torch.inference.v2.engine import InferenceEngineV2
    from deepspeed_tpu_torch.observability import tracer

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = InferenceEngineV2(cfg, params, v2)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    bodies = [0]
    decode_body = eng._decode

    def counted_decode(*args, **kwargs):
        bodies[0] += 1
        return decode_body(*args, **kwargs)

    eng._decode = counted_decode
    for mod in (pa, mg, gm):
        mod.reset_counts()
    tracer.clear()
    run = serve(torch, eng, prompts)
    mixed = [sp.attrs["kind"] for sp in
             tracer.spans(name="engine/step")].count("mixed")
    paged = dict(pa.LAUNCHES)
    gemm = {"mixed": dict(mg.LAUNCHES), "mixed_wgmma": dict(mg.WGMMA_LAUNCHES),
            "mixed_decode": dict(mg.DECODE_LAUNCHES),
            "grouped": dict(gm.LAUNCHES),
            "grouped_wgmma": dict(gm.WGMMA_LAUNCHES)}
    plain = {**pa.PLAIN_CALLS, **mg.PLAIN_CALLS, **gm.PLAIN_CALLS,
             **{f"dequant_{k}": n for k, n in mg.DEQUANT_CALLS.items()}}
    peak = torch.cuda.max_memory_allocated() / 1e9
    del eng
    for uid, prompt in zip(run["uids"], prompts):
        toks = run["results"][uid]
        new = toks[len(prompt):]
        if toks[:len(prompt)] != prompt or len(new) != NEW_TOKENS or not \
                all(0 <= t < cfg.vocab_size for t in new):
            fail(f"{what}: request {uid}: {len(new)} new tokens, want "
                 f"{NEW_TOKENS} in the vocab")
    if not run["probes_finite"] or not all(run["probes_finite"]):
        fail(f"{what}: a mixed step's logits were not finite")
    if any(plain.values()):
        fail(f"{what}: a plain version ran: {plain}")
    L = cfg.num_layers
    pre, dec = paged["paged_prefill_attention"], \
        paged["paged_decode_attention"]
    if pre != L * mixed or mixed != run["mixed_steps"] or \
            dec != L * bodies[0] or bodies[0] != run["decode_bodies_needed"] \
            or not bodies[0]:
        fail(f"{what}: {pre} prefill launches for {mixed} mixed steps "
             f"({run['mixed_steps']} in the prefill phase) and {dec} decode "
             f"launches for {bodies[0]} decode bodies "
             f"({run['decode_bodies_needed']} needed) of {L} layers")
    launches = dict(paged)
    if v2.quantize_bits:
        name = mg._KERNEL_NAMES[v2.quantize_bits]
        got = (gemm["mixed"][name], gemm["mixed_wgmma"][name],
               gemm["mixed_decode"][name])
        if got != (PROJECTIONS * (pre + dec), PROJECTIONS * pre,
                   PROJECTIONS * dec):
            fail(f"{what}: {name} launches (all, wgmma, decode) {got} for "
                 f"{pre} prefill and {dec} decode launches, want "
                 f"{PROJECTIONS} each")
        launches.update({name: got[0], f"{name}_wgmma": got[1],
                         f"{name}_decode": got[2]})
    if getattr(cfg, "num_experts", 0):
        got = (gemm["grouped"]["grouped_matmul"],
               gemm["grouped_wgmma"]["grouped_matmul"])
        if got != (3 * (pre + dec), 3 * pre):
            fail(f"{what}: grouped_matmul launches (all, wgmma) {got} for "
                 f"{pre} prefill and {dec} decode launches, want 3 each")
        launches.update({"grouped_matmul": got[0],
                         "grouped_matmul_wgmma": got[1]})
    prompt_tokens = sum(len(p) for p in prompts)
    decode_tokens = len(prompts) * NEW_TOKENS - run["prefill_emitted"]
    return {"build_s": build_s, "mixed_steps": run["mixed_steps"],
            "decode_bodies": bodies[0], "prefill_s": run["prefill_s"],
            "prefill_tokens_per_s": prompt_tokens / run["prefill_s"],
            "decode_s": run["decode_s"],
            "decode_tokens_per_s": decode_tokens / run["decode_s"],
            "peak_mem_gb": peak, "launches": launches,
            "tokens": [run["results"][u][len(p):]
                       for u, p in zip(run["uids"], prompts)]}


def f16_against_f32(torch, cfg, params, v2, prompts, tol: float,
                    what: str) -> dict:
    """First-token logits of ``prompts`` (served together) on an fp16 engine
    and then, the first one freed, on an f32 engine from the same weights:
    each request's max |fp16 - f32| over its max |f32 logit| within
    ``tol``; the requests whose first greedy tokens agree are counted."""
    from deepspeed_tpu_torch.inference.v2.engine import InferenceEngineV2

    rows = {}
    for dt in ("float16", "float32"):
        eng = InferenceEngineV2(cfg, params, dataclasses.replace(v2, dtype=dt))
        rows[dt] = [r.float() for r in first_token_logits(torch, eng,
                                                           prompts)]
        del eng
        free_cache(torch)
    rel = [logits_rel(a, b) for a, b in zip(rows["float16"], rows["float32"])]
    if not all(bool(torch.isfinite(r).all()) for r in rows["float16"]) or \
            not max(rel) <= tol:
        fail(f"{what}: fp16 first-token logits differ from the f32 "
             f"engine's by {max(rel)} of max |logit| (limit {tol})")
    same = sum(int(a.argmax() == b.argmax())
               for a, b in zip(rows["float16"], rows["float32"]))
    return {"first_logits_rel_vs_f32": max(rel),
            "first_logits_rel_vs_f32_by_request": rel,
            "first_tokens_equal_f32": same, "requests": len(prompts)}


def run_fp16_engines(torch, pa, mg, gm, card: str, cfg=None, moe_cfg=None,
                     prompt_lens=PROMPT_LENS, v1_shape=(V1_BATCH, V1_PROMPT),
                     v2=None) -> dict:
    """fp16 serving through the normal entry points (defaults: llama3-8b at
    full width and depth, dropless Mixtral-8x7B at full width and
    MOE_LAYERS layers, the bf16 cell's V2Config and traffic; weights drawn
    from the seed straight into f16): ``V2Config(dtype="float16")`` plain
    and W8A16, each gated (``f16_serve``) and held against an f32 engine
    on the same weights (``f16_against_f32``); the v1 engine in fp16 W8A16
    (``init_inference``: exact B6 launches, first-token logits against an
    fp16 W8A16 v2 engine's); then dropless Mixtral in fp16, gated."""
    import numpy as np

    from deepspeed_tpu_torch.inference.v2.engine import V2Config
    from deepspeed_tpu_torch.models import transformer as tfm

    t_phase = time.perf_counter()
    cfg = cfg or tfm.get_config("llama3-8b", dtype="float16")
    v2 = v2 or V2Config(max_tokens_per_step=256, max_seqs=8, block_size=BS,
                        num_blocks=NB, max_blocks_per_seq=MB,
                        dtype="float16")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in prompt_lens]
    free_cache(torch)
    params = tfm.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), device="cuda", dtype=torch.float16)
    out = {"layers": cfg.num_layers, "card": card}
    out["fp16"] = f16_serve(torch, pa, mg, gm, cfg, params, v2, prompts,
                            "fp16 engine")
    out["fp16"].update(f16_against_f32(torch, cfg, params, v2, prompts,
                                       TOL_LOGITS_F16_REL, "fp16 engine"))
    free_cache(torch)
    q8 = dataclasses.replace(v2, quantize_bits=8)
    out["fp16_w8a16"] = f16_serve(torch, pa, mg, gm, cfg, params, q8,
                                  prompts, "fp16 W8A16 engine")
    out["fp16_w8a16"].update(f16_against_f32(
        torch, cfg, params, q8, prompts, TOL_LOGITS_F16_QUANT_REL,
        "fp16 W8A16 engine"))
    free_cache(torch)
    for bits in (4, 6):
        out[f"fp16_w{bits}a16"] = f16_serve(
            torch, pa, mg, gm, cfg, params,
            dataclasses.replace(v2, quantize_bits=bits), prompts,
            f"fp16 W{bits}A16 engine")
        free_cache(torch)
    # W8A8's own entry on one quantized layer, f16 x (B7 with f16 output)
    from deepspeed_tpu_torch.inference.quantization import quantize_on_host
    qparams = quantize_on_host(params, 8, q8.quantize_group, "cuda")
    out["int8_gemm_path_f16"] = int8_gemm_path(torch, mg, qparams,
                                               torch.float16)
    del qparams
    free_cache(torch)

    # the v1 engine, fp16 W8A16, against a v2 engine at the same
    # quantization and dtype (v2 quantizes the same raw weights itself)
    B, T = v1_shape
    v1p = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (B, T))
    icfg = {"dtype": "float16", "max_seq_len": T + NEW_TOKENS,
            "quantize_bits": 8}
    v1, eng, toks, first, counts = v1_run(torch, cfg, params, icfg, v1p,
                                          "v1 fp16 W8A16", kernels=[mg])
    del eng
    free_cache(torch)
    ref = v2_first_logits(torch, cfg, params, v1p, q8)
    rel = v1_against_v2(first, ref, "v1 fp16 W8A16")
    agree = (toks[:, T] == ref.argmax(-1).cpu().numpy()).sum()
    out["v1_fp16_w8a16"] = dict(
        v1, launches=v1_quantized_counts(counts, cfg, "v1 fp16 W8A16"),
        first_logits_rel_diff_vs_v2=rel, first_tokens_equal_v2=int(agree))
    del params, ref
    free_cache(torch)

    mcfg = moe_cfg or tfm.get_config("mixtral-8x7b", moe_routing="dropless",
                                     num_layers=MOE_LAYERS, dtype="float16")
    mparams = tfm.init_params(mcfg, torch.Generator(
        device="cuda").manual_seed(SEED), device="cuda", dtype=torch.float16)
    mrng = np.random.default_rng(SEED)
    mprompts = [mrng.integers(0, mcfg.vocab_size, size=n).tolist()
                for n in prompt_lens]
    out["fp16_dropless_moe"] = dict(
        f16_serve(torch, pa, mg, gm, mcfg, mparams, v2, mprompts,
                  "fp16 dropless MoE engine"), layers=mcfg.num_layers,
        param_gb=sum(t.numel() * t.element_size() for t in
                     _leaves(mparams)) / 1e9)
    del mparams
    free_cache(torch)
    out["seconds"] = time.perf_counter() - t_phase
    return out


def fused_adam_f16_path(torch, fo, tfm) -> dict:
    """``fused_adamw_flat`` as an f16 caller uses it: the small MoE model's
    parameters as one flat f16 vector with f16 gradients and f32 moments,
    3 steps on the card (one launch each) against the same steps on the CPU
    (plain version): parameters within the f16 limit (ADAM_REL of the
    largest), moments within ADAM_REL of their largest element."""
    params = tfm.init_params(small_moe_cfg(tfm, "dropless"),
                             torch.Generator().manual_seed(SEED),
                             device="cpu", dtype=torch.float32)
    flat = torch.cat([x.reshape(-1) for x in _leaves(params)]).half()
    gen = torch.Generator().manual_seed(SEED + 9)
    grads = [torch.randn(flat.shape, generator=gen).half() for _ in range(3)]
    out = {}
    for dev in ("cuda", "cpu"):
        state = (flat.to(dev), torch.zeros(flat.shape, device=dev),
                 torch.zeros(flat.shape, device=dev))
        fo.reset_counts()
        for step, g in enumerate(grads, 1):
            state = fo.fused_adamw_flat(state[0], g.to(dev), *state[1:],
                                        step, **ADAM_HYPER)
        out[dev] = ([t.cpu() for t in state], dict(fo.LAUNCHES),
                    dict(fo.PLAIN_CALLS))
    _, launches, plain = out["cuda"]
    if launches != {"fused_adamw": len(grads)} or any(plain.values()):
        fail(f"fused_adamw_flat (f16): {launches} {plain}, want one launch "
             f"per call for {len(grads)} calls")
    (pk, mk, vk), (pp, mp, vp) = out["cuda"][0], out["cpu"][0]
    worst = max(compare_f16(pk, pp, "fused_adamw_flat p (f16)", rel=ADAM_REL),
                compare_grad(mk, mp, True, "fused_adamw_flat m", rel=ADAM_REL),
                compare_grad(vk, vp, True, "fused_adamw_flat v", rel=ADAM_REL))
    return {"launches": launches["fused_adamw"], "calls": len(grads),
            "elements": flat.numel(), "max_abs_diff": worst}


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def small_f16_agreement(torch, pa, mg, gm) -> dict:
    """Small f16 models (head dim 64, GQA; plain, W8A16 and dropless MoE)
    served on the card and on the CPU from the same weights: the first
    mixed step's logits within TOL_LOGITS_F16_REL of their largest
    magnitude, the card run through every kernel of its path with no plain
    call; the greedy tokens that follow are counted, not gated (one f16
    rounding the other way can turn a near tie, ROADMAP C4)."""
    import numpy as np

    from deepspeed_tpu_torch.inference.v2.engine import (InferenceEngineV2,
                                                         V2Config)
    from deepspeed_tpu_torch.models import transformer as tfm

    small = dict(hidden_size=256, intermediate_size=512, num_heads=4,
                 num_kv_heads=2, dtype="float16")
    cases = {"plain": (tfm.get_config("tiny", **small), 0),
             "w8a16": (tfm.get_config("tiny", **small), 8),
             "dropless_moe": (tfm.get_config("tiny-moe",
                                             moe_routing="dropless",
                                             **small), 0)}
    rng = np.random.default_rng(SEED)
    out = {}
    for name, (cfg, bits) in cases.items():
        params = tfm.init_params(cfg, torch.Generator().manual_seed(SEED),
                                 device="cpu", dtype=torch.float32)
        v2 = V2Config(max_tokens_per_step=32, max_seqs=4, block_size=16,
                      num_blocks=64, max_blocks_per_seq=8, dtype="float16",
                      quantize_bits=bits)
        prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
                   for n in (5, 40, 17, 70)]
        res = {}
        for dev in ("cuda", "cpu"):
            eng = InferenceEngineV2(cfg, params, v2, device=dev)
            uids = [eng.put(p, max_new_tokens=12) for p in prompts]
            for mod in (pa, mg, gm):
                mod.reset_counts()
            eng.step()
            first = eng.last_logits.float().cpu()
            toks = eng.generate_all(burst=4)
            res[dev] = (first, [toks[u] for u in uids])
            if dev == "cuda":
                ran = [pa.LAUNCHES] + ([mg.LAUNCHES] if bits else []) + (
                    [gm.LAUNCHES] if name == "dropless_moe" else [])
                plain = {**pa.PLAIN_CALLS, **mg.PLAIN_CALLS,
                         **gm.PLAIN_CALLS}
                if not all(any(c.values()) for c in ran) or \
                        any(plain.values()):
                    fail(f"small f16 {name}: the card run did not go "
                         f"through its kernels: {ran} {plain}")
        a, b = res["cuda"][0], res["cpu"][0]
        rel = ((a - b).abs().amax(-1) / b.abs().amax(-1)).max().item()
        if not (bool(torch.isfinite(a).all()) and rel <= TOL_LOGITS_F16_REL):
            fail(f"small f16 {name}: card vs CPU first-step logits differ by "
                 f"{rel} of max |logit| (limit {TOL_LOGITS_F16_REL})")
        same = sum(x == y for x, y in zip(res["cuda"][1], res["cpu"][1]))
        out[name] = {"first_logits_rel": rel, "requests": len(prompts),
                     "requests_with_equal_tokens": same}
    return out


def run_fp16_phase(torch, pa, mg, gm, fa, ev, fo, tfm, card: str) -> dict:
    """fp16 serving: each f16 kernel against its plain version and timed
    (B4, B5, B6 and B7 and B8 at the bf16 checks' shapes, B1 with biases
    at OpenFold's calls, B9 at ADAM_N), then the engines through them
    (``run_fp16_engines``), small f16 models card vs CPU and B9's f16 path;
    prints each result and the phase's seconds."""
    t_f16 = time.perf_counter()
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    f16 = torch.float16
    out = {"paged": [check_decode(torch, pa, flush, dtype=f16),
                     check_prefill(torch, pa, flush, dtype=f16)],
           "mixed_gemm": check_mixed_gemm(torch, mg, flush, f16),
           "grouped_matmul": check_grouped_matmul(torch, gm, flush, f16),
           "fused_adamw": check_fused_adam(torch, fo, flush, f16),
           "evoformer": check_evoformer_f16(torch, fa, ev, flush)}
    del flush
    free_cache(torch)
    # a mixed step's rows at wq/wo, wk/wv and w_out take split-K, so the f16
    # sum of the splits (splitk_reduce_kernel<__half>) is held above too
    unsplit = {k["shape"] for k in out["mixed_gemm"]
               if k["M"] == GEMM_MS[1] and k["name"] != "int8_gemm"
               and k["splits"] <= 1}
    if unsplit & {"wq/wo", "wk/wv", "w_out"}:
        fail(f"mixed_gemm f16: no split-K at M = {GEMM_MS[1]} at {unsplit}")
    for k in (out["paged"] + out["mixed_gemm"] + out["grouped_matmul"]
              + [out["fused_adamw"]] + list(out["evoformer"]["calls"]
                                            .values())):
        where = "".join(f" {key}={k[key]}" for key in ("shape", "M", "T", "D")
                        if key in k)
        print(f"{k['name']} f16 ({k['kernel']}){where}: max_abs_err "
              f"{k['max_abs_err']:.3e} (limit {F16_ABS} + {F16_REL} max|p| + "
              f"{F16_RTOL} |p|; B6 and B8 {GEMM_F32_REL} / {GMM_F32_REL} "
              f"max|p|, B7 bit for bit) kernel_ms {k['ms']:.4f} plain_ms "
              f"{k['plain_ms']:.4f} library_ms {k['library_ms']:.4f} (fp16) "
              f"bound_ms {k['bound_ms']:.5f} ({k['bound_by']})")
    out["engines"] = run_fp16_engines(torch, pa, mg, gm, card)
    print("fp16 engines: " + json.dumps(out["engines"]))
    print(fp16_line(out["engines"]))
    out["small"] = small_f16_agreement(torch, pa, mg, gm)
    print("small f16 models card vs CPU: " + json.dumps(out["small"]))
    out["fused_adamw_path"] = fused_adam_f16_path(torch, fo, tfm)
    print("fused_adamw_flat f16 path: " + json.dumps(out["fused_adamw_path"]))
    free_cache(torch)
    out["seconds"] = time.perf_counter() - t_f16
    print(f"fp16 phase ({card}): {out['seconds']:.1f} s")
    return out


def fp16_line(f16: dict) -> str:
    def eng(e):
        return (f"prefill {e['prefill_tokens_per_s']:.2f} / decode "
                f"{e['decode_tokens_per_s']:.2f} tokens/s, peak "
                f"{e['peak_mem_gb']:.2f} GB")
    v1 = f16["v1_fp16_w8a16"]
    return (f"fp16 serving ({f16['card']}, {f16['seconds']:.1f} s): "
            f"llama3-8b x{f16['layers']} fp16 {eng(f16['fp16'])}, first "
            f"logits {f16['fp16']['first_logits_rel_vs_f32']:.3e} of max vs "
            f"f32 (limit {TOL_LOGITS_F16_REL}) | fp16 W8A16 "
            f"{eng(f16['fp16_w8a16'])}, "
            f"{f16['fp16_w8a16']['first_logits_rel_vs_f32']:.3e} vs f32 W8A16 "
            f"(limit {TOL_LOGITS_F16_QUANT_REL}) | v1 fp16 W8A16 decode "
            f"{v1['decode_tokens_per_s']:.2f} tokens/s, "
            f"{v1['first_logits_rel_diff_vs_v2']:.3e} vs v2 | dropless "
            f"Mixtral x{f16['fp16_dropless_moe']['layers']} fp16 "
            f"{eng(f16['fp16_dropless_moe'])}")


def fleet_line(fl: dict) -> str:
    """The fleet phase's numbers, on one line beside the card."""
    r, d, s, a = fl["remote"], fl["disagg"], fl["rollout"], fl["adapters"]
    return (f"fleet ({fl['card']}): remote worker spawn to registered "
            f"{r['spawn_to_registered_s']:.2f} s, scale-up decision "
            f"{r['scale_up_decision_s']:.2f} s (debounce {r['debounce_s']} "
            f"s) + ready {r['scale_up_ready_s']:.2f} s, "
            f"{r['http_tokens_per_s']:.2f} tokens/s through HTTP; SIGKILL: "
            f"failover {r['failover_s']:.3f} s, lease expiry "
            f"{r['lease_expiry_s']:.2f} s (TTL {r['lease_ttl_s']} s), back "
            f"under epoch {r['epochs']['after']} after "
            f"{r['reregistered_s']:.2f} s; scale-down "
            f"{r['scale_down_s']:.2f} s; SIGSTOP declared dead after "
            f"{r['stop_declared_dead_s']:.2f} s, replacement "
            f"{r['replacement_s']:.2f} s, returnee exit {r['returnee_rc']}, "
            f"{r['device_used_gb_three_workers']:.2f} GB on the card with "
            f"three workers; handoff of {d['handoff_blocks']} blocks "
            f"{d['handoff_ms']:.2f} ms ({d['handoff_ms_per_block']:.2f} ms "
            f"a block) against a cold TTFT of {d['cold_ttft_ms']:.2f} ms; "
            f"rollout at {s['layers']} layers: publish {s['publish_s']:.2f} "
            f"s ({s['publish_gb_per_s']:.3f} GB/s of {s['checkpoint_gb']:.2f}"
            f" GB), swap s {json.dumps(s['swap_s'])}, peak "
            f"{s['peak_gb_during_swap']:.2f} GB; adapters: logits "
            f"{max(a['logits_rel_vs_merged']):.3e} of max |logit| from "
            f"merged weights")


def v1_line(v1: dict) -> str:
    """The v1 phase's numbers, on one line beside the card."""
    b, q, a, e = v1["bf16"], v1["w8a16"], v1["alibi"], v1["encoder"]

    def rates(r):
        return (f"prefill {r['prefill_s']:.4f} s "
                f"({r['prefill_tokens_per_s']:.2f} tokens/s), decode "
                f"{r['decode_tokens_per_s']:.2f} tokens/s, peak "
                f"{r['peak_mem_gb']:.2f} GB")

    return (f"v1 ({v1['card']}), {V1_BATCH} x {V1_PROMPT} prompt tokens, "
            f"{NEW_TOKENS} new: llama3-8b bf16 {rates(b)}, first-token "
            f"logits {b['first_logits_rel_diff_vs_v2']:.3e} of max |logit| "
            f"from v2's (limit {TOL_V1_LOGITS_REL}); W8A16 {rates(q)}, "
            f"first-token logits {q['first_logits_rel_diff_vs_v2']:.3e} of "
            f"max |logit| from W8A16 v2's, "
            f"mixed_gemm launches {q['launches']['mixed_gemm_int8']} "
            f"(wgmma {q['launches']['mixed_gemm_wgmma']}); BLOOM-7b1 shape "
            f"(ALiBi, {a['layers']} layers) {rates(a)}; BERT-base encoder "
            f"{e['shape']} card {e['card_s']:.4f} s, card vs CPU "
            f"{e['max_abs_err_vs_cpu']:.3e} (limit {TOL_ENCODER_REL} of "
            f"{e['max_abs']:.3f})")


def serving_line(sv: dict) -> str:
    """The serving phase's numbers, on one line beside the card."""
    a, b, c = sv["inprocess"], sv["two_replicas"], sv["subprocess"]
    return (f"serving ({sv['card']}), {a['requests']} requests from "
            f"{a['clients']} clients, {NEW_TOKENS} new tokens each: "
            f"in-process TTFT p50 {a['ttft_ms_p50']:.2f} ms, p99 "
            f"{a['ttft_ms_p99']:.2f} ms, TPOT p50 {a['tpot_ms_p50']:.2f} ms, "
            f"{a['http_tokens_per_s']:.2f} completion tokens/s through HTTP "
            f"against {a['generate_all_tokens_per_s']:.2f} from generate_all "
            f"on the same prompts; a second in-process replica "
            f"{b['second_replica_bytes'] / 1e9:.3f} GB (one KV pool "
            f"{b['kv_pool_bytes'] / 1e9:.3f} GB), two replicas "
            f"{b['http_tokens_per_s']:.2f} tokens/s; subprocess CLI with two "
            f"workers: spawn to ready {c['spawn_to_ready_s']:.2f} s, "
            f"{c['http_tokens_per_s']:.2f} tokens/s, respawn after a "
            f"killed worker {c['respawn_s']:.2f} s")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace a third run's phases of the bf16, W8A16 and "
                    "dropless MoE engines and one more training step with "
                    "torch.profiler and print where the device time goes")
    ap.add_argument("--out", help="also write the results as JSON here")
    ap.add_argument("--spec-rates", action="store_true",
                    help="print one process's warm decode tokens/s of the "
                    "plain, speculative and adapter engines as a JSON line "
                    "and stop (the main run starts these processes itself)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    if args.spec_rates:
        torch.backends.cuda.matmul.allow_tf32 = False
        print(json.dumps(spec_rates(torch)))
        return
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

    clock = PhaseClock()
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # the host Adam (g++) builds beside the kernels (nvcc)
    from deepspeed_tpu_torch.ops import cpu_adam
    host_build = threading.Thread(target=cpu_adam.build)
    host_build.start()
    secs, log = build.build()
    host_build.join()
    print(f"build: {secs:.2f} s")
    clock("build")
    kernel = ""
    for line in log.splitlines():
        if line.startswith("== "):  # a source and its seconds
            print(f"  nvcc {line[3:]}")
        elif "Compiling entry function" in line:
            kernel = kernel_name(line)
        elif "registers" in line or "spill" in line:
            print(f"  ptxas: {kernel}: {line.strip()}")

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    kernels = [check_decode(torch, pa, flush), check_prefill(torch, pa, flush)]
    # the draft model's shapes (D = 64): its decode bodies and mirror
    # prefills; and B4 at a verify's k + 1 positions per row (D = 128)
    draft_kernels = [check_decode(torch, pa, flush, DRAFT_D),
                     check_prefill(torch, pa, flush, DRAFT_D)]
    verify_b4 = verify_prefill_timing(torch, pa, flush)
    del flush
    for k in kernels + draft_kernels:
        edges = (f"split {k['split']}, split edges max_abs_err "
                 f"{k['max_abs_err_split_edges']:.3e}, "
                 if "split" in k else "")
        edges += "".join(f"block size {bs} max_abs_err {e:.3e}, " for bs, e
                         in k.get("max_abs_err_block_sizes", {}).items())
        print(f"{k['name']} D={k['D']}: max_abs_err {k['max_abs_err']:.3e} "
              f"(bf16, limit atol+rtol {TOL_BF16}), "
              f"{k['max_abs_err_f32']:.3e} (f32, limit {TOL_F32}) {edges}"
              f"kernel_ms {k['ms']:.4f} plain_ms "
              f"{k['plain_ms']:.4f} library_ms {k['library_ms']:.4f} "
              f"bound_ms {k['bound_ms']:.5f} ({k['bound_by']})")
    print(f"paged_prefill_attention at a verify's Qp={verify_b4['Qp']} "
          f"({card}): max_abs_err {verify_b4['max_abs_err']:.3e} kernel_ms "
          f"{verify_b4['ms']:.4f} plain_ms {verify_b4['plain_ms']:.4f} "
          f"library_ms {verify_b4['library_ms']:.4f} bound_ms "
          f"{verify_b4['bound_ms']:.5f} ({verify_b4['bound_by']})")
    gc.collect()
    torch.cuda.empty_cache()
    clock("paged kernels")
    rates = spec_rates_over_processes(torch)
    print(f"decode tokens/s over {SPEC_RATE_PROCS} processes ({card}): "
          + json.dumps(rates))
    clock("spec rates")

    keep = {}
    engine = run_engine(torch, pa, args.profile, keep)
    launches = engine["launches"]
    print("engine: " + json.dumps(engine))
    small = small_model_agreement(torch)
    print("small model card vs CPU: " + json.dumps(small))
    clock("engine")
    params = keep.pop("params")
    hier = run_hierarchy_phase(torch, pa, params, card)
    print("hierarchy: " + json.dumps(hier))
    print(hierarchy_line(hier))
    clock("hierarchy")
    spec = run_spec_phase(torch, pa, params, card)
    print("speculative decoding and adapters: " + json.dumps(spec))
    clock("speculative")
    gc.collect()
    torch.cuda.empty_cache()
    v1 = run_v1_phase(torch, mg, params, card)
    del params
    print(f"v1 engine ({card}): " + json.dumps(v1))
    print(v1_line(v1))
    small_v1 = small_v1_agreement(torch, gm)
    print("small v1 models card vs CPU (rope, alibi, dropless MoE): "
          + json.dumps(small_v1))
    for k in draft_kernels:
        k["launches"] = spec["draft"]["launches"][f"{k['name']}_d{DRAFT_D}"]
    small_spec = small_spec_agreement(torch, pa)
    print("small model speculative, card vs CPU vs plain: "
          + json.dumps(small_spec))
    small_hier = small_hierarchy_agreement(torch, pa)
    print("small model hierarchy, card vs CPU vs cache-off: "
          + json.dumps(small_hier))
    clock("v1 and small models")
    gc.collect()
    torch.cuda.empty_cache()
    serving = run_serving_phase(torch, pa, card)
    print(f"serving front ({card}): " + json.dumps(serving))
    print(serving_line(serving))
    small_serving = small_serving_agreement(torch, pa)
    print("small model served over HTTP, card vs CPU: "
          + json.dumps(small_serving))
    clock("serving")
    gc.collect()
    torch.cuda.empty_cache()
    fleet = run_fleet_phase(torch, pa, mg, card)
    print(fleet_line(fleet))
    clock("fleet")

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    flash = check_flash(torch, fa, flush)
    flash16 = check_flash_f16(torch, fa, flush)
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
    for k in flash16:
        cases = ", ".join(f"{c} (max |dS| {v['max_abs_ds']:.3e}) "
                          f"{v.get(k['name'], 0.0):.3e}"
                          for c, v in k["ds_cases"].items())
        print(f"{k['name']} f16 ({k['kernel']}): max_abs_err "
              f"{k['max_abs_err']:.3e} (limit {F16_ABS} + {F16_REL} max|p| "
              f"+ {F16_RTOL} |p|; {cases}; overflow infs "
              f"{k['overflow_infs']}) kernel_ms {k['ms']:.4f} plain_ms "
              f"{k['plain_ms']:.4f} library_ms {k['library_ms']:.4f} (fp16 "
              f"SDPA) bound_ms {k['bound_ms']:.5f} ({k['bound_by']})")
    clock("flash kernels")
    training = run_training(torch, fa, args.profile)
    launches.update(training["launches"])
    print("training: " + json.dumps(training))
    small_train = small_training_agreement(torch, fa)
    print("small training card vs CPU: " + json.dumps(small_train))
    clock("training")
    gc.collect()
    torch.cuda.empty_cache()
    train_engine = run_training_engine_phase(torch, fa)
    for k in flash16:
        k["launches"] = train_engine["fp16"]["launches"][k["name"]]
    print(f"training engine ({card}): " + json.dumps(train_engine))
    print(training_engine_line(train_engine))
    clock("training engine")
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
    clock("mixed GEMM and quantized engine")
    # mixed-GEMM launches by row count: a decode body's M = 8 calls run
    # mixed_gemm_decode_kernel, a mixed step's (M > 16)
    # mixed_gemm_wgmma_kernel;
    # int8_gemm's own path runs M = 8 and 256 once per projection each (M =
    # 8 on int8_gemm_mma_kernel, M = 256 on int8_gemm_wgmma_kernel)
    decode_m, step_m = GEMM_MS
    gemm_launches = {}
    for name, bits in GEMM_KERNELS.items():
        if name == "int8_gemm":
            continue
        counts = quant[f"w{bits}a16"]["launches"]
        gemm_launches[name, step_m] = counts[f"{name}_wgmma"]
        gemm_launches[name, decode_m] = counts[f"{name}_decode"]
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
    clock("grouped GEMM and MoE")
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
    clock("fused AdamW")
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
    clock("evoformer and sparse")
    gc.collect()
    torch.cuda.empty_cache()

    f16 = run_fp16_phase(torch, pa, mg, gm, fa, ev, fo, tfm, card)
    paged16, gemm16, gmm16, adam16, evo16, fp16, small16, adam16_path = (
        f16[k] for k in ("paged", "mixed_gemm", "grouped_matmul",
                         "fused_adamw", "evoformer", "engines", "small",
                         "fused_adamw_path"))
    gc.collect()
    torch.cuda.empty_cache()
    clock("fp16")
    peft = run_peft_phase(torch, fa, mg)
    print(f"peft ({card}): " + json.dumps(peft))
    print(peft_line(peft, card))
    clock("peft")
    offload = run_offload_phase(torch, fa, card)
    print(f"offload ({card}): " + json.dumps(offload))
    print(offload_line(offload, card))
    clock("offload")
    offload_launches = offload["optimizer"]["launches"]
    launches.update({"grouped_matmul": moe["launches"]["grouped_matmul"],
                     "fused_adamw": adam_tree["launches"],
                     "flash_fwd_bias": evo["launches"]})
    result = {"card": card, "torch": torch.__version__, "engine": engine,
              "small_model": small, "hierarchy": hier,
              "verify_prefill": verify_b4, "spec_rates": rates, "spec": spec,
              "small_spec": small_spec,
              "small_hierarchy": small_hier, "flash": flash,
              "flash_f16": flash16, "training": training,
              "training_engine": train_engine,
              "small_training": small_train, "mixed_gemm": gemm,
              "quantized_engine": quant, "small_quantized": small_quant,
              "grouped_matmul": gmm, "moe_engine": moe,
              "small_moe": small_moe, "small_moe_training": small_moe_train,
              "fused_adamw": adam, "fused_adamw_tree": adam_tree,
              "evoformer": evo, "sparse_attention": sparse, "v1": v1,
              "small_v1": small_v1, "serving": serving,
              "small_serving": small_serving, "fleet": fleet,
              "paged_f16": paged16, "mixed_gemm_f16": gemm16,
              "grouped_matmul_f16": gmm16, "fused_adamw_f16": adam16,
              "evoformer_f16": evo16, "fp16_engines": fp16,
              "small_f16": small16, "fused_adamw_f16_path": adam16_path,
              "offload": offload, "peft": peft,
              "phase_seconds": clock.seconds}

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

    # the v1 W8A16 phase's mixed-GEMM launches by rows: its prefill (M = B
    # * T, a row of its own) on the wgmma kernel, its decodes (M = 8, beside
    # the engine's decode bodies) on mixed_gemm_decode_kernel
    v1_launch = v1["w8a16"]["launches"]
    gemm_launches["mixed_gemm_int8", GEMM_V1_M] = \
        v1_launch["mixed_gemm_wgmma"]
    v1_gemm = {("mixed_gemm_int8", decode_m): v1_launch["mixed_gemm_decode"]}
    # the fleet phase's launches: B4/B5 in its workers and replicas (stages
    # 1 and 2), B6 in bench.py's gemm sweep by rows (M = 256 on the wgmma
    # kernel, M = 1, 8 and 16 on mixed_gemm_decode_kernel); the M = 1 and 16
    # rows' launches are the bench's alone
    fb = fleet["bench"]
    fleet_launches = dict(fleet["launches"])
    for name, by_m in fb["gemm_launches_by_m"].items():
        for m in BENCH_GEMM_MS:
            fleet_launches[name, m] = by_m[m]
            if m not in GEMM_MS:
                gemm_launches[name, m] = by_m[m]

    def row(k):
        half = k.get("dtype") == "float16"
        return {"name": k["name"], "route": "cuda",
                "source": f"deepspeed_tpu_torch/csrc/{sources[k['name']]}",
                "replaces": replaces[k["name"]], "status": "ok",
                **{d: k[d] for d in ("M", "T", "D", "kernel", "dtype")
                   if d in k},
                "launches": (k["launches"] if "launches" in k
                             else gemm_launches[k["name"], k["M"]] if "M" in k
                             else gemm_launches[k["name"], k["T"]] if "T" in k
                             else launches[k["name"]]),
                **({"launches_hierarchy": hier["launches"][k["name"]]}
                   if k["name"] in hier["launches"] and "launches" not in k
                   else {}),
                **({"launches_serving":
                    serving["inprocess"]["launches"][k["name"]]}
                   if k["name"] in serving["inprocess"]["launches"]
                   and "launches" not in k else {}),
                **({"launches_v1": v1_gemm[k["name"], k["M"]]}
                   if (k["name"], k.get("M")) in v1_gemm and not half
                   else {}),
                **({"launches_fleet": fleet_launches[k["name"]]}
                   if k["name"] in fleet_launches and "launches" not in k
                   else {"launches_fleet": fleet_launches[k["name"], k["M"]]}
                   if (k["name"], k.get("M")) in fleet_launches and not half
                   else {}),
                **{x: k[x] for x in ("launches_w8a16", "launches_moe",
                                     "launches_peft") if x in k},
                **({"launches_offload": offload_launches[k["name"]]}
                   if k["name"] in offload_launches and not half else {}),
                "max_abs_err": k["max_abs_err"],
                "max_abs_err_f32": k["max_abs_err_f32"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"], "library_ms": k["library_ms"]}

    evo_row = dict(evo["calls"][EVO_JSON], name="flash_fwd_bias")
    # the f16 rows' launches: each from the fp16 path that runs it
    e16 = fp16["fp16"]["launches"]
    for k in paged16:
        k["launches"] = e16[k["name"]]
        k["launches_w8a16"] = fp16["fp16_w8a16"]["launches"][k["name"]]
        k["launches_moe"] = fp16["fp16_dropless_moe"]["launches"][k["name"]]
    rows16 = list(paged16)
    for k in gemm16:
        name, M = k["name"], k["M"]
        if (k["shape"], M) not in GEMM_JSON:
            continue
        if name == "int8_gemm":
            path = fp16["int8_gemm_path_f16"]
            n = path["wgmma_launches"] if M > 16 else \
                path["launches"] - path["wgmma_launches"]
        elif M == GEMM_V1_M:
            n = fp16["v1_fp16_w8a16"]["launches"]["mixed_gemm_wgmma"]
        elif M in GEMM_MS:
            eng16 = fp16[f"fp16_w{GEMM_KERNELS[name]}a16"]["launches"]
            n = eng16[f"{name}_wgmma" if M > 16 else f"{name}_decode"]
        else:  # M = 1 and 16: no fp16 path runs these rows
            continue
        rows16.append(dict(k, launches=n))
    moe16 = fp16["fp16_dropless_moe"]["launches"]
    for k in gmm16:
        if (k["shape"], k["T"]) not in MOE_JSON:
            continue
        rows16.append(dict(k, launches=moe16["grouped_matmul_wgmma"]
                           if k["T"] > 16 else moe16["grouped_matmul"]
                           - moe16["grouped_matmul_wgmma"]))
    rows16.append(dict(evo16["calls"][EVO_JSON], launches=evo16["launches"]))
    rows16.append(dict(adam16, launches=adam16_path["launches"]))
    for k in rows16:
        if not k["launches"] > 0:
            fail(f"{k['name']} f16: no launch on its fp16 path")
    # B6 at the training step's rows (the peft phase): int4 on its QLoRA
    # main path, int8 and fp6 on its other bases' steps
    peft_b6 = {"mixed_gemm_int4":
               peft["qlora"]["launches"]["mixed_gemm_int4_wgmma"],
               **{n: peft["bases"][b]["launches"][n] for n, b in (
                   ("mixed_gemm_int8", "int8"), ("mixed_gemm_fp6", "fp6"))}}
    rows_peft = [dict(k, launches=peft_b6[k["name"]],
                      launches_peft=peft_b6[k["name"]])
                 for k in peft["b6"] if k["shape"] == "w_gate/w_in"]
    for k in rows_peft:
        if not k["launches"] > 0:
            fail(f"{k['name']} M={k['M']}: no launch on the peft path")
    line = {"kernels": [row(k) for k in
                        kernels + draft_kernels + flash + flash16 + [evo_row]
                        + at_shape + [adam] + rows16 + rows_peft]}
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
