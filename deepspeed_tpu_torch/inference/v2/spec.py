"""Speculative decoding for the v2 engine — the port of
``deepspeed_tpu/inference/v2/spec.py``.

Two propose paths share one verify/accept core (Leviathan et al., 2023):

* **draft model** — a small model proposes ``k`` tokens autoregressively
  through its own paged KV pool (the target's block tables, its own pool),
  in ``k + 1`` single-token decode bodies (B5 on the draft's pool);
* **self-draft** — Medusa-style heads (``linear/spec_heads.py``) applied
  to the carried last-accepted hidden state propose all ``k`` tokens at
  once.

The target then verifies all ``k + 1`` positions in ONE multi-position
forward over the paged KV (:func:`verify_body`: the paged prefill kernel,
B4, from ``chunk_start = ctx``), and :func:`_accept_and_emit` keeps the
longest accepted prefix plus one correction or bonus token.  Greedy rows
accept drafts equal to the target's argmax, so their output is token for
token the non-speculative decode; sampled rows run the accept /
residual-resample scheme, which keeps the target distribution.

What changes against the reference: every index the step needs (KV write
slots, chunk starts and lengths) is computed on the host from the decode
table and placed on the device BEFORE the step's device work starts
(:func:`verify_inputs`), so from the first draft to the accept the step
never waits on the device; the host reads back the emitted tokens and the
accept lengths once.  Sampled rows draw from ``torch.Generator``s seeded
per row from (step key, request seed, row), as the engine's
``sample_rows`` does: deterministic per seed, the reference's
distribution, not its bits.

Rejected-suffix KV needs no rollback: the writes at ``ctx .. ctx+k`` land
in blocks the sequence already owns, stale entries are masked by the
context length of every later attention and overwritten by the next step.
Writes at ``pos >= pos_limit`` (past the sequence's reservation) park in
the scratch block.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ...linear.spec_heads import apply_spec_heads
from ...models import transformer as tfm
from ...ops.hopper.paged_attention import paged_prefill_attention


def _leading_accepts(accept: torch.Tensor) -> torch.Tensor:
    """(S, k) bool accept flags -> (S,) length of the leading all-True
    run."""
    return torch.cumprod(accept.long(), dim=1).sum(1)


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (S, Q, ...) gathered at per-row position idx (S,) -> (S, ...)."""
    return x[torch.arange(x.shape[0], device=x.device), idx.long()]


def _row_generator(device: torch.device, key: int, seed: int, row: int
                   ) -> torch.Generator:
    """A row's generator: the step key folded with the request seed and
    the row index (the engine's ``sample_rows`` keying)."""
    from .engine import fold_in

    gen = torch.Generator(device=device)
    gen.manual_seed(fold_in(fold_in(key, int(seed)), int(row)))
    return gen


@dataclasses.dataclass
class VerifyInputs:
    """Device inputs of one verify forward, from the decode table."""

    pos: torch.Tensor  # (S, Q) positions ctx .. ctx+k, clamped to the rope
    write_at: Tuple[torch.Tensor, torch.Tensor]  # (S*Q,) block ids, offsets
    block_tables: torch.Tensor  # (S, MB) int32
    chunk_start: torch.Tensor  # (S,) int32: ctx, 0 for inactive rows
    chunk_len: torch.Tensor  # (S,) int32: min(Q, pos_limit - ctx)


def verify_inputs(ctx: np.ndarray, block_tables: np.ndarray,
                  pos_limit: np.ndarray, Q: int, block_size: int,
                  scratch: int, device: torch.device) -> VerifyInputs:
    """Host-side index math of a verify forward (numpy), then one copy of
    each result to ``device``.  Row ``s`` is active iff ``ctx[s] > 0``;
    writes at ``pos >= pos_limit`` (or of inactive rows) park in the
    ``scratch`` block; the attention window of a row is ``[ctx, ctx +
    chunk_len)``."""
    ctx = np.asarray(ctx, np.int64)
    pos_limit = np.asarray(pos_limit, np.int64)
    bt = np.asarray(block_tables)
    max_pos = bt.shape[1] * block_size - 1
    pos = ctx[:, None] + np.arange(Q)[None, :]
    active = ctx > 0
    write_ok = active[:, None] & (pos < pos_limit[:, None])
    col = np.clip(pos // block_size, 0, bt.shape[1] - 1)
    blk = np.where(write_ok, np.take_along_axis(bt, col, axis=1), scratch)
    chunk_len = np.where(active, np.clip(pos_limit - ctx, 0, Q), 0)

    def dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return VerifyInputs(
        pos=dev(np.minimum(pos, max_pos), np.int64),
        write_at=(dev(blk.reshape(-1), np.int64),
                  dev((pos % block_size).reshape(-1), np.int64)),
        block_tables=dev(bt, np.int32),
        chunk_start=dev(ctx * active, np.int32),
        chunk_len=dev(chunk_len, np.int32))


@torch.no_grad()
def verify_body(params, caches, tokens: torch.Tensor, vin: VerifyInputs,
                model_cfg: tfm.TransformerConfig, v2, rope,
                adapters: Optional[Dict[str, Any]] = None,
                row_slots: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-position decode forward: the target processes ``Q = k+1``
    consecutive positions per sequence in one pass over the paged KV
    (writing their KV into ``caches`` in place).  ``tokens`` (S, Q):
    position ``ctx+j`` gets ``tokens[:, j]``.  ``adapters`` and
    ``row_slots`` (S,): each row adds its adapter slot's delta, so a
    tenant's drafts are verified against its own model.

    Returns (logits (S, Q, V) f32, final-norm hidden (S, Q, H)); rows at
    parked positions are garbage the caller never uses."""
    from .engine import _layer, _layer_adapters, _lm_head

    S, Q = tokens.shape
    T = S * Q
    nh, hd = model_cfg.num_heads, model_cfg.head_dim
    pos = vin.pos.reshape(T)
    x = tfm.embed_tokens(params, tokens.reshape(T).long(), model_cfg,
                         position_ids=pos)
    q_rope = None if rope is None else (rope[0][pos], rope[1][pos])
    slots = None if row_slots is None else row_slots.repeat_interleave(Q)
    for i in range(model_cfg.num_layers):
        k_cache, v_cache = caches["k"][i], caches["v"][i]

        def attend(q, k_cache=k_cache, v_cache=v_cache):
            o = paged_prefill_attention(
                q.reshape(S, Q, nh, hd), k_cache, v_cache, vin.block_tables,
                vin.chunk_start, vin.chunk_len)
            return o.reshape(T, nh, hd)

        x = _layer(x, tfm.layer_params(params, i), k_cache, v_cache, q_rope,
                   attend, model_cfg, vin.write_at,
                   ad=_layer_adapters(adapters, i), slots=slots,
                   ffn_shape=(S, Q))
    x = tfm._norm(x, params["final_norm"], model_cfg.norm, model_cfg.norm_eps)
    logits = _lm_head(params, x, model_cfg)
    return logits.reshape(S, Q, -1), x.reshape(S, Q, -1)


def _accept_and_emit(logits: torch.Tensor, draft: torch.Tensor,
                     draft_probs: Optional[torch.Tensor], rng: int,
                     temps: np.ndarray, seeds: np.ndarray
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The accept/correct core of both propose paths, per row.

    ``logits`` (S, k+1, V) f32: target logits at positions ctx..ctx+k;
    ``draft`` (S, k) int32: proposals for positions ctx+1..ctx+k;
    ``draft_probs`` (S, k, V) f32: the distributions the drafts were drawn
    from (read for sampled rows only; ``None`` when there are none);
    ``temps``/``seeds``: host arrays (S,), the rows' temperatures and
    request seeds.

    Greedy rows (``temps <= 0``): accept the longest prefix where the
    draft equals the target argmax; the next token is the target's own
    argmax.  Sampled rows: accept ``d_i`` with probability ``min(1,
    p_i(d_i) / q_i(d_i))``; at the first rejection draw the correction
    from ``norm(max(p_i - q_i, 0))``, after ``k`` accepts the bonus from
    ``p_k``.  The rows to sample are known on the host, so a greedy batch
    runs the greedy lane alone.

    Returns (emitted (S, k+1) int32, accept_len (S,) int32): ``emitted[:,
    :a+1]`` is the accepted drafts and one correction or bonus token."""
    from .engine import split_key

    S, Qk, _ = logits.shape
    k = Qk - 1
    dev = logits.device
    g = logits.argmax(-1).to(torch.int32)  # (S, k+1)
    if k:
        a = _leading_accepts(draft == g[:, :k])
    else:
        a = torch.zeros(S, dtype=torch.long, device=dev)
    final = _take_rows(g, a)
    sampled = np.nonzero(np.asarray(temps) > 0.0)[0]
    if len(sampled):
        # the sampled rows' lane, batched; only the draws are per row
        u_rng, fix_rng = split_key(rng)
        idx = torch.from_numpy(sampled).to(dev)
        t = torch.from_numpy(np.maximum(np.asarray(temps)[sampled],
                                        1e-6).astype(np.float32)).to(dev)
        p = torch.softmax(logits[idx] / t[:, None, None], -1)  # (n, k+1, V)
        if k:
            d = draft[idx].long()[..., None]
            q = draft_probs[idx]
            p_d, q_d = p[:, :k].gather(-1, d)[..., 0], q.gather(-1, d)[..., 0]
            u = torch.stack([
                torch.rand(k, device=dev, generator=_row_generator(
                    dev, u_rng, seeds[r], r)) for r in sampled])
            a_s = _leading_accepts(u * q_d < p_d)
            res = (p[:, :k] - q).clamp_min(0.0)
            mass = res.sum(-1, keepdim=True)
            res = torch.where(mass > 0, res / mass.clamp_min(1e-20), p[:, :k])
            res = torch.cat([res, p[:, k:]], dim=1)  # (n, k+1, V)
        else:
            a_s = torch.zeros(len(sampled), dtype=torch.long, device=dev)
            res = p
        pick = _take_rows(res, a_s)  # (n, V)
        fix = torch.stack([torch.multinomial(pick[j], 1, generator=(
            _row_generator(dev, fix_rng, seeds[r], r)))[0]
            for j, r in enumerate(sampled)])
        a[idx] = a_s
        final[idx] = fix.to(torch.int32)
    cols = torch.arange(k + 1, device=dev)[None, :]
    d_pad = torch.cat([draft.to(torch.int32),
                       torch.zeros((S, 1), dtype=torch.int32, device=dev)],
                      dim=1)
    emitted = torch.where(cols < a[:, None], d_pad, final[:, None])
    return emitted.to(torch.int32), a.to(torch.int32)


def _draw_rows(probs: torch.Tensor, greedy: torch.Tensor, key: int,
               temps: np.ndarray, seeds: np.ndarray) -> torch.Tensor:
    """``greedy`` (S, ...) int32 with each sampled row's entries drawn
    from its ``probs`` row instead (the last axis is the vocab)."""
    out = greedy.clone()
    dev = probs.device
    for r in (int(r) for r in np.nonzero(np.asarray(temps) > 0.0)[0]):
        pr = probs[r].reshape(-1, probs.shape[-1])
        drawn = torch.multinomial(pr, 1, generator=_row_generator(
            dev, key, seeds[r], r))[:, 0]
        out[r] = drawn.reshape(greedy[r].shape).to(torch.int32)
    return out


def _proposal_probs(logits: torch.Tensor, temps: np.ndarray
                    ) -> Optional[torch.Tensor]:
    """softmax(logits / temp) per row (the rows' proposal distributions),
    or ``None`` when every row is greedy."""
    if not (np.asarray(temps) > 0.0).any():
        return None
    t = torch.from_numpy(np.maximum(np.asarray(temps, np.float32), 1e-6))
    t = t.to(logits.device).reshape((-1,) + (1,) * (logits.dim() - 1))
    return torch.softmax(logits / t, dim=-1)


@torch.no_grad()
def self_draft_step(params, heads, caches, next_tok: torch.Tensor,
                    vin: VerifyInputs, last_hidden: torch.Tensor, rng: int,
                    temps: np.ndarray, seeds: np.ndarray,
                    model_cfg: tfm.TransformerConfig, v2, rope,
                    adapters=None, row_slots=None):
    """Self-draft (Medusa-style) speculative step.  ``last_hidden`` (S, H)
    f32 is the target's final-norm hidden state at the position whose lm
    head produced ``next_tok``; head ``i`` proposes the token at
    ``ctx+1+i``.  The heads propose without adapters; the verify runs the
    adapter-augmented target, so greedy rows still emit their tenant's
    argmax (only acceptance moves).

    Returns (emitted (S, k+1), accept_len (S,), new_hidden (S, H) f32)."""
    from .engine import split_key

    head_logits = apply_spec_heads(heads, last_hidden)  # (S, k, V) f32
    d_rng, v_rng = split_key(rng)
    q = _proposal_probs(head_logits, temps)
    draft = head_logits.argmax(-1).to(torch.int32)
    if q is not None:
        draft = _draw_rows(q, draft, d_rng, temps, seeds)
    tokens = torch.cat([next_tok[:, None].to(torch.int32), draft], dim=1)
    logits, hidden = verify_body(params, caches, tokens, vin, model_cfg, v2,
                                 rope, adapters=adapters,
                                 row_slots=row_slots)
    emitted, a = _accept_and_emit(logits, draft, q, v_rng, temps, seeds)
    return emitted, a, _take_rows(hidden, a).float()


@torch.no_grad()
def draft_model_step(params, draft_params, caches, draft_caches,
                     next_tok: torch.Tensor, ctx: torch.Tensor,
                     block_tables: torch.Tensor, pos_limit: torch.Tensor,
                     vin: VerifyInputs, rng: int, temps: np.ndarray,
                     seeds: np.ndarray, model_cfg: tfm.TransformerConfig,
                     draft_cfg: tfm.TransformerConfig, v2, rope,
                     draft_rope, k: int):
    """Draft-model speculative step.  ``k + 1`` single-token decode bodies
    run on the DRAFT pool (shared block tables): iterations ``0..k-1``
    propose ``d_1..d_k``; iteration ``k`` only writes ``d_k``'s draft KV,
    so the draft pool stays complete when all ``k`` drafts are accepted.
    ``ctx``, ``block_tables`` and ``pos_limit`` are the table's, on the
    device.  Returns (emitted (S, k+1), accept_len (S,))."""
    from .engine import decode_body, split_key

    active = ctx > 0
    d_rng, v_rng = split_key(rng)
    it_rng = d_rng
    tok = next_tok
    proposals, probs = [], []
    for i in range(k + 1):
        pos = ctx + i
        ok = (active & (pos < pos_limit)).to(ctx.dtype)
        dlogits = decode_body(draft_params, draft_caches, tok, pos,
                              block_tables, (pos + 1) * ok, draft_cfg, v2,
                              draft_rope)
        it_rng, s_rng = split_key(it_rng)
        qi = _proposal_probs(dlogits, temps)
        tok = dlogits.argmax(-1).to(torch.int32)
        if qi is not None:
            tok = _draw_rows(qi, tok, s_rng, temps, seeds)
        proposals.append(tok)
        probs.append(qi)
    draft = torch.stack(proposals[:k], dim=1)  # (S, k)
    q = None if probs[0] is None else torch.stack(probs[:k], dim=1)
    tokens = torch.cat([next_tok[:, None].to(torch.int32), draft], dim=1)
    logits, _ = verify_body(params, caches, tokens, vin, model_cfg, v2, rope)
    return _accept_and_emit(logits, draft, q, v_rng, temps, seeds)
