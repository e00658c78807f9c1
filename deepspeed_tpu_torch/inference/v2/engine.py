"""Continuous-batching inference engine (v2) — the port of
``deepspeed_tpu/inference/v2/engine.py``.

Many requests share one forward pass; decode tokens batch with *chunks* of
prefill (Dynamic SplitFuse) so every step runs near the token budget.  KV
lives in a paged ``(layers, num_blocks, block_size, kv_heads, head_dim)``
pool indexed through block tables; every mixed or prefill step runs the
paged prefill kernel and every decode and burst step the paged decode
kernel (``ops/hopper/paged_attention.py``).

What changes against the reference:

* the ``lax.scan`` over layers is a Python loop over the stacked weights;
* the KV pool is updated IN PLACE (the reference's donated functional
  ``.at[].set``), so a step allocates no second pool;
* the jitted burst ``scan`` is a loop of decode bodies that stays on the
  device and reads the tokens back to the host once per burst;
* host-side index preparation (KV write slots, the prefill scatter) happens
  in numpy before the step's inputs move to the device, so a step never
  waits on the device for an index;
* sampling keys are 64-bit integers split and folded with splitmix64, and a
  sampled row draws with a ``torch.Generator`` seeded from (step key,
  request seed, row): per-seed deterministic, not JAX's bits.

``V2Config(quantize_bits=8 | 6 | 4)`` serves a weight-quantized model
(W8A16 / W6A16 / W4A16): the raw weights are quantized first, slice by
slice where they lie (``inference/quantization.py``), and every projection
then runs the mixed GEMM kernel (``ops/hopper/mixed_gemm.py``).

MoE models (``num_experts > 0``) run ``moe/layer.dense_moe_block`` in each
layer's feed-forward half, over all the step's rows; with
``moe_routing='dropless'`` that is three grouped GEMMs per layer
(``ops/hopper/grouped_matmul.py``).  Expert-choice routing is refused, as
the reference refuses it (non-causal).

Prefix caching, host paging, the cold store, speculation and adapter slots
are refused with ``NotImplementedError`` naming the later slice
(``ROADMAP.md``) that brings them; so are ALiBi models.  The
tracer span and flight-recorder append that the reference's ``step()``
makes wait for the observability slice.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...accelerator import resolve_device
from ...models import transformer as tfm
from ...ops.hopper.mixed_gemm import QuantizedWeight
from ...ops.hopper.paged_attention import (paged_decode_attention,
                                           paged_prefill_attention)
from ..quantization import quantize_on_host
from .ragged import (DecodeStateTable, KVCacheManager, RaggedBatch,
                     RaggedBatchBuilder, SequenceDescriptor)


class AdmissionError(ValueError):
    """A request cannot be admitted: the prompt+budget exceeds the maximum
    context, or (``put(strict=True)``) no sequence slot / KV block budget is
    currently available."""


@dataclasses.dataclass
class V2Config:
    """Every field of the reference's ``V2Config``, under the same name and
    default.  The fields of features a later slice brings must keep their
    defaults here (see ``_LATER``)."""

    max_tokens_per_step: int = 256  # ragged token budget (SplitFuse chunk)
    max_seqs: int = 16
    block_size: int = 64
    num_blocks: int = 512
    max_blocks_per_seq: int = 32
    dtype: str = "bfloat16"
    enable_prefix_cache: bool = False
    prefix_cache_min_tokens: int = 0
    prefix_eviction: str = "lru"
    kv_host_pool_mb: int = 0
    kv_host_pool_bytes: int = 0
    kv_spill_dir: str = ""
    kv_promote_ahead: bool = False
    kv_coldstore_dir: str = ""
    spec_mode: str = "off"
    spec_k: int = 4
    quantize_bits: int = 0
    quantize_group: int = 256
    adapter_slots: int = 0
    adapter_rank: int = 0


#: V2Config fields whose non-default value turns on a feature this slice
#: does not carry -> the ROADMAP.md queue-A item that brings it
_LATER = {
    "enable_prefix_cache": "A2 (prefix cache)",
    "kv_host_pool_mb": "A3 (host paging)",
    "kv_host_pool_bytes": "A3 (host paging)",
    "kv_spill_dir": "A3 (host paging)",
    "kv_promote_ahead": "A3 (host paging)",
    "kv_coldstore_dir": "A4 (cold store)",
    "spec_mode": "A5 (speculative decoding)",
    "adapter_slots": "A7 (multi-tenant adapters)",
}


def _check_config(cfg: V2Config) -> None:
    default = V2Config()
    for name, item in _LATER.items():
        if getattr(cfg, name) != getattr(default, name):
            raise NotImplementedError(
                f"V2Config.{name}={getattr(cfg, name)!r} is not ported yet: "
                f"it arrives with ROADMAP.md queue A item {item}")


# ---------------------------------------------------------------------------
# sampling keys and per-row sampling
# ---------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64's finalizer: a bijective scramble of a 64-bit integer."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def split_key(key: int) -> Tuple[int, int]:
    """Two independent keys from one (the port's ``jax.random.split``)."""
    key &= _MASK64
    return _mix64(2 * key & _MASK64), _mix64((2 * key + 1) & _MASK64)


def fold_in(key: int, data: int) -> int:
    """A key folded with an integer (the port's ``jax.random.fold_in``)."""
    return _mix64((key ^ _mix64(data & _MASK64)) & _MASK64)


def sample_rows(logits: torch.Tensor, temps: np.ndarray, rng: int,
                seeds: np.ndarray) -> torch.Tensor:
    """Per-row next token: rows with ``temps <= 0`` take the argmax (the
    first index among ties, as ``jnp.argmax``); rows with ``temps > 0``
    draw from ``softmax(logits / temp)`` with a ``torch.Generator`` seeded
    from ``fold_in(fold_in(rng, seed), row)`` — the request seed and the
    row index, as the reference folds them.  ``temps``/``seeds`` are host
    arrays, so choosing the rows waits on nothing."""
    tokens = logits.argmax(-1).to(torch.int32)
    sampled = np.nonzero(temps > 0.0)[0]
    for r in sampled:
        r = int(r)
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(fold_in(fold_in(rng, int(seeds[r])), r))
        probs = torch.softmax(logits[r].float() / max(float(temps[r]), 1e-6),
                              -1)
        tokens[r] = torch.multinomial(probs, 1, generator=gen)[0].to(
            torch.int32)
    return tokens


# ---------------------------------------------------------------------------
# ragged forward
# ---------------------------------------------------------------------------


def prefill_scatter_coords(seq_index: torch.Tensor, position_ids: torch.Tensor,
                           chunk_start: torch.Tensor, max_seqs: int, Qp: int):
    """Coordinates to scatter the ragged (T, H, D) q into the per-sequence
    (max_seqs, Qp, H, D) chunk layout, and to gather the output back.

    Padding tokens (seq_index == -1) get POSITIVE out-of-range sentinels
    (row == max_seqs, col == Qp), exactly as the reference; the reference
    drops them with ``mode="drop"``, while torch's ``index_put_`` raises
    on out-of-range indices, so callers scatter only the rows with
    ``seq_index >= 0``.  Gather coordinates are clamped in range (padding
    rows read values the caller drops).

    Returns (scat_row, scat_col, gather_row, gather_col)."""
    row = seq_index.clamp(0, max_seqs - 1).long()
    qp_col = position_ids.long() - chunk_start.long()[row]
    valid = seq_index >= 0
    scat_row = torch.where(valid, row, max_seqs)
    scat_col = torch.where(valid, qp_col, Qp)
    return scat_row, scat_col, row, qp_col.clamp(0, Qp - 1)


def _lm_head(params, x: torch.Tensor, cfg: tfm.TransformerConfig
             ) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["tokens"].T
    else:
        logits = x @ params["lm_head"]["w"]
        if "b" in params["lm_head"]:
            logits = logits + params["lm_head"]["b"]
    return logits.float()


def _layer(x, lp, k_cache, v_cache, q_rope, attend, cfg, write_at):
    """One decoder layer over tokens ``x`` (T, hidden): projections, RoPE,
    the in-place KV write at ``write_at`` = (block ids, offsets), attention
    through ``attend(q) -> o`` (T, H, D), output projection and MLP."""
    T = x.shape[0]
    nh, nkv, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    a_in = tfm._norm(x, lp["ln1"], cfg.norm, cfg.norm_eps)
    q = tfm._lin(a_in, lp["attn"], "wq", "bq").reshape(T, nh, hd)
    k = tfm._lin(a_in, lp["attn"], "wk", "bk").reshape(T, nkv, hd)
    v = tfm._lin(a_in, lp["attn"], "wv", "bv").reshape(T, nkv, hd)
    if q_rope is not None:
        cos, sin = q_rope
        q = tfm.apply_rope(q[None], cos, sin)[0]
        k = tfm.apply_rope(k[None], cos, sin)[0]
    # in place: the reference's donated functional cache update
    k_cache[write_at] = k.to(k_cache.dtype)
    v_cache[write_at] = v.to(v_cache.dtype)
    o = attend(q.contiguous())
    attn_out = tfm._lin(o.reshape(T, nh * hd), lp["attn"], "wo", "bo")
    m_src = x if cfg.parallel_residual else x + attn_out
    m_in = tfm._norm(m_src, lp["ln2"], cfg.norm, cfg.norm_eps)
    # MoE layers route every one of the T rows, padding and inactive rows
    # included, as the reference does: capacity routing drops tokens by
    # their position among exactly these rows
    mlp_out = tfm.ffn_block(m_in[None], lp, cfg)[0]
    return (x + attn_out + mlp_out) if cfg.parallel_residual \
        else (m_src + mlp_out)


@torch.no_grad()
def ragged_forward(params, caches, batch: RaggedBatch,
                   model_cfg: tfm.TransformerConfig, v2: V2Config,
                   rope: Optional[Tuple[torch.Tensor, torch.Tensor]]
                   ) -> torch.Tensor:
    """One mixed (prefill + decode) step over a ragged batch: writes the
    batch's KV into ``caches`` in place and returns f32 logits
    (max_seqs, vocab) at each sequence's last token."""
    dev = caches["k"].device
    bs = v2.block_size
    max_seqs = batch.block_tables.shape[0]
    Qp = v2.max_tokens_per_step
    # -- host-side indices (numpy / CPU tensors) --------------------------
    seq_index = torch.from_numpy(batch.seq_index)
    pos = torch.from_numpy(batch.position_ids)
    row = seq_index.clamp(0, max_seqs - 1).long()
    blk_ids = torch.from_numpy(batch.block_tables)[row, pos.long() // bs]
    # padding tokens park their KV writes in the reserved scratch block
    scratch = caches["k"].shape[1] - 1
    blk_ids = torch.where(seq_index >= 0, blk_ids, scratch)
    scat_row, scat_col, gath_row, gath_col = prefill_scatter_coords(
        seq_index, pos, torch.from_numpy(batch.chunk_start), max_seqs, Qp)
    real = torch.nonzero(seq_index >= 0).flatten()

    def to_dev(t):
        return torch.as_tensor(t).to(dev)

    tok_d, pos_d = to_dev(batch.token_ids).long(), to_dev(pos).long()
    write_at = (to_dev(blk_ids).long(), to_dev(pos.long() % bs))
    real_d = to_dev(real)
    scat = (to_dev(scat_row[real]), to_dev(scat_col[real]))
    gath = (to_dev(gath_row), to_dev(gath_col))
    bt_d = to_dev(batch.block_tables)
    cs_d, cl_d = to_dev(batch.chunk_start), to_dev(batch.chunk_len)

    x = tfm.embed_tokens(params, tok_d, model_cfg, position_ids=pos_d)
    q_rope = None if rope is None else (rope[0][pos_d], rope[1][pos_d])
    # padding rows of the chunk layout stay zero; each layer overwrites the
    # same real rows
    q_seq = torch.zeros((max_seqs, Qp, model_cfg.num_heads,
                         model_cfg.head_dim), dtype=x.dtype, device=dev)

    for i in range(model_cfg.num_layers):
        k_cache, v_cache = caches["k"][i], caches["v"][i]

        def attend(q, k_cache=k_cache, v_cache=v_cache):
            q_seq[scat] = q[real_d]
            o_seq = paged_prefill_attention(q_seq, k_cache, v_cache, bt_d,
                                            cs_d, cl_d)
            return o_seq[gath]

        x = _layer(x, tfm.layer_params(params, i), k_cache, v_cache, q_rope,
                   attend, model_cfg, write_at)
    x = tfm._norm(x, params["final_norm"], model_cfg.norm, model_cfg.norm_eps)
    return _lm_head(params, x[to_dev(batch.logits_rows).long()], model_cfg)


@torch.no_grad()
def decode_body(params, caches, token_ids: torch.Tensor,
                position_ids: torch.Tensor, block_tables: torch.Tensor,
                context_lens: torch.Tensor, model_cfg: tfm.TransformerConfig,
                v2: V2Config, rope) -> torch.Tensor:
    """Single-token decode for every row (device tensors; context_lens
    INCLUDE the current token, inactive rows carry 0 and park their KV
    write in the scratch block).  Returns f32 logits (max_seqs, vocab)."""
    bs = v2.block_size
    S = token_ids.shape[0]
    pos = position_ids.long()
    x = tfm.embed_tokens(params, token_ids.long(), model_cfg, position_ids=pos)
    q_rope = None if rope is None else (rope[0][pos], rope[1][pos])
    rows = torch.arange(S, device=token_ids.device)
    blk_ids = torch.where(context_lens > 0, block_tables[rows, pos // bs],
                          caches["k"].shape[1] - 1).long()
    write_at = (blk_ids, pos % bs)
    for i in range(model_cfg.num_layers):
        k_cache, v_cache = caches["k"][i], caches["v"][i]

        def attend(q, k_cache=k_cache, v_cache=v_cache):
            return paged_decode_attention(q, k_cache, v_cache, block_tables,
                                          context_lens)

        x = _layer(x, tfm.layer_params(params, i), k_cache, v_cache, q_rope,
                   attend, model_cfg, write_at)
    x = tfm._norm(x, params["final_norm"], model_cfg.norm, model_cfg.norm_eps)
    return _lm_head(params, x, model_cfg)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


# leaves the reference reads in f32 whatever the compute dtype
# (``x.astype(f32) @ p["router"].astype(f32)``, PR-MoE's ``coef``)
_F32_LEAVES = ("router", "coef")


def _cast_tree(node, device: torch.device, dtype: torch.dtype, key=None):
    """Every tensor of the tree on ``device`` in ``dtype`` (the MoE router
    and PR-MoE coefficient in f32); a :class:`QuantizedWeight` moves with
    its codes and scales uncast."""
    if isinstance(node, dict):
        return {k: _cast_tree(v, device, dtype, k) for k, v in node.items()}
    if isinstance(node, QuantizedWeight):
        return node.to(device)
    if not isinstance(node, torch.Tensor):
        raise NotImplementedError(
            f"parameter leaf of type {type(node).__name__}: LoRA weights "
            "arrive with the adapter slice (ROADMAP.md A7)")
    return node.to(device=device,
                   dtype=torch.float32 if key in _F32_LEAVES else dtype)


class InferenceEngineV2:
    """Reference surface: ``put(prompt) -> uid``, ``step() -> {uid:
    [tokens]}``, and ``generate_all`` driving requests to completion.

    ``params`` is the port's parameter tree (``tfm.init_params`` or
    ``tfm.params_from_jax``); it is cast once to the compute dtype on
    ``device``, which defaults to ``"cuda"`` (``RuntimeError`` when CUDA
    is absent and the caller did not ask for ``"cpu"``)."""

    def __init__(self, model_config: tfm.TransformerConfig, params: Any,
                 config: Optional[V2Config] = None, device: Any = "cuda"):
        self.device = resolve_device(device)
        if (getattr(model_config, "num_experts", 0) > 0 and
                getattr(model_config, "moe_routing", "capacity")
                == "expert_choice"):
            raise ValueError(
                "expert_choice routing is non-causal — continuous-batching "
                "decode with it would route across unrelated requests; "
                "serve with moe_routing='capacity' or 'dropless'")
        if getattr(model_config, "position", "rope") == "alibi":
            raise NotImplementedError(
                "v2's paged attention takes no additive logit bias — ALiBi "
                "models (bloom) are served by the v1 engine, which is not "
                "ported yet (ROADMAP.md queue A item A8)")
        self.cfg = config or V2Config()
        _check_config(self.cfg)
        self.model_cfg = dataclasses.replace(model_config, dtype=self.cfg.dtype)
        dt = tfm.torch_dtype(self.cfg.dtype)
        if self.cfg.quantize_bits:
            # quantize the caller's raw weights before any cast, as the
            # reference does, so the codes and scales are its own
            params = quantize_on_host(params, self.cfg.quantize_bits,
                                      self.cfg.quantize_group, self.device)
        # cast once at load (the reference casts master weights per call)
        self.params = _cast_tree(params, self.device, dt)
        # one block reserved as write-scratch for padded tokens
        self.kv = KVCacheManager(self.cfg.num_blocks - 1, self.cfg.block_size,
                                 self.cfg.max_blocks_per_seq)
        self.builder = RaggedBatchBuilder(self.cfg.max_tokens_per_step,
                                          self.cfg.max_seqs,
                                          self.cfg.max_blocks_per_seq)
        mc = self.model_cfg
        shape = (mc.num_layers, self.cfg.num_blocks, self.cfg.block_size,
                 mc.kv_heads, mc.head_dim)
        self.caches = {"k": torch.zeros(shape, dtype=dt, device=self.device),
                       "v": torch.zeros(shape, dtype=dt, device=self.device)}
        self.rope = None
        if mc.position == "rope":
            self.rope = tfm.rope_table(
                self.cfg.max_blocks_per_seq * self.cfg.block_size,
                mc.rot_dim, mc.rope_theta, device=self.device)
        self.running: Dict[int, SequenceDescriptor] = {}
        self.waiting: Deque[SequenceDescriptor] = deque()
        self.table = DecodeStateTable(
            self.cfg.max_seqs, self.cfg.max_blocks_per_seq,
            self.cfg.max_blocks_per_seq * self.cfg.block_size)
        self._prefilling = 0  # running seqs still before their first token
        self.fast_steps = 0  # telemetry: SoA decode steps taken
        self.burst_steps = 0  # telemetry: multi-token bursts run
        self._uid = 0
        self._rng = 0
        #: f32 logits (max_seqs, vocab) of the latest mixed step (probes)
        self.last_logits: Optional[torch.Tensor] = None

    # -- capacity accessors ---------------------------------------------
    @property
    def total_blocks(self) -> int:
        return self.kv.allocator.num_blocks

    @property
    def free_blocks(self) -> int:
        return self.kv.allocator.free_blocks

    @property
    def num_running(self) -> int:
        return len(self.running)

    @property
    def num_waiting(self) -> int:
        return len(self.waiting)

    def _blocks_for(self, total_tokens: int) -> int:
        return -(-total_tokens // self.cfg.block_size)  # ceil

    def _reserved_by_waiting(self) -> int:
        return sum(self._blocks_for(s.cur_len - s.seen_tokens +
                                    s.max_new_tokens) for s in self.waiting)

    # -- request API ---------------------------------------------------
    def put(self, prompt_tokens: List[int], max_new_tokens: int = 64,
            strict: bool = False, temperature: Optional[float] = None,
            seed: int = 0, adapter_slot: int = 0) -> int:
        """Queue a request.  Raises :class:`AdmissionError` if it could
        never run (exceeds max context) or, with ``strict=True``, if no
        sequence slot or block budget is free right now.
        ``temperature``/``seed`` pin this request's sampling row;
        ``temperature=None`` inherits the scalar passed to :meth:`step`."""
        if adapter_slot:
            raise AdmissionError(
                "engine built without adapter_slots; adapter requests "
                "cannot run here")
        max_ctx = self.cfg.max_blocks_per_seq * self.cfg.block_size
        need = len(prompt_tokens) + max_new_tokens
        if need > max_ctx:
            raise AdmissionError(
                f"request needs {need} tokens of KV but max context is "
                f"{max_ctx} (max_blocks_per_seq * block_size); an admitted "
                "request could never be scheduled")
        if strict:
            if self.num_running + self.num_waiting >= self.cfg.max_seqs:
                raise AdmissionError(
                    f"all {self.cfg.max_seqs} sequence slots in use "
                    f"({self.num_running} running, {self.num_waiting} "
                    "waiting)")
            avail = self.free_blocks - self._reserved_by_waiting()
            if self._blocks_for(need) > avail:
                raise AdmissionError(
                    f"KV block pool exhausted: request needs "
                    f"{self._blocks_for(need)} blocks, {avail} unreserved")
        self._uid += 1
        self.waiting.append(SequenceDescriptor(
            uid=self._uid, tokens=list(prompt_tokens),
            max_new_tokens=max_new_tokens, temperature=temperature,
            seed=seed))
        return self._uid

    def _schedule(self) -> List[Tuple[SequenceDescriptor, int]]:
        """Dynamic SplitFuse: decode tokens first, then prefill chunks."""
        budget = self.cfg.max_tokens_per_step
        picks: List[Tuple[SequenceDescriptor, int]] = []
        for seq in list(self.running.values()):
            if len(picks) >= self.cfg.max_seqs or budget <= 0:
                break
            n = min(seq.cur_len - seq.seen_tokens, budget) or 1
            n = min(n, budget)
            if not self.kv.ensure_capacity(seq, n):
                continue  # stalled on memory this step
            picks.append((seq, n))
            budget -= n
        # admission reserves the request's ENTIRE block budget (prompt +
        # max_new_tokens) so an admitted sequence never stalls mid-decode
        while self.waiting and budget > 0 and len(picks) < self.cfg.max_seqs:
            seq = self.waiting[0]
            n = min(seq.cur_len - seq.seen_tokens, budget)
            total_needed = (seq.cur_len - seq.seen_tokens) + seq.max_new_tokens
            if n <= 0 or not self.kv.ensure_capacity(seq, total_needed):
                break
            self.waiting.popleft()
            self.running[seq.uid] = seq
            self.table.admit(seq)
            self._prefilling += 1
            picks.append((seq, n))
            budget -= n
        return picks

    def _flush_table(self) -> None:
        """Re-sync descriptors from the SoA rows before a mixed step."""
        for seq in self.running.values():
            self.table.flush_tokens(seq)

    def _finish(self, seq: SequenceDescriptor) -> None:
        seq.done = True
        self.table.retire(seq)
        self.kv.release(seq)
        del self.running[seq.uid]

    def cancel(self, uid: int) -> bool:
        """Abort a request mid-prefill or mid-decode and return its KV
        blocks.  False if the uid is unknown or already finished."""
        for seq in self.waiting:
            if seq.uid == uid:
                self.waiting.remove(seq)
                self.kv.release(seq)
                seq.done = True
                return True
        seq = self.running.get(uid)
        if seq is None:
            return False
        if not seq.in_decode:
            self._prefilling -= 1
        self._finish(seq)
        return True

    def _table_inputs(self):
        """Decode inputs straight off the SoA table, on the device:
        (next tokens, positions, block tables, context lens incl. the new
        token; inactive rows carry ctx 0)."""
        t = self.table
        ctx_in = ((t.ctx + 1) * t.active).astype(np.int32)
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                     for a in (t.next_tok, t.ctx, t.block_tables, ctx_in))

    def _row_temps(self, temperature: float) -> np.ndarray:
        """Per-row temperatures: pinned rows keep theirs, the rest (temp <
        0) inherit the step-level scalar."""
        t = self.table
        return np.where(t.temp >= 0.0, t.temp,
                        np.float32(temperature)).astype(np.float32)

    def _step_rng(self, rng: Optional[int]) -> int:
        if rng is None:
            self._rng, rng = split_key(self._rng)
        return rng

    def _advance_rows(self, sel: np.ndarray) -> np.ndarray:
        """Vectorized post-decode bookkeeping. ``sel``: (k, ns) new tokens
        for the active rows; retires sequences whose budget is exhausted."""
        t = self.table
        rows = np.nonzero(t.active)[0]
        k = sel.shape[0]
        t.hist[rows[:, None],
               t.hist_len[rows][:, None] + np.arange(k)[None, :]] = sel.T
        t.hist_len[rows] += k
        t.next_tok[rows] = sel[-1]
        t.ctx[rows] += k
        t.gen[rows] += k
        for r in rows[t.gen[rows] >= t.budget[rows]]:
            self._finish(t.seq_at[int(r)])
        return rows

    def _decode(self, tok, pos, bt, ctx):
        return decode_body(self.params, self.caches, tok, pos, bt, ctx,
                           self.model_cfg, self.cfg, self.rope)

    def _decode_step_fast(self, temperature: float,
                          rng: Optional[int]) -> Dict[int, List[int]]:
        """Steady-state decode: inputs ARE the table arrays; bookkeeping is
        vectorized; Python touches only sequences that just completed."""
        self.fast_steps += 1
        t = self.table
        tok, pos, bt, ctx_in = self._table_inputs()
        logits = self._decode(tok, pos, bt, ctx_in)
        sampled = sample_rows(logits, self._row_temps(temperature),
                              self._step_rng(rng), t.seed).cpu().numpy()
        rows = np.nonzero(t.active)[0]
        sel = sampled[rows].astype(np.int32)[None, :]  # (1, ns)
        out = {t.seq_at[int(r)].uid: [int(s)] for r, s in zip(rows, sel[0])}
        self._advance_rows(sel)
        return out

    def step(self, temperature: float = 0.0, rng: Optional[int] = None
             ) -> Dict[int, List[int]]:
        """One continuous-batching step -> {uid: [new token]} for the
        sequences that produced a token (prefill finished, or decode)."""
        return self._step_impl(temperature=temperature, rng=rng)

    def _step_impl(self, temperature: float = 0.0,
                   rng: Optional[int] = None) -> Dict[int, List[int]]:
        if not self.waiting and self.running and self._prefilling == 0:
            return self._decode_step_fast(temperature, rng)
        self._flush_table()
        picks = self._schedule()
        if not picks:
            if self.running:
                raise RuntimeError(
                    "scheduler made no progress with running sequences — "
                    "KV reservation invariant violated (bug)")
            return {}
        batch = self.builder.build(picks)
        logits = ragged_forward(self.params, self.caches, batch,
                                self.model_cfg, self.cfg, self.rope)
        self.last_logits = logits
        # pick rows carry their request's pinned temperature and seed,
        # padding rows stay greedy
        temps = np.zeros(self.cfg.max_seqs, np.float32)
        seeds = np.zeros(self.cfg.max_seqs, np.int32)
        for row, (seq, _) in enumerate(picks):
            temps[row] = (temperature if seq.temperature is None
                          else seq.temperature)
            seeds[row] = np.int32(np.uint32(seq.seed & 0xFFFFFFFF))
        sampled = sample_rows(logits, temps, self._step_rng(rng),
                              seeds).cpu().numpy()

        out: Dict[int, List[int]] = {}
        for row, (seq, n) in enumerate(picks):
            seq.seen_tokens += n
            if seq.seen_tokens >= seq.cur_len:  # produced a next token
                tok = int(sampled[row])
                seq.tokens.append(tok)
                seq.generated += 1
                out[seq.uid] = [tok]
                if not seq.in_decode:
                    seq.in_decode = True
                    self._prefilling -= 1
                if seq.generated >= seq.max_new_tokens:
                    self._finish(seq)
            if seq.uid in self.table.row_of:
                self.table.sync(seq)
        return out

    def _burst_decode(self, k: int, temperature: float = 0.0,
                      rng: Optional[int] = None) -> None:
        """Decode ``k`` tokens for every running sequence in a loop that
        stays on the device; the tokens come back to the host once, at the
        end (blocks were reserved at admission)."""
        t = self.table
        tok, pos, bt, ctx = self._table_inputs()
        # rows inactive at entry must STAY inactive: advancing their ctx/pos
        # would flip them "active" with a zeroed block table and corrupt
        # block 0 of a real sequence
        alive = (ctx > 0).to(ctx.dtype)
        temps = self._row_temps(temperature)
        rng = self._step_rng(rng)
        toks = []
        for _ in range(k):
            logits = self._decode(tok, pos, bt, ctx)
            rng, step_rng = split_key(rng)
            tok = sample_rows(logits, temps, step_rng, t.seed)
            toks.append(tok)
            pos = pos + alive
            ctx = ctx + alive
        toks = torch.stack(toks).cpu().numpy()  # (k, max_seqs)
        rows = np.nonzero(t.active)[0]
        self._advance_rows(toks[:, rows].astype(np.int32))

    def generate_all(self, temperature: float = 0.0, seed: int = 0,
                     max_steps: int = 10000, burst: int = 8
                     ) -> Dict[int, List[int]]:
        """Drive until every queued request completes.  Decode runs in
        ``burst``-token bursts when every running sequence is in decode,
        clamped to the smallest remaining budget."""
        tracked = {s.uid: s for s in list(self.waiting)} | dict(self.running)
        rng = _mix64(seed & _MASK64)
        for _ in range(max_steps):
            if not self.waiting and not self.running:
                break
            t = self.table
            steady = (burst > 1 and not self.waiting and self.running
                      and self._prefilling == 0)
            if steady:
                eff = min(burst, int((t.budget - t.gen)[t.active].min()))
                if eff > 1:
                    rng, burst_rng = split_key(rng)
                    self._burst_decode(eff, temperature=temperature,
                                       rng=burst_rng)
                    self.burst_steps += 1
                    continue
            rng, step_rng = split_key(rng)
            self.step(temperature=temperature, rng=step_rng)
        self._flush_table()  # max_steps exhaustion: sync still-running seqs
        return {uid: seq.tokens for uid, seq in tracked.items()}
