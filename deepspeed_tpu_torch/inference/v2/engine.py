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

The serving memory hierarchy is the reference's, host logic copied:
``enable_prefix_cache`` shares full KV blocks across requests through the
radix tree of ``prefix_cache.py`` (a partial-block divergence forks a
copy-on-write block: one in-place ``copy_`` across all layers of both
pools), so a hit prefills only its uncached suffix, from an arbitrary
``chunk_start``; ``kv_host_pool_mb``/``kv_host_pool_bytes`` demote cold
blocks to host DRAM instead of evicting them (``paging.py``: one D2H copy
of a block across all layers; promotion is one H2D copy into a fresh
block), ``kv_spill_dir`` or ``kv_coldstore_dir`` (``coldstore.py``, crash
durable, re-adopted by :meth:`InferenceEngineV2.rehydrate_coldstore`)
take the host pool's overflow, and ``kv_promote_ahead`` lifts disk
entries to host memory on a background thread.  Every CUDA copy stays on
the engine's thread, at admission and at a request's finish, never inside
a decode body.  :meth:`InferenceEngineV2.step` records an ``engine/step``
span and a flight-recorder step around its body
(``observability/``), as the reference does.

``spec_mode="draft" | "self_draft"`` decodes speculatively
(``spec.py``): a draft model on its own mirrored paged pool, or
Medusa-style heads on the carried hidden state, propose ``spec_k`` tokens
that one multi-position verify forward (the paged prefill kernel from
``chunk_start = ctx``) accepts or corrects; greedy output stays token for
token the non-speculative decode.  ``adapter_slots``/``adapter_rank``
serve many LoRA adapters over one base (``serving/adapters.py`` pages
them in and out of the device stack): each row gathers its slot's
factors and adds the low-rank delta to its attention projections, in
plain torch; slot 0 is the all-zero null adapter.  ALiBi models are
refused with ``NotImplementedError`` naming the later slice
(``ROADMAP.md``) that brings them.
"""

from __future__ import annotations

import dataclasses
import json
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...accelerator import resolve_device
from ...linear.optimized_linear import LoRAWeight, QuantizedBaseWeight
from ...linear.spec_heads import init_spec_heads
from ...models import transformer as tfm
from ...observability.recorder import recorder
from ...observability.trace import tracer
from ...ops.hopper.mixed_gemm import QuantizedWeight
from ...ops.hopper import paged_attention as paged
from ...ops.hopper.paged_attention import (paged_decode_attention,
                                           paged_prefill_attention)
from ...utils import faults
from ...utils.tree_io import node_items
from ..quantization import quantize_on_host
from .coldstore import ColdStore
from .paging import BlockPager, deserialize_block, serialize_block
from .prefix_cache import PrefixCache, chain_tokens, prefix_digests
from .ragged import (DecodeStateTable, KVCacheManager, RaggedBatch,
                     RaggedBatchBuilder, SequenceDescriptor)
from .spec import draft_model_step, self_draft_step, verify_inputs


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


#: V2Config fields whose non-default value turns on a feature the port
#: does not carry yet -> the ROADMAP.md queue-A item that brings it (none
#: left: the port takes every V2Config the reference takes)
_LATER: Dict[str, str] = {}


def _check_config(cfg: V2Config) -> None:
    default = V2Config()
    for name, item in _LATER.items():
        if getattr(cfg, name) != getattr(default, name):
            raise NotImplementedError(
                f"V2Config.{name}={getattr(cfg, name)!r} is not ported yet: "
                f"it arrives with ROADMAP.md queue A item {item}")


def check_card_coverage(model_config: tfm.TransformerConfig, dtype: str,
                        what: str = "model") -> None:
    """On the card every attention call of the engine runs the paged
    kernels (B4, B5).  A model that no instantiation of theirs covers is
    refused here, at construction, naming its ROADMAP.md item (port rule
    6), instead of raising at its first step."""
    dt = tfm.torch_dtype(dtype)
    H, KV, D = (model_config.num_heads, model_config.kv_heads,
                model_config.head_dim)
    if not paged.kernels_cover(dt, H, KV, D):
        raise NotImplementedError(
            f"{what} in {dtype} with H={H}, KV={KV}, head dim {D} on the "
            f"card: the paged attention kernels (B4, B5) take "
            f"{paged.coverage()}; another instantiation arrives with "
            f"ROADMAP.md queue B, coverage")


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
# batched heterogeneous-adapter LoRA (S-LoRA / Punica shape)
# ---------------------------------------------------------------------------

#: projections the device adapter stack carries deltas for: the attention
#: projections (classic LoRA targets); MLP-targeted adapters are refused
#: at registry load, never silently dropped
ADAPTER_TARGETS = ("wq", "wk", "wv", "wo")


def adapter_target_shapes(model_cfg: tfm.TransformerConfig
                          ) -> Dict[str, Tuple[int, int]]:
    """(K, N) of each stackable projection: what a loaded adapter's
    ``lora_a (L, K, r)`` / ``lora_b (L, r, N)`` must match."""
    H = model_cfg.hidden_size
    qd = model_cfg.num_heads * model_cfg.head_dim
    kvd = model_cfg.kv_heads * model_cfg.head_dim
    return {"wq": (H, qd), "wk": (H, kvd), "wv": (H, kvd), "wo": (qd, H)}


def init_adapter_stack(model_cfg: tfm.TransformerConfig, v2: "V2Config",
                       device: torch.device) -> Dict[str, Dict[str,
                                                               torch.Tensor]]:
    """All-zero device adapter stack: per target, ``a (L, slots, K, r)``
    and ``b (L, slots, r, N)`` in the compute dtype.  Slot 0 stays zero
    (the null adapter); ``serving/adapters.py`` pages adapters in and out
    of slots ``1..slots-1`` with ``set_adapter_slot``."""
    dt = tfm.torch_dtype(v2.dtype)
    L, S, r = model_cfg.num_layers, v2.adapter_slots, v2.adapter_rank
    return {name: {"a": torch.zeros((L, S, K, r), dtype=dt, device=device),
                   "b": torch.zeros((L, S, r, N), dtype=dt, device=device)}
            for name, (K, N) in adapter_target_shapes(model_cfg).items()}


def _adapter_proj_delta(x: torch.Tensor, ab: Dict[str, torch.Tensor],
                        slots: torch.Tensor) -> torch.Tensor:
    """Per-row gathered low-rank delta of one projection: row ``t`` adds
    ``(x_t @ A[slots_t]) @ B[slots_t]`` (scaling folded into B at load).
    ``x`` (T, K); ``ab`` this layer's stacked factors ``{"a": (slots, K,
    r), "b": (slots, r, N)}``; ``slots`` (T,) on the device.  A gather and
    two thin batched matmuls, no host sync; rows on the null slot add an
    exact zero."""
    xa = torch.bmm(x[:, None, :], ab["a"][slots])  # (T, 1, r)
    return torch.bmm(xa, ab["b"][slots])[:, 0]


def _layer_adapters(adapters, i: int):
    """Layer ``i``'s slice of the adapter stack (views), or ``None``."""
    if adapters is None:
        return None
    return {name: {"a": st["a"][i], "b": st["b"][i]}
            for name, st in adapters.items()}


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


def _layer(x, lp, k_cache, v_cache, q_rope, attend, cfg, write_at,
           ad=None, slots=None, ffn_shape=None):
    """One decoder layer over tokens ``x`` (T, hidden): projections (plus
    each row's adapter delta where ``ad``, this layer's adapter stack, is
    given with the tokens' ``slots``), RoPE, the in-place KV write at
    ``write_at`` = (block ids, offsets), attention through ``attend(q) ->
    o`` (T, H, D), output projection and MLP (over ``ffn_shape`` + (hidden,),
    default (1, T): the batch layout MoE routing sees)."""
    T = x.shape[0]
    nh, nkv, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    a_in = tfm._norm(x, lp["ln1"], cfg.norm, cfg.norm_eps)
    proj = {}
    for name, bias in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")):
        proj[name] = tfm._lin(a_in, lp["attn"], name, bias)
        if ad is not None and name in ad:
            proj[name] = proj[name] + _adapter_proj_delta(a_in, ad[name],
                                                          slots)
    q = proj["wq"].reshape(T, nh, hd)
    k = proj["wk"].reshape(T, nkv, hd)
    v = proj["wv"].reshape(T, nkv, hd)
    if q_rope is not None:
        cos, sin = q_rope
        q = tfm.apply_rope(q[None], cos, sin)[0]
        k = tfm.apply_rope(k[None], cos, sin)[0]
    # in place: the reference's donated functional cache update
    k_cache[write_at] = k.to(k_cache.dtype)
    v_cache[write_at] = v.to(v_cache.dtype)
    o = attend(q.contiguous()).reshape(T, nh * hd)
    attn_out = tfm._lin(o, lp["attn"], "wo", "bo")
    if ad is not None and "wo" in ad:
        attn_out = attn_out + _adapter_proj_delta(o, ad["wo"], slots)
    m_src = x if cfg.parallel_residual else x + attn_out
    m_in = tfm._norm(m_src, lp["ln2"], cfg.norm, cfg.norm_eps)
    # MoE layers route every one of the T rows, padding and inactive rows
    # included, as the reference does: capacity routing drops tokens by
    # their position among exactly these rows
    shape = ffn_shape or (1, T)
    mlp_out = tfm.ffn_block(m_in.reshape(*shape, -1), lp, cfg).reshape(T, -1)
    return (x + attn_out + mlp_out) if cfg.parallel_residual \
        else (m_src + mlp_out)


@torch.no_grad()
def ragged_forward(params, caches, batch: RaggedBatch,
                   model_cfg: tfm.TransformerConfig, v2: V2Config,
                   rope: Optional[Tuple[torch.Tensor, torch.Tensor]],
                   adapters=None, row_slots: Optional[np.ndarray] = None,
                   return_hidden: bool = False):
    """One mixed (prefill + decode) step over a ragged batch: writes the
    batch's KV into ``caches`` in place and returns f32 logits
    (max_seqs, vocab) at each sequence's last token.  With ``adapters``
    (the device stack) and ``row_slots`` (host (max_seqs,), the pick rows'
    slots), each token adds its row's adapter delta; padding tokens take
    the null slot.  ``return_hidden``: also return the f32 final-norm
    hidden state at those tokens (max_seqs, hidden), the state the
    self-draft heads propose from."""
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
    slots = None
    if adapters is not None:
        tok_slot = np.where(batch.seq_index >= 0, np.asarray(row_slots)[
            np.clip(batch.seq_index, 0, max_seqs - 1)], 0)
        slots = to_dev(tok_slot.astype(np.int64))

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
                   attend, model_cfg, write_at,
                   ad=_layer_adapters(adapters, i), slots=slots)
    x = tfm._norm(x, params["final_norm"], model_cfg.norm, model_cfg.norm_eps)
    last = x[to_dev(batch.logits_rows).long()]
    logits = _lm_head(params, last, model_cfg)
    return (logits, last.float()) if return_hidden else logits


@torch.no_grad()
def decode_body(params, caches, token_ids: torch.Tensor,
                position_ids: torch.Tensor, block_tables: torch.Tensor,
                context_lens: torch.Tensor, model_cfg: tfm.TransformerConfig,
                v2: V2Config, rope, adapters=None,
                row_slots: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-token decode for every row (device tensors; context_lens
    INCLUDE the current token, inactive rows carry 0 and park their KV
    write in the scratch block).  ``adapters`` and ``row_slots`` (S,) on
    the device: each row adds its adapter slot's delta.  Returns f32
    logits (max_seqs, vocab).

    Positions past the table's last one (a draft iteration beyond a row's
    reservation) read the last rope row and block column, as the
    reference's clamped gathers do; their writes park in scratch."""
    bs = v2.block_size
    S = token_ids.shape[0]
    pos = position_ids.long().clamp(max=block_tables.shape[1] * bs - 1)
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
                   attend, model_cfg, write_at,
                   ad=_layer_adapters(adapters, i), slots=row_slots)
    x = tfm._norm(x, params["final_norm"], model_cfg.norm, model_cfg.norm_eps)
    return _lm_head(params, x, model_cfg)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


# leaves the reference reads in f32 whatever the compute dtype
# (``x.astype(f32) @ p["router"].astype(f32)``, PR-MoE's ``coef``)
_F32_LEAVES = ("router", "coef")


def _structure(node):
    """A parameter tree's nesting and leaf kinds, for ``swap_params`` (a
    LoRA node and its quantized base nest as dicts do)."""
    items = node_items(node)
    if items is None:
        return type(node).__name__
    return (type(node).__name__, {k: _structure(v) for k, v in items})


def _cast_tree(node, device: torch.device, dtype: torch.dtype, key=None):
    """Every tensor of the tree on ``device`` in ``dtype`` (the MoE router
    and PR-MoE coefficient in f32); a :class:`QuantizedWeight` or a LoRA
    node's quantized base moves with its codes and scales uncast.  An
    unmerged LoRA tree is served as the reference's v2 serves it: each
    LoRA projection runs ``lora_forward`` (a dense base and the factors
    cast once here, where the reference casts them per call)."""
    if isinstance(node, dict):
        return {k: _cast_tree(v, device, dtype, k) for k, v in node.items()}
    if isinstance(node, (QuantizedWeight, QuantizedBaseWeight)):
        return node.to(device)
    if isinstance(node, LoRAWeight):
        return dataclasses.replace(
            node, base=_cast_tree(node.base, device, dtype),
            lora_a=_cast_tree(node.lora_a, device, dtype),
            lora_b=_cast_tree(node.lora_b, device, dtype))
    if not isinstance(node, torch.Tensor):
        raise TypeError(f"parameter leaf of type {type(node).__name__} is "
                        "not a tensor")
    return node.to(device=device,
                   dtype=torch.float32 if key in _F32_LEAVES else dtype)


class InferenceEngineV2:
    """Reference surface: ``put(prompt) -> uid``, ``step() -> {uid:
    [tokens]}``, and ``generate_all`` driving requests to completion.

    ``params`` is the port's parameter tree (``tfm.init_params`` or
    ``tfm.params_from_jax``); it is cast once to the compute dtype on
    ``device``, which defaults to ``"cuda"`` (``RuntimeError`` when CUDA
    is absent and the caller did not ask for ``"cpu"``).  With
    ``spec_mode="draft"``, ``draft_params``/``draft_config`` are the draft
    model (cast the same way); with ``"self_draft"``, ``spec_heads`` are
    the heads (``linear/spec_heads.py``; default: seeded from the lm
    head)."""

    def __init__(self, model_config: tfm.TransformerConfig, params: Any,
                 config: Optional[V2Config] = None,
                 draft_params: Any = None,
                 draft_config: Optional[tfm.TransformerConfig] = None,
                 spec_heads: Any = None, device: Any = "cuda"):
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
                "models (bloom) are served by the v1 engine "
                "(deepspeed_tpu_torch.init_inference)")
        self.cfg = config or V2Config()
        _check_config(self.cfg)
        self.model_cfg = dataclasses.replace(model_config, dtype=self.cfg.dtype)
        if self.device.type == "cuda":
            check_card_coverage(self.model_cfg, self.cfg.dtype)
        dt = tfm.torch_dtype(self.cfg.dtype)
        if self.cfg.quantize_bits:
            # quantize the caller's raw weights before any cast, as the
            # reference does, so the codes and scales are its own
            params = quantize_on_host(params, self.cfg.quantize_bits,
                                      self.cfg.quantize_group, self.device)
        # cast once at load (the reference casts master weights per call)
        self.params = _cast_tree(params, self.device, dt)
        self._prev_params = None
        #: which weights the engine serves: 0 at load, a new number at
        #: every swap, the previous one again at a rollback (port only; a
        #: broker records it beside each request's tokens)
        self.params_version = 0
        self._versions_issued = 0
        self._prev_version: Optional[int] = None
        #: step() calls by kind ("mixed", "decode", "spec"): what a serving
        #: worker reports beside its kernel launch counts
        self.steps_by_kind: Dict[str, int] = {}
        # device adapter stack for multi-tenant LoRA routing (slot 0 is the
        # reserved all-zero null adapter; serving/adapters.py owns 1..N-1)
        self.adapter_stack = None
        if self.cfg.adapter_slots:
            if self.cfg.adapter_slots < 2:
                raise ValueError(
                    "adapter_slots must be >= 2 when enabled (slot 0 is "
                    "the reserved null adapter)")
            if self.cfg.adapter_rank <= 0:
                raise ValueError(
                    "adapter_slots > 0 requires adapter_rank > 0")
            if self.cfg.spec_mode == "draft":
                raise ValueError(
                    "adapter routing composes with spec_mode='self_draft' "
                    "only — the separate draft model has no adapter stack "
                    "to stay consistent with per-row deltas")
            self.adapter_stack = init_adapter_stack(self.model_cfg, self.cfg,
                                                    self.device)
        # one block reserved as write-scratch for padded tokens
        self.kv = KVCacheManager(self.cfg.num_blocks - 1, self.cfg.block_size,
                                 self.cfg.max_blocks_per_seq)
        self.prefix_cache = None
        self.pager = None
        if self.cfg.enable_prefix_cache:
            self.prefix_cache = PrefixCache(
                self.kv.allocator, self.cfg.block_size,
                min_prefix_tokens=self.cfg.prefix_cache_min_tokens,
                eviction=self.cfg.prefix_eviction)
            self.kv.prefix_cache = self.prefix_cache
            if self.cfg.kv_host_pool_mb > 0 or self.cfg.kv_host_pool_bytes:
                cold = (ColdStore(self.cfg.kv_coldstore_dir)
                        if self.cfg.kv_coldstore_dir else None)
                self.pager = BlockPager(
                    host_bytes=(self.cfg.kv_host_pool_bytes
                                or self.cfg.kv_host_pool_mb << 20),
                    spill_dir=self.cfg.kv_spill_dir,
                    promote_ahead=self.cfg.kv_promote_ahead,
                    coldstore=cold)
                self.prefix_cache.attach_pager(
                    self.pager, self._demote_node, self._promote_node)
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
        self._init_spec(draft_params, draft_config, spec_heads, dt)

    def _init_spec(self, draft_params, draft_config, spec_heads,
                   dt: torch.dtype) -> None:
        """Speculative decoding state (``spec.py``): validation, the draft
        model and its pool, or the self-draft heads and the carried
        hidden state."""
        mode = self.cfg.spec_mode
        if mode not in ("off", "draft", "self_draft"):
            raise ValueError(f"unknown spec_mode {mode!r}")
        if mode != "off" and self.cfg.spec_k < 1:
            raise ValueError("spec_k must be >= 1 when speculation is on")
        self.spec_heads = None
        self.draft_params = None
        self.draft_cfg = None
        self._draft_caches = None
        self._draft_rope = None
        # carried final-norm hidden state at each row's last accepted
        # position, on the device: what the self-draft heads propose from
        self._spec_hidden = torch.zeros(
            (self.cfg.max_seqs, self.model_cfg.hidden_size),
            dtype=torch.float32, device=self.device)
        self.spec_steps = 0
        self.spec_proposed = 0  # draft tokens offered to verification
        self.spec_accepted = 0  # draft tokens that made it into the output
        self.spec_emitted = 0  # total tokens emitted by spec steps
        self.spec_fallback = 0  # mixed steps taken while speculation is on
        if mode == "self_draft":
            if spec_heads is None:
                # untrained heads still decode exactly (acceptance is just
                # lower); w2 seeded from the base lm head
                spec_heads = init_spec_heads(
                    torch.Generator(device=self.device).manual_seed(1),
                    self.model_cfg, self.cfg.spec_k, base_params=self.params)
            self.spec_heads = {name: torch.as_tensor(v).to(
                self.device, torch.float32) for name, v in spec_heads.items()}
        elif mode == "draft":
            if draft_params is None or draft_config is None:
                raise ValueError(
                    "spec_mode='draft' needs draft_params and draft_config")
            self.draft_cfg = dataclasses.replace(draft_config,
                                                 dtype=self.cfg.dtype)
            if self.device.type == "cuda":
                check_card_coverage(self.draft_cfg, self.cfg.dtype,
                                    "draft model")
            self.draft_params = _cast_tree(draft_params, self.device, dt)
            dshape = (self.draft_cfg.num_layers, self.cfg.num_blocks,
                      self.cfg.block_size, self.draft_cfg.kv_heads,
                      self.draft_cfg.head_dim)
            self._draft_caches = {
                "k": torch.zeros(dshape, dtype=dt, device=self.device),
                "v": torch.zeros(dshape, dtype=dt, device=self.device)}
            if self.draft_cfg.position == "rope":
                self._draft_rope = tfm.rope_table(
                    self.cfg.max_blocks_per_seq * self.cfg.block_size,
                    self.draft_cfg.rot_dim, self.draft_cfg.rope_theta,
                    device=self.device)

    @property
    def _spec_on(self) -> bool:
        return self.cfg.spec_mode != "off"

    # -- rolling weight swaps --------------------------------------------

    def swap_params(self, raw_params: Any) -> None:
        """Point the engine at a new parameter tree (rolling weight swap).
        ``raw_params`` is the UNQUANTIZED tree; the engine re-applies its
        own quantization, so a quantized deployment swaps into quantized
        weights, and casts it as at load.  The previous tree is kept for
        :meth:`swap_rollback`.  Only between steps on a drained engine:
        swapping mid-request would mix weight generations in one
        stream."""
        if self.cfg.quantize_bits:
            raw_params = quantize_on_host(raw_params, self.cfg.quantize_bits,
                                          self.cfg.quantize_group,
                                          self.device)
        if _structure(raw_params) != _structure(self.params):
            raise ValueError("swap_params: incoming pytree structure does "
                             "not match the serving model")
        self._prev_params = self.params
        self.params = _cast_tree(raw_params, self.device,
                                 tfm.torch_dtype(self.cfg.dtype))
        self._prev_version = self.params_version
        self._versions_issued += 1
        self.params_version = self._versions_issued

    def swap_rollback(self) -> None:
        """Restore the pre-swap weights (failed post-swap probe)."""
        if self._prev_params is None:
            raise RuntimeError("swap_rollback: no previous params retained")
        self.params = self._prev_params
        self._prev_params = None
        self.params_version = self._prev_version

    # -- device adapter stack (serving/adapters.py) ----------------------

    def set_adapter_slot(self, slot: int, pack: Dict[str, Tuple[Any, Any]]
                         ) -> None:
        """Load one adapter's stacked factors into device slot ``slot``.

        ``pack`` maps target names (a subset of :data:`ADAPTER_TARGETS`) to
        ``(lora_a (L, K, r), lora_b (L, r, N))`` host arrays or tensors,
        scaling folded into ``lora_b`` and rank padded to
        ``adapter_rank``.  Targets absent from the pack keep zeros.  One
        in-place copy per factor; engine thread only."""
        if self.adapter_stack is None:
            raise RuntimeError("engine built without adapter_slots")
        if not (0 < slot < self.cfg.adapter_slots):
            raise ValueError(
                f"slot must be in 1..{self.cfg.adapter_slots - 1} "
                f"(0 is the null adapter), got {slot}")
        stack = self.adapter_stack
        for name, (a, b) in pack.items():
            if name not in stack:
                raise ValueError(
                    f"unsupported adapter target {name!r}; the device "
                    f"stack carries {sorted(stack)}")
            tgt = stack[name]
            want_a = tgt["a"].shape[:1] + tgt["a"].shape[2:]
            want_b = tgt["b"].shape[:1] + tgt["b"].shape[2:]
            if tuple(a.shape) != tuple(want_a) or \
                    tuple(b.shape) != tuple(want_b):
                raise ValueError(
                    f"adapter target {name!r} shape mismatch: got "
                    f"a{tuple(a.shape)}/b{tuple(b.shape)}, stack wants "
                    f"a{tuple(want_a)}/b{tuple(want_b)}")
        for name, (a, b) in pack.items():
            for half, x in (("a", a), ("b", b)):
                stack[name][half][:, slot].copy_(torch.as_tensor(x))

    def clear_adapter_slot(self, slot: int) -> None:
        """Zero a slot's factors (retire / demote): no row may reference
        it any more (the registry's refcounts guarantee that)."""
        if self.adapter_stack is None:
            raise RuntimeError("engine built without adapter_slots")
        if not (0 < slot < self.cfg.adapter_slots):
            raise ValueError(f"invalid adapter slot {slot}")
        for tgt in self.adapter_stack.values():
            tgt["a"][:, slot].zero_()
            tgt["b"][:, slot].zero_()

    def _adapter_rows(self) -> Optional[torch.Tensor]:
        """The decode table's per-row adapter slots on the device, or
        ``None`` without an adapter stack."""
        if self.adapter_stack is None:
            return None
        return torch.from_numpy(self.table.adapter.astype(np.int64)).to(
            self.device)

    # -- capacity accessors ---------------------------------------------
    @property
    def total_blocks(self) -> int:
        return self.kv.allocator.num_blocks

    @property
    def free_blocks(self) -> int:
        return self.kv.allocator.free_blocks

    @property
    def evictable_blocks(self) -> int:
        """Prefix-tree blocks no live sequence shares (refcount 1)."""
        return self.prefix_cache.evictable_blocks if self.prefix_cache else 0

    @property
    def reclaimable_blocks(self) -> int:
        """Evictable blocks admission control may treat as free (0 when
        the cache is off or the eviction policy is 'none')."""
        return (self.prefix_cache.reclaimable_blocks
                if self.prefix_cache else 0)

    @property
    def pinned_blocks(self) -> int:
        """Allocated blocks some live owner still needs — computed from
        allocator refcounts (NOT as total - free - evictable) so the leak
        invariant ``free + evictable + pinned == total`` is a real check."""
        alloc = self.kv.allocator
        live = sum(1 for b in range(alloc.num_blocks) if alloc.refcount(b) > 0)
        return live - self.evictable_blocks

    def prefix_stats(self) -> Dict[str, float]:
        """Prefix-cache counters + block-accounting gauges for serving
        metrics; all-zero (enabled=0) when the cache is off."""
        stats: Dict[str, float] = {
            "enabled": 0, "lookups": 0, "hits": 0, "hit_rate": 0.0,
            "prefill_tokens_skipped": 0, "evictions": 0, "cow_copies": 0,
            "cached_blocks": 0, "shared_blocks": 0, "evictable_blocks": 0,
            # memory-hierarchy tiers (paging.py)
            "tier_device_blocks": 0, "tier_host_blocks": 0,
            "tier_spill_blocks": 0, "demotions": 0, "promotions": 0,
            "promote_wait_ms": 0.0,
            # crash-durable cold tier (coldstore.py)
            "tier_cold_blocks": 0, "rehydrated_blocks": 0,
            "gc_spill_files": 0, "coldstore_entries": 0,
            "coldstore_bytes": 0, "coldstore_writes": 0,
            "coldstore_corrupt_dropped": 0, "coldstore_gc_tmp": 0,
        }
        if self.prefix_cache is not None:
            stats.update(self.prefix_cache.stats())
            stats["enabled"] = 1
        if self.pager is not None:
            stats["gc_spill_files"] = self.pager.gc_spill_files
            if self.pager.coldstore is not None:
                stats.update(self.pager.coldstore.stats())
        stats["pinned_blocks"] = self.pinned_blocks
        return stats

    def prefix_summary(self, max_digests: int = 1024) -> Dict[str, Any]:
        """Radix-tree digest summary for cache-aware routing (empty when
        the cache is off)."""
        if self.prefix_cache is None:
            return {"block_size": self.cfg.block_size, "digests": []}
        return self.prefix_cache.summary(max_digests)

    # -- KV handoff between replica classes (disaggregated serving) -----

    def export_prefix(self, tokens: List[int]) -> Optional[bytes]:
        """Serialize the longest cached full-block prefix of ``tokens`` as
        a safetensors payload: the k/v block data of the matched radix
        subtree, (L, n, block, kv heads, head dim) each, plus the covered
        token ids.  Byte for byte the reference engine's payload for the
        same cache, so either engine imports the other's.  Returns
        ``None`` when nothing is cached."""
        if self.prefix_cache is None:
            return None
        blocks, matched = self.prefix_cache.walk_full_blocks(tokens)
        if not blocks:
            return None
        try:
            idx = torch.tensor(blocks, dtype=torch.long, device=self.device)
            arrays = {name: self.caches[name].index_select(1, idx).cpu()
                      for name in ("k", "v")}
            meta = {
                "tokens": ",".join(str(int(t)) for t in tokens[:matched]),
                "block_size": str(self.cfg.block_size),
            }
            return serialize_block(arrays, meta)
        finally:
            self.kv.allocator.free(blocks)  # drop the export walk's pins

    def import_prefix(self, payload: bytes) -> int:
        """Adopt an exported prefix: allocate blocks, copy the k/v data
        into the paged caches, and donate the chain into the radix tree.
        Imports the longest leading run of blocks the pool can hold;
        returns the number of prompt tokens now cached locally."""
        if self.prefix_cache is None:
            return 0
        hlen = int.from_bytes(payload[:8], "little")
        meta = json.loads(payload[8:8 + hlen].decode()).get(
            "__metadata__", {})
        if int(meta.get("block_size", -1)) != self.cfg.block_size:
            return 0  # block-size mismatch: not transferable
        tokens = [int(t) for t in meta["tokens"].split(",") if t]
        tensors = deserialize_block(payload)
        k_arr, v_arr = tensors["k"], tensors["v"]
        n = k_arr.shape[1]
        alloc = self.kv.allocator
        if n > alloc.free_blocks:
            self.prefix_cache.evict(n - alloc.free_blocks)
        n = min(n, alloc.free_blocks)
        if n == 0:
            return 0
        blocks = alloc.allocate(n)
        idx = torch.tensor(blocks, dtype=torch.long, device=self.device)
        for name, arr in (("k", k_arr), ("v", v_arr)):
            cache = self.caches[name]
            cache.index_copy_(1, idx, arr[:, :n].to(self.device, cache.dtype))
        covered = n * self.cfg.block_size
        # donate adopts our references (or dedupes against already-cached
        # chunks by freeing the duplicate block)
        self.prefix_cache.donate(tokens[:covered], covered, blocks)
        return covered

    # -- serving memory hierarchy (paging.py, coldstore.py) --------------

    def _cow_copy(self, src: int, dst: int) -> None:
        """Copy one KV block to another across every layer of both pools,
        in place — the copy-on-write fork for partial-block prefix sharing.
        Positions past the shared prefix carry stale KV that the paged
        kernels never read: the step writes the chunk's KV before
        attention, and keys at or past ``context_lens`` are masked."""
        for cache in self.caches.values():
            cache[:, dst].copy_(cache[:, src])

    def _read_kv_block(self, block: int) -> Dict[str, torch.Tensor]:
        """One block's k/v across all layers as CPU tensors (L, block, kv
        heads, head dim): the pager's demote input, in the layout
        ``export_prefix`` ships between replicas.  Always a copy, also
        when the pool lies on the CPU."""
        return {name: self.caches[name][:, block].to("cpu", copy=True)
                for name in ("k", "v")}

    def _demote_node(self, node) -> Optional[Tuple[int, str]]:
        """Prefix-cache demote callback: copy the node's device block into
        the pager.  Returns ``(handle, tier)`` or ``None`` (pager full →
        the caller falls back to true eviction).

        With a cold store attached, the block also gets its *durable
        identity*: the chain digest of its full token prefix becomes the
        cold-store key, and the manifest meta carries the chain tokens —
        everything a restarted worker needs to rebuild the radix path in
        :meth:`rehydrate_coldstore`."""
        sp = tracer.begin("paging/demote", block=int(node.block))
        meta = key = None
        if self.pager.coldstore is not None:
            tokens = chain_tokens(node)
            bs = self.cfg.block_size
            key = "kv-" + prefix_digests(tokens, bs)[-1]
            meta = {"kind": "kv_block",
                    "tokens": ",".join(str(t) for t in tokens),
                    "block_size": str(bs)}
        res = self.pager.put(self._read_kv_block(node.block),
                             metadata=meta, durable_key=key)
        if res is None:
            tracer.end(sp, ok=False, full=True)
            return None
        handle, tier = res
        tracer.end(sp, ok=True, handle=handle, tier=tier)
        return handle, tier

    def rehydrate_coldstore(self) -> Dict[str, int]:
        """Restart rehydration: re-adopt the cold-store entries a crashed
        (or gracefully restarted) predecessor left behind, so resumed
        sessions promote instead of re-prefilling.

        Every entry is verified BEFORE adoption (sha256 manifest + its
        key recomputed from the chain tokens it claims) — a torn, corrupt
        or tampered entry is deleted and the prefix degrades to
        re-prefill, never to wrong tokens.  Entries whose ancestor chunks
        did not survive are orphans and are deleted too (a radix chunk is
        only reachable through its full chain).  Returns adoption counts;
        a no-op without a cold store or prefix cache."""
        out = {"adopted": 0, "orphaned": 0, "skipped": 0}
        pager = self.pager
        if (pager is None or pager.coldstore is None
                or self.prefix_cache is None):
            return out
        cs = pager.coldstore
        bs = self.cfg.block_size
        sp = tracer.begin("coldstore/rehydrate_kv")
        chains: List[Tuple[str, List[int], int]] = []
        for key, meta, nbytes in cs.entries():
            if meta.get("kind") != "kv_block":
                continue  # not ours (e.g. an adapter section sharing root)
            try:
                entry_bs = int(meta.get("block_size", -1))
                tokens = [int(t) for t in
                          str(meta.get("tokens", "")).split(",") if t]
            except ValueError:
                entry_bs, tokens = -1, []
            if (entry_bs != bs or not tokens or len(tokens) % bs != 0
                    or key != "kv-" + prefix_digests(tokens, bs)[-1]):
                cs.delete(key)  # wrong geometry or tampered meta
                out["skipped"] += 1
                continue
            chains.append((key, tokens, nbytes))
        chains.sort(key=lambda c: len(c[1]))  # parent-first (shallow first)
        for key, tokens, nbytes in chains:
            faults.maybe_fail("serving.coldstore.rehydrate")
            if cs.read(key) is None:  # verify-before-adopt; corrupt → GC'd
                out["skipped"] += 1
                continue
            handle = pager.adopt(key, nbytes)
            if handle is None:
                out["skipped"] += 1
                continue
            status = self.prefix_cache.adopt_demoted(tokens, handle,
                                                     tier="cold")
            if status == "adopted":
                out["adopted"] += 1
            elif status == "duplicate":
                # the chain is already in the tree, and its node may be
                # backed by this very durable entry — unwind the handle
                # bookkeeping WITHOUT deleting the shared entry
                pager.forget(handle)
                out["skipped"] += 1
            else:  # orphan: unreachable without its ancestors
                pager.drop(handle)  # unwind + delete the dead entry
                out["orphaned"] += 1
        tracer.end(sp, **out)
        return out

    def _promote_node(self, node) -> bool:
        """Prefix-cache promote callback: fetch a demoted node's bytes
        (staged by the promote-ahead thread when enabled) and copy them
        into a freshly-allocated device block — ``import_prefix``'s path,
        so the step's kernels never change."""
        t0 = time.perf_counter()
        sp = tracer.begin("paging/promote", handle=int(node.handle or -1),
                          tier=node.tier)
        arrays = self.pager.get(node.handle)
        if arrays is None:
            tracer.end(sp, ok=False, lost=True)
            return False
        alloc = self.kv.allocator
        if alloc.free_blocks == 0:
            # make room by demoting a colder node (walked-path ancestors
            # are pinned by match(), so they are never victims)
            self.prefix_cache.evict(1)
        if alloc.free_blocks == 0:
            tracer.end(sp, ok=False)
            return False  # match stops here; the tail prefills normally
        (dst,) = alloc.allocate(1)
        for name in ("k", "v"):
            self.caches[name][:, dst].copy_(arrays[name])
        handle = node.handle
        node.block = dst
        node.tier = "device"
        node.handle = None
        self.pager.drop(handle)
        alloc.note_promote()
        wait_ms = (time.perf_counter() - t0) * 1e3
        self.pager.record_promote_wait(wait_ms)
        tracer.end(sp, ok=True, block=dst, wait_ms=wait_ms)
        return True

    def _prefetch_demoted(self, tokens: List[int]) -> None:
        """Promote-ahead: walk the radix tree read-only along a just-queued
        prompt and hand any demoted handles to the pager's background
        thread, so the disk→host half of their promotion overlaps the
        steps before this request is scheduled."""
        node = self.prefix_cache._root
        bs = self.cfg.block_size
        handles: List[int] = []
        matched = 0
        while matched + bs <= len(tokens):
            child = node.children.get(tuple(tokens[matched:matched + bs]))
            if child is None:
                break
            if child.tier != "device" and child.handle is not None:
                handles.append(child.handle)
            node = child
            matched += bs
        if handles:
            self.pager.prefetch(handles)

    def close(self) -> None:
        """Release paging resources (promote-ahead thread, spill writer).
        Safe to call more than once; a pagerless engine is a no-op."""
        if self.pager is not None:
            self.pager.close()

    def spec_stats(self) -> Dict[str, float]:
        """Speculative-decoding counters; ``enabled=0`` and all zero when
        ``spec_mode`` is 'off'.  ``acceptance_rate`` is accepted draft
        tokens over proposed ones (correction and bonus tokens count on
        neither side)."""
        on = self._spec_on
        return {
            "enabled": float(on),
            "k": float(self.cfg.spec_k) if on else 0.0,
            "steps": float(self.spec_steps),
            "proposed_tokens": float(self.spec_proposed),
            "accepted_tokens": float(self.spec_accepted),
            "emitted_tokens": float(self.spec_emitted),
            "acceptance_rate": (self.spec_accepted / self.spec_proposed
                                if self.spec_proposed else 0.0),
            "fallback_steps": float(self.spec_fallback),
        }

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
        ``temperature=None`` inherits the scalar passed to :meth:`step`.
        ``adapter_slot`` selects the adapter-stack slot the request's rows
        read (0: the base model, no delta)."""
        if adapter_slot:
            if self.adapter_stack is None:
                raise AdmissionError(
                    "engine built without adapter_slots; adapter requests "
                    "cannot run here")
            if not (0 < adapter_slot < self.cfg.adapter_slots):
                raise AdmissionError(
                    f"adapter_slot {adapter_slot} out of range "
                    f"1..{self.cfg.adapter_slots - 1}")
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
            # evictable prefix-cache blocks count as free: admission must
            # not starve on a warm cache (the scheduler evicts on demand)
            avail = (self.free_blocks + self.reclaimable_blocks
                     - self._reserved_by_waiting())
            if self._blocks_for(need) > avail:
                raise AdmissionError(
                    f"KV block pool exhausted: request needs "
                    f"{self._blocks_for(need)} blocks, {avail} unreserved")
        self._uid += 1
        self.waiting.append(SequenceDescriptor(
            uid=self._uid, tokens=list(prompt_tokens),
            max_new_tokens=max_new_tokens, temperature=temperature,
            seed=seed, adapter_slot=adapter_slot))
        if self.pager is not None and self.cfg.kv_promote_ahead:
            # overlap the disk→host half of any needed promotions with the
            # steps that run before the queue head is scheduled
            self._lookahead_prefetch()
        return self._uid

    def _lookahead_prefetch(self) -> None:
        """Promote-ahead keyed off the scheduler's admission lookahead:
        walk the waiting queue in admission order, bounded by the free
        sequence slots and the token budget the next ``_schedule`` will
        have, and prefetch demoted prefix blocks for exactly the requests
        that can land in the upcoming batch."""
        slots = self.cfg.max_seqs - self.num_running
        budget = self.cfg.max_tokens_per_step
        for seq in self.waiting:
            if slots <= 0 or budget <= 0:
                break
            self._prefetch_demoted(seq.tokens)
            slots -= 1
            budget -= min(len(seq.tokens), budget)

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
            # draft mode takes no prefix hits: a skipped prefill would
            # leave the DRAFT pool without KV for the shared tokens (the
            # tree indexes target blocks only); self-draft composes
            if (self.prefix_cache is not None and not seq.blocks
                    and seq.seen_tokens == 0
                    and self.cfg.spec_mode != "draft"):
                self._match_prefix(seq)
            n = min(seq.cur_len - seq.seen_tokens, budget)
            total_needed = (seq.cur_len - seq.seen_tokens) + seq.max_new_tokens
            if n <= 0 or not self.kv.ensure_capacity(seq, total_needed):
                if seq.blocks or seq.seen_tokens:
                    # roll the prefix match back — waiting sequences hold
                    # no blocks (admission-reservation invariant); the
                    # lookup is uncounted so stalls don't skew hit rate
                    self.kv.release(seq)
                    seq.seen_tokens = 0
                    self.prefix_cache.lookups -= 1
                break
            if seq.seen_tokens:
                self.prefix_cache.hits += 1
                self.prefix_cache.tokens_skipped += seq.seen_tokens
            self.waiting.popleft()
            self.running[seq.uid] = seq
            self.table.admit(seq)
            self._prefilling += 1
            picks.append((seq, n))
            budget -= n
        return picks

    def _match_prefix(self, seq: SequenceDescriptor) -> None:
        """Seed a waiting sequence's block table from the radix tree.

        Full shared blocks are pure block-table indirection; a
        partial-block divergence forks a private copy-on-write block on
        the device.  ``seen_tokens`` advances past the cached prefix so
        SplitFuse prefill starts at the first uncached token.  The
        scheduler rolls this back via ``kv.release`` if the sequence still
        cannot be admitted."""
        m = self.prefix_cache.match(seq.tokens, limit=seq.cur_len - 1)
        if m is None:
            return
        blocks = list(m.blocks)
        skipped = m.tokens
        if m.cow_src is not None:
            alloc = self.kv.allocator
            if alloc.free_blocks == 0:
                self.prefix_cache.evict(1)
            if (alloc.free_blocks > 0
                    and len(blocks) < self.cfg.max_blocks_per_seq):
                (dst,) = alloc.allocate(1)
                self._cow_copy(m.cow_src, dst)
                self.prefix_cache.cow_copies += 1
                blocks.append(dst)
                skipped += m.cow_tokens
            alloc.free([m.cow_src])  # drop match()'s pin on the source
        if skipped == 0:
            self.kv.allocator.free(blocks)
            return
        seq.blocks = blocks
        seq.seen_tokens = skipped

    def _flush_table(self) -> None:
        """Re-sync descriptors from the SoA rows before a mixed step."""
        for seq in self.running.values():
            self.table.flush_tokens(seq)

    def _finish(self, seq: SequenceDescriptor) -> None:
        seq.done = True
        self.table.retire(seq)
        if self.prefix_cache is not None and self.cfg.spec_mode != "draft":
            # donate full prefix blocks into the radix tree instead of
            # freeing them (retire() just flushed the SoA row, so
            # seen_tokens == tokens actually written to KV)
            self.prefix_cache.donate(seq.tokens, seq.seen_tokens, seq.blocks)
            seq.blocks = []
            if self.pager is not None:
                # demote-on-pressure: keep one sequence's worth of headroom
                # so the NEXT admission demotes nothing on its critical
                # path (the donate above may have just consumed it)
                short = (self.cfg.max_blocks_per_seq
                         - self.kv.allocator.free_blocks)
                if short > 0:
                    self.prefix_cache.evict(short)
        else:
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

    def _decode(self, tok, pos, bt, ctx, row_slots=None):
        return decode_body(self.params, self.caches, tok, pos, bt, ctx,
                           self.model_cfg, self.cfg, self.rope,
                           adapters=self.adapter_stack, row_slots=row_slots)

    def _decode_step_fast(self, temperature: float,
                          rng: Optional[int]) -> Dict[int, List[int]]:
        """Steady-state decode: inputs ARE the table arrays; bookkeeping is
        vectorized; Python touches only sequences that just completed."""
        self.fast_steps += 1
        t = self.table
        tok, pos, bt, ctx_in = self._table_inputs()
        logits = self._decode(tok, pos, bt, ctx_in, self._adapter_rows())
        sampled = sample_rows(logits, self._row_temps(temperature),
                              self._step_rng(rng), t.seed).cpu().numpy()
        rows = np.nonzero(t.active)[0]
        sel = sampled[rows].astype(np.int32)[None, :]  # (1, ns)
        out = {t.seq_at[int(r)].uid: [int(s)] for r, s in zip(rows, sel[0])}
        self._advance_rows(sel)
        return out

    def _spec_inputs(self) -> Dict[str, Any]:
        """Every device input of one speculative step, placed from the
        decode table before the step's device work starts (so that work,
        from the first draft to the accept, never waits on the host)."""
        t = self.table
        tok, ctx, bt, _ = self._table_inputs()
        vin = verify_inputs(t.ctx, t.block_tables, t.limit,
                            self.cfg.spec_k + 1, self.cfg.block_size,
                            self.caches["k"].shape[1] - 1, self.device)
        return {"next_tok": tok, "ctx": ctx, "block_tables": bt,
                "limit": torch.from_numpy(t.limit.astype(np.int32)).to(
                    self.device),
                "active": torch.from_numpy(t.ctx > 0).to(self.device),
                "row_slots": self._adapter_rows(), "vin": vin}

    def _spec_device(self, inputs: Dict[str, Any], rng: int,
                     temps: np.ndarray, seeds: np.ndarray
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The device work of one speculative step: propose, verify,
        accept.  Returns (emitted (max_seqs, k+1), accept_len (max_seqs,))
        on the device; self-draft also carries each active row's new
        hidden state, on the device."""
        if self.cfg.spec_mode == "self_draft":
            emitted, alen, hidden = self_draft_step(
                self.params, self.spec_heads, self.caches, inputs["next_tok"],
                inputs["vin"], self._spec_hidden, rng, temps, seeds,
                self.model_cfg, self.cfg, self.rope,
                adapters=self.adapter_stack, row_slots=inputs["row_slots"])
            self._spec_hidden = torch.where(inputs["active"][:, None],
                                            hidden, self._spec_hidden)
            return emitted, alen
        return draft_model_step(
            self.params, self.draft_params, self.caches, self._draft_caches,
            inputs["next_tok"], inputs["ctx"], inputs["block_tables"],
            inputs["limit"], inputs["vin"], rng, temps, seeds,
            self.model_cfg, self.draft_cfg, self.cfg, self.rope,
            self._draft_rope, self.cfg.spec_k)

    def _spec_decode_step(self, temperature: float,
                          rng: Optional[int]) -> Dict[int, List[int]]:
        """Steady-state speculative decode: one propose -> verify -> accept
        on the device emits 1..k+1 tokens per sequence; the host reads back
        the emitted tokens and accept lengths once.  Rejected-suffix KV
        needs no rollback (masked by the context lengths, overwritten next
        step), so prefix-cache refcounts never move."""
        self.fast_steps += 1
        self.spec_steps += 1
        t = self.table
        rng = self._step_rng(rng)
        temps = self._row_temps(temperature)
        emitted, alen = self._spec_device(self._spec_inputs(), rng, temps,
                                          t.seed)
        back = torch.cat([emitted, alen[:, None]], dim=1).cpu().numpy()
        emitted, alen = back[:, :-1], back[:, -1]
        out: Dict[int, List[int]] = {}
        k = self.cfg.spec_k
        # rows advance by their own accept lengths, so the vectorized
        # _advance_rows does not apply; a few scalar ops per active row
        for r in np.nonzero(t.active)[0]:
            r = int(r)
            seq = t.seq_at[r]
            # never emit past the request budget: the verify parks (and
            # the attention window ignores) positions >= t.limit
            take = int(min(alen[r] + 1, t.budget[r] - t.gen[r]))
            toks = emitted[r, :take].astype(np.int32)
            t.hist[r, t.hist_len[r]:t.hist_len[r] + take] = toks
            t.hist_len[r] += take
            t.next_tok[r] = toks[-1]
            t.ctx[r] += take
            t.gen[r] += take
            out[seq.uid] = toks.tolist()
            self.spec_proposed += k
            self.spec_accepted += int(min(int(alen[r]), take))
            self.spec_emitted += take
            if t.gen[r] >= t.budget[r]:
                self._finish(seq)
        return out

    def step(self, temperature: float = 0.0, rng: Optional[int] = None
             ) -> Dict[int, List[int]]:
        """One continuous-batching step -> {uid: [new tokens]} for the
        sequences that produced tokens (prefill finished, or decode):
        one token each, or 1..spec_k+1 in a speculative step.

        Instrumentation is host-side only (an ``engine/step`` span and a
        flight-recorder append around the untouched step body), so tracing
        changes no kernel launch."""
        steady = (not self.waiting and self.running
                  and self._prefilling == 0)
        kind = (("spec" if self._spec_on else "decode") if steady
                else "mixed")
        running, waiting = self.num_running, len(self.waiting)
        self.steps_by_kind[kind] = self.steps_by_kind.get(kind, 0) + 1
        prop0, acc0 = self.spec_proposed, self.spec_accepted
        t0 = time.monotonic()
        sp = tracer.begin("engine/step", kind=kind, running=running,
                          waiting=waiting, prefilling=self._prefilling)
        try:
            out = self._step_impl(temperature=temperature, rng=rng)
        except Exception:
            tracer.end(sp, error=True)
            raise
        emitted = sum(len(v) for v in out.values())
        attrs = {"emitted": emitted}
        if kind == "spec":
            attrs["proposed"] = self.spec_proposed - prop0
            attrs["accepted"] = self.spec_accepted - acc0
        tracer.end(sp, **attrs)
        recorder.record_step({
            "kind": kind, "t_start": t0, "t_end": time.monotonic(),
            "running": running, "waiting": waiting,
            "prefilling": self._prefilling, **attrs})
        return out

    def _step_impl(self, temperature: float = 0.0,
                   rng: Optional[int] = None) -> Dict[int, List[int]]:
        if not self.waiting and self.running and self._prefilling == 0:
            if self._spec_on:
                return self._spec_decode_step(temperature, rng)
            return self._decode_step_fast(temperature, rng)
        self._flush_table()
        picks = self._schedule()
        if not picks:
            if self.running:
                raise RuntimeError(
                    "scheduler made no progress with running sequences — "
                    "KV reservation invariant violated (bug)")
            return {}
        if self._spec_on:
            self.spec_fallback += 1  # a mixed step: no speculation
        batch = self.builder.build(picks)
        row_ad = None
        if self.adapter_stack is not None:
            # batch rows are picks order (seq_index indexes the picks, not
            # the decode table)
            row_ad = np.zeros(self.cfg.max_seqs, np.int64)
            for row, (seq, _) in enumerate(picks):
                row_ad[row] = seq.adapter_slot
        self_draft = self.cfg.spec_mode == "self_draft"
        res = ragged_forward(self.params, self.caches, batch,
                             self.model_cfg, self.cfg, self.rope,
                             adapters=self.adapter_stack, row_slots=row_ad,
                             return_hidden=self_draft)
        logits, hidden = res if self_draft else (res, None)
        if self.cfg.spec_mode == "draft":
            # mirror every target KV write into the draft pool (same block
            # tables) so the draft decodes from ctx without re-prefilling
            ragged_forward(self.draft_params, self._draft_caches, batch,
                           self.draft_cfg, self.cfg, self._draft_rope)
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
        carry_rows, carry_picks = [], []
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
                elif hidden is not None:
                    # the hidden state whose lm head produced `tok`: what
                    # the self-draft heads propose from next
                    carry_rows.append(self.table.row_of[seq.uid])
                    carry_picks.append(row)
            if seq.uid in self.table.row_of:
                self.table.sync(seq)
        if carry_rows:
            self._spec_hidden[torch.tensor(carry_rows, device=self.device)] \
                = hidden[torch.tensor(carry_picks, device=self.device)]
        return out

    def _burst_decode(self, k: int, temperature: float = 0.0,
                      rng: Optional[int] = None) -> None:
        """Decode ``k`` tokens for every running sequence in a loop that
        stays on the device; the tokens come back to the host once, at the
        end (blocks were reserved at admission)."""
        t = self.table
        tok, pos, bt, ctx = self._table_inputs()
        row_slots = self._adapter_rows()
        # rows inactive at entry must STAY inactive: advancing their ctx/pos
        # would flip them "active" with a zeroed block table and corrupt
        # block 0 of a real sequence
        alive = (ctx > 0).to(ctx.dtype)
        temps = self._row_temps(temperature)
        rng = self._step_rng(rng)
        toks = []
        for _ in range(k):
            logits = self._decode(tok, pos, bt, ctx, row_slots)
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
            # spec mode never bursts: a speculative step already emits up
            # to spec_k + 1 tokens with its own budget clamp
            steady = (burst > 1 and not self._spec_on and not self.waiting
                      and self.running and self._prefilling == 0)
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
