"""Inference engine v1 — the port of ``deepspeed_tpu/inference/engine.py``.

A prefill forward and a single-token decode forward over a static KV
cache of shape (L, B, max_len, KV, D); attention is taken over the whole
cache under a causal mask, with ALiBi's slope · key position added for
bloom-style models (which the v2 engine's paged kernels refuse).  The
attention is a plain ``einsum``/softmax, as the reference's is XLA; the
projections go through ``tfm._lin`` (the hand-written mixed GEMM on
quantized leaves) and MoE layers through ``moe/layer.dense_moe_block``
(the grouped GEMM when routing is dropless).

The cache is updated in place (the reference's ``dynamic_update_slice``
returns a new one).  Tensor parallelism arrives with multi-GPU (ROADMAP.md
A13).  The v2 ragged engine lives in ``inference/v2/``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..accelerator import resolve_device
from ..linear.optimized_linear import has_lora, tree_map
from ..models import transformer as tfm
from ..ops.hopper.mixed_gemm import QuantizedWeight


@dataclasses.dataclass
class InferenceConfig:
    tensor_parallel_size: int = 1
    max_seq_len: int = 2048
    max_batch_size: int = 8
    dtype: str = "bfloat16"
    # weight-only quantization (W8A16 / W4A16 / W6A16 via the mixed GEMM)
    quantize_bits: int = 0
    quantize_group: int = 256


def _inference_config(config) -> InferenceConfig:
    if isinstance(config, dict):
        icfg = InferenceConfig(**{k: v for k, v in config.items()
                                  if k in InferenceConfig.__dataclass_fields__})
    elif isinstance(config, InferenceConfig):
        icfg = config
    else:
        icfg = InferenceConfig()
    if icfg.tensor_parallel_size > 1:
        raise NotImplementedError(
            f"tensor_parallel_size={icfg.tensor_parallel_size}: tensor "
            "parallelism arrives with multi-GPU (ROADMAP.md A13); the port "
            "serves v1 on one device")
    return icfg


def _place_leaf(leaf, device: torch.device):
    if not isinstance(leaf, (torch.Tensor, QuantizedWeight)):
        raise TypeError(f"parameter leaf of type {type(leaf).__name__} is "
                        "not a tensor")
    return leaf.to(device)


def _place_tree(node, device: torch.device):
    """Every leaf on ``device`` in its own dtype (the reference's
    ``device_put``: weights are cast per call, in ``_lin``), LoRA nodes
    and quantized bases included; a tensor already there is the same
    tensor, so an engine built on another engine's parameters shares
    them."""
    return tree_map(lambda t: _place_leaf(t, device), node)


def _kv_cache_init(cfg: tfm.TransformerConfig, batch: int, max_len: int,
                   dtype: torch.dtype, device: Any = "cpu"
                   ) -> Dict[str, torch.Tensor]:
    L, kvh, hd = cfg.num_layers, cfg.kv_heads, cfg.head_dim
    shape = (L, batch, max_len, kvh, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "length": torch.zeros((batch,), dtype=torch.int32,
                                  device=device)}


def forward_cached(params, tokens: torch.Tensor, cache: Dict[str, Any],
                   start_pos: int, cfg: tfm.TransformerConfig):
    """Forward over ``tokens`` (B, T) with the KV cache filled up to
    ``start_pos``.  Returns (last-position logits (B, V) in f32, cache);
    the cache is written in place at [start_pos, start_pos + T).  Works for
    prefill (T = prompt length) and decode (T = 1)."""
    dt = tfm.torch_dtype(cfg.dtype)
    B, T = tokens.shape
    max_len = cache["k"].shape[2]
    dev = cache["k"].device
    tokens = tokens.long()
    positions = start_pos + torch.arange(T, device=dev)

    x = tfm.embed_tokens(params, tokens, cfg, position_ids=positions)
    cos = sin = None
    if cfg.position == "rope":
        cos_full, sin_full = tfm.rope_table(max_len, cfg.rot_dim,
                                            cfg.rope_theta, device=dev)
        cos = cos_full[start_pos:start_pos + T]
        sin = sin_full[start_pos:start_pos + T]
    nh, nkv, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    key_pos = torch.arange(max_len, device=dev)[None, None, None, :]
    qry_pos = positions[None, None, :, None]
    mask = key_pos <= qry_pos
    alibi = None
    if cfg.position == "alibi":
        # slope · key-position, the training-side formulation (per-query
        # constants cancel in softmax)
        alibi = (tfm.alibi_slopes(nh).to(dev)[None, :, None, None]
                 * key_pos.float())

    for i in range(cfg.num_layers):
        lp = tfm.layer_params(params, i)
        h = x
        a_in = tfm._norm(h, lp["ln1"], cfg.norm, cfg.norm_eps)
        ap = lp["attn"]
        q = tfm._lin(a_in, ap, "wq", "bq").reshape(B, T, nh, hd)
        k = tfm._lin(a_in, ap, "wk", "bk").reshape(B, T, nkv, hd)
        v = tfm._lin(a_in, ap, "wv", "bv").reshape(B, T, nkv, hd)
        if cos is not None:
            q = tfm.apply_rope(q, cos, sin)
            k = tfm.apply_rope(k, cos, sin)
        kk, vv = cache["k"][i], cache["v"][i]  # (B, max_len, KV, D)
        kk[:, start_pos:start_pos + T] = k.to(kk.dtype)
        vv[:, start_pos:start_pos + T] = v.to(vv.dtype)
        if nkv != nh:
            kk = kk.repeat_interleave(nh // nkv, dim=2)
            vv = vv.repeat_interleave(nh // nkv, dim=2)
        logits = torch.einsum("bthd,bshd->bhts", q, kk.to(q.dtype))
        logits = (logits / math.sqrt(hd)).float()
        if alibi is not None:
            logits = logits + alibi
        logits = torch.where(mask, logits, -1e30)
        probs = torch.softmax(logits, dim=-1).to(dt)
        o = torch.einsum("bhts,bshd->bthd", probs,
                         vv.to(dt)).reshape(B, T, nh * hd)
        attn_out = tfm._lin(o, ap, "wo", "bo")

        m_src = h if cfg.parallel_residual else h + attn_out
        m_in = tfm._norm(m_src, lp["ln2"], cfg.norm, cfg.norm_eps)
        mlp_out = tfm.ffn_block(m_in, lp, cfg)
        x = (h + attn_out + mlp_out) if cfg.parallel_residual \
            else (m_src + mlp_out)

    x = tfm._norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    w, tied, b = tfm.lm_head(params, cfg, dt)
    logits = x[:, -1] @ (w.T if tied else w)
    if b is not None:
        logits = logits + b.to(dt)
    cache["length"] += T
    return logits.float(), cache


class InferenceEngine:
    """Reference: ``InferenceEngine`` — ``.generate()``.  Runs on the card
    unless ``device="cpu"`` is asked for."""

    def __init__(self, model=None, config=None, model_config=None,
                 params=None, device: Any = "cuda", **kwargs):
        self.device = resolve_device(device)
        icfg = _inference_config(config)
        self.config = icfg
        if model is not None and hasattr(model, "params"):
            # ModelSpec-style bundle; model_config is the TransformerConfig
            params = model.params
        if model_config is None or params is None:
            raise ValueError("pass model_config=TransformerConfig and params=")
        if (getattr(model_config, "num_experts", 0) > 0 and
                getattr(model_config, "moe_routing", "capacity")
                == "expert_choice"):
            raise ValueError(
                "expert_choice routing is non-causal (experts pick top-C "
                "tokens over the whole sequence) — autoregressive decode "
                "with it is incoherent; serve with moe_routing='capacity' "
                "or 'dropless' (dataclasses.replace(cfg, moe_routing=...))")
        self.model_config = dataclasses.replace(model_config,
                                                dtype=icfg.dtype)
        if has_lora(params) and icfg.quantize_bits:
            # unmerged LoRA serving keeps the (possibly already-quantized)
            # base + adapters as they are; the mixed-GEMM WxA16 path does
            # not know LoRAWeight nodes — merge first for a quantized
            # artifact (reference inference/engine.py:171-181)
            raise ValueError(
                "quantize_bits with an unmerged LoRA tree is not supported: "
                "export merged weights (engine.export_merged_weights) and "
                "serve those quantized, or serve the LoRA tree with "
                "quantize_bits=0")
        if icfg.quantize_bits:
            # quantize where the weights lie: the card holds only the codes
            # and scales of the projections
            from .quantization import quantize_on_host

            params = quantize_on_host(params, icfg.quantize_bits,
                                      icfg.quantize_group, self.device)
        self.params = _place_tree(params, self.device)
        #: f32 (B, V) logits of the latest prefill (probes)
        self.first_logits: Optional[torch.Tensor] = None

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 temperature: float = 0.0, seed: int = 0,
                 eos_token_id: Optional[int] = None) -> np.ndarray:
        """Greedy / temperature sampling.  input_ids: (B, T_prompt) ints;
        returns (B, T_prompt + generated) int32.  Sampled tokens come from
        a ``torch.Generator`` seeded with ``seed`` (the reference's
        distribution, not its draws)."""
        tokens = torch.as_tensor(np.asarray(input_ids), dtype=torch.long,
                                 device=self.device)
        B, T = tokens.shape
        max_len = min(self.config.max_seq_len, T + max_new_tokens)
        cache = _kv_cache_init(self.model_config, B, max_len,
                               tfm.torch_dtype(self.config.dtype),
                               self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)

        logits, cache = forward_cached(self.params, tokens, cache, 0,
                                       self.model_config)
        self.first_logits = logits
        out = [tokens]
        cur = self._sample(logits, gen, temperature)
        out.append(cur[:, None])
        finished = torch.zeros((B,), dtype=torch.bool, device=self.device)
        for i in range(max_new_tokens - 1):
            pos = T + i
            if pos >= max_len:
                break
            logits, cache = forward_cached(self.params, cur[:, None], cache,
                                           pos, self.model_config)
            cur = self._sample(logits, gen, temperature)
            if eos_token_id is not None:
                finished = finished | (cur == eos_token_id)
                cur = torch.where(finished, eos_token_id, cur)
            out.append(cur[:, None])
            if eos_token_id is not None and bool(finished.all()):
                break
        return torch.cat(out, dim=1).to(torch.int32).cpu().numpy()

    @staticmethod
    def _sample(logits: torch.Tensor, gen: torch.Generator,
                temperature: float) -> torch.Tensor:
        if temperature <= 0.0:
            return logits.argmax(-1)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]


class EncoderInferenceEngine:
    """Encoder-model serving (BERT family): one bidirectional forward, no
    KV cache.  ``encode()`` returns hidden states, ``mlm_logits()`` the
    masked-LM head, ``pooled()`` the [CLS] pooler, each as a numpy array.
    Runs on the card unless ``device="cpu"`` is asked for."""

    def __init__(self, model_config, params, config=None,
                 device: Any = "cuda", **kwargs):
        from ..models import encoder as enc

        self.device = resolve_device(device)
        icfg = _inference_config(config)
        self.config = icfg
        self.model_config = dataclasses.replace(model_config,
                                                dtype=icfg.dtype)
        self._enc = enc
        self.params = _place_tree(params, self.device)

    def _args(self, input_ids, attention_mask, token_type_ids):
        def dev(a, dtype):
            return None if a is None else torch.as_tensor(
                np.asarray(a), dtype=dtype, device=self.device)
        return (dev(input_ids, torch.long), dev(attention_mask, torch.int32),
                dev(token_type_ids, torch.long))

    @torch.no_grad()
    def _run(self, fn, input_ids, attention_mask, token_type_ids):
        ids, am, tt = self._args(input_ids, attention_mask, token_type_ids)
        out = fn(self.params, ids, self.model_config, attention_mask=am,
                 token_type_ids=tt)
        return out.float().cpu().numpy()

    def encode(self, input_ids, attention_mask=None, token_type_ids=None):
        return self._run(self._enc.encode, input_ids, attention_mask,
                         token_type_ids)

    def mlm_logits(self, input_ids, attention_mask=None, token_type_ids=None):
        if "mlm" not in self.params:
            raise ValueError("model has no MLM head (converted from a bare "
                             "BertModel?)")
        return self._run(self._enc.mlm_logits, input_ids, attention_mask,
                         token_type_ids)

    def pooled(self, input_ids, attention_mask=None, token_type_ids=None):
        if "pooler" not in self.params:
            raise ValueError("model has no pooler")
        return self._run(self._enc.pooled_output, input_ids, attention_mask,
                         token_type_ids)
