"""BERT-family encoder (bidirectional, post-LN) — the port of
``deepspeed_tpu/models/encoder.py``.

The same three differences from the decoders as the reference:

* **bidirectional attention** with an additive key-side padding mask (no
  causal mask);
* **post-layernorm residuals**: ``x = LN(x + sublayer(x))``;
* **summed embeddings** (word + position + token-type), normalized once.

Parameters keep the reference's pytree layout (per-layer weights stacked
on a leading ``layers`` axis), so :func:`params_from_jax` converts leaf for
leaf.  The attention is a plain ``einsum``/softmax, as the reference's is
XLA (no Pallas kernel).  :func:`param_axes` gives the logical axes the
ZeRO sharding rules read (``runtime/zero/sharding.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from ..accelerator import resolve_device
from .transformer import (_leaf_to_torch, _norm, _remat_policy,
                          apply_activation, torch_dtype)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Field for field the reference's ``EncoderConfig`` (defaults:
    ``bert-base-uncased``'s shape)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 512
    type_vocab_size: int = 2
    norm_eps: float = 1e-12
    activation: str = "gelu_exact"  # BERT uses erf-form GELU
    dtype: str = "float32"
    param_dtype: str = "float32"
    remat_policy: str = "nothing_saveable"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def num_params(self) -> int:
        h, f, L = self.hidden_size, self.intermediate_size, self.num_layers
        # 4 projections + MLP, their biases (4h attn, f+h mlp), two LNs (4h)
        per_layer = 4 * h * h + 2 * h * f + 9 * h + f
        embed = (self.vocab_size + self.max_seq_len + self.type_vocab_size) * h
        return L * per_layer + embed + 2 * h


def init_params(cfg: EncoderConfig, generator: torch.Generator,
                device: Any = "cuda", dtype: Optional[torch.dtype] = None
                ) -> Dict[str, Any]:
    """Random parameters in the reference's layout, drawn from
    ``generator`` (which must live on ``device``) into ``dtype`` (default:
    ``cfg.param_dtype``).  Torch and JAX draw different numbers from one
    seed: parity tests convert with :func:`params_from_jax`."""
    dev = resolve_device(device)
    pd = dtype or torch_dtype(cfg.param_dtype)
    h, f, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=dev, dtype=pd)
        return w.mul_(1.0 / math.sqrt(fan_in))

    def zeros(*s):
        return torch.zeros(s, device=dev, dtype=pd)

    def ones(*s):
        return torch.ones(s, device=dev, dtype=pd)

    layer = {
        "attn": {
            "wq": dense((L, h, h), h), "bq": zeros(L, h),
            "wk": dense((L, h, h), h), "bk": zeros(L, h),
            "wv": dense((L, h, h), h), "bv": zeros(L, h),
            "wo": dense((L, h, h), h), "bo": zeros(L, h),
        },
        "ln_attn": {"scale": ones(L, h), "bias": zeros(L, h)},
        "mlp": {
            "w_in": dense((L, h, f), h), "b_in": zeros(L, f),
            "w_out": dense((L, f, h), f), "b_out": zeros(L, h),
        },
        "ln_mlp": {"scale": ones(L, h), "bias": zeros(L, h)},
    }
    return {
        "embed": {
            "tokens": dense((cfg.vocab_size, h), h),
            "position": dense((cfg.max_seq_len, h), h),
            "token_type": dense((cfg.type_vocab_size, h), h),
        },
        "embed_norm": {"scale": ones(h), "bias": zeros(h)},
        "layers": layer,
        "mlm": {
            "w": dense((h, h), h), "b": zeros(h),
            "norm": {"scale": ones(h), "bias": zeros(h)},
            "decoder_bias": zeros(cfg.vocab_size),
        },
        "pooler": {"w": dense((h, h), h), "b": zeros(h)},
    }


def param_axes(cfg: EncoderConfig,
               params: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Logical axes for the ZeRO/TP sharding rules (the reference's):
    encoders shard like decoders (heads/mlp → tp, vocab rows → tp, layers
    stacked).  Pass ``params`` to prune the optional heads (pooler / mlm)
    the converted model does not carry."""
    ln = {"scale": ("layers", "embed"), "bias": ("layers", "embed")}
    axes = {
        "embed": {"tokens": ("vocab", "embed"), "position": ("seq", "embed"),
                  "token_type": (None, "embed")},
        "embed_norm": {"scale": ("embed",), "bias": ("embed",)},
        "layers": {
            "attn": {
                "wq": ("layers", "embed", "heads"), "bq": ("layers", "heads"),
                "wk": ("layers", "embed", "heads"), "bk": ("layers", "heads"),
                "wv": ("layers", "embed", "heads"), "bv": ("layers", "heads"),
                "wo": ("layers", "heads", "embed"), "bo": ("layers", "embed"),
            },
            "ln_attn": dict(ln),
            "mlp": {
                "w_in": ("layers", "embed", "mlp"), "b_in": ("layers", "mlp"),
                "w_out": ("layers", "mlp", "embed"),
                "b_out": ("layers", "embed"),
            },
            "ln_mlp": dict(ln),
        },
        "mlm": {"w": ("embed", "embed"), "b": ("embed",),
                "norm": {"scale": ("embed",), "bias": ("embed",)},
                "decoder_bias": ("vocab",)},
        "pooler": {"w": ("embed", "embed"), "b": ("embed",)},
    }
    if params is not None:
        axes = {k: v for k, v in axes.items() if k in params}
    return axes


def params_from_jax(tree: Dict[str, Any], cfg: EncoderConfig,
                    device: Any = "cuda", dtype: Optional[torch.dtype] = None
                    ) -> Dict[str, Any]:
    """The reference's encoder pytree (nested dicts of arrays) as tensors
    in ``dtype`` (default: ``cfg.param_dtype``) on ``device``, same
    layout."""
    dev = resolve_device(device)
    dt = dtype or torch_dtype(cfg.param_dtype)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _leaf_to_torch(node, dev, dt)

    return conv(tree)


def _ln(x, p, eps):
    return _norm(x, p, "layernorm", eps)


def _affine(x, w, b):
    return x @ w.to(x.dtype) + b.to(x.dtype)


def encode(params: Dict[str, Any], input_ids: torch.Tensor,
           cfg: EncoderConfig,
           attention_mask: Optional[torch.Tensor] = None,
           token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """input_ids (B, S) → final hidden states (B, S, H) in ``cfg.dtype``.

    ``attention_mask`` (B, S): 1 = attend, 0 = padding (HF convention);
    padded KEYS are masked for every query, bidirectional otherwise."""
    dt = torch_dtype(cfg.dtype)
    input_ids = input_ids.long()
    B, S = input_ids.shape
    h, nh, hd = cfg.hidden_size, cfg.num_heads, cfg.head_dim
    eps = cfg.norm_eps

    emb = params["embed"]
    x = emb["tokens"].to(dt)[input_ids]
    x = x + emb["position"].to(dt)[None, :S]
    tt = (token_type_ids.long() if token_type_ids is not None
          else torch.zeros_like(input_ids))
    x = x + emb["token_type"].to(dt)[tt]
    x = _ln(x, params["embed_norm"], eps)

    # (B, 1, 1, S) additive key mask, broadcasting over heads and queries
    key_bias = None
    if attention_mask is not None:
        key_bias = torch.where(attention_mask[:, None, None, :] > 0,
                               0.0, -1e30).to(x.device, torch.float32)

    def layer(x, lp):
        a = lp["attn"]
        q = _affine(x, a["wq"], a["bq"]).reshape(B, S, nh, hd)
        k = _affine(x, a["wk"], a["bk"]).reshape(B, S, nh, hd)
        v = _affine(x, a["wv"], a["bv"]).reshape(B, S, nh, hd)
        logits = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(hd)
        logits = logits.float()
        if key_bias is not None:
            logits = logits + key_bias
        probs = torch.softmax(logits, dim=-1).to(dt)
        o = torch.einsum("bhst,bthd->bshd", probs, v).reshape(B, S, h)
        o = _affine(o, a["wo"], a["bo"])
        x = _ln(x + o, lp["ln_attn"], eps)
        m = apply_activation(_affine(x, lp["mlp"]["w_in"],
                                     lp["mlp"]["b_in"]), cfg.activation)
        m = _affine(m, lp["mlp"]["w_out"], lp["mlp"]["b_out"])
        return _ln(x + m, lp["ln_mlp"], eps)

    remat = _remat_policy(cfg.remat_policy)
    layers = params["layers"]
    for i in range(cfg.num_layers):
        lp = {g: {k: w[i] for k, w in sub.items()}
              for g, sub in layers.items()}
        if remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(layer, x, lp,
                                                  use_reentrant=False)
        else:
            x = layer(x, lp)
    return x


def mlm_logits(params: Dict[str, Any], input_ids: torch.Tensor,
               cfg: EncoderConfig,
               attention_mask: Optional[torch.Tensor] = None,
               token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BertForMaskedLM head: dense → GELU → LN → tied decoder + bias."""
    dt = torch_dtype(cfg.dtype)
    x = encode(params, input_ids, cfg, attention_mask, token_type_ids)
    m = params["mlm"]
    x = apply_activation(_affine(x, m["w"], m["b"]), cfg.activation)
    x = _ln(x, m["norm"], cfg.norm_eps)
    return x @ params["embed"]["tokens"].to(dt).T + m["decoder_bias"].to(dt)


def pooled_output(params: Dict[str, Any], input_ids: torch.Tensor,
                  cfg: EncoderConfig,
                  attention_mask: Optional[torch.Tensor] = None,
                  token_type_ids: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """[CLS] tanh pooler (sequence-classification input)."""
    x = encode(params, input_ids, cfg, attention_mask, token_type_ids)
    p = params["pooler"]
    return torch.tanh(_affine(x[:, 0], p["w"], p["b"]))


def mlm_loss_fn(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
                cfg: EncoderConfig):
    """Masked-LM cross entropy.  batch: {'input_ids', 'labels'} with -100
    on unmasked positions (HF convention); optional 'attention_mask',
    'token_type_ids'."""
    logits = mlm_logits(params, batch["input_ids"], cfg,
                        batch.get("attention_mask"),
                        batch.get("token_type_ids"))
    labels = batch["labels"].long()
    mask = (labels != -100).float()
    safe = torch.where(labels == -100, torch.zeros_like(labels), labels)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    denom = mask.sum().clamp(min=1.0)
    loss = (nll * mask).sum() / denom
    acc = ((logits.argmax(-1) == labels).float() * mask).sum() / denom
    return loss, {"loss": loss, "accuracy": acc, "tokens": denom}
