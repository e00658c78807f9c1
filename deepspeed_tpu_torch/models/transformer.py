"""Decoder-only transformer, LLaMA path — the port of
``deepspeed_tpu/models/transformer.py``.

Parameters keep the reference's pytree layout as nested dicts of tensors,
with per-layer weights stacked on a leading ``layers`` axis (``(L, ...)``),
so :func:`params_from_jax` is a leaf-for-leaf conversion and the layer
stack is walked with a Python loop where the reference ``lax.scan``-s it.

Weights may live in any dtype: ``_lin`` casts them to the compute dtype on
every call, as the reference does.  Serving loads them straight into the
compute dtype (:func:`init_params` draws into it, :func:`params_from_jax`
converts), which gives the same numbers; training keeps them in
``cfg.param_dtype`` (``init_params(..., dtype=param_dtype(cfg))``), so the
gradients of :func:`loss_fn` arrive in that dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..accelerator import resolve_device
from ..runtime.activation_checkpointing.checkpointing import \
    checkpoint_name
from ..runtime.zero.param_offload import maybe_stream_in
from ..linear.optimized_linear import (LoRAWeight, QuantizedBaseWeight,
                                       lora_forward, tree_map)
from ..ops.hopper.mixed_gemm import (QuantizedWeight, mixed_gemm,
                                     mixed_gemm_frozen)

# the model's dtypes: the paged-attention kernels take bf16 and f32; the
# flash kernels (training) also take f16, the fp16 engine's compute dtype
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; have {sorted(_DTYPES)}")
    return _DTYPES[name]


def param_dtype(cfg: "TransformerConfig") -> torch.dtype:
    """The dtype the training path keeps parameters in."""
    return torch_dtype(cfg.param_dtype)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Field for field the reference's ``TransformerConfig``, so presets
    and overrides carry over unchanged.  The port runs the LLaMA path,
    dense or MoE; other switches are refused where they would be used."""

    vocab_size: int = 32000
    hidden_size: int = 512
    intermediate_size: int = 1408
    num_layers: int = 4
    num_heads: int = 8
    num_kv_heads: Optional[int] = None  # None => MHA; < num_heads => GQA
    head_dim_override: Optional[int] = None
    max_seq_len: int = 2048
    norm: str = "rmsnorm"  # rmsnorm | layernorm | gemma_rmsnorm
    activation: str = "silu"  # silu => SwiGLU; gelu; gelu_exact; relu
    gated_mlp: bool = False
    embed_scale_by_sqrt_dim: bool = False
    position: str = "rope"  # rope | learned | alibi
    tie_embeddings: bool = True
    embed_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    parallel_residual: bool = False
    partial_rotary_factor: float = 1.0
    sliding_window: int = 0
    num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_routing: str = "capacity"
    moe_use_residual: bool = False
    dtype: str = "bfloat16"  # compute dtype
    param_dtype: str = "float32"  # the reference's master-weight dtype
    attn_impl: str = "xla"
    remat_policy: str = "nothing_saveable"

    def __post_init__(self):
        if self.gated_mlp and self.num_experts > 0 and \
                self.activation != "silu":
            raise ValueError(
                "gated_mlp with a non-silu activation is not wired for MoE "
                "expert blocks (they hardcode silu gating)")

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.hidden_size // self.num_heads

    @property
    def is_gated_mlp(self) -> bool:
        return self.gated_mlp or self.activation == "silu"

    @property
    def rot_dim(self) -> int:
        """Rotated head dims (partial rotary rounds down to even)."""
        return int(self.head_dim * self.partial_rotary_factor) // 2 * 2

    def num_params(self, include_embed: bool = True) -> int:
        h, f, v, L = (self.hidden_size, self.intermediate_size,
                      self.vocab_size, self.num_layers)
        kvh = self.kv_heads * self.head_dim
        qh = self.num_heads * self.head_dim
        per_layer = h * qh + 2 * h * kvh + qh * h
        n_mlp = 3 * h * f if self.is_gated_mlp else 2 * h * f
        if self.num_experts > 0:
            n_mlp = n_mlp * self.num_experts + h * self.num_experts
        per_layer += n_mlp + 2 * h
        total = L * per_layer + h
        if include_embed:
            total += v * h if self.tie_embeddings else 2 * v * h
            if self.position == "learned":
                total += self.max_seq_len * h
        return total


# ---------------------------------------------------------------------------
# presets (copied letter for letter from the reference)
# ---------------------------------------------------------------------------

PRESETS: Dict[str, Dict[str, Any]] = {
    "gpt2-125m": dict(vocab_size=50257, hidden_size=768, intermediate_size=3072,
                      num_layers=12, num_heads=12, max_seq_len=1024, norm="layernorm",
                      activation="gelu", position="learned", tie_embeddings=True),
    "llama3-8b": dict(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                      num_layers=32, num_heads=32, num_kv_heads=8, max_seq_len=8192,
                      rope_theta=500000.0),
    "llama3-70b": dict(vocab_size=128256, hidden_size=8192, intermediate_size=28672,
                       num_layers=80, num_heads=64, num_kv_heads=8, max_seq_len=8192,
                       rope_theta=500000.0),
    "mixtral-8x7b": dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                         num_layers=32, num_heads=32, num_kv_heads=8, max_seq_len=32768,
                         num_experts=8, moe_top_k=2),
    "mistral-7b": dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                       num_layers=32, num_heads=32, num_kv_heads=8, max_seq_len=32768,
                       sliding_window=4096, attn_impl="flash"),
    "tiny": dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
                 num_heads=4, max_seq_len=128),
    "tiny-moe": dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
                     num_heads=4, max_seq_len=128, num_experts=4, moe_top_k=2),
    "tiny-prmoe": dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                       num_layers=2, num_heads=4, max_seq_len=128,
                       num_experts=4, moe_top_k=2, moe_use_residual=True),
}


def get_config(name: str, **overrides) -> TransformerConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown model preset {name!r}; have {sorted(PRESETS)}")
    kw = dict(PRESETS[name])
    kw.update(overrides)
    return TransformerConfig(**kw)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device: Any = "cuda", dtype: Optional[torch.dtype] = None
                ) -> Dict[str, Any]:
    """Random parameters in the reference's layout, drawn from
    ``generator`` straight into ``dtype`` (default: the compute dtype) on
    ``device`` — an 8B model never exists in f32 on the card.  The
    generator must live on ``device``.  Torch and JAX draw different
    numbers from one seed: parity tests convert the reference's weights
    with :func:`params_from_jax` instead.  ``device="meta"`` gives the
    tree's shapes and dtypes with no storage (a loader's template)."""
    dev = (torch.device("meta") if str(device) == "meta"
           else resolve_device(device))
    dt = dtype or torch_dtype(cfg.dtype)
    h, f, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    hd, nh, nkv = cfg.head_dim, cfg.num_heads, cfg.kv_heads

    def dense(shape, fan_in):
        if dev.type == "meta":  # shapes only: no draw
            return torch.empty(shape, device=dev, dtype=dt)
        w = torch.randn(shape, generator=generator, device=dev, dtype=dt)
        return w.mul_(1.0 / math.sqrt(fan_in))

    def stacked(shape, fan_in):
        # one layer at a time, straight into dt: at Mixtral's width a
        # whole (L, E, h, f) expert stack is 15 GB in bf16
        w = torch.empty(shape, device=dev, dtype=dt)
        if dev.type == "meta":
            return w
        for i in range(shape[0]):
            w[i].normal_(generator=generator).mul_(1.0 / math.sqrt(fan_in))
        return w

    def norm_w(shape):
        # gemma's (1+w) norm is identity at w=0; plain rmsnorm at w=1
        fill = 0.0 if cfg.norm == "gemma_rmsnorm" else 1.0
        return torch.full(shape, fill, device=dev, dtype=dt)

    layer: Dict[str, Any] = {
        "attn": {
            "wq": dense((L, h, nh * hd), h),
            "wk": dense((L, h, nkv * hd), h),
            "wv": dense((L, h, nkv * hd), h),
            "wo": dense((L, nh * hd, h), nh * hd),
        },
        "ln1": {"scale": norm_w((L, h))},
        "ln2": {"scale": norm_w((L, h))},
    }
    if cfg.norm == "layernorm":
        layer["ln1"]["bias"] = torch.zeros((L, h), device=dev, dtype=dt)
        layer["ln2"]["bias"] = torch.zeros((L, h), device=dev, dtype=dt)
    if cfg.num_experts > 0:  # the reference's moe subtree and layout
        E = cfg.num_experts
        moe = {"router": dense((L, h, E), h),
               "w_in": stacked((L, E, h, f), h),
               "w_gate": stacked((L, E, h, f), h),
               "w_out": stacked((L, E, f, h), f)}
        if cfg.activation != "silu":
            del moe["w_gate"]
        if cfg.moe_use_residual:  # PR-MoE shared expert + mixing coefficient
            moe["res_w_in"] = dense((L, h, f), h)
            moe["res_w_out"] = dense((L, f, h), f)
            if cfg.activation == "silu":
                moe["res_w_gate"] = dense((L, h, f), h)
            moe["coef"] = dense((L, h, 2), h)
        layer["moe"] = moe
    else:
        mlp = {"w_in": dense((L, h, f), h), "w_out": dense((L, f, h), f)}
        if cfg.is_gated_mlp:
            mlp["w_gate"] = dense((L, h, f), h)
        layer["mlp"] = mlp
    params: Dict[str, Any] = {
        "embed": {"tokens": dense((cfg.vocab_size, h), h)},
        "layers": layer,
        "final_norm": {"scale": norm_w((h,))},
    }
    if cfg.norm == "layernorm":
        params["final_norm"]["bias"] = torch.zeros((h,), device=dev, dtype=dt)
    if cfg.position == "learned":
        params["embed"]["position"] = dense((cfg.max_seq_len, h), h)
    if cfg.embed_norm:
        params["embed_norm"] = {
            "scale": torch.ones((h,), device=dev, dtype=dt),
            "bias": torch.zeros((h,), device=dev, dtype=dt)}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": dense((h, cfg.vocab_size), h)}
    return params


def param_axes(cfg: TransformerConfig, params: Optional[Dict[str, Any]] = None
               ) -> Dict[str, Any]:
    """Logical-axes tree matching :func:`init_params` (the reference's
    ``param_axes``), read by the ZeRO sharding rules
    (``runtime/zero/sharding.py``).  Pass ``params`` for converted trees
    that carry linear biases (their leaves get axes) or LoRA nodes (their
    axes are expanded, ``linear/optimized_linear.expand_axes_for_lora``)."""
    from ..linear.optimized_linear import expand_axes_for_lora

    ln = {"scale": ("layers", "embed")}
    if cfg.norm == "layernorm":
        ln = {"scale": ("layers", "embed"), "bias": ("layers", "embed")}
    layer: Dict[str, Any] = {
        "attn": {
            "wq": ("layers", "embed", "heads"),
            "wk": ("layers", "embed", "kv_heads"),
            "wv": ("layers", "embed", "kv_heads"),
            "wo": ("layers", "heads", "embed"),
        },
        "ln1": dict(ln),
        "ln2": dict(ln),
    }
    if cfg.num_experts > 0:
        moe = {
            "router": ("layers", "embed", None),
            "w_in": ("layers", "expert", "embed", "mlp"),
            "w_out": ("layers", "expert", "mlp", "embed"),
        }
        if cfg.activation == "silu":
            moe["w_gate"] = ("layers", "expert", "embed", "mlp")
        if cfg.moe_use_residual:
            moe["res_w_in"] = ("layers", "embed", "mlp")
            moe["res_w_out"] = ("layers", "mlp", "embed")
            if cfg.activation == "silu":
                moe["res_w_gate"] = ("layers", "embed", "mlp")
            moe["coef"] = ("layers", "embed", None)
        layer["moe"] = moe
    else:
        mlp = {"w_in": ("layers", "embed", "mlp"),
               "w_out": ("layers", "mlp", "embed")}
        if cfg.is_gated_mlp:
            mlp["w_gate"] = ("layers", "embed", "mlp")
        layer["mlp"] = mlp

    fn = {"scale": ("embed",)}
    if cfg.norm == "layernorm":
        fn["bias"] = ("embed",)
    axes: Dict[str, Any] = {
        "embed": {"tokens": ("vocab", "embed")},
        "layers": layer,
        "final_norm": fn,
    }
    if cfg.position == "learned":
        axes["embed"]["position"] = ("seq", "embed")
    if cfg.embed_norm:
        axes["embed_norm"] = {"scale": ("embed",), "bias": ("embed",)}
    if not cfg.tie_embeddings:
        axes["lm_head"] = {"w": ("embed", "vocab")}
        if params is not None and "b" in params.get("lm_head", {}):
            axes["lm_head"]["b"] = ("vocab",)

    if params is not None:  # add axes for optional bias leaves
        bias_axes = {
            "bq": ("layers", "heads"), "bk": ("layers", "kv_heads"),
            "bv": ("layers", "kv_heads"), "bo": ("layers", "embed"),
            "b_gate": ("layers", "mlp"), "b_in": ("layers", "mlp"),
            "b_out": ("layers", "embed"),
        }
        for blk in ("attn", "mlp"):
            have = params.get("layers", {}).get(blk, {})
            for key, ax in bias_axes.items():
                if key in have and key not in layer.get(blk, {}):
                    layer.setdefault(blk, {})[key] = ax
        axes = expand_axes_for_lora(axes, params)
    return axes


_QW_FIELDS = ("codes", "scales", "bits", "group", "k")


def _leaf_to_torch(leaf, device: torch.device,
                   dtype: Optional[torch.dtype]) -> torch.Tensor:
    """One array as a tensor on ``device``, cast to ``dtype`` (None: kept)."""
    if not (hasattr(leaf, "shape") and hasattr(leaf, "dtype")):
        raise TypeError(f"parameter leaf of type {type(leaf).__name__} is "
                        "not an array")
    arr = np.ascontiguousarray(np.asarray(leaf))
    if not arr.flags.writeable:  # torch tensors must own writable memory
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype)


#: the fields of the reference's quantized-base node (``linear/
#: optimized_linear.py`` ``QuantizedBaseWeight``) and of its LoRA node
_QBW_FIELDS = ("codes", "scales", "q_bits", "mantissa_bits", "group_size",
               "inner_shape", "layout")
_LORA_FIELDS = ("base", "lora_a", "lora_b", "scaling")


def params_from_jax(tree: Dict[str, Any], cfg: TransformerConfig,
                    device: Any = "cuda", dtype: Optional[torch.dtype] = None
                    ) -> Dict[str, Any]:
    """The reference's parameter pytree (nested dicts of arrays: numpy, or
    anything ``np.asarray`` reads) as the port's parameters: the same
    nested layout, each leaf a tensor in ``dtype`` (default: the compute
    dtype) on ``device``.  The reference's nodes, recognised by their
    fields, become the port's: a mixed-GEMM weight (``codes, scales, bits,
    group, k``) a :class:`QuantizedWeight`, a quantized base a
    :class:`QuantizedBaseWeight` (codes and scales keep their dtypes; fp8
    codes are the reference's uint8 bytes), a LoRA weight a
    :class:`LoRAWeight` (its dense base and factors in ``dtype``)."""
    dev = resolve_device(device)
    dt = dtype or torch_dtype(cfg.dtype)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if all(hasattr(node, f) for f in _LORA_FIELDS):
            return LoRAWeight(conv(node.base), conv(node.lora_a),
                              conv(node.lora_b), float(node.scaling))
        if all(hasattr(node, f) for f in _QBW_FIELDS):
            return QuantizedBaseWeight(
                _leaf_to_torch(node.codes, dev, None),
                _leaf_to_torch(node.scales, dev, None), int(node.q_bits),
                int(node.mantissa_bits), int(node.group_size),
                tuple(int(d) for d in node.inner_shape), str(node.layout))
        if all(hasattr(node, f) for f in _QW_FIELDS):
            return QuantizedWeight(_leaf_to_torch(node.codes, dev, None),
                                   _leaf_to_torch(node.scales, dev, None),
                                   int(node.bits), int(node.group),
                                   int(node.k))
        return _leaf_to_torch(node, dev, dt)

    return conv(tree)


def spec_heads_from_jax(heads: Dict[str, Any], device: Any = "cuda"
                        ) -> Dict[str, torch.Tensor]:
    """The reference's self-draft heads (``linear/spec_heads.py``: ``w1``,
    ``b1``, ``w2``, any array ``np.asarray`` reads) as the port's f32
    tensors on ``device``."""
    dev = resolve_device(device)
    return {k: _leaf_to_torch(heads[k], dev, torch.float32)
            for k in ("w1", "b1", "w2")}


def adapter_pack_from_jax(pack: Dict[str, Any], device: Any = "cuda",
                          dtype: Optional[torch.dtype] = None
                          ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """An adapter pack ``{target: (lora_a (L, K, r), lora_b (L, r, N))}``
    (the reference's ``load_adapter_pack`` format) as tensors on
    ``device`` (``dtype`` None: kept)."""
    dev = resolve_device(device)
    return {t: (_leaf_to_torch(a, dev, dtype), _leaf_to_torch(b, dev, dtype))
            for t, (a, b) in pack.items()}


def adapter_stack_from_jax(stack: Dict[str, Any], device: Any = "cuda",
                           dtype: Optional[torch.dtype] = None
                           ) -> Dict[str, Dict[str, torch.Tensor]]:
    """A device adapter stack ``{target: {"a": (L, slots, K, r), "b": (L,
    slots, r, N)}}`` (the reference engine's ``adapter_stack``) as tensors
    on ``device``."""
    dev = resolve_device(device)
    return {t: {h: _leaf_to_torch(ab[h], dev, dtype) for h in ("a", "b")}
            for t, ab in stack.items()}


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------


def _norm(x: torch.Tensor, p: Dict[str, torch.Tensor], kind: str,
          eps: float) -> torch.Tensor:
    """The reference's ``_norm``: the variance is taken in f32, the rescale
    happens in ``x``'s dtype, in the same order (that order decides the
    bf16 rounding)."""
    if kind == "rmsnorm":
        var = x.float().square().mean(-1, keepdim=True)
        y = x * torch.rsqrt(var + eps).to(x.dtype)
        return y * p["scale"].to(x.dtype)
    if kind == "gemma_rmsnorm":
        var = x.float().square().mean(-1, keepdim=True)
        y = x * torch.rsqrt(var + eps).to(x.dtype)
        return y * (1.0 + p["scale"].to(x.dtype))
    mean = x.mean(-1, keepdim=True)
    var = x.float().var(-1, keepdim=True, unbiased=False).to(x.dtype)
    y = (x - mean) * torch.rsqrt(var + eps).to(x.dtype)
    return y * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)


def rope_table(seq_len: int, head_dim: int, theta: float,
               device: Any = "cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """(seq_len, head_dim/2) cos and sin tables in f32."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (S, R/2).  Rotates INTERLEAVED pairs
    (even, odd) of the head dim — the reference's layout, not the
    half-split one of HF's LLaMA.  Dims past ``R`` (partial rotary) pass
    through unchanged."""
    rot = 2 * cos.shape[-1]
    xr = x[..., :rot]
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    c = cos[None, :, None, :].to(x.dtype)
    s = sin[None, :, None, :].to(x.dtype)
    o1 = x1 * c - x2 * s
    o2 = x2 * c + x1 * s
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    if rot == x.shape[-1]:
        return out
    return torch.cat([out, x[..., rot:]], dim=-1)


def embed_tokens(params, token_ids: torch.Tensor, cfg: TransformerConfig,
                 position_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token lookup, gemma sqrt(d) normalizer, learned positions, bloom
    embedding layernorm — the reference's shared embedding preamble."""
    dt = torch_dtype(cfg.dtype)
    x = params["embed"]["tokens"].to(dt)[token_ids]
    if cfg.embed_scale_by_sqrt_dim:
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=dt)
    if cfg.position == "learned":
        if position_ids is None:
            position_ids = torch.arange(token_ids.shape[-1],
                                        device=token_ids.device)
        x = x + params["embed"]["position"].to(dt)[position_ids]
    if cfg.embed_norm:
        x = _norm(x, params["embed_norm"], "layernorm", cfg.norm_eps)
    return x


def _lin(x: torch.Tensor, p: Dict[str, Any], w_key: str, b_key: str
         ) -> torch.Tensor:
    w = p[w_key]
    if isinstance(w, LoRAWeight):  # frozen (maybe quantized) base + LoRA
        y = lora_forward(x, w)
    elif isinstance(w, QuantizedWeight):  # W8A16/W4A16/W6A16 mixed GEMM
        # the autograd wrapper only where a gradient can flow
        y = mixed_gemm_frozen(x, w) if torch.is_grad_enabled() \
            else mixed_gemm(x, w)
    elif isinstance(w, torch.Tensor):
        y = x @ w.to(x.dtype)
    else:
        raise TypeError(f"{w_key} is a {type(w).__name__}, not a weight")
    if b_key in p:
        y = y + p[b_key].to(x.dtype)
    return y


def apply_activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "relu":
        return F.relu(x)
    if kind == "gelu_exact":
        return F.gelu(x, approximate="none")
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    if kind == "silu":
        return F.silu(x)
    raise ValueError(f"unknown activation {kind!r}")


def _mlp_block(x: torch.Tensor, p: Dict[str, Any], cfg: TransformerConfig
               ) -> torch.Tensor:
    if cfg.is_gated_mlp:
        gate = apply_activation(_lin(x, p, "w_gate", "b_gate"), cfg.activation)
        return _lin(gate * _lin(x, p, "w_in", "b_in"), p, "w_out", "b_out")
    mid = apply_activation(_lin(x, p, "w_in", "b_in"), cfg.activation)
    return _lin(mid, p, "w_out", "b_out")


def ffn_block(x: torch.Tensor, lp: Dict[str, Any], cfg: TransformerConfig,
              moe_fn: Optional[Callable] = None) -> torch.Tensor:
    """A layer's feed-forward half on x (B, S, H): the MoE block of
    ``moe/layer.py`` (router losses discarded, as the reference's forward
    does) when ``cfg.num_experts > 0``, else the dense MLP."""
    if cfg.num_experts > 0:
        if moe_fn is None:
            from ..moe.layer import dense_moe_block

            moe_fn = dense_moe_block
        return moe_fn(x, lp["moe"], cfg)
    return _mlp_block(x, lp["mlp"], cfg)


def layer_params(params: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i``'s slice of the stacked ``params["layers"]`` (views; a
    :class:`QuantizedWeight` slices its codes and scales, a LoRA node each
    of its children, so a quantized base's per-layer codes are 2-D)."""
    return tree_map(lambda t: t[i], params["layers"])


# ---------------------------------------------------------------------------
# training forward
# ---------------------------------------------------------------------------


def alibi_slopes(n_heads: int) -> torch.Tensor:
    """Per-head ALiBi slopes (the reference's ``alibi_slopes``)."""
    p2 = 2 ** math.floor(math.log2(n_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(p2) - 3)))
    slopes = [base ** (i + 1) for i in range(p2)]
    if p2 != n_heads:
        extra = 2.0 ** (-(2.0 ** -(math.log2(2 * p2) - 3)))
        slopes += [extra ** (i + 1) for i in range(0, 2 * (n_heads - p2), 2)]
    return torch.tensor(slopes, dtype=torch.float32)


def alibi_bias(n_heads: int, seq_len: int, device: Any = "cpu"
               ) -> torch.Tensor:
    """(H, 1, S) additive logit bias: slope * key position."""
    return (alibi_slopes(n_heads).to(device)[:, None, None]
            * torch.arange(seq_len, dtype=torch.float32,
                           device=device)[None, None, :])


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  segment_ids: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's einsum attention (B, S, H, D), GQA-aware: logits in
    the inputs' dtype, softmax in f32, probabilities back in the inputs'
    dtype.  ``bias`` broadcasts onto the (B, H, S, T) logits."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    logits = torch.einsum("bshd,bthd->bhst", q, k) * (1.0 / math.sqrt(D))
    logits = logits.float()
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        logits = logits.masked_fill(~mask, -1e30)
    if segment_ids is not None:
        seg = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        logits = logits.masked_fill(~seg, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


AttentionFn = Callable[..., torch.Tensor]


def resolve_attention(impl: str) -> AttentionFn:
    """The attention implementation by name: ``xla`` (einsum reference,
    any shape) or ``flash`` (the CUDA flash kernels,
    ``ops/hopper/flash_attention.py``)."""
    if impl == "xla":
        return xla_attention
    if impl == "flash":
        from ..ops.hopper.flash_attention import flash_attention

        return flash_attention
    if impl in ("ulysses", "ring"):
        raise NotImplementedError(
            f"attn_impl={impl!r} is sequence parallelism across GPUs; it "
            "arrives with the multi-GPU item (ROADMAP.md A13)")
    raise ValueError(f"unknown attn_impl {impl!r}")


def _attention_block(x, p, cfg: TransformerConfig, cos, sin,
                     attn_fn: AttentionFn) -> torch.Tensor:
    B, S, _ = x.shape
    nh, nkv, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    q = _lin(x, p, "wq", "bq").reshape(B, S, nh, hd)
    k = _lin(x, p, "wk", "bk").reshape(B, S, nkv, hd)
    v = _lin(x, p, "wv", "bv").reshape(B, S, nkv, hd)
    if cfg.position == "rope":
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if cfg.position == "alibi":
        o = attn_fn(q, k, v, causal=True,
                    bias=alibi_bias(nh, S, x.device)[None])
    else:
        o = attn_fn(q, k, v, causal=True)
    return _lin(o.reshape(B, S, nh * hd), p, "wo", "bo")


#: the reference's remat policies (``_remat_policy``), by name
REMAT_POLICIES = ("everything", "nothing_saveable", "dots_saveable",
                  "dots_with_no_batch_dims_saveable", "save_attn",
                  "save_attn_mlp")


def _remat_policy(name: str) -> str:
    """The layer's remat policy, checked, with the reference's meaning
    (``jax.checkpoint`` policies around the scanned layer body):

    - ``everything``: nothing recomputed, every activation saved;
    - ``nothing_saveable``: the whole layer recomputed in backward
      (``torch.utils.checkpoint`` around it);
    - ``dots_saveable`` / ``dots_with_no_batch_dims_saveable``: the layer
      recomputed except its matmul outputs (all of them / those without
      batch dimensions, i.e. ``aten.mm``/``addmm`` but not ``bmm``), kept
      by a selective-checkpoint policy on the dispatcher's ops;
    - ``save_attn``: the attention output (the reference's ``attn_out``
      tag) saved, the layer around it recomputed: the pre-attention
      segment (norm, projections, rope, attention, ``wo``) and the
      post-attention segment (norm, MLP, residual) are checkpointed
      separately, so the value between them is kept;
    - ``save_attn_mlp``: the MLP output (``mlp_out``) saved too, the MLP
      segment checkpointed on its own.

    The flash kernels are launched through ``ctypes`` inside an autograd
    function, which a selective-checkpoint policy does not see; so, as in
    the reference (whose Pallas forward is not a dot and whose backward
    needs its o and lse), every policy but ``everything`` runs the flash
    forward again in backward: 2 launches of B1 per layer and step, 1 of
    B2 and B3; ``everything`` runs each once."""
    if name not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {name!r}")
    return name


def _dots_policy(batch_dims: bool):
    """A selective-checkpoint policy that saves matmul outputs: ``mm`` and
    ``addmm`` (a projection ``x @ W`` of any rank folds into one), with
    ``batch_dims`` also ``bmm`` and ``baddbmm`` (einsums over batch and
    heads)."""
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    saved = {aten.mm.default, aten.addmm.default}
    if batch_dims:
        saved |= {aten.bmm.default, aten.baddbmm.default}

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return policy


def _checkpointed(fn, policy: str):
    """``fn`` under ``torch.utils.checkpoint`` as ``policy`` asks; the
    named-save policies (``save_attn*``) are built from segments by the
    caller."""
    import functools

    from torch.utils.checkpoint import (
        checkpoint, create_selective_checkpoint_contexts)

    if policy in ("dots_saveable", "dots_with_no_batch_dims_saveable"):
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _dots_policy(policy == "dots_saveable"))
        return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                     context_fn=ctx)
    return lambda *a: checkpoint(fn, *a, use_reentrant=False)


# ZeRO-Infinity parameter streaming (the reference's maybe_stream_in in its
# layer body): each segment below copies its part of layer i in itself, so
# that a checkpointed segment's recompute streams the layer again instead
# of keeping every layer's device copy alive across the backward


def attention_segment(h: torch.Tensor, lp: Dict[str, Any],
                      cfg: TransformerConfig, cos, sin,
                      attn_fn: AttentionFn, i: int = 0) -> torch.Tensor:
    """Layer ``i``'s attention half on h: norm, attention, output
    projection (the reference's ``attn_out``, before the residual)."""
    lp = maybe_stream_in({"ln1": lp["ln1"], "attn": lp["attn"]}, i)
    a_in = _norm(h, lp["ln1"], cfg.norm, cfg.norm_eps)
    return _attention_block(a_in, lp["attn"], cfg, cos, sin, attn_fn)


def mlp_segment(h: torch.Tensor, lp: Dict[str, Any], cfg: TransformerConfig,
                moe_fn: Optional[Callable] = None, i: int = 0
                ) -> torch.Tensor:
    """Layer ``i``'s feed-forward half on h: norm and MLP or MoE block (the
    reference's ``mlp_out``, before the residual)."""
    lp = maybe_stream_in({k: v for k, v in lp.items()
                          if k not in ("ln1", "attn")}, i)
    m_in = _norm(h, lp["ln2"], cfg.norm, cfg.norm_eps)
    return ffn_block(m_in, lp, cfg, moe_fn)


def layer_forward(h: torch.Tensor, lp: Dict[str, Any],
                  cfg: TransformerConfig, cos, sin, attn_fn: AttentionFn,
                  moe_fn: Optional[Callable] = None, i: int = 0
                  ) -> torch.Tensor:
    """Decoder layer ``i`` on h (the reference's ``layer_body``), with
    ``attn_out`` and ``mlp_out`` tagged as the reference tags them
    (``checkpoint_name``: ``cpu_checkpointing`` keeps them on the host)."""
    lp = maybe_stream_in(lp, i)
    attn_out = checkpoint_name(
        attention_segment(h, lp, cfg, cos, sin, attn_fn, i), "attn_out")
    if cfg.parallel_residual:
        return h + attn_out + checkpoint_name(
            mlp_segment(h, lp, cfg, moe_fn, i), "mlp_out")
    h = h + attn_out
    return h + checkpoint_name(mlp_segment(h, lp, cfg, moe_fn, i),
                               "mlp_out")


def forward_hidden(params: Dict[str, Any], tokens: torch.Tensor,
                   cfg: TransformerConfig,
                   attn_fn: Optional[AttentionFn] = None,
                   moe_fn: Optional[Callable] = None) -> torch.Tensor:
    """tokens (B, S) int → final hidden states (B, S, hidden) after the
    final norm, in the compute dtype.  ``moe_fn(x, moe_params, cfg)``
    replaces ``moe/layer.dense_moe_block`` in MoE layers."""
    if cfg.position == "alibi" and cfg.attn_impl != "xla":
        raise ValueError("position='alibi' requires attn_impl='xla'")
    if attn_fn is None:
        attn_fn = resolve_attention(cfg.attn_impl)
        if cfg.sliding_window > 0:
            if cfg.attn_impl != "flash":
                raise ValueError("sliding_window requires attn_impl='flash'")
            window, base_fn = cfg.sliding_window, attn_fn
            attn_fn = lambda *a, **kw: base_fn(*a, window=window, **kw)  # noqa: E731
    tokens = tokens.long()
    S = tokens.shape[1]
    x = embed_tokens(params, tokens, cfg)
    cos = sin = None
    if cfg.position == "rope":
        cos, sin = rope_table(S, cfg.rot_dim, cfg.rope_theta, x.device)

    def attn(h, lp, i):  # -> attn_out
        return attention_segment(h, lp, cfg, cos, sin, attn_fn, i)

    def mlp(h, lp, i):  # -> mlp_out
        return mlp_segment(h, lp, cfg, moe_fn, i)

    def layer(h, lp, i):
        return layer_forward(h, lp, cfg, cos, sin, attn_fn, moe_fn, i)

    def mlp_residual(h, lp, i):  # the post-attention segment of save_attn
        return h + mlp(h, lp, i)

    def parallel_rest(h, attn_out, lp, i):
        return h + attn_out + mlp(h, lp, i)

    policy = _remat_policy(cfg.remat_policy)
    if policy == "everything" or not torch.is_grad_enabled():
        step = layer
    elif policy in ("save_attn", "save_attn_mlp"):
        attn_c = _checkpointed(attn, policy)
        mlp_c = _checkpointed(mlp, policy)
        rest_c = _checkpointed(
            parallel_rest if cfg.parallel_residual else mlp_residual, policy)

        def step(h, lp, i):
            attn_out = attn_c(h, lp, i)  # kept: the segment's output
            if policy == "save_attn_mlp":
                if cfg.parallel_residual:
                    return h + attn_out + mlp_c(h, lp, i)
                h = h + attn_out
                return h + mlp_c(h, lp, i)
            if cfg.parallel_residual:
                return rest_c(h, attn_out, lp, i)
            return rest_c(h + attn_out, lp, i)
    else:
        step = _checkpointed(layer, policy)
    for i in range(cfg.num_layers):
        x = step(x, layer_params(params, i), i)
    return _norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)


def lm_head(params: Dict[str, Any], cfg: TransformerConfig,
            dtype: torch.dtype) -> Tuple[torch.Tensor, bool, Any]:
    """(weight in ``dtype``, whether it is the tied (V, H) embedding, bias
    or None) of the language-model head."""
    if cfg.tie_embeddings:
        return params["embed"]["tokens"].to(dtype), True, None
    return (params["lm_head"]["w"].to(dtype), False,
            params["lm_head"].get("b"))


def forward(params: Dict[str, Any], tokens: torch.Tensor,
            cfg: TransformerConfig,
            attn_fn: Optional[AttentionFn] = None,
            moe_fn: Optional[Callable] = None) -> torch.Tensor:
    """tokens (B, S) → logits (B, S, V) in the compute dtype."""
    dt = torch_dtype(cfg.dtype)
    x = forward_hidden(params, tokens, cfg, attn_fn=attn_fn, moe_fn=moe_fn)
    w, tied, b = lm_head(params, cfg, dt)
    logits = x @ (w.T if tied else w)
    if b is not None:
        logits = logits + b.to(dt)
    return logits


def shift_labels(batch: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Next-token (labels, mask) from a batch, shifting in place (the final
    position is padded with 0 and masked); honours explicit ``labels`` and
    ``loss_mask``."""
    tokens = batch["input_ids"]
    mask = batch.get("loss_mask")
    if "labels" in batch:
        return batch["labels"], mask
    labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], 1)
    shift = torch.cat([torch.ones_like(tokens[:, 1:]),
                       torch.zeros_like(tokens[:, :1])], 1).float()
    return labels, (shift if mask is None else mask * shift)


def cross_entropy_sums(logits: torch.Tensor, labels: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-position (nll, correct) in f32 from logits of any dtype."""
    logits = logits.float()
    logp = torch.log_softmax(logits, dim=-1)
    labels = labels.long()
    nll = -logp.gather(-1, labels[..., None])[..., 0]
    correct = (logits.argmax(-1) == labels).float()
    return nll, correct


def loss_fn(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
            cfg: TransformerConfig, attn_fn: Optional[AttentionFn] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal-LM cross entropy.  batch: ``{'input_ids': (B, S)}``; optional
    ``labels`` (the shift happens here when absent) and ``loss_mask``."""
    labels, mask = shift_labels(batch)
    logits = forward(params, batch["input_ids"], cfg, attn_fn=attn_fn)
    nll, correct = cross_entropy_sums(logits, labels)
    if mask is None:
        loss, acc = nll.mean(), correct.mean()
        denom = torch.tensor(float(nll.numel()), device=nll.device)
    else:
        mask = mask.float()
        denom = mask.sum().clamp(min=1.0)
        loss = (nll * mask).sum() / denom
        acc = (correct * mask).sum() / denom
    return loss, {"loss": loss, "accuracy": acc, "tokens": denom}
