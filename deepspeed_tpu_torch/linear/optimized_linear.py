"""LoRA and quantized-base linear layers — the port of
``deepspeed_tpu/linear/optimized_linear.py``.

The reference's trainable projection is a tree node, :class:`LoRAWeight`,
that takes the place of a plain ``(..., K, N)`` weight in the parameter
tree:

* ``base`` — the frozen full-rank weight: a tensor, or a
  :class:`QuantizedBaseWeight` of block-scaled codes (``ops/quantizer.py``
  fp8 e4m3 in the flat ``"block"`` layout; int8, int4, fp6 in the mixed
  GEMM's row-group ``"gemm"`` layout, ``ops/hopper/mixed_gemm.py``);
* ``lora_a`` ``(..., K, r)`` / ``lora_b`` ``(..., r, N)`` — the trainable
  factors, A drawn N(0, 1/K), B zeros, so training starts at the base
  model;
* ``scaling`` — ``lora_alpha / lora_r``.

The port's parameter trees are nested dicts of tensors; a node class names
its children in ``tree_fields`` (``utils/tree_io.node_fields``), in the
reference's flatten order, so every tree walker of the port (the engine's
leaves and paths, the checkpoint's ``flatten_with_paths``, the layer
slicing of ``models/transformer.py``) names a node's children as the
reference does: ``layers/attn/wq/lora_a``, ``layers/attn/wq/base/codes``.

Freezing is :func:`trainable_mask`: only the factors train; the engine
differentiates and optimizes the leaves the mask selects, so no gradient
or optimizer state exists for a frozen leaf.  A gemm-layout base with
per-layer (2-D) codes and bf16 activations runs B6 (``mixed_gemm_frozen``,
the gradient to x only); every other base is dequantized, detached, and
multiplied — the reference's rule (``optimized_linear.py:260-262``),
decided from the shapes and dtypes, never from a failure.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Tuple

import torch

from ..accelerator import resolve_device
from ..ops import quantizer as quantizer_ops
from ..ops.hopper.mixed_gemm import (QuantizedWeight, aligned_divisor,
                                     dequantize_gemm_weight, mixed_gemm,
                                     mixed_gemm_frozen, quantize_gemm_weight)
from ..utils.tree_io import node_items, node_replace, tree_map
from .config import LoRAConfig, QuantizationConfig

#: the compute dtype of the kernel path and of a quantized base's
#: materialization (the reference's ``_COMPUTE_DTYPE``)
_COMPUTE_DTYPE = torch.bfloat16

#: (q_bits, mantissa_bits) stored in the mixed GEMM's row-group layout;
#: fp8 (8, 3) keeps the flat block layout (the kernel decodes no e4m3)
_GEMM_FORMATS = frozenset({(8, 0), (4, 0), (6, 2)})

#: leaf names of the adapter: the only trainable, checkpointed state of a
#: PEFT run
ADAPTER_LEAF_KEYS = ("lora_a", "lora_b")


# ---------------------------------------------------------------------------
# trees: dicts, lists and tuples, and the node objects of this module
# ---------------------------------------------------------------------------


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in the reference's flatten order (dict keys
    sorted, a node's children in its field order), without the ``None`` a
    frozen leaf becomes."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    kids = node_items(tree)
    if kids is not None:
        return [x for _, v in kids for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def trainable_subtree(tree: Any, mask: Any) -> Any:
    """Replace frozen leaves (``mask`` False) with ``None``, so an optimizer
    or a gradient built from the result covers the trainable leaves
    only."""
    return tree_map(lambda p, m: p if m else None, tree, mask)


def merge_trainable(trainable: Any, full: Any, mask: Any) -> Any:
    """Inverse of :func:`trainable_subtree`: the trainable leaves from
    ``trainable``, the frozen ones from ``full``."""
    return tree_map(lambda p, t, m: t if m else p, full, trainable, mask)


# ---------------------------------------------------------------------------
# quantized frozen base
# ---------------------------------------------------------------------------


def _quant_matrix(mat: torch.Tensor, *, q_bits: int, mantissa_bits: int,
                  group_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    if (q_bits, mantissa_bits) == (8, 3):
        codes, scales = quantizer_ops.quantize_fp8(mat, block_size=group_size)
        # stored as the bytes' integers (safetensors-serializable), viewed
        # back as e4m3 to decode
        return codes.view(torch.uint8), scales
    if q_bits == 6:
        return quantizer_ops.quantize_minifloat(mat, bits=6,
                                                block_size=group_size)
    return quantizer_ops.quantize_blockwise(mat, bits=q_bits,
                                            block_size=group_size)


def _dequant_matrix(codes: torch.Tensor, scales: torch.Tensor, *,
                    q_bits: int, mantissa_bits: int, group_size: int,
                    shape: Tuple[int, ...], dtype: torch.dtype
                    ) -> torch.Tensor:
    if (q_bits, mantissa_bits) == (8, 3):
        return quantizer_ops.dequantize_fp8(
            codes.view(torch.float8_e4m3fn), scales, shape=shape, dtype=dtype)
    if q_bits == 6:
        return quantizer_ops.dequantize_minifloat(codes, scales, bits=6,
                                                  shape=shape, dtype=dtype)
    return quantizer_ops.dequantize_blockwise(codes, scales, bits=q_bits,
                                              block_size=group_size,
                                              shape=shape, dtype=dtype)


@dataclasses.dataclass(eq=False)
class QuantizedBaseWeight:
    """A frozen base weight as block-scaled codes (reference
    ``optimized_linear.py:104``).  ``codes`` / ``scales`` carry the
    matrix's leading stack dims (``layers``); ``inner_shape`` is the
    trailing ``(K, N)`` they decode to.  ``layout``:

    * ``"gemm"`` — the mixed GEMM's layout (codes ``(..., Kp, N)``, scales
      ``(..., K/group, N)``): per-layer codes run B6;
    * ``"block"`` — the flat codecs of ``ops/quantizer.py`` (codes
      ``(..., nblocks, block)``, scales ``(..., nblocks)``): fp8 e4m3,
      dequantized before the matmul.
    """

    tree_fields = ("codes", "scales")

    codes: Any
    scales: Any
    q_bits: int = 8
    mantissa_bits: int = 3
    group_size: int = 512
    inner_shape: Tuple[int, ...] = ()
    layout: str = "block"

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.codes.shape[:-2]) + tuple(self.inner_shape)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def to(self, device: Any) -> "QuantizedBaseWeight":
        """The same weight on ``device``; codes and scales keep their
        dtypes."""
        return node_replace(self, [self.codes.to(device),
                                   self.scales.to(device)])

    def as_gemm_weight(self) -> QuantizedWeight:
        """Gemm-layout codes as the mixed GEMM's weight."""
        if self.layout != "gemm":
            raise ValueError(f"as_gemm_weight needs the gemm layout, got "
                             f"{self.layout!r}")
        return QuantizedWeight(self.codes, self.scales, self.q_bits,
                               self.group_size, k=int(self.inner_shape[-2]))

    def dequantize(self, dtype: torch.dtype = _COMPUTE_DTYPE) -> torch.Tensor:
        if self.layout == "gemm":
            return dequantize_gemm_weight(self.as_gemm_weight()).to(dtype)
        lead = tuple(self.codes.shape[:-2])
        codes = self.codes.reshape((-1,) + tuple(self.codes.shape[-2:]))
        scales = self.scales.reshape((-1,) + tuple(self.scales.shape[-1:]))
        mats = [_dequant_matrix(c, s, q_bits=self.q_bits,
                                mantissa_bits=self.mantissa_bits,
                                group_size=self.group_size,
                                shape=tuple(self.inner_shape), dtype=dtype)
                for c, s in zip(codes, scales)]
        return torch.stack(mats).reshape(lead + tuple(self.inner_shape))


def quantize_base_weight(w: torch.Tensor, qcfg: QuantizationConfig
                         ) -> QuantizedBaseWeight:
    """Quantize a ``(..., K, N)`` weight matrix by matrix, where it lies (a
    block never straddles the stack dims).  int8 / int4 / fp6 take the
    mixed GEMM's layout, with its group shrunk to a divisor of K where the
    group does not divide it (reference ``:186-187``)."""
    if w.dim() < 2:
        raise ValueError(f"need a matrix to quantize, got shape "
                         f"{tuple(w.shape)}")
    inner = tuple(w.shape[-2:])
    lead = tuple(w.shape[:-2])
    fmt = (qcfg.q_bits, qcfg.mantissa_bits)
    mats = w.reshape((-1,) + inner)
    if fmt in _GEMM_FORMATS:
        group = qcfg.group_size
        if inner[0] % group != 0:
            group = aligned_divisor(inner[0], group, 1) or inner[0]
        parts = [quantize_gemm_weight(m, bits=qcfg.q_bits, group=group)
                 for m in mats]
        codes = torch.stack([q.codes for q in parts])
        scales = torch.stack([q.scales for q in parts])
        layout = "gemm"
    else:
        group = qcfg.group_size
        parts = [_quant_matrix(m, q_bits=qcfg.q_bits,
                               mantissa_bits=qcfg.mantissa_bits,
                               group_size=group) for m in mats]
        codes = torch.stack([c for c, _ in parts])
        scales = torch.stack([s for _, s in parts])
        layout = "block"
    return QuantizedBaseWeight(
        codes.reshape(lead + tuple(codes.shape[1:])),
        scales.reshape(lead + tuple(scales.shape[1:])), qcfg.q_bits,
        qcfg.mantissa_bits, group, inner, layout)


# ---------------------------------------------------------------------------
# the LoRA node
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class LoRAWeight:
    """A projection weight as frozen ``base`` plus trainable ``scaling ·
    lora_a @ lora_b`` (reference ``optimized_linear.py:219``)."""

    tree_fields = ("base", "lora_a", "lora_b")

    base: Any
    lora_a: Any
    lora_b: Any
    scaling: float = 1.0

    def base_materialized(self, dtype: torch.dtype = _COMPUTE_DTYPE
                          ) -> torch.Tensor:
        if isinstance(self.base, QuantizedBaseWeight):
            return self.base.dequantize(dtype)
        return self.base.to(dtype)


def _is_lora(x: Any) -> bool:
    return isinstance(x, LoRAWeight)


def lora_forward(x: torch.Tensor, w: LoRAWeight) -> torch.Tensor:
    """``x @ base + scaling · (x @ A) @ B``.  A gemm-layout base with 2-D
    codes at bf16 x runs the mixed GEMM (B6; under autograd
    :func:`mixed_gemm_frozen`, whose backward sends the gradient to x
    only); any other base is materialized in x's dtype, detached, and
    multiplied."""
    dt = x.dtype
    base = w.base
    if (isinstance(base, QuantizedBaseWeight) and base.layout == "gemm"
            and base.codes.dim() == 2 and dt == _COMPUTE_DTYPE):
        qw = base.as_gemm_weight()
        y = mixed_gemm_frozen(x, qw) if torch.is_grad_enabled() \
            else mixed_gemm(x, qw)
    else:
        y = x @ w.base_materialized(dt).detach()
    ax = x @ w.lora_a.to(dt)
    return y + (ax @ w.lora_b.to(dt)) * w.scaling


def init_lora_weight(generator: torch.Generator, w: torch.Tensor,
                     cfg: LoRAConfig) -> LoRAWeight:
    """Wrap a dense ``(..., K, N)`` weight as a LoRA node: A ~ N(0, 1/K)
    from ``generator`` (drawn on its device, in f32, then cast to w's
    dtype on w's device), B zeros, the base quantized where w lies when
    ``cfg.quantize_base``."""
    k_in, n_out = w.shape[-2:]
    lead = tuple(w.shape[:-2])
    a = torch.randn(lead + (k_in, cfg.lora_r), generator=generator,
                    dtype=torch.float32, device=generator.device)
    a = (a * (1.0 / math.sqrt(k_in))).to(device=w.device, dtype=w.dtype)
    b = torch.zeros(lead + (cfg.lora_r, n_out), dtype=w.dtype,
                    device=w.device)
    base = (quantize_base_weight(w, cfg.quantization)
            if cfg.quantize_base else w)
    return LoRAWeight(base, a, b, cfg.scaling)


class OptimizedLinear(torch.nn.Module):
    """The reference's module surface (``optimized_linear.py:283``) for
    users composing their own models: a frozen base held as buffers (a
    dense ``base``, or a quantized base's ``base_codes`` and
    ``base_scales``) and the factors as ``nn.Parameter``s ``lora_a`` /
    ``lora_b``."""

    def __init__(self, weight: LoRAWeight):
        super().__init__()
        self._quant = None
        if isinstance(weight.base, QuantizedBaseWeight):
            self.register_buffer("base_codes", weight.base.codes)
            self.register_buffer("base_scales", weight.base.scales)
            self._quant = weight.base
        else:
            self.register_buffer("base", weight.base.detach())
        self.lora_a = torch.nn.Parameter(weight.lora_a.detach().clone())
        self.lora_b = torch.nn.Parameter(weight.lora_b.detach().clone())
        self.scaling = weight.scaling

    @classmethod
    def init(cls, generator: torch.Generator, input_dim: int,
             output_dim: int, lora_config: Optional[LoRAConfig] = None,
             dtype: torch.dtype = torch.float32, device: Any = "cuda"
             ) -> "OptimizedLinear":
        """A fresh layer: the base drawn N(0, 1/input_dim) from
        ``generator``, then :func:`init_lora_weight` on ``device``."""
        dev = resolve_device(device)
        cfg = lora_config or LoRAConfig(enabled=True)
        w = torch.randn((input_dim, output_dim), generator=generator,
                        dtype=torch.float32, device=generator.device)
        w = (w * (1.0 / math.sqrt(input_dim))).to(device=dev, dtype=dtype)
        return cls(init_lora_weight(generator, w, cfg))

    @property
    def weight(self) -> LoRAWeight:
        base = self.base if self._quant is None else node_replace(
            self._quant, [self.base_codes, self.base_scales])
        return LoRAWeight(base, self.lora_a, self.lora_b, self.scaling)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return lora_forward(x, self.weight)


# ---------------------------------------------------------------------------
# tree surgery: wrap targets, graft packs, merge back
# ---------------------------------------------------------------------------


def _wrappable(k: str, v: Any, targets) -> bool:
    return (k in targets and isinstance(v, torch.Tensor) and v.dim() >= 2)


#: leading axes of a stacked weight that its LoRA factors keep
_STACK_AXES = ("layers", "expert")


def _axes_for_node(node: LoRAWeight, w_axes, base_weight_sharding: int
                   ) -> LoRAWeight:
    """Logical axes for a LoRA node, derived from the wrapped weight's
    axes (the reference's ``_axes_for_node``).

    ``base_weight_sharding == 1`` (the reference default) strips the base's
    non-stack axes so the frozen copy replicates (or is picked up by the
    stage-3 fsdp fallback); any other value keeps the original axes.  The
    factors keep the base's in/out axis on their full-rank side and leave
    the rank-``r`` side unsharded; a quantized base keeps its stack axes
    alone (its code grid is not the (K, N) plane)."""
    ndim = node.lora_a.dim()
    if not (isinstance(w_axes, tuple) and len(w_axes) == ndim):
        w_axes = (None,) * ndim
    lead, in_ax, out_ax = w_axes[:-2], w_axes[-2], w_axes[-1]
    stack_lead = tuple(ax if ax in _STACK_AXES else None for ax in lead)
    if base_weight_sharding == 1:
        base_axes = stack_lead + (None, None)
    else:
        base_axes = w_axes
    if isinstance(node.base, QuantizedBaseWeight):
        q = node.base
        base_axes = QuantizedBaseWeight(
            stack_lead + (None,) * (q.codes.dim() - len(stack_lead)),
            stack_lead + (None,) * (q.scales.dim() - len(stack_lead)),
            q.q_bits, q.mantissa_bits,
            q.group_size, tuple(q.inner_shape), q.layout)
    return LoRAWeight(base_axes,
                      stack_lead + (in_ax, None),
                      stack_lead + (None, out_ax),
                      node.scaling)


def apply_lora(params: Any, axes: Any, generator: torch.Generator,
               cfg: LoRAConfig) -> Tuple[Any, Any]:
    """Swap every targeted projection of a parameter tree for a LoRA node
    (drawn from ``generator`` in tree order).  Returns ``(params', axes')``
    transformed together, as the reference's does, so the sharding rules'
    prefix matching keeps working (``axes`` may be None).  The ``moe``
    subtree is left as it is: its expert weights go through the grouped
    GEMM, not the dense projection."""
    if not isinstance(params, dict):
        raise TypeError("apply_lora expects the dict parameter tree of "
                        "models/transformer.py (or an HF-converted tree)")
    targets = set(cfg.target_modules)

    def walk(p, a):
        new_p = {}
        new_a = {} if isinstance(a, dict) else a
        for k, v in p.items():
            sub_a = a.get(k) if isinstance(a, dict) else a
            if isinstance(v, dict):
                rp, ra = (v, sub_a) if k == "moe" else walk(v, sub_a)
            elif _wrappable(k, v, targets):
                rp = init_lora_weight(generator, v, cfg)
                ra = _axes_for_node(
                    rp, sub_a if isinstance(sub_a, tuple) else None,
                    cfg.base_weight_sharding)
            else:
                rp, ra = v, sub_a
            new_p[k] = rp
            if isinstance(new_a, dict):
                new_a[k] = ra
        return new_p, new_a

    return walk(params, axes)


def expand_axes_for_lora(axes: Any, params: Any,
                         base_weight_sharding: int = 1) -> Any:
    """Post-pass for ``param_axes(cfg, params=…)`` on a tree that already
    holds LoRA nodes: wherever ``params`` has a :class:`LoRAWeight` and
    ``axes`` still the original weight's plain tuple, expand it."""
    if not isinstance(params, dict) or not isinstance(axes, dict):
        return axes
    out = {}
    for k, a in axes.items():
        p = params.get(k)
        if isinstance(p, LoRAWeight) and not isinstance(a, LoRAWeight):
            out[k] = _axes_for_node(p, a if isinstance(a, tuple) else None,
                                    base_weight_sharding)
        elif isinstance(a, dict):
            out[k] = expand_axes_for_lora(a, p if isinstance(p, dict) else {},
                                          base_weight_sharding)
        else:
            out[k] = a
    return out


def graft_adapter_pack(params: Any, pack: Any, scaling: float = 1.0) -> Any:
    """Wrap the targeted projections of a plain tree with the factors of a
    serving adapter pack ``{target: (a (L, K, r), b (L, r, N))}`` (registry
    packs carry the scaling in ``b``: pass ``scaling=1.0``); the result
    feeds :func:`merge_lora_weights`."""
    pack = dict(pack)
    found = set()

    def walk(p):
        if not isinstance(p, dict):
            return p
        out = {}
        for k, v in p.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif _wrappable(k, v, pack):
                a, b = (torch.as_tensor(t) for t in pack[k])
                if tuple(v.shape) != (a.shape[0], a.shape[1], b.shape[2]):
                    raise ValueError(
                        f"adapter pack target {k!r} wants a weight of shape "
                        f"{(a.shape[0], a.shape[1], b.shape[2])}, tree has "
                        f"{tuple(v.shape)}")
                found.add(k)
                out[k] = LoRAWeight(v, a.to(v.device), b.to(v.device),
                                    float(scaling))
            else:
                out[k] = v
        return out

    grafted = walk(params)
    missing = set(pack) - found
    if missing:
        raise ValueError(f"adapter pack targets {sorted(missing)} not found "
                         "in the parameter tree")
    return grafted


def has_lora(tree: Any) -> bool:
    if _is_lora(tree):
        return True
    kids = node_items(tree)
    return kids is not None and any(has_lora(v) for _, v in kids)


def merge_lora_weights(tree: Any, dtype: Optional[torch.dtype] = None
                       ) -> Any:
    """Fold every LoRA node into a dense weight ``W + scaling · A @ B``,
    summed in f32 where the tensors lie (a quantized base materialized in
    bf16 first), in ``dtype`` — default the base's dtype, the factors' for
    a quantized base (reference ``merge_lora_weights``)."""

    def merge(n: LoRAWeight) -> torch.Tensor:
        quantized = isinstance(n.base, QuantizedBaseWeight)
        mat = (n.base_materialized(_COMPUTE_DTYPE).float() if quantized
               else n.base.float())
        delta = torch.einsum("...kr,...rn->...kn", n.lora_a.float(),
                             n.lora_b.float()) * n.scaling
        out_dt = dtype or (n.lora_a.dtype if quantized else n.base.dtype)
        return (mat + delta).to(out_dt)

    return tree_map(lambda x: merge(x) if _is_lora(x) else x, tree,
                    is_leaf=_is_lora)


# ---------------------------------------------------------------------------
# the trainable-mask partition (runtime/engine.py)
# ---------------------------------------------------------------------------


def trainable_mask(tree: Any) -> Any:
    """``tree``'s structure of booleans: True at the LoRA factors, False
    everywhere else (embeddings, norms, untargeted projections and the
    bases are frozen)."""

    def mask(x):
        if _is_lora(x):
            return LoRAWeight(tree_map(lambda _: False, x.base), True, True,
                              x.scaling)
        return False

    return tree_map(mask, tree, is_leaf=_is_lora)


def adapter_only_flat(flat: dict) -> dict:
    """A ``flatten_with_paths`` dict cut to the adapter leaves — an
    adapter-only checkpoint's payload."""
    return {k: v for k, v in flat.items()
            if k.split("/")[-1] in ADAPTER_LEAF_KEYS}
