"""Weight-only quantization for inference parameters — the port of
``deepspeed_tpu/inference/quantization.py``.

The projection weights of every transformer layer (``_QUANT_KEYS`` under
``attn``/``mlp``) become :class:`QuantizedWeight` nodes, which
``models/transformer._lin`` routes through the mixed GEMM.  Embeddings,
the lm_head and norms stay in full precision, as in the reference.

**Where the quantization runs.**  The reference moves the weights to the
host before it quantizes them, so the accelerator never holds the
full-precision weights beside their codes.  The port quantizes one layer
slice at a time where the caller's tensors lie and places only the codes
and scales on the target device: CPU weights stay on the CPU until their
codes move to the card; weights already on the card are quantized there,
so the f32 working copy never exceeds one layer's slice.  Codes and scales
are the same either way.  ``shardings_for_quantized`` (GSPMD) arrives with
the multi-GPU item (``ROADMAP.md`` A13).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import torch

from ..ops.hopper.mixed_gemm import QuantizedWeight, quantize_gemm_weight

logger = logging.getLogger(__name__)

# projection weights inside each layer's attn/mlp dicts
_QUANT_KEYS = frozenset({"wq", "wk", "wv", "wo", "w_in", "w_out", "w_gate"})
_QUANT_PARENTS = frozenset({"attn", "mlp"})


def _quantize_stacked(w: torch.Tensor, bits: int, group: int,
                      device: Optional[torch.device]) -> QuantizedWeight:
    """``w`` (L, K, N) quantized one layer at a time where it lies, the
    codes and scales written into tensors on ``device`` (default: w's)."""
    dev = w.device if device is None else device
    if w.dim() == 2:
        return quantize_gemm_weight(w, bits=bits, group=group).to(dev)
    first = quantize_gemm_weight(w[0], bits=bits, group=group)
    lead = tuple(w.shape[:-2])
    codes = torch.empty(lead + tuple(first.codes.shape),
                        dtype=first.codes.dtype, device=dev)
    scales = torch.empty(lead + tuple(first.scales.shape),
                         dtype=first.scales.dtype, device=dev)
    flat_w = w.reshape(-1, *w.shape[-2:])
    flat_c = codes.view(-1, *first.codes.shape)
    flat_s = scales.view(-1, *first.scales.shape)
    for i in range(flat_w.shape[0]):
        q = first if i == 0 else quantize_gemm_weight(flat_w[i], bits=bits,
                                                      group=group)
        flat_c[i].copy_(q.codes)
        flat_s[i].copy_(q.scales)
    return QuantizedWeight(codes, scales, bits, first.group, first.k)


def quantize_model_params(params: Dict[str, Any], bits: int = 8,
                          group: int = 256,
                          device: Optional[Any] = None) -> Dict[str, Any]:
    """Replace layer projection weights with :class:`QuantizedWeight`
    nodes, quantized slice by slice where they lie; the codes and scales
    land on ``device`` (default: where each weight lies).  Other leaves are
    returned as they are."""
    saw_moe = False
    dev = None if device is None else torch.device(device)

    def walk(tree, parent=None):
        nonlocal saw_moe
        if isinstance(tree, dict):
            if "moe" in tree:
                saw_moe = True
            return {k: (_quantize_stacked(v, bits, group, dev)
                        if (parent in _QUANT_PARENTS and k in _QUANT_KEYS
                            and getattr(v, "ndim", 0) >= 2)
                        else walk(v, k))
                    for k, v in tree.items()}
        return tree

    out = walk(params)
    if saw_moe:
        logger.warning(
            "quantize_model_params: expert (MoE) weights stay "
            "high-precision — the einsum dispatch path does not take "
            "QuantizedWeight; only attention/MLP projections were quantized. "
            "Check quantized_bytes() for the actual savings.")
    return out


def quantize_on_host(params: Dict[str, Any], bits: int, group: int,
                     device: Any = "cuda") -> Dict[str, Any]:
    """The serving engine's entry (the reference's name): quantize where
    the weights lie, one layer slice at a time, and place only the codes
    and scales on ``device`` (see the module doc)."""
    return quantize_model_params(params, bits=bits, group=group,
                                 device=device)


def quantized_bytes(params: Dict[str, Any]) -> Dict[str, int]:
    """{quantized, total} parameter bytes — the memory-saving accounting."""
    q = t = 0

    def walk(node):
        nonlocal q, t
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, QuantizedWeight):
            b = (node.codes.numel() * node.codes.element_size()
                 + node.scales.numel() * node.scales.element_size())
            q += b
            t += b
        elif isinstance(node, torch.Tensor):
            t += node.numel() * node.element_size()

    walk(params)
    return {"quantized": q, "total": t}
