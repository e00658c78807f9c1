"""Host views of tensors for the safetensors writers, and the node protocol
of parameter trees — the part of ``deepspeed_tpu/utils/tree_io.py`` the
port needs.

numpy has no bfloat16 and the port does not depend on ``ml_dtypes``, so a
bf16 tensor crosses to numpy as a ``uint16`` view of its bits, while its
safetensors dtype stays ``"BF16"``: a payload written here is byte for
byte the reference's (which holds bf16 as an ``ml_dtypes`` array).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

#: numpy dtype name -> safetensors dtype (``"bfloat16"`` covers a numpy
#: array of ml_dtypes' bfloat16 handed in by a caller that has it)
ST_DTYPES = {
    "float64": "F64", "float32": "F32", "float16": "F16",
    "bfloat16": "BF16",
    "int64": "I64", "int32": "I32", "int16": "I16", "int8": "I8",
    "uint64": "U64", "uint32": "U32", "uint16": "U16", "uint8": "U8",
    "bool": "BOOL",
}

#: safetensors dtype -> torch dtype (what a payload decodes into)
TORCH_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "U16": torch.uint16, "BOOL": torch.bool,
}
_ST_OF_TORCH = {v: k for k, v in TORCH_DTYPES.items()}


def host_array(x: Any) -> Tuple[np.ndarray, str]:
    """``(C-contiguous numpy array holding x's bytes, safetensors dtype)``
    for a numpy array or a torch tensor (copied to the host if it lies on
    the device; bf16 as a ``uint16`` view tagged ``"BF16"``)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        st = _ST_OF_TORCH.get(t.dtype)
        if st is None:
            raise TypeError(f"dtype {t.dtype} not representable in "
                            "safetensors")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.uint16)
        return t.numpy(), st
    arr = np.asarray(x)
    if not arr.flags["C_CONTIGUOUS"]:  # (ascontiguousarray makes 0-d 1-d)
        arr = np.ascontiguousarray(arr)
    st = ST_DTYPES.get(str(arr.dtype))
    if st is None:
        raise TypeError(f"dtype {arr.dtype} not representable in "
                        "safetensors")
    return arr, st


def host_arrays(arrays: Dict[str, Any]) -> Dict[str, Tuple[np.ndarray, str]]:
    """:func:`host_array` of every entry, in the dict's order."""
    return {name: host_array(x) for name, x in arrays.items()}


def node_fields(x: Any) -> Tuple[str, ...]:
    """The named children of a parameter-tree node object — its class's
    ``tree_fields`` (``LoRAWeight``: base, lora_a, lora_b;
    ``QuantizedBaseWeight``: codes, scales), in the reference's flatten
    order — or () for a leaf."""
    return getattr(type(x), "tree_fields", ())


def node_items(x: Any) -> Optional[List[Tuple[Any, Any]]]:
    """(key, child) pairs of an inner node of a parameter tree — a dict's
    items as given, a list's or tuple's indices, a node object's fields —
    or None for a leaf."""
    if isinstance(x, dict):
        return list(x.items())
    if isinstance(x, (list, tuple)):
        return list(enumerate(x))
    fields = node_fields(x)
    return [(f, getattr(x, f)) for f in fields] if fields else None


def node_replace(x: Any, values: Any) -> Any:
    """A copy of node ``x`` with its children (:func:`node_fields` order)
    replaced by ``values``; every other field kept."""
    return dataclasses.replace(x, **dict(zip(node_fields(x), values)))


def node_rebuild(node: Any, values: List[Any]) -> Any:
    """``node`` (a dict, list, tuple or node object) with its children
    (:func:`node_items` order) replaced by ``values``."""
    if isinstance(node, dict):
        return dict(zip(node, values))
    if isinstance(node, (list, tuple)):
        return type(node)(values)
    return node_replace(node, values)


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """``fn`` over the leaves of ``tree`` and the same-shaped ``rest``
    (dicts, lists, tuples and node objects are inner nodes; ``None`` in
    ``tree`` is a leaf, and a ``None`` in ``rest`` stands for a subtree of
    ``None``); ``is_leaf`` stops the walk at the nodes it accepts."""
    kids = None if is_leaf is not None and is_leaf(tree) else \
        node_items(tree)
    if kids is None:
        return fn(tree, *rest)

    def child(r, k):
        if r is None:
            return None
        return r[k] if isinstance(r, (dict, list, tuple)) else getattr(r, k)

    return node_rebuild(tree, [tree_map(fn, v, *(child(r, k) for r in rest),
                                        is_leaf=is_leaf) for k, v in kids])
