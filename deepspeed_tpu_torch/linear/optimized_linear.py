"""The trainable-mask partition of ``deepspeed_tpu/linear/
optimized_linear.py`` (``trainable_subtree``, ``merge_trainable``) over the
port's parameter trees: nested dicts (or lists and tuples) of tensors.

The rest of the PEFT subsystem (``LoRAWeight`` leaves, quantized bases,
``OptimizedLinear``, adapter-only checkpoints) is not ported yet: it
arrives with ROADMAP.md queue A item A14.
"""

from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the same-shaped ``rest``
    (dicts, lists and tuples are nodes; ``None`` in ``tree`` is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in the reference's flatten order (dict keys
    sorted), without the ``None`` a frozen leaf becomes."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def trainable_subtree(tree: Any, mask: Any) -> Any:
    """Replace frozen leaves (``mask`` False) with ``None``, so an optimizer
    or a gradient built from the result covers the trainable leaves
    only."""
    return tree_map(lambda p, m: p if m else None, tree, mask)


def merge_trainable(trainable: Any, full: Any, mask: Any) -> Any:
    """Inverse of :func:`trainable_subtree`: the trainable leaves from
    ``trainable``, the frozen ones from ``full``."""
    return tree_map(lambda t, p, m: t if m else p, trainable, full, mask)
