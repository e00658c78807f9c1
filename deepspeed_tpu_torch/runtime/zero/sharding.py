"""ZeRO's sharding rules — the port of
``deepspeed_tpu/runtime/zero/sharding.py``.

The reference expresses ZeRO as a GSPMD sharding policy: each tensor class
(parameters, gradients, optimizer state) gets a ``PartitionSpec`` on the
mesh from the model's *logical* axes (``("layers", "embed", "heads")``)
through :class:`ShardingRules`, and XLA inserts the collectives.  The port
keeps the rules and the specs exactly — a spec here is a plain tuple with
one entry per dim (a mesh-axis name, a tuple of them, or None), equal to
``tuple(PartitionSpec)`` — and the engine issues the collectives itself
(``runtime/engine.py``).  Placing a leaf keeps this rank's slice along each
sharded dim (:class:`NamedSharding`).

Stage mapping (over the combined data-parallel world = ``dp`` × ``fsdp``):

========  =================  ==================  ==================
stage     params             gradients           optimizer state
========  =================  ==================  ==================
0         replicated         all-reduced (dp)    replicated
1         replicated         all-reduced (dp)    sharded over dp
2         replicated         reduce-scattered    sharded over dp
3         sharded (fsdp)     reduce-scattered    sharded over fsdp
========  =================  ==================  ==================
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from ...parallel.topology import MeshTopology
from ...utils.logging import warning_once
from ...utils.tree_io import node_fields, node_items, node_rebuild, tree_map

LogicalAxes = Optional[Tuple[Optional[str], ...]]
Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis name → mesh axis name(s) (None = replicate).

    ``fsdp_fallback`` (stage ≥ 3): when the preferred shard axis is absent or
    indivisible on a leaf, place ``fsdp`` on the largest divisible unsharded
    dim instead of silently replicating — the analogue of stage-3's
    flatten-and-split universality (``stage3.py:830``)."""

    rules: Dict[str, Optional[Tuple[str, ...]]]
    fsdp_fallback: bool = False

    def mesh_axes_for(self, logical: Optional[str]) -> Optional[Tuple[str, ...]]:
        if logical is None:
            return None
        return self.rules.get(logical)

    def updated(self, **kv) -> "ShardingRules":
        new = dict(self.rules)
        for k, v in kv.items():
            new[k] = tuple(v) if v is not None else None
        return ShardingRules(new, self.fsdp_fallback)


def default_rules(stage: int, topo: MeshTopology, shard_axis: str = "embed") -> ShardingRules:
    """Base logical→mesh mapping for a given ZeRO stage; at stage 3 the
    ``shard_axis`` (``embed``, which every transformer weight has) splits
    over ``fsdp``."""
    rules: Dict[str, Optional[Tuple[str, ...]]] = {
        # activations
        "batch": ("dp", "fsdp"),
        "seq": ("sp",),
        # tensor parallel weight axes
        "heads": ("tp",),
        "kv_heads": ("tp",),
        "mlp": ("tp",),
        "vocab": ("tp",),
        "qkv": None,
        "embed": None,
        "kv": None,
        # stacks / experts — the layers axis shards over pp (uniform
        # PipelineModule partition); a no-op when pp == 1
        "layers": ("pp",),
        "expert": ("ep",),
    }
    if stage >= 3:
        rules[shard_axis] = ("fsdp",)
        return ShardingRules(rules, fsdp_fallback=True)
    return ShardingRules(rules)


def rules_for_params(stage: int, topo: MeshTopology) -> ShardingRules:
    return default_rules(stage, topo)


def rules_for_optimizer(stage: int, topo: MeshTopology) -> ShardingRules:
    """Optimizer-state sharding: stages 1/2 shard over the *whole* DP world
    (dp and fsdp axes) even though params stay replicated — ZeRO-1's core idea."""
    rules = default_rules(stage, topo)
    if stage in (1, 2):
        rules = rules.updated(embed=("dp", "fsdp"))
    return rules


# ---------------------------------------------------------------------------
# applying rules to trees
# ---------------------------------------------------------------------------


def _spec_for(shape: Tuple[int, ...], axes: LogicalAxes, rules: ShardingRules,
              topo) -> Spec:
    """The reference's ``_spec_for``, as a tuple (``()`` replicates every
    dim, like ``P()``).  ``topo`` needs only ``size(axis)``."""
    if axes is None:
        return ()
    if len(axes) != len(shape):
        warning_once(f"logical axes {axes} rank-mismatch shape {shape}; replicating")
        return ()
    spec: List[Any] = []
    used: set = set()
    for dim, logical in zip(shape, axes):
        mesh_axes = rules.mesh_axes_for(logical)
        if not mesh_axes:
            spec.append(None)
            continue
        mesh_axes = tuple(a for a in mesh_axes if a not in used and topo.size(a) > 1)
        total = math.prod(topo.size(a) for a in mesh_axes) if mesh_axes else 1
        if total <= 1 or dim % total != 0:
            if total > 1:
                warning_once(
                    f"dim {dim} (logical {logical!r}) not divisible by mesh "
                    f"axes {mesh_axes} (={total}); replicating that dim")
            spec.append(None)
            continue
        used.update(mesh_axes)
        spec.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])

    if rules.fsdp_fallback and "fsdp" not in used:
        n = topo.size("fsdp")
        cands = [i for i, (d, e) in enumerate(zip(shape, spec))
                 if e is None and d >= n and d % n == 0]
        if n > 1 and cands:
            best = max(cands, key=lambda i: shape[i])
            spec[best] = "fsdp"
    return tuple(spec)


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a topology (the reference's ``NamedSharding``): which dims
    split over which mesh axes, and this rank's slice of a leaf."""

    topo: Any
    spec: Spec

    def shard_shape(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        out = list(shape)
        for d, entry in enumerate(self.spec):
            out[d] //= math.prod(self.topo.size(a) for a in _entry_axes(entry))
        return tuple(out)

    @property
    def is_fully_replicated(self) -> bool:
        return all(math.prod(self.topo.size(a) for a in _entry_axes(e)) <= 1
                   for e in self.spec)

    def sharded_dims(self) -> List[Tuple[int, Tuple[str, ...]]]:
        """(dim, mesh axes) of every dim split over more than one rank."""
        return [(d, _entry_axes(e)) for d, e in enumerate(self.spec)
                if math.prod(self.topo.size(a) for a in _entry_axes(e)) > 1]

    def local(self, x: torch.Tensor, rank: Optional[int] = None
              ) -> torch.Tensor:
        """``rank``'s slice of the full tensor ``x`` (a view; default:
        this process's rank)."""
        if rank is None:
            from ...comm import get_rank

            rank = get_rank()
        for d, axes in self.sharded_dims():
            n = math.prod(self.topo.size(a) for a in axes)
            k = self.topo.axis_index(axes, rank)
            size = x.shape[d] // n
            x = x.narrow(d, k * size, size)
        return x


def logical_to_sharding(shape: Tuple[int, ...], axes: LogicalAxes, rules: ShardingRules,
                        topo: MeshTopology) -> NamedSharding:
    return NamedSharding(topo, _spec_for(tuple(shape), axes, rules, topo))


def _is_axes_leaf(x: Any) -> bool:
    return x is None or (isinstance(x, tuple)
                         and all(isinstance(e, (str, type(None))) for e in x))


def sharding_for_tree(tree_shapes: Any, tree_axes: Any, rules: ShardingRules,
                      topo: MeshTopology) -> Any:
    """A :class:`NamedSharding` tree for ``tree_shapes`` (tensors, or
    anything with ``.shape``) guided by a tree of logical-axes tuples.

    ``tree_axes`` may be a *prefix* tree of ``tree_shapes`` — an axes tuple or
    ``None`` at any node applies to the whole matching subtree (``None`` ⇒
    replicate it)."""

    def one(leaf, axes):
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
        return logical_to_sharding(shape, axes, rules, topo)

    def walk(shapes, axes):
        if _is_axes_leaf(axes):
            return tree_map(lambda leaf: one(leaf, axes), shapes)
        kids = node_items(shapes)
        if kids is None:
            raise ValueError(f"axes node {type(axes).__name__} over a leaf")
        return node_rebuild(shapes, [
            walk(v, axes[k] if isinstance(axes, (dict, list, tuple))
                 else getattr(axes, k)) for k, v in kids])

    # the result follows ``tree_shapes``' order (a dict's keys as given)
    return walk(tree_shapes, tree_axes)


def leaves_with_path(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """(``jax.tree_util.keystr`` of the path, leaf) in flatten order: dict
    keys as ``['k']``, list indices as ``[i]``, node fields as ``.f``."""
    kids = node_items(tree)
    if kids is None:
        return [(path, tree)]
    out = []
    obj = bool(node_fields(tree))
    for k, v in kids:
        step = f".{k}" if obj else (f"[{k}]" if isinstance(k, int)
                                    else f"[{k!r}]")
        out += leaves_with_path(v, path + step)
    return out


def shard_accounting(params: Any, shardings: Any) -> Dict[str, Any]:
    """How much of the param bytes ZeRO sharding removes: total bytes,
    per-device bytes, ``sharded_fraction`` (1 - per_device/total; 0 = fully
    replicated) and the paths of replicated leaves ≥ 1 MiB."""
    total = 0
    per_device = 0
    replicated_big = []
    shard_leaves = [s for _, s in leaves_with_path(shardings)]
    for (path, leaf), sh in zip(leaves_with_path(params), shard_leaves):
        item = torch.empty((), dtype=leaf.dtype).element_size()
        nbytes = math.prod(leaf.shape) * item
        local = math.prod(sh.shard_shape(tuple(leaf.shape))) * item
        total += nbytes
        per_device += local
        if local == nbytes and nbytes >= 1 << 20:
            replicated_big.append(path)
    frac = 1.0 - (per_device / total) if total else 0.0
    return {"total_bytes": total, "per_device_bytes": per_device,
            "sharded_fraction": frac, "replicated_leaves": replicated_big}


def shard_pytree(tree: Any, tree_axes: Any, rules: ShardingRules,
                 topo: MeshTopology) -> Any:
    """Each leaf's slice on this rank (contiguous copies, so the full
    tensors can be freed)."""
    shardings = sharding_for_tree(tree, tree_axes, rules, topo)
    return tree_map(lambda x, s: s.local(x).contiguous(), tree, shardings)


# ---------------------------------------------------------------------------
# zero.Init — shard-at-construction context
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def Init(topo: MeshTopology, rules: Optional[ShardingRules] = None, stage: int = 3):
    """Shard-at-construction context (reference: ``partition_parameters.py:884
    zero.Init``): ``init_sharded(init_fn, axes_tree, *args, **kwargs)``
    builds the tree and keeps this rank's shards.  The reference's jit
    materializes only the shards; the port draws each tree whole (on the
    device ``init_fn`` is given — the CPU keeps it off the card) so that
    every rank's values are those of one full initialization, then keeps
    its slices."""
    rules = rules or rules_for_params(stage, topo)

    class _Ctx:
        def init_sharded(self, init_fn, axes_tree, *args, **kwargs):
            return shard_pytree(init_fn(*args, **kwargs), axes_tree, rules,
                                topo)

    yield _Ctx()
