"""Device-mesh topology — the port of ``deepspeed_tpu/parallel/topology.py``.

The reference names every parallel group as an axis of one
``jax.sharding.Mesh`` over the devices.  The port has one process per GPU
under a ``torch.distributed`` world: the mesh is an array of those ranks in
the reference's axis order (outer to inner) ``pp, dp, fsdp, ep, sp, tp``,
backed by a ``torch.distributed.device_mesh.DeviceMesh`` once a process
group is up, and a group of axes (one name or a tuple, as the reference's
collectives take them) is the process group of the ranks that differ only
along those axes.  Ranks are laid out row-major, so a group's ranks in
ascending order are its members in the axes' linear order, which is how
``lax`` numbers a shard over several axes.

This slice runs the data-parallel axes ``dp`` and ``fsdp``: a mesh whose
``pp``, ``ep``, ``sp`` or ``tp`` is larger than 1 raises
``NotImplementedError`` naming the later parts of ROADMAP.md A13.  Sizes,
coordinates and the divisibility errors are the reference's, word for word.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..runtime.config import MeshConfig
from ..runtime.config_utils import ConfigError, is_auto

MESH_AXES: Tuple[str, ...] = ("pp", "dp", "fsdp", "ep", "sp", "tp")

# Logical tensor-axis names used by models; sharding rules map these to mesh axes.
LOGICAL_AXES = (
    "batch", "seq", "heads", "kv_heads", "embed", "mlp", "vocab",
    "layers", "expert", "kv", "qkv",
)

#: the axes this slice runs; the others arrive with later parts of A13
DATA_AXES = ("dp", "fsdp")


@dataclasses.dataclass(frozen=True)
class AxisSpec:
    name: str
    size: int


def _world_ranks() -> List[int]:
    """The ranks of the ``torch.distributed`` world, or [0] without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return list(range(dist.get_world_size()))
    return [0]


class MeshTopology:
    """Resolved mesh axis sizes, the array of ranks (``mesh``) and, once a
    process group is up, its ``DeviceMesh`` and the groups of axes."""

    def __init__(self, axis_sizes: Dict[str, int],
                 devices: Optional[Sequence[int]] = None,
                 dcn_axes: Sequence[str] = ("pp", "dp"),
                 device_type: str = "cuda"):
        for ax in axis_sizes:
            if ax not in MESH_AXES:
                raise ConfigError(f"unknown mesh axis {ax!r}; valid: {MESH_AXES}")
        self.axis_sizes = {ax: int(axis_sizes.get(ax, 1)) for ax in MESH_AXES}
        self.dcn_axes = tuple(dcn_axes)
        self.device_type = device_type

        devices = list(devices) if devices is not None else _world_ranks()
        total = math.prod(self.axis_sizes.values())
        if total != len(devices):
            raise ConfigError(
                f"mesh axes {self.axis_sizes} require {total} devices, "
                f"have {len(devices)}")
        later = [ax for ax in MESH_AXES
                 if ax not in DATA_AXES and self.axis_sizes[ax] > 1]
        if later:
            raise NotImplementedError(
                f"mesh axes {later} > 1: pipeline, expert, sequence and "
                "tensor parallelism arrive with later parts of ROADMAP.md "
                "A13 (multi-GPU); this slice runs dp and fsdp")
        shape = tuple(self.axis_sizes[ax] for ax in MESH_AXES)
        self.mesh = np.asarray(devices, dtype=np.int64).reshape(shape)
        self._device_mesh = None
        self._groups: Dict[Tuple[str, ...], Any] = {}

    # -- factory --------------------------------------------------------

    @classmethod
    def from_config(cls, cfg: MeshConfig, devices: Optional[Sequence[int]] = None,
                    device_count: Optional[int] = None,
                    device_type: str = "cuda") -> "MeshTopology":
        """The reference's size resolution: ``dp`` / ``fsdp`` ``"auto"``
        take what the fixed axes leave of the world's ranks."""
        if devices is None:
            devices = _world_ranks()
        n = device_count if device_count is not None else len(devices)

        sizes: Dict[str, int] = {
            "pp": cfg.pipeline_parallel_size,
            "ep": cfg.expert_parallel_size,
            "sp": cfg.sequence_parallel_size,
            "tp": cfg.tensor_parallel_size,
        }
        fsdp = None if is_auto(cfg.fsdp_size) else int(cfg.fsdp_size)
        dp = None if is_auto(cfg.data_parallel_size) else int(cfg.data_parallel_size)

        fixed = math.prod(sizes.values())
        if n % fixed != 0:
            raise ConfigError(
                f"device count {n} not divisible by pp*ep*sp*tp={fixed}")
        remaining = n // fixed
        if dp is None and fsdp is None:
            dp, fsdp = remaining, 1
        elif dp is None:
            if remaining % fsdp != 0:
                raise ConfigError(f"{remaining} devices not divisible by fsdp={fsdp}")
            dp = remaining // fsdp
        elif fsdp is None:
            if remaining % dp != 0:
                raise ConfigError(f"{remaining} devices not divisible by dp={dp}")
            fsdp = remaining // dp
        if dp * fsdp != remaining:
            raise ConfigError(
                f"dp({dp})*fsdp({fsdp}) != remaining devices ({remaining})")
        sizes["dp"], sizes["fsdp"] = dp, fsdp
        return cls(sizes, devices=devices, dcn_axes=cfg.dcn_axes,
                   device_type=device_type)

    # -- accessors ------------------------------------------------------

    def size(self, axis: str) -> int:
        return self.axis_sizes[axis]

    @property
    def world_size(self) -> int:
        return math.prod(self.axis_sizes.values())

    @property
    def dp_world_size(self) -> int:
        """Replica count for batch-size math: dp × fsdp (both consume batch)."""
        return self.axis_sizes["dp"] * self.axis_sizes["fsdp"]

    @property
    def model_parallel_size(self) -> int:
        return self.axis_sizes["tp"] * self.axis_sizes["pp"]

    def active_axes(self) -> List[str]:
        return [ax for ax in MESH_AXES if self.axis_sizes[ax] > 1]

    def coord_of(self, device_index: int) -> Dict[str, int]:
        """Axis coordinates of the rank ``device_index`` (the reference
        looks a device id up in its mesh array; the port a rank)."""
        pos = np.argwhere(self.mesh == device_index)
        if pos.size == 0:
            raise ValueError(f"device id {device_index} not in mesh")
        return {ax: int(c) for ax, c in zip(MESH_AXES, pos[0])}

    def __repr__(self) -> str:
        active = {ax: s for ax, s in self.axis_sizes.items() if s > 1}
        return f"MeshTopology({active or {'dp': 1}}, world={self.world_size})"

    # -- process groups ----------------------------------------------------

    def normalize_axes(self, axis_name) -> Tuple[str, ...]:
        """An axis name or a tuple of them, checked, in mesh order."""
        axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
        for ax in axes:
            if ax not in MESH_AXES:
                raise ValueError(f"unknown mesh axis {ax!r}; valid: {MESH_AXES}")
        order = [MESH_AXES.index(ax) for ax in axes]
        if order != sorted(order) or len(set(order)) != len(order):
            raise ValueError(
                f"axes {axes} must be distinct and in mesh order {MESH_AXES}")
        return axes

    def axis_size(self, axis_name) -> int:
        return math.prod(self.size(ax) for ax in self.normalize_axes(axis_name))

    def group_ranks(self, axis_name, rank: int) -> List[int]:
        """The ranks of ``rank``'s group over ``axis_name``, ascending (the
        axes' row-major order)."""
        axes = self.normalize_axes(axis_name)
        coord = self.coord_of(rank)
        index = tuple(slice(None) if ax in axes else coord[ax]
                      for ax in MESH_AXES)
        return sorted(int(r) for r in self.mesh[index].reshape(-1))

    def axis_index(self, axis_name, rank: int) -> int:
        return self.group_ranks(axis_name, rank).index(rank)

    @property
    def device_mesh(self):
        """The ``DeviceMesh`` over the world's ranks, named by the mesh
        axes (built at first use; needs the process group)."""
        if self._device_mesh is None:
            import torch
            from torch.distributed.device_mesh import DeviceMesh

            self._device_mesh = DeviceMesh(
                self.device_type, torch.as_tensor(self.mesh),
                mesh_dim_names=MESH_AXES)
        return self._device_mesh

    def build_groups(self) -> None:
        """Create every process group this topology's collectives use:
        one per mesh axis (the ``DeviceMesh``'s) and one per set of two or
        more axes larger than 1.  Every rank must call it, in the same
        order (``new_group`` is collective)."""
        import torch.distributed as dist

        dm = self.device_mesh
        for ax in MESH_AXES:
            self._groups[(ax,)] = dm.get_group(ax)
        active = self.active_axes()
        rank = dist.get_rank()
        for k in range(2, len(active) + 1):
            for axes in itertools.combinations(active, k):
                if k == len(active) and self.world_size == dist.get_world_size():
                    self._groups[axes] = dist.group.WORLD
                    continue
                mine = None
                seen = set()
                for r in range(self.world_size):
                    ranks = tuple(self.group_ranks(axes, r))
                    if ranks in seen:
                        continue
                    seen.add(ranks)
                    g = dist.new_group(list(ranks))
                    if rank in ranks:
                        mine = g
                self._groups[axes] = mine

    def group(self, axis_name):
        """The process group of this rank over ``axis_name``: axes of size
        1 do not change the group, so they are dropped (all of them: the
        first axis's group, of one rank)."""
        axes = self.normalize_axes(axis_name)
        if not self._groups:
            self.build_groups()
        live = tuple(ax for ax in axes if self.size(ax) > 1)
        if len(live) <= 1:
            return self._groups[live or axes[:1]]
        return self._groups[live]


@dataclasses.dataclass(frozen=True)
class RuleTopology:
    """Axis sizes alone: what the sharding rules read (``size``).  The
    engine picks its shard dims on one of these where a world of one would
    shard nothing (``runtime/engine.py``)."""

    axis_sizes: Dict[str, int]

    def size(self, axis: str) -> int:
        return self.axis_sizes.get(axis, 1)


# ---------------------------------------------------------------------------
# global topology registry (reference: groups.py module-level group cache)
# ---------------------------------------------------------------------------

_TOPOLOGY: Optional[MeshTopology] = None


def set_topology(topo: MeshTopology) -> None:
    global _TOPOLOGY
    _TOPOLOGY = topo


def get_topology() -> MeshTopology:
    if _TOPOLOGY is None:
        raise RuntimeError(
            "mesh topology not initialized; call deepspeed_tpu_torch.initialize() "
            "or parallel.topology.set_topology() first")
    return _TOPOLOGY


def topology_initialized() -> bool:
    return _TOPOLOGY is not None


def reset_topology() -> None:
    global _TOPOLOGY
    _TOPOLOGY = None


# reference-parity getters (groups.py get_data_parallel_world_size etc.)

def get_data_parallel_world_size() -> int:
    return get_topology().dp_world_size


def get_model_parallel_world_size() -> int:
    return get_topology().size("tp")


def get_expert_parallel_world_size() -> int:
    return get_topology().size("ep")


def get_sequence_parallel_world_size() -> int:
    return get_topology().size("sp")


def get_pipeline_parallel_world_size() -> int:
    return get_topology().size("pp")
