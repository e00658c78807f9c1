"""Communication facade — the port of ``deepspeed_tpu/comm/comm.py``.

Two tiers, as in the reference:

* **process tier** — :func:`init_distributed` sets up the
  ``torch.distributed`` world (one process per GPU): from the torchrun
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
  ``MASTER_PORT``), from an ``init_method`` (``tcp://host:port``,
  ``file://...``) or, with neither, a world of one over an in-process
  store.  Its backend is NCCL for the card (``device="cuda"``, the
  default) and gloo only when the caller asks for the CPU; it never falls
  back from one to the other.  ``barrier`` and ``broadcast_host_value``
  act on that world.

* **device tier** — collectives by mesh-axis name, as the reference's take
  them inside ``shard_map`` (one name or a tuple): each runs eagerly over
  the process group of this rank's axes (``parallel/topology.py``) and has
  the ``lax`` primitive's semantics: ``all_reduce`` (``psum`` family),
  ``all_gather`` (tiled or stacked along ``axis``), ``reduce_scatter``
  (``psum_scatter``), ``all_to_all``, ``ppermute``.  ``all_reduce``
  reduces its input in place (and returns it): the engine hands it
  buffers of its own; the others return new tensors.

Every device-tier call reports to the :class:`CommsLogger` (op counts and
bytes per op and axis) when it is enabled (:func:`configure`).
"""

from __future__ import annotations

import datetime
import os
from enum import Enum
from typing import Any, Optional, Sequence, Union

import torch

from ..utils.logging import logger
from .comms_logger import CommsLogger

_comms_logger = CommsLogger()


class ReduceOp(Enum):
    SUM = "sum"
    AVG = "avg"
    MAX = "max"
    MIN = "min"
    PROD = "prod"


# ---------------------------------------------------------------------------
# process tier
# ---------------------------------------------------------------------------


def init_distributed(dist_backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     device: Any = "cuda",
                     timeout: Optional[int] = None,
                     verbose: bool = True) -> None:
    """Set up the process group (reference: ``comm/comm.py:50``).

    ``world_size`` / ``rank`` default to ``$WORLD_SIZE`` / ``$RANK``; with
    an ``init_method`` they are required, without one and without
    ``$WORLD_SIZE`` the world is this process alone.  On the card each
    process takes ``cuda:$LOCAL_RANK``.  A second call does nothing."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    from ..accelerator import resolve_device

    dev = resolve_device(device)
    backend = dist_backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        dev = torch.device("cuda", get_local_rank())
        torch.cuda.set_device(dev)
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    if init_method is not None:
        if world_size is None or rank is None:
            raise ValueError("init_method needs world_size and rank "
                             "(arguments, or $WORLD_SIZE and $RANK)")
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank, **kw)
    elif world_size is not None:
        # torchrun: MASTER_ADDR / MASTER_PORT name the rendezvous
        dist.init_process_group(backend, init_method="env://",
                                world_size=world_size,
                                rank=0 if rank is None else rank, **kw)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    if verbose:
        logger.info(f"torch.distributed initialized: rank {dist.get_rank()}"
                    f"/{dist.get_world_size()}, backend {backend}, "
                    f"device {dev}")


def is_initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    """This process's rank: one process per device, as in the reference
    (whose JAX processes are per host, so its ranks count hosts)."""
    import torch.distributed as dist

    return dist.get_rank() if is_initialized() else 0


def get_world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if is_initialized() else 1


def get_global_device_count() -> int:
    return get_world_size()


def get_local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def get_local_world_size() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", get_world_size()))


def barrier(name: str = "barrier") -> None:
    import torch.distributed as dist

    if is_initialized():
        dist.barrier()


def broadcast_host_value(value: Any, is_source: Optional[bool] = None) -> Any:
    """Rank 0's ``value`` (any picklable object) on every rank."""
    import torch.distributed as dist

    if get_world_size() == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


# ---------------------------------------------------------------------------
# device tier — named-axis collectives
# ---------------------------------------------------------------------------

AxisName = Union[str, Sequence[str]]


def _log(op: str, x, axis: AxisName) -> None:
    if _comms_logger.enabled:
        _comms_logger.record(op, x, axis)


def _topo(topo):
    if topo is not None:
        return topo
    from ..parallel.topology import get_topology

    return get_topology()


def get_group(axis_name: AxisName, topo=None):
    """The process group of this rank over ``axis_name``."""
    if not is_initialized():
        raise RuntimeError("no process group: call "
                           "deepspeed_tpu_torch.comm.init_distributed() first")
    return _topo(topo).group(axis_name)


def _single(name: str):
    """``torch.distributed``'s one-tensor gather / scatter: ``*_single``
    where the installed torch has it, else its older ``*_tensor`` name."""
    import torch.distributed as dist

    old = {"all_gather": "all_gather_into_tensor",
           "reduce_scatter": "reduce_scatter_tensor"}[name]
    return getattr(dist, f"{name}_single", None) or getattr(dist, old)


_TORCH_OPS = {ReduceOp.SUM: "SUM", ReduceOp.AVG: "SUM", ReduceOp.MAX: "MAX",
              ReduceOp.MIN: "MIN", ReduceOp.PROD: "PRODUCT"}


def all_reduce(x: torch.Tensor, axis_name: AxisName,
               op: ReduceOp = ReduceOp.SUM, topo=None) -> torch.Tensor:
    """Reference: ``comm/comm.py:188`` (``lax.psum`` / ``pmax`` / ``pmin``;
    AVG divides the sum).  Reduces ``x`` in place and returns it."""
    import torch.distributed as dist

    _log("all_reduce", x, axis_name)
    if op not in _TORCH_OPS:
        raise ValueError(f"unsupported reduce op {op}")
    dist.all_reduce(x, op=getattr(dist.ReduceOp, _TORCH_OPS[op]),
                    group=get_group(axis_name, topo))
    if op == ReduceOp.AVG:
        x.div_(axis_size(axis_name, topo))
    return x


def all_gather(x: torch.Tensor, axis_name: AxisName, axis: int = 0,
               tiled: bool = True, topo=None) -> torch.Tensor:
    """Reference: ``comm/comm.py:212`` (``lax.all_gather``): the shards
    concatenated along ``axis`` (``tiled``) or stacked on a new ``axis``."""
    import torch.distributed as dist

    _log("all_gather", x, axis_name)
    n = axis_size(axis_name, topo)
    # the concatenated form along dim 0 (gloo takes no other), viewed as
    # (n, *x.shape)
    flat = x.contiguous().reshape((-1,) + tuple(x.shape[1:]))
    out = torch.empty((n * flat.shape[0],) + tuple(flat.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _single("all_gather")(out, flat, group=get_group(axis_name, topo))
    out = out.reshape((n,) + tuple(x.shape))
    if not tiled:
        return out.movedim(0, axis)
    if axis == 0:
        return out.reshape((n * x.shape[0],) + tuple(x.shape[1:]))
    return torch.cat(out.unbind(0), dim=axis)


def reduce_scatter(x: torch.Tensor, axis_name: AxisName,
                   scatter_axis: int = 0, tiled: bool = True,
                   topo=None) -> torch.Tensor:
    """Reference: ``comm/comm.py:220`` (``lax.psum_scatter``): the sum over
    the group, of which this rank keeps its slice of ``scatter_axis``
    (``tiled``; untiled, that dim has the group's size and is dropped)."""
    import torch.distributed as dist

    _log("reduce_scatter", x, axis_name)
    n = axis_size(axis_name, topo)
    xm = x.movedim(scatter_axis, 0).contiguous()
    if xm.shape[0] % n:
        raise ValueError(f"dim {scatter_axis} of {tuple(x.shape)} not "
                         f"divisible by the group's {n} ranks")
    out = torch.empty((xm.shape[0] // n,) + tuple(xm.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _single("reduce_scatter")(out, xm, op=dist.ReduceOp.SUM,
                              group=get_group(axis_name, topo))
    if not tiled:
        if xm.shape[0] != n:
            raise ValueError(f"untiled reduce_scatter wants dim "
                             f"{scatter_axis} of size {n}")
        return out[0]
    return out.movedim(0, scatter_axis)


def all_to_all(x: torch.Tensor, axis_name: AxisName, split_axis: int,
               concat_axis: int, tiled: bool = True,
               topo=None) -> torch.Tensor:
    """Reference: ``comm/comm.py:228`` (``lax.all_to_all``): chunk j of
    ``split_axis`` goes to rank j; what arrives from rank i is chunk i of
    ``concat_axis`` (tiled), or stacked there (untiled: ``split_axis`` has
    the group's size and is dropped)."""
    import torch.distributed as dist

    _log("all_to_all", x, axis_name)
    n = axis_size(axis_name, topo)
    xm = x.movedim(split_axis, 0).contiguous()
    if xm.shape[0] % n:
        raise ValueError(f"dim {split_axis} of {tuple(x.shape)} not "
                         f"divisible by the group's {n} ranks")
    out = torch.empty_like(xm)
    dist.all_to_all_single(out, xm, group=get_group(axis_name, topo))
    chunks = out.reshape((n, xm.shape[0] // n) + tuple(xm.shape[1:]))
    chunks = chunks.movedim(1, split_axis + 1)  # (n, *chunk in x's order)
    if not tiled:
        if xm.shape[0] != n:
            raise ValueError(f"untiled all_to_all wants dim {split_axis} "
                             f"of size {n}")
        return chunks.squeeze(split_axis + 1).movedim(0, concat_axis)
    return torch.cat(chunks.unbind(0), dim=concat_axis)


def ppermute(x: torch.Tensor, axis_name: AxisName, perm: Sequence,
             topo=None) -> torch.Tensor:
    """Reference: ``comm/comm.py:238`` (``lax.ppermute``): ``perm`` lists
    (source, destination) axis indices; a rank no one sends to gets
    zeros."""
    import torch.distributed as dist

    _log("ppermute", x, axis_name)
    t = _topo(topo)
    me = dist.get_rank()
    ranks = t.group_ranks(axis_name, me)
    k = ranks.index(me)
    perm = [(int(s), int(d)) for s, d in perm]
    out = torch.zeros_like(x)
    xc = x.contiguous()
    ops = []
    group = get_group(axis_name, t)
    for s, d in perm:
        if s == k and d == k:
            out.copy_(xc)
        elif s == k:
            ops.append(dist.P2POp(dist.isend, xc, ranks[d], group))
        elif d == k:
            ops.append(dist.P2POp(dist.irecv, out, ranks[s], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def axis_index(axis_name: AxisName, topo=None) -> int:
    """This rank's index along ``axis_name`` (row-major over a tuple)."""
    return _topo(topo).axis_index(axis_name, get_rank())


def axis_size(axis_name: AxisName, topo=None) -> int:
    return _topo(topo).axis_size(axis_name)


# ---------------------------------------------------------------------------
# comms logging (reference: comm/comm.py configure/log_summary)
# ---------------------------------------------------------------------------


def configure(enabled: Optional[bool] = None, verbose: Optional[bool] = None,
              prof_all: Optional[bool] = None,
              prof_ops: Optional[Sequence[str]] = None) -> None:
    _comms_logger.configure(enabled=enabled, verbose=verbose, prof_all=prof_all,
                            prof_ops=prof_ops)


def get_comms_logger() -> CommsLogger:
    return _comms_logger


def log_summary() -> str:
    return _comms_logger.log_summary()
