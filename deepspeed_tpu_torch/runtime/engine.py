"""The training engine — the port of ``deepspeed_tpu/runtime/engine.py``.

One ``train_batch`` runs the reference's step (``engine.py:775-844``,
``:1039-1143``) eagerly: for each of the ``gas`` micro-batches, the loss
(times the loss scale under fp16) and its gradients (cast to f32 and
summed), then the mean over ``gas``, the unscale (fp16), the finite check
(fp16), the global norm of those f32 gradients, optional clipping
(``gradient_clipping``) and the optimizer's update with the lr
``schedule(step - skipped)``.  Parameters stay in their own dtype (the
model's ``param_dtype``); optimizer state is f32.  The update runs in
place: the engine owns copies of the caller's parameters (``engine.params``)
and keeps no reference to the caller's tensors, which never change.

fp16 (``fp16.enabled``; the model's compute dtype is ``float16``, its
master weights ``param_dtype``): the loss scale, the optimizer's count and
the skipped-step count live on the device (``runtime/loss_scaler.py``), so
an overflowed step is skipped without a host sync: the optimizer keeps
each leaf's old parameters and state where the gradients were not finite
(``torch.where``), the scale follows the reference's state machine, and
``skipped_steps`` grows, so that the lr schedule reads ``step - skipped``.

``train_batch`` returns :class:`LazyMetrics` — ``loss``, ``accuracy``,
``tokens``, ``grad_norm``, ``loss_scale`` (the scale this step ran
under), ``lr``, ``overflow`` (1.0 on a skipped step) — which stay on the
device until first read, so a training loop that does not read them never
waits for the card.  ``sanity_checks`` reads them every step and raises on
a non-finite loss or grad norm unless the step overflowed (one device: no
replicas to compare).  ``save_checkpoint`` / ``load_checkpoint`` write and
read the reference's layout (``runtime/checkpoint/engine.py``).

ZeRO-Offload / ZeRO-Infinity (``zero_optimization.offload_optimizer`` /
``offload_param``, the reference's ``engine.py:254-298``, ``:1154-1269``):
the card runs the forward, the backward and the f32 accumulation over
``gas`` and the gradient norm (``_grad_step``); the f32 master and the
optimizer's update live on the host (``runtime/zero/offload.py``, an NVMe
tier behind it), and the updated parameters are copied back.  With
``offload_param`` the stacked layer leaves live in host memory and stream
to the card one layer at a time (``runtime/zero/param_offload.py``).
``delayed_update`` applies step N-1's update on the host while the card
runs step N (the parameters are written back behind step N's work on the
compute stream); ``zenflow`` updates the top-k columns on the card and
flushes the rest through the host optimizer (``runtime/zenflow.py``).
``offload_states`` / ``reload_states`` evict the optimizer state or the
parameters to host memory between phases (the reference's
``engine.py:1641-1730``).

PEFT (``peft.lora``, the reference's ``engine.py:171-237``): the
targeted projections become ``linear/optimized_linear.LoRAWeight`` nodes
(drawn from ``config.seed``, unless the tree has them already), with a
dense or quantized frozen base; only ``lora_a`` / ``lora_b`` take
gradients, optimizer state and checkpoint space (``peft_enabled``, an
adapter-only ``adapter_model.safetensors``), and
:meth:`TrainingEngine.export_merged_weights` folds them into the base for
serving.  Embeddings, norms and bases are copied once and never change.

Data parallelism and ZeRO stages 1-3 (ROADMAP.md A13 part 1; the
reference's ``engine.py:139-161``, ``:217-430``, ``:689-1143``): one
process per GPU under ``torch.distributed`` (``comm.init_distributed``),
the mesh's ``dp`` × ``fsdp`` ranks each taking its rows of every
micro-batch.  The engine builds the reference's topology (MiCS, stage 3's
dp → fsdp fold), the parameter and optimizer sharding rules
(``runtime/zero/sharding.py``) and the bucket plans
(``runtime/coalesce.py``), and issues each collective itself
(``_train_batch_dp``): stage 1 all-reduces the gradients by bucket and
all-gathers each rank's updated optimizer shard; stage 2 reduce-scatters
them onto those shards; stage 3 holds every parameter as a shard and
gathers a layer segment where the model uses it (``runtime/zero/
stage3.py``); qgZ, 1-bit (``gradient_compression``) and qwZ compress the
traffic.  The metrics, the gradient norm's sum of squares and the fp16
overflow count ride one all-reduce, so every rank skips together.
Collectives are the same calls at a world of one as at a world of N:
where the stage's axes hold one rank, the shard dims are those a two-way
axis would give (``_layout_topology``; ROADMAP.md C11); qwZ reads the real
fsdp axis, so a world of one gathers unquantized leaves, as the
reference's ``qwz_gather_leaf`` does.  At stage 3, and in any offloaded
step, the reference evaluates the loss on the global batch: each rank
weighs its loss by its share of the world's tokens (one all-reduce of each
micro-batch's count, ``_global_weight``), so the averaged gradients and
metrics are the global token mean's (ROADMAP.md C10).  PEFT's LoRA nodes
run at every stage: at stage 3 the frozen bases are gathered per layer
beside the factors, outside autograd.

Offload on a data-parallel world (ROADMAP.md A13 part 2; the reference's
``engine.py:254-298``, ``:1155-1262``): the step above through the
bucketed reduction, then each rank's gradient partition to its host, the
host update of that partition (``_offloaded_update``) and the updated
partition back — all-gathered by bucket at stages 1-2, the resident shard
itself at stage 3.  A rank's host holds its partition alone (``_parts``:
the optimizer shard at stages 1-2, the parameter shard at stage 3).  With
``offload_param`` at stage 3 (ZeRO-Infinity) the streamed leaves' shards
live in page-locked host memory, stream to the card inside the stage-3
gathers, and their gradients land in the host buffers.  ``delayed_update``
and ZenFlow run over the partitions as they do at stage 0.
"""

from __future__ import annotations

import collections.abc
import contextlib
import dataclasses
import logging
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import comm
from ..accelerator import get_accelerator, resolve_device
from ..linear.optimized_linear import apply_lora, has_lora, trainable_mask
from ..parallel.topology import MeshTopology, RuleTopology, set_topology
from ..utils.logging import log_dist
from ..utils.tree_io import tree_map
from .config import (DeepSpeedTPUConfig, OffloadOptimizerConfig,
                     ResolvedBatchConfig)
from .config_utils import ConfigError
from .loss_scaler import (LossScaleState, grads_finite, init_loss_scale,
                          scale_loss, unscale_grads, update_loss_scale)
from .lr_schedules import create_scheduler
from .optimizers import (clip_by_global_norm, create_optimizer,
                         default_weight_decay_mask, global_norm, leaf_paths,
                         leaves)
from .zero.sharding import (rules_for_optimizer, rules_for_params,
                            shard_accounting, sharding_for_tree)

#: the axes of the data-parallel world (batch and optimizer shards)
DP_AXES = ("dp", "fsdp")

logger = logging.getLogger(__name__)

#: optimizers whose update reads whole-leaf statistics (LAMB's trust
#: ratio, Adafactor's factored moments, Muon's orthogonalization)
_WHOLE_LEAF_OPTIMIZERS = ("lamb", "fusedlamb", "adafactor", "muon")

LossFn = Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


class LazyMetrics(collections.abc.Mapping):
    """Per-step metrics whose device-to-host copy waits for the first read;
    a read copies them all at once (one sync) as plain floats.  A Mapping,
    not a dict: ``dict(m)`` and ``{**m}`` read through it."""

    def __init__(self, device_metrics: Dict[str, torch.Tensor]):
        self._dev: Optional[Dict[str, torch.Tensor]] = device_metrics
        self._host: Dict[str, float] = {}

    def _materialize(self) -> Dict[str, float]:
        if self._dev is not None:
            keys = list(self._dev)
            vals = torch.stack([self._dev[k].detach().float().reshape(())
                                for k in keys]).tolist()
            self._host = dict(zip(keys, vals))
            self._dev = None
        return self._host

    def __getitem__(self, k):
        return self._materialize()[k]

    def __iter__(self):
        return iter(self._materialize())

    def __len__(self):
        return len(self._materialize())

    def __repr__(self):
        return repr(self._materialize())

    def __reduce__(self):  # pickle as a plain dict
        return (dict, (self._materialize(),))


@dataclasses.dataclass
class ModelSpec:
    """What the engine needs from a model.

    ``loss_fn(params, batch, rng) -> (loss, metrics)`` with MEAN semantics
    over the batch; ``params`` a nested dict of tensors; ``rng`` is a
    ``torch.Generator`` on the engine's device, seeded per step.
    ``param_axes`` is accepted for the reference's signature and unused on
    one device."""

    loss_fn: LossFn
    params: Any
    param_axes: Any = None
    eval_fn: Optional[LossFn] = None
    flops_per_token: Optional[float] = None


@dataclasses.dataclass
class PlacedBatch:
    """A batch already reshaped to ``(gas, micro, ...)`` on the device."""

    placed: Dict[str, torch.Tensor]


class TrainingEngine:
    """Reference: ``DeepSpeedEngine`` / the JAX package's
    ``TrainingEngine``: one per process, on its GPU (or the CPU when
    asked), over the data-parallel world's ``topo`` (default: the config's
    mesh over the ``torch.distributed`` world, or this process alone)."""

    def __init__(self, model: ModelSpec, config: DeepSpeedTPUConfig,
                 device: Any = "cuda", topo: Optional[MeshTopology] = None):
        config.check_supported()
        self.config = config
        self.device = resolve_device(device)
        self.accelerator = get_accelerator()
        zero = config.zero_optimization
        stage = self.zero_stage = zero.stage

        # topology (reference engine.py:139-161): MiCS shards parameters
        # within groups of mics_shard_size; stage 3 folds dp into fsdp
        self.topo = topo if topo is not None else self._build_topology()
        set_topology(self.topo)
        W = self.topo.dp_world_size
        self.batch_config: ResolvedBatchConfig = \
            config.resolve_batch_config(W)

        # PEFT (reference engine.py:171-215): the targeted projections
        # become LoRA nodes, drawn from the config's seed, unless the tree
        # has them already; only their factors train
        params, axes = model.params, model.param_axes
        lora_cfg = config.peft.lora
        if lora_cfg.enabled and not has_lora(params):
            gen = torch.Generator(device=leaves(params)[0].device)
            params, axes = apply_lora(params, axes,
                                      gen.manual_seed(config.seed), lora_cfg)
        self.peft_enabled = has_lora(params)
        if self.peft_enabled:
            config.check_peft()
        self._trainable_mask = trainable_mask(params) if self.peft_enabled \
            else None
        flat_in = leaves(params)
        trainable = leaves(self._trainable_mask) if self.peft_enabled \
            else [True] * len(flat_in)

        # offload mode: parameters off the card imply the host optimizer
        self.param_offload_enabled = config.param_offloaded
        self.offload_enabled = (config.optimizer_offloaded
                                or self.param_offload_enabled)
        self.offloaded_optimizer = None
        self.zenflow_optimizer = None
        self._streamer = None
        self._sink = None  # stage 3's streamed gradients to the host
        # stage 3, offloaded: the gradients go to the host buffers in the
        # backward — except under ZenFlow, whose hot update, selection and
        # cold sums run on the card (so its gradients stay there)
        self._host_grads = (stage >= 3 and self.offload_enabled
                            and not config.zenflow.enabled)
        self._delayed_update = False
        self._pending = False  # a delayed update's gradients are staged
        self._pending_lr: Optional[float] = None
        self._offloaded_states: Dict[str, bool] = {}
        self._host = None
        stream_mask = None

        # the data-parallel step (explicit collectives): every ZeRO stage
        # >= 1, any world of more than one rank, and the wire-compression
        # schemes; stage 0 alone on one device keeps the plain step
        self.qgz = bool(zero.zero_quantized_gradients)
        self.qwz = bool(zero.zero_quantized_weights)
        self.onebit_enabled = bool(config.gradient_compression.enabled)
        self._dp = stage >= 1 or W > 1 or self.qgz or self.onebit_enabled
        if self._dp and not comm.is_initialized():
            raise RuntimeError(
                f"zero_optimization.stage={stage} on a data-parallel world "
                f"of {W} runs under torch.distributed: call "
                "deepspeed_tpu_torch.comm.init_distributed() first "
                "(deepspeed_tpu_torch.initialize does)")
        if self._dp and self.param_offload_enabled and stage < 3:
            raise NotImplementedError(
                f"offload_param at zero_optimization.stage={stage} on a "
                "data-parallel world (whole layers in every rank's host "
                "memory) arrives with a later part of ROADMAP.md A13 "
                "(multi-GPU); ZeRO-Infinity streams stage 3's shards")
        if self._dp and W > 1 and config.optimizer.type.lower().replace(
                "_", "") in _WHOLE_LEAF_OPTIMIZERS:
            raise NotImplementedError(
                f"optimizer {config.optimizer.type!r} reads whole-leaf "
                "statistics (norms, factored moments) that a sharded leaf "
                "would need collectives for; it arrives at ZeRO stages 1-3 "
                "with a later part of ROADMAP.md A13 (multi-GPU)")
        if self.offload_enabled:
            from .zero.param_offload import (HostArena, offload_mask,
                                             resolve_threshold)

            self._host = HostArena(self.device)
            if self.param_offload_enabled:
                stream_mask = leaves(offload_mask(
                    params, min_numel=resolve_threshold(
                        zero.stage3_param_persistence_threshold)))

        # sharding rules (reference engine.py:217-236): the parameters'
        # and the optimizer state's specs from the logical axes
        topo = self.topo
        self.param_rules = rules_for_params(stage, topo)
        self.opt_rules = rules_for_optimizer(stage, topo)
        self.param_shardings = sharding_for_tree(params, axes,
                                                 self.param_rules, topo)
        self.opt_param_shardings = sharding_for_tree(params, axes,
                                                     self.opt_rules, topo)
        self._full_shapes = [tuple(p.shape) for p in flat_in]
        self._init_layouts(params, axes, flat_in, trainable)
        #: the all-leaf index of each trainable leaf
        self._train_idx = [j for j, t in enumerate(trainable) if t]
        # C10: the losses the reference evaluates on the global batch
        self._global_loss = self._dp and W > 1 and (
            stage >= 3 or self.offload_enabled)

        # the engine owns its parameters: fresh copies on its device (the
        # streamed layer leaves in host memory, in their own dtype; at
        # stage 3 this rank's shard of each); a frozen leaf is copied once
        # and takes no gradient
        streamed = stream_mask or [False] * len(flat_in)
        s3 = stage >= 3

        def own_copy(j, p, s, t):
            if s3 and self._p_dims[j] is not None:
                p = self._local(p, self._p_dims[j], self._p_n)
            if s:
                return self._host.copy_of(p)
            return p.detach().to(self.device, copy=True).contiguous() \
                .requires_grad_(t and not s3)

        own = iter([own_copy(j, p, s, t) for j, (p, s, t) in
                    enumerate(zip(flat_in, streamed, trainable))])
        self.params = tree_map(lambda p: next(own), params)
        del params, flat_in
        self._all_leaves: List[torch.Tensor] = leaves(self.params)
        self._all_paths: List[str] = leaf_paths(self.params)
        # the leaves that train: gradients, optimizer state and checkpoints
        # cover these (under PEFT the LoRA factors alone)
        self._leaves: List[torch.Tensor] = [
            p for p, t in zip(self._all_leaves, trainable) if t]
        self._paths: List[str] = [
            p for p, t in zip(self._all_paths, trainable) if t]
        self._streamed = [j for j, s in enumerate(streamed) if s]
        # keep the spec without the caller's tensors, so that a caller who
        # drops them frees their memory (an 8B model's 4.5 GB on the card)
        self.model = dataclasses.replace(model, params=None, param_axes=axes)

        base_lr = config.optimizer.params.get("lr", 1e-3)
        self.lr_schedule = create_scheduler(config.scheduler, base_lr=base_lr)
        wd_mask = None
        if config.optimizer.params.get("weight_decay", 0.0):
            # over the trainable leaves only (reference: the mask of the
            # trainable template)
            wd_mask = [m for m, t in zip(
                leaves(default_weight_decay_mask(self.params)), trainable)
                if t]
        self.optimizer = create_optimizer(
            config.optimizer, self.lr_schedule, wd_mask,
            wire_compression=self.onebit_enabled)
        if self._dp:
            self._init_data_parallel(init_optimizer=not self.offload_enabled)
        if self.offload_enabled:
            self._init_offload(wd_mask)
        elif not self._dp:
            self.optimizer.init(self._leaves)
        self.step_count = 0
        self.global_steps = 0
        self.fp16_enabled = config.fp16.enabled is True
        fp = config.fp16
        if self.fp16_enabled:
            self.loss_scale: LossScaleState = init_loss_scale(
                fp.initial_scale_power, fp.hysteresis, fp.loss_scale,
                device=self.device)
            # the count of applied updates and of skipped steps stay on the
            # device: an overflow is decided there, without a host sync
            self.optimizer.count_on_device(self.device)
            self.skipped_steps: Any = torch.zeros((), dtype=torch.int32,
                                                  device=self.device)
        else:
            self.loss_scale = init_loss_scale(static_scale=1.0,
                                              device=self.device)
            self.skipped_steps = 0
        log_dist(f"engine ready: zero_stage={stage} topo={topo} "
                 f"batch={self.train_batch_size} "
                 f"micro={self.train_micro_batch_size_per_device} "
                 f"gas={self.gradient_accumulation_steps} "
                 f"dtype={config.compute_dtype} device={self.device}")
        if stage >= 3:
            rep = self.shard_report()
            log_dist(
                f"ZeRO-3 shard accounting: {rep['sharded_fraction']:.1%} of "
                f"{rep['total_bytes'] / 2**20:.1f} MiB param bytes removed "
                f"per device ({rep['per_device_bytes'] / 2**20:.1f} MiB local)")
            fsdp_n = topo.size("fsdp")
            expected = 1.0 - 1.0 / max(fsdp_n, 1)
            if fsdp_n > 1 and rep["sharded_fraction"] < 0.5 * expected:
                logger.warning(
                    "ZeRO-3 is sharding only %.1f%% of param bytes (expected "
                    "~%.1f%% at fsdp=%d) — large replicated leaves: %s. "
                    "Check logical-axes annotations / dim divisibility.",
                    100 * rep["sharded_fraction"], 100 * expected, fsdp_n,
                    rep["replicated_leaves"][:5])

    # ------------------------------------------------------------------
    # data parallelism: topology, layouts, plans
    # ------------------------------------------------------------------

    def _build_topology(self) -> MeshTopology:
        """The reference's mesh resolution with its ZeRO folds (MiCS:
        fsdp = mics_shard_size; stage 3: dp folded into fsdp)."""
        from .config import MeshConfig

        config = self.config
        mesh_cfg = config.mesh
        zero = config.zero_optimization
        mics = zero.mics_shard_size
        if zero.stage >= 3 and mics > 0:
            mesh_cfg = dataclasses.replace(
                mesh_cfg, fsdp_size=mics, data_parallel_size="auto")
        elif zero.stage >= 3:
            from .config_utils import is_auto

            if is_auto(mesh_cfg.fsdp_size) or int(mesh_cfg.fsdp_size) == 1:
                mesh_cfg = dataclasses.replace(
                    mesh_cfg, fsdp_size="auto", data_parallel_size=1)
        assert isinstance(mesh_cfg, MeshConfig)
        return MeshTopology.from_config(mesh_cfg,
                                        device_type=self.device.type)

    def _layout_topology(self, axes: Sequence[str]):
        """The topology the shard dims are read from: the real one, or —
        where the axes a stage shards over hold one rank — one whose fsdp
        axis has two, so that a world of one holds (whole) shards on the
        same dims as a world of two and runs the stage's collectives over
        groups of one."""
        topo = self.topo
        if topo.axis_size(tuple(axes)) > 1:
            return topo
        return RuleTopology({**topo.axis_sizes, "fsdp": 2})

    def _init_layouts(self, params, axes, flat_in, trainable) -> None:
        """Each leaf's shard dim: ``_p_dims`` (all leaves; stage 3: the dim
        split over ``fsdp`` into ``_p_n`` shards) and ``_o_dims``
        (trainable leaves; stages 1-2: the dim of the optimizer state split
        over the data-parallel world into ``_o_n``)."""
        from .coalesce import shard_dims_for
        from .zero.qwz import _fsdp_dim

        stage = self.zero_stage
        n_all = len(flat_in)
        self._p_dims: List[Optional[int]] = [None] * n_all
        self._o_dims: List[Optional[int]] = [None] * sum(trainable)
        self._p_n = self.topo.size("fsdp")
        self._o_n = self.topo.dp_world_size
        if not self._dp:
            return
        paths = leaf_paths(params)
        if stage >= 3:
            lt = self._layout_topology(("fsdp",))
            specs = leaves(sharding_for_tree(params, axes, self.param_rules,
                                             lt))
            for j, sh in enumerate(specs):
                d = _fsdp_dim(sh.spec)
                # a stacked layer leaf is gathered a layer at a time: one
                # split on its layers axis stays whole (replicated)
                if d < 0 or (d == 0 and paths[j].startswith("layers/")):
                    continue
                self._p_dims[j] = d
        elif stage >= 1:
            lt = self._layout_topology(DP_AXES)
            sh = [s for s, t in zip(leaves(sharding_for_tree(
                params, axes, self.opt_rules, lt)), trainable) if t]
            shapes = [p for p, t in zip(flat_in, trainable) if t]
            self._o_dims = shard_dims_for(
                shapes, sh, DP_AXES, {ax: lt.size(ax) for ax in DP_AXES})

    def _local(self, x: torch.Tensor, d: Optional[int], n: int,
               axes=("fsdp",)) -> torch.Tensor:
        """This rank's slice (its index on ``axes``) of the whole ``x``
        along ``d`` (a view)."""
        if d is None:
            return x
        k = comm.axis_index(axes, topo=self.topo)
        size = x.shape[d] // n
        return x.narrow(d, k * size, size)

    def _init_data_parallel(self, init_optimizer: bool = True) -> None:
        """The optimizer over this rank's shards (unless the host's holds
        them), the gradient bucket plans (reference engine.py:355-401),
        the parameter gather plan (:403-430), the stage-3 gatherer and the
        1-bit residuals."""
        from .coalesce import (plan_buckets, resolve_allgather_numel,
                               resolve_bucket_numel)

        zero = self.config.zero_optimization
        W = self.topo.dp_world_size
        cap = resolve_bucket_numel(zero)
        self.reduce_bucket_numel = cap
        cap = cap if cap > 0 else 1  # 0: one collective per leaf
        meta = torch.device("meta")
        self._bucket_plan = self._wire_plan = self._gather_plan = None
        self._gatherer = None
        if self.zero_stage >= 3:
            from .zero.stage3 import ShardGatherer

            # the f32 gradient buffers lie in the buckets of two plans,
            # each bucket one contiguous tensor reduced in place after the
            # backward: the shards' over dp (they were reduce-scattered
            # over fsdp in backward), the replicated leaves' over the
            # world; offloaded (ZenFlow aside), the buffers are the host's
            # (``_init_offload``)
            bufs: List[Optional[torch.Tensor]] = [None] * len(self._leaves)
            tdims = self._tp_dims
            self._s3_buckets = []
            for axes, whole in (("dp", False), (DP_AXES, True)):
                idx = [j for j, d in enumerate(tdims)
                       if (d is None) == whole and not self._host_grads]
                plan = plan_buckets([torch.empty(self._leaves[j].shape,
                                                 device=meta) for j in idx],
                                    cap)
                for b in plan.buckets:
                    flat = torch.zeros(b.numel, dtype=torch.float32,
                                       device=self.device)
                    self._s3_buckets.append((axes, flat))
                    for slot in b.slots:
                        bufs[idx[slot.leaf]] = flat[
                            slot.offset:slot.offset + slot.size].view(
                                slot.shape)
            self._grad_bufs = bufs
            # over every leaf: a frozen one (None) is gathered, not trained
            grads: List[Optional[torch.Tensor]] = [None] * len(
                self._all_leaves)
            for j, b in zip(self._train_idx, bufs):
                grads[j] = b
            # qwZ reads the real fsdp axis: over one rank the reference
            # gathers the leaves unchanged (ROADMAP.md C11)
            self._gatherer = ShardGatherer(
                self._all_leaves, self._p_dims, self._full_shapes, grads,
                [p.startswith("layers/") for p in self._all_paths],
                self._p_n, "fsdp", self.topo,
                qwz=self.qwz and self.topo.size("fsdp") > 1,
                device=self.device)
            if init_optimizer:
                self.optimizer.init(self._leaves)
            return
        grad_shapes = [torch.empty(p.shape, device=meta)
                       for p in self._leaves]
        shard_dims = self._o_dims if self.zero_stage >= 2 else None
        self._bucket_plan = plan_buckets(grad_shapes, cap, world=W,
                                         shard_dims=shard_dims)
        self._wire_plan = plan_buckets(grad_shapes, cap)
        st = self._bucket_plan.stats()
        log_dist(
            f"gradient coalescing: {st['num_leaves']} leaves -> "
            f"{st['num_buckets']} bucket(s) "
            f"({st['scatter_buckets']} reduce-scatter), cap="
            f"{self.reduce_bucket_numel} elements")
        # the optimizer updates this rank's slice of each sharded leaf (a
        # view of the replicated parameter); the gather plan puts the
        # updated slices back together
        self._bind_opt_params()
        if init_optimizer:
            self.optimizer.init(self._opt_params)
        gather_numel = resolve_allgather_numel(zero)
        if self.zero_stage in (1, 2):
            gp = plan_buckets(
                [torch.empty(p.shape, dtype=p.dtype, device=meta)
                 for p in self._leaves], gather_numel if gather_numel > 0
                else 1, world=W, shard_dims=self._o_dims)
            if any(b.scatter for b in gp.buckets):
                self._gather_plan = gp
                gst = gp.stats()
                log_dist(
                    f"param-gather coalescing: {gst['num_leaves']} leaves -> "
                    f"{gst['scatter_buckets']} fused all-gather bucket(s), "
                    f"cap={gather_numel} elements")
        if self.onebit_enabled:
            self._init_onebit()

    def _bind_opt_params(self) -> None:
        """Stages 0-2 on a data-parallel world: this rank's slice of each
        trainable leaf, a view (bound again when the leaves move)."""
        self._opt_params = [self._local(p, d, self._o_n, axes=DP_AXES)
                            for p, d in zip(self._leaves, self._o_dims)]

    @property
    def _tp_dims(self) -> List[Optional[int]]:
        """Stage 3: the shard dim of each trainable leaf."""
        return [self._p_dims[j] for j in self._train_idx]

    @property
    def _parts(self) -> List[torch.Tensor]:
        """This rank's partition of each trainable leaf — what its
        optimizer (on the card or the host) updates: a slice of the leaf
        at stages 0-2 on a data-parallel world, the shard at stage 3, the
        leaf alone."""
        if self._dp and self.zero_stage < 3:
            return self._opt_params
        return self._leaves

    def _part_weights(self) -> List[float]:
        """Each partition's weight in the world's sum of squares: 1 over
        the ranks that hold the same values."""
        W = self.topo.dp_world_size
        return [(n if d is not None else 1) / W for d, n, _ in
                map(self._state_layout, range(len(self._leaves)))]

    def _part_norm(self, tensors: List[torch.Tensor]) -> torch.Tensor:
        """The global norm of per-partition tensors (aligned with
        :attr:`_parts`, on the card or the host): one all-reduce of the
        weighted sum of squares."""
        sq = torch.zeros(1, dtype=torch.float32, device=self.device)
        for t, w in zip(tensors, self._part_weights()):
            sq += (t.float().square().sum() * w).to(self.device)
        return torch.sqrt(comm.all_reduce(sq, DP_AXES, topo=self.topo)[0])

    # ---- 1-bit wire compression (reference engine.py:689-751) -----------
    _ONEBIT_MIN_NUMEL = 2048  # buckets below this all-reduce exactly
    _ONEBIT_BLOCK = 2048      # scale-block length (multiple of 8)

    def _onebit_freeze_step(self) -> int:
        """Warmup before compression engages: a 1-bit optimizer's own
        freeze_step (variance freeze and wire compression flip together),
        else gradient_compression's."""
        name = self.config.optimizer.type.lower().replace("_", "")
        if name in ("onebitadam", "zerooneadam", "onebitlamb"):
            return int(self.config.optimizer.params.get("freeze_step", 100))
        return int(self.config.gradient_compression.freeze_step)

    def _init_onebit(self) -> None:
        """This rank's error-feedback residuals, one pair per bucket of
        ``_wire_plan`` (empty for buckets small enough to reduce exactly):
        the worker's over the padded bucket, the server's over its chunk."""
        from ..ops.onebit import residual_shapes

        W = self.topo.dp_world_size

        def zeros(numel, slot):
            n = residual_shapes(numel, W, self._ONEBIT_BLOCK)[slot] \
                if numel >= self._ONEBIT_MIN_NUMEL else 0
            return torch.zeros((n,), dtype=torch.float32, device=self.device)

        self._onebit_wres = [zeros(b.numel, 0)
                             for b in self._wire_plan.buckets]
        self._onebit_sres = [zeros(b.numel, 1)
                             for b in self._wire_plan.buckets]

    def _init_offload(self, wd_mask) -> None:
        """The host optimizer (an NVMe tier behind it) over this rank's
        partitions, the layer streamer (stage 3: the gradient sink of the
        streamed shards) and ZenFlow, as the reference engine builds
        them."""
        from .zero.offload import OffloadedOptimizer
        from .zero.param_offload import LayerStreamer

        config = self.config
        zero = config.zero_optimization
        off = zero.offload_optimizer if config.optimizer_offloaded \
            else OffloadOptimizerConfig(device="cpu")
        clip = config.gradient_clipping if config.gradient_clipping and \
            config.gradient_clipping > 0 else 0.0
        W = self.topo.dp_world_size
        opt = self.offloaded_optimizer = OffloadedOptimizer(
            self.optimizer, self._parts, off, aio=config.aio,
            param_cfg=zero.offload_param, paths=self._paths, clip=clip,
            device=self.device, arena=self._host,
            rank=comm.get_rank() if self._dp and W > 1 else None,
            norm_fn=self._part_norm if self._dp else None)
        self._delayed_update = bool(off.delayed_update)
        self._sink = None
        if self._dp and self._host_grads:
            # every gradient lands in its host buffer in the backward (a
            # delayed update's beside the ones being applied); the
            # all-leaf indices are the trainable ones (PEFT + offload is
            # refused)
            sink = self._sink = LayerStreamer({}, self.device, self._host)
            dp = self.topo.size("dp")
            host = {}
            for j, g in enumerate(opt.grads):
                sink.grads[j] = g if not off.delayed_update \
                    else self._host.empty(g.shape, torch.float32)
                self._gatherer.grads[j] = sink.grads[j]
                sharded = self._p_dims[j] is not None
                axes = ("dp" if dp > 1 else None) if sharded else (
                    DP_AXES if W > 1 else None)
                host[j] = (axes, 1.0 / (dp if sharded else W))
            self._gatherer.to_host(sink, host, W)
            self._gatherer.streamed = set(self._streamed)
        elif self._streamed:
            st = self._streamer = LayerStreamer(
                {j: self._leaves[j] for j in self._streamed}, self.device,
                self._host)
            st.grads = {j: opt.grads[j] for j in self._streamed}
            if self._delayed_update:
                # step N's streamed gradients land beside step N-1's, which
                # the host is still applying
                st.grads = {j: self._host.empty(opt.grads[j].shape,
                                                torch.float32)
                            for j in self._streamed}
        if config.zenflow.enabled:
            from .zenflow import ZenFlowOptimizer

            self.zenflow_optimizer = ZenFlowOptimizer(
                create_optimizer(config.optimizer, self.lr_schedule,
                                 wd_mask), config.zenflow, host_opt=opt,
                clip=clip, layout=[self._state_layout(j) for j in range(
                    len(self._leaves))] if self._dp else None,
                topo=self.topo, norm_fn=self._part_norm if self._dp
                else None)
            if self._delayed_update:
                logger.warning(
                    "zenflow already removes the per-step offload stall; "
                    "ignoring delayed_update")
                self._delayed_update = False

    # ------------------------------------------------------------------
    # data placement
    # ------------------------------------------------------------------

    def _place(self, batch: Dict[str, Any], local: bool = True
               ) -> Dict[str, torch.Tensor]:
        """The global batch as ``(gas, micro, ...)`` on the device; on a
        data-parallel world (``local``) this rank's rows of each
        micro-batch only (the reference shards that dim over dp × fsdp,
        row-major)."""
        gas = self.batch_config.gradient_accumulation_steps
        tb = self.batch_config.train_batch_size
        W = self.topo.dp_world_size
        r = comm.axis_index(DP_AXES, topo=self.topo) if self._dp and local \
            else None

        def place(x):
            t = torch.as_tensor(np.asarray(x)) if not isinstance(
                x, torch.Tensor) else x
            if t.shape[0] != tb:
                raise ConfigError(f"batch leading dim {t.shape[0]} != "
                                  f"train_batch_size {tb}")
            rest = tuple(t.shape[1:])
            if r is not None:
                t = t.reshape((gas, W, tb // gas // W) + rest)[:, r]
            else:
                t = t.reshape((gas, tb // gas) + rest)
            return t.to(self.device, non_blocking=True)

        return {k: place(v) for k, v in batch.items()}

    def place_batch(self, batch: Dict[str, Any]) -> PlacedBatch:
        """Copy a host batch to the device now and return a
        :class:`PlacedBatch` that ``train_batch`` takes as it is."""
        if "lr_scale" in batch:
            raise NotImplementedError(
                "variable-batch lr_scale arrives with the data pipeline "
                "(ROADMAP.md A14)")
        return PlacedBatch(self._place(batch))

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------

    def _step_rng(self) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.config.seed * 1_000_003 + self.step_count)
                        % (2 ** 63))
        return gen

    def train_batch(self, batch: Any) -> LazyMetrics:
        """One global-batch step: forward, backward, update."""
        self.reload_states()  # states evicted by offload_states come back
        if not isinstance(batch, PlacedBatch):
            batch = self.place_batch(batch)
        placed = batch.placed
        if self._dp:
            return self._finish(self._train_batch_dp(placed))
        if self.offload_enabled:
            return self._finish(self._train_batch_offloaded(placed))
        rng = self._step_rng()
        fp16 = self.fp16_enabled
        ls = self.loss_scale
        grads, msum = self._micro_batch_grads(placed, rng)
        gas = self.batch_config.gradient_accumulation_steps
        with torch.no_grad():
            if gas > 1:
                for g in grads:
                    g.div_(float(gas))
            metrics = {k: m / gas for k, m in msum.items()}
            finite = None
            if fp16:
                grads = unscale_grads(grads, ls)
                finite = grads_finite(grads)
            grad_norm = global_norm(grads)
            lr = self._apply_update(self._leaves, grads, grad_norm, finite)
        del grads
        return self._finish(self._step_metrics(metrics, grad_norm, ls, lr,
                                               finite))

    def _micro_batch_grads(self, placed, rng):
        """Forward and backward of every micro-batch: the f32 gradients of
        the trainable leaves summed over them, and the summed metrics."""
        gas = self.batch_config.gradient_accumulation_steps
        fp16 = self.fp16_enabled
        ls = self.loss_scale
        grads: Optional[List[torch.Tensor]] = None
        msum: Dict[str, torch.Tensor] = {}
        for i in range(gas):
            mb = {k: v[i] for k, v in placed.items()}
            loss, metrics = self._global_weight(
                *self.model.loss_fn(self.params, mb, rng))
            if fp16:
                loss = scale_loss(loss, ls)
            g = torch.autograd.grad(loss, self._leaves, allow_unused=True)
            g = [torch.zeros_like(p, dtype=torch.float32) if gi is None
                 else gi.float() for gi, p in zip(g, self._leaves)]
            if grads is None:
                grads = g
            else:
                for a, b in zip(grads, g):
                    a.add_(b)
            self._sum_metrics(msum, metrics)
        return grads, msum

    def _global_weight(self, loss: torch.Tensor, metrics):
        """ROADMAP.md C10: where the reference evaluates the loss on the
        global batch (stage 3, any offloaded step), this rank's micro-batch
        loss and accuracy weighed by ``local tokens · W / world tokens``
        (one all-reduce of the count), and ``tokens`` the world's: the
        ranks' average is then the global token mean.  Elsewhere, or
        without a ``tokens`` metric, as they are."""
        if not self._global_loss or "tokens" not in metrics:
            return loss, metrics
        local = torch.as_tensor(metrics["tokens"], device=self.device
                                ).detach().float().reshape(1)
        total = comm.all_reduce(local.clone(), DP_AXES, topo=self.topo)[0]
        w = local[0] * self.topo.dp_world_size / total
        metrics = dict(metrics, tokens=total)
        for k in ("loss", "accuracy"):
            if k in metrics:
                metrics[k] = metrics[k] * w
        return loss * w, metrics

    def _sum_metrics(self, msum: Dict[str, torch.Tensor], metrics) -> None:
        for k, m in metrics.items():
            m = torch.as_tensor(m, device=self.device).detach().float()
            msum[k] = msum[k] + m if k in msum else m

    def _apply_update(self, params, grads, grad_norm, finite) -> Any:
        """Clip, step the optimizer (skipping where not ``finite``) and the
        loss scale; returns the lr the update applied."""
        clip = self.config.gradient_clipping
        if clip and clip > 0:
            clip_by_global_norm(grads, grad_norm, clip)
        # lr(step - skipped): the optimizer's count is that difference
        lr = self.optimizer.lr(self.optimizer.count)
        self.optimizer.step(params, grads, finite=finite)
        if finite is not None:
            fp = self.config.fp16
            self.loss_scale = update_loss_scale(
                self.loss_scale, finite,
                loss_scale_window=fp.loss_scale_window,
                min_scale=fp.min_loss_scale, hysteresis=fp.hysteresis,
                dynamic=fp.dynamic_loss_scale)
            self.skipped_steps = self.skipped_steps + (~finite).to(
                torch.int32)
        return lr

    def _step_metrics(self, metrics, grad_norm, ls, lr, finite
                      ) -> Dict[str, torch.Tensor]:
        self.step_count += 1
        dev = self.device
        metrics["grad_norm"] = grad_norm
        metrics["loss_scale"] = ls.scale
        metrics["lr"] = torch.as_tensor(lr, dtype=torch.float32, device=dev)
        metrics["overflow"] = (~finite).float() if finite is not None else \
            torch.zeros((), device=dev)
        return metrics

    # ------------------------------------------------------------------
    # the data-parallel step (ZeRO 0-3 over dp × fsdp)
    # ------------------------------------------------------------------

    def _train_batch_dp(self, placed) -> Dict[str, torch.Tensor]:
        """The reference's explicit data-parallel step
        (``engine.py:775-1143``), each collective issued here: this rank's
        rows of every micro-batch through forward and backward (stage 3:
        the layers gathered per segment, the gradients reduce-scattered in
        backward), the gradients reduced by bucket (stage 1: all-reduced;
        stage 2: reduce-scattered onto the optimizer's shards; qgZ / 1-bit:
        compressed), the metrics, the gradient sum of squares and the fp16
        overflow count summed in ONE all-reduce, the global norm and
        clipping over shards, the optimizer's update of this rank's shards
        (skipped on every rank together on overflow), and at stages 1-2 the
        updated shards all-gathered by bucket."""
        from .coalesce import psum_scalars

        gas = self.batch_config.gradient_accumulation_steps
        rng = self._step_rng()
        fp16 = self.fp16_enabled
        ls = self.loss_scale
        W = self.topo.dp_world_size
        lr0 = self.get_lr()  # an offloaded update's, before the count moves
        if self.zero_stage >= 3:
            msum: Dict[str, torch.Tensor] = {}
            g3 = self._gatherer
            for _, flat in self._s3_buckets:
                flat.zero_()
            with g3:
                for i in range(gas):
                    g3.begin(i)
                    mb = {k: v[i] for k, v in placed.items()}
                    loss, metrics = self._global_weight(*self.model.loss_fn(
                        g3.gather_tree(self.params), mb, rng))
                    if fp16:
                        loss = scale_loss(loss, ls)
                    torch.autograd.grad(loss, [g3.anchor], allow_unused=True)
                    del loss
                    if self._sink is not None:
                        self._sink.accumulate()
                    self._sum_metrics(msum, metrics)
            params = self._leaves
        else:
            grads, msum = self._micro_batch_grads(placed, rng)
            params = self._opt_params
        with torch.no_grad():
            if self.zero_stage >= 3:
                local, sq = self._reduce_stage3(gas)
            else:
                local, sq = self._reduce_buckets(grads)
                del grads
            bad = torch.zeros((), dtype=torch.float32, device=self.device)
            if fp16:
                bad = (~grads_finite(local)).float()
            metrics = {k: m / gas for k, m in msum.items()}
            metrics, tot = psum_scalars(metrics, DP_AXES, 1.0 / W,
                                        extra=torch.stack([sq, bad]),
                                        topo=self.topo)
            if gas > 1:
                for g in local:
                    g.div_(float(gas))
            grad_norm = torch.sqrt(tot[0]) / gas
            if self.offload_enabled:
                return self._offloaded_update(lr0, local, metrics, grad_norm)
            finite = None
            if fp16:
                local = unscale_grads(local, ls)
                finite = tot[1] == 0
                grad_norm = grad_norm / ls.scale
            lr = self._apply_update(params, local, grad_norm, finite)
            del local
            if self._gather_plan is not None:
                self._gather_params()
        return self._step_metrics(metrics, grad_norm, ls, lr, finite)

    def _reduce_buckets(self, grads: List[torch.Tensor]):
        """Stages 0-2: the gradients reduced through the bucket plan (or
        the wire plan, compressed) → (this rank's part of each, aligned
        with the optimizer's parameters; the weighted sum of squares)."""
        from .coalesce import reduce_bucketed

        W = float(self.topo.dp_world_size)
        sqs: List[torch.Tensor] = []

        def exact(b, f):
            r = comm.all_reduce(f.div_(W), DP_AXES, topo=self.topo)
            # replicated: every rank holds the full bucket
            sqs.append(r.square().sum() / W)
            return r

        def scatter(b, f):
            r = comm.reduce_scatter(f.div_(W), DP_AXES, topo=self.topo)
            # scattered: each rank owns a disjoint 1/W chunk
            sqs.append(r.square().sum())
            return r

        onebit = (self.onebit_enabled and
                  self.global_steps >= self._onebit_freeze_step())
        if onebit or self.qgz:
            plan = self._wire_plan
            index = {id(b): i for i, b in enumerate(plan.buckets)}

            def wire(b, f):
                if self.qgz:
                    from ..ops.quantizer import compressed_all_reduce

                    r = compressed_all_reduce(f.div_(W), DP_AXES,
                                              topo=self.topo)
                else:
                    r = self._onebit_bucket(index[id(b)], f)
                sqs.append(r.square().sum() / W)
                return r

            red = reduce_bucketed(plan, grads, wire)
        else:
            plan = self._bucket_plan
            red = reduce_bucketed(plan, grads, exact, scatter)
        scattered = {s.leaf for b in plan.buckets if b.scatter
                     for s in b.slots}
        local = [g if j in scattered else
                 self._local(g, d, self._o_n, axes=DP_AXES)
                 for j, (g, d) in enumerate(zip(red, self._o_dims))]
        return local, torch.stack(sqs).sum()

    def _onebit_bucket(self, bi: int, flat: torch.Tensor) -> torch.Tensor:
        """One bucket through the 1-bit two-phase scheme (its mean), or an
        exact mean for a bucket below ``_ONEBIT_MIN_NUMEL``."""
        from ..ops.onebit import onebit_all_reduce

        W = self.topo.dp_world_size
        w, s = self._onebit_wres[bi], self._onebit_sres[bi]
        if w.numel() == 0:
            return comm.all_reduce(flat.div_(W), DP_AXES, topo=self.topo)
        # the primitive computes the mean itself
        r, self._onebit_wres[bi], self._onebit_sres[bi] = onebit_all_reduce(
            flat, w, s, DP_AXES, W, self._ONEBIT_BLOCK, topo=self.topo)
        return r

    def _reduce_stage3(self, gas: int):
        """Stage 3, after the backward: each gradient bucket all-reduced in
        place — the shards' (already reduce-scattered over fsdp) over dp,
        the replicated leaves' over the whole world → (the gradient
        buffers, the weighted sum of squares).  Offloaded, the buffers are
        the host's, already reduced (``ShardGatherer.to_host``)."""
        W = float(self.topo.dp_world_size)
        for axes, flat in self._s3_buckets:
            comm.all_reduce(flat.div_(W), axes, topo=self.topo)
        dp = float(self.topo.size("dp"))
        bufs = list(self._grad_bufs)
        sqs = [g.square().sum() / (dp if d is not None else W)
               for g, d in zip(bufs, self._tp_dims) if g is not None]
        sink = self._sink
        if sink is not None:
            weights = self._gatherer._host
            for j, g in sink.grads.items():
                bufs[j] = g
            if gas == 1:  # summed on the card as they were copied
                sqs.append(self._gatherer.host_sq)
            else:  # the host holds the sums (accumulate waited for them)
                sqs.append(torch.tensor(float(sum(
                    torch.linalg.vector_norm(g).double() ** 2
                    * weights[j][1] for j, g in sink.grads.items())),
                    dtype=torch.float32, device=self.device))
        return bufs, torch.stack(sqs).sum()

    @torch.no_grad()
    def _gather_params(self) -> None:
        """Stages 1-2: the updated shards all-gathered by bucket into the
        replicated parameters (reference ``_coalesced_gather_fn``)."""
        from .coalesce import unflatten_bucket_shard_major

        W = self.topo.dp_world_size
        for b in self._gather_plan.buckets:
            if not b.scatter:
                continue
            # this rank's row: its slice of every member, the shard-major
            # layout; the all-gather rebuilds the full buffer in one call
            row = torch.cat([self._opt_params[s.leaf].reshape(-1)
                             for s in b.slots])
            full = comm.all_gather(row, DP_AXES, topo=self.topo)
            for i, v in unflatten_bucket_shard_major(b, full, W):
                self._leaves[i].copy_(v)

    def shard_report(self) -> Dict[str, Any]:
        """Per-param sharded-byte accounting
        (``zero.sharding.shard_accounting``) of the whole tree's shapes
        under the parameter shardings."""
        shapes = iter([torch.empty(s, dtype=p.dtype, device="meta")
                       for s, p in zip(self._full_shapes, self._all_leaves)])
        return shard_accounting(tree_map(lambda _: next(shapes),
                                         self.params), self.param_shardings)

    def _finish(self, metrics: Dict[str, torch.Tensor]) -> LazyMetrics:
        self.global_steps += 1
        out = LazyMetrics(metrics)
        if self.config.sanity_checks:
            self._run_sanity_checks(out)
        every = self.config.steps_per_print
        if every and self.global_steps % every == 0:
            logger.info("step=%d loss=%.4f lr=%.2e grad_norm=%.3f",
                        self.global_steps, out["loss"], out["lr"],
                        out["grad_norm"])
        return out

    # ------------------------------------------------------------------
    # offload mode
    # ------------------------------------------------------------------

    def _streaming(self):
        return self._streamer if self._streamer is not None \
            else contextlib.nullcontext()

    def _grad_step(self, placed: Dict[str, torch.Tensor]):
        """The device half of the offloaded step (reference
        ``_build_grad_step``): forward and backward of every micro-batch,
        the f32 gradients summed and divided by ``gas``, and their global
        norm.  Returns (the gradients, None for a streamed leaf: its
        gradient is in the host buffer; the mean metrics; the norm)."""
        gas = self.batch_config.gradient_accumulation_steps
        rng = self._step_rng()
        st = self._streamer
        streamed = set(self._streamed)
        want = [p for j, p in enumerate(self._leaves) if j not in streamed]
        if st is not None:
            want.append(st.anchor)
        grads: Optional[List[torch.Tensor]] = None
        msum: Dict[str, torch.Tensor] = {}
        with self._streaming():
            for i in range(gas):
                if st is not None:
                    st.begin(i)
                mb = {k: v[i] for k, v in placed.items()}
                loss, metrics = self.model.loss_fn(self.params, mb, rng)
                g = torch.autograd.grad(loss, want, allow_unused=True)
                if st is not None:
                    g = g[:-1]
                    st.accumulate()
                g = [torch.zeros_like(p, dtype=torch.float32) if gi is None
                     else gi.float() for gi, p in zip(g, want)]
                if grads is None:
                    grads = g
                else:
                    for a, b in zip(grads, g):
                        a.add_(b)
                for k, m in metrics.items():
                    m = torch.as_tensor(m, device=self.device).detach().float()
                    msum[k] = msum[k] + m if k in msum else m
        with torch.no_grad():
            if gas > 1:
                for g in grads:
                    g.div_(float(gas))
            metrics = {k: m / gas for k, m in msum.items()}
            grad_norm = global_norm(grads)
            if st is not None:
                if gas > 1:  # the host holds the streamed sums
                    host = [st.grads[j] for j in self._streamed]
                    for h in host:
                        h.div_(float(gas))
                    sq = torch.tensor(float(sum(
                        torch.linalg.vector_norm(h).double() ** 2
                        for h in host)), device=self.device)
                else:
                    sq = st.sq
                grad_norm = torch.sqrt(grad_norm * grad_norm + sq)
            full: List[Optional[torch.Tensor]] = []
            it = iter(grads)
            for j in range(len(self._leaves)):
                full.append(None if j in streamed else next(it))
        return full, metrics, grad_norm

    def _stage(self, grads, grad_norm) -> None:
        """Queue the gradients' copies into the host optimizer's buffers
        (a delayed update's streamed buffers trade places first; a
        gradient already in its host buffer is not copied)."""
        opt = self.offloaded_optimizer
        st = self._streamer or self._sink
        if st is not None and self._delayed_update:
            for j in st.grads:
                opt.grads[j], st.grads[j] = st.grads[j], opt.grads[j]
        opt.stage_grads([None if g is b else g
                         for g, b in zip(grads, opt.grads)], grad_norm)

    def _after_update(self) -> None:
        """Stages 1-2: the updated partitions all-gathered by bucket."""
        if self._dp and self._gather_plan is not None:
            self._gather_params()

    def _train_batch_offloaded(self, placed) -> Dict[str, torch.Tensor]:
        """Reference ``_train_batch_offloaded``."""
        lr = self.get_lr()  # before the count moves: the lr of this update
        grads, metrics, grad_norm = self._grad_step(placed)
        return self._offloaded_update(lr, grads, metrics, grad_norm)

    def _offloaded_update(self, lr, grads, metrics, grad_norm
                          ) -> Dict[str, torch.Tensor]:
        """The host half of an offloaded step over this rank's partitions
        (``grads``, their f32 gradients; None or the host buffer itself
        where a gradient is there already), the updated partitions back
        (and all-gathered at stages 1-2)."""
        opt = self.offloaded_optimizer
        parts = self._parts
        # the device work is queued, not done: NVMe reads overlap it
        opt.prefetch()
        applied_lr = None
        if self.zenflow_optimizer is not None:
            self.zenflow_optimizer.step(parts, grads)
            self._after_update()
        elif self._delayed_update:
            # the host applies step N-1 while the card runs step N; the
            # parameters go back behind step N's work on the compute stream
            if self._pending:
                applied_lr = self._pending_lr
                opt.step(out=parts)
                self._after_update()
            self._stage(grads, grad_norm)
            self._pending, self._pending_lr = True, lr
        else:
            self._stage(grads, grad_norm)
            opt.step(out=parts)
            self._after_update()
        del grads
        self.step_count += 1
        dev = self.device
        metrics["grad_norm"] = torch.as_tensor(grad_norm, device=dev)
        metrics["lr"] = torch.tensor(lr, dtype=torch.float32, device=dev)
        if applied_lr is not None:
            # the metrics describe this batch; the update just applied was
            # the previous batch's, at its own lr
            metrics["applied_lr"] = torch.tensor(
                applied_lr, dtype=torch.float32, device=dev)
        return metrics

    def flush_delayed_update(self) -> None:
        """Apply the pending (one step late) update, if any.  Eval and save
        call it; so should the end of training, or the last batch's
        gradients are dropped."""
        if not self._pending:
            return
        self.offloaded_optimizer.step(out=self._parts)
        self._after_update()
        self._pending, self._pending_lr = False, None

    def _run_sanity_checks(self, out: LazyMetrics) -> None:
        """``sanity_checks`` (reference ``_run_sanity_checks``): a
        non-finite loss or grad norm raises, unless the step overflowed
        (the dynamic loss scale skipped it).  One device holds no replicas
        to compare."""
        if float(out.get("overflow", 0.0)) == 0.0:
            for key in ("loss", "grad_norm"):
                if key in out and not np.isfinite(float(out[key])):
                    raise RuntimeError(
                        f"sanity_checks: non-finite {key}="
                        f"{float(out[key])} at step {self.global_steps} — "
                        "data or numerics corruption upstream of the update")

    def eval_batch(self, batch: Any) -> Dict[str, float]:
        """The loss function's metrics over the whole batch, no update (on
        a data-parallel world every rank evaluates the whole host batch,
        so the metrics are the reference's global ones; at stage 3 the
        layers are gathered as in training)."""
        # eval needs the parameters only: evicted optimizer state stays
        self.reload_states(include=("lp_params",))
        self.flush_delayed_update()
        placed = batch.placed if isinstance(batch, PlacedBatch) \
            else self._place(batch, local=False)
        flat = {k: v.reshape((-1,) + tuple(v.shape[2:]))
                for k, v in placed.items()}
        loss_fn = self.model.eval_fn or self.model.loss_fn
        g3 = getattr(self, "_gatherer", None)
        with torch.no_grad(), (g3 or self._streaming()):
            if g3 is None:
                params = self.params
            else:
                # the reference quantizes (qwZ) the training gathers only
                qwz, g3.qwz = g3.qwz, False
                params = g3.gather_tree(self.params)
            try:
                _, metrics = loss_fn(params, flat, self._step_rng())
            finally:
                if g3 is not None:
                    g3.qwz = qwz
        return dict(LazyMetrics(dict(metrics)))

    # -- state accessors (reference: engine property surface) -----------

    @property
    def train_batch_size(self) -> int:
        return self.batch_config.train_batch_size

    @property
    def train_micro_batch_size_per_device(self) -> int:
        return self.batch_config.micro_batch_size_per_device

    @property
    def gradient_accumulation_steps(self) -> int:
        return self.batch_config.gradient_accumulation_steps

    def get_lr(self) -> float:
        return float(self.lr_schedule(self.step_count
                                      - int(self.skipped_steps)))

    def get_global_step(self) -> int:
        return self.step_count

    def get_loss_scale(self) -> float:
        return float(self.loss_scale.scale)

    # -- checkpointing ---------------------------------------------------

    def _opt_prefix(self) -> str:
        # the reference's optimizer is optax.chain([clip,] base): the base
        # optimizer's state sits under index 1 when clipping is on
        clip = self.config.gradient_clipping
        return "1/" if clip and clip > 0 else "0/"

    # the files hold whole tensors (the reference's ``_full_host_tree``);
    # memory holds this rank's shards: (dim, shards, axes) of each

    def _param_layout(self, j: int):
        if self._dp and self.zero_stage >= 3:
            return self._p_dims[j], self._p_n, ("fsdp",)
        return None, 1, None

    def _state_layout(self, j: int):
        """(dim, shards, axes) of trainable leaf ``j``'s partition."""
        if not self._dp:
            return None, 1, None
        if self.zero_stage >= 3:
            return self._p_dims[self._train_idx[j]], self._p_n, ("fsdp",)
        return self._o_dims[j], self._o_n, DP_AXES

    def _whole(self, t: torch.Tensor, layout) -> torch.Tensor:
        """``t`` gathered whole (a collective on the card's tensors: a host
        partition goes through the card, and the result back to the
        host)."""
        d, _, axes = layout
        if d is None:
            return t
        host = t.device != self.device
        w = comm.all_gather(t.to(self.device).contiguous(), axes, axis=d,
                            topo=self.topo)
        return w.cpu() if host else w

    def _state_key_leaf(self) -> Dict[str, int]:
        """{optimizer state path: trainable leaf index}."""
        out = {}
        for key, val in self.optimizer._state().items():
            if isinstance(val, list):
                for j, path in enumerate(self._paths):
                    out[key.format(path)] = j
        return out

    def checkpoint_params(self) -> Dict[str, torch.Tensor]:
        """{path: whole tensor} to save (PEFT: the trainable leaves); at
        stage 3 each leaf's shards all-gathered in turn into host memory
        (a collective: every rank calls it)."""
        if self.peft_enabled:
            return {path: self._whole(t, self._param_layout(j))
                    for path, t, j in zip(self._paths, self._leaves,
                                          self._train_idx)}
        if not (self._dp and self.zero_stage >= 3):
            from .checkpoint.engine import flatten_with_paths

            return flatten_with_paths(self.params)
        return {path: self._whole(t, self._param_layout(j)).cpu()
                for j, (path, t) in enumerate(zip(self._all_paths,
                                                  self._all_leaves))}

    def whole_params(self) -> Any:
        """The parameter tree with whole tensors (at stage 3 each shard
        all-gathered in turn: a collective); the tree itself elsewhere."""
        if not (self._dp and self.zero_stage >= 3):
            return self.params
        whole = iter([self._whole(t, self._param_layout(j))
                      for j, t in enumerate(self._all_leaves)])
        return tree_map(lambda _: next(whole), self.params)

    def optimizer_state_flat(self) -> Dict[str, torch.Tensor]:
        """The optimizer state under the reference's paths (the engine's
        ``optax.chain`` index first), sharded state gathered whole (a
        collective on a data-parallel world)."""
        pre = self._opt_prefix()
        opt = self.optimizer
        if self.offloaded_optimizer is not None:
            # saved from the host (read back from NVMe when paged there)
            opt = self.offloaded_optimizer.state_for_checkpoint()
        flat = opt.state_flat(self._paths, self.device)
        if self._dp:
            where = self._state_key_leaf()
            flat = {k: self._whole(v, self._state_layout(where[k]))
                    if k in where else v for k, v in flat.items()}
        return {pre + k: v for k, v in flat.items()}

    def onebit_residuals_flat(self) -> Optional[Dict[str, torch.Tensor]]:
        """The 1-bit residuals in the reference's layout (``worker/<b>``,
        ``server/<b>``: one row per rank), or None without 1-bit."""
        if not getattr(self, "_onebit_wres", None):
            return None
        flat = {}
        for name, res in (("worker", self._onebit_wres),
                          ("server", self._onebit_sres)):
            for b, t in enumerate(res):
                flat[f"{name}/{b}"] = comm.all_gather(
                    t, DP_AXES, tiled=False, topo=self.topo)
        return flat

    @torch.no_grad()
    def load_onebit_residuals(self, flat: Optional[Dict[str, Any]]) -> None:
        """This rank's rows of saved residuals; zeros (with the
        reference's warnings) when absent or from another world."""
        if not getattr(self, "_onebit_wres", None):
            return
        r = comm.axis_index(DP_AXES, topo=self.topo)
        W = self.topo.dp_world_size
        pairs = [(name, b, t) for name, res in (("worker", self._onebit_wres),
                                                ("server", self._onebit_sres))
                 for b, t in enumerate(res)]
        ok = flat is not None and all(
            f"{name}/{b}" in flat and tuple(flat[f"{name}/{b}"].shape)
            == (W,) + tuple(t.shape) for name, b, t in pairs)
        if flat is None:
            logger.warning(
                "checkpoint has no onebit_residuals.safetensors — 1-bit "
                "error-feedback restarts from zero (one-shot gradient-bias "
                "transient on resume)")
        elif not ok:
            logger.warning(
                "onebit residual shapes in the checkpoint do not match "
                "this engine's dp world — residuals restart from zero "
                "(the per-worker feedback is topology-bound)")
        for name, b, t in pairs:
            if ok:
                t.copy_(torch.as_tensor(flat[f"{name}/{b}"])[r])
            else:
                t.zero_()

    @torch.no_grad()
    def load_state_from(self, flat_params: Dict[str, torch.Tensor],
                        flat_opt: Optional[Dict[str, torch.Tensor]],
                        meta: Dict[str, Any], where: str = "",
                        adapter_only: bool = False) -> None:
        """Restore from a checkpoint's flat trees and engine meta: each
        parameter in place (in the engine's dtype; this rank's shard of it
        at stage 3; ``adapter_only``: the trainable leaves alone, over the
        engine's frozen base), the optimizer state (``flat_opt``, sliced to
        this rank's shards; None keeps the engine's), the step counts and
        the loss scale.  The files hold whole tensors, so a checkpoint of
        any stage and world loads at any other.  The step's generator
        derives from the restored step (the reference's ``rng`` key is not
        used)."""
        if adapter_only:
            paths, targets = self._paths, self._leaves
            pos = {id(t): j for j, t in enumerate(self._all_leaves)}
            index = [pos[id(t)] for t in targets]
        else:
            paths, targets = self._all_paths, self._all_leaves
            index = list(range(len(targets)))
        # the first missing tensor in the reference's (sorted) order
        for path in sorted(paths):
            if path not in flat_params:
                raise KeyError(f"checkpoint missing tensor {path!r}")
        for path, p, j in zip(paths, targets, index):
            src = flat_params[path]
            full = self._full_shapes[j]
            if tuple(src.shape) != full:
                raise ValueError(f"{path}: checkpoint shape "
                                 f"{tuple(src.shape)} != {full}")
            d, n, axes = self._param_layout(j)
            src = torch.as_tensor(src)
            if d is not None:
                src = self._local(src, d, n, axes=axes)
            p.copy_(src.to(p.device, p.dtype))
        if flat_opt is not None:
            pre = self._opt_prefix()
            flat = {k[len(pre):]: v for k, v in flat_opt.items()
                    if k.startswith(pre)}
            if self._dp:
                keyed = self._state_key_leaf()
                for k, j in keyed.items():
                    d, n, axes = self._state_layout(j)
                    if k in flat and d is not None:
                        flat[k] = self._local(torch.as_tensor(flat[k]), d, n,
                                              axes=axes)
            try:
                if self.offloaded_optimizer is not None:
                    self.offloaded_optimizer.load_state(flat, self._paths)
                else:
                    self.optimizer.load_state_flat(flat, self._paths)
            except KeyError as e:
                raise ValueError(
                    f"optimizer state in {where} does not match the "
                    f"engine's optimizer structure ({e}); if the optimizer "
                    "config changed, pass load_optimizer_states=False") from e
        dev = self.device
        self.step_count = self.global_steps = int(meta["step"])
        skipped = int(meta.get("skipped_steps", 0))
        self.skipped_steps = torch.tensor(skipped, dtype=torch.int32,
                                          device=dev) \
            if self.fp16_enabled else skipped
        self.loss_scale = LossScaleState(
            scale=torch.tensor(float(meta["loss_scale"]),
                               dtype=torch.float32, device=dev),
            good_steps=torch.tensor(int(meta["loss_scale_good_steps"]),
                                    dtype=torch.int32, device=dev),
            hysteresis=torch.tensor(int(meta["loss_scale_hysteresis"]),
                                    dtype=torch.int32, device=dev))

    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[Dict] = None) -> str:
        self.flush_delayed_update()
        if self.zenflow_optimizer is not None:
            # mid-interval cold gradients must not be dropped by the save
            self.zenflow_optimizer.flush(self._parts)
            self._after_update()
        from .checkpoint.engine import save_checkpoint as _save

        return _save(self, save_dir, tag=tag, client_state=client_state or {})

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        load_optimizer_states: bool = True,
                        fallback: Optional[bool] = None,
                        ) -> Tuple[Optional[str], Dict]:
        from .checkpoint.engine import load_checkpoint as _load

        return _load(self, load_dir, tag=tag,
                     load_optimizer_states=load_optimizer_states,
                     fallback=fallback)

    def export_merged_weights(self, save_dir: str, tag: str = "merged"
                              ) -> str:
        """PEFT serving export: every LoRA node folded into its base and
        written as a plain full-model checkpoint
        (``checkpoint/engine.export_merged_weights``)."""
        self.flush_delayed_update()
        from .checkpoint.engine import export_merged_weights as _export

        return _export(self, save_dir, tag=tag)

    # -- phase-alternation state offload (reference: offload_states /
    # reload_states; an RLHF rollout evicts the optimizer state to free
    # the card for the KV cache, then reloads it before the next update) --

    _OFFLOADABLE = ("optim_states", "lp_params")

    def offload_states(self, include: Optional[Sequence[str]] = None,
                       device: str = "cpu", pin_memory: bool = True,
                       non_blocking: bool = False) -> None:
        """Evict engine state to host memory between phases.

        ``include`` is a subset of {"optim_states", "lp_params"} (default:
        the optimizer state; evicting the parameters too means nothing runs
        until :meth:`reload_states`).  The device tensors are dropped, so
        the card's memory is freed.  Under ``offload_optimizer`` the
        optimizer already lives on the host and "optim_states" does
        nothing.  Idempotent; ``train_batch`` reloads by itself."""
        if device != "cpu":
            raise ConfigError(f"offload_states supports device='cpu', "
                              f"got {device!r}")
        include = set(include) if include is not None else {"optim_states"}
        unknown = include - set(self._OFFLOADABLE)
        if unknown:
            raise ConfigError(
                f"offload_states: unknown state types {sorted(unknown)}; "
                f"valid: {self._OFFLOADABLE}")
        self.flush_delayed_update()
        pin = pin_memory and self.device.type == "cuda"

        def to_host(t):
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
            h.copy_(t.detach(), non_blocking=non_blocking)
            return h

        done = self._offloaded_states
        if ("optim_states" in include and "optim_states" not in done
                and self.offloaded_optimizer is None):
            for lst in self.optimizer._leaf_state():
                for i, t in enumerate(lst):
                    if t is not None and t.device != torch.device("cpu"):
                        lst[i] = to_host(t)
            done["optim_states"] = True
        if "lp_params" in include and "lp_params" not in done:
            with torch.no_grad():
                for p in self._all_leaves:
                    if p.device != torch.device("cpu"):
                        p.data = to_host(p)
            if self._dp and self.zero_stage < 3:
                # the slices' views would keep the card's copies alive
                self._opt_params = None
            done["lp_params"] = True
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        if done:
            logger.info("offloaded states to host: %s", sorted(done))

    def reload_states(self, non_blocking: bool = False,
                      include: Optional[Sequence[str]] = None) -> None:
        """Put the states :meth:`offload_states` evicted back on the
        device (``include`` a subset: eval needs the parameters, not the
        optimizer state).  Idempotent."""
        done = self._offloaded_states
        if not done:
            return
        wanted = set(include) if include is not None else set(done)
        streamed = set(self._streamed)
        if "optim_states" in done and "optim_states" in wanted:
            for lst in self.optimizer._leaf_state():
                for i, t in enumerate(lst):
                    if t is not None:
                        lst[i] = t.to(self.device, non_blocking=non_blocking)
            del done["optim_states"]
        if "lp_params" in done and "lp_params" in wanted:
            with torch.no_grad():
                for j, p in enumerate(self._all_leaves):
                    if j not in streamed:
                        p.data = p.data.to(self.device,
                                           non_blocking=non_blocking)
            if self._dp and self.zero_stage < 3:
                self._bind_opt_params()  # the slices of the moved leaves
            del done["lp_params"]

    @property
    def states_offloaded(self) -> bool:
        return bool(self._offloaded_states)
