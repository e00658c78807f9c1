"""The training engine, single device, ZeRO stage 0 — the port of
``deepspeed_tpu/runtime/engine.py``.

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

Data parallelism, ZeRO 1-3 and wire compression of gradients are later
items of ROADMAP.md; the config refuses them out loud.
"""

from __future__ import annotations

import collections.abc
import contextlib
import dataclasses
import logging
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..accelerator import get_accelerator, resolve_device
from ..linear.optimized_linear import apply_lora, has_lora, trainable_mask
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

logger = logging.getLogger(__name__)

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
    ``TrainingEngine``, on one GPU (or the CPU when asked)."""

    def __init__(self, model: ModelSpec, config: DeepSpeedTPUConfig,
                 device: Any = "cuda"):
        config.check_supported()
        self.config = config
        self.device = resolve_device(device)
        self.accelerator = get_accelerator()
        self.batch_config: ResolvedBatchConfig = \
            config.resolve_batch_config(1)

        # PEFT (reference engine.py:171-215): the targeted projections
        # become LoRA nodes, drawn from the config's seed, unless the tree
        # has them already; only their factors train
        params = model.params
        lora_cfg = config.peft.lora
        if lora_cfg.enabled and not has_lora(params):
            gen = torch.Generator(device=leaves(params)[0].device)
            params = apply_lora(params, gen.manual_seed(config.seed),
                                lora_cfg)
        self.peft_enabled = has_lora(params)
        if self.peft_enabled:
            config.check_peft()
        self._trainable_mask = trainable_mask(params) if self.peft_enabled \
            else None
        flat_in = leaves(params)
        trainable = leaves(self._trainable_mask) if self.peft_enabled \
            else [True] * len(flat_in)

        # offload mode: parameters off the card imply the host optimizer
        zero = config.zero_optimization
        self.param_offload_enabled = config.param_offloaded
        self.offload_enabled = (config.optimizer_offloaded
                                or self.param_offload_enabled)
        self.offloaded_optimizer = None
        self.zenflow_optimizer = None
        self._streamer = None
        self._delayed_update = False
        self._pending = False  # a delayed update's gradients are staged
        self._pending_lr: Optional[float] = None
        self._offloaded_states: Dict[str, bool] = {}
        self._host = None
        stream_mask = None
        if self.offload_enabled:
            from .zero.param_offload import (HostArena, offload_mask,
                                             resolve_threshold)

            self._host = HostArena(self.device)
            if self.param_offload_enabled:
                stream_mask = leaves(offload_mask(
                    params, min_numel=resolve_threshold(
                        zero.stage3_param_persistence_threshold)))

        # the engine owns its parameters: fresh copies on its device (the
        # streamed layer leaves in host memory, in their own dtype); a
        # frozen leaf is copied once and takes no gradient
        streamed = stream_mask or [False] * len(flat_in)
        own = iter([self._host.copy_of(p) if s else p.detach().to(
            self.device, copy=True).requires_grad_(t)
            for p, s, t in zip(flat_in, streamed, trainable)])
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
        self.model = dataclasses.replace(model, params=None)

        base_lr = config.optimizer.params.get("lr", 1e-3)
        self.lr_schedule = create_scheduler(config.scheduler, base_lr=base_lr)
        wd_mask = None
        if config.optimizer.params.get("weight_decay", 0.0):
            # over the trainable leaves only (reference: the mask of the
            # trainable template)
            wd_mask = [m for m, t in zip(
                leaves(default_weight_decay_mask(self.params)), trainable)
                if t]
        self.optimizer = create_optimizer(config.optimizer, self.lr_schedule,
                                          wd_mask)
        if self.offload_enabled:
            self._init_offload(wd_mask)
        else:
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
        logger.info("engine ready: zero_stage=0 device=%s batch=%d micro=%d "
                    "gas=%d", self.device, self.train_batch_size,
                    self.train_micro_batch_size_per_device,
                    self.gradient_accumulation_steps)

    def _init_offload(self, wd_mask) -> None:
        """The host optimizer (an NVMe tier behind it), the layer streamer
        and ZenFlow, as the reference engine builds them."""
        from .zero.offload import OffloadedOptimizer
        from .zero.param_offload import LayerStreamer

        config = self.config
        zero = config.zero_optimization
        off = zero.offload_optimizer if config.optimizer_offloaded \
            else OffloadOptimizerConfig(device="cpu")
        clip = config.gradient_clipping if config.gradient_clipping and \
            config.gradient_clipping > 0 else 0.0
        opt = self.offloaded_optimizer = OffloadedOptimizer(
            self.optimizer, self._leaves, off, aio=config.aio,
            param_cfg=zero.offload_param, paths=self._paths, clip=clip,
            device=self.device, arena=self._host)
        self._delayed_update = bool(off.delayed_update)
        if self._streamed:
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
                clip=clip)
            if self._delayed_update:
                logger.warning(
                    "zenflow already removes the per-step offload stall; "
                    "ignoring delayed_update")
                self._delayed_update = False

    # ------------------------------------------------------------------
    # data placement
    # ------------------------------------------------------------------

    def _place(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        gas = self.batch_config.gradient_accumulation_steps
        tb = self.batch_config.train_batch_size

        def place(x):
            t = torch.as_tensor(np.asarray(x)) if not isinstance(
                x, torch.Tensor) else x
            if t.shape[0] != tb:
                raise ConfigError(f"batch leading dim {t.shape[0]} != "
                                  f"train_batch_size {tb}")
            t = t.reshape((gas, tb // gas) + tuple(t.shape[1:]))
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
        if self.offload_enabled:
            return self._finish(self._train_batch_offloaded(placed))
        gas = self.batch_config.gradient_accumulation_steps
        rng = self._step_rng()
        fp16 = self.fp16_enabled
        ls = self.loss_scale
        grads: Optional[List[torch.Tensor]] = None
        msum: Dict[str, torch.Tensor] = {}
        for i in range(gas):
            mb = {k: v[i] for k, v in placed.items()}
            loss, metrics = self.model.loss_fn(self.params, mb, rng)
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
            for k, m in metrics.items():
                m = torch.as_tensor(m, device=self.device).detach().float()
                msum[k] = msum[k] + m if k in msum else m
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
            clip = self.config.gradient_clipping
            if clip and clip > 0:
                clip_by_global_norm(grads, grad_norm, clip)
            # lr(step - skipped): the optimizer's count is that difference
            lr = self.optimizer.lr(self.optimizer.count)
            self.optimizer.step(self._leaves, grads, finite=finite)
            if fp16:
                fp = self.config.fp16
                self.loss_scale = update_loss_scale(
                    ls, finite, loss_scale_window=fp.loss_scale_window,
                    min_scale=fp.min_loss_scale, hysteresis=fp.hysteresis,
                    dynamic=fp.dynamic_loss_scale)
                self.skipped_steps = self.skipped_steps + (~finite).to(
                    torch.int32)
        del grads
        self.step_count += 1
        dev = self.device
        metrics["grad_norm"] = grad_norm
        metrics["loss_scale"] = ls.scale
        metrics["lr"] = torch.as_tensor(lr, dtype=torch.float32, device=dev)
        metrics["overflow"] = (~finite).float() if fp16 else \
            torch.zeros((), device=dev)
        return self._finish(metrics)

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
        (a delayed update's streamed buffers trade places first)."""
        opt = self.offloaded_optimizer
        st = self._streamer
        if st is not None and self._delayed_update:
            for j in self._streamed:
                opt.grads[j], st.grads[j] = st.grads[j], opt.grads[j]
        opt.stage_grads(grads, grad_norm)

    def _train_batch_offloaded(self, placed) -> Dict[str, torch.Tensor]:
        """Reference ``_train_batch_offloaded``."""
        lr = self.get_lr()  # before the count moves: the lr of this update
        grads, metrics, grad_norm = self._grad_step(placed)
        opt = self.offloaded_optimizer
        # the device work is queued, not done: NVMe reads overlap it
        opt.prefetch()
        applied_lr = None
        if self.zenflow_optimizer is not None:
            self.zenflow_optimizer.step(self._leaves, grads)
        elif self._delayed_update:
            # the host applies step N-1 while the card runs step N; the
            # parameters go back behind step N's work on the compute stream
            if self._pending:
                applied_lr = self._pending_lr
                opt.step(out=self._leaves)
            self._stage(grads, grad_norm)
            self._pending, self._pending_lr = True, lr
        else:
            self._stage(grads, grad_norm)
            opt.step(out=self._leaves)
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
        self.offloaded_optimizer.step(out=self._leaves)
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
        """The loss function's metrics over the whole batch, no update."""
        # eval needs the parameters only: evicted optimizer state stays
        self.reload_states(include=("lp_params",))
        self.flush_delayed_update()
        placed = batch.placed if isinstance(batch, PlacedBatch) \
            else self._place(batch)
        flat = {k: v.reshape((-1,) + tuple(v.shape[2:]))
                for k, v in placed.items()}
        loss_fn = self.model.eval_fn or self.model.loss_fn
        with torch.no_grad(), self._streaming():
            _, metrics = loss_fn(self.params, flat, self._step_rng())
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

    def optimizer_state_flat(self) -> Dict[str, torch.Tensor]:
        """The optimizer state under the reference's paths (the engine's
        ``optax.chain`` index first)."""
        pre = self._opt_prefix()
        opt = self.optimizer
        if self.offloaded_optimizer is not None:
            # saved from the host (read back from NVMe when paged there)
            opt = self.offloaded_optimizer.state_for_checkpoint()
        return {pre + k: v for k, v in opt.state_flat(
            self._paths, self.device).items()}

    @torch.no_grad()
    def load_state_from(self, flat_params: Dict[str, torch.Tensor],
                        flat_opt: Optional[Dict[str, torch.Tensor]],
                        meta: Dict[str, Any], where: str = "",
                        adapter_only: bool = False) -> None:
        """Restore from a checkpoint's flat trees and engine meta: each
        parameter in place (in the engine's dtype; ``adapter_only``: the
        trainable leaves alone, over the engine's frozen base), the
        optimizer state (``flat_opt``; None keeps the engine's), the step
        counts and the loss scale.  The step's generator derives from the
        restored step (the reference's ``rng`` key is not used)."""
        paths, targets = (self._paths, self._leaves) if adapter_only else \
            (self._all_paths, self._all_leaves)
        # the first missing tensor in the reference's (sorted) order
        for path in sorted(paths):
            if path not in flat_params:
                raise KeyError(f"checkpoint missing tensor {path!r}")
        for path, p in zip(paths, targets):
            src = flat_params[path]
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{path}: checkpoint shape "
                                 f"{tuple(src.shape)} != {tuple(p.shape)}")
            p.copy_(src.to(p.device, p.dtype))
        if flat_opt is not None:
            pre = self._opt_prefix()
            flat = {k[len(pre):]: v for k, v in flat_opt.items()
                    if k.startswith(pre)}
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
            self.zenflow_optimizer.flush(self._leaves)
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
            del done["lp_params"]

    @property
    def states_offloaded(self) -> bool:
        return bool(self._offloaded_states)
