"""The framework config tree — the port of
``deepspeed_tpu/runtime/config.py``.

The root config accepts every section and key of the reference's, so a
config written for the JAX package loads here and a typo still raises
:class:`ConfigError`.  The training slice reads the batch spine
(``train_batch_size``, ``train_micro_batch_size_per_gpu``,
``gradient_accumulation_steps``), ``bf16``, ``fp16`` (the dynamic loss
scaler), ``optimizer``, ``scheduler``, ``zero_optimization.stage`` (0)
with ``offload_optimizer`` / ``offload_param`` (cpu or nvme) and
``stage3_param_persistence_threshold``, ``aio``, ``zenflow``,
``gradient_clipping``, ``sanity_checks``, ``checkpoint`` (the ``native``
and ``fast`` engines), ``seed`` and ``steps_per_print``; and the
data-parallel world (ROADMAP.md A13, part 1): ``zero_optimization.stage``
1-3 with every ``ZeroConfig`` key (the bucket sizes, ``mics_shard_size``,
``zero_quantized_weights``, ``zero_quantized_gradients``; the keys no
reference code reads, such as ``zero_hpz_partition_size`` or
``stage3_prefetch_bucket_size``, are taken and unread), ``mesh``
(``data_parallel_size``, ``fsdp_size``), ``gradient_compression``, and
``comms_logger``, ``prescale_gradients``, ``gradient_predivide_factor``
and ``sparse_gradients``, which the reference reads nowhere either.
``data_types``, ``remat`` and ``activation_checkpointing`` are parsed and
validated and, as in the reference, read by no engine code (the model's
``remat_policy`` and ``runtime/activation_checkpointing`` carry the
policies, ``cpu_checkpointing`` included).  The offload combinations the reference
engine rejects raise its ``ConfigError`` word for word.  Any other key set
to a value other than its default raises ``NotImplementedError`` naming
the ROADMAP item it arrives with, as do offload at stages 1-3, mesh axes
other than dp / fsdp, the ``orbax`` checkpoint engine (multi-host),
universal checkpoints and ``partition_activations``.

Batch-size arithmetic is the reference's, verbatim:

    train_batch_size == micro_batch_per_device * gradient_accumulation_steps
                        * data_parallel_world_size
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import field
from typing import Any, Dict, List, Optional, Union

from ..linear.config import LoRAConfig, PEFTConfig, QuantizationConfig  # noqa: F401
from .config_utils import (AUTO, ConfigError, DSConfigModel,
                           check_int_or_auto, is_auto)

dataclass = dataclasses.dataclass


# ---------------------------------------------------------------------------
# sections (field for field the reference's)
# ---------------------------------------------------------------------------


@dataclass
class FP16Config(DSConfigModel):
    enabled: Union[bool, str] = False
    loss_scale: float = 0.0
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0
    auto_cast: bool = False

    @property
    def dynamic_loss_scale(self) -> bool:
        return self.loss_scale == 0.0


@dataclass
class BF16Config(DSConfigModel):
    enabled: Union[bool, str] = True
    accumulate_grads_in_fp32: bool = True


@dataclass
class FloatingPointConfig(DSConfigModel):
    master_weights: bool = True
    master_dtype: str = "float32"


@dataclass
class OptimizerConfig(DSConfigModel):
    type: str = "adamw"
    params: Dict[str, Any] = field(default_factory=dict)


@dataclass
class SchedulerConfig(DSConfigModel):
    type: Optional[str] = None
    params: Dict[str, Any] = field(default_factory=dict)


#: the reference's ``OffloadDeviceEnum``
OFFLOAD_DEVICES = ("none", "cpu", "nvme")


def _check_offload_device(section: str, device: str) -> None:
    if device not in OFFLOAD_DEVICES:
        raise ConfigError(f"{section}.device must be one of "
                          f"{list(OFFLOAD_DEVICES)}, got {device!r}")


@dataclass
class OffloadParamConfig(DSConfigModel):
    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 5
    buffer_size: int = 100_000_000
    max_in_cpu: int = 1_000_000_000
    pin_memory: bool = True

    @property
    def device_str(self) -> str:
        return self.device

    def validate(self) -> None:
        _check_offload_device("offload_param", self.device)


@dataclass
class OffloadOptimizerConfig(DSConfigModel):
    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 4
    pin_memory: bool = True
    pipeline_read: bool = True
    pipeline_write: bool = True
    fast_init: bool = False
    ratio: float = 1.0
    delayed_update: bool = False

    @property
    def device_str(self) -> str:
        return self.device

    def validate(self) -> None:
        _check_offload_device("offload_optimizer", self.device)


@dataclass
class ZeroConfig(DSConfigModel):
    stage: int = 0
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: Union[int, str] = 500_000_000
    allreduce_bucket_size: Optional[Union[int, str]] = None
    allgather_partitions: bool = True
    allgather_bucket_size: Union[int, str] = 500_000_000
    overlap_comm: Optional[bool] = None
    offload_param: Optional[OffloadParamConfig] = None
    offload_optimizer: Optional[OffloadOptimizerConfig] = None
    sub_group_size: int = 1_000_000_000
    stage3_max_live_parameters: int = 1_000_000_000
    stage3_max_reuse_distance: int = 1_000_000_000
    stage3_prefetch_bucket_size: Union[int, str] = 50_000_000
    stage3_param_persistence_threshold: Union[int, str] = 100_000
    stage3_gather_16bit_weights_on_model_save: bool = False
    zero_hpz_partition_size: int = 1
    zero_quantized_weights: bool = False
    zero_quantized_gradients: bool = False
    mics_shard_size: int = -1
    mics_hierarchical_params_gather: bool = False
    round_robin_gradients: bool = False
    ignore_unused_parameters: bool = True
    elastic_checkpoint: bool = False

    def validate(self) -> None:
        if self.stage not in (0, 1, 2, 3):
            raise ConfigError(
                f"zero_optimization.stage must be 0..3, got {self.stage}")


@dataclass
class MeshConfig(DSConfigModel):
    pipeline_parallel_size: int = 1
    data_parallel_size: Union[int, str] = AUTO
    fsdp_size: Union[int, str] = 1
    expert_parallel_size: int = 1
    sequence_parallel_size: int = 1
    tensor_parallel_size: int = 1
    dcn_axes: List[str] = field(default_factory=lambda: ["pp", "dp"])


@dataclass
class PipelineConfig(DSConfigModel):
    stages: Union[int, str] = AUTO
    partition_method: str = "uniform"
    num_microbatches: Union[int, str] = AUTO
    schedule: str = "1f1b"
    activation_checkpoint_interval: int = 0


@dataclass
class MoEConfig(DSConfigModel):
    enabled: bool = False
    num_experts: int = 1
    top_k: int = 2
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    min_capacity: int = 4
    noisy_gate_policy: Optional[str] = None
    drop_tokens: bool = True
    use_residual: bool = False
    aux_loss_weight: float = 0.01
    z_loss_weight: float = 0.001
    expert_parallel_size: int = 1


@dataclass
class SequenceParallelConfig(DSConfigModel):
    enabled: bool = False
    size: int = 1
    mode: str = "ulysses"
    tiled_mlp: bool = False
    tiled_logits_loss: bool = False
    tile_size: int = 2048


@dataclass
class TensorParallelConfig(DSConfigModel):
    enabled: bool = False
    tp_size: int = 1
    partition_spec: Union[str, Dict[str, str]] = AUTO


@dataclass
class ActivationCheckpointingConfig(DSConfigModel):
    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False
    policy: str = "nothing_saveable"


@dataclass
class MonitorSinkConfig(DSConfigModel):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedTPUJob"
    team: Optional[str] = None
    group: Optional[str] = None
    project: Optional[str] = None


@dataclass
class FlopsProfilerConfig(DSConfigModel):
    enabled: bool = False
    profile_step: int = 1
    module_depth: int = -1
    top_modules: int = 1
    detailed: bool = True
    output_file: Optional[str] = None


@dataclass
class TraceProfilerConfig(DSConfigModel):
    enabled: bool = False
    start_step: int = 3
    end_step: int = 5
    output_dir: str = "dstpu_trace"


@dataclass
class CommsLoggerConfig(DSConfigModel):
    enabled: bool = False
    verbose: bool = False
    prof_all: bool = True
    debug: bool = False
    prof_ops: List[str] = field(default_factory=list)


@dataclass
class AIOConfig(DSConfigModel):
    block_size: int = 1_048_576
    queue_depth: int = 8
    thread_count: int = 1
    single_submit: bool = False
    overlap_events: bool = True
    use_gds: bool = False


@dataclass
class DataEfficiencyConfig(DSConfigModel):
    enabled: bool = False
    seed: int = 1234
    curriculum_learning: Dict[str, Any] = field(default_factory=dict)
    data_sampling: Dict[str, Any] = field(default_factory=dict)
    data_routing: Dict[str, Any] = field(default_factory=dict)


@dataclass
class CompressionConfig(DSConfigModel):
    enabled: bool = False
    weight_quantization: Dict[str, Any] = field(default_factory=dict)
    activation_quantization: Dict[str, Any] = field(default_factory=dict)
    sparse_pruning: Dict[str, Any] = field(default_factory=dict)
    row_pruning: Dict[str, Any] = field(default_factory=dict)
    head_pruning: Dict[str, Any] = field(default_factory=dict)
    layer_reduction: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ElasticityConfig(DSConfigModel):
    enabled: bool = False
    max_train_batch_size: int = 2000
    micro_batch_sizes: List[int] = field(default_factory=lambda: [2, 4, 6])
    min_device_count: int = 1
    max_device_count: int = 10000
    min_time: int = 0
    prefer_larger_batch: bool = True
    ignore_non_elastic_batch_info: bool = False
    version: float = 0.2


@dataclass
class AutotuningConfig(DSConfigModel):
    enabled: bool = False
    fast: bool = True
    metric: str = "throughput"
    start_profile_step: int = 3
    end_profile_step: int = 5
    max_train_batch_size: Optional[int] = None
    mp_size: int = 1
    num_tuning_micro_batch_sizes: int = 3
    tuner_type: str = "gridsearch"
    tuner_early_stopping: int = 5
    results_dir: str = "autotuning_results"
    exps_dir: str = "autotuning_exps"
    overwrite: bool = False


@dataclass
class CheckpointConfig(DSConfigModel):
    tag_validation: str = "Warn"
    load_universal: bool = False
    use_node_local_storage: bool = False
    parallel_write_pipeline: bool = False
    async_save: bool = False
    engine: str = "native"
    keep_n_latest: Optional[int] = None
    integrity: str = "sha256"
    fallback_on_corruption: bool = True


@dataclass
class GradientCompressionConfig(DSConfigModel):
    enabled: bool = False
    algorithm: str = "onebit_adam"
    freeze_step: int = 100_000
    comm_dtype: str = "int8"
    cuda_aware: bool = False


@dataclass
class RematConfig(DSConfigModel):
    policy: str = "nothing_saveable"
    prevent_cse: bool = True


@dataclass
class ZenFlowConfig(DSConfigModel):
    enabled: bool = False
    topk_ratio: float = 0.1
    select_strategy: str = "auto"
    select_interval: Union[int, str] = AUTO
    update_interval: Union[int, str] = AUTO
    overlap_step: bool = True


# ---------------------------------------------------------------------------
# root
# ---------------------------------------------------------------------------

# keys of the root config this slice does not run yet -> the ROADMAP.md
# item they arrive with; set to anything but their default, they raise
_LATER = {
    "wall_clock_breakdown": "A14 (training periphery)",
    "dump_state": "A14 (training periphery)",
    "memory_breakdown": "A14 (training periphery)",
    "pipeline": "A13 (multi-GPU)",
    "moe": "A13 (multi-GPU, MoE)",
    "sequence_parallel": "A13 (multi-GPU)",
    "tensor_parallel": "A13 (multi-GPU)",
    "tensorboard": "A14 (training periphery)",
    "wandb": "A14 (training periphery)",
    "comet": "A14 (training periphery)",
    "csv_monitor": "A14 (training periphery)",
    "flops_profiler": "A14 (training periphery)",
    "trace_profiler": "A14 (training periphery)",
    "data_efficiency": "A14 (training periphery)",
    "compression_training": "A14 (training periphery)",
    "elasticity": "A14 (training periphery)",
    "autotuning": "A14 (training periphery)",
}


@dataclass
class DeepSpeedTPUConfig(DSConfigModel):
    """Root config (reference: ``runtime/config.py`` DeepSpeedTPUConfig)."""

    train_batch_size: Union[int, str] = AUTO
    train_micro_batch_size_per_gpu: Union[int, str] = AUTO
    gradient_accumulation_steps: Union[int, str] = AUTO

    steps_per_print: int = 10
    wall_clock_breakdown: bool = False
    dump_state: bool = False
    sanity_checks: bool = False
    prescale_gradients: bool = False
    gradient_predivide_factor: float = 1.0
    gradient_clipping: float = 0.0
    sparse_gradients: bool = False
    memory_breakdown: bool = False
    seed: int = 42

    fp16: FP16Config = field(default_factory=FP16Config)
    bf16: BF16Config = field(default_factory=BF16Config)
    data_types: FloatingPointConfig = field(
        default_factory=FloatingPointConfig)

    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)

    zero_optimization: ZeroConfig = field(default_factory=ZeroConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    moe: MoEConfig = field(default_factory=MoEConfig)
    sequence_parallel: SequenceParallelConfig = field(
        default_factory=SequenceParallelConfig)
    tensor_parallel: TensorParallelConfig = field(
        default_factory=TensorParallelConfig)

    activation_checkpointing: ActivationCheckpointingConfig = field(
        default_factory=ActivationCheckpointingConfig)
    remat: RematConfig = field(default_factory=RematConfig)

    aio: AIOConfig = field(default_factory=AIOConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)

    tensorboard: MonitorSinkConfig = field(default_factory=MonitorSinkConfig)
    wandb: MonitorSinkConfig = field(default_factory=MonitorSinkConfig)
    comet: MonitorSinkConfig = field(default_factory=MonitorSinkConfig)
    csv_monitor: MonitorSinkConfig = field(default_factory=MonitorSinkConfig)

    flops_profiler: FlopsProfilerConfig = field(
        default_factory=FlopsProfilerConfig)
    trace_profiler: TraceProfilerConfig = field(
        default_factory=TraceProfilerConfig)
    comms_logger: CommsLoggerConfig = field(default_factory=CommsLoggerConfig)

    data_efficiency: DataEfficiencyConfig = field(
        default_factory=DataEfficiencyConfig)
    compression_training: CompressionConfig = field(
        default_factory=CompressionConfig)
    elasticity: ElasticityConfig = field(default_factory=ElasticityConfig)
    autotuning: AutotuningConfig = field(default_factory=AutotuningConfig)
    gradient_compression: GradientCompressionConfig = field(
        default_factory=GradientCompressionConfig)
    zenflow: ZenFlowConfig = field(default_factory=ZenFlowConfig)
    peft: PEFTConfig = field(default_factory=PEFTConfig)

    def validate(self) -> None:
        check_int_or_auto("config", train_batch_size=self.train_batch_size,
                          train_micro_batch_size_per_gpu=(
                              self.train_micro_batch_size_per_gpu),
                          gradient_accumulation_steps=(
                              self.gradient_accumulation_steps))
        if self.fp16.enabled is True and self.bf16.enabled is True:
            # bf16 defaults on; explicit fp16 wins (the reference's rule)
            self.bf16.enabled = False

    def check_supported(self) -> None:
        """Raise ``NotImplementedError`` for every key this slice does not
        run that is set to other than its default, and the reference's
        ``ConfigError`` for the offload combinations it rejects."""
        self._check_offload()
        default = DeepSpeedTPUConfig()
        for key, item in _LATER.items():
            if getattr(self, key) != getattr(default, key):
                raise NotImplementedError(
                    f"config key {key!r} is not ported yet; it arrives with "
                    f"ROADMAP.md {item}")
        self._check_training_sections()
        self._check_mesh()
        self._check_zero()

    def _check_mesh(self) -> None:
        """The data-parallel axes run; the others arrive with later parts
        of A13."""
        m = self.mesh
        for key in ("pipeline_parallel_size", "expert_parallel_size",
                    "sequence_parallel_size", "tensor_parallel_size"):
            if getattr(m, key) != 1:
                raise NotImplementedError(
                    f"mesh.{key}={getattr(m, key)}: pipeline, expert, "
                    "sequence and tensor parallelism arrive with later parts "
                    "of ROADMAP.md A13 (multi-GPU); this slice runs the "
                    "data-parallel axes (data_parallel_size, fsdp_size)")

    def _check_zero(self) -> None:
        """The reference engine's rejections of the wire-compression and
        qwZ combinations (``deepspeed_tpu/runtime/engine.py:302-353``),
        word for word.  Offload, ZenFlow and PEFT run at every stage (their
        own rejections are :meth:`_check_offload` and :meth:`check_peft`)."""
        zero = self.zero_optimization
        stage = zero.stage
        offload = self.optimizer_offloaded or self.param_offloaded
        if zero.zero_quantized_gradients:
            if offload:
                raise ConfigError(
                    "zero_quantized_gradients + offload_optimizer is not "
                    "supported yet (the offloaded grad step has no compressed-"
                    "reduction wiring)")
            if stage >= 3:
                raise ConfigError(
                    "zero_quantized_gradients requires stage <= 2 (params must "
                    "be replicated across the dp axes for the manual reduction)")
        if zero.zero_quantized_weights:
            if stage < 3:
                raise ConfigError(
                    "zero_quantized_weights (qwZ) requires stage 3 — below "
                    "stage 3 params are replicated and there is no weight "
                    "all-gather to quantize")
            if offload:
                raise ConfigError(
                    "zero_quantized_weights + offload_optimizer is not "
                    "supported")
        if self.gradient_compression.enabled:
            if offload:
                raise ConfigError(
                    "gradient_compression + offload_optimizer is not supported")
            if self.fp16.enabled is True:
                raise ConfigError(
                    "gradient_compression requires bf16/fp32: error-feedback "
                    "residuals live in the loss-scaled domain, so a dynamic "
                    "scale change (or one overflow poisoning them with NaN) "
                    "breaks the compensation — use bf16")
            if zero.zero_quantized_gradients:
                raise ConfigError(
                    "gradient_compression and zero_quantized_gradients are "
                    "both wire-compression schemes — enable one")
            if stage >= 3:
                raise ConfigError(
                    "gradient_compression requires stage <= 2 (params must be "
                    "replicated across the dp axes for the manual reduction)")

    @property
    def optimizer_offloaded(self) -> bool:
        off = self.zero_optimization.offload_optimizer
        return off is not None and off.device_str != "none"

    @property
    def param_offloaded(self) -> bool:
        off = self.zero_optimization.offload_param
        return off is not None and off.device_str != "none"

    def check_peft(self) -> None:
        """The reference engine's rejections of PEFT combinations
        (``deepspeed_tpu/runtime/engine.py:194-215``), word for word, for a
        config whose ``peft.lora`` is enabled or whose model tree already
        has LoRA nodes: offload, ZenFlow, ``gradient_compression`` and
        ``zero_quantized_weights``."""
        if self.optimizer_offloaded or self.param_offloaded:
            raise ConfigError(
                "peft.lora + offload_optimizer/offload_param is not "
                "supported: the host fp32 master-weight path cannot "
                "carry frozen quantized-code leaves, and adapter state "
                "is small enough to stay device-resident")
        if self.zenflow.enabled:
            raise ConfigError("peft.lora + zenflow is not supported "
                              "(zenflow is an offload schedule)")
        if self.gradient_compression.enabled:
            raise ConfigError(
                "peft.lora + gradient_compression is not supported: "
                "adapter gradients are tiny, wire compression would "
                "cost more in error-feedback state than it saves")
        if self.zero_optimization.zero_quantized_weights:
            raise ConfigError(
                "peft.lora + zero_quantized_weights is not supported "
                "(the frozen base is already stored quantized; qwZ "
                "would re-quantize the stage-3 gathers of int codes)")

    def _check_offload(self) -> None:
        """The reference engine's rejections of offload combinations
        (``deepspeed_tpu/runtime/engine.py``), word for word: PEFT with
        offload or ZenFlow (:meth:`check_peft`), fp16 with either offload,
        ZenFlow without the optimizer offload or with parameter offload."""
        off_o, off_p = self.optimizer_offloaded, self.param_offloaded
        if self.peft.lora.enabled:
            self.check_peft()
        fp16 = self.fp16.enabled is True
        if off_p and fp16:
            raise ConfigError(
                "fp16 + offload_param is not supported; use bf16")
        # parameters off the device imply the host optimizer
        offload = off_o or off_p
        if offload and fp16:
            raise ConfigError(
                "fp16 + offload_optimizer is not supported; use bf16")
        if self.zenflow.enabled and not offload:
            raise ConfigError(
                "zenflow requires offload_optimizer (it is a stall-free "
                "*offload* schedule; reference zenflow_stage_1_and_2.py)")
        if self.zenflow.enabled and off_p:
            raise ConfigError(
                "zenflow + offload_param is not supported (the hot-column "
                "scatter needs device-resident params)")

    def _check_training_sections(self) -> None:
        """Validate the A12 sections the port accepts, and refuse their
        options that arrive with later items."""
        ckpt = self.checkpoint
        if ckpt.engine == "orbax":
            raise NotImplementedError(
                "checkpoint.engine='orbax' is the multi-host checkpoint "
                "engine; it arrives with ROADMAP.md A13 (multi-GPU); use "
                "'native' or 'fast'")
        if ckpt.engine not in ("native", "fast"):
            raise ConfigError(f"checkpoint.engine must be native, fast or "
                              f"orbax, got {ckpt.engine!r}")
        if ckpt.load_universal:
            raise NotImplementedError(
                "checkpoint.load_universal (universal checkpoints) arrives "
                "with ROADMAP.md A14 (training periphery)")
        if ckpt.integrity not in ("none", "crc32", "sha256"):
            raise ConfigError(f"checkpoint.integrity must be none, crc32 or "
                              f"sha256, got {ckpt.integrity!r}")
        if ckpt.tag_validation.lower() not in ("ignore", "warn", "fail"):
            raise ConfigError(f"checkpoint.tag_validation must be Ignore, "
                              f"Warn or Fail, got {ckpt.tag_validation!r}")
        ac = self.activation_checkpointing
        if ac.partition_activations:
            raise NotImplementedError(
                "activation_checkpointing.partition_activations shards the "
                "saved residuals over tp/sp; it arrives with ROADMAP.md A13 "
                "(multi-GPU)")
        from .activation_checkpointing.checkpointing import POLICIES
        if ac.policy not in POLICIES:
            raise ConfigError(f"activation_checkpointing.policy "
                              f"{ac.policy!r} is not one of {sorted(POLICIES)}")
        from ..models.transformer import REMAT_POLICIES
        if self.remat.policy not in REMAT_POLICIES:
            raise ConfigError(f"remat.policy {self.remat.policy!r} is not one "
                              f"of {sorted(REMAT_POLICIES)}")
        if self.data_types.master_dtype not in ("float32", "bfloat16",
                                                "float16"):
            raise ConfigError(f"data_types.master_dtype must be a float "
                              f"dtype, got {self.data_types.master_dtype!r}")

    @property
    def compute_dtype(self) -> str:
        if self.fp16.enabled is True:
            return "float16"
        if self.bf16.enabled is True:
            return "bfloat16"
        return "float32"

    def resolve_batch_config(self, dp_world_size: int
                             ) -> "ResolvedBatchConfig":
        """Reference batch arithmetic (``runtime/config.py``
        _configure_train_batch_size): fill in any one unknown of
        (train_batch, micro_batch, gas)."""
        tb = None if is_auto(self.train_batch_size) else int(
            self.train_batch_size)
        mb = None if is_auto(self.train_micro_batch_size_per_gpu) else int(
            self.train_micro_batch_size_per_gpu)
        gas = None if is_auto(self.gradient_accumulation_steps) else int(
            self.gradient_accumulation_steps)

        if tb is not None and mb is not None and gas is not None:
            pass  # full specification; consistency-checked below
        elif tb is not None and mb is not None and gas is None:
            if tb % (mb * dp_world_size) != 0:
                raise ConfigError(
                    f"train_batch_size {tb} not divisible by micro_batch*dp "
                    f"({mb}*{dp_world_size})")
            gas = tb // (mb * dp_world_size)
        elif tb is not None and gas is not None and mb is None:
            if tb % (gas * dp_world_size) != 0:
                raise ConfigError(
                    f"train_batch_size {tb} not divisible by gas*dp "
                    f"({gas}*{dp_world_size})")
            mb = tb // (gas * dp_world_size)
        elif mb is not None:
            gas = gas or 1
            tb = mb * gas * dp_world_size
        elif tb is not None:
            gas = gas or 1
            if tb % (gas * dp_world_size) != 0:
                raise ConfigError(
                    f"train_batch_size {tb} not divisible by gas*dp "
                    f"({gas}*{dp_world_size})")
            mb = tb // (gas * dp_world_size)
        else:
            raise ConfigError(
                "need at least one of train_batch_size / "
                "train_micro_batch_size_per_gpu")

        if tb != mb * gas * dp_world_size:
            raise ConfigError(
                f"batch config inconsistent: {tb} != {mb} * {gas} * "
                f"{dp_world_size}")
        return ResolvedBatchConfig(train_batch_size=tb,
                                   micro_batch_size_per_device=mb,
                                   gradient_accumulation_steps=gas,
                                   dp_world_size=dp_world_size)


@dataclass
class ResolvedBatchConfig(DSConfigModel):
    train_batch_size: int
    micro_batch_size_per_device: int
    gradient_accumulation_steps: int
    dp_world_size: int


def load_config(config: Union[str, Dict[str, Any], DeepSpeedTPUConfig, None]
                ) -> DeepSpeedTPUConfig:
    """Accepts a path to a JSON file, a dict, an existing config, or
    None."""
    if config is None:
        return DeepSpeedTPUConfig()
    if isinstance(config, DeepSpeedTPUConfig):
        return config
    if isinstance(config, (str, os.PathLike)):
        path = os.fspath(config)
        if not os.path.exists(path):
            raise ConfigError(f"config file not found: {path}")
        with open(path) as f:
            config = json.load(f)
    if not isinstance(config, dict):
        raise ConfigError(f"unsupported config type: {type(config)}")
    return DeepSpeedTPUConfig.from_dict(config)
