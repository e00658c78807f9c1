"""deepspeed_tpu_torch — the PyTorch / CUDA (NVIDIA H100) port of
``deepspeed_tpu``.

The JAX package stays the reference; this package mirrors its layout path
for path (``ops/pallas/`` becomes ``ops/hopper/``) and imports neither JAX
nor anything of ``deepspeed_tpu``.  Slice 1 covers the v2 serving engine:

    from deepspeed_tpu_torch.models import transformer as tfm
    from deepspeed_tpu_torch.inference.v2.engine import InferenceEngineV2, V2Config

    cfg = tfm.get_config("llama3-8b")
    params = tfm.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    eng = InferenceEngineV2(cfg, params, V2Config())
    uid = eng.put(prompt_tokens, max_new_tokens=32)
    tokens = eng.generate_all()[uid]

Slice 3 serves the same engine weight-quantized (W8A16; ``quantize_bits``
4 and 6 give W4A16 and W6A16): the projections are quantized where the
weights lie, and only their codes and scales go to the card:

    eng = InferenceEngineV2(cfg, params, V2Config(quantize_bits=8))

Slice 4 serves MoE models on one device (capacity, dropless and PR-MoE
routing, ``moe/``); with ``moe_routing="dropless"`` each layer's experts
run as three grouped GEMMs (``ops/hopper/grouped_matmul.py``), and
``ops/fused_optimizers.py`` holds the fused AdamW entries:

    cfg = tfm.get_config("mixtral-8x7b", moe_routing="dropless", num_layers=16)
    params = tfm.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    eng = InferenceEngineV2(cfg, params, V2Config())

Slice 2 adds the training step:

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.runtime.engine import ModelSpec
    from deepspeed_tpu_torch.sequence.tiled_compute import tiled_loss_fn

    cfg = tfm.get_config("llama3-8b", num_layers=8, param_dtype="bfloat16",
                         attn_impl="flash")
    params = tfm.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                             dtype=tfm.param_dtype(cfg))
    spec = ModelSpec(loss_fn=lambda p, b, rng: tiled_loss_fn(p, b, cfg, 512),
                     params=params)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=spec, config={
        "train_micro_batch_size_per_gpu": 4,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-4}}})
    metrics = engine.train_batch({"input_ids": tokens})  # (4, S) int

Slice 10 serves through the memory hierarchy of the JAX package: the
prefix cache, the host pool, and the cold store a restarted engine
re-adopts; every ``step()`` records an ``engine/step`` span
(``observability/``):

    eng = InferenceEngineV2(cfg, params, V2Config(
        enable_prefix_cache=True, kv_host_pool_mb=64,
        kv_coldstore_dir="/var/cache/kv"))
    eng.rehydrate_coldstore()

Slice 12 adds the v1 engine (a static KV cache; it also serves the ALiBi
models the v2 engine refuses) and the BERT-family encoder, through the
reference's other entry point:

    eng = deepspeed_tpu_torch.init_inference(
        model_config=cfg, params=params, config={"dtype": "bfloat16"})
    tokens = eng.generate(prompts, max_new_tokens=32)  # (B, T + 32)

and the serving front over the v2 engine (``serving/``): ``python -m
deepspeed_tpu_torch.serving.server --model llama3-8b --dtype bfloat16``
answers OpenAI-style ``/v1/completions`` from in-process or subprocess
replicas.

Importing the package builds nothing and imports neither ``triton`` nor the
CUDA kernels; those are built from ``csrc/`` at their first launch.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, Optional, Tuple, Union

__version__ = "0.1.0"

# name -> (module, attribute): resolved on first access so that importing the
# package stays cheap and never touches CUDA
_LAZY = {
    "InferenceEngineV2": ("deepspeed_tpu_torch.inference.v2.engine",
                          "InferenceEngineV2"),
    "V2Config": ("deepspeed_tpu_torch.inference.v2.engine", "V2Config"),
    "ModelSpec": ("deepspeed_tpu_torch.runtime.engine", "ModelSpec"),
    "TrainingEngine": ("deepspeed_tpu_torch.runtime.engine",
                       "TrainingEngine"),
    "get_accelerator": ("deepspeed_tpu_torch.accelerator", "get_accelerator"),
    "resolve_device": ("deepspeed_tpu_torch.accelerator", "resolve_device"),
    "InferenceEngine": ("deepspeed_tpu_torch.inference.engine",
                        "InferenceEngine"),
    "EncoderInferenceEngine": ("deepspeed_tpu_torch.inference.engine",
                               "EncoderInferenceEngine"),
    "InferenceConfig": ("deepspeed_tpu_torch.inference.engine",
                        "InferenceConfig"),
}

__all__ = ["__version__", "initialize", "init_inference", *_LAZY]


def initialize(model: Any = None,
               config: Union[str, Dict, Any, None] = None,
               config_params: Union[str, Dict, None] = None,
               model_params: Any = None, param_axes: Any = None,
               loss_fn: Any = None, device: Any = "cuda", topo: Any = None,
               dist_init_required: Optional[bool] = None
               ) -> Tuple[Any, Any, None, Any]:
    """Create a training engine (reference: ``deepspeed_tpu.initialize``).
    Returns ``(engine, optimizer, None, lr_schedule)``.  ``model`` is a
    :class:`~deepspeed_tpu_torch.runtime.engine.ModelSpec`, or pass
    ``loss_fn`` and ``model_params``.  The engine runs on the card unless
    ``device="cpu"`` is asked for.

    A config that needs a data-parallel world (ZeRO stage 1-3, qgZ, 1-bit
    compression) or a torchrun environment (``$WORLD_SIZE``) sets up the
    ``torch.distributed`` world first (``comm.init_distributed``: NCCL on
    the card, gloo on the CPU; a world of one without the environment);
    ``dist_init_required`` forces that either way."""
    import os

    from . import comm
    from .runtime.config import load_config
    from .runtime.engine import ModelSpec, TrainingEngine

    cfg = load_config(config if config is not None else config_params)
    zero = cfg.zero_optimization
    if dist_init_required is None:
        dist_init_required = (zero.stage >= 1 or "WORLD_SIZE" in os.environ
                              or zero.zero_quantized_gradients
                              or cfg.gradient_compression.enabled)
    if dist_init_required:
        comm.init_distributed(device=device, verbose=False)
    if not isinstance(model, ModelSpec):
        if loss_fn is None or model_params is None:
            raise ValueError(
                "pass model=ModelSpec(...) or loss_fn= and model_params=")
        model = ModelSpec(loss_fn=loss_fn, params=model_params,
                          param_axes=param_axes)
    engine = TrainingEngine(model, cfg, device=device, topo=topo)
    return engine, engine.optimizer, None, engine.lr_schedule


def init_inference(model: Any = None, config: Any = None,
                   device: Any = "cuda", **kwargs: Any) -> Any:
    """The v1 inference engine (reference: ``deepspeed_tpu.init_inference``).

    Decoder models (``model_config=`` a ``TransformerConfig``, ``params=``)
    get :class:`~deepspeed_tpu_torch.inference.engine.InferenceEngine`;
    encoder configs (:class:`~deepspeed_tpu_torch.models.encoder.
    EncoderConfig`) get the bidirectional ``EncoderInferenceEngine``.
    Both run on the card unless ``device="cpu"`` is asked for."""
    from .models.encoder import EncoderConfig

    mc = kwargs.get("model_config")
    if isinstance(mc, EncoderConfig):
        from .inference.engine import EncoderInferenceEngine

        kwargs.pop("model_config")
        params = kwargs.pop("params", None)
        if params is None and model is not None and hasattr(model, "params"):
            params = model.params  # ModelSpec-style bundle, decoder parity
        if params is None:
            raise ValueError(
                "encoder inference needs the parameter tree: pass params= "
                "or a model bundle with .params")
        return EncoderInferenceEngine(mc, params, config=config,
                                      device=device, **kwargs)
    from .inference.engine import InferenceEngine

    return InferenceEngine(model=model, config=config, device=device,
                           **kwargs)


def __getattr__(name: str):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module, attr = _LAZY[name]
    return getattr(importlib.import_module(module), attr)
