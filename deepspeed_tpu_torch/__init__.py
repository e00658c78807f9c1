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

Importing the package builds nothing and imports neither ``triton`` nor the
CUDA kernels; those are built from ``csrc/`` at their first launch.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, Tuple, Union

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
}

__all__ = ["__version__", "initialize", *_LAZY]


def initialize(model: Any = None,
               config: Union[str, Dict, Any, None] = None,
               config_params: Union[str, Dict, None] = None,
               model_params: Any = None, param_axes: Any = None,
               loss_fn: Any = None, device: Any = "cuda"
               ) -> Tuple[Any, Any, None, Any]:
    """Create a training engine (reference: ``deepspeed_tpu.initialize``).
    Returns ``(engine, optimizer, None, lr_schedule)``.  ``model`` is a
    :class:`~deepspeed_tpu_torch.runtime.engine.ModelSpec`, or pass
    ``loss_fn`` and ``model_params``.  The engine runs on the card unless
    ``device="cpu"`` is asked for."""
    from .runtime.config import load_config
    from .runtime.engine import ModelSpec, TrainingEngine

    cfg = load_config(config if config is not None else config_params)
    if not isinstance(model, ModelSpec):
        if loss_fn is None or model_params is None:
            raise ValueError(
                "pass model=ModelSpec(...) or loss_fn= and model_params=")
        model = ModelSpec(loss_fn=loss_fn, params=model_params,
                          param_axes=param_axes)
    engine = TrainingEngine(model, cfg, device=device)
    return engine, engine.optimizer, None, engine.lr_schedule


def __getattr__(name: str):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module, attr = _LAZY[name]
    return getattr(importlib.import_module(module), attr)
