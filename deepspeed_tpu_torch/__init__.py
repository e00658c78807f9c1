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

Importing the package builds nothing and imports neither ``triton`` nor the
CUDA kernels; those are built from ``csrc/`` at their first launch.
"""

from __future__ import annotations

import importlib

__version__ = "0.1.0"

# name -> (module, attribute): resolved on first access so that importing the
# package stays cheap and never touches CUDA
_LAZY = {
    "InferenceEngineV2": ("deepspeed_tpu_torch.inference.v2.engine",
                          "InferenceEngineV2"),
    "V2Config": ("deepspeed_tpu_torch.inference.v2.engine", "V2Config"),
    "get_accelerator": ("deepspeed_tpu_torch.accelerator", "get_accelerator"),
    "resolve_device": ("deepspeed_tpu_torch.accelerator", "resolve_device"),
}

__all__ = ["__version__", *_LAZY]


def __getattr__(name: str):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module, attr = _LAZY[name]
    return getattr(importlib.import_module(module), attr)
