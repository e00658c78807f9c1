"""Optimizer factory — the port of ``deepspeed_tpu/runtime/optimizers.py``
for Adam and AdamW.

The reference builds optax transformations; the port writes the same
formulas out in plain torch, updating in place to save memory:

- moments mu and nu are f32 whatever the parameter dtype (the reference
  feeds f32 grads to optax, which promotes them, and casts fresh state to
  that dtype, ``engine.py:652-683``);
- mu <- b1 mu + (1 - b1) g, nu <- b2 nu + (1 - b2) g^2, bias correction
  with count + 1, eps outside the square root (``optax.scale_by_adam``);
- AdamW adds ``weight_decay * p`` (in p's dtype) to the update under the
  decay mask (``optax.add_decayed_weights``); Adam with
  ``adam_w_mode=False`` adds it to the gradient instead (classic L2);
- the update is scaled by -lr(count) and added to each parameter in f32,
  which is rounded into the parameter's dtype once (``optax.apply_updates``).

``torch.optim.AdamW`` keeps its moments in the parameter dtype, so it is
not used.  Other optimizer types raise, naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Union

import torch

from .config import OptimizerConfig
from .config_utils import ConfigError

Schedule = Union[float, Callable[[int], float]]

_LATER = ("lamb", "fusedlamb", "lion", "fusedlion", "sgd", "adagrad",
          "adafactor", "muon", "onebitadam", "zerooneadam", "onebitlamb")


def leaves(tree: Any) -> List[Any]:
    """The leaves of a nested-dict tree, in key order."""
    if isinstance(tree, dict):
        return [x for key in tree for x in leaves(tree[key])]
    return [tree]


def default_weight_decay_mask(params: Any) -> Any:
    """Decay matrices; skip norms, biases and scales (the reference's
    rule, on the same nested-dict layout)."""

    def build(node, path):
        if isinstance(node, dict):
            return {k: build(v, f"{path}/{k}") for k, v in node.items()}
        name = path.lower()
        if any(s in name for s in ("ln", "norm", "bias", "scale")):
            return False
        return getattr(node, "ndim", 0) >= 2

    return build(params, "")


class Adam:
    """Adam / AdamW over a list of parameter tensors, optax's arithmetic.

    ``step(params, grads)`` takes f32 gradients aligned with ``params`` and
    updates the parameters and the f32 moments in place."""

    def __init__(self, learning_rate: Schedule, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, decoupled: bool = True,
                 mask: Optional[List[bool]] = None):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.decoupled = decoupled
        self.mask = mask
        self.count = 0
        self.mu: List[torch.Tensor] = []
        self.nu: List[torch.Tensor] = []

    def init(self, params: List[torch.Tensor]) -> None:
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        if self.mask is None:
            self.mask = [True] * len(params)

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count) if callable(lr) else lr)

    @torch.no_grad()
    def step(self, params: List[torch.Tensor],
             grads: List[torch.Tensor]) -> None:
        b1, b2, wd = self.b1, self.b2, self.weight_decay
        count = self.count + 1
        bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
        lr = self.lr(self.count)
        for p, g, mu, nu, decay in zip(params, grads, self.mu, self.nu,
                                       self.mask):
            if wd and decay and not self.decoupled:
                g = g + (p * wd).float()
            mu.mul_(b1).add_(g, alpha=1.0 - b1)
            nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            upd = (nu / bc2).sqrt_().add_(self.eps)
            upd = torch.div(mu / bc1, upd, out=upd)
            if wd and decay and self.decoupled:
                upd.add_((p * wd).float())
            upd.mul_(-lr).add_(p)  # p + u in f32, rounded once below
            p.copy_(upd)
        self.count = count


def create_optimizer(cfg: OptimizerConfig, learning_rate: Schedule,
                     weight_decay_mask: Optional[List[bool]] = None) -> Adam:
    """The base optimizer from config (reference: ``create_optimizer``)."""
    name = cfg.type.lower().replace("_", "")
    p = cfg.params
    wd = p.get("weight_decay", 0.0)
    betas = p.get("betas", (0.9, 0.999))
    kw = dict(b1=betas[0], b2=betas[1], eps=p.get("eps", 1e-8),
              mask=weight_decay_mask)
    if name in ("adam", "fusedadam", "cpuadam"):
        decoupled = bool(p.get("adam_w_mode", True))
        return Adam(learning_rate, weight_decay=wd, decoupled=decoupled, **kw)
    if name in ("adamw", "fusedadamw"):
        return Adam(learning_rate, weight_decay=wd, decoupled=True, **kw)
    if name in _LATER:
        raise NotImplementedError(
            f"optimizer {cfg.type!r} is not ported yet; the optimizers "
            "beyond Adam/AdamW arrive with ROADMAP.md A12")
    raise ConfigError(f"unknown optimizer type {cfg.type!r}")


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, f32, on the device."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t.float()) for t in tensors]))


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], norm: torch.Tensor,
                        max_norm: float) -> None:
    """``optax.clip_by_global_norm`` in place: g / norm * max_norm where
    norm >= max_norm, g untouched otherwise (no host sync)."""
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))

