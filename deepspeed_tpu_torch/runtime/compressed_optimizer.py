"""Error-compensated compressed-gradient optimizer (1-bit Adam) on one
device — the port of ``deepspeed_tpu/runtime/compressed_optimizer.py``.

The reference's ``onebit_adam`` is an optax chain:

1. ``error_feedback_compression(freeze_step)``: once ``freeze_step`` steps
   have run, each gradient g becomes its 1-bit reconstruction
   q = sign(c) mean(|c|) of c = g + r, and the residual r <- c - q carries
   the error into the next step (before that, g passes unchanged);
2. ``scale_by_adam_freezable``: Adam whose second moment and its bias
   correction freeze after ``freeze_step`` steps (sign-compressed
   gradients carry no magnitude);
3. decoupled weight decay under the mask, when ``weight_decay`` is set;
4. -lr(count).

The port runs the same arithmetic in place, with f32 residuals and
moments, and names its state with the chain's optax paths
(``0/residual/...``, ``0/step``, ``1/count``, ``1/mu/...``, ``1/nu/...``,
then the schedule's count), so checkpoints cross packages.  With
``compress_gradients=False`` (the engine compresses the gradient on the
data-parallel wire, ``gradient_compression``, ``ops/onebit.py``) the first
stage is dropped, as in the reference: compressing twice would square the
error, and the state paths shift down by one.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from .optimizers import Optimizer, Schedule, _apply, _decay, _zeros


def compress_decompress(g: torch.Tensor) -> torch.Tensor:
    """The 1-bit round trip of one tensor: sign(g) * mean(|g|)."""
    return torch.sign(g) * g.abs().mean()


class OneBitAdam(Optimizer):
    """The reference's ``onebit_adam``."""

    def __init__(self, learning_rate: Schedule, weight_decay: float = 0.0,
                 freeze_step: int = 100, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, mask: Optional[List[bool]] = None,
                 compress_gradients: bool = True):
        super().__init__(learning_rate)
        self.compress_gradients = compress_gradients
        self.weight_decay, self.freeze_step = weight_decay, freeze_step
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mask = mask
        self.residual: List[torch.Tensor] = []
        self.mu: List[torch.Tensor] = []
        self.nu: List[torch.Tensor] = []

    def init(self, params) -> None:
        self.count = 0
        self.mu, self.nu = _zeros(params), _zeros(params)
        self.residual = _zeros(params) if self.compress_gradients else []
        if self.mask is None:
            self.mask = [True] * len(params)

    def _state(self):
        # the compression stage's step and Adam's count are separate
        # leaves in the reference, always equal: both advance every update
        first = 1 if self.compress_gradients else 0
        sched = first + (2 if self.weight_decay else 1)
        state = {f"{first}/count": self.count, f"{first}/mu/{{}}": self.mu,
                 f"{first}/nu/{{}}": self.nu, f"{sched}/count": self.count}
        if self.compress_gradients:
            state = {"0/residual/{}": self.residual, "0/step": self.count,
                     **state}
        return state

    def _update(self, i, p, g, count, lr) -> None:
        b1, b2, fs = self.b1, self.b2, self.freeze_step
        mu, nu = self.mu[i], self.nu[i]
        r = self.residual[i] if self.compress_gradients else None
        if r is None:
            frozen = count + 1 > fs
            c2 = 1.0 - b2 ** (torch.clamp(count + 1, max=fs)
                              if isinstance(count, torch.Tensor)
                              else min(count + 1, fs))
        elif isinstance(count, torch.Tensor):  # the fp16 engine's device count
            corrected = g + r
            q = compress_decompress(corrected)
            compress = count >= fs
            g = torch.where(compress, q, g)
            r.copy_(torch.where(compress, corrected - q, r))
            frozen = count + 1 > fs
            c2 = 1.0 - b2 ** torch.clamp(count + 1, max=fs)
        else:
            if count >= fs:  # error feedback from the freeze step on
                corrected = g + r
                g = compress_decompress(corrected)
                r.copy_(corrected - g)
            frozen = count + 1 > fs
            c2 = 1.0 - b2 ** min(count + 1, fs)
        c1 = 1.0 - b1 ** (count + 1)
        mu.mul_(b1).add_(g, alpha=1.0 - b1)
        grown = nu * b2 + g * g * (1.0 - b2)
        nu.copy_(torch.where(torch.as_tensor(frozen, device=nu.device), nu,
                             grown))
        upd = (nu / c2).sqrt_().add_(self.eps)
        upd = torch.div(mu / c1, upd, out=upd)
        if self.weight_decay and self.mask[i]:
            _decay(upd, p, self.weight_decay)
        _apply(p, upd, -lr)
