"""fp16 loss scaling — the port of ``deepspeed_tpu/runtime/loss_scaler.py``.

The state is three 0-d tensors on the engine's device (f32 scale, i32
good-step count, i32 hysteresis), and every transition is tensor
arithmetic with ``torch.where``: the step never copies a flag to the host
to decide whether it overflowed, so an fp16 step makes no host sync.

Semantics are the reference's ``DynamicLossScaler.update_scale``: on an
overflow the hysteresis counts down and, when it reaches zero, the scale
halves (not under ``min_scale``) and the hysteresis refills; on a finite
step the good-step count grows and, after ``loss_scale_window`` of them,
the scale doubles; a finite step also refills the hysteresis.  A static
scale (``dynamic=False``) never moves.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch


class LossScaleState(NamedTuple):
    scale: torch.Tensor       # current loss scale (f32 scalar)
    good_steps: torch.Tensor  # consecutive overflow-free steps (i32)
    hysteresis: torch.Tensor  # remaining overflow tolerance (i32)


def init_loss_scale(initial_scale_power: int = 16, hysteresis: int = 2,
                    static_scale: float = 0.0,
                    device="cpu") -> LossScaleState:
    scale = static_scale if static_scale > 0 else float(
        2 ** initial_scale_power)
    return LossScaleState(
        scale=torch.tensor(scale, dtype=torch.float32, device=device),
        good_steps=torch.zeros((), dtype=torch.int32, device=device),
        hysteresis=torch.tensor(hysteresis, dtype=torch.int32,
                                device=device))


def grads_finite(grads: List[torch.Tensor]) -> torch.Tensor:
    """A 0-d bool tensor: every element of every gradient is finite."""
    if not grads:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(g).all() for g in grads]).all()


def update_loss_scale(state: LossScaleState, finite: torch.Tensor,
                      loss_scale_window: int = 1000, min_scale: float = 1.0,
                      hysteresis: int = 2, dynamic: bool = True,
                      scale_factor: float = 2.0) -> LossScaleState:
    """The dynamic transition (reference ``update_loss_scale``), on the
    device: both branches are computed and ``finite`` picks one."""
    if not dynamic:
        return state
    refill = torch.full_like(state.hysteresis, hysteresis)
    # overflow
    hys = state.hysteresis - 1
    drop = hys <= 0
    o_scale = torch.where(drop, torch.clamp(state.scale / scale_factor,
                                            min=min_scale), state.scale)
    o_hys = torch.where(drop, refill, hys)
    # finite
    good = state.good_steps + 1
    grow = good >= loss_scale_window
    g_scale = torch.where(grow, state.scale * scale_factor, state.scale)
    g_good = torch.where(grow, torch.zeros_like(good), good)
    return LossScaleState(
        scale=torch.where(finite, g_scale, o_scale),
        good_steps=torch.where(finite, g_good, torch.zeros_like(good)),
        hysteresis=torch.where(finite, refill, o_hys))


def scale_loss(loss: torch.Tensor, state: LossScaleState) -> torch.Tensor:
    return loss * state.scale.to(loss.dtype)


def unscale_grads(grads: List[torch.Tensor],
                  state: LossScaleState) -> List[torch.Tensor]:
    """f32 gradients times 1 / scale (in place where a gradient is f32
    already, as the engine's accumulators are)."""
    inv = (1.0 / state.scale).to(torch.float32)
    out = []
    for g in grads:
        if g.dtype == torch.float32:
            out.append(g.mul_(inv))
        else:
            out.append(g.float() * inv)
    return out
