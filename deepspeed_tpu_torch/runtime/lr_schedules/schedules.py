"""LR schedules — the port of
``deepspeed_tpu/runtime/lr_schedules/schedules.py``: WarmupLR,
WarmupDecayLR, WarmupCosineLR, OneCycle, LRRangeTest and constant, each a
function of the step count (the reference's are ``jnp`` functions traced
into the jitted update; the formulas are the same).

A step given as an int gives a Python float.  A step given as a 0-d
tensor (the fp16 engine's count of applied updates, which stays on the
device so that a skipped step needs no host sync) gives a 0-d f32 tensor
on its device: the same formulas in torch, both sides of each branch
computed and one selected."""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

from ..config import SchedulerConfig
from ..config_utils import ConfigError

Schedule = Callable[[int], float]


def _step(step):
    return step.float() if isinstance(step, torch.Tensor) else float(step)


def _clip(x, lo: float, hi: float):
    if isinstance(x, torch.Tensor):
        return torch.clamp(x, lo, hi)
    return min(max(x, lo), hi)


def _max(x, lo: float):
    return torch.clamp(x, min=lo) if isinstance(x, torch.Tensor) \
        else max(x, lo)


def _fn(name: str, x):
    return getattr(torch, name)(x) if isinstance(x, torch.Tensor) \
        else getattr(math, name)(x)


def _where(cond, if_true: Callable, if_false: Callable):
    """``if_true()`` where ``cond`` holds, else ``if_false()``: a Python
    branch for a bool, ``torch.where`` over both for a tensor."""
    if isinstance(cond, torch.Tensor):
        a, b = if_true(), if_false()
        return torch.where(cond, torch.as_tensor(a, device=cond.device),
                           torch.as_tensor(b, device=cond.device))
    return if_true() if cond else if_false()


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
              warmup_num_steps: int = 1000, warmup_type: str = "log",
              **_) -> Schedule:
    """Reference WarmupLR: warm from min to max, then hold."""

    def sched(step):
        step = _step(step)
        if warmup_type == "log":
            denom = math.log(max(warmup_num_steps, 2))
            frac = _clip(_fn("log", step + 1.0) / denom, 0.0, 1.0)
        else:
            frac = _clip(step / max(warmup_num_steps, 1), 0.0, 1.0)
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * frac

    return sched


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 0.001,
                    warmup_num_steps: int = 1000,
                    warmup_type: str = "linear", **_) -> Schedule:
    """Warmup, then linear decay to 0 over ``total_num_steps``."""
    warm = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps,
                     warmup_type)

    def sched(step):
        step = _step(step)
        return _where(step < warmup_num_steps, lambda: warm(step),
                      lambda: warmup_max_lr * _clip(
                          (total_num_steps - step)
                          / max(total_num_steps - warmup_num_steps, 1),
                          0.0, 1.0))

    return sched


def warmup_cosine_lr(total_num_steps: int, warmup_min_ratio: float = 0.0,
                     warmup_num_steps: int = 1000,
                     cos_min_ratio: float = 0.0001,
                     warmup_max_lr: float = 0.001, **_) -> Schedule:

    def warm(step):
        return warmup_min_ratio + (1 - warmup_min_ratio) * _clip(
            step / max(warmup_num_steps, 1), 0.0, 1.0)

    def cosine(step):
        prog = _clip((step - warmup_num_steps)
                     / max(total_num_steps - warmup_num_steps, 1), 0.0, 1.0)
        return cos_min_ratio + (1 - cos_min_ratio) * 0.5 * (
            1 + _fn("cos", math.pi * prog))

    def sched(step):
        step = _step(step)
        return warmup_max_lr * _where(step < warmup_num_steps,
                                      lambda: warm(step),
                                      lambda: cosine(step))

    return sched


def one_cycle(cycle_min_lr: float, cycle_max_lr: float,
              cycle_first_step_size: int = 2000,
              cycle_second_step_size: int = None, decay_step_size: int = 0,
              decay_lr_rate: float = 0.0, **_) -> Schedule:
    """Reference OneCycle: an lr triangle, then an optional decay."""
    second = cycle_second_step_size or cycle_first_step_size
    total = cycle_first_step_size + second

    def sched(step):
        step = _step(step)
        in_cycle = _where(
            step < cycle_first_step_size,
            lambda: cycle_min_lr + (cycle_max_lr - cycle_min_lr) * (
                step / cycle_first_step_size),
            lambda: _max(cycle_max_lr - (cycle_max_lr - cycle_min_lr) * (
                (step - cycle_first_step_size) / second), cycle_min_lr))
        if decay_step_size > 0:
            return _where(step > total, lambda: _max(cycle_min_lr * (
                decay_lr_rate ** ((step - total) / decay_step_size)), 0.0),
                lambda: in_cycle)
        return in_cycle

    return sched


def lr_range_test(lr_range_test_min_lr: float = 1e-3,
                  lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False, **_) -> Schedule:

    def sched(step):
        interval = _step(step) / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = _fn("floor", interval)
        return lr_range_test_min_lr * (1 + interval * lr_range_test_step_rate)

    return sched


def constant(lr: float = 0.001, **_) -> Schedule:
    def sched(step):
        return lr

    return sched


SCHEDULES: Dict[str, Callable[..., Schedule]] = {
    "warmuplr": warmup_lr,
    "warmupdecaylr": warmup_decay_lr,
    "warmupcosinelr": warmup_cosine_lr,
    "onecycle": one_cycle,
    "lrrangetest": lr_range_test,
    "constant": constant,
}


def create_scheduler(cfg: SchedulerConfig, base_lr: float = 0.001
                     ) -> Schedule:
    if cfg.type is None:
        return constant(lr=base_lr)
    key = cfg.type.lower().replace("_", "")
    if key not in SCHEDULES:
        raise ConfigError(f"unknown scheduler {cfg.type!r}; have "
                          f"{sorted(SCHEDULES)}")
    params = dict(cfg.params)
    # reference convention: WarmupLR defaults max lr to optimizer lr
    if key.startswith("warmup"):
        params.setdefault("warmup_max_lr", base_lr)
    return SCHEDULES[key](**params)
