"""LR schedules — the port of
``deepspeed_tpu/runtime/lr_schedules/schedules.py``: WarmupLR,
WarmupDecayLR, WarmupCosineLR, OneCycle, LRRangeTest and constant, each a
plain Python function of the step count (the reference's are ``jnp``
functions traced into the jitted update; the formulas are the same)."""

from __future__ import annotations

import math
from typing import Callable, Dict

from ..config import SchedulerConfig
from ..config_utils import ConfigError

Schedule = Callable[[int], float]


def _clip(x: float, lo: float, hi: float) -> float:
    return min(max(x, lo), hi)


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
              warmup_num_steps: int = 1000, warmup_type: str = "log",
              **_) -> Schedule:
    """Reference WarmupLR: warm from min to max, then hold."""

    def sched(step):
        step = float(step)
        if warmup_type == "log":
            denom = math.log(max(warmup_num_steps, 2))
            frac = _clip(math.log(step + 1.0) / denom, 0.0, 1.0)
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
        step = float(step)
        if step < warmup_num_steps:
            return warm(step)
        decay = _clip((total_num_steps - step)
                      / max(total_num_steps - warmup_num_steps, 1), 0.0, 1.0)
        return warmup_max_lr * decay

    return sched


def warmup_cosine_lr(total_num_steps: int, warmup_min_ratio: float = 0.0,
                     warmup_num_steps: int = 1000,
                     cos_min_ratio: float = 0.0001,
                     warmup_max_lr: float = 0.001, **_) -> Schedule:

    def sched(step):
        step = float(step)
        if step < warmup_num_steps:
            ratio = warmup_min_ratio + (1 - warmup_min_ratio) * _clip(
                step / max(warmup_num_steps, 1), 0.0, 1.0)
        else:
            prog = _clip((step - warmup_num_steps)
                         / max(total_num_steps - warmup_num_steps, 1),
                         0.0, 1.0)
            ratio = cos_min_ratio + (1 - cos_min_ratio) * 0.5 * (
                1 + math.cos(math.pi * prog))
        return warmup_max_lr * ratio

    return sched


def one_cycle(cycle_min_lr: float, cycle_max_lr: float,
              cycle_first_step_size: int = 2000,
              cycle_second_step_size: int = None, decay_step_size: int = 0,
              decay_lr_rate: float = 0.0, **_) -> Schedule:
    """Reference OneCycle: an lr triangle, then an optional decay."""
    second = cycle_second_step_size or cycle_first_step_size
    total = cycle_first_step_size + second

    def sched(step):
        step = float(step)
        if step < cycle_first_step_size:
            in_cycle = cycle_min_lr + (cycle_max_lr - cycle_min_lr) * (
                step / cycle_first_step_size)
        else:
            in_cycle = max(cycle_max_lr - (cycle_max_lr - cycle_min_lr) * (
                (step - cycle_first_step_size) / second), cycle_min_lr)
        if decay_step_size > 0 and step > total:
            return max(cycle_min_lr * (decay_lr_rate ** (
                (step - total) / decay_step_size)), 0.0)
        return in_cycle

    return sched


def lr_range_test(lr_range_test_min_lr: float = 1e-3,
                  lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False, **_) -> Schedule:

    def sched(step):
        interval = float(step) / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = math.floor(interval)
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
