"""Monitoring sinks — the port of ``deepspeed_tpu/monitor/monitor.py``.

Capability analogue of the reference's ``deepspeed/monitor/`` (``Monitor``
ABC monitor.py:13, ``MonitorMaster:30``, tensorboard/wandb/csv/comet sinks).
Events are ``(name, value, step)`` tuples written from the engine each step.
"""

from __future__ import annotations

import csv
import os
from typing import List, Optional, Tuple

from ..utils.logging import logger

Event = Tuple[str, float, int]


class Monitor:
    enabled = False

    def write_events(self, events: List[Event]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        """Release sink resources (file handles, writers, sessions).
        Idempotent; called from engine/server/broker shutdown paths."""


class CSVMonitor(Monitor):
    """Reference: ``monitor/csv_monitor.py``."""

    def __init__(self, output_path: str, job_name: str = "job"):
        self.enabled = True
        self.dir = os.path.join(output_path, job_name)
        os.makedirs(self.dir, exist_ok=True)
        self._files = {}  # metric name -> (handle, csv.writer), kept open

    def _writer(self, name: str):
        if name not in self._files:
            fname = os.path.join(self.dir, name.replace("/", "_") + ".csv")
            new = not os.path.exists(fname)
            f = open(fname, "a", newline="")
            w = csv.writer(f)
            if new:
                w.writerow(["step", name])
            self._files[name] = (f, w)
        return self._files[name]

    def write_events(self, events: List[Event]) -> None:
        for name, value, step in events:
            f, w = self._writer(name)
            w.writerow([step, value])
        for f, _ in self._files.values():
            f.flush()

    def close(self) -> None:
        for f, _ in self._files.values():
            try:
                f.close()
            except Exception:  # pragma: no cover
                pass
        self._files.clear()


class TensorBoardMonitor(Monitor):
    def __init__(self, output_path: str, job_name: str = "job"):
        try:
            from torch.utils.tensorboard import SummaryWriter  # cpu torch is baked in

            self.writer = SummaryWriter(log_dir=os.path.join(output_path, job_name))
            self.enabled = True
        except Exception as e:  # pragma: no cover
            logger.warning(f"tensorboard unavailable: {e}")
            self.enabled = False

    def write_events(self, events: List[Event]) -> None:
        if not self.enabled:
            return
        for name, value, step in events:
            self.writer.add_scalar(name, value, step)
        self.writer.flush()

    def close(self) -> None:
        if self.enabled:
            self.writer.close()
            self.enabled = False


class WandbMonitor(Monitor):  # pragma: no cover - needs network
    def __init__(self, team=None, group=None, project=None, job_name="job"):
        try:
            import wandb

            wandb.init(entity=team, group=group, project=project, name=job_name)
            self.wandb = wandb
            self.enabled = True
        except Exception as e:
            logger.warning(f"wandb unavailable: {e}")
            self.enabled = False

    def write_events(self, events: List[Event]) -> None:
        if not self.enabled:
            return
        for name, value, step in events:
            self.wandb.log({name: value}, step=step)

    def close(self) -> None:
        if self.enabled:
            self.wandb.finish()
            self.enabled = False


class CometMonitor(Monitor):  # pragma: no cover - needs network
    """Reference ``monitor/comet.py``: events forwarded to a comet_ml
    Experiment.  Import-guarded like wandb — absent SDK degrades to off."""

    def __init__(self, project=None, job_name="job", **kwargs):
        try:
            import comet_ml

            self.experiment = comet_ml.Experiment(project_name=project,
                                                  **kwargs)
            self.experiment.set_name(job_name)
            self.enabled = True
        except Exception as e:
            logger.warning(f"comet_ml unavailable: {e}")
            self.enabled = False

    def write_events(self, events: List[Event]) -> None:
        if not self.enabled:
            return
        for name, value, step in events:
            self.experiment.log_metric(name, value, step=step)

    def close(self) -> None:
        if self.enabled:
            self.experiment.end()
            self.enabled = False


def _process_index() -> int:
    """This process's ``torch.distributed`` rank; 0 without a process
    group (the reference's ``jax.process_index()``)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class MonitorMaster(Monitor):
    """Fan-out to all enabled sinks; only process 0 writes (reference
    MonitorMaster rank gating)."""

    def __init__(self, config):
        self.monitors: List[Monitor] = []
        self.enabled = False
        if _process_index() != 0:
            return
        tb, wb, cv = config.tensorboard, config.wandb, config.csv_monitor
        if tb.enabled:
            self.monitors.append(TensorBoardMonitor(tb.output_path or "./runs",
                                                    tb.job_name))
        if wb.enabled:
            self.monitors.append(WandbMonitor(wb.team, wb.group, wb.project,
                                              wb.job_name))
        cm = getattr(config, "comet", None)
        if cm is not None and cm.enabled:
            self.monitors.append(CometMonitor(cm.project, cm.job_name))
        if cv.enabled:
            self.monitors.append(CSVMonitor(cv.output_path or "./csv_logs",
                                            cv.job_name))
        self.enabled = any(m.enabled for m in self.monitors)

    def write_events(self, events: List[Event]) -> None:
        for m in self.monitors:
            if m.enabled:
                m.write_events(events)

    def close(self) -> None:
        for m in self.monitors:
            try:
                m.close()
            except Exception as e:  # pragma: no cover
                logger.warning(f"monitor close failed: {e}")
        self.enabled = False
