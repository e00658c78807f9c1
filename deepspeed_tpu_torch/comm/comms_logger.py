"""Comms logger — the port of ``deepspeed_tpu/comm/comms_logger.py``.

Per-op counts and message volumes keyed ``"{op}@{axis_name}"``, with the
reference's printable summary.  The reference records at trace time
(static counts of the collectives in a compiled program); the port's
collectives are eager, so :meth:`CommsLogger.record` runs at every call
and the counts are the calls this process made.  ``record_timed`` takes
wall-clock timings from a benchmark, as the reference's does.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Sequence

from ..observability.trace import tracer
from ..utils.logging import log_dist


def _nbytes(x) -> int:
    try:
        return int(x.numel()) * x.element_size()
    except Exception:
        return 0


class OpRecord:
    __slots__ = ("count", "total_bytes", "total_time_s")

    def __init__(self):
        self.count = 0
        self.total_bytes = 0
        self.total_time_s = 0.0


class CommsLogger:
    def __init__(self):
        self.enabled = False
        self.verbose = False
        self.prof_all = True
        self.prof_ops: List[str] = []
        self.stats: Dict[str, OpRecord] = collections.defaultdict(OpRecord)

    def configure(self, enabled: Optional[bool] = None, verbose: Optional[bool] = None,
                  prof_all: Optional[bool] = None,
                  prof_ops: Optional[Sequence[str]] = None) -> None:
        if enabled is not None:
            self.enabled = enabled
        if verbose is not None:
            self.verbose = verbose
        if prof_all is not None:
            self.prof_all = prof_all
        if prof_ops is not None:
            self.prof_ops = list(prof_ops)

    def _should_record(self, op: str) -> bool:
        return self.prof_all or op in self.prof_ops

    def record(self, op: str, x, axis_name) -> None:
        """Called by every collective of the facade with its input."""
        if not self._should_record(op):
            return
        key = f"{op}@{axis_name}"
        rec = self.stats[key]
        rec.count += 1
        rec.total_bytes += _nbytes(x)
        if self.verbose:
            log_dist(f"comm: {key} bytes={_nbytes(x)}")

    def record_timed(self, op: str, nbytes: int, seconds: float) -> None:
        """Called by eager benchmarks with real wall-clock timings."""
        if not self._should_record(op):
            return
        rec = self.stats[op]
        rec.count += 1
        rec.total_bytes += nbytes
        rec.total_time_s += seconds
        # retroactive span: the op just finished, `seconds` ago → now
        now = time.monotonic()
        tracer.add_span(f"comm/{op}", now - seconds, now,
                        attrs={"bytes": nbytes})

    def reset(self) -> None:
        self.stats.clear()

    def counts(self) -> Dict[str, int]:
        """``{"{op}@{axis}": calls}`` so far."""
        return {k: r.count for k, r in self.stats.items()}

    def log_summary(self) -> str:
        """Reference: ``comm/comm.py:439 log_summary`` — size-binned table."""
        lines = [f"{'op':<32}{'count':>8}{'total MB':>12}{'time ms':>10}{'algbw GB/s':>12}"]
        for name in sorted(self.stats):
            rec = self.stats[name]
            mb = rec.total_bytes / 2**20
            ms = rec.total_time_s * 1e3
            bw = (rec.total_bytes / rec.total_time_s / 2**30) if rec.total_time_s else 0.0
            lines.append(f"{name:<32}{rec.count:>8}{mb:>12.2f}{ms:>10.2f}{bw:>12.2f}")
        out = "\n".join(lines)
        log_dist("comms summary:\n" + out)
        return out
