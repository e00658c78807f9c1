"""Rank-aware logging — the port of ``deepspeed_tpu/utils/logging.py``:
the package logger, ``warning_once``, the rank-filtered ``log_dist``
(ranks from ``torch.distributed``, where the reference reads
``jax.process_index()``) and the per-request ``request_logger`` the
serving stack tags its lines with."""

from __future__ import annotations

import functools
import logging
import os
import sys
from typing import Iterable, Optional

LOG_FORMAT = "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"


# not "deepspeed_tpu_torch": the port's modules log through
# ``logging.getLogger(__name__)``, and a handler on their parent would
# route all of their records to stdout
@functools.lru_cache(None)
def _create_logger(name: str = "dstpu_torch",
                   level: int = logging.INFO) -> logging.Logger:
    lg = logging.getLogger(name)
    lg.setLevel(level)
    lg.propagate = False
    handler = logging.StreamHandler(stream=sys.stdout)
    handler.setFormatter(logging.Formatter(LOG_FORMAT))
    lg.addHandler(handler)
    return lg


logger = _create_logger()


def _process_index() -> int:
    """This process's ``torch.distributed`` rank; without a process
    group, ``$RANK`` (0 when unset)."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
    except Exception:
        pass
    return int(os.environ.get("RANK", 0))


def log_dist(message: str, ranks: Optional[Iterable[int]] = None,
             level: int = logging.INFO) -> None:
    """Log ``message`` only on the given process ranks (default: rank 0).

    ``ranks=[-1]`` logs on every process.
    """
    ranks = list(ranks) if ranks is not None else [0]
    me = _process_index()
    if -1 in ranks or me in ranks:
        logger.log(level, f"[Rank {me}] {message}")


def should_log_le(max_log_level: str) -> bool:
    mapping = logging.getLevelNamesMapping()
    wanted = mapping.get(max_log_level.upper())
    if wanted is None:
        raise ValueError(f"invalid log level: {max_log_level!r}")
    return logger.getEffectiveLevel() <= wanted


class _RequestLogAdapter(logging.LoggerAdapter):
    """Prefixes every line with ``[rid=... uid=...]`` so one request's log
    lines can be grepped across broker / balancer / engine threads."""

    def process(self, msg, kwargs):
        rid = self.extra.get("rid")
        uid = self.extra.get("uid")
        tag = f"[rid={rid}]" if not uid else f"[rid={rid} uid={uid}]"
        return f"{tag} {msg}", kwargs


def request_logger(rid: str, uid: Optional[str] = None
                   ) -> logging.LoggerAdapter:
    """Logger whose lines carry the request id (and user id when known)."""
    return _RequestLogAdapter(logger, {"rid": rid, "uid": uid})


def warning_once(message: str) -> None:
    _warning_once_impl(message)


@functools.lru_cache(None)
def _warning_once_impl(message: str) -> None:
    logger.warning(message)
