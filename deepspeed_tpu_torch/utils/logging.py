"""The package logger and ``warning_once`` — the part of
``deepspeed_tpu/utils/logging.py`` the port's host modules use (the
rank-filtered ``log_dist`` arrives with the multi-GPU slice, ROADMAP.md
queue A item A13)."""

from __future__ import annotations

import functools
import logging
import sys

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


def warning_once(message: str) -> None:
    _warning_once_impl(message)


@functools.lru_cache(None)
def _warning_once_impl(message: str) -> None:
    logger.warning(message)
