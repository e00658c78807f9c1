"""Shared backoff policies for every retry loop (the port of
``deepspeed_tpu/utils/backoff.py``).

Three subsystems grew the same two shapes independently — the replica
supervisor's respawn delay, the balancer's failover retry, and the
elastic agent's relaunch pacing.  They live here now so the semantics
(and the off-by-one conventions) stay identical everywhere:

* :func:`exponential_backoff` — deterministic ``base * 2**(attempt-1)``
  capped at ``cap``.  Right when ONE actor is retrying one thing (a
  respawn loop, a relaunch loop): determinism makes tests and logs
  predictable, and there is no thundering herd to de-synchronize.
* :func:`decorrelated_jitter` — AWS-style ``min(cap, uniform(base,
  3 * prev))``.  Right when MANY actors retry at once (every stream a
  dead replica carried fails over together): jitter spreads the
  stampede, the 3x growth still backs off, the cap bounds added latency.
"""

from __future__ import annotations

import random


def exponential_backoff(base_s: float, cap_s: float, attempt: int) -> float:
    """Delay before retry number ``attempt`` (1-based): ``base * 2**(attempt-1)``,
    capped.  ``attempt <= 1`` returns ``base`` (a first failure waits the
    base delay, not zero)."""
    if base_s <= 0:
        return 0.0
    return min(cap_s, base_s * (2 ** max(0, attempt - 1)))


def decorrelated_jitter(base_s: float, cap_s: float, prev_s: float,
                        rng=random) -> float:
    """Next sleep from the previous one: ``min(cap, uniform(base,
    3 * prev))``.  Feed the result back in as ``prev_s``; seed with
    ``prev_s = base_s``.  Never below ``base_s``, never above ``cap_s``."""
    return min(cap_s, rng.uniform(base_s, max(base_s, 3.0 * prev_s)))
