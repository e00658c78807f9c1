"""Deterministic fault injection for durability testing (the port of
``deepspeed_tpu/utils/faults.py``, host-only and copied).

Named fault *sites* are compiled into the checkpoint / IO / elasticity
paths (``faults.maybe_fail("ckpt.write.model")``).  A site with no armed
spec is a dict lookup — negligible overhead in production.  Activation:

* environment: ``DSTPU_FAULTS="ckpt.write.model=exit;io.fast.submit=ioerror@2"``
  (read once, at the first site hit — subprocess tests set it before exec);
* programmatic: ``faults.configure({"ckpt.commit": "delay:0.5"})``.

Spec grammar, per site: ``KIND[:ARG][@HIT]``

``exit[:code]``
    ``os._exit`` — a hard kill with no atexit / flush / unwinding, the
    closest in-process stand-in for a preemption or power loss
    (default code 70, EX_SOFTWARE — distinguishable from a crash).
``ioerror[:msg]``
    raise ``IOError`` at the site (ENOSPC-style failures).
``delay:seconds``
    sleep — widens race / overlap windows.
``hang``
    sleep forever at the site (the thread never returns) — models a
    wedged worker: a stuck compile, a deadlocked collective, a hung
    device.  Unlike ``exit`` the process stays alive, so only timeout-
    based supervision (heartbeats) can detect it.
``truncate[:bytes]``
    truncate the file handed to ``maybe_truncate`` (torn-write model);
    no arg → truncate to half the current size.
``@HIT``
    fire on the Nth arrival at the site only (1-based).  Without it the
    spec fires on *every* hit.  Hit counters are per-process and
    per-site, so ``exit@2`` deterministically kills the second save.

Tests can assert on ``faults.hits(site)`` / ``faults.fired(site)``.

Sites are free-form strings — new subsystems add sites without touching
this module.  The serving cold tier (``inference/v2/coldstore.py``)
compiles in ``serving.coldstore.write`` (before staging; also the
``maybe_truncate`` torn-write point on the staged payload),
``serving.coldstore.commit`` (between manifest write and the atomic
rename — a kill here leaves a ``.tmp`` orphan for startup GC), and
``serving.coldstore.rehydrate`` (per entry during restart rehydration).

Crash hooks: callables registered with :func:`add_crash_hook` run just
before an ``exit`` spec's ``os._exit`` — the flight recorder
(``observability/recorder.py``) uses this to leave a postmortem dump on
injected hard-kills.  Hooks must be fast and must not raise (failures are
swallowed so they can't mask the kill).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Union

from .locks import named_lock
from .logging import logger

_ENV = "DSTPU_FAULTS"


@dataclasses.dataclass
class _Spec:
    kind: str
    arg: Optional[str] = None
    hit: int = 0  # 0 → every hit; N → Nth hit only


def _parse_spec(text: str) -> _Spec:
    text = text.strip()
    hit = 0
    if "@" in text:
        text, n = text.rsplit("@", 1)
        hit = int(n)
    kind, _, arg = text.partition(":")
    kind = kind.strip().lower()
    if kind not in ("exit", "ioerror", "delay", "hang", "truncate"):
        raise ValueError(f"unknown fault kind {kind!r} "
                         "(want exit|ioerror|delay|hang|truncate)")
    return _Spec(kind=kind, arg=arg.strip() or None, hit=hit)


class FaultInjector:
    """Process-wide registry of armed fault sites (module singleton below)."""

    def __init__(self) -> None:
        self._lock = named_lock("faults.registry")
        self._specs: Dict[str, _Spec] = {}
        self._hits: Dict[str, int] = {}
        self._fired: Dict[str, int] = {}
        self._env_loaded = False
        self._crash_hooks: List[Callable[[str], None]] = []

    # -- arming ----------------------------------------------------------
    def configure(self, spec: Union[str, Dict[str, str]]) -> None:
        """Arm sites from ``"site=KIND[:ARG][@HIT];site2=..."`` or a dict."""
        if isinstance(spec, str):
            pairs = (p for p in spec.split(";") if p.strip())
            spec = dict(p.split("=", 1) for p in pairs)
        with self._lock:
            self._env_loaded = True  # explicit config wins over the env
            for site, text in spec.items():
                self._specs[site.strip()] = _parse_spec(text)

    def reset(self) -> None:
        """Disarm everything and zero the counters (test isolation).  The
        env var is NOT re-read after a reset — reset means 'off'."""
        with self._lock:
            self._specs.clear()
            self._hits.clear()
            self._fired.clear()
            self._env_loaded = True

    def active(self) -> bool:
        self._load_env()
        return bool(self._specs)

    def hits(self, site: str) -> int:
        return self._hits.get(site, 0)

    def fired(self, site: str) -> int:
        return self._fired.get(site, 0)

    def add_crash_hook(self, fn: Callable[[str], None]) -> None:
        """Register ``fn(site)`` to run before an injected hard-kill's
        ``os._exit``.  Idempotent per callable."""
        with self._lock:
            if fn not in self._crash_hooks:
                self._crash_hooks.append(fn)

    # -- sites -----------------------------------------------------------
    def maybe_fail(self, site: str) -> None:
        """Fault site for exit / ioerror / delay kinds (truncate specs are
        ignored here — they belong to ``maybe_truncate`` sites)."""
        spec = self._arm(site)
        if spec is None or spec.kind == "truncate":
            return
        if spec.kind == "exit":
            code = int(spec.arg) if spec.arg else 70
            logger.error(f"fault injection: hard-killing process at {site!r} "
                         f"(os._exit({code}))")
            with self._lock:
                hooks = list(self._crash_hooks)
            for fn in hooks:
                try:
                    fn(site)
                except Exception:  # noqa: BLE001 — must not mask the kill
                    pass
            os._exit(code)
        if spec.kind == "ioerror":
            raise IOError(f"injected fault at {site!r}"
                          + (f": {spec.arg}" if spec.arg else ""))
        if spec.kind == "delay":
            time.sleep(float(spec.arg or 0.1))
        if spec.kind == "hang":
            logger.error(f"fault injection: hanging thread at {site!r}")
            while True:  # wedged, not dead — only a watchdog can tell
                time.sleep(1.0)

    def maybe_truncate(self, site: str, path: str) -> None:
        """Fault site modelling a torn write: truncate ``path`` in place."""
        spec = self._arm(site)
        if spec is None or spec.kind != "truncate":
            return
        size = os.path.getsize(path)
        keep = int(spec.arg) if spec.arg else size // 2
        with open(path, "rb+") as f:
            f.truncate(min(keep, size))
        logger.error(f"fault injection: truncated {path} to "
                     f"{min(keep, size)} bytes at {site!r}")

    # -- internals -------------------------------------------------------
    def _load_env(self) -> None:
        if self._env_loaded:
            return
        self._env_loaded = True
        raw = os.environ.get(_ENV)
        if raw:
            self.configure(raw)
            logger.warning(f"fault injection ACTIVE from ${_ENV}: {raw}")

    def _arm(self, site: str) -> Optional[_Spec]:
        self._load_env()
        with self._lock:
            if not self._specs:
                return None
            n = self._hits[site] = self._hits.get(site, 0) + 1
            spec = self._specs.get(site)
            if spec is None or (spec.hit and n != spec.hit):
                return None
            self._fired[site] = self._fired.get(site, 0) + 1
            return spec


_INJECTOR = FaultInjector()

configure = _INJECTOR.configure
reset = _INJECTOR.reset
active = _INJECTOR.active
hits = _INJECTOR.hits
fired = _INJECTOR.fired
maybe_fail = _INJECTOR.maybe_fail
maybe_truncate = _INJECTOR.maybe_truncate
add_crash_hook = _INJECTOR.add_crash_hook
