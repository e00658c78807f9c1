"""Named locks + an optional lockdep runtime (``DSTPU_LOCKDEP=1``) — the
port of ``deepspeed_tpu/utils/locks.py`` (host-only, copied so that the
port never imports the JAX package).

Every lock in ``observability/``, ``utils/`` and the serving memory
hierarchy (``inference/v2/paging.py``, ``coldstore.py``) is created
through :func:`named_lock` / :func:`named_rlock` instead of bare
``threading.Lock()``.  The *name* is the lock's class (in the Linux
lockdep sense): all instances created under one name share ordering
state, so an order proven on one ``FramedReplica`` covers the whole
fleet.

With ``DSTPU_LOCKDEP`` unset this module is a passthrough — the factory
returns plain ``threading.Lock``/``RLock`` objects and costs nothing.
With ``DSTPU_LOCKDEP=1`` each lock is wrapped and the runtime records,
per thread:

* **acquisition-order edges** — acquiring ``B`` while holding ``A`` adds
  the edge ``A -> B`` (with the acquire-site stacks of both ends) to a
  global graph; a new edge that closes a cycle is a potential deadlock
  and is reported with the full chain and both acquire sites
  (Eraser / kernel-lockdep discipline: the *order* is the bug, no actual
  deadlock needs to strike on this run);
* **blocking calls under a lock** — ``time.sleep``, socket
  ``send``/``sendall``/``recv``/``accept``, blocking ``Queue.get`` /
  bounded ``Queue.put``, ``Thread.join``, and ``Popen.wait`` while any
  named lock is held (each a latency bomb for every other waiter, and
  half of every classic deadlock).

Violations accumulate in-process; :func:`lockdep_report` returns them
for a test to assert empty.  Reentrant
re-acquisition of a :func:`named_rlock` by the owning thread is *not* an
edge (and never a self-cycle).

The wrappers deliberately support the two idioms the serving stack uses
beyond ``with lock:`` — ``threading.Condition(lock)`` (the broker's
``_wake``) and ``acquire(blocking=False)``/``release()`` (the server's
profile lock) — so migration never changes runtime behaviour.
"""

from __future__ import annotations

import os
import queue
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "named_lock",
    "named_rlock",
    "lockdep_enabled",
    "lockdep_report",
    "lockdep_reset",
]

#: frames kept per acquire site (enough to see through helper wrappers)
_SITE_DEPTH = 8


def lockdep_enabled() -> bool:
    """True when the lockdep runtime is on (``DSTPU_LOCKDEP=1``)."""
    return os.environ.get("DSTPU_LOCKDEP", "") == "1"


def _capture_site() -> Tuple[str, ...]:
    """Compact acquire-site stack: ``file:line:function`` innermost
    first, skipping frames inside this module."""
    out: List[str] = []
    try:
        f = sys._getframe(1)
    except ValueError:  # pragma: no cover — no caller frame
        return ()
    while f is not None and len(out) < _SITE_DEPTH:
        if f.f_code.co_filename != __file__:
            out.append(f"{f.f_code.co_filename}:{f.f_lineno}:"
                       f"{f.f_code.co_name}")
        f = f.f_back
    return tuple(out)


class _Held:
    """One entry in a thread's held-lock stack."""

    __slots__ = ("lock", "name", "site", "count")

    def __init__(self, lock: Any, name: str, site: Tuple[str, ...]):
        self.lock = lock
        self.name = name
        self.site = site
        self.count = 1


class _LockdepState:
    """Global (per-process) lockdep state.  Guarded by a *raw*
    ``threading.Lock`` that is itself invisible to the tracker."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._tls = threading.local()
        #: lock class names ever created under lockdep
        self.classes: Dict[str, int] = {}
        #: (holder_name, acquired_name) -> edge info with both sites
        self.edges: Dict[Tuple[str, str], Dict[str, Any]] = {}
        #: canonical cycle key -> cycle report
        self.cycles: Dict[str, Dict[str, Any]] = {}
        #: "blocking:<lock>:<call>" -> blocking-call report
        self.blocking: Dict[str, Dict[str, Any]] = {}
        self._patched = False

    # -- per-thread held stack ------------------------------------------

    def _held(self) -> List[_Held]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    # -- registration ----------------------------------------------------

    def register(self, name: str) -> None:
        with self._mu:
            self.classes[name] = self.classes.get(name, 0) + 1
            if not self._patched:
                self._patched = True
                _install_blocking_patches()

    # -- acquire / release ----------------------------------------------

    def note_acquire(self, lock: Any, name: str, reentrant: bool) -> None:
        held = self._held()
        if reentrant:
            for h in held:
                if h.lock is lock:
                    h.count += 1
                    return
        site = _capture_site()
        if held:
            with self._mu:
                for h in held:
                    self._add_edge(h, name, site)
        held.append(_Held(lock, name, site))

    def note_release(self, lock: Any) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i].lock is lock:
                held[i].count -= 1
                if held[i].count == 0:
                    del held[i]
                return
        # release of a lock acquired before lockdep saw it (or handed
        # across threads) — nothing tracked, nothing to do

    # -- graph -----------------------------------------------------------

    def _add_edge(self, holder: _Held, name: str,
                  site: Tuple[str, ...]) -> None:
        """Record holder.name -> name; detect any cycle it closes.
        Caller holds self._mu."""
        key = (holder.name, name)
        edge = self.edges.get(key)
        if edge is not None:
            edge["count"] += 1
            return
        self.edges[key] = {
            "from": holder.name, "to": name,
            "hold_site": list(holder.site), "acquire_site": list(site),
            "count": 1,
        }
        chain = self._find_path(name, holder.name)
        if chain is not None:
            self._record_cycle(chain + [name])

    def _find_path(self, src: str, dst: str) -> Optional[List[str]]:
        """DFS over edges from src to dst; returns the node chain
        [src, ..., dst] or None."""
        adj: Dict[str, List[str]] = {}
        for (a, b) in self.edges:
            adj.setdefault(a, []).append(b)
        stack: List[Tuple[str, List[str]]] = [(src, [src])]
        seen = set()
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            if node in seen:
                continue
            seen.add(node)
            for nxt in adj.get(node, ()):
                if nxt not in path or nxt == dst:
                    stack.append((nxt, path + [nxt]))
        return None

    def _record_cycle(self, chain: List[str]) -> None:
        """chain is [n0, n1, ..., n0-closing-name]; canonicalize and
        store with the acquire sites of every edge on it."""
        nodes = chain[:-1] if len(chain) > 1 and chain[0] == chain[-1] \
            else chain
        # rotate so the lexicographically smallest class leads: the key
        # is stable no matter which edge closed the cycle
        k = nodes.index(min(nodes))
        nodes = nodes[k:] + nodes[:k]
        key = "cycle:" + "->".join(nodes + [nodes[0]])
        if key in self.cycles:
            self.cycles[key]["count"] += 1
            return
        edges = []
        for i in range(len(nodes)):
            a, b = nodes[i], nodes[(i + 1) % len(nodes)]
            e = self.edges.get((a, b))
            if e is not None:
                edges.append(dict(e))
        self.cycles[key] = {
            "key": key, "chain": nodes + [nodes[0]],
            "edges": edges, "count": 1,
        }

    # -- blocking calls ---------------------------------------------------

    def note_blocking(self, call: str) -> None:
        held = self._held()
        if not held:
            return
        site = _capture_site()
        with self._mu:
            for h in held:
                key = f"blocking:{h.name}:{call}"
                rec = self.blocking.get(key)
                if rec is not None:
                    rec["count"] += 1
                else:
                    self.blocking[key] = {
                        "key": key, "lock": h.name, "call": call,
                        "site": list(site),
                        "hold_site": list(h.site), "count": 1,
                    }

    # -- reporting --------------------------------------------------------

    def report(self) -> Dict[str, Any]:
        with self._mu:
            return {
                "enabled": lockdep_enabled(),
                "locks": sorted(self.classes),
                "lock_instances": dict(self.classes),
                "edges": [dict(e) for e in self.edges.values()],
                "cycles": [dict(c) for c in self.cycles.values()],
                "blocking": [dict(b) for b in self.blocking.values()],
            }

    def reset(self) -> None:
        with self._mu:
            self.classes.clear()
            self.edges.clear()
            self.cycles.clear()
            self.blocking.clear()
        # the current thread's held stack is cleared too so a failed
        # test cannot poison the next one; other threads' stacks drain
        # naturally as they release
        self._tls.held = []


_STATE = _LockdepState()


# -- blocking-call monkeypatches (installed once, first lockdep lock) -----

def _install_blocking_patches() -> None:
    """Shadow the known blocking primitives with held-lock checks.  The
    wrappers are passthroughs when no named lock is held; they are only
    installed when lockdep is enabled, never in production mode."""
    orig_sleep = time.sleep

    def _sleep(secs):
        _STATE.note_blocking("time.sleep")
        return orig_sleep(secs)

    time.sleep = _sleep

    orig_qget = queue.Queue.get

    def _qget(self, block=True, timeout=None):
        if block:
            _STATE.note_blocking("queue.Queue.get")
        return orig_qget(self, block=block, timeout=timeout)

    queue.Queue.get = _qget

    orig_qput = queue.Queue.put

    def _qput(self, item, block=True, timeout=None):
        # an unbounded put never blocks; only bounded queues count
        if block and self.maxsize > 0:
            _STATE.note_blocking("queue.Queue.put")
        return orig_qput(self, item, block=block, timeout=timeout)

    queue.Queue.put = _qput

    orig_join = threading.Thread.join

    def _join(self, timeout=None):
        _STATE.note_blocking("threading.Thread.join")
        return orig_join(self, timeout=timeout)

    threading.Thread.join = _join

    orig_wait = subprocess.Popen.wait

    def _wait(self, timeout=None):
        _STATE.note_blocking("subprocess.Popen.wait")
        return orig_wait(self, timeout=timeout)

    subprocess.Popen.wait = _wait

    for meth in ("send", "sendall", "recv", "accept"):
        _patch_socket_method(meth)


def _patch_socket_method(meth: str) -> None:
    orig = getattr(socket.socket, meth)

    def _wrapped(self, *args, **kwargs):
        _STATE.note_blocking(f"socket.{meth}")
        return orig(self, *args, **kwargs)

    _wrapped.__name__ = meth
    setattr(socket.socket, meth, _wrapped)


# -- lock wrappers --------------------------------------------------------

class _DepLock:
    """Lockdep-instrumented ``threading.Lock``.  Duck-types the stdlib
    lock (acquire/release/locked/context manager) and works as the
    underlying lock of a ``threading.Condition``."""

    _reentrant = False

    __slots__ = ("name", "_inner")

    def __init__(self, name: str, inner: Any):
        self.name = name
        self._inner = inner

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            _STATE.note_acquire(self, self.name, self._reentrant)
        return got

    def release(self) -> None:
        _STATE.note_release(self)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "_DepLock":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r} {self._inner!r}>"


class _DepRLock(_DepLock):
    """Lockdep-instrumented ``threading.RLock``: the owning thread's
    re-acquisition bumps a depth counter instead of adding an edge, so
    reentrancy is never a false-positive self-cycle."""

    _reentrant = True

    __slots__ = ()


# -- factory --------------------------------------------------------------

def named_lock(name: str) -> Any:
    """A ``threading.Lock`` carrying a lock-class *name* for ordering
    analysis.  Passthrough (a bare stdlib lock) unless ``DSTPU_LOCKDEP=1``."""
    if not lockdep_enabled():
        return threading.Lock()
    _STATE.register(name)
    return _DepLock(name, threading.Lock())


def named_rlock(name: str) -> Any:
    """Reentrant sibling of :func:`named_lock`."""
    if not lockdep_enabled():
        return threading.RLock()
    _STATE.register(name)
    return _DepRLock(name, threading.RLock())


def lockdep_report() -> Dict[str, Any]:
    """Snapshot of the lockdep state: lock classes, order edges, cycles
    (each with the full chain and per-edge acquire sites), and
    blocking-call-under-lock records."""
    return _STATE.report()


def lockdep_reset() -> None:
    """Clear all recorded state (test isolation).  Installed blocking
    patches stay (they are inert with no held locks)."""
    _STATE.reset()
