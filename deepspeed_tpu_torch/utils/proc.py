"""Process-group teardown shared by elasticity and serving (the port of
``deepspeed_tpu/utils/proc.py``).

One grace-period policy for every place the framework kills a process
group: the elastic agent tearing down a worker generation
(``elasticity/elastic_agent.py``), the serving demo/bench stopping an HTTP
front, the replica supervisor reaping a dead worker
(``serving/supervisor.py``), and any launcher-spawned helper. SIGTERM
first so workers can flush checkpoints / drain in-flight requests,
SIGKILL whatever is still alive after the grace period.

``process_group=True`` escalates each signal to the child's whole process
group via ``os.killpg`` — only correct when the child was started with
``start_new_session=True`` (it is then its own group leader, so the group
id equals its pid and cannot alias the caller's group). Without it, a
worker that forked helpers (an HTTP front's profiler, a data loader, a
shell wrapper) leaves grandchildren running after teardown: SIGTERM/
SIGKILL on the direct ``Popen`` only reaches the immediate child.
"""

from __future__ import annotations

import os
import signal
import subprocess
import time
from typing import List, Optional, Sequence


def _signal_proc(p: subprocess.Popen, sig: int, process_group: bool) -> None:
    """Deliver ``sig``; with ``process_group`` prefer the child's group.
    Falls back to the direct child when no such group exists (child not a
    session leader — e.g. a custom launch_fn that didn't opt in)."""
    if process_group and hasattr(os, "killpg"):
        try:
            os.killpg(p.pid, sig)
            return
        except (ProcessLookupError, PermissionError, OSError):
            pass  # no group led by the child (or already gone): direct
    try:
        p.send_signal(sig)
    except (OSError, ValueError):  # already reaped by the OS
        pass


def terminate_procs(procs: Sequence[subprocess.Popen],
                    term_timeout_s: float = 10.0,
                    poll_interval_s: float = 0.05,
                    process_group: bool = False) -> List[Optional[int]]:
    """SIGTERM every live process, give the group ``term_timeout_s`` to exit,
    SIGKILL the survivors.  Returns the final return codes (same order as
    ``procs``; every entry is non-None on return).

    ``process_group=True``: signals go to each child's process group
    (grandchildren included). Callers must have spawned the children with
    ``start_new_session=True`` — the elastic agent's local launcher,
    ``serving.server.launch_server_subprocess``, and the replica worker
    transport all do."""
    for p in procs:
        if p.poll() is None:
            _signal_proc(p, signal.SIGTERM, process_group)
    deadline = time.monotonic() + term_timeout_s
    for p in procs:
        while p.poll() is None and time.monotonic() < deadline:
            time.sleep(poll_interval_s)
        if p.poll() is None:
            _signal_proc(p, signal.SIGKILL, process_group)
            p.wait()
        elif process_group:
            # the direct child exited on SIGTERM but forked helpers may
            # not have: sweep the (now leaderless) group once more
            _signal_proc(p, signal.SIGKILL, process_group=True)
    return [p.poll() for p in procs]
