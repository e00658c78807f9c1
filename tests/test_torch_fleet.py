"""The port's out-of-process serving fleet (``serving/transport.py``,
``supervisor.py``, ``worker.py``, ``utils/proc.py``, ``utils/backoff.py``),
mirroring ``tests/test_fleet.py``.

Host logic runs in lockstep with the JAX package's: wire frames are byte
for byte the reference's, the supervisor's state machine takes the same
decisions on the same scripted liveness, and the jitter backoff keeps the
same envelope.  One module-scoped pool of two CPU worker processes
(``--device cpu``) then serves greedy tokens identical to the port's plain
uncached forward on the same seeded weights, survives a worker hard-killed
mid-stream (delivered prefix skipped, slot respawned) and drains with no
worker process left.  The server CLI runs as a subprocess in both replica
transports.  Every subprocess wait has its own limit."""

import argparse
import http.client
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

import pytest
import torch

from deepspeed_tpu.serving import supervisor as jsup
from deepspeed_tpu.serving import transport as jtr
from deepspeed_tpu.serving.config import ServingConfig as JServingConfig
from deepspeed_tpu.serving.metrics import ServingMetrics as JServingMetrics
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.serving import (NoReplicaError, ReplicaPool,
                                         ReplicaSupervisor, ServingConfig,
                                         ServingMetrics)
from deepspeed_tpu_torch.serving.balancer import BalancedHandle
from deepspeed_tpu_torch.serving.server import (add_engine_cli_args,
                                                engine_argv_from_args,
                                                launch_server_subprocess,
                                                stop_server)
from deepspeed_tpu_torch.serving.transport import (MAX_FRAME, recv_frame,
                                                   send_frame)
from deepspeed_tpu_torch.utils.proc import terminate_procs

from tests.torch_cpu import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_ARGV = ["--model", "tiny", "--device", "cpu", "--seed", "0",
               "--num_blocks", "64", "--max_tokens_per_step", "32",
               "--max_seqs", "4", "--block_size", "8",
               "--max_blocks_per_seq", "8"]
# a worker imports torch and builds the tiny engine in ~3 s on a loaded
# CPU box: ten times that before a spawn is called hung
SPAWN_S = 60.0
STREAM_S = 60.0


def wait_until(pred, timeout=30.0, interval=0.05, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


@pytest.fixture(scope="module")
def ref_fn():
    """Greedy continuation through the port's plain uncached forward on the
    weights every worker draws from ``--seed 0`` (``build_engine_factory``:
    ``init_params`` on a CPU generator) — the lone-model reference."""
    cfg = tt.get_config("tiny", dtype="float32")
    params = tt.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    cache = {}

    @torch.no_grad()
    def ref(prompt, n):
        key = (tuple(prompt), n)
        if key not in cache:
            seq = torch.tensor([list(prompt)])
            for _ in range(n):
                nxt = tt.forward(params, seq, cfg)[:, -1].argmax(-1)
                seq = torch.cat([seq, nxt[:, None]], dim=1)
            cache[key] = seq[0, len(prompt):].tolist()
        return cache[key]

    return ref


@pytest.fixture(scope="module")
def flight_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("flight"))
    prev = os.environ.get("DSTPU_FLIGHT_DIR")
    os.environ["DSTPU_FLIGHT_DIR"] = d
    yield d
    if prev is None:
        os.environ.pop("DSTPU_FLIGHT_DIR", None)
    else:
        os.environ["DSTPU_FLIGHT_DIR"] = prev


@pytest.fixture(scope="module")
def fleet_pool(flight_dir):
    """Two CPU worker processes under supervision."""
    cfg = ServingConfig(num_replicas=2, replica_transport="subprocess",
                        default_max_tokens=8, max_queue=32,
                        heartbeat_interval_s=0.2, heartbeat_timeout_s=5.0,
                        respawn_backoff_s=0.2, respawn_reset_s=1.0,
                        submit_timeout_s=STREAM_S, spawn_timeout_s=SPAWN_S,
                        retry_backoff_s=0.02, retry_backoff_max_s=0.5)
    pool = ReplicaPool.build_subprocess(WORKER_ARGV, cfg)
    pool.start()
    pool.wait_ready(timeout=SPAWN_S)
    yield pool
    pool.shutdown()
    for t in pool.replicas:
        assert t._proc is None or t._proc.poll() is not None


def _fleet_heal(pool, n=2):
    wait_until(lambda: len(pool.healthy_replicas()) >= n, timeout=SPAWN_S,
               interval=0.2, msg=f"{n} healthy replicas")


def _alive(pid):
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False


# ---------------------------------------------------------------------------
# process-group teardown (utils/proc)
# ---------------------------------------------------------------------------


def _spawn_tree():
    """A child (own session) that forks a grandchild and reports its pid."""
    p = subprocess.Popen(["bash", "-c", "sleep 300 & echo $!; wait"],
                         stdout=subprocess.PIPE, text=True,
                         start_new_session=True)
    return p, int(p.stdout.readline())


def test_terminate_procs_group_reaps_grandchildren():
    p, gc_pid = _spawn_tree()
    assert _alive(gc_pid)
    assert terminate_procs([p], term_timeout_s=2.0, process_group=True)[0] \
        is not None
    wait_until(lambda: not _alive(gc_pid), timeout=5.0,
               msg="grandchild reaped")
    p.stdout.close()


def test_terminate_procs_direct_signal_orphans_grandchildren():
    p, gc_pid = _spawn_tree()
    try:
        terminate_procs([p], term_timeout_s=2.0, process_group=False)
        assert p.poll() is not None
        assert _alive(gc_pid)
    finally:
        try:
            os.kill(gc_pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        p.stdout.close()


def test_terminate_procs_group_fallback_without_session():
    p = subprocess.Popen(["sleep", "300"])
    terminate_procs([p], term_timeout_s=2.0, process_group=True)
    assert p.poll() is not None


# ---------------------------------------------------------------------------
# failover backoff
# ---------------------------------------------------------------------------


class _FakePool:
    def __init__(self, cfg):
        self.cfg = cfg


def test_decorrelated_jitter_backoff_matches_reference(monkeypatch):
    from deepspeed_tpu.serving.balancer import BalancedHandle as JHandle

    cfg = ServingConfig(retry_backoff_s=0.05, retry_backoff_max_s=2.0)
    mine = BalancedHandle(_FakePool(cfg), None, 0, {})
    ref = JHandle(_FakePool(JServingConfig(retry_backoff_s=0.05,
                                           retry_backoff_max_s=2.0)),
                  None, 0, {})
    for bound in ("hi", "lo"):
        pick = (lambda lo, hi: hi) if bound == "hi" else (lambda lo, hi: lo)
        monkeypatch.setattr("deepspeed_tpu_torch.utils.backoff.random."
                            "uniform", pick)
        monkeypatch.setattr("deepspeed_tpu.utils.backoff.random.uniform",
                            pick)
        a = b = cfg.retry_backoff_s
        for _ in range(8):
            a, b = mine._backoff(a), ref._backoff(b)
            assert a == b
        assert a == (cfg.retry_backoff_max_s if bound == "hi"
                     else cfg.retry_backoff_s)
    monkeypatch.undo()
    prev = cfg.retry_backoff_s
    for _ in range(100):
        prev = mine._backoff(prev)
        assert cfg.retry_backoff_s <= prev <= cfg.retry_backoff_max_s


# ---------------------------------------------------------------------------
# wire protocol frames: byte for byte the reference's
# ---------------------------------------------------------------------------

FRAMES = [{"op": "submit", "rid": "r1", "prompt": [1, 2],
           "max_new_tokens": 8, "trace": {"id": "t-1", "parent": None}},
          {"ev": "hb", "stats": {"busy": False, "kv": 0.25}},
          {"ev": "tok", "rid": "r1", "t": 17},
          {"ev": "err", "rid": "r1", "reason": "déjà vu"}]


def _wire(send, obj):
    a, b = socket.socketpair()
    try:
        send(a, obj)
        a.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            data = b.recv(65536)
            if not data:
                return b"".join(chunks)
            chunks.append(data)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("frame", FRAMES, ids=["submit", "hb", "tok", "err"])
def test_frame_bytes_equal_reference(frame):
    mine = _wire(lambda s, o: send_frame(s, o, threading.Lock()), frame)
    assert mine == _wire(jtr.send_frame, frame)
    assert struct.unpack(">I", mine[:4])[0] == len(mine) - 4


def test_frame_roundtrip_both_ways_and_eof():
    a, b = socket.socketpair()
    rfile = b.makefile("rb")
    try:
        send_frame(a, FRAMES[0])
        jtr.send_frame(a, FRAMES[1])
        assert jtr.recv_frame(rfile) == FRAMES[0]
        assert recv_frame(rfile) == FRAMES[1]
        a.close()
        assert recv_frame(rfile) is None  # clean EOF
    finally:
        rfile.close()
        b.close()


@pytest.mark.parametrize("recv", [recv_frame, jtr.recv_frame],
                         ids=["port", "reference"])
def test_frame_truncation_and_oversize_are_errors(recv):
    a, b = socket.socketpair()
    rfile = b.makefile("rb")
    try:
        a.sendall(struct.pack(">I", 100) + b'{"x": 1}')  # 8 of 100 bytes
        a.close()
        with pytest.raises(ConnectionError):
            recv(rfile)
    finally:
        rfile.close()
        b.close()
    a, b = socket.socketpair()
    rfile = b.makefile("rb")
    try:
        a.sendall(struct.pack(">I", MAX_FRAME + 1))
        with pytest.raises(ConnectionError):
            recv(rfile)
    finally:
        rfile.close()
        a.close()
        b.close()
    assert MAX_FRAME == jtr.MAX_FRAME


# ---------------------------------------------------------------------------
# supervisor state machine, in lockstep with the reference's
# ---------------------------------------------------------------------------


class _ScriptedReplica:
    """Duck-typed SubprocessReplica for deterministic supervisor ticks."""

    def __init__(self):
        self.name = "replica0"
        self.generation = 0
        self.consecutive_failures = 0
        self.circuit_open = False
        self.next_respawn_at = 0.0
        self.live = {"down": None, "stopping": False, "connected": True,
                     "alive": True, "pid": 1234, "hb_age": 0.0,
                     "progress_age": 0.0, "busy": False,
                     "broker_healthy": True, "spawn_age": 0.0}
        self.marked = []
        self.respawns = 0

    def liveness(self):
        return dict(self.live)

    def mark_down(self, reason):
        self.marked.append(reason)
        self.live["down"] = reason

    def respawn(self):
        self.respawns += 1
        self.generation += 1
        self.live["down"] = None
        self.live["spawn_age"] = 0.0
        return self


SUP_KW = dict(heartbeat_timeout_s=1.0, hung_replica_timeout_s=5.0,
              respawn_backoff_s=0.5, respawn_backoff_max_s=4.0,
              circuit_breaker_threshold=3, respawn_reset_s=2.0)
PACKAGES = {"port": (ReplicaSupervisor, ServingConfig, ServingMetrics),
            "reference": (jsup.ReplicaSupervisor, JServingConfig,
                          JServingMetrics)}


@pytest.fixture(params=sorted(PACKAGES))
def sup(request):
    sup_cls, cfg_cls, metrics_cls = PACKAGES[request.param]
    m = metrics_cls()
    return sup_cls([], cfg_cls(**SUP_KW), metrics=m), m


def test_supervisor_detects_missed_heartbeats(sup):
    s, m = sup
    r = _ScriptedReplica()
    r.live["hb_age"] = 0.5
    s._tick(r)
    assert r.marked == []
    r.live["hb_age"] = 1.5
    s._tick(r)
    assert r.marked == ["heartbeat_timeout"]
    assert m.fleet["heartbeat_misses"] == 1


def test_supervisor_hung_detection_requires_busy(sup):
    s, m = sup
    r = _ScriptedReplica()
    r.live["progress_age"] = 99.0  # idle: stale progress is fine
    s._tick(r)
    assert r.marked == []
    r.live["busy"] = True
    s._tick(r)
    assert r.marked == ["hung_replica"]
    assert m.fleet["hung_detected"] == 1


def test_supervisor_detects_dead_broker(sup):
    s, _ = sup
    r = _ScriptedReplica()
    r.live["broker_healthy"] = False
    s._tick(r)
    assert r.marked == ["broker_dead"]


def test_supervisor_backoff_doubles_and_circuit_opens(sup):
    s, m = sup
    r = _ScriptedReplica()
    backoffs = []
    for _ in range(2):
        r.mark_down("worker_exited")
        s._tick(r)  # schedules the respawn
        backoffs.append(r.next_respawn_at - time.monotonic())
        r.next_respawn_at = time.monotonic() - 0.01  # due now
        s._tick(r)  # fires it
        assert r.live["down"] is None
    assert r.respawns == 2
    assert 0.3 < backoffs[0] <= 0.55     # ~base
    assert 0.8 < backoffs[1] <= 1.05     # ~2x base
    r.mark_down("worker_exited")
    s._tick(r)
    assert r.circuit_open
    assert m.fleet["circuit_opens"] == 1
    before = r.respawns
    s._tick(r)  # open breaker: no further respawns, ever
    assert r.respawns == before


def test_supervisor_healthy_streak_resets_failures(sup):
    s, _ = sup
    r = _ScriptedReplica()
    r.consecutive_failures = 2
    r.live["spawn_age"] = 1.0
    s._tick(r)
    assert r.consecutive_failures == 2
    r.live["spawn_age"] = 3.0
    s._tick(r)
    assert r.consecutive_failures == 0


# ---------------------------------------------------------------------------
# worker CLI round-trip
# ---------------------------------------------------------------------------


def test_engine_argv_roundtrip_and_matches_reference():
    from deepspeed_tpu.serving.server import (
        add_engine_cli_args as jadd, engine_argv_from_args as jargv)

    flags = ["--model", "tiny", "--seed", "3", "--spec_mode", "self_draft",
             "--spec_k", "2", "--enable_prefix_cache", "--num_blocks", "128",
             "--quantize_bits", "8", "--kv_host_pool_mb", "4"]
    p = argparse.ArgumentParser()
    add_engine_cli_args(p)
    args = p.parse_args(flags + ["--device", "cpu"])
    p2 = argparse.ArgumentParser()
    add_engine_cli_args(p2)
    args2 = p2.parse_args(engine_argv_from_args(args))
    assert vars(args2) == vars(args)
    assert p.parse_args(flags).device == "cuda"  # the card by default
    # the reference's flag set, plus --device
    jp = argparse.ArgumentParser()
    jadd(jp)
    jargs = jp.parse_args(flags)
    mine = engine_argv_from_args(args)
    i = mine.index("--device")
    assert mine[:i] + mine[i + 2:] == jargv(jargs)


def test_worker_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is the card")
    from deepspeed_tpu_torch.serving import server

    with pytest.raises(RuntimeError, match="device='cpu'"):
        server.main(["--model", "tiny", "--port", "0"])
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.serving.worker",
         "--model", "tiny"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=SPAWN_S)
    assert res.returncode != 0
    assert "device='cpu'" in res.stderr
    assert "listening" not in res.stdout


# ---------------------------------------------------------------------------
# the CPU worker fleet (two real processes)
# ---------------------------------------------------------------------------


def test_fleet_roundtrip_token_identity(fleet_pool, ref_fn):
    for prompt in ([5, 6, 7], [9, 3]):
        h = fleet_pool.submit(prompt, max_new_tokens=12)
        assert list(h.tokens(timeout=STREAM_S)) == ref_fn(prompt, 12)
        assert h.finish_reason == "length"
    health = fleet_pool.health()
    assert health["status"] == "ok"
    assert health["healthy_replicas"] == 2
    assert all(r["transport"] == "subprocess" and r["pid"]
               for r in health["replicas"])


def test_fleet_hardkill_failover_and_respawn(fleet_pool, ref_fn, flight_dir):
    _fleet_heal(fleet_pool)
    deaths0 = fleet_pool.metrics.fleet["worker_deaths"]
    dumps0 = len(os.listdir(flight_dir))
    # every engine step of both workers held 0.1 s, so the 20 tokens still
    # owed after the first 4 outlast the victim's next heartbeat tick (0.2
    # s) by far: the kill lands mid-stream, never after the stream's end
    for rep in fleet_pool.replicas:
        assert rep.inject_fault({"serving.step": "delay:0.1"})
    h = fleet_pool.submit([4, 4, 2], max_new_tokens=24)
    it = h.tokens(timeout=STREAM_S)
    got = [next(it) for _ in range(4)]
    victim = fleet_pool.replicas[h.replica_index]
    gen0 = victim.generation
    # hard os._exit in the current worker generation, armed over the wire:
    # it fires at the worker's next heartbeat tick
    assert victim.inject_fault({"serving.worker.hardkill": "exit"})
    got += list(it)
    assert got == ref_fn([4, 4, 2], 24)  # delivered prefix skipped
    assert h.finish_reason == "length"
    _fleet_heal(fleet_pool)
    for rep in fleet_pool.replicas:  # the survivor's steps at full speed
        assert rep.inject_fault({"serving.step": "delay:0"})
    assert victim.generation > gen0
    assert fleet_pool.metrics.fleet["worker_deaths"] > deaths0
    assert fleet_pool.metrics.fleet["respawns"] >= 1
    wait_until(lambda: len(os.listdir(flight_dir)) > dumps0, timeout=10.0,
               msg="flight dump after worker death")


def test_fleet_clean_drain_leaves_no_process(fleet_pool, ref_fn):
    _fleet_heal(fleet_pool)
    results, errors = {}, []

    def run(i):
        try:
            h = fleet_pool.submit([i + 1, i + 2, i + 3], max_new_tokens=10)
            results[i] = list(h.tokens(timeout=STREAM_S))
        except Exception as e:  # noqa: BLE001 — collected and asserted
            errors.append((i, e))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=STREAM_S)
        assert not t.is_alive(), "stream wedged"
    assert not errors, errors
    for i in range(4):
        assert results[i] == ref_fn([i + 1, i + 2, i + 3], 10)
    pids = [t._proc.pid for t in fleet_pool.replicas if t._proc is not None]
    assert len(pids) == 2
    fleet_pool.drain(timeout=30.0)
    for pid in pids:
        wait_until(lambda: not _alive(pid), timeout=10.0,
                   msg=f"worker {pid} reaped")
    for t in fleet_pool.replicas:
        assert t._proc is None or t._proc.poll() is not None
        assert t._sock is None or t._sock.fileno() == -1
    with pytest.raises(NoReplicaError):
        fleet_pool.submit([1, 2], max_new_tokens=2)


# ---------------------------------------------------------------------------
# the server CLI as a subprocess, both replica transports
# ---------------------------------------------------------------------------


def _get(port, path):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=STREAM_S)
    c.request("GET", path)
    r = c.getresponse()
    return r.status, r.read()


def _complete(port, body):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=STREAM_S)
    c.request("POST", "/v1/completions", json.dumps(body),
              {"Content-Type": "application/json"})
    r = c.getresponse()
    return r.status, r.read().decode()


@pytest.mark.parametrize("transport", ["inprocess", "subprocess"])
def test_server_cli_answers_on_the_cpu(transport, ref_fn):
    proc, url = launch_server_subprocess(
        ["--port", "0", "--device", "cpu", "--replica_transport", transport,
         "--replicas", "2" if transport == "subprocess" else "1"]
        + WORKER_ARGV[:2] + WORKER_ARGV[4:], timeout_s=2 * SPAWN_S)
    port = int(url.rsplit(":", 1)[1])
    try:
        status, body = _complete(port, {"prompt": [5, 6, 7],
                                        "max_tokens": 8})
        assert status == 200
        assert json.loads(body)["choices"][0]["tokens"] == \
            ref_fn([5, 6, 7], 8)
        status, body = _complete(port, {"prompt": "5 6 7", "max_tokens": 8,
                                        "stream": True})
        assert status == 200
        toks = [json.loads(line[6:])["choices"][0].get("token")
                for line in body.splitlines()
                if line.startswith("data: {")]
        assert [t for t in toks if t is not None] == ref_fn([5, 6, 7], 8)
        status, health = _get(port, "/healthz")
        health = json.loads(health)
        assert status == 200 and health["healthy_replicas"] == \
            (2 if transport == "subprocess" else 1)
        pids = [r["pid"] for r in health["replicas"] if r.get("pid")]
        status, metrics = _get(port, "/metrics")
        assert status == 200
        # in-process, the front's brokers count completions; a worker's
        # broker counts its own (the reference's split), and the front
        # exports the fleet's per-replica series
        assert (b"\ndstpu_serving_completed 2\n" in metrics
                if transport == "inprocess" else
                b'dstpu_serving_replica_kv_utilization{replica="replica1"'
                in metrics)
    finally:
        assert stop_server(proc, term_timeout_s=30.0) is not None
        proc.stdout.close()
    for pid in pids:
        wait_until(lambda: not _alive(pid), timeout=10.0,
                   msg=f"worker {pid} reaped")
