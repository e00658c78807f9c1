"""Parity: the port's multi-host fleet (``serving/remote.py``,
``autoscaler.py``, ``rollout.py``, a worker's ``--connect`` mode) against
the JAX package's, mirroring ``tests/test_remote_fleet.py``.

The registry's handshake verdicts and fencing epochs, hello for hello, and
the autoscaler's decisions, tick for tick on one scripted pressure series,
move in lockstep with the reference's.  The TCP, fencing, lease and
failover cases run the port's registry and pool against
``tests/scripted_worker.py`` (the reference's stdlib-only worker that
speaks the wire protocol: ~0.1 s a process), plus one real CPU worker
dialing in.  Only the broker swap unit and the rolling-swap story build
engines: tiny ones in f32, on the reference's weights
(``params_from_jax``), whose greedy tokens equal the JAX engine's.
``publish_params`` writes the reference's directory byte for byte, and
each package loads the other's.  Every subprocess wait has its own
limit."""

import os
import signal
import socket
import subprocess
import sys
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import engine as je
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.serving import Autoscaler as JAutoscaler
from deepspeed_tpu.serving import RequestBroker as JBroker
from deepspeed_tpu.serving import ServingConfig as JServingConfig
from deepspeed_tpu.serving import ServingMetrics as JServingMetrics
from deepspeed_tpu.serving import rollout as jrollout
from deepspeed_tpu.serving.remote import RemoteReplica as JRemoteReplica
from deepspeed_tpu.serving.remote import WorkerRegistry as JWorkerRegistry
from deepspeed_tpu_torch.inference.v2 import engine as te
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.serving import (Autoscaler, ReplicaPool,
                                         ReplicaSupervisor, RequestBroker,
                                         ServingConfig, ServingMetrics)
from deepspeed_tpu_torch.serving import rollout as trollout
from deepspeed_tpu_torch.serving.remote import RemoteReplica, WorkerRegistry
from deepspeed_tpu_torch.serving.transport import (FLEET_MAGIC,
                                                   PROTO_VERSION, recv_frame,
                                                   send_frame)

from tests.scripted_worker import scripted_tokens
from tests.torch_cpu import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTED = os.path.join(REPO, "tests", "scripted_worker.py")
V2 = dict(max_tokens_per_step=32, max_seqs=4, block_size=8, num_blocks=64,
          max_blocks_per_seq=8, dtype="float32")
P = [5, 6, 7]
# a scripted worker starts in ~0.1 s, a real CPU worker imports torch and
# builds the tiny engine in ~3 s: ten times that before a wait fails
SPAWN_S = 60.0
STREAM_S = 60.0


def wait_until(pred, timeout=30.0, interval=0.05, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


def _cfg(cls=ServingConfig, **over):
    base = dict(num_replicas=2, default_max_tokens=8, max_queue=32,
                heartbeat_interval_s=0.25, heartbeat_timeout_s=3.0,
                lease_ttl_s=2.0, submit_timeout_s=30.0,
                spawn_timeout_s=30.0, retry_backoff_s=0.02,
                retry_backoff_max_s=0.5, supervise_interval_s=0.1)
    base.update(over)
    return cls(**base)


PACKAGES = {"jax": (JWorkerRegistry, JRemoteReplica, JServingConfig,
                    JServingMetrics),
            "torch": (WorkerRegistry, RemoteReplica, ServingConfig,
                      ServingMetrics)}


# ---------------------------------------------------------------------------
# registry handshake: verdicts and epochs hello for hello
# ---------------------------------------------------------------------------


def _drop(s):
    """Sever a hand-dialed connection for real (``makefile`` holds an
    io-ref on the fd, so ``close()`` alone would not send the FIN)."""
    try:
        s.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    s.close()


def _hello(address, **overrides):
    host, port = address.rsplit(":", 1)
    s = socket.create_connection((host, int(port)), timeout=5.0)
    frame = {"op": "hello", "magic": FLEET_MAGIC, "version": PROTO_VERSION,
             "name": "replica0", "pid": os.getpid()}
    frame.update(overrides)
    for k in [k for k, v in frame.items() if v is None]:
        del frame[k]
    send_frame(s, frame)
    rfile = s.makefile("rb")
    return s, rfile, recv_frame(rfile)


def _registry(pkg, **over):
    reg_cls, slot_cls, cfg_cls, met_cls = PACKAGES[pkg]
    cfg = _cfg(cfg_cls, num_replicas=1, **over)
    metrics = met_cls()
    reg = reg_cls(cfg, metrics).start()
    slot = slot_cls(cfg, "replica0", metrics)
    reg.register_slot(slot)
    slot.start()
    return reg, slot, metrics


def _close(reg, slot):
    try:
        slot.stop(drain=False, timeout=1.0)
    except Exception:
        pass
    reg.stop()


def _fencing_story(pkg):
    """The reference's fencing lifecycle on one package's registry: every
    verdict, the slot's epoch after each accepted hello, and the fleet
    counters at the end."""
    reg, slot, metrics = _registry(pkg, fleet_token="sekrit")
    out = []

    def adopted(n):
        # the slot takes the new epoch before it counts the registration
        # (``RemoteReplica.attach``), so an epoch seen here does not yet
        # mean the counter moved: wait for the n-th accepted hello to be
        # counted before the counters are read
        return metrics.fleet["registrations"] >= n
    try:
        for over in ({"op": "nonsense"}, {"magic": "http/1.1"},
                     {"version": 99}, {"name": "nobody"}, {"token": None},
                     {"token": "wrong"}, {"class": "warp"}):
            s, rf, reply = _hello(reg.address, epoch=1,
                                  **{"token": "sekrit", **over})
            out.append(reply)
            assert rf.read(1) == b""  # clean close after the verdict
            s.close()
        sa, rfa, reply = _hello(reg.address, epoch=5, token="sekrit")
        out.append(reply)
        wait_until(lambda: slot.healthy() and slot.epoch == 5
                   and adopted(1), msg="first registration")
        for epoch in (5, 4):  # duplicate while live, then stale
            s, _, reply = _hello(reg.address, epoch=epoch, token="sekrit")
            out.append(reply)
            s.close()
        sb, _, reply = _hello(reg.address, epoch=6, token="sekrit",
                              **{"class": "decode"})
        out.append(reply)
        wait_until(lambda: slot.epoch == 6 and adopted(2),
                   msg="the newer epoch fences")
        sa.settimeout(5.0)
        assert rfa.read(1) == b""  # the fenced connection is closed
        sa.close()
        out.append(slot.replica_class)
        _drop(sb)
        wait_until(lambda: not slot.healthy(), msg="the slot sees the drop")
        sc, _, reply = _hello(reg.address, epoch=None, prev_epoch=6,
                              token="sekrit")
        out.append(reply)
        wait_until(lambda: slot.epoch == 7 and adopted(3),
                   msg="reconnect bumps the epoch")
        s, _, reply = _hello(reg.address, epoch=None, prev_epoch=5,
                             token="sekrit")
        out.append(reply)
        s.close()
        sc.close()
        out.append({k: metrics.fleet[k] for k in (
            "registrations", "fenced", "stale_epoch_rejects")})
        out.append([{k: m[k] for k in ("worker", "epoch")}
                    for m in reg.membership()])
    finally:
        _close(reg, slot)
    return out


def test_handshake_verdicts_and_epochs_equal_reference():
    """Magic, version, auth, class, unknown worker; grant, duplicate,
    stale, fence by a newer epoch (the worker's class wins), reconnect by
    ``prev_epoch``, a zombie's stale proof: the same replies, epochs and
    counters from both registries."""
    mine = _fencing_story("torch")
    assert mine == _fencing_story("jax")
    assert [r["reason"] for r in mine[:7]] == [
        "bad_hello", "bad_magic", "version_mismatch", "unknown_worker",
        "auth_failed", "auth_failed", "bad_class"]
    assert mine[7:12] == [{"ev": "hello_ok", "epoch": 5},
                          {"ev": "hello_err", "reason": "duplicate_epoch"},
                          {"ev": "hello_err", "reason": "stale_epoch"},
                          {"ev": "hello_ok", "epoch": 6}, "decode"]
    assert mine[12:] == [{"ev": "hello_ok", "epoch": 7},
                         {"ev": "hello_err", "reason": "stale_epoch"},
                         {"registrations": 3, "fenced": 1,
                          "stale_epoch_rejects": 3},
                         [{"worker": "replica0", "epoch": 7}]]


def test_hello_garbage_counts_protocol_error():
    reg, slot, metrics = _registry("torch")
    try:
        host, port = reg.address.rsplit(":", 1)
        s = socket.create_connection((host, int(port)), timeout=5.0)
        junk = b"GET / HTTP/1.1\r\n"
        s.sendall(len(junk).to_bytes(4, "big") + junk)
        wait_until(lambda: metrics.fleet["protocol_errors"] == 1,
                   msg="protocol_errors counter")
        assert s.makefile("rb").read(1) == b""
        s.close()
    finally:
        _close(reg, slot)


def test_lease_holds_slot_then_expires_exactly_once():
    reg, slot, metrics = _registry("torch", lease_ttl_s=0.4)
    sup = ReplicaSupervisor([slot], slot.cfg, metrics=metrics)
    try:
        s, _, reply = _hello(reg.address, epoch=1)
        assert reply["ev"] == "hello_ok"
        send_frame(s, {"ev": "hb", "pid": os.getpid(), "stats": {
            "healthy": True, "busy": False, "queue_depth": 0,
            "outstanding_tokens": 0, "running": 0, "kv_utilization": 0.0,
            "progress_age": 0.0, "prefix": {}, "spec": {}}})
        wait_until(lambda: slot.liveness()["lease_remaining"] is not None,
                   msg="heartbeat opens the lease")
        _drop(s)  # network loss, not worker death
        wait_until(lambda: slot.liveness()["down"] == "connection_lost",
                   msg="reader declares connection_lost")
        sup._tick(slot)  # inside the lease: the slot is held open
        assert metrics.fleet["lease_expiries"] == 0
        assert not slot.lease_escalated
        wait_until(lambda: slot.liveness()["lease_remaining"] == 0.0,
                   msg="lease expiry")
        sup._tick(slot)
        sup._tick(slot)  # escalates once
        assert metrics.fleet["lease_expiries"] == 1
        assert slot.lease_escalated
    finally:
        _close(reg, slot)


# ---------------------------------------------------------------------------
# the scripted-worker fleet: loopback TCP, real processes, fake tokens
# ---------------------------------------------------------------------------


class _Fleet:
    def __init__(self, pool):
        self.pool = pool
        self.procs = []  # (name, Popen)

    def spawn(self, name, epoch, **kw):
        argv = [sys.executable, SCRIPTED, "--connect",
                self.pool.registry.address, "--name", name,
                "--epoch", str(epoch)]
        for k, v in kw.items():
            argv += [f"--{k}", str(v)]
        p = subprocess.Popen(argv, stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL)
        self.procs.append((name, p))
        return p


@pytest.fixture
def remote_fleet():
    fleets = []

    def make(workers=2, **cfg_over):
        pool = ReplicaPool.build_remote([], _cfg(**cfg_over),
                                        launch_workers=False)
        pool.start()
        fl = _Fleet(pool)
        fleets.append(fl)
        for i in range(workers):
            fl.spawn(f"replica{i}", 1)
        if workers:
            pool.wait_ready(timeout=15.0)
        return fl

    yield make
    for fl in fleets:
        try:
            fl.pool.shutdown()
        except Exception:
            pass
        for _, p in fl.procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=5.0)


def test_scripted_fleet_roundtrip_membership_prometheus(remote_fleet):
    fl = remote_fleet(workers=2)
    pool = fl.pool
    h = pool.submit([3, 4, 5], max_new_tokens=6)
    assert list(h.tokens(timeout=20.0)) == scripted_tokens([3, 4, 5], 6)
    assert h.finish_reason == "length"
    members = {m["worker"]: m for m in pool.registry.membership()}
    assert set(members) == {"replica0", "replica1"}
    assert all(m["connected"] and m["epoch"] == 1
               for m in members.values())
    wait_until(lambda: "dstpu_serving_registry_member"
               in pool.metrics.to_prometheus(),
               timeout=10.0, msg="membership gauge in /metrics")
    expo = pool.metrics.to_prometheus()
    assert 'worker="replica0"' in expo and 'epoch="1"' in expo
    for decision in ("up", "down", "blocked"):
        assert f"dstpu_serving_autoscale_{decision}" in expo
    health = pool.health()["replicas"]
    assert [r["transport"] for r in health] == ["remote", "remote"]
    assert all(r["externally_managed"] for r in health)


def test_mid_stream_tcp_drop_fails_over_token_identical(remote_fleet):
    fl = remote_fleet(workers=0)
    pool = fl.pool
    # replica0 severs its TCP connection after the 3rd token (one shot),
    # then dials back in like a worker riding out a network blip
    fl.spawn("replica0", 1, drop_after_toks=3, tok_delay_s=0.03)
    fl.spawn("replica1", 1, tok_delay_s=0.03)
    pool.wait_ready(timeout=15.0)
    pool.quiesce("replica1")  # force placement onto the dropper
    h = pool.submit([3, 4, 5], max_new_tokens=8)
    time.sleep(0.05)
    pool.resume_replica("replica1")
    assert list(h.tokens(timeout=20.0)) == scripted_tokens([3, 4, 5], 8)
    wait_until(lambda: any(m["worker"] == "replica0" and m["epoch"] == 2
                           and m["connected"]
                           for m in pool.registry.membership()),
               timeout=10.0, msg="dropped worker re-registers, epoch bumped")
    wait_until(lambda: all(t.outstanding_tokens() == 0
                           for t in pool.replicas),
               timeout=5.0, msg="no outstanding tokens after failover")


def test_worker_sigkill_fails_over_and_lease_expires(remote_fleet):
    fl = remote_fleet(workers=0, lease_ttl_s=0.8)
    pool = fl.pool
    fl.spawn("replica0", 1, tok_delay_s=0.05)
    fl.spawn("replica1", 1, tok_delay_s=0.05)
    pool.wait_ready(timeout=15.0)
    pool.quiesce("replica1")
    h = pool.submit([1, 2], max_new_tokens=8)
    time.sleep(0.12)
    victim = dict(fl.procs)["replica0"]
    os.kill(victim.pid, signal.SIGKILL)
    pool.resume_replica("replica1")
    assert list(h.tokens(timeout=20.0)) == scripted_tokens([1, 2], 8)
    # externally managed: the lease expires once, nothing respawns
    wait_until(lambda: pool.metrics.fleet["lease_expiries"] >= 1,
               timeout=10.0, msg="lease expiry escalation")
    time.sleep(0.4)
    assert pool.metrics.fleet["lease_expiries"] == 1
    assert pool.healthy_replicas() == [1]
    members = {m["worker"]: m for m in pool.registry.membership()}
    assert members["replica0"]["connected"] is False
    assert members["replica1"]["connected"] is True
    assert victim.poll() is not None


def test_stale_epoch_returnee_fenced_and_exits(remote_fleet):
    fl = remote_fleet(workers=2)
    pool = fl.pool
    old = dict(fl.procs)["replica0"]
    fl.spawn("replica0", 2)  # a replacement claims the slot
    assert old.wait(timeout=15.0) == 3
    wait_until(lambda: pool.metrics.fleet["fenced"] >= 1,
               timeout=5.0, msg="fence counter")
    wait_until(lambda: pool.metrics.fleet["stale_epoch_rejects"] >= 1,
               timeout=5.0, msg="stale-epoch counter")
    wait_until(lambda: any(m["worker"] == "replica0" and m["epoch"] == 2
                           and m["connected"]
                           for m in pool.registry.membership()),
               timeout=10.0, msg="replacement owns the slot")
    h = pool.submit([9, 9], max_new_tokens=5)
    assert list(h.tokens(timeout=20.0)) == scripted_tokens([9, 9], 5)


def test_remove_replica_concurrent_single_release(remote_fleet):
    fl = remote_fleet(workers=0)
    pool = fl.pool
    results = []
    barrier = threading.Barrier(2)

    def rm():
        barrier.wait()
        results.append(pool.remove_replica("replica1"))

    ts = [threading.Thread(target=rm) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10.0)
    assert sorted(results) == [False, True]
    assert [t.name for t in pool.replicas] == ["replica0"]
    s, _, reply = _hello(pool.registry.address, name="replica1", epoch=1)
    assert reply == {"ev": "hello_err", "reason": "unknown_worker"}
    s.close()


def test_real_worker_dials_in_and_stale_launch_exits_fenced(tmp_path):
    """A launcher-backed pool spawns one real CPU worker (``python -m
    deepspeed_tpu_torch.serving.worker --connect ... --epoch 1 --device
    cpu``), which registers and serves; a second worker launched by hand
    under the same epoch is refused (``duplicate_epoch``) and exits 3; the
    drain leaves no process."""
    from deepspeed_tpu_torch.serving.worker import EXIT_FENCED

    argv = ["--model", "tiny", "--device", "cpu", "--seed", "0",
            "--num_blocks", "64", "--max_tokens_per_step", "32",
            "--max_seqs", "4", "--block_size", "8",
            "--max_blocks_per_seq", "8"]
    cfg = _cfg(num_replicas=1, spawn_timeout_s=SPAWN_S,
               submit_timeout_s=STREAM_S)
    pool = ReplicaPool.build_remote(argv, cfg)
    pool.start()
    try:
        pool.wait_ready(timeout=SPAWN_S)
        slot = pool.replicas[0]
        out = pool.submit(P, max_new_tokens=6).result(timeout=STREAM_S)
        assert len(out) == 6 and slot.epoch == 1
        env = dict(os.environ, PYTHONPATH=REPO)
        dup = subprocess.run(
            [sys.executable, "-m", "deepspeed_tpu_torch.serving.worker",
             "--name", "replica0", "--connect", pool.registry.address,
             "--epoch", "1", *argv], cwd=REPO, env=env, capture_output=True,
            text=True, timeout=SPAWN_S)
        log = dup.stdout + dup.stderr
        assert dup.returncode == EXIT_FENCED, log[-2000:]
        assert "duplicate_epoch" in log
        assert pool.submit(P, max_new_tokens=6).result(
            timeout=STREAM_S) == out
        proc = slot._proc
    finally:
        pool.drain(timeout=30.0)
    assert proc.wait(timeout=30.0) == 0


# ---------------------------------------------------------------------------
# the autoscaler's decisions, tick for tick with the reference's
# ---------------------------------------------------------------------------


class _FakeReplica:
    def __init__(self, name, pool, cls="mixed"):
        self.name, self.pool, self.replica_class = name, pool, cls
        self.backlog = 0

    def healthy(self):
        return True

    def queue_depth(self):
        # the pool-level knob spread over the replicas, or the replica's own
        return self.backlog or self.pool.queue / max(1, len(
            self.pool.replicas))

    def outstanding_tokens(self):
        return 0


class _FakePool:
    def __init__(self, n, cfg, metrics_cls, classes=()):
        self.cfg = cfg
        self.metrics = metrics_cls()
        self.replicas = [_FakeReplica(f"replica{i}", self,
                                      classes[i] if i < len(classes)
                                      else "mixed") for i in range(n)]
        self._quiesced = set()
        self.autoscaler = None
        self.queue = 0
        self.spawn_error = None
        self.spawned, self.retired = [], []

    def healthy_replicas(self):
        return [i for i, t in enumerate(self.replicas) if t.healthy()]

    def replicas_of_class(self, cls):
        return [i for i, t in enumerate(self.replicas)
                if t.replica_class == cls]

    def spawn_remote_replica(self, name=None, replica_class="mixed"):
        if self.spawn_error is not None:
            raise self.spawn_error
        name = name or f"replica{len(self.replicas)}"
        self.replicas = self.replicas + [
            _FakeReplica(name, self, replica_class)]
        self.spawned.append((name, replica_class))
        return name

    def retire_replica(self, name, drain_timeout_s):
        self.retired.append(name)
        self.replicas = [t for t in self.replicas if t.name != name]
        return True


def _lockstep(series, n=1, classes=(), **over):
    """Both packages' autoscalers over fake pools, driven by one scripted
    series of ``(pool queue, {replica index: backlog}, spawn error,
    seconds to sleep after the tick)``: after every tick, each side's
    decisions, spawned and retired slots and ban state."""
    sides = []
    for asc_cls, cfg_cls, met_cls in ((JAutoscaler, JServingConfig,
                                       JServingMetrics),
                                      (Autoscaler, ServingConfig,
                                       ServingMetrics)):
        law = dict(autoscale_min=1, autoscale_max=3, scale_up_pressure=10.0,
                   scale_up_debounce_s=0.05, scale_down_pressure=1.0,
                   scale_down_idle_s=0.05, autoscale_backoff_s=0.01,
                   autoscale_backoff_max_s=0.05, autoscale_max_spawn_fails=2,
                   drain_timeout_s=1.0)
        cfg = _cfg(cfg_cls, **{**law, **over})
        pool = _FakePool(n, cfg, met_cls, classes)
        sides.append((asc_cls(pool, cfg), pool))
    trace = {"jax": [], "torch": []}
    for queue, backlogs, err, pause in series:
        for (asc, pool), side in zip(sides, ("jax", "torch")):
            pool.queue = queue
            for i, b in backlogs.items():
                if i < len(pool.replicas):
                    pool.replicas[i].backlog = b
            pool.spawn_error = err
            asc._tick()
            trace[side].append((dict(asc.decisions), list(pool.spawned),
                                list(pool.retired), asc.banned))
        time.sleep(pause)
    assert sides[1][1].metrics.autoscale == sides[1][0].decisions
    return trace


HOT, IDLE, WAIT = 100, 0, 0.07


@pytest.mark.parametrize("case", [
    "debounce_up_blocked", "floor", "scale_down", "ban"])
def test_autoscaler_decisions_lockstep_with_reference(case):
    """The reference's four control-law stories (debounce then up, cool
    down, blocked once at max; the floor restored without debounce; idle
    retires the newest down to the floor; consecutive spawn failures ban
    growth) on one scripted pressure series, both autoscalers ticking in
    turn: every tick's decisions, spawns and retires equal."""
    boom = RuntimeError("no capacity")
    if case == "debounce_up_blocked":
        trace = _lockstep([(HOT, {}, None, WAIT), (HOT, {}, None, 0),
                           (HOT, {}, None, WAIT), (HOT, {}, None, 0),
                           (HOT, {}, None, WAIT), (HOT, {}, None, 0),
                           (HOT, {}, None, 0)], n=1)
        assert trace["torch"][-1][0] == {"up": 2, "down": 0, "blocked": 1}
    elif case == "floor":
        trace = _lockstep([(IDLE, {}, None, 0)], n=0)
        assert trace["torch"][-1][1] == [("replica0", "mixed")]
    elif case == "scale_down":
        trace = _lockstep([(IDLE, {}, None, WAIT)] * 8, n=3)
        assert trace["torch"][-1][2] == ["replica2", "replica1"]
    else:
        trace = _lockstep([(HOT, {}, boom, WAIT), (HOT, {}, boom, WAIT),
                           (HOT, {}, boom, WAIT)]
                          + [(HOT, {}, None, WAIT)] * 3, n=1)
        assert trace["torch"][-1][3] is True
        assert trace["torch"][-1][1] == []
    assert trace["torch"] == trace["jax"]


def test_autoscaler_class_groups_lockstep_with_reference():
    """Per-class bounds (prefill 1..2, decode 2..4): the decode class
    restored to its floor at once, the saturated prefill class grows to
    its max and then blocks — the same decisions as the reference's."""
    trace = _lockstep(
        [(IDLE, {}, None, 0), (IDLE, {0: HOT}, None, WAIT),
         (IDLE, {0: HOT}, None, 0), (IDLE, {0: HOT, 3: HOT}, None, WAIT),
         (IDLE, {0: HOT, 3: HOT}, None, 0)],
        n=2, classes=("prefill", "decode"),
        autoscale_class_bounds={"prefill": (1, 2), "decode": (2, 4)},
        scale_up_pressure=8.0)
    assert trace["torch"] == trace["jax"]
    assert [c for _, c in trace["torch"][-1][1]] == ["decode", "prefill"]
    assert trace["torch"][-1][0]["blocked"] >= 1


# ---------------------------------------------------------------------------
# rolling weight swaps (tiny engines on the reference's weights)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    """The reference's tiny weights A (key 0) and B (key 1), each with its
    port conversion, and the JAX broker's greedy tokens of P (12 new)
    on each."""
    cfg = jt.get_config("tiny", dtype="float32")
    tcfg = tt.get_config("tiny", dtype="float32")
    out = {"cfg": cfg, "tcfg": tcfg}
    for name, key in (("a", 0), ("b", 1)):
        jp = jt.init_params(jax.random.PRNGKey(key), cfg)
        out[name] = jp
        out[f"t{name}"] = tt.params_from_jax(
            jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
        broker = JBroker(je.InferenceEngineV2(cfg, jp, je.V2Config(**V2)),
                         JServingConfig()).start()
        try:
            out[f"ref_{name}"] = broker.submit(
                prompt=P, max_new_tokens=12).result(timeout=STREAM_S)
        finally:
            broker.stop(drain=False, timeout=5.0)
    assert out["ref_a"] != out["ref_b"]
    return out


def _teng(w, params):
    return te.InferenceEngineV2(w["tcfg"], params, te.V2Config(**V2),
                                device="cpu")


def test_broker_swap_and_rollback_unit(weights):
    """Swap, a refused swap and rollback on one broker; each request's
    ``weight_versions`` names the one weight generation that served it
    (the port's record: a new version at a swap, the old at rollback)."""
    w = weights
    broker = RequestBroker(_teng(w, w["ta"]), ServingConfig()).start()

    def run():
        h = broker.submit(prompt=P, max_new_tokens=6)
        return h.result(timeout=60), h.weight_versions

    try:
        out_a = run()
        assert out_a == (w["ref_a"][:6], {0})
        with pytest.raises(ValueError):  # not this model's tree
            broker.swap_params({"bogus": torch.ones(1)})
        assert run() == out_a
        broker.swap_params(w["tb"])
        assert run() == (w["ref_b"][:6], {1})
        broker.swap_rollback()
        assert run() == out_a
        broker.swap_params(w["tb"])
        assert run() == (w["ref_b"][:6], {2})
    finally:
        broker.stop(drain=False, timeout=5.0)


def test_weight_versions_record_a_swap_inside_a_stream(weights):
    """A swap made under a running stream (no drain: what the rollout's
    quiesce and drain exist to prevent) shows in that request's
    ``weight_versions`` as two generations: the record the card's rollout
    gate reads is taken per step, not once per request."""
    from deepspeed_tpu_torch.utils import faults

    w = weights
    broker = RequestBroker(_teng(w, w["ta"]), ServingConfig()).start()
    faults.configure({"serving.step": "delay:0.05"})
    try:
        h = broker.submit(prompt=P, max_new_tokens=12)
        it = h.tokens(timeout=60)
        toks = [next(it), next(it)]
        broker.engine.swap_params(w["tb"])
        toks += list(it)
        assert len(toks) == 12
        assert h.weight_versions == {0, 1}
    finally:
        faults.reset()
        broker.stop(drain=False, timeout=5.0)


def test_publish_params_bytes_equal_reference_and_cross_load(weights,
                                                             tmp_path):
    """``publish_params`` of the same weights by each package: the same
    files, byte for byte (safetensors and sha256 manifest), each loaded by
    the other's ``load_swap_params`` (the port's template is shapes on
    the meta device: no weights drawn)."""
    w = weights
    jdir = jrollout.publish_params(w["b"], str(tmp_path / "jax"), "v2")
    tdir = trollout.publish_params(w["tb"], str(tmp_path / "torch"), "v2")
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) == ["manifest.json",
                                                 "model.safetensors"]
    for n in names:
        with open(os.path.join(jdir, n), "rb") as a, \
                open(os.path.join(tdir, n), "rb") as b:
            assert a.read() == b.read(), n
    mine = trollout.load_swap_params(
        jdir, types.SimpleNamespace(model_cfg=w["tcfg"]))
    theirs = jrollout.load_swap_params(
        tdir, types.SimpleNamespace(model_cfg=w["cfg"]))
    flat_t = jax.tree_util.tree_leaves_with_path(w["tb"])
    assert len(flat_t) == len(jax.tree_util.tree_leaves(theirs))
    for (path, ref), (_, got) in zip(
            flat_t, jax.tree_util.tree_leaves_with_path(mine)):
        assert torch.equal(got, ref), path
    for a, b in zip(jax.tree_util.tree_leaves(theirs),
                    jax.tree_util.tree_leaves(w["b"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    tcfg_small = tt.get_config("tiny", dtype="float32", num_layers=1)
    with pytest.raises((KeyError, ValueError)):
        trollout.load_swap_params(
            tdir, types.SimpleNamespace(model_cfg=tcfg_small))


def test_rolling_swap_story(weights, tmp_path):
    """Publish → refuse a corrupt checkpoint → halt-and-rollback on a
    probe mismatch → zero-drop swap with streams in flight, on one
    two-replica pool of port engines: every greedy stream equals the JAX
    engine's on the weights it started on."""
    from deepspeed_tpu_torch.serving.rollout import (RolloutError,
                                                     RolloutHalted,
                                                     publish_params,
                                                     rolling_swap)

    w = weights
    scfg = ServingConfig(num_replicas=2, default_max_tokens=8,
                         rollout_drain_timeout_s=20.0,
                         rollout_probe_tokens=4,
                         rollout_probe_timeout_s=120.0)
    pool = ReplicaPool.build(lambda: _teng(w, w["ta"]), scfg)
    pool.start()
    try:
        assert list(pool.submit(P, max_new_tokens=6).tokens(
            timeout=STREAM_S)) == w["ref_a"][:6]
        d_good = publish_params(w["tb"], str(tmp_path), "v2")
        d_bad = publish_params(w["tb"], str(tmp_path), "corrupt")
        with open(os.path.join(d_bad, "model.safetensors"), "r+b") as f:
            f.seek(-1, os.SEEK_END)
            last = f.read(1)[0]
            f.seek(-1, os.SEEK_END)
            f.write(bytes([last ^ 0xFF]))
        with pytest.raises(RolloutError):
            rolling_swap(pool, d_bad, P)
        assert pool.metrics.fleet.get("worker_deaths", 0) == 0
        with pytest.raises(RolloutHalted):
            rolling_swap(pool, d_good, P, probe_expected=[0, 0, 0, 0])
        assert pool._quiesced == set()
        for _ in range(4):
            assert list(pool.submit(P, max_new_tokens=6).tokens(
                timeout=STREAM_S)) == w["ref_a"][:6]
        old = {i: t.engine.params_version
               for i, t in enumerate(pool.replicas)}
        inflight = [pool.submit(P, max_new_tokens=12) for _ in range(4)]
        summary = rolling_swap(pool, d_good, P)
        for h in inflight:
            assert list(h.tokens(timeout=STREAM_S)) == w["ref_a"]
            # every token from the weights the stream started on
            assert h.weight_versions == {(h.replica_index,
                                          old[h.replica_index])}
        assert all(t.engine.params_version != old[i]
                   for i, t in enumerate(pool.replicas))
        assert sorted(summary["swapped"]) == ["replica0", "replica1"]
        assert summary["probe_tokens"] == w["ref_b"][:4]
        assert pool._quiesced == set()
        for _ in range(4):
            assert list(pool.submit(P, max_new_tokens=6).tokens(
                timeout=STREAM_S)) == w["ref_b"][:6]
    finally:
        pool.shutdown()
