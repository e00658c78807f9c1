"""Parity: the port's serving front (``serving/broker.py``, ``balancer.py``,
``server.py``, ``metrics.py``; ``observability/prometheus.py`` and
``replay.py``) against the JAX package's, mirroring ``tests/test_serving.py``
on the tiny engine in f32 on the CPU.

The reference's weights cross over through ``params_from_jax``.  Broker
streams are token for token the JAX broker's; HTTP bodies equal the JAX
server's on the same traffic except ids and timestamps; ``/metrics``
carries the same families with the same counts; the Prometheus builder
writes the same bytes; workload captures agree except times; the SLO
loader reads the packaged ``slo.toml`` with stdlib ``tomllib``.  The
lifecycle (cancellation returns every block, 429 with ``Retry-After``,
504 past a deadline, invalid requests, transparent retry after a replica
dies, drain) runs on the port alone."""

import http.client
import json
import os
import queue as pyqueue
import shutil
import threading
import time
import tomllib

import jax
import numpy as np
import pytest

from deepspeed_tpu.inference.v2 import engine as je
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.observability import prometheus as jprom
from deepspeed_tpu.observability import replay as jrp
from deepspeed_tpu.serving import ReplicaPool as JPool
from deepspeed_tpu.serving import RequestBroker as JBroker
from deepspeed_tpu.serving import ServingConfig as JServingConfig
from deepspeed_tpu.serving import create_server as jcreate_server
from deepspeed_tpu_torch.inference.v2 import engine as te
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.monitor.monitor import CSVMonitor
from deepspeed_tpu_torch.observability import prometheus as tprom
from deepspeed_tpu_torch.observability import replay as trp
from deepspeed_tpu_torch.ops.hopper import build
from deepspeed_tpu_torch.serving import (InvalidRequestError, NoReplicaError,
                                         QueueFullError, ReplicaPool,
                                         RequestBroker, RequestFailedError,
                                         RequestState, ServingConfig,
                                         ServingMetrics, create_server)

from tests.torch_cpu import one_torch_thread  # noqa: F401

V2 = dict(max_tokens_per_step=32, max_seqs=4, block_size=8, num_blocks=64,
          max_blocks_per_seq=8, dtype="float32")
STREAM_S = 60.0
# every (prompt, max_new_tokens) a test below serves: the JAX broker
# serves them once, and each port path must give its tokens
JOBS = [((5, 6, 7), 6), ((9, 8, 7, 6), 4), ((11, 12), 8), ((1, 2, 3), 12),
        ((5, 6, 7), 8), ((6, 5, 4), 12), ((2, 3, 4), 6)] + \
    [((3, 1 + i), 5) for i in range(6)]


def wait_until(pred, timeout=30.0, interval=0.01, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


@pytest.fixture(scope="module")
def model():
    jcfg = jt.get_config("tiny", dtype="float32")
    params = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = tt.get_config("tiny", dtype="float32")
    tparams = tt.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                 tcfg, device="cpu")
    return jcfg, params, tcfg, tparams


def _jeng(model, **over):
    jcfg, params, _, _ = model
    return je.InferenceEngineV2(jcfg, params, je.V2Config(**{**V2, **over}))


def _teng(model, **over):
    _, _, tcfg, tparams = model
    return te.InferenceEngineV2(tcfg, tparams, te.V2Config(**{**V2, **over}),
                                device="cpu")


@pytest.fixture(scope="module")
def jax_tokens(model):
    """The JAX broker's stream for every job, served concurrently."""
    broker = JBroker(_jeng(model), JServingConfig(max_queue=64)).start()
    try:
        handles = {job: broker.submit(list(job[0]), max_new_tokens=job[1])
                   for job in JOBS}
        return {job: h.result(timeout=STREAM_S) for job, h in handles.items()}
    finally:
        broker.stop()


def _assert_no_block_leak(eng):
    eng.kv.allocator.check_consistency()
    assert eng.free_blocks + eng.evictable_blocks + eng.pinned_blocks == \
        eng.total_blocks
    assert eng.pinned_blocks == 0


# ---------------------------------------------------------------------------
# broker
# ---------------------------------------------------------------------------


def test_broker_streams_match_jax_broker(model, jax_tokens):
    broker = RequestBroker(_teng(model), ServingConfig()).start()
    jobs = JOBS[:3]
    handles = [broker.submit(list(p), max_new_tokens=n) for p, n in jobs]
    for job, h in zip(jobs, handles):
        assert list(h.tokens(timeout=STREAM_S)) == jax_tokens[job]
        assert h.state == RequestState.DONE and h.finish_reason == "length"
    snap = broker.metrics.snapshot()
    assert snap["completed"] == 3 and snap["ttft_ms_count"] == 3
    assert snap["tpot_ms_count"] > 0
    broker.stop()
    _assert_no_block_leak(broker.engine)


def test_broker_defers_admission_beyond_engine_capacity(model, jax_tokens):
    broker = RequestBroker(_teng(model, max_seqs=2),
                           ServingConfig(max_queue=16)).start()
    jobs = JOBS[-6:]
    handles = [broker.submit(list(p), max_new_tokens=n) for p, n in jobs]
    for job, h in zip(jobs, handles):
        assert h.result(timeout=STREAM_S) == jax_tokens[job]
    _assert_no_block_leak(broker.engine)
    broker.stop()


def test_broker_cancel_mid_stream_returns_every_block(model):
    eng = _teng(model)
    free0 = eng.kv.allocator.free_blocks
    broker = RequestBroker(eng, ServingConfig()).start()
    h = broker.submit([5, 6, 7], max_new_tokens=40)
    it = h.tokens(timeout=STREAM_S)
    got = [next(it) for _ in range(3)]
    h.cancel()
    got += list(it)  # the stream ends cleanly
    assert 3 <= len(got) < 40
    assert h.state == RequestState.CANCELLED
    wait_until(lambda: eng.kv.allocator.free_blocks == free0, timeout=10,
               msg="KV blocks returned")
    broker.stop()
    _assert_no_block_leak(eng)


def test_broker_queue_cap_and_deadline(model):
    broker = RequestBroker(_teng(model), ServingConfig(max_queue=2))
    h1 = broker.submit([1, 2], max_new_tokens=4)
    h2 = broker.submit([3, 4], max_new_tokens=4, deadline_s=0.01)
    with pytest.raises(QueueFullError):
        broker.submit([5, 6], max_new_tokens=4)
    assert broker.metrics.snapshot()["rejected"] == 1
    time.sleep(0.05)
    broker.start()
    assert len(h1.result(timeout=STREAM_S)) == 4
    with pytest.raises(RequestFailedError) as ei:
        h2.result(timeout=STREAM_S)
    assert ei.value.reason == "deadline" and h2.state == RequestState.FAILED
    assert broker.metrics.snapshot()["deadline_missed"] == 1
    broker.stop()


def test_broker_stop_tokens_and_invalid(model, jax_tokens):
    ref = jax_tokens[((5, 6, 7), 8)]
    k = next(i for i in range(1, len(ref)) if ref[i] not in ref[:i])
    broker = RequestBroker(_teng(model), ServingConfig())
    for bad in (dict(prompt=[], max_new_tokens=4),
                dict(prompt=[1], max_new_tokens=200),
                dict(prompt=[1], max_new_tokens=4, temperature=-1.0)):
        with pytest.raises(InvalidRequestError):
            broker.submit(bad.pop("prompt"), **bad)
    broker.start()
    h = broker.submit([5, 6, 7], max_new_tokens=8, stop_token_ids=[ref[k]])
    assert h.result(timeout=STREAM_S) == ref[:k]  # stop token excluded
    assert h.finish_reason == "stop"
    broker.stop()


# ---------------------------------------------------------------------------
# balancer
# ---------------------------------------------------------------------------


def _pool(model, scfg, **eng_over):
    return ReplicaPool.build(lambda: _teng(model, **eng_over), scfg,
                             metrics=ServingMetrics())


def test_pool_replica_kill_retried_transparently(model, jax_tokens):
    pool = _pool(model, ServingConfig(num_replicas=2)).start()
    h = pool.submit([1, 2, 3], max_new_tokens=12)
    it = h.tokens(timeout=STREAM_S)
    got = [next(it) for _ in range(3)]
    pool.kill_replica(h.replica_index)
    got += list(it)
    assert got == jax_tokens[((1, 2, 3), 12)]
    assert pool.metrics.snapshot()["failovers"] >= 1
    assert len(pool.healthy_replicas()) == 1
    pool.shutdown()


def test_pool_shares_one_copy_of_the_weights(model):
    pool = _pool(model, ServingConfig(num_replicas=2))
    a, b = (t.engine for t in pool.replicas)
    assert a.params["layers"]["attn"]["wq"] is \
        b.params["layers"]["attn"]["wq"] is \
        model[3]["layers"]["attn"]["wq"]
    assert a.caches["k"] is not b.caches["k"]


def test_pool_drain_rejects_new_finishes_old(model):
    pool = _pool(model, ServingConfig(num_replicas=1)).start()
    h = pool.submit([2, 3, 4], max_new_tokens=6)
    drainer = threading.Thread(target=pool.drain, args=(STREAM_S,))
    drainer.start()
    wait_until(lambda: not pool._accepting, timeout=10, msg="draining")
    with pytest.raises(NoReplicaError):
        pool.submit([1], max_new_tokens=2)
    assert len(h.result(timeout=STREAM_S)) == 6
    drainer.join(timeout=STREAM_S)
    assert not drainer.is_alive()


def test_kernel_library_builds_once_under_threads(monkeypatch):
    """Two replicas' engine threads reaching their first launch together
    build the library once and load it once."""
    builds, loads = [], []
    gate = threading.Event()

    def fake_build():
        builds.append(threading.get_ident())
        gate.wait(5.0)  # hold the first builder while the second arrives
        return 0.0, ""

    class FakeLib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    def fake_cdll(path):
        loads.append(path)
        return FakeLib()

    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(build, "build", fake_build)
    monkeypatch.setattr(build.ctypes, "CDLL", fake_cdll)
    got = []
    threads = [threading.Thread(target=lambda: got.append(build.load()))
               for _ in range(2)]
    for t in threads:
        t.start()
    wait_until(lambda: builds, timeout=5, msg="first build")
    time.sleep(0.05)
    gate.set()
    for t in threads:
        t.join(timeout=10)
    assert len(builds) == 1 and len(loads) == 1
    assert got[0] is got[1]


# ---------------------------------------------------------------------------
# HTTP front, against the JAX server
# ---------------------------------------------------------------------------


def _serve(pool, metrics, scfg, create):
    srv = create(pool, metrics, scfg, model_name="tiny")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _post(port, path, obj, timeout=STREAM_S):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", path, json.dumps(obj),
                 {"Content-Type": "application/json"})
    return conn, conn.getresponse()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=STREAM_S)
    conn.request("GET", path)
    resp = conn.getresponse()
    return resp.status, resp.read().decode()


def _strip(obj):
    """A response body without its request id and creation time."""
    return {k: v for k, v in obj.items() if k not in ("id", "created")}


TRAFFIC = [{"prompt": [5, 6, 7], "max_tokens": 6},
           {"prompt": "9 8 7 6", "max_tokens": 4, "stream": True},
           {"prompt": [11, 12], "max_tokens": 8, "stream": True},
           {"prompt": "1 2 3", "max_tokens": 12},
           {"prompt": [5, 6, 7], "max_tokens": 8, "stop_token_ids": [999]},
           {"prompt": []}, {"prompt": "not token ids"},
           {"prompt": [1], "n": 2}, {"prompt": [1], "max_tokens": 999},
           {"prompt": {"bad": 1}}, {"prompt": [1], "seed": "x"}]


def _http_session(port):
    """TRAFFIC sent one request at a time: [(status, bodies)]."""
    out = []
    for body in TRAFFIC:
        conn, resp = _post(port, "/v1/completions", body)
        raw = resp.read().decode()
        if body.get("stream") and resp.status == 200:
            chunks = [line[6:] for line in raw.splitlines()
                      if line.startswith("data: ")]
            assert chunks[-1] == "[DONE]"
            parsed = [_strip(json.loads(c)) for c in chunks[:-1]]
        else:
            parsed = _strip(json.loads(raw))
        out.append((resp.status, resp.getheader("Content-Type"), parsed))
        conn.close()
    conn, resp = _post(port, "/v1/cancel", {"id": "nope"})
    out.append((resp.status, None, json.loads(resp.read())))
    conn.close()
    return out


@pytest.fixture(scope="module")
def http_pair(model):
    """(JAX session, port session, JAX metrics text, port metrics text)
    on the same traffic, one replica each."""
    def run(pool_cls, create, cfg_cls, factory):
        scfg = cfg_cls(num_replicas=1, max_queue=32)
        pool = pool_cls.build(factory, scfg).start()
        srv = _serve(pool, pool.metrics, scfg, create)
        try:
            session = _http_session(srv.server_port)
            _, metrics = _get(srv.server_port, "/metrics")
            status, health = _get(srv.server_port, "/healthz")
            assert status == 200 and json.loads(health)["status"] == "ok"
            return session, metrics
        finally:
            pool.shutdown()
            srv.shutdown()

    js, jm = run(JPool, jcreate_server, JServingConfig,
                 lambda: _jeng(model))
    ts, tm = run(ReplicaPool, create_server, ServingConfig,
                 lambda: _teng(model))
    return js, ts, jm, tm


def test_http_bodies_equal_jax_server(http_pair, jax_tokens):
    js, ts, _, _ = http_pair
    assert [s for s, _, _ in ts] == [200] * 5 + [400] * 6 + [404]
    assert ts == js
    assert ts[0][2]["choices"][0]["tokens"] == jax_tokens[((5, 6, 7), 6)]


def test_metrics_families_and_counts_equal_jax_server(http_pair):
    _, _, jm, tm = http_pair
    jfam = jprom.parse_exposition(jm)
    tfam = tprom.parse_exposition(tm)
    assert {k: (v["type"], v["help"]) for k, v in tfam.items()} == \
        {k: (v["type"], v["help"]) for k, v in jfam.items()}
    for name in ("dstpu_serving_submitted", "dstpu_serving_completed",
                 "dstpu_serving_rejected", "dstpu_serving_tokens_out",
                 "dstpu_serving_cancelled", "dstpu_serving_failed"):
        assert tfam[name]["samples"] == jfam[name]["samples"], name
    assert tfam["dstpu_serving_completed"]["samples"][0][2] == 5
    for name, fam in tfam.items():  # every histogram saw as many samples
        if fam["type"] == "histogram":
            count = [s for s in fam["samples"] if s[0].endswith("_count")]
            jcount = [s for s in jfam[name]["samples"]
                      if s[0].endswith("_count")]
            assert count == jcount, name


def test_http_429_on_queue_overflow_and_504_past_deadline(model):
    scfg = ServingConfig(num_replicas=1, max_queue=1)
    pool = _pool(model, scfg)
    pool.start(paused=True)  # the queue can only grow: a certain overflow
    srv = _serve(pool, pool.metrics, scfg, create_server)
    port = srv.server_port
    done = pyqueue.Queue()

    def first():
        conn, resp = _post(port, "/v1/completions",
                           {"prompt": [1, 2], "max_tokens": 3,
                            "deadline_s": 0.01})
        done.put((resp.status, json.loads(resp.read())))
        conn.close()

    t = threading.Thread(target=first)
    t.start()
    wait_until(lambda: pool.queue_depth() >= 1, timeout=10, msg="queued")
    conn2, resp2 = _post(port, "/v1/completions",
                         {"prompt": [3, 4], "max_tokens": 3})
    assert resp2.status == 429
    assert resp2.getheader("Retry-After") == "1"
    assert json.loads(resp2.read())["error"]["type"] == "overloaded"
    conn2.close()
    time.sleep(0.05)
    pool.start_engines()  # the queued request is past its deadline
    status, obj = done.get(timeout=STREAM_S)
    assert status == 504 and obj["error"]["type"] == "deadline_exceeded"
    conn, resp = _post(port, "/v1/completions",
                       {"prompt": [3, 4], "max_tokens": 3})
    assert resp.status == 200
    resp.read()
    conn.close()
    assert pool.metrics.snapshot()["rejected"] >= 1
    status, body = _get(port, "/debug/requests")
    assert status == 200 and "requests" in json.loads(body)
    status, body = _get(port, "/debug/profile?seconds=0.05")
    assert status == 200, body
    profile_dir = json.loads(body)["profile_dir"]
    assert os.path.exists(os.path.join(profile_dir, "trace.json"))
    shutil.rmtree(profile_dir)
    # the fleet adapter ops run: a register without an adapter id is the
    # reference's 400 (the whole session is in test_torch_fleet_ops.py)
    conn, resp = _post(port, "/v1/adapters", {"op": "register"})
    assert resp.status == 400
    assert json.loads(resp.read())["error"]["message"] == \
        "adapter must be a string adapter id"
    conn.close()
    pool.shutdown()
    srv.shutdown()


def test_metrics_flow_to_monitor_csv(model, tmp_path):
    scfg = ServingConfig(num_replicas=1, metrics_interval_s=0.05)
    pool = ReplicaPool.build(lambda: _teng(model), scfg,
                             metrics=ServingMetrics(),
                             monitor=CSVMonitor(str(tmp_path),
                                                job_name="serving")).start()
    assert len(pool.submit([5, 5, 5], max_new_tokens=6).result(
        timeout=STREAM_S)) == 6
    time.sleep(0.2)  # let the pump emit
    pool.shutdown()
    names = {p.name for p in (tmp_path / "serving").glob("*.csv")}
    for expected in ("serving_ttft_ms_p50.csv", "serving_queue_depth.csv",
                     "serving_kv_utilization.csv", "serving_tokens_out.csv"):
        assert expected in names, (expected, names)


# ---------------------------------------------------------------------------
# observability: Prometheus builder, workload capture, SLO gate
# ---------------------------------------------------------------------------


def _exposition(prom):
    b = prom.ExpositionBuilder()
    b.counter("dstpu_x_total", "Requests.", 7)
    b.gauge("dstpu_y", "A gauge.", 0.125, labels={"replica": "r0"})
    b.gauge_series("dstpu_z", "Per replica.", [({"replica": "a"}, 1.0),
                                                ({"replica": "b\"q"}, 2.5)])
    h = prom.Histogram()
    for v in (0.3, 4.0, 17.0, 250.0, 1e9, float("inf")):
        h.observe(v)
    b.histogram("dstpu_lat_ms", "Latency.", h)
    return b.render()


def test_prometheus_text_byte_equal_reference():
    text = _exposition(tprom)
    assert text == _exposition(jprom)
    assert tprom.parse_exposition(text) == jprom.parse_exposition(text)
    for bad in ("x 1\n", "# TYPE x counter\nx{a=1} 1\n"):
        with pytest.raises(tprom.ExpositionError):
            tprom.parse_exposition(bad)
        with pytest.raises(jprom.ExpositionError):
            jprom.parse_exposition(bad)


def _capture(rp, broker):
    with rp.WorkloadCapture() as cap:
        h1 = broker.submit([5, 6, 7], max_new_tokens=4, deadline_s=30.0)
        h1.result(timeout=STREAM_S)
        h2 = broker.submit([8, 9], max_new_tokens=32, stop_token_ids=[3],
                           tenant="t1")
        h2.cancel()
        broker.submit([1, 2], max_new_tokens=2).result(timeout=STREAM_S)
    broker.submit([4, 4], max_new_tokens=2).result(timeout=STREAM_S)
    broker.stop()
    recs = []
    for r in cap.to_workload():
        rec = r.to_record()
        assert rec.pop("offset_s") >= 0.0
        if "cancel_after_s" in rec:
            assert rec.pop("cancel_after_s") >= 0.0
            rec["cancelled"] = True
        rec.pop("rid")
        recs.append(rec)
    meta = cap.meta()
    return recs, {k: v for k, v in meta.items() if k != "captured_wall"}


def test_replay_capture_equal_except_times(model):
    mine = _capture(trp, RequestBroker(_teng(model), ServingConfig()).start())
    ref = _capture(jrp, JBroker(_jeng(model), JServingConfig()).start())
    assert mine == ref
    assert len(mine[0]) == 3 and mine[1]["requests"] == 3


def test_replay_synthesis_and_port_replay(model, jax_tokens):
    meta, wl = trp.synthesize_workload(seed=11, num_requests=6,
                                       mean_rate_rps=24.0)
    jmeta, jwl = jrp.synthesize_workload(seed=11, num_requests=6,
                                         mean_rate_rps=24.0)
    assert meta == jmeta
    assert [r.to_record() for r in wl] == [r.to_record() for r in jwl]
    pool = _pool(model, ServingConfig(num_replicas=1, max_queue=32)).start()
    try:
        out = trp.replay_workload(pool, wl, time_scale=0.5)
    finally:
        pool.shutdown()
    s = out["summary"]
    assert s["requests"] == 6 and s["completed"] == 6 and s["failed"] == 0
    srt = sorted(wl, key=lambda r: r.offset_s)
    ref = JBroker(_jeng(model), JServingConfig(max_queue=32)).start()
    try:
        for req, got in zip(srt, out["requests"]):
            want = ref.submit(req.prompt, max_new_tokens=req.max_new_tokens)
            assert got["tokens"] == want.result(timeout=STREAM_S)
    finally:
        ref.stop()
    assert trp.check_slo(s, {"max_failed": 0, "min_goodput_rps": 0.0},
                         "smoke") == []


def test_load_slos_reads_the_packaged_file_with_tomllib():
    with open(trp.default_slo_path(), "rb") as f:
        raw = f.read()
    with open(jrp.default_slo_path(), "rb") as f:
        assert f.read() == raw  # the reference's file, as package data
    slos = trp.load_slos()
    assert slos == tomllib.loads(raw.decode())["workloads"]
    summary = {k[4:]: 1.0 for table in slos.values() for k in table
               if k != "description"}
    for name, table in slos.items():
        assert [v.to_dict() for v in trp.check_slo(summary, table, name)] \
            == [v.to_dict() for v in jrp.check_slo(summary, table, name)]
    with pytest.raises(trp.SLOError, match="vacuously"):
        trp.check_slo({}, {"max_ttft_ms_p95": 1.0}, "w")


def test_load_slos_unknown_key_is_hard_error(tmp_path):
    p = tmp_path / "slo.toml"
    p.write_text('[workloads."w"]\nmax_ttft_ms_p95 = 1.0\nmax_typo = 2\n')
    with pytest.raises(trp.SLOError, match="unknown SLO key"):
        trp.load_slos(str(p))
