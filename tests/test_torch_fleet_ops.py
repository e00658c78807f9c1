"""Parity: the port's fleet operations around the serving front — the fleet
adapter ops behind ``POST /v1/adapters`` (``adapters.fleet_register`` /
``fleet_retire``), ``python -m deepspeed_tpu_torch.observability``, the
frame-protocol check (``analysis/concurrency.py``), ``serving/bench.py``
and the server CLI's fleet options — against the JAX package's, on the
tiny engine in f32 on the CPU.

HTTP bodies of the adapter ops and of completions naming an adapter equal
the JAX server's (except ids and times); the observability CLI prints the
reference's text for the same flight dump and workload file; the protocol
check finds the reference's frame set; the bench's summaries carry their
keys and the mixed-GEMM sweep's plain version agrees with
dequantize-then-matmul; the server CLI serves with ``--replica_transport
remote --autoscale_max`` and with ``--replica_classes``.  Every
subprocess wait has its own limit."""

import argparse
import http.client
import json
import os

import jax
import numpy as np
import pytest

from deepspeed_tpu.analysis import concurrency as jconc
from deepspeed_tpu.inference.v2 import engine as je
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.observability import __main__ as jobs_cli
from deepspeed_tpu.serving import ReplicaPool as JPool
from deepspeed_tpu.serving import ServingConfig as JServingConfig
from deepspeed_tpu.serving import create_server as jcreate_server
from deepspeed_tpu.serving.adapters import publish_adapter
from deepspeed_tpu.serving.server import \
    add_engine_cli_args as jadd_engine_cli_args
from deepspeed_tpu.serving.server import \
    build_adapter_factory as jbuild_adapter_factory
from deepspeed_tpu_torch.analysis import concurrency as tconc
from deepspeed_tpu_torch.inference.v2 import engine as te
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.observability import __main__ as tobs_cli
from deepspeed_tpu_torch.observability.recorder import recorder
from deepspeed_tpu_torch.observability import replay as trp
from deepspeed_tpu_torch.serving import (ReplicaPool, ServingConfig, bench,
                                         create_server, fleet_register,
                                         fleet_retire)
from deepspeed_tpu_torch.serving.adapters import AdapterError
from deepspeed_tpu_torch.serving.server import (add_engine_cli_args,
                                                build_adapter_factory,
                                                launch_server_subprocess,
                                                stop_server)

from tests.torch_cpu import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V2 = dict(max_tokens_per_step=32, max_seqs=4, block_size=8, num_blocks=64,
          max_blocks_per_seq=8, dtype="float32")
ADAPTERS = dict(adapter_slots=4, adapter_rank=4)
STREAM_S = 60.0
# a CPU server with one tiny replica (or one dial-in worker) is up in a few
# seconds: twenty times that before the launch is called hung
SERVER_S = 120.0


@pytest.fixture(scope="module")
def model():
    jcfg = jt.get_config("tiny", dtype="float32")
    params = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = tt.get_config("tiny", dtype="float32")
    tparams = tt.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                 tcfg, device="cpu")
    return jcfg, params, tcfg, tparams


@pytest.fixture(scope="module")
def adapter_ckpt(model, tmp_path_factory):
    """One rank-4 adapter over the attention projections, published by the
    reference's ``publish_adapter`` (the port writes the same bytes)."""
    jcfg = model[0]
    rng = np.random.default_rng(7)
    tree = {t: {"lora_a": (rng.standard_normal((jcfg.num_layers, K, 4))
                           / np.sqrt(K)).astype(np.float32),
                "lora_b": rng.standard_normal(
                    (jcfg.num_layers, 4, N)).astype(np.float32)}
            for t, (K, N) in je.adapter_target_shapes(jcfg).items()}
    return publish_adapter(tree, str(tmp_path_factory.mktemp("adapters")),
                           "tenant0", scaling=0.5)


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=STREAM_S)
    conn.request("POST", path, json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read())
    conn.close()
    return out


def _strip(obj):
    return {k: v for k, v in obj.items() if k not in ("id", "created")}


def _adapter_session(port, ckpt, bad_ckpt):
    """Register, serve with and without the adapter, bad ops, retire, a
    request naming the retired adapter: [(status, body)]."""
    out = []
    for body in ({"op": "register", "adapter": "tenant0", "ckpt_dir": ckpt},
                 {"op": "register", "adapter": "tenant1",
                  "ckpt_dir": bad_ckpt},
                 {"op": "register", "adapter": "tenant0"},
                 {"op": "bogus", "adapter": "tenant0"},
                 {"op": "retire", "adapter": 7}):
        out.append(_post(port, "/v1/adapters", body))
    for body in ({"prompt": [5, 6, 7], "max_tokens": 6, "adapter":
                  "tenant0"},
                 {"prompt": [5, 6, 7], "max_tokens": 6},
                 {"prompt": [9, 8], "max_tokens": 4, "adapter": "nope"}):
        status, resp = _post(port, "/v1/completions", body)
        out.append((status, _strip(resp) if status == 200 else resp))
    out.append(_post(port, "/v1/adapters", {"op": "retire",
                                            "adapter": "tenant0"}))
    status, resp = _post(port, "/v1/completions", {
        "prompt": [5, 6, 7], "max_tokens": 6, "adapter": "tenant0"})
    out.append((status, resp))
    return out


def _serve(pool, scfg, create):
    import threading

    srv = create(pool, pool.metrics, scfg, port=0, model_name="tiny")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def test_fleet_adapter_http_bodies_equal_jax_server(model, adapter_ckpt,
                                                    tmp_path):
    """``POST /v1/adapters`` register / retire across two replicas, the bad
    ops' 400s, completions naming the adapter (its tokens differ from the
    base's), naming an unknown or retired one: status and body equal the
    JAX server's, request for request."""
    jcfg, params, tcfg, tparams = model
    bad = str(tmp_path / "missing")

    def run(pool_cls, create, cfg_cls, factory, adapter_factory):
        scfg = cfg_cls(num_replicas=2, max_queue=32)
        pool = pool_cls.build(factory, scfg,
                              adapter_factory=adapter_factory).start()
        srv = _serve(pool, scfg, create)
        try:
            return _adapter_session(srv.server_port, adapter_ckpt, bad)
        finally:
            pool.shutdown()
            srv.shutdown()

    def args(add):
        p = argparse.ArgumentParser()
        add(p)
        return p.parse_args(["--adapter_slots", "4", "--adapter_rank", "4"])

    js = run(JPool, jcreate_server, JServingConfig,
             lambda: je.InferenceEngineV2(jcfg, params,
                                          je.V2Config(**V2, **ADAPTERS)),
             jbuild_adapter_factory(args(jadd_engine_cli_args)))
    ts = run(ReplicaPool, create_server, ServingConfig,
             lambda: te.InferenceEngineV2(tcfg, tparams,
                                          te.V2Config(**V2, **ADAPTERS),
                                          device="cpu"),
             build_adapter_factory(args(add_engine_cli_args)))
    assert ts == js
    assert ts[0] == (200, {"adapter": "tenant0",
                           "registered": ["replica0", "replica1"],
                           "failed": {}})
    assert [s for s, _ in ts] == [200, 400, 400, 400, 400, 200, 200, 400,
                                  200, 400]
    adapted, base = (ts[i][1]["choices"][0]["tokens"] for i in (5, 6))
    assert adapted != base
    assert ts[8][1]["retired"] == ["replica0", "replica1"]


def test_fleet_register_refuses_unverified_checkpoint(model, adapter_ckpt,
                                                      tmp_path):
    """A checkpoint whose manifest does not verify never reaches a
    replica; retiring an adapter a replica never had is reported as that
    replica's failure, as the reference reports it; register then retire
    walk the fleet; a pool with nothing healthy refuses."""
    _, _, tcfg, tparams = model
    scfg = ServingConfig(num_replicas=1)
    pool = ReplicaPool.build(
        lambda: te.InferenceEngineV2(tcfg, tparams,
                                     te.V2Config(**V2, **ADAPTERS),
                                     device="cpu"), scfg,
        adapter_factory=lambda eng, name: __import__(
            "deepspeed_tpu_torch.serving.adapters",
            fromlist=["AdapterRegistry"]).AdapterRegistry(eng, name=name))
    pool.start()
    try:
        corrupt = str(tmp_path / "corrupt")
        os.makedirs(corrupt)
        with pytest.raises(AdapterError, match="refusing fleet register"):
            fleet_register(pool, "tenant0", corrupt)
        unknown = fleet_retire(pool, "tenant0")
        assert unknown["retired"] == [] and list(unknown["failed"]) == [
            "replica0"]
        assert fleet_register(pool, "tenant0", adapter_ckpt)[
            "registered"] == ["replica0"]
        assert fleet_retire(pool, "tenant0") == {
            "adapter": "tenant0", "retired": ["replica0"], "failed": {}}
    finally:
        pool.shutdown()
    with pytest.raises(AdapterError, match="no healthy replicas"):
        fleet_register(pool, "tenant0", adapter_ckpt)


# ---------------------------------------------------------------------------
# python -m deepspeed_tpu_torch.observability
# ---------------------------------------------------------------------------


def _cli(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def test_observability_cli_equals_reference(model, tmp_path, capsys):
    """A flight dump of a served batch (request timelines, engine steps,
    infra events), rendered directly and through ``--latest DIR``, and a
    seeded workload file summarized by ``workload``: the port's CLI prints
    the reference's text."""
    _, _, tcfg, tparams = model
    recorder.clear()
    pool = ReplicaPool.build(
        lambda: te.InferenceEngineV2(tcfg, tparams, te.V2Config(**V2),
                                     device="cpu"),
        ServingConfig(num_replicas=1)).start()
    try:
        for prompt in ([5, 6, 7], [9, 8, 7, 6]):
            pool.submit(prompt, max_new_tokens=4).result(timeout=STREAM_S)
        recorder.record_event("replica/spawn", replica="replica0",
                                   pid=1, generation=0)
    finally:
        pool.shutdown()
    flight = tmp_path / "flight"
    flight.mkdir()
    dump = recorder.dump(str(flight / "flight_1_manual_1.json"))
    assert dump is not None
    meta, wl = trp.synthesize_workload(seed=3, num_requests=12,
                                       cancel_fraction=0.25, tenants=2)
    trace = str(tmp_path / "workload.jsonl")
    trp.save_workload(trace, wl, meta)
    for argv in ([dump], [dump, "--requests", "1"],
                 ["--latest", str(flight)], ["workload", trace],
                 ["workload", trace, "--prefix_len", "4"]):
        mine = _cli(tobs_cli.main, argv, capsys)
        assert mine == _cli(jobs_cli.main, argv, capsys), argv
        assert mine[0] == 0 and mine[1].strip()
    rendered = _cli(tobs_cli.main, [dump], capsys)[1]
    assert "engine steps" in rendered and "replica/spawn" in rendered
    assert _cli(tobs_cli.main, ["--latest", str(tmp_path)], capsys)[0] == 1


# ---------------------------------------------------------------------------
# the frame-protocol check
# ---------------------------------------------------------------------------


def _frames(mod, paths):
    out = {"sent": {}, "handled": {}}
    for p in paths:
        with open(p) as f:
            ex = mod.extract_protocol(f.read(), p)
        for kind in out:
            for chan, lits in ex[kind].items():
                out[kind].setdefault(chan, set()).update(lits)
    return out


def test_frame_protocol_exhaustive_and_equal_reference(tmp_path):
    """The port's transport, worker and remote files: no frame sent
    without a handler, no dead handler, the submit and heartbeat fields
    exhaustive — and the same frame types, sent and handled, as the
    reference's files.  A dead handler planted in a copy is found."""
    mine = tconc.default_protocol_paths()
    assert [os.path.basename(p) for p in mine] == [
        "transport.py", "worker.py", "remote.py"]
    assert "deepspeed_tpu_torch" in mine[0]
    assert tconc.check_frame_protocol() == []
    assert tconc.check_frame_fields() == []
    assert _frames(tconc, mine) == _frames(jconc,
                                           jconc.default_protocol_paths())
    bad = tmp_path / "worker.py"
    with open(mine[1]) as f:
        bad.write_text(f.read() + "\nif op == 'teleport':\n    pass\n")
    problems = tconc.check_frame_protocol([mine[0], str(bad), mine[2]])
    assert len(problems) == 1 and "'teleport'" in problems[0]
    assert tconc.main([]) == 0


# ---------------------------------------------------------------------------
# serving/bench.py on the CPU
# ---------------------------------------------------------------------------


def test_bench_gemm_sweep_plain_agrees_and_refusals(tmp_path):
    """``run_gemm_sweep`` on the CPU runs ``mixed_gemm``'s plain version:
    every cell (bits 8/4/6, whole-column and 128 groups) within its limit
    of dequantize-then-matmul; the tile search refuses naming A14; ``--out``
    never writes ``BENCH_EVIDENCE.json``; the default output lies under
    the checkout's git-ignored ``build/``."""
    res = bench.run_gemm_sweep(ms=(1, 8), shapes=((256, 256), (256, 704)),
                               device="cpu")
    assert len(res["cells"]) == 2 * 3 * 2 * 2
    assert all(c["within_tol"] and c["rel_err"] <= 1e-2
               for c in res["cells"])
    assert {c["group"] for c in res["cells"]} == {128, 256}
    with pytest.raises(NotImplementedError, match="A14"):
        bench.run_gemm_sweep(ms=(1,), shapes=((256, 256),), tune_tiles=True,
                             device="cpu")
    with pytest.raises(SystemExit):
        bench.main(["--mode", "gemm", "--device", "cpu", "--out",
                    str(tmp_path / "BENCH_EVIDENCE.json")])
    assert bench.DEFAULT_OUT == os.path.join(REPO, "build",
                                             "serving_bench.json")
    out = str(tmp_path / "b.json")
    assert bench.main(["--mode", "gemm", "--device", "cpu", "--gemm_ms", "2",
                       "--gemm_bits", "8", "--out", out]) == 0
    with open(out) as f:
        assert len(json.load(f)["mixed_gemm"]["cells"]) == 5


@pytest.mark.parametrize("mode", ["classes", "remote_autoscaled"])
def test_bench_replay_summaries(mode):
    """``run_replay`` at the pool: replica classes run the workload
    disaggregated and all-mixed and report the decode TPOT delta; the
    remote transport runs CPU dial-in workers under the autoscaler, which
    scales up under the replay and back down when idle.  Both gate on the
    packaged ``slo.toml`` with no violation, no leaked block or worker."""
    if mode == "classes":
        res = bench.run_replay(seed=1, requests=16, rate_rps=16.0,
                               replicas=2, replica_classes="prefill,decode",
                               tenants=2, device="cpu")
        assert res["replica_classes"] == ["prefill", "decode"]
        assert res["route_stats"]["prefill"] + \
            res["route_stats"]["decode"] >= 16
        assert res["disagg_tpot_ms_p99_delta"] is not None
        assert {r["tenant"] for r in res["tenant_goodput"]} >= {
            "tenant0", "tenant1"}
    else:
        res = bench.run_replay(seed=2, requests=48, rate_rps=48.0,
                               transport="remote", autoscale_min=1,
                               autoscale_max=2, max_new_tokens=24,
                               device="cpu")
        assert res["autoscale"]["decisions"]["up"] >= 1
        assert res["autoscale"]["decisions"]["down"] >= 1
        assert res["leaked_worker_processes_after_drain"] == 0
    assert res["slo_violations"] == []
    assert res["leaked_blocks_after_idle"] == 0
    assert set(res["summary"]) >= {"completed", "ttft_ms_p99",
                                   "tpot_ms_p99", "goodput_rps"}


def test_bench_serving_sweep_cpu_server():
    """``--mode serving``: a server subprocess on the CPU at two offered
    rates, every request answered, the sweep's columns filled."""
    res = bench.run_sweep([4.0, 8.0], duration_s=1.0, max_tokens=4,
                          replicas=1, device="cpu")
    assert res["graceful_shutdown_rc"] == 0
    assert res["subject"].startswith("--model tiny on cpu")
    for point in res["sweep"]:
        assert point["failed"] == 0 and point["completed"] == \
            point["requests"] - point["rejected_429"]
        assert set(point) == {
            "offered_rps", "requests", "completed", "rejected_429", "failed",
            "goodput_rps", "tokens_per_s", "ttft_s_p50", "ttft_s_p95",
            "e2e_s_p50", "e2e_s_p95"}


# ---------------------------------------------------------------------------
# the server CLI's fleet options
# ---------------------------------------------------------------------------


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=STREAM_S)
    conn.request("GET", path)
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read())
    conn.close()
    return out


@pytest.mark.parametrize("fleet", ["remote", "classes"])
def test_server_cli_runs_fleet_options(fleet):
    """The options that refused until the port had the fleet run:
    ``--replica_transport remote`` with ``--autoscale_max`` and
    ``--autoscale_class_bounds`` (one CPU worker dials in; ``/healthz``
    shows its epoch; ``/metrics`` the autoscaler's counters), and
    ``--replica_classes prefill,decode`` in process; each answers a
    completion and drains to rc 0."""
    extra = (["--replica_transport", "remote", "--replicas", "1",
              "--autoscale_max", "2", "--autoscale_class_bounds",
              "mixed=1:2"] if fleet == "remote"
             else ["--replicas", "2", "--replica_classes", "prefill,decode"])
    proc, url = launch_server_subprocess(
        ["--model", "tiny", "--device", "cpu", "--port", "0",
         "--max_tokens_per_step", "32", "--max_seqs", "4",
         "--block_size", "8", "--num_blocks", "64",
         "--max_blocks_per_seq", "8", *extra], timeout_s=SERVER_S)
    try:
        port = int(url.rsplit(":", 1)[1])
        status, body = _post(port, "/v1/completions",
                             {"prompt": [5, 6, 7], "max_tokens": 6})
        assert status == 200 and len(body["choices"][0]["tokens"]) == 6
        status, health = _get(port, "/healthz")
        reps = health["replicas"]
        if fleet == "remote":
            assert [r["transport"] for r in reps] == ["remote"]
            assert reps[0]["epoch"] == 1
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=STREAM_S)
            conn.request("GET", "/metrics")
            text = conn.getresponse().read().decode()
            conn.close()
            assert "dstpu_serving_autoscale_up" in text
        else:
            assert [r["replica_class"] for r in reps] == ["prefill",
                                                          "decode"]
    finally:
        assert stop_server(proc, term_timeout_s=SERVER_S) == 0
        proc.stdout.close()
