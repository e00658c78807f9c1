"""Parity: disaggregated prefill/decode serving on the port (replica
classes, phase routing, cache-aware placement, the KV prefix handoff
between replicas, per-row sampling, tenant SLO classes), mirroring
``tests/test_disagg.py`` on the tiny engine in f32 on the CPU.

The reference's weights cross over through ``params_from_jax``, and the
JAX broker's greedy streams are the oracle: greedy rows batched beside
sampled rows, and a decode replica serving from a handed-off prefix, give
its tokens.  The handoff runs on a JAX pool and a port pool side by side:
the exported payloads carry the same header and the same KV blocks (to f32
rounding: each engine computed its own), and both decode replicas emit the
same tokens."""

import json
import time

import jax
import numpy as np
import pytest

from deepspeed_tpu.inference.v2 import engine as je
from deepspeed_tpu.inference.v2.paging import deserialize_block
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.serving import ReplicaPool as JPool
from deepspeed_tpu.serving import RequestBroker as JBroker
from deepspeed_tpu.serving import ServingConfig as JServingConfig
from deepspeed_tpu.serving import config as jconfig
from deepspeed_tpu_torch.inference.v2 import engine as te
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.serving import (InvalidRequestError, ReplicaPool,
                                         RequestBroker, ServingConfig,
                                         ServingMetrics)
from deepspeed_tpu_torch.serving import config as tconfig
from deepspeed_tpu_torch.serving.remote import (FLEET_MAGIC, PROTO_VERSION,
                                                WorkerRegistry)

from tests.torch_cpu import one_torch_thread  # noqa: F401

V2 = dict(max_tokens_per_step=32, max_seqs=4, block_size=8, num_blocks=64,
          max_blocks_per_seq=8, dtype="float32")
STREAM_S = 120.0
HANDOFF = list(range(50, 75))  # 3 full blocks of 8 and a ragged tail
JOBS = [((3, 5, 7), 8), ((9, 2), 8), (tuple(HANDOFF), 2),
        (tuple(HANDOFF), 6)]


@pytest.fixture(scope="module")
def model():
    jcfg = jt.get_config("tiny", dtype="float32")
    params = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = tt.get_config("tiny", dtype="float32")
    tparams = tt.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                 tcfg, device="cpu")
    return jcfg, params, tcfg, tparams


@pytest.fixture(scope="module")
def jax_tokens(model):
    """The JAX broker's greedy stream for every job."""
    jcfg, params = model[:2]
    broker = JBroker(je.InferenceEngineV2(jcfg, params, je.V2Config(**V2)),
                     JServingConfig(max_queue=64)).start()
    try:
        handles = {job: broker.submit(list(job[0]), max_new_tokens=job[1])
                   for job in JOBS}
        return {job: h.result(timeout=STREAM_S) for job, h in handles.items()}
    finally:
        broker.stop()


def _teng(model, **over):
    _, _, tcfg, tparams = model
    return te.InferenceEngineV2(tcfg, tparams, te.V2Config(**{**V2, **over}),
                                device="cpu")


def _pool(model, scfg, **eng_over):
    return ReplicaPool.build(lambda: _teng(model, **eng_over), scfg,
                             metrics=ServingMetrics())


# ---------------------------------------------------------------------------
# per-row sampling through the serving path
# ---------------------------------------------------------------------------


def test_greedy_rows_bit_identical_next_to_sampled_rows(model, jax_tokens):
    pool = _pool(model, ServingConfig(num_replicas=1))
    pool.start(paused=True)  # queues hold: all four rows co-batch
    greedy = [pool.submit([3, 5, 7], max_new_tokens=8),
              pool.submit([9, 2], max_new_tokens=8)]
    sampled = [pool.submit([4, 4, 4], max_new_tokens=8, temperature=0.9,
                           seed=123),
               pool.submit([8, 1], max_new_tokens=8, temperature=1.3)]
    pool.start_engines()
    try:
        for h, job in zip(greedy, JOBS[:2]):
            assert h.result(timeout=STREAM_S) == jax_tokens[job]
        for h in sampled:
            assert len(h.result(timeout=STREAM_S)) == 8
    finally:
        pool.shutdown()


def test_per_request_temperature_no_longer_rejected(model):
    broker = RequestBroker(_teng(model), ServingConfig(temperature=0.0))
    broker.start()
    try:
        h = broker.submit([1, 2, 3], max_new_tokens=4, temperature=0.7)
        assert len(h.result(timeout=STREAM_S)) == 4
        with pytest.raises(InvalidRequestError):
            broker.submit([1, 2, 3], max_new_tokens=4, temperature=-0.5)
    finally:
        broker.stop(drain=False)


# ---------------------------------------------------------------------------
# phase-class routing
# ---------------------------------------------------------------------------


def test_phase_routing_prefers_matching_class(model):
    pool = _pool(model, ServingConfig(
        num_replicas=2, replica_classes=("prefill", "decode")))
    pool.start()
    try:
        health = pool.health()
        assert [r["replica_class"] for r in health["replicas"]] == \
            ["prefill", "decode"]
        # decode-heavy: short prompt, large budget → the decode class;
        # prefill-heavy: prompt >= phase_prefill_ratio * budget
        d = pool.submit([1, 2, 3], max_new_tokens=12)
        p = pool.submit(list(range(1, 33)), max_new_tokens=4)
        d.result(timeout=STREAM_S)
        p.result(timeout=STREAM_S)
        assert (d.replica_index, p.replica_index) == (1, 0)
        assert pool.route_stats["decode"] >= 1
        assert pool.route_stats["prefill"] >= 1
        assert pool._request_phase(32, 4) == "prefill"
        assert pool._request_phase(3, 12) == "decode"
    finally:
        pool.shutdown()


def test_phase_routing_degrades_to_mixed(model):
    pool = _pool(model, ServingConfig(num_replicas=1,
                                      replica_classes=("decode",)))
    pool.start()
    try:
        h = pool.submit(list(range(1, 33)), max_new_tokens=2)
        assert len(h.result(timeout=STREAM_S)) == 2
    finally:
        pool.shutdown()


@pytest.mark.parametrize("fn,text", [
    ("parse_replica_classes", "prefill,decode"),
    ("parse_replica_classes", "prefil"),
    ("parse_replica_classes", None),
    ("parse_slo_classes", "a:0:2.5,b:1:0"),
    ("parse_slo_classes", "a:0"),
    ("parse_class_bounds", "decode=1:4,prefill=1:2"),
    ("parse_class_bounds", "warp=1:4")])
def test_parse_helpers_equal_reference(fn, text):
    def call(mod):
        try:
            return ("ok", getattr(mod, fn)(text))
        except ValueError as e:
            return ("ValueError", str(e))

    assert call(tconfig) == call(jconfig)


def test_registry_rejects_bad_class_hello():
    reg = WorkerRegistry(ServingConfig())
    hello = {"op": "hello", "magic": FLEET_MAGIC, "version": PROTO_VERSION,
             "name": "w0", "pid": 1, "class": "warp"}
    assert reg._validate(hello)[0] == "bad_class"
    hello["class"] = "decode"
    assert reg._validate(hello)[0] == "unknown_worker"


# ---------------------------------------------------------------------------
# cache-aware routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("aware", [True, False])
def test_cache_aware_routing(model, aware):
    """On: every request sharing a warm 3-block prefix lands on the
    replica holding it (a routed cache hit each); off: no cache-aware
    routing happens."""
    pool = _pool(model, ServingConfig(num_replicas=2,
                                      cache_aware_routing=aware),
                 enable_prefix_cache=True)
    pool.start()
    try:
        warm_prompt = list(range(100, 124))
        h0 = pool.submit(warm_prompt, max_new_tokens=2)
        h0.result(timeout=STREAM_S)
        for i in range(4):
            h = pool.submit(warm_prompt + [7 + i], max_new_tokens=2)
            h.result(timeout=STREAM_S)
            if aware:
                assert h.replica_index == h0.replica_index
        hits = pool.route_stats["cache_hits"]
        assert hits >= 4 if aware else hits == 0
    finally:
        pool.shutdown()


# ---------------------------------------------------------------------------
# KV prefix handoff between replicas
# ---------------------------------------------------------------------------


def _header(payload: bytes) -> dict:
    n = int.from_bytes(payload[:8], "little")
    return json.loads(payload[8:8 + n])


def _handoff(pool, eng_of):
    """Serve HANDOFF on one replica, hand its prefix to the other, then
    serve it on the importing replica: (payload, covered, tokens,
    importer's prefix stats)."""
    h = pool.submit(HANDOFF, max_new_tokens=2)
    first = h.result(timeout=STREAM_S)
    src = h.replica_index
    dst = 1 - src
    payload = eng_of(src).export_prefix(HANDOFF)
    covered = pool.handoff_prefix(pool.replicas[src].name,
                                  pool.replicas[dst].name, HANDOFF)
    assert eng_of(dst).prefix_summary()["digests"]
    out = pool.replicas[dst].broker.submit(
        HANDOFF, max_new_tokens=6).result(timeout=STREAM_S)
    return first, payload, covered, out, eng_of(dst).prefix_stats()


def test_prefix_handoff_token_identity_against_jax_pool(model, jax_tokens):
    """The same handoff on a JAX pool and a port pool: the exported
    payloads carry the same header and KV blocks, every full block travels
    (24 of 25
    tokens), and the importing replica decodes the JAX broker's tokens,
    prefilling only the ragged tail."""
    jcfg, params = model[:2]
    jpool = JPool.build(lambda: je.InferenceEngineV2(
        jcfg, params, je.V2Config(**V2, enable_prefix_cache=True)),
        JServingConfig(num_replicas=2))
    jpool.start()
    try:
        jres = _handoff(jpool, lambda i: jpool.replicas[i].engine)
    finally:
        jpool.shutdown()
    pool = _pool(model, ServingConfig(num_replicas=2),
                 enable_prefix_cache=True)
    pool.start()
    try:
        tres = _handoff(pool, lambda i: pool.replicas[i].engine)
    finally:
        pool.shutdown()
    first, payload, covered, out, stats = tres
    assert first == jax_tokens[(tuple(HANDOFF), 2)]
    assert covered == 24 and out == jax_tokens[(tuple(HANDOFF), 6)]
    assert stats["hits"] >= 1 and stats["prefill_tokens_skipped"] >= 16
    # the same header (tokens, block size, shapes, dtypes, offsets) and
    # the same KV blocks up to f32 rounding: each engine computed its own
    assert _header(payload) == _header(jres[1])
    mine, theirs = deserialize_block(payload), deserialize_block(jres[1])
    assert sorted(mine) == sorted(theirs) == ["k", "v"]
    for name in mine:
        np.testing.assert_allclose(np.asarray(mine[name]),
                                   np.asarray(theirs[name]), atol=1e-5,
                                   rtol=1e-5)
    assert tres[2:4] == jres[2:4]
    assert {k: stats[k] for k in ("hits", "prefill_tokens_skipped")} == \
        {k: jres[4][k] for k in ("hits", "prefill_tokens_skipped")}


def test_handoff_to_unknown_replica_raises(model):
    pool = _pool(model, ServingConfig(num_replicas=1),
                 enable_prefix_cache=True)
    pool.start()
    try:
        with pytest.raises(ValueError):
            pool.handoff_prefix(pool.replicas[0].name, "nope", [1, 2, 3])
    finally:
        pool.shutdown()


# ---------------------------------------------------------------------------
# per-tenant SLO classes
# ---------------------------------------------------------------------------


def test_tenant_goodput_gauges_in_metrics(model):
    scfg = ServingConfig(num_replicas=1,
                         slo_classes={"interactive": (0, 0.0),
                                      "batch": (1, 0.0)},
                         default_slo_class="batch")
    pool = _pool(model, scfg)
    pool.start()
    try:
        pool.submit([1, 2, 3], max_new_tokens=4, tenant="acme",
                    slo_class="interactive").result(timeout=STREAM_S)
        pool.submit([4, 5], max_new_tokens=4,
                    tenant="globex").result(timeout=STREAM_S)
        text = pool.metrics.to_prometheus()
        assert ('dstpu_serving_tenant_goodput_rps{tenant="acme",'
                'slo_class="interactive"}') in text
        assert 'tenant="globex",slo_class="batch"' in text
        assert "dstpu_serving_tenant_shed_total" in text
        rows = {(r["tenant"], r["slo_class"]): r
                for r in pool.metrics.tenant_snapshot()}
        assert rows[("acme", "interactive")]["completed"] == 1
        assert rows[("globex", "batch")]["shed_total"] == 0
    finally:
        pool.shutdown()


def test_unknown_slo_class_rejected(model):
    broker = RequestBroker(_teng(model),
                           ServingConfig(slo_classes={"standard": (0, 0.0)}))
    broker.start()
    try:
        with pytest.raises(InvalidRequestError):
            broker.submit([1, 2], max_new_tokens=2, slo_class="vip")
    finally:
        broker.stop(drain=False)


def test_priority_admission_order(model):
    """Both queued before the engine starts, one sequence slot: the
    high-priority (lower number) class admits first."""
    broker = RequestBroker(
        _teng(model, max_seqs=1),
        ServingConfig(slo_classes={"interactive": (0, 0.0),
                                   "batch": (1, 0.0)},
                      default_slo_class="batch"))
    low = broker.submit([3, 4], max_new_tokens=2)  # batch, queued first
    high = broker.submit([5, 6], max_new_tokens=2, slo_class="interactive")
    broker.start()
    try:
        assert len(high.result(timeout=STREAM_S)) == 2
        assert len(low.result(timeout=STREAM_S)) == 2
        assert high._req.admit_ts < low._req.admit_ts
        assert time.monotonic() >= low._req.admit_ts
    finally:
        broker.stop(drain=False)
