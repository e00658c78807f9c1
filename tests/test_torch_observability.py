"""Parity: the port's span tracer and flight recorder
(``deepspeed_tpu_torch/observability/``), fault injection and named locks
(``utils/``) against the JAX package's.

Each unit case makes the same calls on both packages' objects and compares
what they record: span parenting and ordering, the bounded ring, the
disabled no-op, the Chrome-trace document, the recorder's rings and dump.
The engine's ``engine/step`` spans and flight-recorder steps carry the
reference engine's attributes on the same traffic, one span per
``step()``; tracing on or off gives the same tokens; the memory hierarchy
records its ``paging/*`` and ``coldstore/*`` spans."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from deepspeed_tpu.observability import recorder as j_recorder
from deepspeed_tpu.observability import tracer as j_tracer
from deepspeed_tpu.observability.recorder import FlightRecorder as JRecorder
from deepspeed_tpu.observability.trace import Tracer as JTracer
from deepspeed_tpu.utils import faults as jfaults
from deepspeed_tpu_torch.observability import (FlightRecorder, Tracer,
                                               load_dump, recorder, tracer)
from deepspeed_tpu_torch.utils import faults

from tests.torch_cpu import one_torch_thread  # noqa: F401
from tests.torch_hierarchy import jax_engine, port_engine, serve, tiny_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def model():
    return tiny_model()


def _shape(spans):
    """A span list without its clock: names, trace ids, attrs, threads and
    parents as positions in the list (ids differ between tracers)."""
    pos = {s.span_id: i for i, s in enumerate(spans)}
    return [(s.name, s.trace_id, pos.get(s.parent_id, s.parent_id),
             dict(s.attrs), s.thread, s.t_end is None) for s in spans]


def _both(fn):
    """Run ``fn(tracer)`` on a fresh tracer of each package."""
    out = []
    for cls in (JTracer, Tracer):
        tr = cls(enabled=True)
        fn(tr)
        out.append(tr)
    return out


# ---------------------------------------------------------------------------
# tracer units
# ---------------------------------------------------------------------------


def test_span_parenting_and_ordering():
    def calls(tr):
        with tr.span("outer", trace_id="r1", items=2):
            with tr.span("inner"):
                pass
            sp = tr.begin("manual", step=3)
            tr.end(sp, ok=True)
        with tr.span("second"):
            pass

    jtr, ttr = _both(calls)
    assert _shape(ttr.spans()) == _shape(jtr.spans())
    spans = ttr.spans()
    assert [s.name for s in spans] == ["inner", "manual", "outer", "second"]
    by = {s.name: s for s in spans}
    assert by["inner"].parent_id == by["outer"].span_id
    assert by["inner"].trace_id == "r1" and by["second"].parent_id is None
    assert by["outer"].t_start <= by["inner"].t_start <= \
        by["inner"].t_end <= by["outer"].t_end


def test_retroactive_span_and_filtering():
    def calls(tr):
        tr.add_span("phase", 1.0, 2.5, trace_id="rA")
        tr.add_span("phase", 3.0, 3.5, trace_id="rB", attrs={"n": 1})
        tr.add_event("kick", trace_id="rA")

    jtr, ttr = _both(calls)
    for tid in ("rA", "rB"):
        assert _shape(ttr.spans(trace_id=tid)) == \
            _shape(jtr.spans(trace_id=tid))
    assert len(ttr.spans(name="phase")) == 2
    (sp,) = ttr.spans(trace_id="rB")
    assert sp.duration_s == pytest.approx(0.5)
    assert [s.to_dict() for s in ttr.spans(name="phase")] == \
        [s.to_dict() for s in jtr.spans(name="phase")]


def test_ring_is_bounded():
    out = []
    for cls in (JTracer, Tracer):
        tr = cls(capacity=16, enabled=True)
        for i in range(100):
            tr.add_event(f"e{i}")
        out.append([s.name for s in tr.spans()])
    assert out[1] == out[0] and len(out[1]) == 16
    assert out[1][0] == "e84"  # oldest surviving


def test_disabled_tracer_is_noop(monkeypatch):
    tr = Tracer(enabled=False)
    with tr.span("x") as sp:
        assert sp is None
    assert tr.begin("y") is None
    tr.end(None)
    assert tr.add_span("y", 0.0, 1.0) is None
    assert tr.add_event("z") is None
    assert tr.spans() == []
    monkeypatch.setenv("DSTPU_TRACE", "0")
    assert Tracer().enabled is False and JTracer().enabled is False
    monkeypatch.setenv("DSTPU_TRACE", "1")
    assert Tracer().enabled is True


def test_chrome_trace_format():
    def calls(tr):
        with tr.span("work", trace_id="r1", items=3):
            pass
        tr.add_event("instant")

    jtr, ttr = _both(calls)
    docs = [json.loads(tr.to_chrome_json()) for tr in (jtr, ttr)]

    def strip(doc):
        events = []
        for e in doc["traceEvents"]:
            e = {k: v for k, v in e.items() if k not in ("ts", "dur", "pid")}
            if e["ph"] == "M":
                e["args"] = {}  # the process's display name
            events.append(e)
        return events, sorted(doc["otherData"]), doc["displayTimeUnit"]

    assert strip(docs[1]) == strip(docs[0])
    events = docs[1]["traceEvents"]
    assert events[0]["ph"] == "M"
    assert events[0]["args"]["name"] == "deepspeed_tpu_torch"
    (x,) = [e for e in events if e["ph"] == "X"]
    assert x["name"] == "work" and x["dur"] >= 0 and x["ts"] >= 0
    assert x["args"] == {"items": 3, "trace_id": "r1"}
    for e in events[1:]:
        assert {"name", "ph", "ts", "pid", "tid"} <= set(e)


def test_export_and_ingest_across_packages():
    """Spans exported over the wire format by one package's tracer are
    ingested by the other's as a remote process track."""
    jtr, ttr = _both(lambda tr: tr.add_span("w", 1.0, 2.0, trace_id="r"))
    cursor, wire = ttr.export_since(0)
    assert cursor > 0 and len(wire) == 1
    assert jtr.ingest_remote(wire, pid=4242, process="port") == 1
    _, jwire = jtr.export_since(0)
    assert ttr.ingest_remote(jwire, pid=77, process="jax") == 1
    remote = [s for s in ttr.spans() if s.pid == 77]
    assert [s.name for s in remote] == ["w"]
    assert remote[0].duration_s == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# flight recorder units
# ---------------------------------------------------------------------------


def test_recorder_rings_and_dump_roundtrip(tmp_path):
    bodies = []
    for cls, name in ((JRecorder, "j"), (FlightRecorder, "t")):
        rec = cls(max_requests=2, max_steps=2, max_events=2)
        for i in range(4):
            rec.record_request({"rid": f"r{i}", "spans": []})
            rec.record_step({"kind": "decode", "t_start": 0.0,
                             "t_end": 0.01, "i": i})
            rec.record_event("ev", i=i)
        path = rec.dump(path=str(tmp_path / f"{name}.json"), reason="test")
        bodies.append(load_dump(path))
    for body in bodies:
        for ev in body["events"]:
            del ev["t"], ev["wall"]
        del body["meta"]["wall"], body["meta"]["mono"]
    assert bodies[1] == bodies[0]
    assert [r["rid"] for r in bodies[1]["requests"]] == ["r2", "r3"]
    assert bodies[1]["meta"]["reason"] == "test"


def test_recorder_dump_without_destination_is_none(monkeypatch):
    monkeypatch.delenv("DSTPU_FLIGHT_DIR", raising=False)
    assert FlightRecorder().dump() is None


def test_dump_gc_keeps_newest(tmp_path, monkeypatch):
    monkeypatch.setenv("DSTPU_FLIGHT_MAX_DUMPS", "3")
    rec = FlightRecorder()
    rec.record_event("ev")
    for i in range(6):
        p = str(tmp_path / f"flight_{i}.json")
        rec.dump(path=p, reason=f"r{i}")
        os.utime(p, (i + 1, i + 1))
    assert sorted(f for f in os.listdir(tmp_path)
                  if f.startswith("flight_")) == \
        ["flight_3.json", "flight_4.json", "flight_5.json"]
    (tmp_path / "notes.txt").write_text("keep me")
    rec.dump(path=str(tmp_path / "flight_7.json"), reason="r7")
    assert (tmp_path / "notes.txt").exists()


def test_injected_kill_dumps_flight_recorder(tmp_path):
    """A hard kill at a fault site runs the recorder's crash hook first:
    the port's steps survive in ``$DSTPU_FLIGHT_DIR`` (a port subprocess,
    no JAX)."""
    script = textwrap.dedent("""\
        import sys
        import torch
        from deepspeed_tpu_torch.inference.v2.engine import (
            InferenceEngineV2, V2Config)
        from deepspeed_tpu_torch.models import transformer as tfm
        from deepspeed_tpu_torch.observability import recorder
        from deepspeed_tpu_torch.utils import faults
        recorder.install_crash_hook()
        cfg = tfm.get_config("tiny", dtype="float32")
        eng = InferenceEngineV2(cfg, tfm.init_params(
            cfg, torch.Generator().manual_seed(0), device="cpu"), V2Config(
            max_tokens_per_step=8, max_seqs=2, block_size=8, num_blocks=16,
            max_blocks_per_seq=4, dtype="float32"), device="cpu")
        eng.put(list(range(1, 20)), max_new_tokens=4)
        for _ in range(3):
            eng.step()
        faults.maybe_fail("test.site")
        sys.exit(3)
    """)
    env = {**os.environ, "DSTPU_FAULTS": "test.site=exit",
           "DSTPU_FLIGHT_DIR": str(tmp_path)}
    # a torch import and three tiny steps: seconds; 90 s means it hung
    res = subprocess.run([sys.executable, "-c", script], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=90)
    assert res.returncode == 70, res.stderr
    (dump,) = tmp_path.glob("flight_*.json")
    body = load_dump(str(dump))
    assert body["meta"]["reason"] == "fault_test_site"
    assert [s["kind"] for s in body["steps"]] == ["mixed"] * 3


# ---------------------------------------------------------------------------
# fault injection and named locks: the same behaviour as the reference
# ---------------------------------------------------------------------------


def test_faults_configure_hits_and_truncate(tmp_path):
    for mod in (jfaults, faults):
        mod.reset()
        mod.configure("a.site=ioerror@2;b.site=truncate:4")
        mod.maybe_fail("a.site")  # first hit: not armed for it
        with pytest.raises(IOError, match="a.site"):
            mod.maybe_fail("a.site")
        mod.maybe_fail("a.site")
        path = tmp_path / f"{mod.__name__}.bin"
        path.write_bytes(b"x" * 10)
        mod.maybe_truncate("b.site", str(path))
        assert path.read_bytes() == b"xxxx"
        assert (mod.hits("a.site"), mod.fired("a.site")) == (3, 1)
        with pytest.raises(ValueError, match="unknown fault kind"):
            mod.configure({"c.site": "explode"})
        mod.reset()
        mod.maybe_fail("a.site")
        assert not mod.active()


def test_lockdep_reports_the_same_cycle():
    """Under ``DSTPU_LOCKDEP=1`` both packages' named locks report an
    A -> B -> A order cycle and a sleep under a lock, with the same keys
    (run in a subprocess: lockdep patches blocking calls process-wide)."""
    script = textwrap.dedent("""\
        import json, sys, time
        mod = sys.argv[1]
        locks = __import__(mod + ".utils.locks", fromlist=["x"])
        a, b = locks.named_lock("t.a"), locks.named_lock("t.b")
        with a:
            with b:
                pass
        with b:
            with a:
                time.sleep(0)
        rep = locks.lockdep_report()
        print(json.dumps([sorted(c["key"] for c in rep["cycles"]),
                          sorted(x["key"] for x in rep["blocking"]),
                          [n for n in rep["locks"] if n.startswith("t.")]]))
    """)
    outs = []
    for mod in ("deepspeed_tpu", "deepspeed_tpu_torch"):
        res = subprocess.run(
            [sys.executable, "-c", script, mod], cwd=REPO, timeout=90,
            env={**os.environ, "DSTPU_LOCKDEP": "1", "JAX_PLATFORMS": "cpu"},
            capture_output=True, text=True)
        assert res.returncode == 0, res.stderr
        outs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    assert outs[1] == outs[0]
    assert outs[1][0] == ["cycle:t.a->t.b->t.a"]
    assert outs[1][1] == ["blocking:t.a:time.sleep", "blocking:t.b:time.sleep"]


# ---------------------------------------------------------------------------
# the engine: one span and one recorder step per step(), same attributes
# ---------------------------------------------------------------------------


STEP_KEYS = ("kind", "running", "waiting", "prefilling", "emitted")


def _drive(eng):
    """Mixed steps, then single decode steps, through ``step()``."""
    for p, n in (([5, 6, 7], 4), (list(range(1, 30)), 5), ([9] * 12, 3)):
        eng.put(p, max_new_tokens=n)
    outs = []
    while eng.running or eng.waiting:
        outs.append(eng.step())
    return outs


def test_engine_steps_carry_reference_attrs(model):
    jeng = jax_engine(model, cache=False, max_tokens_per_step=16)
    teng = port_engine(model, cache=False, max_tokens_per_step=16)
    records = []
    for eng, tr, rec in ((jeng, j_tracer, j_recorder),
                         (teng, tracer, recorder)):
        tr.clear()
        rec.clear()
        outs = _drive(eng)
        spans = tr.spans(name="engine/step")
        steps = rec.snapshot()["steps"]
        assert len(spans) == len(steps) == len(outs)
        for sp, st in zip(spans, steps):
            # the span's ``prefilling`` is taken as the step begins, the
            # recorder's as it ends, in both packages
            same = ("kind", "running", "waiting", "emitted")
            assert {k: sp.attrs[k] for k in same} == {k: st[k] for k in same}
            assert st["t_end"] >= st["t_start"]
        records.append(([{k: sp.attrs[k] for k in STEP_KEYS} for sp in spans],
                        [{k: st[k] for k in STEP_KEYS} for st in steps],
                        outs))
    assert records[1] == records[0]
    kinds = [r["kind"] for r in records[1][1]]
    assert kinds[0] == "mixed" and "decode" in kinds
    assert sum(r["emitted"] for r in records[1][0]) == 4 + 5 + 3


def test_tracing_on_vs_off_token_identical(model):
    """The tracer never touches the device: the same tokens with it on and
    off, and off records nothing."""
    prompts = [([5, 6, 7], 6), ([1, 2, 3, 4], 5), ([11, 12] * 9, 8)]
    outs = {}
    was = tracer.enabled
    try:
        for enabled in (True, False):
            tracer.enabled = enabled
            tracer.clear()
            eng = port_engine(model, cache=False)
            uids = [eng.put(p, max_new_tokens=n) for p, n in prompts]
            res = eng.generate_all(burst=4)
            outs[enabled] = [res[u] for u in uids]
            assert bool(tracer.spans(name="engine/step")) == enabled
    finally:
        tracer.enabled = was
    assert outs[True] == outs[False]
    jeng = jax_engine(model, cache=False)
    uids = [jeng.put(p, max_new_tokens=n) for p, n in prompts]
    res = jeng.generate_all(burst=4)
    assert outs[True] == [res[u] for u in uids]


def test_hierarchy_spans(model, tmp_path):
    """Demotion, promotion and rehydration record their spans with the
    reference engine's names and attributes."""
    tracer.clear()
    root = str(tmp_path)
    prompt = list(range(1, 30))
    eng = port_engine(model, kv_host_pool_bytes=1, kv_coldstore_dir=root)
    serve(eng, prompt, 4)
    eng.prefix_cache.evict(100)
    eng.close()
    eng = port_engine(model, kv_host_pool_bytes=1, kv_coldstore_dir=root)
    r = eng.rehydrate_coldstore()
    serve(eng, prompt, 4)
    eng.close()
    demotes = tracer.spans(name="paging/demote")
    promotes = tracer.spans(name="paging/promote")
    (rehydrate,) = tracer.spans(name="coldstore/rehydrate_kv")
    assert len(demotes) == r["adopted"] == 4
    assert all(s.attrs["ok"] and s.attrs["tier"] == "cold" for s in demotes)
    assert len(promotes) == 3 and all(s.attrs["ok"] for s in promotes)
    assert {k: rehydrate.attrs[k] for k in r} == r
    # every span of the promotion nests in the engine step that ran it
    steps = {s.span_id for s in tracer.spans(name="engine/step")}
    assert all(s.parent_id in steps for s in promotes)
