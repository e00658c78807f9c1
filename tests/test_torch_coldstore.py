"""Parity: the port's crash-durable cold tier (``deepspeed_tpu_torch/
inference/v2/coldstore.py``, the pager's cold tier and the engine's
``rehydrate_coldstore``) against the JAX package's.

Mirrors the reference's rehydrate tests without the fleet, adapter and
metrics cases (those arrive with the serving layer, ROADMAP.md A9 and
A7): the cold store's atomic commit, verify-before-adopt and startup GC
under injected faults (hard kills in real subprocesses included), the
pager's cold tier, and restart rehydration — token-identical to the
uncached engine, with corrupt, tampered and wrong-geometry entries
degrading to prefill.  Cold stores cross the packages: a store written by
the JAX engine is rehydrated by the port and continues token-identically,
and the reverse."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2.coldstore import ColdStore as JColdStore
from deepspeed_tpu_torch.inference.v2.coldstore import (PAYLOAD, ColdStore,
                                                        sanitize_key)
from deepspeed_tpu_torch.inference.v2.paging import (BlockPager,
                                                     serialize_block)
from deepspeed_tpu_torch.utils import faults

from tests.torch_cpu import one_torch_thread  # noqa: F401
from tests.torch_hierarchy import (assert_consistent, jax_engine,
                                   port_engine, serve, tiny_model)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P1 = list(range(1, 13))
P2 = list(range(21, 33))


@pytest.fixture(scope="module")
def model():
    return tiny_model()


@pytest.fixture(scope="module")
def ref(model):
    eng = port_engine(model, cache=False)
    memo = {}

    def fn(prompt, n):
        key = (tuple(prompt), n)
        if key not in memo:
            memo[key] = serve(eng, prompt, n)
        return memo[key]

    return fn


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


def _cold_engine(model, root, jax=False, **over):
    make = jax_engine if jax else port_engine
    return make(model, kv_host_pool_bytes=1, kv_coldstore_dir=root, **over)


def _run_session(eng, prompts, ref, n=8):
    uids = {tuple(p): eng.put(list(p), max_new_tokens=n) for p in prompts}
    done = eng.generate_all()
    for p in prompts:
        got = [int(t) for t in done[uids[tuple(p)]][len(p):]]
        assert got == ref(p, n), f"prompt {p}"


def _seed_cold_root(model, ref, root, prompts, jax=False):
    """Run a session, demote everything to the cold tier, close gracefully
    (a graceful close keeps the cold entries)."""
    eng = _cold_engine(model, root, jax=jax)
    _run_session(eng, prompts, ref)
    eng.prefix_cache.evict(100)
    stats = eng.prefix_stats()
    assert stats["tier_cold_blocks"] > 0
    assert stats["coldstore_entries"] > 0
    eng.close()
    return ColdStore(root).entries()


# ---------------------------------------------------------------------------
# ColdStore: atomic commit, verify-before-adopt, startup GC (no model)
# ---------------------------------------------------------------------------


def test_coldstore_roundtrip_entries_meta_delete(tmp_path):
    cs = ColdStore(str(tmp_path))
    payload = os.urandom(256)
    cs.write("kv-abc123", payload, {"kind": "kv_block", "tokens": "1,2"})
    assert cs.read("kv-abc123") == payload
    assert cs.meta("kv-abc123") == {"kind": "kv_block", "tokens": "1,2"}
    [(key, meta, nbytes)] = cs.entries()
    assert key == "kv-abc123" and nbytes == 256
    assert meta["kind"] == "kv_block"
    cs.write("kv-abc123", b"x" * 8, {"kind": "kv_block"})  # atomic replace
    assert cs.read("kv-abc123") == b"x" * 8
    st = cs.stats()
    assert st["coldstore_entries"] == 1 and st["coldstore_writes"] == 2
    assert st["coldstore_bytes"] == 8
    cs.delete("kv-abc123")
    assert cs.read("kv-abc123") is None
    assert cs.entries() == []


def test_coldstore_entry_is_the_reference_entry(tmp_path):
    """The same write in both stores leaves the same files: the payload
    and a manifest with the same sizes, digests and meta; each store
    reads the other's entry."""
    payload = serialize_block({"k": torch.ones(2, 8, dtype=torch.bfloat16)})
    meta = {"kind": "kv_block", "tokens": "1,2,3", "block_size": "8"}
    stores = (JColdStore(str(tmp_path / "j")), ColdStore(str(tmp_path / "t")))
    for cs in stores:
        cs.write("kv-0011", payload, meta)
    mans = [json.loads((tmp_path / d / "kv-0011" / "manifest.json")
                       .read_text()) for d in ("j", "t")]
    assert mans[0] == mans[1]
    assert stores[0].entries() == stores[1].entries()
    assert ColdStore(str(tmp_path / "j")).read("kv-0011") == payload
    assert JColdStore(str(tmp_path / "t")).read("kv-0011") == payload


def test_coldstore_key_sanitization():
    assert sanitize_key("kv-ab/../c") == "kv-ab_.._c"
    for bad in ("", ".hidden", "x.tmp"):
        with pytest.raises(ValueError):
            sanitize_key(bad)


def test_coldstore_bitflip_detected_and_dropped(tmp_path):
    cs = ColdStore(str(tmp_path))
    cs.write("kv-deadbeef", b"A" * 128, {"kind": "kv_block"})
    ppath = os.path.join(cs.path("kv-deadbeef"), PAYLOAD)
    with open(ppath, "rb+") as f:
        f.seek(64)
        f.write(b"B")
    assert cs.read("kv-deadbeef") is None
    assert not os.path.exists(cs.path("kv-deadbeef"))
    assert cs.stats()["coldstore_corrupt_dropped"] == 1


def test_coldstore_torn_write_caught_by_manifest(tmp_path):
    cs = ColdStore(str(tmp_path))
    faults.configure({"serving.coldstore.write": "truncate:16"})
    cs.write("kv-torn", b"T" * 200, {"kind": "kv_block"})
    faults.reset()
    assert os.path.isdir(cs.path("kv-torn"))  # committed, but torn
    assert cs.read("kv-torn") is None
    assert cs.stats()["coldstore_corrupt_dropped"] == 1


def test_coldstore_commit_fault_leaves_tmp_for_startup_gc(tmp_path):
    root = str(tmp_path)
    cs = ColdStore(root)
    faults.configure({"serving.coldstore.commit": "ioerror"})
    with pytest.raises(IOError):
        cs.write("kv-halfway", b"H" * 64, {"kind": "kv_block"})
    faults.reset()
    assert os.path.isdir(os.path.join(root, "kv-halfway.tmp"))
    assert cs.entries() == []
    cs2 = ColdStore(root)
    assert cs2.stats()["coldstore_gc_tmp"] == 1
    assert not os.path.exists(os.path.join(root, "kv-halfway.tmp"))
    assert cs2.entries() == []


def test_coldstore_write_fault_stages_nothing(tmp_path):
    cs = ColdStore(str(tmp_path))
    faults.configure({"serving.coldstore.write": "ioerror"})
    with pytest.raises(IOError):
        cs.write("kv-early", b"E" * 32, {"kind": "kv_block"})
    faults.reset()
    assert os.listdir(str(tmp_path)) == []


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_rewrite_read_race(tmp_path, monkeypatch, pkg):
    """A rewrite of a key racing a read of it (ROADMAP.md C5), on the same
    steps in both packages: the writer is held inside ``_commit_dir``
    after part of the old entry is gone (its manifest) and before the
    staged entry is renamed in; a reader then reads the key.  The
    reference's reader calls the half-removed entry corrupt and removes
    it after the writer's rename, so the new entry is lost.  The port's
    reader waits for the commit and returns the new payload, which
    survives."""
    import shutil
    import threading
    import types

    if pkg == "reference":
        from deepspeed_tpu.inference.v2 import coldstore as cs_mod
        from deepspeed_tpu.runtime.checkpoint import engine as ck
    else:
        from deepspeed_tpu_torch.inference.v2 import coldstore as cs_mod
        from deepspeed_tpu_torch.runtime.checkpoint import engine as ck
    cs = cs_mod.ColdStore(str(tmp_path))
    cs.write("kv-k", b"O" * 96, {"kind": "kv_block"})
    final = os.path.abspath(cs.path("kv-k"))
    half_removed, judged = threading.Event(), threading.Event()
    rmtree = shutil.rmtree

    def writer_rmtree(path, ignore_errors=False):
        if os.path.abspath(path) == final:  # _commit_dir's removal
            os.remove(os.path.join(path, "manifest.json"))
            half_removed.set()
            judged.wait(10)
        rmtree(path, ignore_errors=ignore_errors)

    def reader_rmtree(path, ignore_errors=False):
        if os.path.abspath(path) == final and \
                threading.current_thread() is reader:
            judged.set()  # the reader has called the entry corrupt
            writer.join(10)
        rmtree(path, ignore_errors=ignore_errors)

    monkeypatch.setattr(ck, "shutil", types.SimpleNamespace(
        rmtree=writer_rmtree))
    monkeypatch.setattr(cs_mod, "shutil", types.SimpleNamespace(
        rmtree=reader_rmtree))
    got = []
    writer = threading.Thread(target=cs.write,
                              args=("kv-k", b"N" * 96, {"kind": "kv_block"}))
    reader = threading.Thread(target=lambda: got.append(cs.read("kv-k")))
    writer.start()
    assert half_removed.wait(10)
    reader.start()
    if not judged.wait(0.5):
        # the port: the reader waits on the key's lock behind the commit
        assert pkg == "port" and reader.is_alive()
        judged.set()
    writer.join(10)
    reader.join(10)
    assert not writer.is_alive() and not reader.is_alive()
    monkeypatch.undo()
    if pkg == "reference":
        assert got == [None] and cs.read("kv-k") is None  # the rewrite lost
        assert cs.stats()["coldstore_corrupt_dropped"] == 1
    else:
        assert got == [b"N" * 96] and cs.read("kv-k") == b"N" * 96
        assert cs.stats()["coldstore_corrupt_dropped"] == 0


def test_sigkill_at_write_and_commit_sites(tmp_path):
    """Hard ``os._exit`` at each durability fault site in a real
    subprocess (the port alone, no JAX): a kill before staging leaves
    nothing; a kill between manifest and rename leaves only a .tmp orphan
    the next boot GCs."""
    root = str(tmp_path)
    script = textwrap.dedent("""\
        import sys
        from deepspeed_tpu_torch.inference.v2.coldstore import ColdStore
        cs = ColdStore(sys.argv[1])
        cs.write("kv-victim", b"V" * 64, {"kind": "kv_block"})
        sys.exit(3)  # unreachable when the armed site fires
    """)
    for site, leftovers in (("serving.coldstore.write", []),
                            ("serving.coldstore.commit", ["kv-victim.tmp"])):
        env = {**os.environ, "DSTPU_FAULTS": f"{site}=exit:70"}
        # a torch import and one write: seconds; a minute means it hung
        res = subprocess.run([sys.executable, "-c", script, root], env=env,
                             cwd=REPO, capture_output=True, text=True,
                             timeout=60)
        assert res.returncode == 70, res.stderr
        assert sorted(os.listdir(root)) == leftovers
    cs = ColdStore(root)
    assert cs.stats()["coldstore_gc_tmp"] == 1
    assert cs.entries() == [] and os.listdir(root) == []


# ---------------------------------------------------------------------------
# BlockPager cold tier: durable keys, adopt, startup sweeps (no model)
# ---------------------------------------------------------------------------


def test_pager_cold_tier_put_get_drop(tmp_path):
    pg = BlockPager(host_bytes=1, coldstore=ColdStore(str(tmp_path)))
    arrays = {"k": torch.arange(64, dtype=torch.float32).reshape(4, 16)}
    handle, tier = pg.put(arrays, metadata={"kind": "kv_block"},
                          durable_key="kv-feedface")
    assert tier == "cold" and pg.cold_blocks == 1 and pg.spill_blocks == 0
    assert torch.equal(pg.get(handle)["k"], arrays["k"])
    st = pg.stats()
    assert st["tier_cold_blocks"] == 1 and st["coldstore_entries"] == 1
    pg.drop(handle)
    assert pg.get(handle) is None
    assert pg.stats()["coldstore_entries"] == 0
    pg.close()


def test_pager_adopt_is_bookkeeping_only(tmp_path):
    cs = ColdStore(str(tmp_path))
    payload = serialize_block({"k": torch.ones(2, 8)}, {"kind": "kv_block"})
    cs.write("kv-survivor", payload, {"kind": "kv_block"})
    writes0 = cs.stats()["coldstore_writes"]
    pg = BlockPager(host_bytes=1 << 20, coldstore=cs)
    handle = pg.adopt("kv-survivor", len(payload))
    assert handle is not None and pg.rehydrated == 1
    assert cs.stats()["coldstore_writes"] == writes0  # no rewrite
    assert torch.equal(pg.get(handle)["k"], torch.ones(2, 8))
    assert BlockPager(host_bytes=1).adopt("kv-survivor") is None
    pg.close()


def test_pager_sweeps_orphaned_spill_files(tmp_path):
    for h in (3, 9):
        (tmp_path / f"kvblock-{h}.safetensors").write_bytes(b"dead")
    (tmp_path / "unrelated.txt").write_text("keep me")
    pg = BlockPager(host_bytes=1 << 20, spill_dir=str(tmp_path))
    assert pg.gc_spill_files == 2
    assert sorted(os.listdir(tmp_path)) == ["unrelated.txt"]
    pg.close()


# ---------------------------------------------------------------------------
# engine restart rehydration, token-identical to the uncached engine
# ---------------------------------------------------------------------------


def test_engine_restart_rehydrates_token_identical(model, ref, tmp_path):
    root = str(tmp_path)
    entries = _seed_cold_root(model, ref, root, [P1, P2])
    assert len(entries) >= 2
    eng = _cold_engine(model, root)
    r = eng.rehydrate_coldstore()
    assert r == {"adopted": len(entries), "orphaned": 0, "skipped": 0}
    stats = eng.prefix_stats()
    assert stats["rehydrated_blocks"] == len(entries)
    assert stats["tier_cold_blocks"] == len(entries)
    _run_session(eng, [P1, P2], ref)
    stats = eng.prefix_stats()
    assert stats["prefill_tokens_skipped"] >= 16
    assert stats["promotions"] > 0
    assert_consistent(eng)
    eng.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cold_store_crosses_packages(model, ref, tmp_path, writer):
    """A cold store written by one package's engine is rehydrated by the
    other's: the same chains are adopted and the resumed sessions
    continue with the uncached greedy tokens.  Both writers leave the
    same keys and manifest meta."""
    roots = {w: str(tmp_path / w) for w in ("jax", "port")}
    entries = {w: _seed_cold_root(model, ref, roots[w], [P1, P2],
                                  jax=(w == "jax")) for w in roots}
    assert [(k, m) for k, m, _ in entries["jax"]] == \
        [(k, m) for k, m, _ in entries["port"]]
    reader = _cold_engine(model, roots[writer], jax=(writer == "port"))
    r = reader.rehydrate_coldstore()
    assert r == {"adopted": len(entries[writer]), "orphaned": 0,
                 "skipped": 0}
    _run_session(reader, [P1, P2], ref)
    stats = reader.prefix_stats()
    assert stats["promotions"] > 0 and stats["prefill_tokens_skipped"] >= 16
    reader.prefix_cache.check_consistency()
    reader.close()


def test_engine_rehydrate_idempotent_and_noop_safe(model, ref, tmp_path):
    assert port_engine(model).rehydrate_coldstore() == {
        "adopted": 0, "orphaned": 0, "skipped": 0}
    root = str(tmp_path)
    entries = _seed_cold_root(model, ref, root, [P1])
    eng = _cold_engine(model, root)
    assert eng.rehydrate_coldstore()["adopted"] == len(entries)
    # a second pass adopts nothing new; the unwound duplicates must not
    # delete the originals' entries
    assert eng.rehydrate_coldstore()["adopted"] == 0
    _run_session(eng, [P1], ref)
    assert eng.prefix_stats()["prefill_tokens_skipped"] >= 8
    assert_consistent(eng)
    eng.close()


def test_engine_rehydrate_corrupt_parent_degrades_to_prefill(model, ref,
                                                             tmp_path):
    root = str(tmp_path)
    entries = _seed_cold_root(model, ref, root, [P1, P2])
    parent = min(entries, key=lambda e: len(e[1].get("tokens", "")))
    ppath = os.path.join(root, parent[0], PAYLOAD)
    size = os.path.getsize(ppath)
    with open(ppath, "rb+") as f:
        f.seek(size // 2)
        f.write(b"\xff")
    eng = _cold_engine(model, root)
    r = eng.rehydrate_coldstore()
    assert r["skipped"] >= 1, r  # the corrupt parent
    assert r["orphaned"] >= 1, r  # its unreachable child
    assert r["adopted"] == len(entries) - r["skipped"] - r["orphaned"]
    assert eng.pager.coldstore.corrupt_dropped >= 1
    assert not os.path.exists(os.path.join(root, parent[0]))
    _run_session(eng, [P1, P2], ref)
    assert_consistent(eng)
    eng.close()


def test_engine_rehydrate_rejects_tampered_meta(model, ref, tmp_path):
    root = str(tmp_path)
    entries = _seed_cold_root(model, ref, root, [P1])
    victim = entries[0][0]
    mpath = os.path.join(root, victim, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    toks = [int(t) for t in manifest["meta"]["tokens"].split(",")]
    toks[0] = (toks[0] + 1) % 250
    manifest["meta"]["tokens"] = ",".join(str(t) for t in toks)
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    eng = _cold_engine(model, root)
    assert eng.rehydrate_coldstore()["skipped"] >= 1
    assert not os.path.exists(os.path.join(root, victim))
    _run_session(eng, [P1], ref)
    assert_consistent(eng)
    eng.close()


def test_engine_rehydrate_rejects_wrong_geometry(model, ref, tmp_path):
    root = str(tmp_path)
    entries = _seed_cold_root(model, ref, root, [P1])
    eng = _cold_engine(model, root, block_size=4, max_blocks_per_seq=16)
    r = eng.rehydrate_coldstore()
    assert r["adopted"] == 0 and r["skipped"] == len(entries)
    assert ColdStore(root).entries() == []  # deleted, not retried forever
    _run_session(eng, [P1], ref)
    eng.close()


def test_sigkill_mid_rehydrate_then_full_recovery(model, ref, tmp_path):
    """Hard kill at the serving.coldstore.rehydrate site (second entry) in
    a port subprocess: adoption is bookkeeping only, so the killed boot
    leaves every committed entry for the next one."""
    root = str(tmp_path)
    entries = _seed_cold_root(model, ref, root, [P1, P2])
    assert len(entries) >= 2
    script = textwrap.dedent("""\
        import sys
        import torch
        from deepspeed_tpu_torch.inference.v2.engine import (
            InferenceEngineV2, V2Config)
        from deepspeed_tpu_torch.models import transformer as tfm
        cfg = tfm.get_config("tiny", dtype="float32")
        params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
        eng = InferenceEngineV2(cfg, params, V2Config(
            max_tokens_per_step=32, max_seqs=4, block_size=8, num_blocks=64,
            max_blocks_per_seq=8, dtype="float32", enable_prefix_cache=True,
            kv_host_pool_bytes=1, kv_coldstore_dir=sys.argv[1]),
            device="cpu")
        eng.rehydrate_coldstore()
        sys.exit(3)  # unreachable: the armed site fires on entry #2
    """)
    env = {**os.environ,
           "DSTPU_FAULTS": "serving.coldstore.rehydrate=exit:70@2"}
    res = subprocess.run([sys.executable, "-c", script, root], env=env,
                         cwd=REPO, capture_output=True, text=True,
                         timeout=90)
    assert res.returncode == 70, res.stderr
    eng = _cold_engine(model, root)
    r = eng.rehydrate_coldstore()
    assert r["adopted"] == len(entries), (r, res.stderr)
    _run_session(eng, [P1, P2], ref)
    assert eng.prefix_stats()["prefill_tokens_skipped"] >= 16
    eng.close()


def test_rehydrated_block_is_bitwise_the_demoted_one(model, ref, tmp_path):
    """bf16: a block's bytes before demotion to the cold store equal its
    bytes after a restarted engine rehydrates and promotes it."""
    root = str(tmp_path)
    eng = _cold_engine(model, root, dtype="bfloat16")
    serve(eng, P1 + P2, 4)
    before = {tuple(n.chunk): eng._read_kv_block(n.block)
              for n in eng.prefix_cache._nodes}
    eng.prefix_cache.evict(100)
    eng.close()
    eng = _cold_engine(model, root, dtype="bfloat16")
    assert eng.rehydrate_coldstore()["adopted"] == len(before) == 3
    serve(eng, P1 + P2 + [5], 4)  # promotes all three chunks
    assert eng.prefix_stats()["promotions"] == 3
    for n in eng.prefix_cache._nodes:
        after = eng._read_kv_block(n.block)
        for name in ("k", "v"):
            assert np.array_equal(
                after[name].view(torch.int16).numpy(),
                before[tuple(n.chunk)][name].view(torch.int16).numpy())
    assert_consistent(eng)
    eng.close()


@pytest.mark.parametrize("batch", [1, 4])
def test_restart_replay_workload_rehydrates_as_the_reference(model, tmp_path,
                                                             batch):
    """``bench.run_restart_replay``'s seeded session workload, in process
    and in a fixed order (``batch`` requests at a time): the base wave on
    an engine with a cold store under the bench's device and host
    pressure, then a fresh engine on the same root (a restart) serves the
    resume wave.  The port adopts, orphans and skips exactly as the JAX
    engine, and serves the same tokens as a restart with no cold store.
    On this workload every surviving entry is an orphan in both packages:
    the radix tree demotes its leaves first, so the cold tier holds child
    blocks whose parents died with the process; that is why the bench
    mode's ``rehydrate-smoke`` gain gate holds only by chance of timing."""
    from deepspeed_tpu_torch.observability import replay as rp

    _, wl = rp.synthesize_workload(
        seed=0, num_requests=12, mean_rate_rps=8.0, num_templates=6,
        template_len=20, suffix_len=4, max_new_tokens=8,
        resume_fraction=0.5, idle_gap_s=0.5)
    base, resume = wl[:12], wl[12:]
    geo = dict(num_blocks=20, kv_host_pool_bytes=65536)

    def run(eng, wave):
        toks = []
        for i in range(0, len(wave), batch):
            uids = [(eng.put(list(r.prompt), max_new_tokens=r.max_new_tokens),
                     r) for r in wave[i:i + batch]]
            done = eng.generate_all()
            toks += [[int(t) for t in done[u][len(r.prompt):]]
                     for u, r in uids]
        return toks

    def restart(jax, cold):
        root = str(tmp_path / f"{jax}-{cold}")
        make = jax_engine if jax else port_engine
        first = make(model, kv_coldstore_dir=root, **geo)
        run(first, base)
        entries = first.prefix_stats()["coldstore_entries"]
        eng = make(model, kv_coldstore_dir=root if cold else root + "-empty",
                   **geo)
        adopted = eng.rehydrate_coldstore()
        s0 = eng.prefix_stats()["prefill_tokens_skipped"]
        toks = run(eng, resume)
        return {"entries": entries, "rehydrate": adopted, "toks": toks,
                "skipped": eng.prefix_stats()["prefill_tokens_skipped"] - s0}

    mine, theirs = restart(False, True), restart(True, True)
    assert mine == theirs
    assert mine["entries"] > 0
    assert mine["rehydrate"]["orphaned"] == mine["entries"]
    assert mine["toks"] == restart(False, False)["toks"]
