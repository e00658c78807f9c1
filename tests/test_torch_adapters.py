"""Parity: the port's multi-tenant adapter serving (the engine's
``adapter_slots``/``adapter_rank`` stack, ``serving/adapters.py``, and the
checkpoint seams of ``runtime/checkpoint/engine.py``) against the JAX
package's, on ``tiny`` in f32.

Mirrors ``tests/test_adapters.py``.  The broker is not ported yet
(ROADMAP.md A9), so both packages are driven by the same host loop here
(``_Pool``: the broker's admission discipline — acquire, ``put(strict=
True)``, defer on capacity, release at the finish).  Greedy rows must be
token-identical to the reference pool and to a dedicated engine whose
weights were merged offline; sampled rows replay bit for bit per seed.
Adapter packs, published artifacts and cold-store entries cross the
packages both ways, byte for byte."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import engine as je
from deepspeed_tpu.linear import spec_heads as jsh
from deepspeed_tpu.linear.optimized_linear import (graft_adapter_pack,
                                                   merge_lora_weights)
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.runtime.checkpoint import engine as jck
from deepspeed_tpu.serving import adapters as jad
from deepspeed_tpu_torch.inference.v2 import engine as te
from deepspeed_tpu_torch.linear import optimized_linear as tlin
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.runtime.checkpoint import engine as tck
from deepspeed_tpu_torch.serving import adapters as tad

from tests.torch_cpu import one_torch_thread  # noqa: F401

V2 = dict(max_tokens_per_step=32, max_seqs=4, block_size=8, num_blocks=64,
          max_blocks_per_seq=8, dtype="float32", adapter_slots=4,
          adapter_rank=4)
PLAIN = {k: v for k, v in V2.items() if not k.startswith("adapter")}
RANK = 4
#: registry gauges that time a host operation: they differ run to run
TIMED = ("promote_wait_ms",)


@pytest.fixture(scope="module")
def model():
    jcfg = jt.get_config("tiny", dtype="float32")
    jparams = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = tt.get_config("tiny", dtype="float32")
    tparams = tt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                 tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _make_pack(model_cfg, i, rank=RANK):
    """The reference test's deterministic factors, large enough that an
    adapter row demonstrably leaves the base's continuation."""
    rng = np.random.default_rng(1000 + i)
    L = model_cfg.num_layers
    pack = {}
    for target, (K, N) in te.adapter_target_shapes(model_cfg).items():
        a = (rng.standard_normal((L, K, rank)) / np.sqrt(K)).astype(np.float32)
        b = (0.5 * rng.standard_normal((L, rank, N))).astype(np.float32)
        pack[target] = (a, b)
    return pack


def _engine(model, pkg="port", **over):
    jcfg, jparams, tcfg, tparams = model
    kw = {**V2, **over}
    if pkg == "port":
        return te.InferenceEngineV2(tcfg, tparams, te.V2Config(**kw),
                                    device="cpu")
    return je.InferenceEngineV2(jcfg, jparams, je.V2Config(**kw))


def _registry(eng, ids, pkg="port", **kw):
    reg = (tad if pkg == "port" else jad).AdapterRegistry(eng, **kw)
    for i, aid in enumerate(ids):
        reg.register(aid, pack=_make_pack(eng.model_cfg, i))
    return reg


@pytest.fixture(scope="module")
def dedicated(model):
    """Oracle: one port engine per adapter with its weights merged offline
    (``W + A @ B``) — a tenant's private deployment; ``None`` is the plain
    base."""
    _, _, tcfg, tparams = model
    engines = {}

    def tokens(i, prompt, n=6):
        if i not in engines:
            p = tparams if i is None else tlin.merge_lora_weights(
                tlin.graft_adapter_pack(tparams, _make_pack(tcfg, i)))
            engines[i] = te.InferenceEngineV2(tcfg, p, te.V2Config(**PLAIN),
                                              device="cpu")
        eng = engines[i]
        uid = eng.put(list(prompt), max_new_tokens=n)
        return [int(t) for t in eng.generate_all()[uid][len(prompt):]]

    return tokens


class _Pool:
    """The broker's admission discipline over one engine and its registry,
    for either package: requests queue in order; the head is admitted when
    its adapter gets a slot and ``put(strict=True)`` takes it (else it
    waits for capacity); each step's tokens are collected; a finished
    request releases its adapter; an adapter retired while its request
    waited fails that request with ``"adapter_retired"``."""

    def __init__(self, eng, reg, pkg="port"):
        self.eng, self.reg = eng, reg
        self.mod = tad if pkg == "port" else jad
        self.admission = te.AdmissionError if pkg == "port" \
            else je.AdmissionError
        self.queue, self.out, self.live = [], {}, {}

    def submit(self, prompt, n, adapter=None, temperature=None, seed=0):
        rid = len(self.out)
        self.out[rid] = []
        self.queue.append((rid, list(prompt), n, adapter, temperature, seed))
        return rid

    def _admit(self):
        while self.queue:
            rid, prompt, n, aid, temp, seed = self.queue[0]
            slot = 0
            if aid is not None:
                try:
                    slot = self.reg.acquire(aid)
                except self.mod.AdapterCapacityError:
                    return
                except self.mod.AdapterError:
                    self.queue.pop(0)
                    self.out[rid] = "adapter_retired"
                    continue
            try:
                uid = self.eng.put(prompt, n, strict=True, temperature=temp,
                                   seed=seed, adapter_slot=slot)
            except self.admission:
                if aid is not None:
                    self.reg.release(aid)
                return
            self.queue.pop(0)
            self.live[uid] = (rid, aid)

    def run(self, max_steps=500):
        for _ in range(max_steps):
            self._admit()
            if not self.live:
                break
            for uid, toks in self.eng.step().items():
                self.out[self.live[uid][0]] += [int(t) for t in toks]
            for uid, (rid, aid) in list(self.live.items()):
                if uid not in self.eng.running:  # finished this step
                    if aid is not None:
                        self.reg.release(aid)
                    del self.live[uid]
        assert not self.queue and not self.live
        return [self.out[r] for r in sorted(self.out)]


def _untimed(stats):
    return {k: v for k, v in stats.items() if k not in TIMED}


# ---------------------------------------------------------------------------
# registry residency (no engine steps)
# ---------------------------------------------------------------------------


def test_registry_acquire_release_lru_evict(model):
    """The same acquire / release / retire sequence on both packages'
    registries gives the same slots and the same gauges."""
    seen = []
    for pkg in ("reference", "port"):
        eng = _engine(model, pkg)  # 4 slots -> 3 usable (slot 0 = null)
        reg = _registry(eng, ["a0", "a1", "a2", "a3"], pkg)
        s0 = reg.acquire("a0")
        assert 0 < s0 < V2["adapter_slots"]
        assert reg.acquire("a0") == s0  # resident: a refcount bump
        assert reg.stats()["hits"] == 1
        reg.release("a0")
        reg.release("a0")
        s1, s2 = reg.acquire("a1"), reg.acquire("a2")
        assert len({s0, s1, s2}) == 3
        reg.release("a1"), reg.release("a2")
        # no free slot left: a3 LRU-evicts a0, the coldest idle resident
        s3 = reg.acquire("a3")
        assert s3 == s0 and reg.stats()["evictions"] == 1
        reg.release("a3")
        assert reg.acquire("a0") != s0  # demoted, not lost: promoted back
        reg.release("a0")
        st = reg.stats()
        assert st["loads"] == 5 and st["registered"] == 4 and st["refs"] == 0
        assert st["resident"] == 3
        seen.append((s0, s1, s2, s3, _untimed(st), reg.summary()))
        for aid in ("a0", "a1", "a2", "a3"):
            reg.retire(aid)
        reg.check_leaks()
        reg.close()
    assert seen[1] == seen[0]


def test_registry_capacity_and_validation(model):
    eng = _engine(model, adapter_slots=2)  # one usable slot
    reg = _registry(eng, ["a0", "a1"])
    assert reg.acquire("a0") == 1
    # the only slot is pinned by a running request: admission defers,
    # never evicts pinned state from under a live row
    with pytest.raises(tad.AdapterCapacityError):
        reg.acquire("a1")
    reg.release("a0")
    assert reg.acquire("a1") == 1  # a0 idle -> evictable -> a1 lands
    reg.release("a1")
    with pytest.raises(tad.AdapterError, match="already registered"):
        reg.register("a0", pack=_make_pack(eng.model_cfg, 0))
    with pytest.raises(tad.AdapterError, match="exactly one"):
        reg.register("x", ckpt_dir="/nonexistent", pack=_make_pack(
            eng.model_cfg, 0))
    with pytest.raises(tad.AdapterError, match="unknown adapter"):
        reg.acquire("ghost")
    with pytest.raises(tad.AdapterError, match="unknown adapter"):
        reg.retire("ghost")
    bad = _make_pack(eng.model_cfg, 0)
    bad["wq"] = (bad["wq"][0][:, :-1, :], bad["wq"][1])
    with pytest.raises(tad.AdapterError, match="wq"):
        reg.register("bad", pack=bad)
    with pytest.raises(tad.AdapterError, match="unsupported adapter target"):
        reg.register("mlp", pack={"w_in": bad["wq"]})
    assert reg.stats()["capacity_deferrals"] == 1
    reg.retire("a0"), reg.retire("a1")
    reg.check_leaks()
    reg.close()


def test_registry_retire_with_inflight_refs(model):
    """Retire while a request holds the slot: routing stops at once; the
    slot and the host bytes are reclaimed when the last ref drops."""
    eng = _engine(model)
    reg = _registry(eng, ["a0"])
    slot = reg.acquire("a0")
    assert eng.adapter_stack["wq"]["a"][:, slot].abs().sum() > 0
    assert reg.retire("a0") is False  # one in-flight ref: not purged yet
    assert not reg.known("a0") and reg.ids() == []
    reg.release("a0")  # the last ref: purged, slot zeroed
    assert reg.stats()["registered"] == 0
    assert not any(t[h][:, slot].any() for t in eng.adapter_stack.values()
                   for h in ("a", "b"))
    reg.check_leaks()
    reg.close()


# ---------------------------------------------------------------------------
# the oracle: mixed heterogeneous-adapter batches
# ---------------------------------------------------------------------------


def _mixed_cases():
    lanes = [None, "a0", "a1", "a2"]
    return [(lanes[i % 4], [7 * i + j for j in range(1, 6)],
             0.7 if i >= 4 else None, 100 + i) for i in range(8)]


def _run_mixed_pool(model, pkg):
    eng = _engine(model, pkg)
    reg = _registry(eng, ["a0", "a1", "a2"], pkg)
    pool = _Pool(eng, reg, pkg)
    for aid, p, t, s in _mixed_cases():
        pool.submit(p, 6, adapter=aid, temperature=t, seed=s)
    outs = pool.run()
    reg.check_leaks()  # every finished request dropped its ref
    assert reg.stats()["resident"] <= V2["adapter_slots"] - 1
    reg.close()
    return outs


def test_mixed_batch_token_identity(model, dedicated):
    """One shared-base pool serving the base and three adapters in the SAME
    batches, greedy and sampled rows interleaved: greedy rows are the
    reference pool's tokens and their dedicated merged engine's; sampled
    rows replay bit for bit on an identical pool."""
    outs = _run_mixed_pool(model, "port")
    want = _run_mixed_pool(model, "reference")
    for got, ref, (aid, p, t, _) in zip(outs, want, _mixed_cases()):
        if t is None:
            idx = None if aid is None else int(aid[1:])
            assert got == ref == dedicated(idx, p), f"adapter={aid}"
        else:
            assert len(got) == 6
    assert _run_mixed_pool(model, "port") == outs
    # the adapters demonstrably change the output
    p = _mixed_cases()[1][1]
    assert dedicated(0, p) != dedicated(None, p)


def test_adapter_paging_pressure_zero_leaks(model, dedicated):
    """More tenants than device slots: adapters page through the host tier
    mid-run (evictions, residency bounded by the slots) while every stream
    stays exact, and the pool drains with no leaked ref or slot."""
    eng = _engine(model)  # 3 usable slots
    reg = _registry(eng, [f"a{i}" for i in range(5)])
    pool = _Pool(eng, reg)
    cases = [(i % 5, [11 * i + j for j in range(1, 5)]) for i in range(10)]
    for ai, p in cases:
        pool.submit(p, 4, adapter=f"a{ai}")
    for got, (ai, p) in zip(pool.run(), cases):
        assert got == dedicated(ai, p, n=4)
    st = reg.stats()
    assert st["evictions"] > 0, "5 adapters / 3 slots never paged"
    assert st["resident"] <= 3 and st["refs"] == 0
    assert st["hits"] + st["loads"] >= 10
    reg.check_leaks()
    reg.close()


def test_self_draft_composes_with_adapters(model, dedicated):
    """Self-draft speculation stays lossless under per-row adapters: the
    pool's greedy tokens are the dedicated engines', and its spec_stats
    and tokens are the reference pool's."""
    jcfg, jparams, _, _ = model
    heads = jsh.init_spec_heads(jax.random.PRNGKey(1), jcfg, 2,
                                base_params=jparams)
    cases = [(None, [3, 5, 7, 9]), ("a0", [4, 6, 8, 10]),
             ("a1", [5, 10, 15, 20]), ("a0", [2, 4, 8, 16])]
    res = {}
    for pkg in ("reference", "port"):
        eng = (_engine(model, pkg, spec_mode="self_draft", spec_k=2)
               if pkg == "reference" else te.InferenceEngineV2(
                   model[2], model[3], te.V2Config(
                       **V2, spec_mode="self_draft", spec_k=2),
                   spec_heads=tt.spec_heads_from_jax(
                       jax.tree_util.tree_map(np.asarray, heads),
                       device="cpu"), device="cpu"))
        reg = _registry(eng, ["a0", "a1"], pkg)
        pool = _Pool(eng, reg, pkg)
        for aid, p in cases:
            pool.submit(p, 6, adapter=aid)
        res[pkg] = (pool.run(), eng.spec_stats())
        reg.check_leaks()
        reg.close()
    assert res["port"] == res["reference"]
    assert res["port"][1]["steps"] > 0
    for got, (aid, p) in zip(res["port"][0], cases):
        assert got == dedicated(None if aid is None else int(aid[1:]), p)


# ---------------------------------------------------------------------------
# hot register / retire, request validation
# ---------------------------------------------------------------------------


def test_hot_register_and_retire_midstream(model, dedicated):
    """Adapters come and go without a restart: a request queued for an
    adapter retired before its admission fails with ``adapter_retired``;
    a tenant registered mid-run is routable at once; the base serves on."""
    eng = _engine(model)
    reg = _registry(eng, ["a0"])
    pool = _Pool(eng, reg)
    doomed = pool.submit([1, 2, 3, 4], 4, adapter="a0")
    reg.retire("a0")  # retired between submit and admission
    with pytest.raises(tad.AdapterError, match="unknown adapter"):
        reg.acquire("a0")
    reg.register("a1", pack=_make_pack(eng.model_cfg, 1))
    live = pool.submit([4, 6, 8, 10], 4, adapter="a1")
    base = pool.submit([9, 8, 7, 6], 4)
    outs = pool.run()
    assert outs[doomed] == "adapter_retired"
    assert outs[live] == dedicated(1, [4, 6, 8, 10], n=4)
    assert outs[base] == dedicated(None, [9, 8, 7, 6], n=4)
    reg.retire("a1")
    reg.check_leaks()
    reg.close()


def test_request_validation(model):
    _, _, tcfg, tparams = model
    base_eng = te.InferenceEngineV2(tcfg, tparams, te.V2Config(**PLAIN),
                                    device="cpu")
    with pytest.raises(tad.AdapterError, match="adapter_slots"):
        tad.AdapterRegistry(base_eng)
    with pytest.raises(te.AdmissionError, match="without adapter_slots"):
        base_eng.put([1, 2, 3], max_new_tokens=2, adapter_slot=1)
    eng = _engine(model)
    with pytest.raises(te.AdmissionError, match="out of range"):
        eng.put([1, 2, 3], max_new_tokens=2,
                adapter_slot=V2["adapter_slots"])
    with pytest.raises(ValueError, match="slot must be"):
        eng.set_adapter_slot(0, _make_pack(tcfg, 0))
    with pytest.raises(ValueError, match="shape mismatch"):
        eng.set_adapter_slot(1, {"wq": (np.zeros((1, 2, 3)),
                                        np.zeros((1, 3, 2)))})


# ---------------------------------------------------------------------------
# the engine's adapter stack against the reference's
# ---------------------------------------------------------------------------


def test_adapter_forward_matches_reference_and_null_slot_is_exact(model):
    """One mixed step with rows on slots 0..3: logits within 1e-5 of the
    reference engine's on the same stack (loaded by both engines'
    set_adapter_slot), and the slot-0 rows bit for bit those of an
    adapterless engine serving the same batch."""
    jeng, teng = _engine(model, "reference"), _engine(model)
    plain = te.InferenceEngineV2(model[2], model[3], te.V2Config(**PLAIN),
                                 device="cpu")
    for slot in (1, 2, 3):
        for eng in (jeng, teng):
            eng.set_adapter_slot(slot, _make_pack(eng.model_cfg, slot))
    for name, ab in jeng.adapter_stack.items():
        for half in ("a", "b"):
            np.testing.assert_array_equal(teng.adapter_stack[name][half],
                                          np.asarray(ab[half]))
    prompts = [list(range(1, 9)), [7, 8], list(range(30, 40)), [3, 1, 4]]
    for eng in (jeng, teng, plain):
        for slot, p in enumerate(prompts):
            eng.put(p, max_new_tokens=3,
                    adapter_slot=slot if eng is not plain else 0)
        eng.step()
    np.testing.assert_allclose(teng.last_logits.numpy(),
                               np.asarray(_jax_first_logits(jeng, prompts)),
                               atol=1e-5, rtol=0)
    assert torch.equal(teng.last_logits[0], plain.last_logits[0])
    assert not torch.equal(teng.last_logits[1], plain.last_logits[1])


def _jax_first_logits(jeng, prompts):
    """The reference engine's logits of its first mixed step, recomputed
    on a fresh engine with the same stack (the reference keeps none)."""
    fresh = je.InferenceEngineV2(jeng.model_cfg, jeng.params, jeng.cfg)
    fresh.adapter_stack = jeng.adapter_stack
    for slot, p in enumerate(prompts):
        fresh.put(p, max_new_tokens=3, adapter_slot=slot)
    fresh._flush_table()
    picks = fresh._schedule()
    batch = fresh.builder.build(picks)
    row_ad = np.zeros(fresh.cfg.max_seqs, np.int32)
    for row, (seq, _) in enumerate(picks):
        row_ad[row] = seq.adapter_slot
    logits, _, _ = fresh._fwd(fresh.params, fresh.caches, *map(jnp.asarray, (
        batch.token_ids, batch.position_ids, batch.seq_index,
        batch.block_tables, batch.context_lens, batch.logits_rows,
        batch.chunk_start, batch.chunk_len)), fresh.adapter_stack,
        jnp.asarray(row_ad))
    return logits


def test_swap_params_and_rollback(model):
    """A rolling weight swap on a drained engine serves the new weights
    (the tokens of an engine built on them); a tree of another structure
    is refused; rollback restores the old weights."""
    _, _, tcfg, tparams = model
    new = tlin.merge_lora_weights(tlin.graft_adapter_pack(
        tparams, _make_pack(tcfg, 2)))
    eng = te.InferenceEngineV2(tcfg, tparams, te.V2Config(**PLAIN),
                               device="cpu")
    fresh = te.InferenceEngineV2(tcfg, new, te.V2Config(**PLAIN),
                                 device="cpu")

    def serve(e):
        uid = e.put([5, 6, 7], max_new_tokens=5)
        return e.generate_all()[uid]

    before = serve(eng)
    eng.swap_params(new)
    assert serve(eng) == serve(fresh) != before
    with pytest.raises(ValueError, match="structure"):
        eng.swap_params({"embed": new["embed"]})
    eng.swap_rollback()
    assert serve(eng) == before
    with pytest.raises(RuntimeError, match="no previous params"):
        eng.swap_rollback()


# ---------------------------------------------------------------------------
# checkpoint seams: publish / load, merged export, the cold tier
# ---------------------------------------------------------------------------


def _adapter_tree(cfg, rank=2, seed=7):
    rng = np.random.default_rng(seed)
    L = cfg.num_layers
    return {target: {
        "lora_a": rng.standard_normal((L, K, rank)).astype(np.float32),
        "lora_b": rng.standard_normal((L, rank, N)).astype(np.float32)}
        for target, (K, N) in te.adapter_target_shapes(cfg).items()}


def test_publish_load_roundtrip_and_rank_padding(model, tmp_path):
    """A published adapter (rank 2 under a rank-4 deployment) loads padded
    to the deployment's rank with the scaling folded into b; the port's
    published directory is the reference's file for file, byte for byte,
    and each package loads the other's to the same arrays."""
    jcfg, _, tcfg, _ = model
    tree = _adapter_tree(tcfg)
    d = tad.publish_adapter(tree, str(tmp_path / "t"), "tenant-x",
                            scaling=0.5)
    jd = jad.publish_adapter(tree, str(tmp_path / "j"), "tenant-x",
                             scaling=0.5)
    assert sorted(os.listdir(d)) == sorted(os.listdir(jd)) == [
        "adapter_model.safetensors", "manifest.json"]
    for name in os.listdir(d):
        with open(os.path.join(d, name), "rb") as f, \
                open(os.path.join(jd, name), "rb") as g:
            assert f.read() == g.read(), name
    pack = tad.load_adapter_pack(d, tcfg, adapter_rank=RANK)
    L = tcfg.num_layers
    for target in tree:
        a, b = pack[target]
        K, N = te.adapter_target_shapes(tcfg)[target]
        assert a.shape == (L, K, RANK) and b.shape == (L, RANK, N)
        assert np.array_equal(a[:, :, :2], tree[target]["lora_a"])
        assert np.allclose(b[:, :2, :], 0.5 * tree[target]["lora_b"],
                           atol=1e-7)
        assert not a[:, :, 2:].any() and not b[:, 2:, :].any()
    for got in (jad.load_adapter_pack(d, jcfg, adapter_rank=RANK),
                tad.load_adapter_pack(jd, tcfg, adapter_rank=RANK)):
        for target, (a, b) in pack.items():
            assert np.array_equal(np.asarray(got[target][0]), a)
            assert np.array_equal(np.asarray(got[target][1]), b)
    with pytest.raises(tad.AdapterError, match="rank"):
        tad.load_adapter_pack(d, tcfg, adapter_rank=1)
    mlp = {"w_in": {"lora_a": np.zeros((L, 4, 2), np.float32),
                    "lora_b": np.zeros((L, 2, 4), np.float32)}}
    bad = tad.publish_adapter(mlp, str(tmp_path / "t"), "mlp-x")
    with pytest.raises(tad.AdapterError, match="supports"):
        tad.load_adapter_pack(bad, tcfg, adapter_rank=RANK)


def test_save_tree_bf16_is_the_reference_file(model, tmp_path):
    """A bf16 tree is written as the reference writes it (uint16 bits, the
    keys in ``bf16_keys``) and reads back as bf16 in both packages."""
    tree = {"b": {"w": torch.linspace(-2, 2, 12).reshape(3, 4).to(
        torch.bfloat16)}, "a": torch.arange(6, dtype=torch.int32),
        "c": torch.ones(2, 2)}
    tck._save_tree(tree, str(tmp_path / "t.safetensors"))
    jtree = {"b": {"w": jnp.asarray(tree["b"]["w"].float().numpy(),
                                    jnp.bfloat16)},
             "a": np.arange(6, dtype=np.int32), "c": np.ones((2, 2),
                                                             np.float32)}
    jck._save_tree(jtree, str(tmp_path / "j.safetensors"))
    assert (tmp_path / "t.safetensors").read_bytes() == \
        (tmp_path / "j.safetensors").read_bytes()
    flat = tck._load_tree_flat(str(tmp_path / "j.safetensors"))
    assert flat["b/w"].dtype == torch.bfloat16
    assert torch.equal(flat["b/w"], tree["b"]["w"])
    assert torch.equal(flat["a"], tree["a"])
    jflat = jck._load_tree_flat(str(tmp_path / "t.safetensors"))
    assert np.array_equal(np.asarray(jflat["b/w"], np.float32),
                          tree["b"]["w"].float().numpy())


def test_export_merged_weights_by_registry_id(model, tmp_path):
    """A tenant leaves multi-tenant serving with the artifact a dedicated
    deployment uses: the export folds the registry's pack into the base,
    within 1e-6 of the reference's merge, and the reference loads it."""
    jcfg, jparams, tcfg, tparams = model
    eng = _engine(model)
    reg = _registry(eng, ["a0", "a1"])
    out = tck.export_merged_weights(eng, str(tmp_path / "exp"),
                                    adapter_id="a1", adapters=reg)
    host = jax.tree_util.tree_map(np.asarray, jparams)
    want = merge_lora_weights(graft_adapter_pack(host, _make_pack(tcfg, 1),
                                                 scaling=1.0))
    for merged in (tck.load_merged_params(out, tparams),
                   jck.load_merged_params(out, host)):
        got_l = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
            np.asarray, merged))
        want_l = jax.tree_util.tree_leaves(want)
        assert len(got_l) == len(want_l)
        for g, w in zip(got_l, want_l):
            assert np.allclose(g, np.asarray(w), atol=1e-6)
    with open(os.path.join(out, "engine_state.json")) as f:
        assert json.load(f)["merged_adapter_id"] == "a1"
    with pytest.raises(tad.AdapterError, match="unknown adapter"):
        tck.export_merged_weights(eng, str(tmp_path / "exp2"),
                                  adapter_id="ghost", adapters=reg)
    with pytest.raises(ValueError, match="AdapterRegistry"):
        tck.export_merged_weights(eng, str(tmp_path / "exp3"),
                                  adapter_id="a0")
    reg.retire("a0"), reg.retire("a1")
    reg.check_leaks()
    reg.close()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_adapter_cold_tier_crosses_packages(model, tmp_path, writer):
    """A registry whose host tier overflows commits its packs to the cold
    store; a restarted registry of the other package rehydrates them and
    serves the same factors."""
    root = str(tmp_path / "cold")
    reader = "port" if writer == "reference" else "reference"
    reg = _registry(_engine(model, writer), ["a0", "a1"], writer,
                    host_bytes=1, coldstore_dir=root)
    assert reg.stats()["cold_blocks"] == 2
    reg.close()
    reg2 = (tad if reader == "port" else jad).AdapterRegistry(
        _engine(model, reader), coldstore_dir=root)
    assert reg2.stats()["rehydrated"] == 2 and reg2.ids() == ["a0", "a1"]
    for i, aid in enumerate(["a0", "a1"]):
        for target, (a, b) in _make_pack(model[2], i).items():
            got = reg2.get_pack(aid)[target]
            assert np.array_equal(np.asarray(got[0]), a)
            assert np.array_equal(np.asarray(got[1]), b)
    reg2.acquire("a1")
    reg2.release("a1")
    reg2.check_leaks()
    reg2.close()
