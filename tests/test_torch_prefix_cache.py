"""Parity: the port's KV prefix cache (``deepspeed_tpu_torch/inference/v2/
prefix_cache.py`` and the engine's hooks) against the JAX package's.

The radix tree is host code copied from the reference, so a seeded fuzz of
match / donate / evict / cancel drives both copies to identical matches,
stats and free lists.  The engine cases mirror the reference's own tests
(sequential reuse, copy-on-write, concurrent sharing, eviction, cancel,
the min-tokens gate, burst decode, strict ``put``, a template soak): each
serves the same traffic on the JAX engine with the cache on, on the port
with it on and on the port with it off, and the greedy tokens, block pools
and prefix stats must be identical.  ``export_prefix`` payloads are byte
for byte the reference's, and either engine imports the other's."""

import json

import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2.prefix_cache import PrefixCache as JCache
from deepspeed_tpu.inference.v2.ragged import BlockedAllocator as JAlloc
from deepspeed_tpu_torch.inference.v2.prefix_cache import (PrefixCache,
                                                           prefix_digests)
from deepspeed_tpu_torch.inference.v2.ragged import BlockedAllocator

from tests.torch_hierarchy import (assert_consistent, assert_same_state,
                                   jax_engine, port_engine, serve,
                                   tiny_model)

PA = list(range(1, 21))


@pytest.fixture(scope="module")
def model():
    return tiny_model()


@pytest.fixture(scope="module")
def ref(model):
    """Greedy continuation on the port with the cache off (memoized)."""
    eng = port_engine(model, cache=False)
    memo = {}

    def fn(prompt, n):
        key = (tuple(prompt), n)
        if key not in memo:
            memo[key] = serve(eng, prompt, n)
        return memo[key]

    return fn


def _trio(model, **over):
    return jax_engine(model, **over), port_engine(model, **over)


# ---------------------------------------------------------------------------
# radix tree, no model: a seeded fuzz on both copies
# ---------------------------------------------------------------------------


def _match_tuple(m):
    return None if m is None else (m.blocks, m.tokens, m.cow_src,
                                   m.cow_tokens)


@pytest.mark.parametrize("seed", range(4))
def test_radix_tree_fuzz_identical(seed):
    """Random sequences allocate, match a cached prefix (taking a COW
    source's pin), donate or are cancelled (released), and the pool is
    squeezed by evictions — on both trees in lockstep.  Every match, every
    evict count, the stats, the free lists and the refcounts agree."""
    rng = np.random.default_rng(seed)
    bs = 4
    trees = []
    for alloc_cls, cache_cls in ((JAlloc, JCache),
                                 (BlockedAllocator, PrefixCache)):
        a = alloc_cls(24)
        trees.append((a, cache_cls(a, block_size=bs,
                                   min_prefix_tokens=int(seed % 2) * 4)))
    templates = [list(range(1, 13)), list(range(50, 62)), [7, 7, 7, 7]]
    live = []  # (tokens, blocks per tree)
    for _ in range(120):
        op = rng.random()
        if op < 0.45:
            tpl = templates[int(rng.integers(len(templates)))]
            toks = tpl[:int(rng.integers(1, len(tpl) + 1))] + rng.integers(
                100, 140, size=int(rng.integers(0, 9))).tolist()
            got = []
            for a, pc in trees:
                m = pc.match(toks, limit=len(toks) - 1)
                blocks = [] if m is None else list(m.blocks)
                if m is not None and m.cow_src is not None:
                    a.free([m.cow_src])
                need = -(-len(toks) // bs) - len(blocks)
                if need > a.free_blocks:
                    pc.evict(need - a.free_blocks)
                if need > a.free_blocks:
                    a.free(blocks)
                    blocks = None
                else:
                    blocks += a.allocate(need)
                got.append((_match_tuple(m), blocks))
            assert got[0] == got[1]
            if got[0][1] is not None:
                live.append((toks, [g[1] for g in got]))
        elif op < 0.75 and live:
            toks, per_tree = live.pop(int(rng.integers(len(live))))
            cancel = rng.random() < 0.3
            for (a, pc), blocks in zip(trees, per_tree):
                if cancel:
                    a.free(blocks)
                else:
                    pc.donate(toks, len(toks), blocks)
        else:
            n = int(rng.integers(1, 6))
            assert trees[0][1].evict(n) == trees[1][1].evict(n)
        (ja, jc), (ta, tc) = trees
        assert ta._free == ja._free and ta._refs == ja._refs
        assert tc.stats() == jc.stats()
        assert tc.summary() == jc.summary()
        tc.check_consistency()
    assert trees[1][1].stats()["lookups"] > 0


def test_prefix_digests_match_reference():
    from deepspeed_tpu.inference.v2.prefix_cache import \
        prefix_digests as jdig

    toks = list(range(1000, 1050))
    assert prefix_digests(toks, 8) == jdig(toks, 8)
    assert prefix_digests(toks, 8, max_chunks=3) == jdig(toks, 8, 3)


# ---------------------------------------------------------------------------
# engine: token-exact with sharing, COW, eviction, cancellation
# ---------------------------------------------------------------------------


def test_sequential_reuse_token_exact(model, ref):
    jeng, teng = _trio(model)
    for _ in range(3):
        assert serve(teng, PA, 6) == serve(jeng, PA, 6) == ref(PA, 6)
        assert_same_state(jeng, teng)
    s = teng.prefix_stats()
    assert s["hits"] == 2 and s["prefill_tokens_skipped"] >= 2 * 16
    assert_consistent(teng)


def test_partial_block_divergence_cow_token_exact(model, ref):
    jeng, teng = _trio(model)
    pB = PA[:12] + [99, 98, 97, 96]  # shares block 0 + 4 tokens of block 1
    for p in (PA, pB):
        assert serve(teng, p, 6) == serve(jeng, p, 6) == ref(p, 6)
        assert_same_state(jeng, teng)
    s = teng.prefix_stats()
    assert s["cow_copies"] >= 1 and s["hits"] >= 1
    assert_consistent(teng)


def test_cow_stale_tail_is_never_read(model, ref):
    """A copy-on-write block carries the source's KV past the shared
    prefix.  Poison those positions with large values in every layer right
    after the copy: the step writes the chunk's KV before attention and
    the paged attention masks keys at or past ``context_lens``, so the
    tokens stay those of the uncached run."""
    teng = port_engine(model)
    serve(teng, PA, 6)
    copy, match = teng._cow_copy, teng.prefix_cache.match
    last, poisoned = {}, []

    def recording_match(tokens, limit):
        last["m"] = match(tokens, limit)
        return last["m"]

    def poisoning_copy(src, dst):
        copy(src, dst)
        shared = last["m"].cow_tokens
        for cache in teng.caches.values():
            cache[:, dst, shared:] = 100.0
        poisoned.append((dst, shared))

    teng.prefix_cache.match = recording_match
    teng._cow_copy = poisoning_copy
    for pB in (PA[:12] + [99, 98, 97, 96], PA[:10] + [5]):
        assert serve(teng, pB, 6) == ref(pB, 6)
    assert len(poisoned) == 2 and all(s > 0 for _, s in poisoned)
    assert_consistent(teng)


def test_concurrent_sharing_one_block_many_streams(model, ref):
    jeng, teng = _trio(model)
    for eng in (jeng, teng):
        serve(eng, PA, 6)  # warm the tree
    first = next(iter(teng.prefix_cache._nodes)).block
    uids = [[eng.put(list(PA), max_new_tokens=6) for _ in range(3)]
            for eng in (jeng, teng)]
    assert uids[0] == uids[1]
    assert teng.step() == jeng.step()  # all three match the cached prefix
    assert teng.kv.allocator.refcount(first) == 4  # tree + 3 sharers
    assert teng.prefix_stats()["shared_blocks"] >= 2
    assert_same_state(jeng, teng)
    assert_consistent(teng, idle=False)
    jr, tr = jeng.generate_all(), teng.generate_all()
    for u in uids[1]:
        assert tr[u] == jr[u] and tr[u][len(PA):] == ref(PA, 6)
    assert teng.kv.allocator.refcount(first) == 1  # only the tree
    assert_same_state(jeng, teng)
    assert_consistent(teng)


def test_eviction_under_pool_pressure(model, ref):
    jeng, teng = _trio(model, num_blocks=17, max_seqs=2)  # 16 usable
    for i in range(16):
        p = [10 * i + j for j in range(1, 13)]
        assert serve(teng, p, 4) == serve(jeng, p, 4) == ref(p, 4), i
        assert_same_state(jeng, teng)
        assert_consistent(teng)
    assert teng.prefix_stats()["evictions"] > 0


def test_cancel_with_shared_blocks_decrements_refcounts(model, ref):
    jeng, teng = _trio(model)
    for eng in (jeng, teng):
        serve(eng, PA, 6)
    first = next(iter(teng.prefix_cache._nodes)).block
    keeps, victims = [], []
    for eng in (jeng, teng):
        keeps.append(eng.put(list(PA), max_new_tokens=6))
        victims.append(eng.put(list(PA), max_new_tokens=6))
    assert teng.step() == jeng.step()
    assert teng.kv.allocator.refcount(first) == 3
    assert teng.cancel(victims[1]) and jeng.cancel(victims[0])
    assert_same_state(jeng, teng)
    jr, tr = jeng.generate_all(), teng.generate_all()
    assert tr[keeps[1]] == jr[keeps[0]]
    assert tr[keeps[1]][len(PA):] == ref(PA, 6)
    assert_same_state(jeng, teng)
    assert_consistent(teng)


def test_min_prefix_tokens_gates_hits(model, ref):
    jeng, teng = _trio(model, prefix_cache_min_tokens=16)
    pA = list(range(1, 25))  # 3 full blocks cached after donation
    pB = pA[:8] + [88, 87, 86, 85]  # 8 shared tokens < 16: no hit
    for p, hits in ((pA, 0), (pB, 0), (pA, 1)):
        assert serve(teng, p, 6) == serve(jeng, p, 6) == ref(p, 6)
        assert teng.prefix_stats()["hits"] == hits
        assert_same_state(jeng, teng)
    assert_consistent(teng)


def test_burst_decode_with_cache_token_exact(model, ref):
    jeng, teng = _trio(model)
    pA = list(range(3, 19))
    for _ in range(2):
        assert serve(teng, pA, 16, burst=8) == serve(jeng, pA, 16, burst=8) \
            == ref(pA, 16)
    assert teng.prefix_stats()["hits"] == 1
    assert teng.burst_steps == jeng.burst_steps > 0
    assert_same_state(jeng, teng)
    assert_consistent(teng)


def test_strict_put_counts_evictable_as_free(model):
    jeng, teng = _trio(model, num_blocks=17, max_seqs=2)  # 16 usable
    for i in range(4):  # fill the tree with distinct donated prefixes
        p = [20 * i + j for j in range(1, 13)]
        assert serve(teng, p, 4) == serve(jeng, p, 4)
    assert teng.evictable_blocks > 0
    assert teng.free_blocks + teng.reclaimable_blocks >= 5
    # needs 3 blocks; must not raise even if raw free is low
    p = list(range(240, 252))
    uids = [eng.put(list(p), max_new_tokens=4, strict=True)
            for eng in (jeng, teng)]
    assert teng.generate_all()[uids[1]] == jeng.generate_all()[uids[0]]
    assert_same_state(jeng, teng)
    assert_consistent(teng)


def test_fuzz_shared_templates_cancels_exact_and_leak_free(model, ref):
    """The reference's randomized soak, on both engines in lockstep:
    template-heavy traffic with random suffixes, steps and cancels."""
    rng = np.random.RandomState(7)
    jeng, teng = _trio(model, num_blocks=33)  # 32 usable: real pressure
    templates = [list(range(1, 17)), list(range(50, 66)), [5, 6, 7, 8]]
    prompts, emitted = {}, {}
    for _ in range(10):
        for _ in range(rng.randint(1, 3)):
            tpl = templates[rng.randint(len(templates))]
            suffix = [int(t) for t in rng.randint(100, 250,
                                                  size=rng.randint(0, 4))]
            prompt, n = tpl + suffix, int(rng.randint(2, 7))
            uid = jeng.put(list(prompt), max_new_tokens=n)
            assert teng.put(list(prompt), max_new_tokens=n) == uid
            prompts[uid] = (prompt, n)
        for _ in range(rng.randint(1, 5)):
            out = teng.step()
            assert out == jeng.step()
            for uid, toks in out.items():
                emitted.setdefault(uid, []).extend(toks)
        live = [u for u in prompts if u in jeng.running
                or any(s.uid == u for s in jeng.waiting)]
        if live and rng.rand() < 0.3:
            victim = live[rng.randint(len(live))]
            assert teng.cancel(victim) == jeng.cancel(victim)
        assert_same_state(jeng, teng)
        teng.kv.allocator.check_consistency()
    jr, tr = jeng.generate_all(), teng.generate_all()
    assert tr == jr
    for uid, (prompt, n) in prompts.items():
        # finished or cancelled before the last drive: its steps' tokens
        got = tr[uid][len(prompt):] if uid in tr else emitted.get(uid, [])
        assert got == ref(prompt, n)[:len(got)], uid
    assert_consistent(teng)
    assert teng.prefix_stats()["hits"] > 0


# ---------------------------------------------------------------------------
# KV handoff: export_prefix / import_prefix across the packages
# ---------------------------------------------------------------------------


def _header(payload):
    hlen = int.from_bytes(payload[:8], "little")
    return json.loads(payload[8:8 + hlen].decode())


def test_export_prefix_is_the_reference_payload(model):
    jeng, teng = _trio(model)
    prompt = list(range(1, 30))
    assert serve(teng, prompt, 5) == serve(jeng, prompt, 5)
    assert teng.export_prefix([1, 2]) is None  # nothing cached
    got, want = teng.export_prefix(prompt), jeng.export_prefix(prompt)
    assert _header(got) == _header(want)
    assert _header(got)["k"]["shape"][1] == 3  # 3 full blocks of 8
    # the same KV to the float's last bits: the two forwards differ only in
    # summation order, so compare the values, and the layout exactly
    ln = 8 + int.from_bytes(got[:8], "little")
    g = np.frombuffer(got[ln:], np.float32)
    w = np.frombuffer(want[ln:], np.float32)
    np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
    assert_same_state(jeng, teng)  # the export's pins are dropped
    assert teng.export_prefix(prompt) == got  # deterministic


def test_export_import_across_packages(model, ref):
    """A prefill replica of either package exports, a decode replica of
    the other imports and continues from the first uncached token with the
    uncached greedy tokens."""
    prompt = list(range(40, 70))
    donors = _trio(model)
    payloads = []
    for eng in donors:
        serve(eng, prompt, 4)
        payloads.append(eng.export_prefix(prompt))
    for payload, dst in ((payloads[0], port_engine(model)),
                         (payloads[1], jax_engine(model))):
        assert dst.import_prefix(payload) == 24
        assert serve(dst, prompt, 6) == ref(prompt, 6)
        assert dst.prefix_stats()["prefill_tokens_skipped"] == 24
        assert_consistent(dst)
    # a block-size mismatch is not transferable
    assert port_engine(model, block_size=4,
                       max_blocks_per_seq=16).import_prefix(payloads[0]) == 0


def test_import_prefix_bf16_payload_from_reference(model):
    """A bf16 engine's payload crosses without ml_dtypes on the port side:
    the port's import holds the reference's bits exactly and re-exports
    the same bytes."""
    jeng = jax_engine(model, dtype="bfloat16")
    teng = port_engine(model, dtype="bfloat16")
    prompt = list(range(3, 27))
    serve(jeng, prompt, 3)
    payload = jeng.export_prefix(prompt)
    assert _header(payload)["k"]["dtype"] == "BF16"
    assert teng.import_prefix(payload) == 24
    assert teng.export_prefix(prompt) == payload
    assert teng.caches["k"].dtype == torch.bfloat16
