"""Parity: the port's host paging tier (``deepspeed_tpu_torch/inference/v2/
paging.py`` and the engine's demote / promote) against the JAX package's.

``serialize_block`` and the safetensors headers are byte for byte the
reference's, bf16 included (carried as tensors, without ``ml_dtypes``).
The rest mirrors the reference's paging tests: the pager's host and spill
tiers, demote → promote on both tiers, the allocator's demoted count,
a pressure soak, promote-ahead with cancels, and the COW-alias eviction
regression — each engine case on the JAX engine and the port in lockstep,
with identical tokens, pools and tier counters, and tokens equal to the
port with the cache off."""

import glob
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import paging as jpg
from deepspeed_tpu.inference.v2.prefix_cache import PrefixCache as JCache
from deepspeed_tpu.inference.v2.ragged import BlockedAllocator as JAlloc
from deepspeed_tpu.io.fast_writer import \
    build_safetensors_header as jheader
from deepspeed_tpu_torch.inference.v2.paging import (BlockPager,
                                                     deserialize_block,
                                                     serialize_block)
from deepspeed_tpu_torch.inference.v2.prefix_cache import PrefixCache
from deepspeed_tpu_torch.inference.v2.ragged import BlockedAllocator
from deepspeed_tpu_torch.io.fast_writer import (FastFileWriter,
                                                build_safetensors_header)

from tests.torch_hierarchy import (assert_consistent, assert_same_state,
                                   jax_engine, port_engine, serve,
                                   tiny_model)

PA = list(range(1, 21))


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


def _block(seed, dtype):
    """A KV block's k and v (L, block, kv heads, head dim) as port tensors
    and as the reference's numpy arrays (bf16 through ml_dtypes)."""
    rng = np.random.default_rng(seed)
    arrs = {n: rng.standard_normal((2, 8, 2, 16)).astype(np.float32)
            for n in ("k", "v")}
    tens = {n: torch.from_numpy(a).to(dtype) for n, a in arrs.items()}
    if dtype == torch.bfloat16:
        ref = {n: t.float().numpy().astype(ml_dtypes.bfloat16)
               for n, t in tens.items()}
    else:
        ref = {n: t.numpy() for n, t in tens.items()}
    return tens, ref


# ---------------------------------------------------------------------------
# serialization: byte parity with the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
def test_serialize_block_byte_identical(dtype):
    tens, ref = _block(0, dtype)
    meta = {"kind": "kv_block", "tokens": "1,2,3", "block_size": "8"}
    got = serialize_block(tens, meta)
    assert got == jpg.serialize_block(ref, meta)
    assert got == serialize_block({n: t.numpy() if dtype != torch.bfloat16
                                   else t for n, t in tens.items()}, meta)
    back = deserialize_block(got)
    assert list(back) == ["k", "v"]
    for n in tens:
        assert back[n].dtype == dtype and torch.equal(back[n], tens[n])
    # the reference decodes the port's payload to the same bits
    jback = jpg.deserialize_block(got)
    for n in tens:
        np.testing.assert_array_equal(
            jback[n].view(np.uint8),
            tens[n].contiguous().view(torch.uint8).numpy())


def test_safetensors_header_byte_identical():
    arrays = {"a": np.zeros((3, 5), np.float64), "b": np.arange(7, dtype=np.int8),
              "c": np.ones((2, 2), np.uint16), "d": np.zeros(0, np.float32)}
    meta = {"x": "1", "y": "two"}
    assert build_safetensors_header(arrays, meta) == jheader(arrays, meta)
    bf = torch.ones(4, 3, dtype=torch.bfloat16)
    got = build_safetensors_header({"w": bf})
    assert got == jheader({"w": bf.float().numpy().astype(
        ml_dtypes.bfloat16)})
    assert b'"dtype":"BF16"' in got[0]
    with pytest.raises(TypeError):
        build_safetensors_header({"z": torch.zeros(2, dtype=torch.complex64)})


def test_serialize_block_roundtrip_mixed_dtypes():
    arrays = {"k": torch.randn(2, 8, 2, 16),
              "v": torch.arange(24, dtype=torch.int32).reshape(2, 3, 4),
              "e": torch.zeros(0, 4)}
    back = deserialize_block(serialize_block(arrays, {"note": "t"}))
    assert list(back) == ["k", "v", "e"]
    for name in arrays:
        assert back[name].dtype == arrays[name].dtype
        assert torch.equal(back[name], arrays[name])


def test_fast_writer_file_is_the_reference_payload(tmp_path):
    """A spill file written through the AIO pool holds exactly the bytes
    of ``serialize_block``, bf16 included."""
    tens, _ = _block(1, torch.bfloat16)
    with FastFileWriter(block_size=1 << 20, queue_depth=8, thread_count=2,
                        fsync=False) as w:
        w.write_safetensors(tens, str(tmp_path / "b.safetensors"),
                            metadata={"m": "1"})
        assert w.last_stats["bytes"] > 0
    data = (tmp_path / "b.safetensors").read_bytes()
    assert data == serialize_block(tens, {"m": "1"})


# ---------------------------------------------------------------------------
# the pager's tiers (no model)
# ---------------------------------------------------------------------------


def test_pager_host_tier_put_get_drop():
    pg = BlockPager(host_bytes=1 << 20)
    arrays = {"k": torch.full((4, 16), 7.5)}
    handle, tier = pg.put(arrays)
    assert tier == "host" and pg.host_blocks == 1
    assert torch.equal(pg.get(handle)["k"], arrays["k"])
    assert pg.get(handle) is not None  # get does not consume
    pg.drop(handle)
    assert pg.get(handle) is None and pg.resident_blocks == 0
    # no bottom tier: a pool too small for the payload refuses
    tiny = BlockPager(host_bytes=64)
    assert tiny.put({"k": torch.zeros(64, 64)}) is None
    tiny.close()
    pg.close()
    pg.close()  # idempotent


def test_pager_spill_overflow_prefetch_and_unlink(tmp_path):
    pg = BlockPager(host_bytes=3000, spill_dir=str(tmp_path),
                    promote_ahead=True)
    handles = [pg.put({"k": torch.full((4, 32), float(i))})[0]
               for i in range(6)]
    st = pg.stats()
    assert st["tier_spill_blocks"] > 0 and st["spills"] > 0
    assert glob.glob(str(tmp_path / "*.safetensors"))
    pg.prefetch(handles)
    pg.drop(handles[0])  # a racing drop wins, without a crash
    for i, h in enumerate(handles[1:], start=1):
        got = pg.get(h)
        assert got is not None and float(got["k"][0, 0]) == float(i)
        pg.drop(h)
    deadline = time.monotonic() + 5
    while glob.glob(str(tmp_path / "*.safetensors")):
        assert time.monotonic() < deadline, "spill files not unlinked"
        time.sleep(0.05)
    assert pg.resident_blocks == 0
    pg.close()


def test_pager_tiers_match_reference(tmp_path):
    """The same blocks put into both pagers land in the same tiers (the
    payloads have the same length, so the host pool overflows alike)."""
    pagers = [jpg.BlockPager(host_bytes=6000, spill_dir=str(tmp_path / "j")),
              BlockPager(host_bytes=6000, spill_dir=str(tmp_path / "t"))]
    for i in range(5):
        tens, ref = _block(i, torch.bfloat16)
        assert pagers[1].put(tens) == pagers[0].put(ref)
    keys = ("tier_host_blocks", "tier_spill_blocks", "spills", "demotions",
            "host_bytes_used")
    st = [pg.stats() for pg in pagers]
    assert {k: st[1][k] for k in keys} == {k: st[0][k] for k in keys}
    assert st[1]["tier_spill_blocks"] > 0
    for pg in pagers:
        pg.close()


# ---------------------------------------------------------------------------
# demote → promote on both tiers, token-exact against the JAX engine
# ---------------------------------------------------------------------------


def test_host_tier_demote_promote_token_exact(model, ref):
    engs = jeng, teng = (jax_engine(model, kv_host_pool_mb=8),
                         port_engine(model, kv_host_pool_mb=8))
    assert teng.pager is not None
    assert serve(teng, PA, 6) == serve(jeng, PA, 6) == ref(PA, 6)
    assert teng.prefix_cache.evict(100) == jeng.prefix_cache.evict(100) > 0
    s = teng.prefix_stats()
    assert s["tier_host_blocks"] > 0 and s["tier_device_blocks"] == 0
    assert s["demotions"] > 0 and s["cached_blocks"] > 0
    assert_same_state(jeng, teng)
    assert_consistent(teng)
    assert serve(teng, PA, 6) == serve(jeng, PA, 6) == ref(PA, 6)
    s = teng.prefix_stats()
    assert s["promotions"] > 0 and s["hits"] >= 1
    assert s["prefill_tokens_skipped"] >= 16  # promote, not recompute
    assert_same_state(jeng, teng)
    assert_consistent(teng)
    for eng in engs:
        eng.close()
        eng.close()  # idempotent


def test_promoted_block_is_bitwise_the_demoted_one(model, tmp_path):
    """A block's bytes read before demotion equal its bytes after the
    promotion, bit for bit, in bf16 (host tier and spill tier)."""
    for over in ({"kv_host_pool_mb": 8},
                 {"kv_host_pool_bytes": 1, "kv_spill_dir": str(tmp_path)}):
        teng = port_engine(model, dtype="bfloat16", **over)
        serve(teng, PA, 6)
        before = {}
        for node in teng.prefix_cache._nodes:
            before[id(node)] = teng._read_kv_block(node.block)
        teng.prefix_cache.evict(100)
        assert teng.prefix_stats()["tier_device_blocks"] == 0
        serve(teng, PA, 6)
        for node in teng.prefix_cache._nodes:
            assert node.tier == "device"
            after = teng._read_kv_block(node.block)
            for n in ("k", "v"):
                assert torch.equal(after[n].view(torch.int16),
                                   before[id(node)][n].view(torch.int16))
        teng.close()


def test_spill_tier_demote_promote_token_exact(model, ref, tmp_path):
    jeng, teng = jax_engine(model), port_engine(model)
    for eng, cls, sub in ((jeng, jpg.BlockPager, "j"),
                          (teng, BlockPager, "t")):
        eng.pager = cls(host_bytes=1, spill_dir=str(tmp_path / sub))
        eng.prefix_cache.attach_pager(eng.pager, eng._demote_node,
                                      eng._promote_node)
    assert serve(teng, PA, 6) == serve(jeng, PA, 6) == ref(PA, 6)
    assert teng.prefix_cache.evict(100) == jeng.prefix_cache.evict(100) > 0
    s = teng.prefix_stats()
    assert s["tier_spill_blocks"] > 0 and s["tier_host_blocks"] == 0
    assert glob.glob(str(tmp_path / "t" / "*.safetensors"))
    assert_same_state(jeng, teng)
    assert serve(teng, PA, 6) == serve(jeng, PA, 6) == ref(PA, 6)
    assert teng.prefix_stats()["promotions"] > 0
    assert_same_state(jeng, teng)
    assert_consistent(teng)
    jeng.close()
    teng.close()


def test_allocator_demoted_accounting(model):
    teng = port_engine(model, kv_host_pool_mb=8)
    serve(teng, PA, 6)
    demoted = teng.prefix_cache.evict(100)
    alloc = teng.kv.allocator
    assert alloc.demoted == demoted == teng.prefix_cache.demoted_blocks
    assert teng.pager.resident_blocks == demoted
    assert_consistent(teng)
    serve(teng, PA, 6)  # promote drains the counter back
    assert alloc.demoted == teng.prefix_cache.demoted_blocks
    assert_consistent(teng)
    with pytest.raises(AssertionError, match="no demoted blocks"):
        for _ in range(alloc.demoted + 1):
            alloc.note_promote()
    teng.close()


def test_pressure_demotion_soak_zero_leaks(model, ref):
    over = dict(num_blocks=17, max_seqs=2, kv_host_pool_mb=8)
    jeng, teng = jax_engine(model, **over), port_engine(model, **over)
    for i in range(16):
        p = [10 * i + j for j in range(1, 13)]
        assert serve(teng, p, 4) == serve(jeng, p, 4) == ref(p, 4), i
        assert_same_state(jeng, teng)
        assert_consistent(teng)
    s = teng.prefix_stats()
    assert s["demotions"] > 0, "no pressure reached the pager"
    assert s["tier_host_blocks"] + s["tier_spill_blocks"] > 0
    p0 = list(range(1, 13))  # the first, now cold, session
    assert serve(teng, p0, 4) == serve(jeng, p0, 4) == ref(p0, 4)
    assert teng.prefix_stats()["promotions"] > 0
    assert_same_state(jeng, teng)
    assert_consistent(teng)
    jeng.close()
    teng.close()


def test_promote_ahead_with_cancels(model, ref, tmp_path):
    """Resumed sessions promoting demoted prefixes (staged from spill files
    by the promote-ahead thread) while half of them are cancelled at once:
    the survivors' tokens, the pools and the counters match the JAX
    engine's, and nothing leaks."""
    over = dict(num_blocks=17, max_seqs=2, kv_host_pool_bytes=20000,
                kv_promote_ahead=True)
    jeng = jax_engine(model, kv_spill_dir=str(tmp_path / "j"), **over)
    teng = port_engine(model, kv_spill_dir=str(tmp_path / "t"), **over)
    # 10 sessions x 2 full blocks > the 16-block device pool
    prompts = [[20 * i + j for j in range(1, 21)] for i in range(10)]
    for p in prompts:  # warm wave: builds and pressure-demotes the tree
        assert serve(teng, p, 4) == serve(jeng, p, 4)
    assert teng.prefix_stats()["demotions"] > 0
    assert teng.prefix_stats()["tier_spill_blocks"] > 0
    uids = [[eng.put(list(p), max_new_tokens=4) for p in prompts]
            for eng in (jeng, teng)]
    assert uids[0] == uids[1]
    for u in uids[1][::2]:
        assert teng.cancel(u) and jeng.cancel(u)
    jr, tr = jeng.generate_all(), teng.generate_all()
    for i, u in enumerate(uids[1]):
        if i % 2:
            assert tr[u] == jr[u] and tr[u][20:] == ref(prompts[i], 4), i
    assert teng.prefix_stats()["promotions"] > 0
    assert_consistent(teng)
    # the cancelled sessions' prefetched blocks are still staged: the
    # reference counts each of them twice (ROADMAP.md C2), the port once
    deadline = time.monotonic() + 10
    while not (jeng.pager._queue.empty() and teng.pager._queue.empty()):
        assert time.monotonic() < deadline
        time.sleep(0.01)
    time.sleep(0.2)  # the last dequeued prefetch lands
    staged = len(teng.pager._staged)
    assert staged == len(jeng.pager._staged) > 0
    with pytest.raises(AssertionError, match="pager holds"):
        jeng.prefix_cache.check_consistency()
    js, ts = jeng.prefix_stats(), teng.prefix_stats()
    assert ts["tier_spill_blocks"] == js["tier_spill_blocks"] - staged
    tier = ("tier_spill_blocks", "promote_wait_ms")
    assert {k: v for k, v in ts.items() if k not in tier} == \
        {k: v for k, v in js.items() if k not in tier}
    assert teng.kv.allocator._free == jeng.kv.allocator._free
    jeng.close()
    teng.close()
    assert teng.pager._closed


def test_evict_alias_dedupe_regression():
    """Two leaf paths on ONE block: both trees count it once, free it once
    and reset each node's own reference — the reference's regression, run
    on both copies in lockstep."""
    for alloc_cls, cache_cls in ((JAlloc, JCache),
                                 (BlockedAllocator, PrefixCache)):
        a = alloc_cls(8)
        pc = cache_cls(a, block_size=4)
        (b,) = a.allocate(1)
        a.incref(b)
        pc.donate([1, 2, 3, 4], 4, [b])
        pc.donate([5, 6, 7, 8], 4, [b])
        assert pc.cached_blocks == 2 and pc.evictable_blocks == 1
        assert pc.shared_blocks == 0
        assert pc.evict(10) == 1
        assert a.free_blocks == 8 and pc.cached_blocks == 0
        (b2,) = a.allocate(1)
        a.incref(b2)
        pc.donate([1, 2, 3, 4], 4, [b2])
        pc.donate([5, 6, 7, 8], 4, [b2])
        a.incref(b2)  # the "sequence"
        assert pc.evictable_blocks == 0 and pc.shared_blocks == 1
        assert pc.evict(10) == 0
        a.free([b2])
        assert pc.evict(10) == 1 and a.free_blocks == 8
        (b3,) = a.allocate(1)
        a.incref(b3)
        pc.donate([1, 2, 3, 4], 4, [b3])
        pc.donate([5, 6, 7, 8], 4, [b3])
        assert pc.reset() == 2 and a.free_blocks == 8
        a.check_consistency()
