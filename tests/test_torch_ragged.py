"""Parity: the port's host-side ragged batching / paged-KV bookkeeping
(``deepspeed_tpu_torch/inference/v2/ragged.py``, a copy that must not
import the JAX package) behaves exactly like the JAX package's module under
the same operations — allocator, KV manager, batch builder and SoA decode
table, driven by one numpy-seeded scheduling fuzz."""

import dataclasses

import numpy as np
import pytest

from deepspeed_tpu.inference.v2 import ragged as jr
from deepspeed_tpu_torch.inference.v2 import ragged as tr

from tests.torch_cpu import one_torch_thread  # noqa: F401


def _same_state(a, b):
    """Two objects of the twin classes hold equal state."""
    da, db = vars(a), vars(b)
    assert da.keys() == db.keys()
    for key in da:
        va, vb = da[key], db[key]
        if isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=key)
            assert va.dtype == vb.dtype, key
        elif key == "seq_at":
            assert {r: s.uid for r, s in va.items()} == \
                {r: s.uid for r, s in vb.items()}
        elif key in ("allocator",):
            _same_state(va, vb)
        else:
            assert va == vb, key


def _same_batch(a, b):
    for f in dataclasses.fields(jr.RaggedBatch):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
            assert va.dtype == vb.dtype, f.name
        else:
            assert va == vb, f.name


def test_allocator_semantics():
    a = tr.BlockedAllocator(8)
    got = a.allocate(3)
    assert got == [0, 1, 2] and a.free_blocks == 5
    a.incref(1)
    a.free(got)
    assert a.free_blocks == 7 and a.refcount(1) == 1
    with pytest.raises(ValueError, match="double-free"):
        a.free([0])
    with pytest.raises(MemoryError):
        a.allocate(9)
    a.free([1])
    a.check_consistency()
    assert a.free_blocks == 8


def test_kv_manager_capacity():
    kv = tr.KVCacheManager(num_blocks=4, block_size=4, max_blocks_per_seq=3)
    seq = tr.SequenceDescriptor(uid=1, tokens=list(range(10)))
    assert not kv.ensure_capacity(seq, 13)
    assert kv.ensure_capacity(seq, 10)
    assert len(seq.blocks) == 3
    kv.release(seq)
    assert kv.allocator.free_blocks == 4


def test_builder_matches_reference_layout():
    s = [tr.SequenceDescriptor(uid=1, tokens=[5, 6, 7], blocks=[0]),
         tr.SequenceDescriptor(uid=2, tokens=[8, 9], blocks=[1],
                               seen_tokens=1)]
    j = [jr.SequenceDescriptor(**dataclasses.asdict(x)) for x in s]
    bt = tr.RaggedBatchBuilder(16, 4, 4).build([(s[0], 3), (s[1], 1)])
    bj = jr.RaggedBatchBuilder(16, 4, 4).build([(j[0], 3), (j[1], 1)])
    _same_batch(bt, bj)
    np.testing.assert_array_equal(bt.token_ids[:4], [5, 6, 7, 9])
    np.testing.assert_array_equal(bt.seq_index[:5], [0, 0, 0, 1, -1])


class _Twin:
    """The same scheduler-shaped operations applied to both modules."""

    def __init__(self, mod, num_blocks, bs, max_blocks, max_tokens, max_seqs):
        self.mod = mod
        self.kv = mod.KVCacheManager(num_blocks, bs, max_blocks)
        self.builder = mod.RaggedBatchBuilder(max_tokens, max_seqs, max_blocks)
        self.table = mod.DecodeStateTable(max_seqs, max_blocks,
                                          max_blocks * bs)
        self.seqs = {}


@pytest.mark.parametrize("seed", range(6))
def test_scheduling_fuzz_identical(seed):
    rng = np.random.default_rng(seed)
    kw = dict(num_blocks=24, bs=4, max_blocks=6, max_tokens=16, max_seqs=4)
    twins = [_Twin(jr, **kw), _Twin(tr, **kw)]
    uid = stepped = 0
    for _ in range(120):
        op = rng.choice(["put", "step", "decode", "retire"],
                        p=[0.3, 0.3, 0.25, 0.15])
        if op == "put" and len(twins[0].seqs) < kw["max_seqs"]:
            uid += 1
            n = int(rng.integers(1, 14))
            toks = rng.integers(0, 100, size=n).tolist()
            budget = int(rng.integers(1, 6))
            temp = None if rng.random() < 0.5 else float(rng.random())
            seed_ = int(rng.integers(-2**31, 2**31))
            for tw in twins:
                seq = tw.mod.SequenceDescriptor(
                    uid=uid, tokens=list(toks), max_new_tokens=budget,
                    temperature=temp, seed=seed_)
                ok = tw.kv.ensure_capacity(seq, n + budget)
                if ok:
                    tw.seqs[uid] = seq
                    tw.table.admit(seq)
            assert (uid in twins[0].seqs) == (uid in twins[1].seqs)
        elif op == "step" and twins[0].seqs:
            picks_uids = sorted(twins[0].seqs)[: kw["max_seqs"]]
            chunk = {u: int(rng.integers(1, 5)) for u in picks_uids}
            batches = []
            for tw in twins:
                picks, budget = [], kw["max_tokens"]
                for u in picks_uids:
                    seq = tw.seqs[u]
                    tw.table.flush_tokens(seq)
                    left = seq.cur_len - seq.seen_tokens
                    n = min(left if left else 1, chunk[u], budget)
                    if n <= 0 or not tw.kv.ensure_capacity(seq, n):
                        continue
                    picks.append((seq, n))
                    budget -= n
                batches.append(tw.builder.build(picks))
                for seq, n in picks:
                    seq.seen_tokens = min(seq.seen_tokens + n, seq.cur_len)
                    tw.table.sync(seq)
            _same_batch(*batches)
            stepped += batches[0].num_tokens
        elif op == "decode" and twins[0].seqs:
            for tw in twins:
                t = tw.table
                rows = np.nonzero(t.active)[0]
                sel = (rows * 7 + 3).astype(np.int32)
                t.hist[rows, t.hist_len[rows]] = sel
                t.hist_len[rows] += 1
                t.next_tok[rows] = sel
                t.ctx[rows] = np.minimum(t.ctx[rows] + 1,
                                         t.limit[rows] - 1)
                t.gen[rows] += 1
        elif op == "retire" and twins[0].seqs:
            u = int(rng.choice(sorted(twins[0].seqs)))
            for tw in twins:
                seq = tw.seqs.pop(u)
                tw.table.retire(seq)
                tw.kv.release(seq)
        _same_state(twins[0].kv.allocator, twins[1].kv.allocator)
        _same_state(twins[0].table, twins[1].table)
        for u in twins[0].seqs:
            sa, sb = twins[0].seqs[u], twins[1].seqs[u]
            assert dataclasses.asdict(sa) == dataclasses.asdict(sb)
    for tw in twins:
        tw.kv.allocator.check_consistency()
    assert uid > 5 and stepped > 20  # the fuzz did admit and schedule work
