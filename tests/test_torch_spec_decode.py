"""Parity: the port's speculative decoding (``deepspeed_tpu_torch/
inference/v2/spec.py``, ``linear/spec_heads.py``, the engine's
``spec_mode``) against the JAX package's, on ``tiny`` in f32.

Mirrors every test of ``tests/test_spec_decode.py`` but the broker's
(``serving/`` arrives with ROADMAP.md A9).  Each traffic runs once on the
reference engine (its Pallas kernels in interpret mode on the CPU) and
once on the port's: greedy tokens must be identical to the reference's and
to the plain uncached forward, and ``spec_stats`` and the ``engine/step``
trace (``kind``, ``emitted``, ``proposed``, ``accepted``) must be the
reference's exactly.  The self-draft heads are the reference engine's
default heads (``init_spec_heads(PRNGKey(1), ...)``), converted.  Sampled
rows draw from the port's own generators, so they are held to determinism
per seed and to the target distribution, not to the reference's bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import engine as je
from deepspeed_tpu.inference.v2 import spec as jspec
from deepspeed_tpu.linear import spec_heads as jsh
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.observability.trace import tracer as jtracer
from deepspeed_tpu_torch.inference.v2 import engine as te
from deepspeed_tpu_torch.inference.v2 import spec as tspec
from deepspeed_tpu_torch.linear import (apply_spec_heads, greedy_rollouts,
                                        init_spec_heads, train_spec_heads,
                                        trainable_subtree, tree_leaves)
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.observability.trace import tracer as ttracer

from tests.torch_cpu import one_torch_thread  # noqa: F401

V2 = dict(max_tokens_per_step=32, max_seqs=4, block_size=8, num_blocks=64,
          max_blocks_per_seq=8, dtype="float32")
MODES = ["self_draft", "draft"]
# the reference's tests use spec_k 3 and 4; one k here shares the
# reference's compiled programs across every traffic (the traffic is its)
K = 4


@pytest.fixture(scope="module")
def model():
    """(JAX config, JAX params, port config, port params, (reference
    heads, port heads)) of ``tiny`` in f32; the heads are the reference
    engine's defaults for spec_k = K."""
    jcfg = jt.get_config("tiny", dtype="float32")
    jparams = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = tt.get_config("tiny", dtype="float32")
    tparams = tt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                 tcfg, device="cpu")
    jh = jsh.init_spec_heads(jax.random.PRNGKey(1), jcfg, K,
                             base_params=jparams)
    heads = (jh, tt.spec_heads_from_jax(
        jax.tree_util.tree_map(np.asarray, jh), device="cpu"))
    return jcfg, jparams, tcfg, tparams, heads


@pytest.fixture(scope="module")
def plain(model):
    """Greedy continuation by the port's uncached forward — the
    non-speculative oracle every speculative stream must match."""
    _, _, tcfg, tparams, _ = model
    memo = {}

    def fn(prompt, n):
        key = (tuple(prompt), n)
        if key not in memo:
            seq = list(prompt)
            with torch.no_grad():
                for _ in range(n):
                    logits = tt.forward(tparams, torch.tensor([seq]), tcfg)
                    seq.append(int(logits[0, -1].argmax()))
            memo[key] = seq[len(prompt):]
        return memo[key]

    return fn


def _pair(model, mode, **over):
    """(reference engine, port engine) on one V2Config."""
    jcfg, jparams, tcfg, tparams, heads = model
    kw = {**V2, "spec_mode": mode, "spec_k": K, **over}
    jkw, tkw = {}, {}
    if mode == "draft":
        # draft == target: the acceptance upper bound, and the strictest
        # identity test (an off-by-one in draft KV positions breaks it)
        jkw = dict(draft_params=jparams, draft_config=jcfg)
        tkw = dict(draft_params=tparams, draft_config=tcfg)
    elif mode == "self_draft":
        tkw = dict(spec_heads=heads[1])
    return (je.InferenceEngineV2(jcfg, jparams, je.V2Config(**kw), **jkw),
            te.InferenceEngineV2(tcfg, tparams, te.V2Config(**kw),
                                 device="cpu", **tkw))


def _traced(tr, fn):
    """(fn's result, the engine/step spans it recorded as (kind, emitted,
    proposed, accepted))."""
    last = max((s.seq for s in tr.spans()), default=0)
    out = fn()
    steps = [(s.attrs["kind"], s.attrs.get("emitted"), s.attrs.get("proposed"),
              s.attrs.get("accepted"))
             for s in tr.spans(name="engine/step") if s.seq > last]
    return out, steps


def _both(model, mode, scenario, **over):
    """Run ``scenario(engine)`` on both engines; the port's outputs,
    ``spec_stats`` and step trace must be the reference's.  Returns (port
    outputs, port engine)."""
    jeng, teng = _pair(model, mode, **over)
    want, jsteps = _traced(jtracer, lambda: scenario(jeng))
    got, tsteps = _traced(ttracer, lambda: scenario(teng))
    assert got == want
    assert teng.spec_stats() == jeng.spec_stats()
    assert tsteps == jsteps
    assert (teng.fast_steps, teng.burst_steps) == \
        (jeng.fast_steps, jeng.burst_steps)
    return got, teng


def _assert_no_block_leak(eng, idle=True):
    eng.kv.allocator.check_consistency()
    free, ev, pin, tot = (eng.free_blocks, eng.evictable_blocks,
                          eng.pinned_blocks, eng.total_blocks)
    assert free + ev + pin == tot, (free, ev, pin, tot)
    if idle:
        assert pin == 0, f"{pin} blocks pinned with no live sequence"


# ---------------------------------------------------------------------------
# greedy identity: the output is exactly the non-speculative tokens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_greedy_identity_sequential(model, plain, mode):
    reqs = [([5, 6, 7, 8], 9), ([1, 2, 3], 6), ([42], 11)]

    def scenario(eng):
        out = []
        for prompt, n in reqs:
            uid = eng.put(prompt, max_new_tokens=n)
            out.append(eng.generate_all()[uid])
        return out

    got, teng = _both(model, mode, scenario)
    assert got == [p + plain(p, n) for p, n in reqs]
    assert teng.spec_steps > 0
    _assert_no_block_leak(teng)


@pytest.mark.parametrize("mode", MODES)
def test_greedy_identity_concurrent_streams(model, plain, mode):
    """Interleaved requests of different lengths and budgets share the
    batch; each stream stays exact and rows never cross."""
    reqs = [([5, 6, 7], 8), ([9, 8, 7, 6], 5), ([11, 12], 12), ([3], 7)]

    def scenario(eng):
        uids = [eng.put(p, max_new_tokens=n) for p, n in reqs]
        res = eng.generate_all()
        return [res[u] for u in uids]

    got, teng = _both(model, mode, scenario)
    assert got == [p + plain(p, n) for p, n in reqs]
    if mode == "draft":  # draft == target: multi-token steps, no fallback
        assert teng.spec_emitted > teng.spec_steps
    _assert_no_block_leak(teng)


def test_step_emits_token_lists(model, plain):
    """The step() contract: {uid: [tokens]} with 1..k+1 tokens each, step
    for step the reference's; their concatenation is the greedy
    continuation."""

    def scenario(eng):
        uid = eng.put([7, 8, 9], max_new_tokens=10)
        steps = []
        for _ in range(50):
            if not eng.running and not eng.waiting:
                break
            steps.append(eng.step().get(uid, []))
        return steps

    steps, _ = _both(model, "draft", scenario)
    assert all(1 <= len(s) <= K + 1 for s in steps if s)
    assert [t for s in steps for t in s] == plain([7, 8, 9], 10)


@pytest.mark.parametrize("mode", MODES)
def test_cancel_mid_speculation(model, plain, mode):
    """Cancel between speculative steps: the survivor stays exact and every
    block of the victim returns to the pool."""

    def scenario(eng):
        free0 = eng.kv.allocator.free_blocks
        keep = eng.put([5, 6, 7], max_new_tokens=12)
        victim = eng.put([1, 2, 3, 4], max_new_tokens=12)
        first = [eng.step(), eng.step()]  # prefill, then a spec step
        assert eng.cancel(victim)
        res = eng.generate_all()
        assert eng.kv.allocator.free_blocks == free0
        return first, res[keep]

    (_, kept), teng = _both(model, mode, scenario)
    assert kept == [5, 6, 7] + plain([5, 6, 7], 12)
    _assert_no_block_leak(teng)


def test_arrival_mid_decode_falls_back_then_resumes(model, plain):
    """An arrival forces mixed steps mid-stream: the engine falls back
    (counted) and both streams stay exact."""

    def scenario(eng):
        u1 = eng.put([5, 6, 7], max_new_tokens=14)
        eng.step()  # prefill u1
        eng.step()  # a speculative step
        u2 = eng.put([9, 8, 7], max_new_tokens=6)
        res = eng.generate_all()
        return res[u1], res[u2]

    (r1, r2), teng = _both(model, "self_draft", scenario)
    assert r1 == [5, 6, 7] + plain([5, 6, 7], 14)
    assert r2 == [9, 8, 7] + plain([9, 8, 7], 6)
    assert teng.spec_fallback > 0
    _assert_no_block_leak(teng)


# ---------------------------------------------------------------------------
# prefix cache: a rejected suffix moves no refcount
# ---------------------------------------------------------------------------


def test_prefix_cache_spec_rollback_keeps_refcounts(model, plain):
    shared = list(range(1, 17))  # two full blocks of shareable prefix

    def scenario(eng):
        u1 = eng.put(shared + [20], max_new_tokens=6)
        r1 = eng.generate_all()[u1]
        # the second request takes the prefix hit and decodes
        # speculatively through the shared blocks' attention window
        u2 = eng.put(shared + [21], max_new_tokens=8)
        got = []
        while eng.waiting or eng._prefilling:
            got.extend(eng.step().get(u2, []))
        assert eng.prefix_cache.hits >= 1
        alloc = eng.kv.allocator
        refs0 = [alloc.refcount(b) for b in range(alloc.num_blocks)]
        spec0 = eng.spec_steps
        while u2 in eng.running:
            got.extend(eng.step().get(u2, []))
            if u2 in eng.running:  # _finish legitimately moves refcounts
                assert [alloc.refcount(b) for b in range(alloc.num_blocks)] \
                    == refs0, "speculative rollback moved a block refcount"
        assert eng.spec_steps > spec0
        return r1, got

    (r1, got), teng = _both(model, "self_draft", scenario,
                            enable_prefix_cache=True)
    assert r1 == shared + [20] + plain(shared + [20], 6)
    assert got == plain(shared + [21], 8)
    _assert_no_block_leak(teng, idle=False)


def test_prefix_cache_spec_token_identity_warm(model, plain):
    """Warm-cache speculative decode is exact: the shared-prefix KV the
    verify attends through came from a donated tree."""
    shared = [1 + (3 * j) % 250 for j in range(20)]

    def scenario(eng):
        out = []
        for suffix in ([31], [32], [33]):
            uid = eng.put(shared + suffix, max_new_tokens=7)
            out.append(eng.generate_all()[uid])
        return out

    got, teng = _both(model, "self_draft", scenario,
                      enable_prefix_cache=True)
    assert got == [shared + s + plain(shared + s, 7)
                   for s in ([31], [32], [33])]
    assert teng.prefix_cache.hits >= 2
    _assert_no_block_leak(teng, idle=False)
    assert teng.pinned_blocks == 0


# ---------------------------------------------------------------------------
# the verify forward and the heads against the reference's, on one state
# ---------------------------------------------------------------------------


def test_verify_body_logits_match_reference(model):
    """Both engines prefill the same requests; then one k+1-position verify
    forward over the same caches (a row near its reservation's end parks
    writes in scratch) gives logits within 1e-5 of the reference's, and the
    caches stay equal."""
    jcfg, _, tcfg, _, _ = model
    jeng, teng = _pair(model, "off")
    for eng in (jeng, teng):
        eng.put(list(range(1, 12)), max_new_tokens=6)
        eng.put([7, 8], max_new_tokens=2)  # pos_limit 4: parks 2 of 5
        eng.put(list(range(30, 50)), max_new_tokens=6)
        eng.step()
    t = teng.table
    np.testing.assert_array_equal(t.ctx, jeng.table.ctx)
    Q = 5
    tokens = np.random.default_rng(0).integers(0, tcfg.vocab_size,
                                               (V2["max_seqs"], Q))
    tokens = tokens.astype(np.int32)
    jlog, jhid, jcaches = jspec.verify_body(
        jeng.params, jeng.caches, jnp.asarray(tokens), jnp.asarray(t.ctx),
        jnp.asarray(t.block_tables), jnp.asarray(t.limit), jeng.model_cfg,
        jeng.cfg)
    vin = tspec.verify_inputs(t.ctx, t.block_tables, t.limit, Q,
                              V2["block_size"],
                              teng.caches["k"].shape[1] - 1, teng.device)
    tlog, thid = tspec.verify_body(teng.params, teng.caches,
                                   torch.from_numpy(tokens), vin,
                                   teng.model_cfg, teng.cfg, teng.rope)
    live = t.ctx[:, None] + np.arange(Q)[None, :] < t.limit[:, None]
    live &= (t.ctx > 0)[:, None]
    np.testing.assert_allclose(tlog.numpy()[live], np.asarray(jlog)[live],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(thid.numpy()[live], np.asarray(jhid)[live],
                               atol=1e-5, rtol=0)
    for name in ("k", "v"):  # the scratch block aside
        np.testing.assert_allclose(teng.caches[name][:, :-1].numpy(),
                                   np.asarray(jcaches[name])[:, :-1],
                                   atol=1e-5, rtol=0)


def test_sampled_acceptance_preserves_target_distribution():
    """Accept / residual-resample emits the FIRST token with exactly the
    target marginal p_0 for a mismatched proposal q (the Leviathan
    identity), against a same-size exact-sampling baseline."""
    k, V, N = 2, 8, 4000
    rng = np.random.default_rng(42)
    logits = torch.from_numpy(1.5 * rng.standard_normal((1, k + 1, V))
                              .astype(np.float32))
    q = torch.softmax(torch.from_numpy(
        1.5 * rng.standard_normal((1, k, V)).astype(np.float32)), -1)
    gen = torch.Generator().manual_seed(3)
    draft = torch.multinomial(q[0], N, replacement=True,
                              generator=gen).T.to(torch.int32)  # (N, k)
    emitted, _ = tspec._accept_and_emit(
        logits.expand(N, k + 1, V), draft, q.expand(N, k, V), 7,
        np.ones(N, np.float32), np.zeros(N, np.int32))
    toks = emitted[:, 0].numpy()
    p = torch.softmax(logits[0, 0], -1).numpy()
    tv_spec = 0.5 * np.abs(np.bincount(toks, minlength=V)[:V] / N - p).sum()
    base = rng.choice(V, size=N, p=p / p.sum())
    tv_base = 0.5 * np.abs(np.bincount(base, minlength=V)[:V] / N - p).sum()
    assert tv_spec < max(3.0 * tv_base, 0.05), (tv_spec, tv_base)


@pytest.mark.parametrize("mode", MODES)
def test_sampled_spec_completes_with_sane_stats(model, mode):
    """Sampled speculative decode runs every request to its budget, is
    deterministic per seed (another seed draws otherwise), and counts
    proposals per active row."""

    def run(seed):
        _, teng = _pair(model, mode)
        uids = [teng.put([1 + i, 2, 3], max_new_tokens=9) for i in range(3)]
        res = teng.generate_all(temperature=0.7, seed=seed)
        return [res[u] for u in uids], teng.spec_stats()

    (a, s), (b, _), (c, _) = run(11), run(11), run(12)
    assert a == b and a != c
    assert all(len(r) == 3 + 9 for r in a)
    assert s["enabled"] == 1 and s["steps"] > 0
    assert s["steps"] * K <= s["proposed_tokens"] <= s["steps"] * 4 * K
    assert s["proposed_tokens"] % K == 0
    assert 0 <= s["accepted_tokens"] <= s["proposed_tokens"]
    assert s["emitted_tokens"] >= s["steps"]


# ---------------------------------------------------------------------------
# burst budget clamp (no speculation)
# ---------------------------------------------------------------------------


def test_burst_clamps_to_remaining_budget(model, plain):
    """A budget below the burst length still takes (clamped) bursts."""

    def scenario(eng):
        uid = eng.put([5, 6, 7], max_new_tokens=5)  # budget 5 < burst 8
        return eng.generate_all(burst=8)[uid]

    got, teng = _both(model, "off", scenario)
    assert got == [5, 6, 7] + plain([5, 6, 7], 5)
    assert teng.burst_steps >= 1


def test_burst_clamp_mixed_budgets_token_exact(model, plain):
    def scenario(eng):
        u1 = eng.put([5, 6, 7], max_new_tokens=21)
        u2 = eng.put([9, 8], max_new_tokens=6)
        res = eng.generate_all(burst=8)
        return res[u1], res[u2]

    (r1, r2), teng = _both(model, "off", scenario)
    assert r1 == [5, 6, 7] + plain([5, 6, 7], 21)
    assert r2 == [9, 8] + plain([9, 8], 6)
    assert teng.burst_steps >= 1
    _assert_no_block_leak(teng)


# ---------------------------------------------------------------------------
# self-draft heads: frozen-base training
# ---------------------------------------------------------------------------


def test_spec_head_training_updates_heads_only(model):
    _, _, tcfg, tparams, _ = model
    heads = init_spec_heads(torch.Generator().manual_seed(3), tcfg, k=2,
                            base_params=tparams)
    prompts = [[1 + i, 5, 9] for i in range(8)]
    data = greedy_rollouts(tparams, tcfg, prompts, n_new=8)
    assert data.shape == (8, 3 + 8)
    eng = te.InferenceEngineV2(tcfg, tparams, te.V2Config(**V2),
                               device="cpu")
    uid = eng.put(prompts[0], max_new_tokens=8)  # the engine's own decode
    assert data[0].tolist() == eng.generate_all()[uid]
    base_snap = [x.clone() for x in tree_leaves(tparams)]
    head_snap = {k0: v.clone() for k0, v in heads.items()}
    trained, losses = train_spec_heads(
        tparams, heads, tcfg, data, steps=25, lr=5e-3, batch_size=4,
        generator=torch.Generator().manual_seed(0))
    assert len(losses) == 25 and losses[-1] < losses[0]
    for snap, cur in zip(base_snap, tree_leaves(tparams)):
        assert torch.equal(snap, cur)  # the base, bit for bit
    assert all(torch.equal(heads[k0], head_snap[k0]) for k0 in heads)
    assert any(not torch.equal(trained[k0], head_snap[k0])
               for k0 in ("w1", "b1", "w2"))


def test_trainable_subtree_excludes_base(model):
    """Only head leaves reach the optimizer: frozen leaves are None and
    absent from the trainable tree's leaves."""
    _, _, tcfg, tparams, _ = model
    heads = init_spec_heads(torch.Generator().manual_seed(3), tcfg, k=2)
    full = {"base": tparams, "heads": heads}
    mask = {"base": jax.tree_util.tree_map(lambda _: False, tparams),
            "heads": {k0: True for k0 in heads}}
    leaves = tree_leaves(trainable_subtree(full, mask))
    assert len(leaves) == 3 and all(
        any(x is h for h in heads.values()) for x in leaves)


def test_spec_head_shapes_and_seeding(model):
    jcfg, jparams, tcfg, tparams, heads = model
    got = init_spec_heads(torch.Generator().manual_seed(1), tcfg, k=3,
                          base_params=tparams)
    H, V = tcfg.hidden_size, tcfg.vocab_size
    assert got["w1"].shape == (3, H, H) and got["b1"].shape == (3, H)
    assert got["w2"].shape == (3, H, V)
    assert all(v.dtype == torch.float32 for v in got.values())
    # w2 seeded from the (tied) lm head: untrained heads propose the base's
    # next-token distribution
    torch.testing.assert_close(got["w2"][0], tparams["embed"]["tokens"].T,
                               rtol=1e-6, atol=0)
    assert apply_spec_heads(got, torch.ones(2, H)).shape == (2, 3, V)
    with pytest.raises(ValueError):
        init_spec_heads(torch.Generator(), tcfg, k=0)
    # the head math is the reference's on the same heads and states
    h = np.random.default_rng(0).standard_normal((2, 5, H)).astype(
        np.float32)
    want = jsh.apply_spec_heads(heads[0], jnp.asarray(h))
    np.testing.assert_allclose(
        apply_spec_heads(heads[1], torch.from_numpy(h)).numpy(),
        np.asarray(want), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# config validation and the stats surface
# ---------------------------------------------------------------------------


def test_spec_config_validation(model):
    _, _, tcfg, tparams, _ = model
    for over, match in (({"spec_mode": "banana"}, "spec_mode"),
                        ({"spec_mode": "draft"}, "draft_params"),
                        ({"spec_mode": "self_draft", "spec_k": 0},
                         "spec_k")):
        with pytest.raises(ValueError, match=match):
            te.InferenceEngineV2(tcfg, tparams, te.V2Config(**{**V2, **over}),
                                 device="cpu")


def test_spec_stats_surface(model, plain):
    def scenario(eng):
        uid = eng.put([5, 6, 7], max_new_tokens=8)
        return eng.generate_all()[uid]

    got, teng = _both(model, "self_draft", scenario)
    assert got == [5, 6, 7] + plain([5, 6, 7], 8)
    s = teng.spec_stats()
    assert s["enabled"] == 1.0 and s["k"] == K and s["steps"] > 0
    assert s["acceptance_rate"] == s["accepted_tokens"] / s["proposed_tokens"]
    off = te.InferenceEngineV2(model[2], model[3], te.V2Config(**V2),
                               device="cpu").spec_stats()
    assert off["enabled"] == 0.0 and not any(off.values())
