"""Parity in fp16: the port's serving paths against the JAX package's, both
in float16, on the reference's weights converted by ``params_from_jax``.

* The v2 engine on ``tiny`` (MHA and GQA), plain and at ``quantize_bits``
  8 and 4, and dropless MoE on ``tiny-moe``: greedy tokens identical for
  concurrent requests with chunked prefill and burst decode, up to a near
  tie (below); the first mixed step's logits within LOGITS_REL of their
  largest magnitude.
* The v1 engine (``init_inference``) on ``tiny``, plain and W8A16: greedy
  tokens identical, up to a near tie; the prefill's logits within
  LOGITS_REL.

A near tie: logits are f16, and the two sides round activations at other
places (XLA fuses elementwise chains and rounds once; torch rounds after
each op), so two tokens whose logits lie within a few f16 ulps can swap
places (MHA W8A16 here: 2.7402 / 2.7383 in the port, 2.7363 / 2.7422 in the
reference).  Where a request's tokens first differ, both sides' logits for
the next token after the common prefix are computed: they must agree
within LOGITS_REL, and each side's token must lie within TIE_ULPS f16 ulps
of the other side's best; the request's continuation is then not compared.
* Each kernel's plain version in f16 against the reference's function on
  the same inputs (its Pallas kernel in interpret mode; the grouped
  matmul's reference off the TPU is ``ragged_dot``): paged decode and
  prefill (B5, B4), the mixed GEMM on its kernel path (B6: x rounded to
  bf16 on both sides), W8A8 (B7), the grouped matmul (B8) and fused AdamW
  with f16 parameters (B9), each within its stated tolerance.
* ``check_card_coverage``: a model no paged-kernel instantiation covers is
  refused at engine construction on the card, naming its ROADMAP item.

The JAX side's Pallas kernels run in interpret mode on the CPU; the port's
wrappers run their plain versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import engine as jv1
from deepspeed_tpu.inference.v2 import engine as je
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.ops import fused_optimizers as jfo
from deepspeed_tpu.ops.pallas import grouped_matmul as jgm
from deepspeed_tpu.ops.pallas import mixed_gemm as jmg
from deepspeed_tpu.ops.pallas import paged_attention as jpa
from deepspeed_tpu_torch.inference import engine as tv1
from deepspeed_tpu_torch.inference.v2 import engine as te
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.ops import fused_optimizers as tfo
from deepspeed_tpu_torch.ops.hopper import grouped_matmul as tgm
from deepspeed_tpu_torch.ops.hopper import mixed_gemm as tmg
from deepspeed_tpu_torch.ops.hopper import paged_attention as tpa

from tests.torch_cpu import one_torch_thread  # noqa: F401

F16 = "float16"
# tests/test_torch_engine_v2.py's chunked-prefill V2Config, in f16: the
# longer prompts' prefill spans several SplitFuse steps
V2_KW = dict(max_tokens_per_step=16, max_seqs=4, block_size=8, num_blocks=64,
             max_blocks_per_seq=8, dtype=F16)
PROMPTS = [[1, 2, 3], list(range(9, 30)), [11, 12], list(range(40, 75))]
# the first mixed step's (and v1's prefill) logits, port against reference,
# both in f16: max |a - b| over max |b|.  Both sides round every activation
# to f16 (2**-11 of its size) but sum in other orders (XLA's dots against
# torch's), so an element may round one f16 ulp the other way in any layer;
# over tiny's two layers that stays within a few ulps of the logits' scale
LOGITS_REL = 1e-2
TIE_ULPS = 4  # a near tie: within 4 f16 ulps of the best logit
# kernels' plain versions against the reference in f16: one f16 ulp of an
# element (2**-10 of its size; 2e-3 where it lies just under a power of
# two), plus 1e-4 of the largest element for f32 sums in another order
F16_RTOL, F16_REL = 2e-3, 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f16_close(got, want, what, rel=F16_REL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    limit = rel * np.abs(want).max() + F16_RTOL * np.abs(want) + 2.0 ** -24
    assert (np.abs(got - want) <= limit).all(), (
        what, float(np.abs(got - want).max()))


def _logits_rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _same_up_to_near_ties(got, want, next_logits):
    """Per request: tokens identical, or identical up to a position where
    the two sides' next-token logits (``next_logits(prefix)`` -> (port,
    reference)) agree within LOGITS_REL and each side's pick lies within
    TIE_ULPS f16 ulps of the other side's best.  Returns the requests that
    met such a tie."""
    ties = 0
    for g, w in zip(got, want):
        i = next((k for k, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if i is None:
            assert len(g) == len(w)
            continue
        port, ref = (np.asarray(x, np.float32) for x in next_logits(w[:i]))
        assert _logits_rel(port, ref) <= LOGITS_REL
        ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 10)
        assert ref.max() - ref[g[i]] <= TIE_ULPS * ulp, (i, g[i], w[i])
        assert port.max() - port[w[i]] <= TIE_ULPS * ulp, (i, g[i], w[i])
        ties += 1
    return ties


# ---------------------------------------------------------------------------
# the v2 engine
# ---------------------------------------------------------------------------


def _pair(name, **kw):
    jcfg = jt.get_config(name, dtype=F16, **kw)
    params = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = tt.get_config(name, dtype=F16, **kw)
    # the reference's raw weights in their own dtype (f32): each engine
    # quantizes or casts them itself
    tparams = tt.params_from_jax(_np_tree(params), tcfg, device="cpu",
                                 dtype=tt.param_dtype(tcfg))
    return jcfg, params, tcfg, tparams


@pytest.fixture(scope="module", params=[None, 2], ids=["mha", "gqa"])
def tiny(request):
    return _pair("tiny", num_kv_heads=request.param)


@pytest.fixture(scope="module")
def tiny_moe():
    return _pair("tiny-moe", num_kv_heads=2, moe_routing="dropless")


def _v2_engines(pair, bits=0):
    jcfg, params, tcfg, tparams = pair
    kw = dict(V2_KW, quantize_bits=bits)
    return (je.InferenceEngineV2(jcfg, params, je.V2Config(**kw)),
            te.InferenceEngineV2(tcfg, tparams, te.V2Config(**kw),
                                 device="cpu"))


def _v2_step_logits(pair, bits, prompts):
    """Both engines' logits of their first mixed step over ``prompts``,
    computed on the same batch: (port, reference)."""
    jeng, teng = _v2_engines(pair, bits)
    for eng in (jeng, teng):
        for p in prompts:
            eng.put(p, max_new_tokens=6)
    teng._flush_table()
    batch = teng.builder.build(teng._schedule())
    got = te.ragged_forward(teng.params, teng.caches, batch, teng.model_cfg,
                            teng.cfg, teng.rope)
    fwd = je.build_ragged_forward(jeng.model_cfg, jeng.cfg)
    want, _, _ = fwd(jeng.params, jeng.caches, *map(jnp.asarray, (
        batch.token_ids, batch.position_ids, batch.seq_index,
        batch.block_tables, batch.context_lens, batch.logits_rows,
        batch.chunk_start, batch.chunk_len)))
    return got.float().numpy(), np.asarray(want, np.float32)


def _v2_tokens_and_logits(pair, bits=0):
    """Both engines serve PROMPTS together (burst 4): their tokens, and the
    first mixed step's logits of each, computed on the same batch."""
    logits, ref = _v2_step_logits(pair, bits, PROMPTS)
    jeng, teng = _v2_engines(pair, bits)
    ju = [jeng.put(p, max_new_tokens=6) for p in PROMPTS]
    tu = [teng.put(p, max_new_tokens=6) for p in PROMPTS]
    for mod in (tpa, tmg, tgm):
        mod.reset_counts()
    jr, tr = jeng.generate_all(burst=4), teng.generate_all(burst=4)
    assert teng.caches["k"].dtype == torch.float16
    assert teng.burst_steps == jeng.burst_steps > 0
    return [tr[u] for u in tu], [jr[u] for u in ju], logits, ref


def _v2_next_logits(pair, bits):
    """(port, reference) logits of the token after ``prefix``, the prefix
    prefilled alone."""
    def next_logits(prefix):
        port, ref = _v2_step_logits(pair, bits, [prefix])
        return port[0], ref[0]
    return next_logits


@pytest.mark.parametrize("bits", [0, 8, 4], ids=["plain", "w8a16", "w4a16"])
def test_v2_f16_tokens_and_logits_match_reference(tiny, bits):
    got, want, logits, ref = _v2_tokens_and_logits(tiny, bits)
    ties = _same_up_to_near_ties(got, want, _v2_next_logits(tiny, bits))
    assert ties <= 1  # one request at most: the rest are identical
    assert np.isfinite(logits).all()
    assert _logits_rel(logits, ref) <= LOGITS_REL
    assert tpa.PLAIN_CALLS["prefill_attention_plain"] > 0
    assert tpa.PLAIN_CALLS["decode_attention_plain"] > 0
    if bits:  # every projection on the mixed GEMM's kernel path
        assert tmg.PLAIN_CALLS["mixed_gemm_plain"] > 0
        assert tmg.DEQUANT_CALLS["mixed_gemm"] == 0


def test_v2_f16_dropless_moe_matches_reference(tiny_moe):
    got, want, logits, ref = _v2_tokens_and_logits(tiny_moe)
    assert _same_up_to_near_ties(got, want, _v2_next_logits(tiny_moe, 0)) \
        <= 1
    assert _logits_rel(logits, ref) <= LOGITS_REL
    assert tgm.PLAIN_CALLS["grouped_matmul_plain"] > 0


# ---------------------------------------------------------------------------
# the v1 engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [0, 8], ids=["plain", "w8a16"])
def test_v1_f16_tokens_and_logits_match_reference(bits):
    jcfg, params, tcfg, tparams = _pair("tiny", num_kv_heads=2)
    icfg = {"dtype": F16, "max_seq_len": 64, "quantize_bits": bits}
    jeng = jv1.InferenceEngine(model_config=jcfg, params=params,
                               config=dict(icfg))
    teng = tv1.InferenceEngine(model_config=tcfg, params=tparams,
                               config=dict(icfg), device="cpu")
    prompts = np.random.default_rng(3).integers(1, 256, (3, 11),
                                                dtype=np.int64)
    tmg.reset_counts()
    got = teng.generate(prompts, max_new_tokens=8)
    calls = tmg.PLAIN_CALLS["mixed_gemm_plain"]
    want = jeng.generate(prompts, max_new_tokens=8)

    def prefill_logits(rows):
        cache = jv1._kv_cache_init(jeng.model_config, rows.shape[0],
                                   rows.shape[1] + 4, jnp.float16)
        ref, _ = jeng._prefill(jeng.params, jnp.asarray(rows, jnp.int32),
                               cache, 0)
        return ref

    def next_logits(prefix):
        rows = np.asarray([prefix], np.int64)
        teng.generate(rows, max_new_tokens=1)
        return teng.first_logits[0].numpy(), prefill_logits(rows)[0]

    first = teng.first_logits.numpy()
    assert _logits_rel(first, prefill_logits(prompts)) <= LOGITS_REL
    assert _same_up_to_near_ties(got.tolist(), want.tolist(),
                                 next_logits) <= 1
    if bits:
        assert calls == 7 * tcfg.num_layers * 8


# ---------------------------------------------------------------------------
# the kernels' plain versions in f16 against the reference's
# ---------------------------------------------------------------------------


def _f16(rng, *shape):
    return rng.standard_normal(shape).astype(np.float16)


def _paged(rng, S, H, KV, D, BS, NB, MB):
    k, v = _f16(rng, NB, BS, KV, D), _f16(rng, NB, BS, KV, D)
    bt = rng.permutation(NB)[: S * MB].reshape(S, MB).astype(np.int32)
    return k, v, bt


@pytest.mark.parametrize("H,KV", [(4, 4), (4, 1)], ids=["mha", "gqa4"])
def test_paged_decode_and_prefill_plain_match_pallas_f16(H, KV):
    """B5 and B4's plain versions in f16 against the Pallas kernels in
    interpret mode: f32 inside on both sides, one f16 rounding of the
    output (F16_RTOL, F16_REL); ctx = 0 and padding rows exactly zero."""
    rng = np.random.default_rng(5)
    S, D, BS, NB, MB = 5, 16, 8, 32, 4
    k, v, bt = _paged(rng, S, H, KV, D, BS, NB, MB)
    q = _f16(rng, S, H, D)
    ctx = np.array([5, 0, 17, 32, 1], np.int32)
    want = jpa.paged_decode_attention(*map(jnp.asarray, (q, k, v, bt, ctx)))
    got = tpa.paged_decode_attention(*map(torch.from_numpy,
                                          (q, k, v, bt, ctx)))
    assert got.dtype == torch.float16 and want.dtype == jnp.float16
    _f16_close(got.float(), want, "decode")
    assert not got[1].any()
    q = _f16(rng, 4, 24, H, D)
    start = np.array([0, 5, 13, 3], np.int32)
    length = np.array([24, 11, 0, 20], np.int32)
    args = (q, k, v, bt[:4], start, length)
    want = jpa.paged_prefill_attention(*map(jnp.asarray, args))
    got = tpa.paged_prefill_attention(*map(torch.from_numpy, args))
    _f16_close(got.float(), want, "prefill")
    for s, n in enumerate(length):
        assert not got[s, n:].any()


@pytest.mark.parametrize("bits", [8, 4, 6])
@pytest.mark.parametrize("M", [8, 64])
def test_mixed_gemm_plain_matches_pallas_kernel_f16(bits, M):
    """B6 in f16 on the reference's kernel path (its ``_gemm_pallas``, not
    the dequantize fallback): both round x and the dequantized weight to
    bf16, sum the exact products in f32 and write f16 (F16_RTOL, and 1e-4
    of the largest output for the order of the sums)."""
    rng = np.random.default_rng(bits * 100 + M)
    K, N = 512, 256
    x = _f16(rng, M, K)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    jw = jmg.quantize_gemm_weight(jnp.asarray(w), bits=bits, group=256)
    tw = tmg.quantize_gemm_weight(torch.from_numpy(w), bits=bits, group=256)
    assert tmg.mixed_gemm_on_kernel_path(tw)
    tmg.reset_counts()
    got = tmg.mixed_gemm(torch.from_numpy(x), tw)
    assert tmg.PLAIN_CALLS["mixed_gemm_plain"] == 1
    want = jmg.mixed_gemm(jnp.asarray(x), jw)
    assert got.dtype == torch.float16 and want.dtype == jnp.float16
    _f16_close(got.float(), want, f"mixed_gemm bits={bits} M={M}")
    # x is rounded to bf16 first: not the f16 product
    exact = x.astype(np.float32) @ np.asarray(jmg.dequantize_gemm_weight(jw))
    assert np.abs(got.float().numpy() - exact).max() > 0


@pytest.mark.parametrize("M", [8, 64])
def test_int8_gemm_plain_matches_pallas_kernel_f16(M):
    """B7 with f16 activations and output: the same int8 codes and scales
    on both sides (quantization bit-exact), the same group sums, f32
    rescales and one f16 rounding.  XLA may round an f32 rescale in the
    last bit otherwise than the plain version (the f32 parity test allows
    1e-6), which moves an output element to its neighbouring f16 (6 of
    16384 at M = 64): within one f16 ulp.  On the card the kernel is held
    to the plain version bit for bit."""
    rng = np.random.default_rng(M)
    K, N = 512, 256
    x = _f16(rng, M, K)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    jw = jmg.quantize_gemm_weight(jnp.asarray(w), bits=8, group=256)
    tw = tmg.quantize_gemm_weight(torch.from_numpy(w), bits=8, group=256)
    assert tmg.int8_gemm_on_kernel_path(tw)
    got = tmg.int8_gemm(torch.from_numpy(x), tw)
    want = jmg.int8_gemm(jnp.asarray(x), jw)
    assert got.dtype == torch.float16 and want.dtype == jnp.float16
    _f16_close(got.float(), want, f"int8_gemm M={M}", rel=0.0)


def test_grouped_matmul_plain_matches_reference_f16():
    """B8 in f16: exact f16 products summed in f32, one f16 rounding, on
    both sides (the reference off the TPU is ``ragged_dot``)."""
    rng = np.random.default_rng(8)
    E, K, N, T, tile_m = 4, 96, 80, 37, 16
    ef = rng.integers(0, E, T)
    jlay = jgm.tile_aligned_layout(jnp.asarray(ef), E, T, tile_m)
    tlay = tgm.tile_aligned_layout(torch.from_numpy(ef), E, T, tile_m)
    pos, tgroup, sizes, M_pad = (np.array(a) for a in jlay)
    assert np.array_equal(tlay[0].numpy(), pos)
    lhs = np.zeros((M_pad, K), np.float16)
    lhs[pos] = _f16(rng, T, K)
    rhs = (rng.standard_normal((E, K, N)) / np.sqrt(K)).astype(np.float16)
    want = jgm.grouped_matmul(jnp.asarray(lhs), jnp.asarray(rhs),
                              jnp.asarray(tgroup), jnp.asarray(sizes),
                              tile_m=tile_m)
    got = tgm.grouped_matmul(torch.from_numpy(lhs), torch.from_numpy(rhs),
                             torch.from_numpy(tgroup), torch.from_numpy(sizes),
                             tile_m=tile_m)
    assert got.dtype == torch.float16 and want.dtype == jnp.float16
    _f16_close(got.float(), want, "grouped_matmul")


def test_fused_adamw_plain_matches_pallas_f16():
    """B9 with f16 parameters: every operation in f32 on both sides (p and
    g read as f32), p written in f16 (F16_RTOL: an f32 p' one ulp apart may
    round to the other f16 neighbour), m and v in f32 within 1e-6 of their
    largest element (``b ** step`` may differ in the last bit)."""
    rng = np.random.default_rng(9)
    n = 4099
    p = _f16(rng, n)
    m = np.zeros(n, np.float32)
    v = np.zeros(n, np.float32)
    hyper = dict(lr=1e-2, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.1)
    jp, jm_, jv_ = jnp.asarray(p), jnp.asarray(m), jnp.asarray(v)
    tp, tm_, tv_ = (torch.from_numpy(a) for a in (p, m, v))
    for step in (1, 2):
        g = _f16(rng, n)
        jp, jm_, jv_ = jfo.fused_adamw_flat(
            jp, jnp.asarray(g), jm_, jv_, jnp.asarray(step, jnp.int32),
            **hyper, block=1024)
        tp, tm_, tv_ = tfo.fused_adamw_flat(
            tp, torch.from_numpy(g), tm_, tv_, step, **hyper)
    assert tp.dtype == torch.float16 and jp.dtype == jnp.float16
    _f16_close(tp.float(), jp, "p", rel=0.0)
    for got, want in ((tm_, jm_), (tv_, jv_)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


# ---------------------------------------------------------------------------
# what no f16 instantiation covers: refused at construction on the card
# ---------------------------------------------------------------------------


def test_card_coverage_refusal_names_its_item():
    cfg = tt.get_config("tiny", dtype=F16)  # head dim 16: no instantiation
    with pytest.raises(NotImplementedError,
                       match=r"ROADMAP\.md queue B, coverage") as e:
        te.check_card_coverage(cfg, F16)
    assert "head dim 16" in str(e.value) and "float16" in str(e.value)
    wide = dataclasses.replace(cfg, hidden_size=256, intermediate_size=512,
                               num_heads=4, num_kv_heads=2)
    for dtype in ("float16", "bfloat16", "float32"):
        te.check_card_coverage(wide, dtype)  # head dim 64, GQA: covered
    with pytest.raises(NotImplementedError, match="queue B"):
        te.check_card_coverage(dataclasses.replace(
            wide, num_heads=32, num_kv_heads=2), F16)  # 16 heads a kv head
    # the CPU path takes any head dim
    tparams = tt.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    te.InferenceEngineV2(cfg, tparams, te.V2Config(**V2_KW), device="cpu")
