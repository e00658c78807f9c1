"""Parity: the port's quantized serving (``V2Config(quantize_bits=8 | 4 |
6)``, W8A16 / W4A16 / W6A16) against the JAX package's, on ``tiny`` in f32
with MHA and GQA.  Both engines quantize the same raw weights; greedy tokens
must be identical for one request, for concurrent requests with chunked
prefill and in burst decode, and the first mixed step's logits agree to
1e-4.  The JAX side runs its Pallas mixed GEMM in interpret mode on the CPU;
the port runs the kernel's plain version, and every projection of the tiny
model lies on the reference's kernel path, so no call takes the dequantize
formula."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepspeed_tpu.inference.v2 import engine as je
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.inference.v2 import engine as te
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.ops.hopper import mixed_gemm as tmg

from tests.torch_cpu import one_torch_thread  # noqa: F401

# the V2Config of tests/test_torch_engine_v2.py
V2_KW = dict(max_tokens_per_step=32, max_seqs=4, block_size=8, num_blocks=64,
             max_blocks_per_seq=8, dtype="float32")
SPLIT_KW = dict(V2_KW, max_tokens_per_step=16)
PROJECTIONS = 7  # wq, wk, wv, wo, w_gate, w_in, w_out per layer


@pytest.fixture(scope="module", params=[None, 2], ids=["mha", "gqa"])
def model(request):
    kv = request.param
    jcfg = jt.get_config("tiny", dtype="float32", num_kv_heads=kv)
    params = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = tt.get_config("tiny", dtype="float32", num_kv_heads=kv)
    tparams = tt.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                 tcfg, device="cpu")
    return jcfg, params, tcfg, tparams


def _engines(model, v2_kw, bits):
    jcfg, params, tcfg, tparams = model
    kw = dict(v2_kw, quantize_bits=bits)
    return (je.InferenceEngineV2(jcfg, params, je.V2Config(**kw)),
            te.InferenceEngineV2(tcfg, tparams, te.V2Config(**kw),
                                 device="cpu"))


def _serve_both(model, v2_kw, bits, prompts, max_new, **gen_kw):
    jeng, teng = _engines(model, v2_kw, bits)
    ju = [jeng.put(p, max_new_tokens=max_new) for p in prompts]
    tu = [teng.put(p, max_new_tokens=max_new) for p in prompts]
    jr = jeng.generate_all(**gen_kw)
    tmg.reset_counts()
    tr = teng.generate_all(**gen_kw)
    return [jr[u] for u in ju], [tr[u] for u in tu], jeng, teng


@pytest.mark.parametrize("bits", [8, 4, 6])
def test_single_request_greedy_identical(model, bits):
    want, got, _, teng = _serve_both(model, V2_KW, bits, [[5, 6, 7, 8]], 6)
    assert got == want
    assert len(got[0]) == 4 + 6
    assert teng.free_blocks == teng.total_blocks


@pytest.mark.parametrize("bits", [8, 4, 6])
def test_concurrent_chunked_prefill_identical(model, bits):
    prompts = [[1, 2, 3], list(range(9, 30)), [11, 12], list(range(40, 75))]
    want, got, jeng, teng = _serve_both(model, SPLIT_KW, bits, prompts, 5,
                                        burst=4)
    assert got == want
    assert teng.burst_steps == jeng.burst_steps > 0
    assert teng.fast_steps == jeng.fast_steps
    # every projection went through the mixed GEMM's plain version, none
    # through the reference's dequantize formula
    assert tmg.DEQUANT_CALLS == {"mixed_gemm": 0, "int8_gemm": 0}
    assert tmg.PLAIN_CALLS["mixed_gemm_plain"] > 0


@pytest.mark.parametrize("bits", [8, 4, 6])
def test_burst_matches_single_step(model, bits):
    prompts = [[3, 1, 4, 1, 5], list(range(20, 41))]
    want, got4, _, _ = _serve_both(model, SPLIT_KW, bits, prompts, 7,
                                   burst=4)
    # single-step decode on the port alone: the reference's tokens are
    # want, whatever its burst
    teng1 = _engines(model, SPLIT_KW, bits)[1]
    uids = [teng1.put(p, max_new_tokens=7) for p in prompts]
    res = teng1.generate_all(burst=1)
    got1 = [res[u] for u in uids]
    assert got4 == want and got1 == want
    assert teng1.burst_steps == 0 and teng1.fast_steps > 0


@pytest.mark.parametrize("bits", [8, 4, 6])
def test_first_mixed_step_logits(model, bits):
    """One mixed step: logits within 1e-4 of the reference's, and 7 mixed
    GEMMs per layer."""
    jeng, teng = _engines(model, SPLIT_KW, bits)
    prompts = [list(range(1, 12)), [7, 8], list(range(30, 50))]
    for eng in (jeng, teng):
        for p in prompts:
            eng.put(p, max_new_tokens=3)
    teng._flush_table()
    batch = teng.builder.build(teng._schedule())
    tmg.reset_counts()
    got = te.ragged_forward(teng.params, teng.caches, batch, teng.model_cfg,
                            teng.cfg, teng.rope)
    assert tmg.PLAIN_CALLS["mixed_gemm_plain"] == \
        PROJECTIONS * teng.model_cfg.num_layers
    assert tmg.DEQUANT_CALLS["mixed_gemm"] == 0
    fwd = je.build_ragged_forward(jeng.model_cfg, jeng.cfg)
    want, _, _ = fwd(jeng.params, jeng.caches, *map(jnp.asarray, (
        batch.token_ids, batch.position_ids, batch.seq_index,
        batch.block_tables, batch.context_lens, batch.logits_rows,
        batch.chunk_start, batch.chunk_len)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("bits", [8, 4, 6])
def test_engine_codes_match_reference(model, bits):
    """The engine quantizes the raw weights (f32 here) before any cast:
    its codes and scales are the reference engine's, bit for bit."""
    jeng, teng = _engines(model, V2_KW, bits)
    for part, keys in (("attn", ("wq", "wk", "wv", "wo")),
                       ("mlp", ("w_gate", "w_in", "w_out"))):
        for key in keys:
            jq = jeng.params["layers"][part][key]
            tq = teng.params["layers"][part][key]
            assert isinstance(tq, tmg.QuantizedWeight)
            assert (tq.bits, tq.group, tq.k) == (jq.bits, jq.group, jq.k)
            np.testing.assert_array_equal(tq.codes.numpy(),
                                          np.asarray(jq.codes))
            np.testing.assert_array_equal(tq.scales.numpy(),
                                          np.asarray(jq.scales))
    # the embedding, norms and lm_head stay in the compute dtype
    assert not isinstance(teng.params["embed"]["tokens"], tmg.QuantizedWeight)


def test_quantize_bits_outside_4_6_8_refused(model):
    """The reference's quantize_gemm_weight refuses other widths
    (``mixed_gemm.py:88``); so does the port's engine."""
    _, _, tcfg, tparams = model
    with pytest.raises(ValueError, match="4, 6 or 8"):
        te.InferenceEngineV2(tcfg, tparams,
                             te.V2Config(**V2_KW, quantize_bits=5),
                             device="cpu")
