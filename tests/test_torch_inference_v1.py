"""Parity: the port's v1 engine (``inference/engine.py``) and
``init_inference`` against the JAX package's, on the CPU in f32.  The same
numpy-seeded prompts go through both engines with the reference's weights
converted by ``params_from_jax``: greedy tokens must be identical (rope,
bloom-shaped ALiBi, W8A16, MoE in capacity and dropless routing, with an
end-of-sequence token) and the prefill's last-position logits agree to
1e-5.  The JAX side runs its Pallas kernels in interpret mode; the port
runs the kernels' plain versions (counted)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.inference import engine as je
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.inference import engine as te
from deepspeed_tpu_torch.models import encoder as tenc
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.ops.hopper import grouped_matmul as tgm
from deepspeed_tpu_torch.ops.hopper import mixed_gemm as tmg

from tests.torch_cpu import one_torch_thread  # noqa: F401

ICFG = {"dtype": "float32", "max_seq_len": 64}
PROJECTIONS = 7  # wq, wk, wv, wo, w_gate, w_in, w_out per layer
# bigscience/bloom-7b1's architecture (config.json: layernorm, GELU,
# embedding layernorm, tied embeddings, ALiBi) at the tiny width
BLOOM_KW = dict(vocab_size=256, hidden_size=64, intermediate_size=256,
                num_layers=2, num_heads=4, max_seq_len=128, norm="layernorm",
                activation="gelu", position="alibi", embed_norm=True,
                tie_embeddings=True)


def _prompts(vocab, b=2, t=9, seed=0):
    return np.random.default_rng(seed).integers(1, vocab, (b, t),
                                                dtype=np.int64)


def _pair(name=None, **kw):
    """(jax cfg, jax params, port cfg, port params) on the same weights."""
    if name is None:
        jcfg = jt.TransformerConfig(dtype="float32", **kw)
        tcfg = tt.TransformerConfig(dtype="float32", **kw)
    else:
        jcfg = jt.get_config(name, dtype="float32", **kw)
        tcfg = tt.get_config(name, dtype="float32", **kw)
    params = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = tt.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                 tcfg, device="cpu")
    return jcfg, params, tcfg, tparams


def _engines(pair, icfg=ICFG):
    jcfg, params, tcfg, tparams = pair
    return (je.InferenceEngine(model_config=jcfg, params=params,
                               config=dict(icfg)),
            te.InferenceEngine(model_config=tcfg, params=tparams,
                               config=dict(icfg), device="cpu"))


def _jax_prefill_logits(jeng, prompts):
    cache = je._kv_cache_init(jeng.model_config, prompts.shape[0],
                              prompts.shape[1] + 4, np.float32)
    logits, _ = jeng._prefill(jeng.params, jax.numpy.asarray(
        prompts, jax.numpy.int32), cache, 0)
    return np.asarray(logits)


@pytest.fixture(scope="module")
def tiny():
    return _pair("tiny", num_kv_heads=2)


@pytest.mark.parametrize("arch", ["rope", "alibi"])
def test_greedy_tokens_and_logits_identical(tiny, arch):
    pair = tiny if arch == "rope" else _pair(**BLOOM_KW)
    jeng, teng = _engines(pair)
    prompts = _prompts(pair[2].vocab_size)
    want = jeng.generate(prompts, max_new_tokens=8)
    got = teng.generate(prompts, max_new_tokens=8)
    assert got.dtype == np.int32 and got.shape == (2, 17)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(teng.first_logits.numpy(),
                               _jax_prefill_logits(jeng, prompts),
                               atol=1e-5, rtol=0)


def test_quantized_tokens_identical_on_the_mixed_gemm(tiny):
    icfg = dict(ICFG, quantize_bits=8)
    jeng, teng = _engines(tiny, icfg)
    prompts = _prompts(256, seed=1)
    want = jeng.generate(prompts, max_new_tokens=6)
    tmg.reset_counts()
    got = teng.generate(prompts, max_new_tokens=6)
    np.testing.assert_array_equal(got, want)
    # every projection of every layer, once per forward (prefill + 5)
    assert tmg.PLAIN_CALLS["mixed_gemm_plain"] == \
        PROJECTIONS * tiny[2].num_layers * 6
    assert tmg.DEQUANT_CALLS["mixed_gemm"] == 0


@pytest.mark.parametrize("routing", ["capacity", "dropless"])
def test_moe_tokens_identical(routing):
    pair = _pair("tiny-moe", moe_routing=routing)
    jeng, teng = _engines(pair)
    prompts = _prompts(256, seed=2)
    want = jeng.generate(prompts, max_new_tokens=5)
    tgm.reset_counts()
    got = teng.generate(prompts, max_new_tokens=5)
    np.testing.assert_array_equal(got, want)
    # dropless: three grouped GEMMs per layer and forward
    assert tgm.PLAIN_CALLS["grouped_matmul_plain"] == (
        3 * pair[2].num_layers * 5 if routing == "dropless" else 0)


def test_eos_token_stops_and_pads(tiny):
    jeng, teng = _engines(tiny)
    prompts = _prompts(256, seed=3)
    free = teng.generate(prompts, max_new_tokens=8)
    eos = int(free[0, prompts.shape[1] + 2])  # row 0's third new token
    want = jeng.generate(prompts, max_new_tokens=8, eos_token_id=eos)
    got = teng.generate(prompts, max_new_tokens=8, eos_token_id=eos)
    np.testing.assert_array_equal(got, want)
    row0 = got[0, prompts.shape[1]:]
    assert (row0[list(row0).index(eos):] == eos).all()


def test_sampling_is_seeded(tiny):
    _, teng = _engines(tiny)
    prompts = _prompts(256, seed=4)
    a = teng.generate(prompts, max_new_tokens=6, temperature=1.0, seed=7)
    b = teng.generate(prompts, max_new_tokens=6, temperature=1.0, seed=7)
    np.testing.assert_array_equal(a, b)
    assert ((a >= 0) & (a < 256)).all()


def test_init_inference_dispatch_and_errors(tiny):
    _, _, tcfg, tparams = tiny
    eng = deepspeed_tpu_torch.init_inference(
        model_config=tcfg, params=tparams, config=ICFG, device="cpu")
    assert isinstance(eng, te.InferenceEngine)
    assert eng.model_config.dtype == "float32"
    # a tensor already on the device is shared, not copied
    assert eng.params["embed"]["tokens"] is tparams["embed"]["tokens"]
    ecfg = tenc.EncoderConfig(vocab_size=64, hidden_size=32,
                              intermediate_size=64, num_layers=1,
                              num_heads=2, max_seq_len=16)
    eparams = tenc.init_params(ecfg, torch.Generator().manual_seed(0),
                               device="cpu")
    enc = deepspeed_tpu_torch.init_inference(
        model_config=ecfg, params=eparams, config={"dtype": "float32"},
        device="cpu")
    assert isinstance(enc, te.EncoderInferenceEngine)
    assert enc.encode(np.ones((1, 4), np.int64)).shape == (1, 4, 32)
    with pytest.raises(ValueError, match="params"):
        deepspeed_tpu_torch.init_inference(model_config=ecfg, device="cpu")
    with pytest.raises(ValueError, match="model_config"):
        deepspeed_tpu_torch.init_inference(params=tparams, device="cpu")
    with pytest.raises(NotImplementedError, match="A13"):
        deepspeed_tpu_torch.init_inference(
            model_config=tcfg, params=tparams, device="cpu",
            config=dict(ICFG, tensor_parallel_size=2))
    with pytest.raises(ValueError, match="expert_choice"):
        deepspeed_tpu_torch.init_inference(
            model_config=dataclasses.replace(tcfg, num_experts=4,
                                             moe_routing="expert_choice"),
            params=tparams, config=ICFG, device="cpu")


def test_card_by_default(tiny):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is the card")
    _, _, tcfg, tparams = tiny
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.init_inference(model_config=tcfg,
                                           params=tparams, config=ICFG)
