"""Parity: the port's BERT-family encoder (``models/encoder.py``) and its
``EncoderInferenceEngine`` against the JAX package's, on the CPU in f32.
The reference's weights cross over through ``encoder.params_from_jax``;
the same numpy-seeded ids, padding mask and token types go through both:
hidden states, masked-LM logits, the pooler and the masked-LM loss agree
within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import engine as je
from deepspeed_tpu.models import encoder as jenc
from deepspeed_tpu_torch.inference import engine as te
from deepspeed_tpu_torch.models import encoder as tenc

from tests.torch_cpu import one_torch_thread  # noqa: F401

SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_layers=2, num_heads=4, max_seq_len=32, dtype="float32")
B, S = 3, 12
TOL = 1e-5


@pytest.fixture(scope="module")
def model():
    jcfg = jenc.EncoderConfig(**SMALL)
    tcfg = tenc.EncoderConfig(**SMALL)
    params = jenc.init_params(jax.random.PRNGKey(0), jcfg)
    # non-zero biases and norm shifts, so every operand is exercised
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(1)
    leaves = [np.asarray(x) + 0.02 * rng.standard_normal(x.shape).astype(
        np.float32) for x in leaves]
    params = jax.tree_util.tree_unflatten(tree, leaves)
    tparams = tenc.params_from_jax(params, tcfg, device="cpu")
    return jcfg, params, tcfg, tparams


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, SMALL["vocab_size"], (B, S))
    mask = np.ones((B, S), np.int32)
    mask[1, 7:] = 0  # padded rows: keys masked for every query
    mask[2, 3:] = 0
    types = (np.arange(S)[None, :] >= S // 2).astype(np.int64).repeat(B, 0)
    return ids, mask, types


@pytest.mark.parametrize("fn", ["encode", "mlm_logits", "pooled_output"])
def test_forward_matches_reference(model, batch, fn):
    jcfg, params, tcfg, tparams = model
    ids, mask, types = batch
    want = getattr(jenc, fn)(params, jnp.asarray(ids), jcfg,
                             attention_mask=jnp.asarray(mask),
                             token_type_ids=jnp.asarray(types))
    got = getattr(tenc, fn)(tparams, torch.as_tensor(ids), tcfg,
                            attention_mask=torch.as_tensor(mask),
                            token_type_ids=torch.as_tensor(types))
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want,
                               atol=TOL * np.abs(want).max(), rtol=0)


def test_mlm_loss_matches_reference(model, batch):
    jcfg, params, tcfg, tparams = model
    ids, mask, _ = batch
    labels = np.full((B, S), -100)
    labels[:, 2] = ids[:, 2]
    labels[0, 5] = ids[0, 5]
    jl, jm = jenc.mlm_loss_fn(params, {"input_ids": jnp.asarray(ids),
                                       "labels": jnp.asarray(labels),
                                       "attention_mask": jnp.asarray(mask)},
                              jcfg)
    tl, tm = tenc.mlm_loss_fn(tparams, {
        "input_ids": torch.as_tensor(ids), "labels": torch.as_tensor(labels),
        "attention_mask": torch.as_tensor(mask)}, tcfg)
    assert abs(float(tl) - float(jl)) <= TOL * abs(float(jl))
    assert float(tm["accuracy"]) == pytest.approx(float(jm["accuracy"]))
    assert float(tm["tokens"]) == float(jm["tokens"]) == 4.0


def test_engine_matches_reference_engine(model, batch):
    jcfg, params, tcfg, tparams = model
    ids, mask, types = batch
    jeng = je.EncoderInferenceEngine(jcfg, params, config={"dtype": "float32"})
    teng = te.EncoderInferenceEngine(tcfg, tparams,
                                     config={"dtype": "float32"},
                                     device="cpu")
    for fn in ("encode", "mlm_logits", "pooled"):
        want = getattr(jeng, fn)(ids, mask, types)
        got = getattr(teng, fn)(ids, mask, types)
        np.testing.assert_allclose(got, want,
                                   atol=TOL * np.abs(want).max(), rtol=0)
    bare = {k: v for k, v in tparams.items() if k not in ("mlm", "pooler")}
    beng = te.EncoderInferenceEngine(tcfg, bare, device="cpu")
    with pytest.raises(ValueError, match="MLM head"):
        beng.mlm_logits(ids)
    with pytest.raises(ValueError, match="pooler"):
        beng.pooled(ids)


def test_init_params_layout_matches_reference(model):
    jcfg, params, tcfg, _ = model
    tparams = tenc.init_params(tcfg, torch.Generator().manual_seed(0),
                               device="cpu")
    jshapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), params)
    tshapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), tparams)
    assert tshapes == jshapes
    assert all(x.dtype == torch.float32 for x in jax.tree_util.tree_leaves(
        tparams))
