"""Parity: the port's LLaMA-path model pieces
(``deepspeed_tpu_torch/models/transformer.py``) against the JAX package's,
on the same numpy-seeded inputs in f32, and the weight conversion
``params_from_jax``."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.linear.optimized_linear import LoRAWeight
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.moe.sharded_moe import sharded_moe_block

from tests.torch_cpu import one_torch_thread  # noqa: F401

ATOL = 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_presets_and_config_match_reference():
    assert tt.PRESETS == jt.PRESETS
    for name in tt.PRESETS:
        a, b = jt.get_config(name), tt.get_config(name)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert (a.kv_heads, a.head_dim, a.rot_dim, a.num_params()) == \
            (b.kv_heads, b.head_dim, b.rot_dim, b.num_params())
    cfg = tt.get_config("llama3-8b")
    assert (cfg.num_layers, cfg.num_heads, cfg.kv_heads, cfg.head_dim,
            cfg.tie_embeddings) == (32, 32, 8, 128, True)


@pytest.mark.parametrize("kind", ["rmsnorm", "gemma_rmsnorm", "layernorm"])
def test_norm_matches(kind):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    want = np.asarray(jt._norm(jnp.asarray(x), {k: jnp.asarray(v)
                                                for k, v in p.items()},
                               kind, 1e-5))
    got = tt._norm(torch.from_numpy(x),
                   {k: torch.from_numpy(v) for k, v in p.items()}, kind, 1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("rot_dim", [16, 8], ids=["full", "partial"])
def test_rope_matches(rot_dim):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    jc, js = jt.rope_table(7, rot_dim, 500000.0)
    tc, ts = tt.rope_table(7, rot_dim, 500000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    want = np.asarray(jt.apply_rope(jnp.asarray(x), jc, js))
    got = tt.apply_rope(torch.from_numpy(x), tc, ts)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # interleaved (even, odd) pairs rotate, not the half-split layout
    rotated = tt.apply_rope(torch.from_numpy(x), tc, ts).numpy()
    c, s = tc.numpy()[None, :, None, :], ts.numpy()[None, :, None, :]
    np.testing.assert_allclose(
        rotated[..., 0:rot_dim:2],
        x[..., 0:rot_dim:2] * c - x[..., 1:rot_dim:2] * s, atol=ATOL)


@pytest.mark.parametrize("overrides", [
    {}, {"embed_scale_by_sqrt_dim": True},
    {"position": "learned", "norm": "layernorm", "embed_norm": True}],
    ids=["plain", "sqrt_scale", "learned_pos_embed_norm"])
def test_embed_tokens_matches(overrides):
    jcfg = jt.get_config("tiny", dtype="float32", **overrides)
    tcfg = tt.get_config("tiny", dtype="float32", **overrides)
    params = jt.init_params(jax.random.PRNGKey(3), jcfg)
    tparams = tt.params_from_jax(_np_tree(params), tcfg, device="cpu")
    rng = np.random.default_rng(2)
    ids = rng.integers(0, jcfg.vocab_size, size=(2, 9)).astype(np.int32)
    pos = rng.integers(0, jcfg.max_seq_len, size=(2, 9)).astype(np.int32)
    want = np.asarray(jt.embed_tokens(params, jnp.asarray(ids), jcfg,
                                      position_ids=jnp.asarray(pos)))
    got = tt.embed_tokens(tparams, torch.from_numpy(ids).long(), tcfg,
                          position_ids=torch.from_numpy(pos).long())
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("activation", ["silu", "gelu", "gelu_exact", "relu"])
def test_mlp_block_matches(activation):
    jcfg = jt.get_config("tiny", dtype="float32", activation=activation)
    tcfg = tt.get_config("tiny", dtype="float32", activation=activation)
    params = jt.init_params(jax.random.PRNGKey(4), jcfg)
    jmlp = jax.tree_util.tree_map(lambda a: a[0], params["layers"]["mlp"])
    tmlp = tt.params_from_jax(_np_tree(jmlp), tcfg, device="cpu")
    x = np.random.default_rng(5).standard_normal((1, 6, 64)).astype(np.float32)
    want = np.asarray(jt._mlp_block(jnp.asarray(x), jmlp, jcfg))
    got = tt._mlp_block(torch.from_numpy(x), tmlp, tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("kv_heads", [None, 2], ids=["mha", "gqa"])
def test_params_from_jax_round_trip(kv_heads):
    jcfg = jt.get_config("tiny", num_kv_heads=kv_heads)
    tcfg = tt.get_config("tiny", num_kv_heads=kv_heads)
    params = _np_tree(jt.init_params(jax.random.PRNGKey(0), jcfg))
    tparams = tt.params_from_jax(params, tcfg, device="cpu",
                                 dtype=torch.float32)
    fj, ft = _flat(params), _flat(tparams)
    assert fj.keys() == ft.keys()
    for key in fj:
        assert ft[key].dtype == torch.float32
        np.testing.assert_array_equal(ft[key].numpy(), fj[key], err_msg=key)
    # the port's own init draws the same layout (other numbers: torch RNG)
    own = _flat(tt.init_params(tcfg, torch.Generator().manual_seed(0),
                               device="cpu", dtype=torch.float32))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in fj.items()}


def test_params_from_jax_bf16_bits_exact():
    cfg = tt.get_config("tiny")
    rng = np.random.default_rng(6)
    w = rng.standard_normal((4, 8)).astype(ml_dtypes.bfloat16)
    got = tt.params_from_jax({"w": w}, cfg, device="cpu")["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  w.view(np.int16))


def test_refusals(monkeypatch):
    cfg = tt.get_config("tiny")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tt.init_params(cfg, torch.Generator())  # default device is the card
    # MoE layers run on one device (tests/test_torch_moe.py); the
    # expert-parallel all-to-all waits for the multi-GPU item
    with pytest.raises(NotImplementedError, match="A13"):
        sharded_moe_block(torch.zeros(1, 2, 64), {}, tt.get_config(
            "tiny-moe"))
    # quantized weights are served (tests/test_torch_mixed_gemm.py), and
    # LoRA weights run (tests/test_torch_peft.py): base + scaling * x A B
    gen = torch.Generator().manual_seed(0)
    x, w = torch.randn(2, 4, generator=gen), torch.randn(4, 3, generator=gen)
    a, b = torch.randn(4, 2, generator=gen), torch.randn(2, 3, generator=gen)
    got = tt._lin(x, {"w": LoRAWeight(w, a, b, 0.5)}, "w", "b")
    torch.testing.assert_close(got, x @ w + 0.5 * (x @ a) @ b)
    with pytest.raises(TypeError, match="not a weight"):
        tt._lin(torch.zeros(2, 4), {"w": object()}, "w", "b")
