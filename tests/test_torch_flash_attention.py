"""Parity: the port's flash attention
(``deepspeed_tpu_torch.ops.hopper.flash_attention``) against the JAX
package's Pallas kernels, run in interpret mode on the CPU as the JAX
package's own tests run them.

The same numpy-seeded f32 inputs go through both packages: the output, and
dq/dk/dv by autograd against ``jax.grad``, must agree within the limits of
``tests/test_flash_attention.py`` (2e-5 forward, 5e-4 gradients).  On CPU
tensors the port runs its plain versions, including the backward's
recompute formulas; the CUDA kernels are held against those plain versions
on a GPU by ``tests/test_torch_gpu.py``."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import flash_attention as jfa
from deepspeed_tpu_torch.ops.hopper import flash_attention as tfa

from tests.torch_cpu import one_torch_thread  # noqa: F401

FWD_TOL = 2e-5  # atol and rtol, f32 both sides
GRAD_TOL = 5e-4

# (B, S, H, KV, D, kwargs): every mask option, GQA, and an S that is not a
# multiple of the block (the reference falls back to its einsum path there;
# the port's kernels mask the ragged edge themselves)
SEG = np.repeat(np.arange(4), [10, 30, 8, 16])[None].astype(np.int32)
CASES = {
    "causal": (2, 64, 4, 4, 16, dict(causal=True)),
    "full": (1, 64, 4, 4, 16, dict(causal=False)),
    "gqa": (1, 64, 8, 2, 16, dict(causal=True)),
    "window": (1, 64, 4, 2, 16, dict(causal=True, window=20)),
    "segments": (1, 64, 4, 2, 16, dict(causal=True, segment_ids=SEG)),
    "block_mask": (1, 64, 4, 1, 16, dict(
        causal=False, block_mask=np.array([[1, 0], [1, 1]], np.int32))),
    "ragged": (2, 50, 4, 2, 16, dict(causal=True)),
}


def _inputs(seed, B, S, H, KV, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    g = rng.standard_normal((B, S, H, D)).astype(np.float32)
    return q, k, v, g


def _conv(kw, fn):
    return {k: fn(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_and_grads_match_pallas(case):
    B, S, H, KV, D, kw = CASES[case]
    kw = dict(kw, block_q=32, block_k=32)
    q, k, v, g = _inputs(0, B, S, H, KV, D)
    jkw = _conv(kw, jnp.asarray)

    def loss(q, k, v):
        return (jfa.flash_attention(q, k, v, **jkw) * g).sum()

    want = np.asarray(jfa.flash_attention(*map(jnp.asarray, (q, k, v)),
                                          **jkw))
    want_g = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))

    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tfa.reset_counts()
    got = tfa.flash_attention(*leaves, **_conv(kw, torch.from_numpy))
    (got * torch.from_numpy(g)).sum().backward()
    assert tfa.PLAIN_CALLS == {"flash_fwd_plain": 1,
                               "flash_bwd_dkdv_plain": 1,
                               "flash_bwd_dq_plain": 1}
    assert not any(tfa.LAUNCHES.values())
    np.testing.assert_allclose(got.detach().numpy(), want, atol=FWD_TOL,
                               rtol=FWD_TOL)
    for t, w, name in zip(leaves, want_g, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("window", [0, 24])
def test_fwd_o_and_lse_match_flash_fwd_with_a_fully_masked_row(window):
    """(o, lse) against the reference's ``_flash_fwd``; the block mask's
    zero row leaves rows 16..31 with no kept key: o = 0, lse = -inf."""
    B, S, H, KV, D = 1, 64, 4, 2, 16
    q, k, v, _ = _inputs(1, B, S, H, KV, D)
    bm = np.array([[1, 0, 0, 0], [0, 0, 0, 0], [1, 1, 1, 0], [0, 1, 1, 1]],
                  np.int32)
    scale = 1.0 / math.sqrt(D)
    t = [jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v)]
    jo, jlse = jfa._flash_fwd(*t, None, None, jnp.asarray(bm), scale, True,
                              16, 16, window)
    jo = np.asarray(jo).transpose(0, 2, 1, 3)
    jlse = np.asarray(jlse)[..., 0]
    mask = tfa.AttnMask(True, window, None, torch.from_numpy(bm), 16, 16)
    o, lse = tfa.flash_fwd(*map(torch.from_numpy, (q, k, v)), mask, scale)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), jo, atol=FWD_TOL, rtol=FWD_TOL)
    assert np.array_equal(np.isinf(lse.numpy()), np.isinf(jlse))
    assert np.isinf(jlse[:, :, 16:32]).all() and not o[:, 16:32].any()
    fin = np.isfinite(jlse)
    np.testing.assert_allclose(lse.numpy()[fin], jlse[fin], atol=FWD_TOL,
                               rtol=FWD_TOL)


def test_backward_plain_versions_skip_fully_masked_rows():
    """With lse = -inf rows (no kept key) the recompute never produces
    inf or NaN, and those rows contribute nothing to dq/dk/dv."""
    B, S, H, KV, D = 1, 32, 2, 1, 16
    q, k, v, g = map(torch.from_numpy, _inputs(2, B, S, H, KV, D))
    bm = torch.tensor([[1, 1], [0, 0]], dtype=torch.int32)
    mask = tfa.AttnMask(False, 0, None, bm, 16, 16)
    o, lse = tfa.flash_fwd(q, k, v, mask, 0.25)
    delta = tfa.attention_delta(g, o)
    dk, dv = tfa.flash_bwd_dkdv(q, k, v, g, lse, delta, mask, 0.25)
    dq = tfa.flash_bwd_dq(q, k, v, g, lse, delta, mask, 0.25)
    for t in (dq, dk, dv):
        assert torch.isfinite(t).all()
    assert not dq[:, 16:].any()
    # dropping the masked rows' upstream gradient changes nothing
    g2 = g.clone()
    g2[:, 16:] = 0
    dk2, dv2 = tfa.flash_bwd_dkdv(q, k, v, g2, lse, tfa.attention_delta(
        g2, o), mask, 0.25)
    torch.testing.assert_close(dk, dk2, atol=0, rtol=0)
    torch.testing.assert_close(dv, dv2, atol=0, rtol=0)


def test_checkpoint_recompute_gives_the_same_gradients():
    q, k, v, g = _inputs(3, 1, 40, 4, 2, 16)
    grads = []
    for remat in (False, True):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        if remat:
            out = torch.utils.checkpoint.checkpoint(
                tfa.flash_attention, *leaves, use_reentrant=False)
        else:
            out = tfa.flash_attention(*leaves)
        (out * torch.from_numpy(g)).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_wrapper_refuses_what_the_kernels_do_not_take():
    q = torch.zeros((1, 8, 4, 64), dtype=torch.float64)
    kv = torch.zeros((1, 8, 2, 64), dtype=torch.float64)
    mask = tfa.AttnMask()
    with pytest.raises(TypeError, match="bfloat16, float16 or float32"):
        tfa._check(q, kv, kv, mask)
    assert tfa._check(q.half(), kv.half(), kv.half(), mask)[-2] == 64
    with pytest.raises(TypeError, match="float16 or float32 for a "
                       "torch.float16 forward"):
        tfa._check_bias(q.half(), torch.zeros((1, 8), dtype=torch.float64),
                        None, 1, 8, 8, 4)
    q, kv = q.float(), kv.float()
    with pytest.raises(ValueError, match="head dim"):
        tfa._check(q[..., :48], kv[..., :48], kv[..., :48], mask)
    with pytest.raises(ValueError, match="multiple of KV"):
        tfa._check(q[:, :, :3], kv, kv, mask)
    with pytest.raises(ValueError, match="contiguous"):
        tfa._check(q.transpose(1, 2).contiguous().transpose(1, 2), kv, kv,
                   mask)
    with pytest.raises(TypeError, match="int32"):
        tfa._check(q, kv, kv, mask._replace(
            segment_ids=torch.zeros((1, 8), dtype=torch.int64)))
    with pytest.raises(ValueError, match="block_mask shape"):
        tfa._check(q, kv, kv, mask._replace(
            block_mask=torch.ones((2, 2), dtype=torch.int32), block_q=8,
            block_k=8))
    assert tfa._check(q, kv, kv, mask) == (1, 8, 8, 4, 2, 64, 0)
    b2 = torch.zeros((2, 4, 8, 8))  # the biases: B' must divide B = 1
    with pytest.raises(ValueError, match="bias_qk must be"):
        tfa._check_bias(q, None, b2, 1, 8, 8, 4)
    with pytest.raises(ValueError, match="bias_kv must be"):
        tfa._check_bias(q, torch.zeros((1, 7)), None, 1, 8, 8, 4)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        tfa._check_bias(q, torch.zeros((1, 8), dtype=torch.float16), None,
                        1, 8, 8, 4)
    with pytest.raises(ValueError, match="contiguous"):
        tfa._check_bias(q, None, b2[:1].transpose(2, 3), 1, 8, 8, 4)
    assert tfa._check_bias(q, None, b2[:1], 1, 8, 8, 4)[2:] == (0, 0, 1)
    with pytest.raises(ValueError, match="block_mask shape"):
        tfa.flash_attention(q, kv, kv, block_q=4, block_k=4,
                            block_mask=np.ones((3, 2), np.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_fwd(q.to("meta"), kv.to("meta"), kv.to("meta"), mask, 0.1)


@pytest.mark.parametrize("b2_batch,causal,KV", [(1, True, 2), (2, False, 4),
                                                (2, True, 1)],
                         ids=["broadcast_causal_gqa", "full", "causal_mqa"])
def test_plain_forward_biases_match_pallas(b2_batch, causal, KV):
    """flash_fwd_plain with bias_kv (B, Skv) and bias_qk (B', H, S, Skv)
    against the reference's ``_flash_fwd(..., bias_kv=, bias_qk=)`` in
    interpret mode (its bias_kv in the (B, 8, Skv) sublane layout): o and
    lse, masks on top of the biases, bias_qk broadcast over the batch."""
    B, S, H, D = 2, 64, 4, 16
    q, k, v, _ = _inputs(2, B, S, H, KV, D)
    rng = np.random.default_rng(3)
    bias_kv = rng.standard_normal((B, S)).astype(np.float32)
    bias_kv[1, ::5] = -1e9
    bias_qk = rng.standard_normal((b2_batch, H, S, S)).astype(np.float32)
    scale = 1.0 / math.sqrt(D)
    jo, jlse = jfa._flash_fwd(
        *(jnp.asarray(t).transpose(0, 2, 1, 3) for t in (q, k, v)), None,
        None, None, scale, causal, 32, 32,
        bias_kv=jnp.broadcast_to(jnp.asarray(bias_kv)[:, None],
                                 (B, jfa.NUM_SUBLANES, S)),
        bias_qk=jnp.asarray(bias_qk))
    tfa.reset_counts()
    o, lse = tfa.flash_fwd(*map(torch.from_numpy, (q, k, v)),
                           tfa.AttnMask(causal=causal), scale,
                           torch.from_numpy(bias_kv),
                           torch.from_numpy(bias_qk))
    assert tfa.PLAIN_CALLS["flash_fwd_plain"] == 1
    assert not any(tfa.LAUNCHES.values())
    np.testing.assert_allclose(
        o.numpy(), np.asarray(jo).transpose(0, 2, 1, 3), atol=FWD_TOL,
        rtol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               atol=FWD_TOL, rtol=FWD_TOL)


def test_public_op_prepares_strided_and_misaligned_inputs():
    """A transposed q, q/k/v sliced from a fused QKV projection and a bf16
    q two bytes off the 16-byte grid: ``_check`` (the wrappers' own check
    on the card) refuses each as it is and takes it after
    ``kernel_layout``; the public op gives the same output and gradients as
    on contiguous copies."""
    B, S, H, KV, D = 2, 40, 4, 2, 64
    rng = np.random.default_rng(5)
    mask = tfa.AttnMask()
    qkv = torch.from_numpy(rng.standard_normal(
        (B, S, H + 2 * KV, D)).astype(np.float32))
    q_t = torch.from_numpy(rng.standard_normal(
        (B, H, S, D)).astype(np.float32)).transpose(1, 2)
    buf = torch.zeros(B * S * H * D + 1, dtype=torch.bfloat16)
    q_mis = buf[1:].view(B, S, H, D)
    q_mis.copy_(q_t)
    views = {"transposed": (q_t, qkv[:, :, H:H + KV], qkv[:, :, H + KV:]),
             "fused_qkv": tuple(qkv.split([H, KV, KV], dim=2)),
             "misaligned_bf16": (q_mis, qkv[:, :, H:H + KV].bfloat16(),
                                 qkv[:, :, H + KV:].bfloat16())}
    for name, (q, k, v) in views.items():
        with pytest.raises(ValueError, match="contiguous|16-byte aligned"):
            tfa._check(q, k.contiguous(), v.contiguous(), mask)
        ready = [tfa.kernel_layout(t) for t in (q, k, v)]
        assert tfa._check(*ready, mask) == (B, S, S, H, KV, D, 0), name
        assert [t.shape for t in ready] == [q.shape, k.shape, v.shape]
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        copies = [t.detach().contiguous().requires_grad_() for t in (q, k, v)]
        outs = []
        for ins in (leaves, copies):
            o = tfa.flash_attention(*ins)
            o.float().square().sum().backward()
            outs.append([o.detach()] + [t.grad for t in ins])
        for a, b in zip(*outs):
            assert a.shape == b.shape
            torch.testing.assert_close(a, b, rtol=0, atol=0)
