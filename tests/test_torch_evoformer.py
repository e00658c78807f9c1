"""Parity: the port's evoformer attention
(``deepspeed_tpu_torch.ops.evoformer``) against the JAX package's
(``deepspeed_tpu.ops.evoformer``), whose forward runs the Pallas flash
kernel in interpret mode on the CPU (its XLA branch at L = 20), as its own
tests run it.

The same numpy-seeded f32 inputs (a 0 / -1e9 mask bias and a normal pair
bias, as ``tests/test_evoformer.py`` draws them) go through both packages:
the output and lse, and the gradients of all five inputs by autograd
against ``jax.grad``, must agree within the reference test's 2e-4 (atol and
rtol).  On CPU tensors the port runs ``flash_fwd_plain``; the bias kernels
are held against it on a GPU by ``tests/test_torch_gpu.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import evoformer as jev
from deepspeed_tpu_torch.ops import evoformer as tev
from deepspeed_tpu_torch.ops.hopper import flash_attention as tfa

from tests.torch_cpu import one_torch_thread  # noqa: F401

TOL = 2e-4  # tests/test_evoformer.py's limit, f32 both sides


def _inputs(seed, shape, with_mask=True, with_pair=True, padded=None):
    """q, k, v, bias1, bias2 and a cotangent, f32 numpy; ``padded``: an
    MSA sequence whose keys all sit at -1e9."""
    B, N, L, H, D = shape
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal(shape).astype(np.float32)
                  for _ in range(4))
    b1 = b2 = None
    if with_mask:
        keep = rng.random((B, N, 1, 1, L)) < 0.8
        if padded is not None:
            keep[:, padded] = False
        b1 = (1e9 * (keep.astype(np.float32) - 1.0)).astype(np.float32)
    if with_pair:
        b2 = rng.standard_normal((B, 1, H, L, L)).astype(np.float32)
    return q, k, v, b1, b2, g


def _jax(a):
    return None if a is None else jnp.asarray(a)


def _torch(a, grad=False):
    return None if a is None else torch.from_numpy(a).requires_grad_(grad)


def _check_forward(q, k, v, b1, b2):
    """Port output and lse (plain path, no kernel launch) against the
    reference's ``_fwd_impl``."""
    want, want_lse = jev._fwd_impl(
        *map(_jax, (q, k, v)), _jax(b1) if b1 is not None else jnp.zeros(0),
        _jax(b2) if b2 is not None else jnp.zeros(0), b1 is not None,
        b2 is not None)
    tfa.reset_counts()
    out, lse = tev.evoformer_fwd(*map(_torch, (q, k, v, b1, b2)))
    assert tfa.PLAIN_CALLS["flash_fwd_plain"] == 1
    assert not any(tfa.LAUNCHES.values())
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=TOL,
                               rtol=TOL)
    return out


@pytest.mark.parametrize("shape", [(1, 4, 32, 4, 16), (2, 2, 64, 2, 8)])
def test_forward_matches_reference(shape):
    q, k, v, b1, b2, _ = _inputs(0, shape)
    _check_forward(q, k, v, b1, b2)
    out = tev.DS4Sci_EvoformerAttention(*map(_torch, (q, k, v)),
                                        [_torch(b1), _torch(b2)])
    want = jev.evoformer_attention(*map(_jax, (q, k, v)), [_jax(b1),
                                                           _jax(b2)])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("case,shape", [
    ("unaligned_length", (1, 2, 20, 2, 8)),  # the reference's XLA branch
    ("multi_tile", (1, 1, 1024, 1, 8)),      # two 512-key Pallas tiles
    ("ragged_multi_tile", (1, 2, 200, 2, 16)),
])
def test_forward_lengths_match_reference(case, shape):
    q, k, v, b1, b2, _ = _inputs(1, shape)
    _check_forward(q, k, v, b1, b2)


def test_padded_msa_sequence_gives_mean_of_v():
    """A sequence whose keys all sit at -1e9: every score rounds to the
    same value, so o is the mean of V, as the reference's kernel gives."""
    shape = (1, 3, 64, 2, 16)
    q, k, v, b1, b2, _ = _inputs(2, shape, padded=1)
    out = _check_forward(q, k, v, b1, b2)
    np.testing.assert_allclose(
        out[0, 1].numpy(),
        np.broadcast_to(v[0, 1].mean(0, keepdims=True), v[0, 1].shape),
        atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("with_mask,with_pair,padded",
                         [(True, True, None), (False, True, None),
                          (True, False, None), (False, False, None),
                          (True, True, 2), (True, False, 2)])
def test_grads_match_reference(with_mask, with_pair, padded):
    """The four bias combinations, and a padded MSA sequence (sequence 2)
    with each combination that has the mask bias."""
    shape = (1, 4, 32, 2, 16)
    q, k, v, b1, b2, g = _inputs(3, shape, with_mask, with_pair, padded)

    def loss(q, k, v, b1, b2):
        bs = [b1 if with_mask else None, b2 if with_pair else None]
        return jnp.sum(jev.evoformer_attention(q, k, v, bs) * g)

    zero = jnp.zeros(())
    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *map(_jax, (q, k, v)), _jax(b1) if with_mask else zero,
        _jax(b2) if with_pair else zero)
    leaves = [_torch(a, True) for a in (q, k, v, b1, b2)]
    out = tev.evoformer_attention(*leaves[:3], leaves[3:])
    (out * torch.from_numpy(g)).sum().backward()
    for name, t, w in zip("dq dk dv db1 db2".split(), leaves, want):
        if t is None:
            continue
        assert t.grad.dtype == t.dtype and t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL, err_msg=name)


def test_absent_bias_gets_no_gradient():
    q, k, v, b1, _, g = _inputs(4, (1, 2, 16, 2, 8), with_pair=False)
    leaves = [_torch(a, True) for a in (q, k, v)]
    dq, dk, dv, db1, db2 = tev.evoformer_bwd(
        *leaves, _torch(b1), None, *tev.evoformer_fwd(
            *leaves, _torch(b1), None), torch.from_numpy(g))
    assert db2 is None and db1.shape == b1.shape


def test_unbatched_4d_input():
    q, k, v, b1, b2, _ = _inputs(5, (1, 2, 32, 2, 8))
    out5 = tev.evoformer_attention(*map(_torch, (q, k, v)),
                                   [_torch(b1), _torch(b2)])
    out4 = tev.evoformer_attention(*(_torch(a[0]) for a in (q, k, v)),
                                   [_torch(b1[0]), _torch(b2[0])])
    want = jev.evoformer_attention(*(_jax(a[0]) for a in (q, k, v)),
                                   [_jax(b1[0]), _jax(b2[0])])
    np.testing.assert_allclose(out4.detach().numpy(),
                               out5[0].detach().numpy(), atol=1e-6)
    np.testing.assert_allclose(out4.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)


def test_bad_shapes_raise_the_reference_errors():
    q, k, v, b1, b2, _ = _inputs(6, (1, 2, 32, 2, 8))
    for args in ([b2], [b1, b1], [b1, b2, b1]):
        with pytest.raises(ValueError) as want:
            jev.evoformer_attention(*map(_jax, (q, k, v)),
                                    [_jax(a) for a in args])
        with pytest.raises(ValueError) as got:
            tev.evoformer_attention(*map(_torch, (q, k, v)),
                                    [_torch(a) for a in args])
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=r"q must be \(B, N, L, H, D\)"):
        tev.evoformer_attention(torch.zeros(2, 3, 4), torch.zeros(2, 3, 4),
                                torch.zeros(2, 3, 4))


def test_chunk_size_is_the_reference_one():
    for args in ((128, 1, 8, 256, 256), (256, 1, 4, 256, 256), (7, 2, 3, 5,
                                                                  5),
                 (1, 1, 1, 1, 1), (6, 4, 64, 4096, 4096)):
        assert tev._chunk_size(*args) == jev._chunk_size(*args)
