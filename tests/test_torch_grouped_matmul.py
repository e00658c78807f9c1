"""Parity: the port's grouped matmul (``deepspeed_tpu_torch/ops/hopper/
grouped_matmul.py``) against the JAX package's, on numpy-seeded inputs.

* ``tile_aligned_layout`` is exact: positions, tile_group, the padded group
  sizes and M_pad equal the reference's, with empty experts, every row on
  one expert, and T not a multiple of tile_m; the used-tile count is the
  tiles before the clipped tail.
* ``grouped_matmul`` (the kernel's plain version on the CPU) against the
  reference's entry, which runs ``jax.lax.ragged_dot`` off the TPU: the
  product and both gradients within 1e-5 of max|ref| (f32 sums of the same
  products in another order).
* ``rhs_transposed`` reads rhs as (E, N, K): the product with the
  weights transposed, within 1e-6 of max|ref| (the plain version reads a
  transposed view against a contiguous copy).
* Counters: the CPU path counts plain calls and never a launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import grouped_matmul as jg
from deepspeed_tpu_torch.ops.hopper import grouped_matmul as tg

TOL = 1e-5  # of the largest reference element


def _rel_err(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / np.abs(want).max())


LAYOUT_CASES = {
    "random": (lambda rng: rng.integers(0, 4, 37), 4, 8),
    "empty_experts": (lambda rng: rng.choice([1, 3], 21), 5, 4),
    "one_expert": (lambda rng: np.full(19, 2), 4, 8),
    "last_expert": (lambda rng: np.full(16, 3), 4, 16),
    "exact_tiles": (lambda rng: np.repeat(np.arange(4), 8), 4, 8),
    "decode_like": (lambda rng: rng.integers(0, 8, 16), 8, 16),
    "tile_512": (lambda rng: rng.integers(0, 8, 48), 8, 512),
}


@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
def test_layout_exact(case):
    make, E, tile_m = LAYOUT_CASES[case]
    ef = make(np.random.default_rng(len(case))).astype(np.int32)
    T = ef.shape[0]
    want = jg.tile_aligned_layout(jnp.asarray(ef), E, T, tile_m)
    got = tg.tile_aligned_layout(torch.from_numpy(ef), E, T, tile_m,
                                 with_used_tiles=True)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3] == want[3]
    counts = np.bincount(ef, minlength=E)
    used = int(sum(-(-c // tile_m) for c in counts))
    assert got[4].tolist() == [used]
    # every tile from the used count on is padding, clipped to expert E-1
    assert (got[1][used:] == E - 1).all()


def _problem(seed, E=4, T=30, K=24, N=40, tile_m=8):
    rng = np.random.default_rng(seed)
    ef = rng.integers(0, E, T).astype(np.int32)
    ef[ef == 1] = 2  # an empty expert
    pos, tgroup, sizes, M_pad = jg.tile_aligned_layout(jnp.asarray(ef), E, T,
                                                       tile_m)
    lhs = np.zeros((M_pad, K), np.float32)
    lhs[np.asarray(pos)] = rng.standard_normal((T, K))
    rhs = rng.standard_normal((E, K, N)).astype(np.float32)
    g = np.zeros((M_pad, N), np.float32)
    g[np.asarray(pos)] = rng.standard_normal((T, N))
    return lhs, rhs, g, np.array(tgroup), np.array(sizes), tile_m


@pytest.mark.parametrize("tile_m", [8, 16])
def test_forward_and_gradients_match_reference(tile_m):
    lhs, rhs, g, tgroup, sizes, _ = _problem(tile_m, tile_m=tile_m)

    def jloss(a, b):
        out = jg.grouped_matmul(a, b, jnp.asarray(tgroup),
                                jnp.asarray(sizes), tile_m=tile_m)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, want), (jdl, jdr) = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(
        jnp.asarray(lhs), jnp.asarray(rhs))
    tl = torch.from_numpy(lhs).requires_grad_()
    tr = torch.from_numpy(rhs).requires_grad_()
    out = tg.grouped_matmul(tl, tr, torch.from_numpy(tgroup),
                            torch.from_numpy(sizes), tile_m=tile_m)
    assert _rel_err(out.detach().numpy(), want) <= TOL
    (out * torch.from_numpy(g)).sum().backward()
    assert _rel_err(tl.grad.numpy(), jdl) <= TOL
    assert _rel_err(tr.grad.numpy(), jdr) <= TOL
    # padding rows: zero in and zero out
    real = np.abs(lhs).sum(1) > 0
    assert not out.detach().numpy()[~real].any()


def test_rhs_transposed_reads_n_by_k():
    lhs, rhs, g, tgroup, _, tile_m = _problem(3)
    rt = torch.from_numpy(np.ascontiguousarray(rhs.swapaxes(1, 2)))
    tgroup = torch.from_numpy(tgroup)
    gt = torch.from_numpy(g)
    # dlhs = g @ rhs[e]^T from the (E, K, N) weights read as (N, K) ...
    got = tg.grouped_matmul(gt, torch.from_numpy(rhs), tgroup, None,
                            tile_m=tile_m, rhs_transposed=True)
    # ... equals the plain product with a materialized transpose
    want = tg.grouped_matmul_plain(gt, rt, tgroup, tile_m)
    assert _rel_err(got.numpy(), want.numpy()) <= 1e-6
    assert got.shape == (lhs.shape[0], rhs.shape[1])


def test_bf16_rounds_once():
    lhs, rhs, _, tgroup, sizes, tile_m = _problem(4)
    lb = torch.from_numpy(lhs).bfloat16()
    rb = torch.from_numpy(rhs).bfloat16()
    got = tg.grouped_matmul(lb, rb, torch.from_numpy(tgroup),
                            torch.from_numpy(sizes), tile_m=tile_m)
    assert got.dtype == torch.bfloat16
    want = jg.grouped_matmul(jnp.asarray(lb.float().numpy()),
                             jnp.asarray(rb.float().numpy()),
                             jnp.asarray(tgroup), jnp.asarray(sizes),
                             tile_m=tile_m)
    # f32 sums of exact bf16 products, rounded once to bf16: within one
    # bf16 ulp (2**-8 relative) of the f32 reference
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=2 ** -8, atol=1e-6)


def test_counts_and_refusals():
    lhs, rhs, _, tgroup, sizes, tile_m = _problem(5)
    tg.reset_counts()
    args = (torch.from_numpy(lhs), torch.from_numpy(rhs),
            torch.from_numpy(tgroup), torch.from_numpy(sizes))
    tg.grouped_matmul(*args, tile_m=tile_m)
    tg.grouped_matmul(*args, tile_m=tile_m)
    assert tg.PLAIN_CALLS == {"grouped_matmul_plain": 2}
    assert tg.LAUNCHES == {"grouped_matmul": 0}
    with pytest.raises(ValueError, match="multiple of tile_m"):
        tg.grouped_matmul(*args, tile_m=7)
    with pytest.raises(ValueError, match="K="):
        tg.grouped_matmul(args[0][:, :-1].contiguous(), *args[1:],
                          tile_m=tile_m)
    assert tg.kernel_tile_m(16) == 16 and tg.kernel_tile_m(512) == 64
    assert tg.kernel_tile_m(48) == 16
    with pytest.raises(ValueError, match="multiple of 16"):
        tg.kernel_tile_m(8)
    tg.reset_counts()
    assert tg.PLAIN_CALLS == {"grouped_matmul_plain": 0}
