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

from tests.torch_cpu import one_torch_thread  # noqa: F401

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


# ---------------------------------------------------------------------------
# grouped_matmul_wgmma_kernel's schedule (csrc/grouped_matmul.cu), mirrored
# ---------------------------------------------------------------------------

WG_CHUNK, WG_BK = 256, 64  # rows per chunk at most, K-tile depth


def _expert_tiles(tile_group, used, e):
    """The kernel's search for expert e's tiles: among the first ``used``
    tiles (all when None), the tiles of experts < e come first (tile_group
    is sorted), then e's own.  Returns (first tile, tile count)."""
    tgl = [int(v) for v in tile_group]
    lim = len(tgl) if used is None else min(max(int(used), 0), len(tgl))
    return (sum(v < e for v in tgl[:lim]), sum(v == e for v in tgl[:lim]))


def _chunks(first, count, tile_m):
    """(row, 64-row sub-tiles) of each chunk the block walks."""
    row0, rows = first * tile_m, count * tile_m
    return [(r, min(WG_CHUNK, row0 + rows - r) // 64)
            for r in range(row0, row0 + rows, WG_CHUNK)]


def _routing(rng, T, E):
    """Seeded top-k-like routing with empty experts and one heavy expert."""
    ef = rng.integers(0, E, T)
    ef[rng.random(T) < rng.random()] = rng.integers(0, E)  # a heavy one
    for e in rng.choice(E, size=rng.integers(0, E // 2 + 1), replace=False):
        ef[ef == e] = (e + 1) % E  # some experts left empty
    return ef.astype(np.int32)


@pytest.mark.parametrize("tile_m", [64, 128])
@pytest.mark.parametrize("with_used", [True, False], ids=["used", "no_used"])
def test_wgmma_expert_search_matches_layout(tile_m, with_used):
    """Over 60 seeded routings (empty experts, experts of more than 256
    rows): the search gives each expert the offset and padded size of
    tile_aligned_layout, the chunks cover its rows in pieces of at most 256
    rows; without a used count the last expert also takes the all-padding
    tail, which then holds zero rows of lhs."""
    heavy = 0
    for seed in range(60):
        rng = np.random.default_rng(seed)
        E = int(rng.choice([2, 4, 8]))
        T = int(rng.integers(1, 700))
        ef = _routing(rng, T, E)
        _, tgroup, sizes, M_pad, used = tg.tile_aligned_layout(
            torch.from_numpy(ef), E, T, tile_m, with_used_tiles=True)
        ntiles = M_pad // tile_m
        counts = np.bincount(ef, minlength=E)
        padded = -(-counts // tile_m) * tile_m
        offsets = np.cumsum(padded) - padded
        for e in range(E):
            first, count = _expert_tiles(tgroup, used.item() if with_used
                                         else None, e)
            want = padded[e] // tile_m
            if not with_used and e == E - 1:
                want = ntiles - offsets[e] // tile_m  # + the tail
            assert (first * tile_m, count) == (offsets[e], want)
            chunks = _chunks(first, count, tile_m)
            assert sum(64 * n for _, n in chunks) == count * tile_m
            assert all(1 <= n <= WG_CHUNK // 64 for _, n in chunks)
            heavy += len(chunks) > 1
        # the padded sizes of the layout agree, tail included
        assert sizes[:-1].tolist() == padded[:-1].tolist()
        assert int(used.item()) == padded.sum() // tile_m
    assert heavy > 10  # experts of more than 256 rows were searched


def _emulate_wgmma_gmm(lhs, rhs, tile_group, tile_m, used):
    """The wgmma kernel's schedule in f32: per expert its rows from the
    search, in chunks of at most 256 rows, each chunk's f32 sums taken over
    64-deep K-tiles in order; the all-padding tail (tiles from ``used`` on)
    written as zeros."""
    M, K = lhs.shape
    E = rhs.shape[0]
    out = torch.full((M, rhs.shape[2]), float("nan"))
    for e in range(E):
        first, count = _expert_tiles(tile_group, used, e)
        for r, nsub in _chunks(first, count, tile_m):
            rows = slice(r, r + 64 * nsub)
            d = torch.zeros((64 * nsub, rhs.shape[2]))
            for k0 in range(0, K, WG_BK):
                d = d + lhs[rows, k0:k0 + WG_BK] @ rhs[e, k0:k0 + WG_BK]
            out[rows] = d
    if used is not None:
        out[int(used) * tile_m:] = 0.0
    return out


@pytest.mark.parametrize("with_used", [True, False], ids=["used", "no_used"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wgmma_chunk_loop_matches_plain_and_reference(seed, with_used):
    """The emulated schedule at tile_m 64 (an expert of more than 256 rows,
    an empty one, K off the 64-deep tiles) against grouped_matmul_plain and
    the reference's entry: every row written, within 1e-5 of max|ref|."""
    rng = np.random.default_rng(100 + seed)
    E, T, K, N, tile_m = 4, 400, 96, 40, 64
    ef = rng.integers(0, E, T).astype(np.int32)
    ef[: T // 2] = 3  # 200+ rows on expert 3: two chunks
    ef[ef == 1] = 0  # expert 1 empty
    pos, tgroup, sizes, M_pad = jg.tile_aligned_layout(jnp.asarray(ef), E, T,
                                                       tile_m)
    lhs = np.zeros((M_pad, K), np.float32)
    lhs[np.asarray(pos)] = rng.standard_normal((T, K))
    rhs = rng.standard_normal((E, K, N)).astype(np.float32)
    used = int(sum(-(-c // tile_m) for c in np.bincount(ef, minlength=E)))
    tgt = torch.from_numpy(np.array(tgroup))
    got = _emulate_wgmma_gmm(torch.from_numpy(lhs), torch.from_numpy(rhs),
                             tgt, tile_m, used if with_used else None)
    assert not got.isnan().any()
    plain = tg.grouped_matmul_plain(torch.from_numpy(lhs),
                                    torch.from_numpy(rhs), tgt, tile_m)
    want = jg.grouped_matmul(jnp.asarray(lhs), jnp.asarray(rhs), tgroup,
                             sizes, tile_m=tile_m)
    assert _rel_err(got.numpy(), plain.numpy()) <= TOL
    assert _rel_err(got.numpy(), want) <= TOL
    assert not got[used * tile_m:].any()


def test_wgmma_dispatch():
    """bf16 on (E, K, N) weights at tile_m a multiple of 64 runs the wgmma
    kernel; decode's tile_m 16, the transposed weights of the backward's
    dlhs and f32 keep the mma.sync and CUDA-core kernels."""
    assert tg.uses_wgmma(torch.bfloat16, 64, False)
    assert tg.uses_wgmma(torch.bfloat16, 512, False)
    assert not tg.uses_wgmma(torch.bfloat16, 16, False)
    assert not tg.uses_wgmma(torch.bfloat16, 48, False)
    assert not tg.uses_wgmma(torch.bfloat16, 64, True)
    assert not tg.uses_wgmma(torch.float32, 64, False)
    tg.reset_counts()
    assert tg.WGMMA_LAUNCHES == {"grouped_matmul": 0}
