"""Parity: the port's quantizer and mixed GEMMs (``deepspeed_tpu_torch/ops/
quantizer.py``, ``ops/hopper/mixed_gemm.py``, ``inference/quantization.py``)
against the JAX package's, on numpy-seeded inputs.

* Quantization is bit-exact: codes, scales, the true K and the shrunken
  group of ``quantize_gemm_weight`` equal the reference's for bits 8, 4 and 6
  and for K in {256, 200, 99, 130} (aligned, shrinking and odd cases), as do
  ``dequantize_gemm_weight`` and ``quantize_activations_rowwise``.
* ``mixed_gemm`` (the kernel's plain version on the CPU) against the
  reference's Pallas kernel in interpret mode: on its kernel path within
  1e-5 of max|ref| (f32 sums of the same exact bf16 products in another
  order); off it, the same dequantize formula within 1e-6 of max|ref|.
* ``int8_gemm`` within 1e-6 of max|ref|, on and off its envelope.
* ``mixed_gemm_frozen``'s dx against ``jax.grad`` through the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import quantization as jq
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.ops import quantizer as jqz
from deepspeed_tpu.ops.pallas import mixed_gemm as jm
from deepspeed_tpu_torch.inference import quantization as tq
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.ops import quantizer as tqz
from deepspeed_tpu_torch.ops.hopper import mixed_gemm as tm

from tests.torch_cpu import one_torch_thread  # noqa: F401


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(w, bits, group=256):
    return (jm.quantize_gemm_weight(jnp.asarray(w), bits=bits, group=group),
            tm.quantize_gemm_weight(torch.from_numpy(w), bits=bits,
                                    group=group))


def _rel_err(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("bits", [8, 4, 6])
@pytest.mark.parametrize("K", [256, 200, 99, 130])
def test_quantize_gemm_weight_bit_exact(bits, K):
    w = _rand(K + bits, K, 96)
    w[:, 5] = 0.0  # an all-zero column takes scale 1
    jw, tw = _both(w, bits)
    assert (tw.bits, tw.group, tw.k) == (jw.bits, jw.group, jw.k)
    assert tw.codes.numpy().dtype == np.asarray(jw.codes).dtype
    np.testing.assert_array_equal(tw.codes.numpy(), np.asarray(jw.codes))
    np.testing.assert_array_equal(tw.scales.numpy(), np.asarray(jw.scales))
    np.testing.assert_array_equal(tm.dequantize_gemm_weight(tw).numpy(),
                                  np.asarray(jm.dequantize_gemm_weight(jw)))


@pytest.mark.parametrize("bits", [8, 4, 6])
def test_stacked_quantize_bit_exact(bits):
    w = _rand(1, 3, 128, 64)
    jw, tw = _both(w, bits, group=64)
    np.testing.assert_array_equal(tw.codes.numpy(), np.asarray(jw.codes))
    np.testing.assert_array_equal(tw.scales.numpy(), np.asarray(jw.scales))
    layer = tw[1]
    assert tuple(layer.codes.shape) == tuple(jw.codes.shape[1:])
    assert (layer.bits, layer.group, layer.k) == (bits, 64, 128)


def test_quantize_activations_rowwise_bit_exact():
    x = _rand(2, 9, 512)
    x[3, :256] = 0.0  # an all-zero (row, group) takes scale 1
    jc, js = jm.quantize_activations_rowwise(jnp.asarray(x), 256)
    tc, ts = tm.quantize_activations_rowwise(torch.from_numpy(x), 256)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_int4_pack_round_trip_exact():
    rng = np.random.default_rng(3)
    lo = rng.integers(-8, 8, size=(64, 33)).astype(np.int8)
    hi = rng.integers(-8, 8, size=(64, 33)).astype(np.int8)
    packed = tqz.pack_int4(torch.from_numpy(lo), torch.from_numpy(hi))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jqz.pack_int4(jnp.asarray(lo),
                                                 jnp.asarray(hi))))
    got_lo, got_hi = tqz.unpack_int4(packed)
    np.testing.assert_array_equal(got_lo.numpy(), lo)
    np.testing.assert_array_equal(got_hi.numpy(), hi)


def test_fp6_pack_and_minifloat_round_trip_exact():
    codes = np.random.default_rng(4).integers(0, 64, size=(5, 48))
    packed = tqz.pack_fp6(torch.from_numpy(codes))
    assert packed.dtype == torch.uint8 and packed.shape == (5, 36)
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jqz.pack_fp6(jnp.asarray(codes))))
    np.testing.assert_array_equal(tqz.unpack_fp6(packed).numpy(), codes)
    # every code decodes as the reference decodes it, and encodes back
    all_codes = torch.arange(64)
    vals = tqz.minifloat_decode(all_codes, 3, 2)
    np.testing.assert_array_equal(
        vals.numpy(), np.asarray(jqz.minifloat_decode(jnp.arange(64), 3, 2)))
    back = tqz.minifloat_encode(vals, 3, 2)
    nonzero = vals != 0  # +0 and -0 both encode as +0
    assert torch.equal(back[nonzero], all_codes[nonzero].to(torch.int32))
    assert tqz.minifloat_max(3, 2) == jqz.minifloat_max(3, 2) == 28.0
    x = _rand(5, 1000) * 10
    np.testing.assert_array_equal(
        tqz.minifloat_encode(torch.from_numpy(x), 3, 2).numpy(),
        np.asarray(jqz.minifloat_encode(jnp.asarray(x), 3, 2)))


@pytest.mark.parametrize("bits", [8, 4, 6])
@pytest.mark.parametrize("shape", [(64, 256, 256), (8, 512, 384),
                                   (300, 256, 256)],
                         ids=["64x256x256", "8x512x384", "ragged_m300"])
def test_mixed_gemm_matches_reference_kernel(bits, shape):
    M, K, N = shape
    x = _rand(10, M, K)
    jw, tw = _both(_rand(11, K, N), bits)
    assert tm.mixed_gemm_on_kernel_path(tw)
    tm.reset_counts()
    got = tm.mixed_gemm(torch.from_numpy(x), tw)
    assert tm.PLAIN_CALLS["mixed_gemm_plain"] == 1
    assert tm.DEQUANT_CALLS["mixed_gemm"] == 0
    want = jm.mixed_gemm(jnp.asarray(x), jw)
    assert got.shape == (M, N) and got.dtype == torch.float32
    assert _rel_err(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("bits,K,N,group", [
    (8, 98, 33, 49),    # group 49: neither a multiple of 128 nor K
    (4, 99, 33, 256),   # odd K: the group shrinks to 99, odd for int4
    (6, 130, 128, 130),  # K % 4 != 0 for fp6
    (6, 200, 128, 256),  # the group shrinks to 200, not a multiple of 32
    (8, 256, 300, 256),  # N = 300 has no 128-multiple tile
], ids=["int8_group49", "int4_oddk", "fp6_k130", "fp6_k200", "n300"])
def test_mixed_gemm_off_envelope_matches_reference(bits, K, N, group):
    x = _rand(12, 7, K)
    jw, tw = _both(_rand(13, K, N), bits, group)
    assert not tm.mixed_gemm_on_kernel_path(tw)
    tm.reset_counts()
    got = tm.mixed_gemm(torch.from_numpy(x), tw)
    assert tm.DEQUANT_CALLS["mixed_gemm"] == 1
    assert tm.PLAIN_CALLS["mixed_gemm_plain"] == 0
    assert _rel_err(got.numpy(), jm.mixed_gemm(jnp.asarray(x), jw)) < 1e-6


def test_mixed_gemm_lead_dims_and_refusals():
    x = _rand(14, 2, 3, 256)
    _, tw = _both(_rand(15, 256, 128), 8)
    got = tm.mixed_gemm(torch.from_numpy(x), tw)
    assert got.shape == (2, 3, 128)
    flat = tm.mixed_gemm(torch.from_numpy(x.reshape(6, 256)), tw)
    torch.testing.assert_close(got.reshape(6, 128), flat, rtol=0, atol=0)
    with pytest.raises(ValueError, match="x K=128"):
        tm.mixed_gemm(torch.from_numpy(x[..., :128].copy()), tw)
    stacked = tm.quantize_gemm_weight(torch.from_numpy(_rand(16, 2, 256, 128)))
    with pytest.raises(ValueError, match="per-layer"):
        tm.mixed_gemm(torch.from_numpy(x), stacked)
    with pytest.raises(ValueError, match="4, 6 or 8"):
        tm.quantize_gemm_weight(torch.zeros(256, 128), bits=5)
    with pytest.raises(ValueError, match="true K"):
        tm.QuantizedWeight(tw.codes, tw.scales, 4, 256)


@pytest.mark.parametrize("bits", [8, 4, 6])
def test_frozen_gemm_grad_matches_reference(bits):
    x = _rand(17, 16, 256)
    g = _rand(18, 16, 128)
    jw, tw = _both(_rand(19, 256, 128), bits, group=128)
    want = jax.grad(lambda xx: jnp.sum(jm.mixed_gemm_frozen(xx, jw)
                                       * jnp.asarray(g)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (tm.mixed_gemm_frozen(xt, tw) * torch.from_numpy(g)).sum().backward()
    assert _rel_err(xt.grad.numpy(), want) < 1e-6
    assert tw.codes.grad is None


@pytest.mark.parametrize("shape", [(64, 256, 256), (8, 512, 384),
                                   (4, 130, 128)],
                         ids=["64x256x256", "8x512x384", "off_k130"])
def test_int8_gemm_matches_reference(shape):
    M, K, N = shape
    x = _rand(20, M, K)
    jw, tw = _both(_rand(21, K, N), 8, group=256)
    on = tm.int8_gemm_on_kernel_path(tw)
    assert on == (K % 256 == 0)
    tm.reset_counts()
    got = tm.int8_gemm(torch.from_numpy(x), tw)
    assert tm.PLAIN_CALLS["int8_gemm_plain"] == int(on)
    assert tm.DEQUANT_CALLS["int8_gemm"] == int(not on)
    assert _rel_err(got.numpy(), jm.int8_gemm(jnp.asarray(x), jw)) < 1e-6


def test_int8_gemm_refuses_other_bits():
    _, tw = _both(_rand(22, 130, 128), 4, group=130)
    with pytest.raises(ValueError, match="bits=8"):
        tm.int8_gemm(torch.zeros(4, 130), tw)


def test_params_from_jax_carries_quantized_weights():
    """A reference tree already quantized by its quantize_model_params
    converts to QuantizedWeight leaves with the same codes and scales per
    layer slice; the port's own quantize_model_params of the raw weights
    gives the same codes."""
    cfg = jt.get_config("tiny", dtype="float32", num_kv_heads=2)
    raw = jt.init_params(jax.random.PRNGKey(0), cfg)
    tcfg = tt.get_config("tiny", dtype="float32", num_kv_heads=2)
    for bits in (8, 4, 6):
        qtree = jq.quantize_model_params(raw, bits=bits, group=256)
        conv = tt.params_from_jax(jax.tree_util.tree_map(np.asarray, qtree),
                                  tcfg, device="cpu")
        ours = tq.quantize_model_params(tt.params_from_jax(
            jax.tree_util.tree_map(np.asarray, raw), tcfg, device="cpu"),
            bits=bits, group=256)
        for part, key in (("attn", "wq"), ("attn", "wk"), ("mlp", "w_out")):
            ref = qtree["layers"][part][key]
            for tree in (conv, ours):
                w = tree["layers"][part][key]
                assert isinstance(w, tm.QuantizedWeight)
                assert (w.bits, w.group, w.k) == (ref.bits, ref.group, ref.k)
                assert w.scales.dtype == torch.float32
                for i in range(cfg.num_layers):
                    layer = tt.layer_params(tree, i)[part][key]
                    np.testing.assert_array_equal(
                        layer.codes.numpy(), np.asarray(ref.codes[i]))
                    np.testing.assert_array_equal(
                        layer.scales.numpy(), np.asarray(ref.scales[i]))
        assert conv["embed"]["tokens"].dtype == torch.float32
        acct, ref_acct = tq.quantized_bytes(conv), jq.quantized_bytes(qtree)
        assert acct == ref_acct and acct["quantized"] > 0


# the wgmma kernel's K-tile depth (csrc/mixed_gemm.cu WgSmem::BK)
WGMMA_BK = 64


def _emulate_wgmma_gemm(x, qw, splits):
    """mixed_gemm_wgmma_kernel's order of sums in f32: split z of `splits`
    takes K-groups [z G / splits, (z + 1) G / splits); each group is walked
    in 64-deep K-tiles (a partial last tile when 64 does not divide the
    group), each tile's bf16 products summed in f32 into the split's
    partial; the partials are added in split order (splitk_reduce_kernel).
    The weight is dequantized as the kernel does it: code * scale in f32,
    then bf16."""
    w = tm.dequantize_gemm_weight(qw).to(torch.bfloat16).float()
    xb = x.to(torch.bfloat16).float()
    G, g = qw.k_features // qw.group, qw.group
    out = None
    for z in range(splits):
        part = torch.zeros(x.shape[0], qw.out_features)
        for grp in range(z * G // splits, (z + 1) * G // splits):
            for kin in range(0, g, WGMMA_BK):
                k0, k1 = grp * g + kin, grp * g + min(g, kin + WGMMA_BK)
                part = part + xb[:, k0:k1] @ w[k0:k1]
        out = part if out is None else out + part
    return out.to(x.dtype)


@pytest.mark.parametrize("bits,K,N,group,splits", [
    (8, 99, 33, 99, 1),      # the unaligned shapes of the card's tests:
    (4, 200, 50, 200, 1),    # rows and strides off the 16-byte grid, a
    (6, 96, 40, 96, 1),      # partial last K-tile
    (8, 200, 64, 200, 1),    # aligned rows, a group that 64 does not divide
    (8, 768, 96, 256, 3),    # one group per split
    (4, 768, 96, 256, 2),    # 1 + 2 groups
    (6, 1792, 40, 256, 3),   # 2 + 2 + 3 groups
], ids=["int8_k99", "int4_k200", "fp6_k96", "int8_k200_n64", "int8_split3",
        "int4_split2", "fp6_split3"])
def test_wgmma_gemm_tile_order_and_split_k_match_plain_and_reference(
        bits, K, N, group, splits):
    """The M > 16 kernel's K-tile order and split-K, emulated at M = 40 in
    f32, against mixed_gemm_plain and the reference's Pallas kernel
    (interpret mode): f32 sums of the same exact bf16 products in another
    order, within 1e-5 of the largest output."""
    x = _rand(K + N, 40, K)
    jw, tw = _both(_rand(K + N + 1, K, N), bits, group)
    assert tm.mixed_gemm_on_kernel_path(tw) and tw.group == group
    assert splits <= K // group
    got = _emulate_wgmma_gemm(torch.from_numpy(x), tw, splits)
    plain = tm.mixed_gemm_plain(torch.from_numpy(x), tw)
    want = jm.mixed_gemm(jnp.asarray(x), jw)
    assert _rel_err(got.numpy(), plain.numpy()) < 1e-5
    assert _rel_err(got.numpy(), want) < 1e-5
    assert _rel_err(plain.numpy(), want) < 1e-5


# ---------------------------------------------------------------------------
# the W8A8 kernels' arithmetic (csrc/mixed_gemm.cu int8_gemm_wgmma_kernel and
# int8_gemm_mma_kernel), emulated on the CPU
# ---------------------------------------------------------------------------

I8_BK, I8_BN = 128, 64  # K-tile depth and columns per block of both kernels
H100_SMS = 132  # the wgmma kernel's row-block choice reads the SM count


def _sw64(r, c):
    """Byte c (< 64) of row r of a 64-byte-row tile in the 64-byte swizzle
    mode (csrc ``sw64``): chunk c // 16 stored at chunk (c // 16) ^ ((r //
    2) % 4)."""
    return r * 64 + ((((c >> 4) ^ (r >> 1)) & 3) << 4) + (c & 15)


def _byte_perm(x, y, s):
    """CUDA's ``__byte_perm``: byte i of the result is byte (s >> 4i) & 7
    of the eight bytes x (0-3), y (4-7)."""
    b = [(x >> (8 * i)) & 255 for i in range(4)] + \
        [(y >> (8 * i)) & 255 for i in range(4)]
    return sum(b[(s >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _a_frag_s8(tile, k0, c, tq, loads=None):
    """``a_frag_s8``: the four s8 A registers of one thread for the 32-deep
    k-step at K-row k0, read from the swizzled code tile (bytes) as the
    kernel reads it (tq >= 2 rotates its rows by two), each 16-bit load's
    byte address appended to ``loads`` in issue order."""
    rot = tq & 2
    regs = []
    for h in range(2):
        kb = k0 + 16 * h + 4 * tq
        u = []
        for i in range(4):
            at = _sw64(kb + ((i + rot) & 3), c)
            if loads is not None:
                loads.append(at)
            u.append(int(tile[at]) | int(tile[at + 1]) << 8)
        p, q = u[0] | u[1] << 16, u[2] | u[3] << 16
        r01, r23 = (q, p) if rot else (p, q)
        regs += [_byte_perm(r01, r23, 0x6420), _byte_perm(r01, r23, 0x7531)]
    return regs


def _swizzled(codes_tile):
    """A (128, 64) int8 code tile laid out as TMA's 64-byte swizzle (and
    the mma kernel's cp.async copies) write it."""
    buf = np.zeros(128 * 64, np.uint8)
    raw = codes_tile.astype(np.int8).view(np.uint8)
    for r in range(128):
        for c in range(64):
            buf[_sw64(r, c)] = raw[r, c]
    return buf


def test_int8_a_fragments_from_the_swizzled_tile():
    """Every thread's s8 A registers hold what wgmma's and mma.sync's A
    layout asks for: register 2h + j is K-rows k0 + 16h + 4tq .. + 3 of
    column 16 wl + 2 gr + j, lowest K in the lowest byte; and each of the
    warp's 16-bit loads touches no shared-memory bank at two addresses."""
    codes = np.random.default_rng(0).integers(-128, 128, (128, 64))
    tile = _swizzled(codes)
    raw = codes.astype(np.int8).view(np.uint8)
    for wl in range(4):
        for kk in range(4):
            loads = {}
            for lane in range(32):
                gr, tq = lane >> 2, lane & 3
                c = 16 * wl + 2 * gr
                seq = []
                regs = _a_frag_s8(tile, 32 * kk, c, tq, seq)
                for h in range(2):
                    for j in range(2):
                        rows = 32 * kk + 16 * h + 4 * tq + np.arange(4)
                        want = sum(int(raw[r, c + j]) << (8 * i)
                                   for i, r in enumerate(rows))
                        assert regs[2 * h + j] == want
                for n, at in enumerate(seq):
                    loads.setdefault(n, []).append(at)
            for addrs in loads.values():  # one load instruction, 32 lanes
                banks = {}
                for at in addrs:
                    banks.setdefault((at // 4) % 32, set()).add(at // 4)
                assert max(len(words) for words in banks.values()) == 1


def _group_sum_f32(i):
    """csrc ``group_sum_f32<true>``: the s32 group sum i (|i| <= 2**22) as
    f32 by the bits of 1.5 * 2**23 + i, less 1.5 * 2**23."""
    bits = (0x4B400000 + i.to(torch.int64)).to(torch.int32)
    return bits.view(torch.float32) - torch.tensor(12582912.0)


def test_int8_group_sum_conversion_is_exact():
    """Every s32 sum a group of at most 256 int8 products can reach, the
    extremes +-2**22 included, converts exactly."""
    i = torch.cat([torch.arange(-2 ** 22, -2 ** 22 + 4096),
                   torch.arange(-70000, 70000),
                   torch.randint(-2 ** 22, 2 ** 22 + 1, (200000,),
                                 generator=torch.Generator().manual_seed(0)),
                   torch.arange(2 ** 22 - 4096, 2 ** 22 + 1)])
    got = _group_sum_f32(i)
    assert torch.equal(got.to(torch.int64), i)
    assert torch.equal(got, i.to(torch.float32))


def _a_rows_to_columns(rows):
    """The column of a 64-column block that A row rho (of a warp's 16, warp
    rho // 16) stands for: A rows gr and gr + 8 are columns 2 gr and 2 gr +
    1 of the warp's 16."""
    rho = np.arange(rows)
    return 16 * (rho // 16) + 2 * (rho % 8) + (rho % 16) // 8


def _emulate_int8_kernel(xc, xs, qw, wgmma, dtype=torch.float32):
    """The W8A8 kernels' arithmetic: per block of 64 columns and BM rows of
    x (wgmma: two warpgroups of 128 rows, or of 64 where 256-row blocks
    would not fill an H100's SMs; mma.sync: 16 rows), D = A B with
    A = W^T's columns in the permuted A-row order (_a_rows_to_columns) and
    B = x^T, summed exactly over each group's 32-deep k-steps and 128-deep
    K-tiles, a new sum at each group's first k-step (scale-d = 0); at each
    group's last tile acc = acc + f32(D) * xs * ws in f32, one rounding per
    operation; the result un-permuted at the store.  A group's integer sum
    is exact in any order, so it is formed by one f64 product over the
    group's depth (every partial sum is an integer below 2**53)."""
    M, K = xc.shape
    N, g = qw.out_features, qw.group
    codes = qw.codes.to(torch.float64)
    x = xc.to(torch.float64)
    if wgmma:  # 256-row blocks where they fill the card's SMs, else 128
        big = M > 128 and -(-M // 256) * -(-N // I8_BN) >= H100_SMS
        bm, parts = (256 if big else 128), 2
    else:
        bm, parts = 16, 1
    perm = torch.from_numpy(_a_rows_to_columns(I8_BN))
    out = torch.zeros((M, N), dtype=dtype)
    for n0 in range(0, N, I8_BN):
        cols = n0 + perm  # the block's A rows as columns
        valid = cols < N
        a_full = torch.zeros((I8_BN, K), dtype=torch.float64)
        a_full[valid] = codes[:, cols[valid]].T  # A = W^T, permuted
        for m0 in range(0, M, bm):
            for part in range(parts):
                r0 = m0 + part * (bm // parts)
                rows = torch.arange(r0, r0 + bm // parts)
                b_full = torch.zeros((K, rows.numel()), dtype=torch.float64)
                b_full[:, rows < M] = x[rows[rows < M]].T
                acc = torch.zeros((I8_BN, rows.numel()))
                for grp in range(K // g):  # scaled at its last K-tile
                    k0 = grp * g
                    d = (a_full[:, k0:k0 + g] @ b_full[k0:k0 + g]).to(
                        torch.int64)
                    xsr = torch.zeros(rows.numel())
                    xsr[rows < M] = xs[rows[rows < M], grp]
                    wsr = torch.zeros(I8_BN)
                    wsr[valid] = qw.scales[grp, cols[valid]]
                    fd = (_group_sum_f32(d) if g <= 256
                          else d.to(torch.float32))
                    acc = acc + fd * xsr[None, :] * wsr[:, None]
                keep = rows < M
                out[rows[keep][:, None], cols[valid][None, :]] = \
                    acc[valid][:, keep].T.to(dtype)
    return out


@pytest.mark.parametrize("wgmma", [True, False], ids=["wgmma", "mma"])
@pytest.mark.parametrize("M,K,N", [
    (8, 512, 96), (16, 256, 1024), (17, 256, 40), (64, 512, 128),
    (200, 512, 384), (300, 256, 200), (200, 256, 8448)],
    ids=["m8", "m16", "m17_n40", "m64", "m200", "m300_n200",
         "m200_256row_blocks"])
def test_int8_kernels_match_plain_bit_for_bit_and_reference(wgmma, M, K, N):
    """The emulated kernels against int8_gemm_quantized_plain bit for bit
    (the card holds the kernels to the same), and against the reference's
    Pallas W8A8 kernel (interpret mode) within 1e-6 of max|ref|; ragged M
    (17, 200, 300) leaves partial row blocks, ragged N (40, 200) partial
    column blocks; the f32 sums of the group products go through
    _group_sum_f32 where the group is at most 256 deep, as in the kernel."""
    x = _rand(M + N, M, K)
    jw, tw = _both(_rand(M + K, K, N), 8, group=256)
    assert tm.int8_gemm_on_kernel_path(tw)
    xc, xs = tm.quantize_activations_rowwise(torch.from_numpy(x), tw.group)
    got = _emulate_int8_kernel(xc, xs, tw, wgmma)
    plain = tm.int8_gemm_quantized_plain(xc, xs, tw, torch.float32)
    assert torch.equal(got, plain)
    bf16 = _emulate_int8_kernel(xc, xs, tw, wgmma, torch.bfloat16)
    assert torch.equal(bf16, tm.int8_gemm_quantized_plain(
        xc, xs, tw, torch.bfloat16))
    assert _rel_err(got.numpy(), jm.int8_gemm(jnp.asarray(x), jw)) < 1e-6


def test_int8_dispatch_and_refusals():
    """W8A8's kernel choice is on the rows and the layout: more than 16
    rows with TMA's rows (N a multiple of 16, 16-byte aligned arrays) take
    the wgmma kernel; everything else the mma.sync kernel."""
    _, tw = _both(_rand(30, 256, 96), 8)
    xc = torch.zeros((17, 256), dtype=torch.int8)
    assert tm.int8_uses_wgmma(xc, tw)
    assert not tm.int8_uses_wgmma(xc[:16], tw)
    _, odd = _both(_rand(31, 256, 40), 8)
    assert not tm.int8_uses_wgmma(xc, odd)
    shifted = torch.zeros(17 * 256 + 1, dtype=torch.int8)[1:].view(17, 256)
    assert not tm.int8_uses_wgmma(shifted, tw)
    with pytest.raises(ValueError, match="CUDA"):
        tm.int8_gemm_quantized(xc, torch.ones((17, 1)), tw, torch.float32)


def test_kernel_header_is_part_of_the_library_digest(monkeypatch, tmp_path):
    """The GEMM sources include csrc/hopper.cuh: an edited header gives
    another library name, so a stale build is never loaded."""
    from deepspeed_tpu_torch.ops.hopper import build
    path = build.library_path()
    assert [h.name for h in build.HEADERS] == ["hopper.cuh"]
    for src in build.SOURCES:
        if src.name in ("mixed_gemm.cu", "grouped_matmul.cu"):
            assert '#include "hopper.cuh"' in src.read_text()
    copy = tmp_path / "hopper.cuh"
    copy.write_bytes(build.HEADERS[0].read_bytes() + b"// edited\n")
    monkeypatch.setattr(build, "HEADERS", (copy,))
    assert build.library_path().name != path.name
