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


# ---------------------------------------------------------------------------
# the decode-row kernel (csrc/mixed_gemm.cu mixed_gemm_decode_kernel),
# emulated on the CPU: its exact code conversions bit for bit, then its
# fragments, loads, K-steps, warps and split-K sums
# ---------------------------------------------------------------------------

DEC_STEP, DEC_COLS, DEC_WARPS = 16, 128, 8  # csrc Dec: K-rows a step, columns a tile, warps


def _f32(bits):
    return np.asarray(bits, np.uint32).view(np.float32)


def _bf16_bits(v):
    """f32 -> bf16 bits, round to nearest even (finite values), as
    ``__floats2bfloat162_rn`` and ``Tensor.to(torch.bfloat16)``."""
    u = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint32)


def _i8_value(w, b):
    """csrc ``i8_value``: byte b of w (sign bits flipped) in 2^23's mantissa,
    less 2^23 + 128."""
    return _f32(_byte_perm(w, 0x4B000000, 0x7540 + b)) - np.float32(8388736.0)


def _i4_lo(lo, b):
    return _f32(_byte_perm(lo, 0x4B000000, 0x7540 + b)) - np.float32(8388616.0)


def _i4_hi(hi, b):
    """csrc ``i4_hi``: one fma of 2^23 + 16 (code + 8) by 1/16 less 2^19 + 8;
    its exact result is an integer, so computing it in f64 and rounding
    once is the fma."""
    exact = _f32(_byte_perm(hi, 0x4B000000, 0x7540 + b)).astype(np.float64) \
        * 0.0625 - 524296.0
    assert np.array_equal(exact, np.round(exact))
    return exact.astype(np.float32)


def _fp6_bits(t, second):
    """csrc ``fp6_bits``: both columns' codes of K-row k (or k + 1) as bf16
    patterns of fp6 * 2^-124."""
    t = np.asarray(t, np.uint32)
    if second:
        return ((t >> 1) & 0x03E003E0) | ((t << 4) & 0x80008000)
    return ((t << 5) & 0x03E003E0) | ((t << 10) & 0x80008000)


def _fp6_scaled(v, s, fast):
    """csrc ``fp6_scaled``: fast, s holds s * 2^124; else two products."""
    f = _f32(v)
    if fast:
        return f * np.float32(s)
    return (f * np.float32(2.0 ** 124)) * np.float32(s)


_CONV_SCALES = np.array([1.0, 0.0123, 3.7e-3, 7.5, 15.99, 1e-30, 1e-40,
                         2.0 ** -7, 1.0 / 3.0], np.float32)


def _ref_bf16(values, s):
    """``(float)code * s`` rounded to bf16, as the plain version's
    dequantization does it (torch on the CPU)."""
    w = torch.from_numpy(np.asarray(values, np.float32)) * torch.tensor(s)
    return w.to(torch.bfloat16).view(torch.int16).numpy().astype(
        np.uint32) & 0xFFFF


@pytest.mark.parametrize("s", _CONV_SCALES.tolist() + [16.0, 1e4],
                         ids=lambda s: f"s{s:g}")
def test_decode_code_conversions_are_exact(s):
    """Every int8 code (all 256, in each byte of a word), every int4 nibble
    (low and high, each byte) and every fp6 code (both K-rows of a pair,
    both halves, at bit 0 and bit 4 of the pair's 16 bits; subnormals and
    +-0) through the decode kernel's bit paths, times the scale and
    rounded to bf16, equals (float)code * s rounded to bf16, bit for bit;
    fp6 takes one product by s * 2^124 below s = 16, two above."""
    rng = np.random.default_rng(7)
    s = np.float32(s)
    codes = np.arange(-128, 128)
    for b in range(4):  # int8: code in byte b, other bytes random
        other = rng.integers(0, 256, (codes.size, 4)).astype(np.uint32)
        other[:, b] = codes.astype(np.int8).view(np.uint8)
        w = (other[:, 0] | other[:, 1] << 8 | other[:, 2] << 16
             | other[:, 3] << 24).astype(np.uint32) ^ np.uint32(0x80808080)
        v = _i8_value(w, b)
        assert np.array_equal(v, codes.astype(np.float32))
        np.testing.assert_array_equal(_bf16_bits(v * s), _ref_bf16(codes, s))
    lo, hi = np.meshgrid(np.arange(-8, 8), np.arange(-8, 8))
    lo, hi = lo.ravel(), hi.ravel()
    byte = ((lo & 15) | (hi & 15) << 4).astype(np.uint32)
    for b in range(4):
        w = (rng.integers(0, 2 ** 32, byte.size, dtype=np.uint64).astype(
            np.uint32) & ~np.uint32(255 << (8 * b))) | byte << (8 * b)
        vl = _i4_lo((w & 0x0F0F0F0F) ^ 0x08080808, b)
        vh = _i4_hi((w & 0xF0F0F0F0) ^ 0x80808080, b)
        assert np.array_equal(vl, lo.astype(np.float32))
        assert np.array_equal(vh, hi.astype(np.float32))
        np.testing.assert_array_equal(_bf16_bits(vl * s), _ref_bf16(lo, s))
        np.testing.assert_array_equal(_bf16_bits(vh * s), _ref_bf16(hi, s))
    c0, c1 = np.meshgrid(np.arange(64), np.arange(64))
    c0, c1 = c0.ravel().astype(np.uint32), c1.ravel().astype(np.uint32)
    vals = tqz.minifloat_decode(torch.arange(64), 3, 2).numpy()
    fast = s < 16
    scale = s * np.float32(2.0 ** 124) if fast else s
    assert np.isfinite(scale)
    for sh in (0, 4):  # K-rows 4q, 4q + 1 (bit 0) or 4q + 2, 4q + 3 (bit 4)
        junk = rng.integers(0, 16, c0.size).astype(np.uint32)
        u = (c0 << sh | c1 << (sh + 6) | (junk << 12 if sh == 0 else junk))
        u_other = np.roll(u, 1)  # the other column of the register
        for half in (0, 1):
            word = (u | u_other << 16) if half == 0 else (u_other | u << 16)
            t = (word & 0xFFFFFFFF).astype(np.uint32) >> sh
            x0, x1 = _fp6_bits(t, False), _fp6_bits(t, True)
            if half == 0:
                v0, v1 = (x0 << 16) & 0xFFFFFFFF, (x1 << 16) & 0xFFFFFFFF
            else:
                v0, v1 = x0 & 0xFFFF0000, x1 & 0xFFFF0000
            np.testing.assert_array_equal(
                _bf16_bits(_fp6_scaled(v0, scale, fast)),
                _ref_bf16(vals[c0], s))
            np.testing.assert_array_equal(
                _bf16_bits(_fp6_scaled(v1, scale, fast)),
                _ref_bf16(vals[c1], s))


_LANES = np.arange(32)
_GR, _TQ = _LANES >> 2, _LANES & 3


def _dec_rows(bits, i):
    """csrc ``DecRows``: (code row offset, first K-row) of register i of
    every lane."""
    if bits == 8:
        r = 2 * _TQ + (i & 1) + 8 * (i >> 1)
        return r, r
    if bits == 4:
        return _TQ + 4 * i, 2 * _TQ + 8 * i
    return (3 * (_TQ >> 1) + (_TQ & 1) + (i & 1) + 6 * (i >> 1),
            2 * _TQ + 8 * (i >> 1))


def _dec_a_frags(bits, words, sc, fast):
    """csrc ``decode_step``'s A registers (lanes, tile t, register r) from
    the code words (lanes, register, word) and the lanes' 16 scales."""
    a = np.zeros((32, 8, 4), np.uint32)
    pack = (lambda lo_, hi_: _bf16_bits(lo_) | _bf16_bits(hi_) << 16)
    if bits == 8:
        w = words ^ np.uint32(0x80808080)
    elif bits == 4:
        lo = (words & 0x0F0F0F0F) ^ np.uint32(0x08080808)
        hi = (words & 0xF0F0F0F0) ^ np.uint32(0x80808080)
    sh = (4 * (_TQ & 1)).astype(np.uint32)
    for t in range(8):
        q, b0 = t >> 1, 2 * (t & 1)
        s0, s1 = sc[:, 2 * t], sc[:, 2 * t + 1]
        for h in range(2):
            if bits == 8:
                a[:, t, 2 * h] = pack(_i8_value(w[:, 2 * h, q], b0) * s0,
                                      _i8_value(w[:, 2 * h + 1, q], b0) * s0)
                a[:, t, 2 * h + 1] = pack(
                    _i8_value(w[:, 2 * h, q], b0 + 1) * s1,
                    _i8_value(w[:, 2 * h + 1, q], b0 + 1) * s1)
            elif bits == 4:
                a[:, t, 2 * h] = pack(_i4_lo(lo[:, h, q], b0) * s0,
                                      _i4_hi(hi[:, h, q], b0) * s0)
                a[:, t, 2 * h + 1] = pack(_i4_lo(lo[:, h, q], b0 + 1) * s1,
                                          _i4_hi(hi[:, h, q], b0 + 1) * s1)
            else:
                u = _byte_perm(words[:, 2 * h, q], words[:, 2 * h + 1, q],
                               0x7362 if t & 1 else 0x5140)
                t_ = (np.asarray(u, np.uint32) >> sh).astype(np.uint32)
                x0, x1 = _fp6_bits(t_, False), _fp6_bits(t_, True)
                lo16 = (lambda v: (v << 16) & 0xFFFFFFFF)
                a[:, t, 2 * h] = pack(_fp6_scaled(lo16(x0), s0, fast),
                                      _fp6_scaled(lo16(x1), s0, fast))
                a[:, t, 2 * h + 1] = pack(
                    _fp6_scaled(x0 & 0xFFFF0000, s1, fast),
                    _fp6_scaled(x1 & 0xFFFF0000, s1, fast))
    return a


def _bf16_value(bits):
    return _f32((np.asarray(bits, np.uint32) & 0xFFFF) << 16)


def _emulate_decode_kernel(x, qw, blocks):
    """mixed_gemm_decode_kernel's arithmetic in f32: `blocks` blocks, block
    b taking steps [b T S / blocks, (b + 1) T S / blocks) of the T
    128-column tiles' S K-steps (16 K-rows each, partial at a group's end)
    in tile order, one tile's segment at a time: its 8 warps take
    contiguous shares of the segment; each lane's code rows gathered as the
    kernel loads them (every load instruction reading whole 128-byte row
    runs where the rows allow), converted by the kernel's bit paths into
    the m16n8k16 A fragments of eight m16 tiles (A rows gr, gr + 8 =
    columns 16 gr + 2t, + 1), B = x^T from the lanes' bf16 x pairs; D += A
    B per step; the warps added in warp order; y stored through the C
    fragment layout, a tile that several blocks share as their segments'
    sums added in block order."""
    M, K = x.shape
    N, g, bits = qw.out_features, qw.group, qw.bits
    NT = 1 if M <= 8 else 2
    upg, G = -(-g // DEC_STEP), K // g
    steps = G * upg
    tiles = -(-N // DEC_COLS)
    width = tiles * DEC_COLS + DEC_COLS
    codes = np.zeros((qw.codes.shape[0], width), np.uint8)
    codes[:, :N] = qw.codes.numpy().view(np.uint8)
    scales = np.zeros((G, width), np.float32)
    scales[:, :N] = qw.scales.numpy()
    xf = x.numpy().astype(np.float32)
    num, den = {8: (1, 1), 4: (1, 2), 6: (3, 4)}[bits]
    n_regs = {8: 4, 4: 2, 6: 4}[bits]
    rows_k = [_dec_rows(bits, i) for i in range(n_regs)]

    def warp_steps(col, u_lo, u_hi):
        acc = np.zeros((8, 16, 8 * NT), np.float32)
        for u in range(u_lo, u_hi):
            grp, kin = u // upg, (u % upg) * DEC_STEP
            k0, vk = grp * g + kin, min(DEC_STEP, g - kin)
            row0 = k0 * num // den
            words = np.zeros((32, n_regs, 4), np.uint32)
            for i, (r, kr) in enumerate(rows_k):
                at = (row0 + r)[:, None] * width + col[:, None] + np.arange(16)
                if N % 16 == 0:  # one 16-byte load: 4 runs of 128 bytes
                    for q in range(4):
                        run = np.sort(at[_TQ == q, 0])
                        assert np.array_equal(np.diff(run), [16] * 7)
                ok = (kr < vk)[:, None]
                raw = np.where(ok, codes.ravel()[np.minimum(
                    at, codes.size - 1)], 0).astype(np.uint8)
                words[:, i] = raw.view("<u4").reshape(32, 4)
            sc = scales[grp][col[:, None] + np.arange(16)]
            fast = bool((sc < 16).all())
            a = _dec_a_frags(bits, words, sc * np.float32(2.0 ** 124)
                             if bits == 6 and fast else sc, fast)
            A = np.zeros((8, 16, 16), np.float32)
            for r, (rr, kk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
                A[:, _GR + rr, 2 * _TQ + kk] = _bf16_value(a[:, :, r]).T
                A[:, _GR + rr, 2 * _TQ + kk + 1] = _bf16_value(a[:, :, r] >> 16).T
            B = np.zeros((16, 8 * NT), np.float32)
            for j in range(NT):  # x rows gr + 8j, K-rows from k0
                m = _GR + 8 * j
                for kk in (0, 1, 8, 9):
                    k = k0 + 2 * _TQ + kk
                    ok = (m < M) & (k < k0 + vk)
                    v = np.where(ok, xf[np.minimum(m, M - 1),
                                        np.minimum(k, K - 1)], 0)
                    B[2 * _TQ + kk, m] = _bf16_value(_bf16_bits(v))
            acc = acc + np.matmul(A, B)
        return acc

    def tile_values(v):
        """The warps' sum v (8, 16, 8 NT) as y rows and the tile's 128
        columns, through the C fragment layout: D[gr + 8 (e >> 1), 2tq + (e
        & 1) + 8j] -> y[8j + 2tq + (e & 1), 16 gr + 2t + (e >> 1)]."""
        out = np.zeros((16, DEC_COLS), np.float32)
        for e in range(4):
            for j in range(NT):
                m = 8 * j + 2 * _TQ + (e & 1)
                n = 16 * _GR[:, None] + 2 * np.arange(8) + (e >> 1)
                out[np.broadcast_to(m[:, None], n.shape), n] = \
                    v[np.arange(8), (_GR + 8 * (e >> 1))[:, None],
                      (2 * _TQ + (e & 1) + 8 * j)[:, None]]
        return out[:M]

    total = tiles * steps
    segment = {}
    for b in range(blocks):
        l, l_end = b * total // blocks, (b + 1) * total // blocks
        while l < l_end:
            tile, s_lo = l // steps, l % steps
            s_hi = min(steps, s_lo + l_end - l)
            l += s_hi - s_lo
            col = tile * DEC_COLS + 16 * _GR
            v = None
            for w in range(DEC_WARPS):  # the warps in warp order
                d = warp_steps(col, s_lo + w * (s_hi - s_lo) // DEC_WARPS,
                               s_lo + (w + 1) * (s_hi - s_lo) // DEC_WARPS)
                v = d if v is None else v + d
            segment[b, tile] = tile_values(v)

    def block_of(step):
        return ((step + 1) * blocks + total - 1) // total - 1

    y = np.zeros((M, tiles * DEC_COLS), np.float32)
    for tile in range(tiles):
        first, last = block_of(tile * steps), block_of((tile + 1) * steps - 1)
        v = segment[first, tile]
        for b in range(first + 1, last + 1):  # shared: in block order
            v = v + segment[b, tile]
        y[:, tile * DEC_COLS:(tile + 1) * DEC_COLS] = v
    return torch.from_numpy(y[:, :N].copy())


@pytest.mark.parametrize("bits,M,K,N,group,blocks", [
    (8, 1, 768, 104, 256, 3),   # a tile in three shares of one group each
    (8, 8, 768, 256, 256, 5),   # two tiles in five shares: one straddles
    (8, 16, 512, 40, 128, 3),   # two n8 tiles, N off the 16-byte grid
    (8, 9, 200, 96, 200, 1),    # a group 16 does not divide (a partial step)
    (8, 7, 99, 33, 99, 1),      # odd K: x rows and codes unaligned
    (4, 9, 512, 104, 256, 2),
    (4, 16, 200, 40, 200, 1),   # int4, a partial step
    (4, 1, 768, 256, 256, 7),   # shares of 13 5/7 steps over two tiles
    (6, 8, 768, 104, 256, 3),
    (6, 7, 512, 40, 128, 2),
    (6, 16, 96, 96, 96, 1),
], ids=["int8_m1_3shares", "int8_m8_straddle", "int8_m16_n40",
        "int8_partial_step", "int8_oddk", "int4_m9", "int4_partial_step",
        "int4_m1_straddle", "fp6_m8_3shares", "fp6_m7_2shares",
        "fp6_m16_k96"])
def test_decode_kernel_emulation_matches_plain_and_reference(
        bits, M, K, N, group, blocks):
    """The decode kernel emulated in f32 (_emulate_decode_kernel) against
    mixed_gemm_plain and the reference's Pallas kernel (interpret mode):
    sums of the same exact bf16 products in another order, within 1e-5 of
    the largest output."""
    x = _rand(M * K + N, M, K)
    jw, tw = _both(_rand(K * N + bits, K, N), bits, group)
    assert tw.group == group and tm.mixed_gemm_on_kernel_path(tw)
    got = _emulate_decode_kernel(torch.from_numpy(x), tw, blocks)
    plain = tm.mixed_gemm_plain(torch.from_numpy(x), tw)
    assert _rel_err(got.numpy(), plain.numpy()) < 1e-5
    assert _rel_err(got.numpy(), jm.mixed_gemm(jnp.asarray(x), jw)) < 1e-5


def test_decode_kernel_emulation_odd_k_int4():
    """int4 at odd K (one group: the kernel takes it; the wrapper sends
    it to the reference's dequantize formula, off its kernel envelope):
    the zero padding row in the last code byte, x masked past K."""
    x = _rand(5, 9, 99)
    tw = tm.quantize_gemm_weight(torch.from_numpy(_rand(6, 99, 48)), bits=4,
                                 group=256)
    assert tw.group == 99 and tw.codes.shape[0] == 50
    got = _emulate_decode_kernel(torch.from_numpy(x), tw, 1)
    plain = tm.mixed_gemm_plain(torch.from_numpy(x), tw)
    assert _rel_err(got.numpy(), plain.numpy()) < 1e-5


def test_decode_split_k_rule():
    """The decode kernel's split of the work (decode_blocks): as many
    blocks as an H100's 132 SMs hold at once, two an SM up to M = 8 (one
    n8 tile of x rows) and one above, each an equal share of the
    128-column tiles' 16-row K-steps, at least 16 steps a block.  At
    llama3-8b's projections (group 256): w_gate/w_in and w_out 264 blocks
    (108 3/5 and 108 8/11 steps), wk/wv 128 (8 tiles of 256 steps: the
    16-step floor); above 16 rows mixed_gemm_splits keeps the wgmma
    kernel's K-splits."""
    sms = 132
    assert tm.decode_steps(4096, 256) == 256
    assert tm.decode_steps(200, 200) == 13  # the last step partial
    assert tm.decode_blocks(8, 14336, 4096, 256, sms) == 264
    assert tm.decode_blocks(1, 14336, 4096, 256, sms) == 264
    assert tm.decode_blocks(16, 14336, 4096, 256, sms) == 132
    assert tm.decode_blocks(8, 4096, 14336, 256, sms) == 264
    assert tm.decode_blocks(8, 4096, 4096, 256, sms) == 264
    assert tm.decode_blocks(8, 1024, 4096, 256, sms) == 128
    assert tm.decode_blocks(8, 33, 99, 99, sms) == 1
    # above 16 rows the wgmma kernel's tile: 128 x 128, one block an SM
    assert tm.mixed_gemm_splits(17, 14336, 16, sms) == 1
    assert tm.mixed_gemm_splits(256, 4096, 16, sms) == 4
    assert tm.mixed_gemm_splits(256, 4096, 16, sms, bf16=False) == 4
