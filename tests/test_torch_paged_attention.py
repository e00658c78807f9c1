"""Parity: the port's paged attention (``deepspeed_tpu_torch.ops.hopper``)
against the JAX package's Pallas kernels (run in interpret mode on the CPU,
as the JAX package's own tests run them).

On CPU tensors the port's wrappers run their plain PyTorch versions; the
same numpy-seeded inputs go through both packages in f32 and must agree to
1e-5.  The CUDA kernels themselves are held against the plain versions on
a GPU by ``tests/test_torch_gpu.py``."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import paged_attention as jpa
from deepspeed_tpu_torch.ops.hopper import build
from deepspeed_tpu_torch.ops.hopper import paged_attention as tpa

from tests.torch_cpu import one_torch_thread  # noqa: F401

ATOL = 1e-5  # f32 both sides; only the summation order differs


def _paged(rng, S, H, KV, D, BS, NB, MB):
    k = rng.standard_normal((NB, BS, KV, D)).astype(np.float32)
    v = rng.standard_normal((NB, BS, KV, D)).astype(np.float32)
    bt = rng.permutation(NB)[: S * MB].reshape(S, MB).astype(np.int32)
    return k, v, bt


def _decode_case(seed, H, KV, D=16, BS=8):
    rng = np.random.default_rng(seed)
    S, NB, MB = 5, 32, 4
    k, v, bt = _paged(rng, S, H, KV, D, BS, NB, MB)
    q = rng.standard_normal((S, H, D)).astype(np.float32)
    ctx = np.array([5, 0, 17, 32, 1], np.int32)  # incl. ctx=0, full chain
    return q, k, v, bt, ctx


def _prefill_case(seed, H, KV, D=16, BS=8):
    rng = np.random.default_rng(seed)
    S, NB, MB, Qp = 4, 32, 6, 32
    k, v, bt = _paged(rng, S, H, KV, D, BS, NB, MB)
    q = rng.standard_normal((S, Qp, H, D)).astype(np.float32)
    # starts off the block grid; lens with padding rows, an inactive second
    # tile (len <= 16 with tq = 16), a zero-length row and a full one
    start = np.array([0, 5, 13, 3], np.int32)
    length = np.array([32, 11, 0, 20], np.int32)
    return q, k, v, bt, start, length


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2), (4, 1)],
                         ids=["mha", "gqa2", "gqa4"])
def test_decode_plain_matches_pallas(H, KV):
    q, k, v, bt, ctx = _decode_case(0, H, KV)
    want = np.asarray(jpa.paged_decode_attention(*map(jnp.asarray,
                                                      (q, k, v, bt, ctx))))
    tpa.reset_counts()
    got = tpa.paged_decode_attention(*_t(q, k, v, bt, ctx)).numpy()
    assert tpa.PLAIN_CALLS["decode_attention_plain"] == 1
    assert tpa.LAUNCHES["paged_decode_attention"] == 0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert not np.any(got[1])  # ctx = 0 row is exactly zero
    assert np.isfinite(got).all()


@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2), (4, 1)],
                         ids=["mha", "gqa2", "gqa4"])
def test_prefill_plain_matches_pallas(H, KV):
    q, k, v, bt, start, length = _prefill_case(1, H, KV)
    want = np.asarray(jpa.paged_prefill_attention(
        *map(jnp.asarray, (q, k, v, bt, start, length))))
    tpa.reset_counts()
    got = tpa.paged_prefill_attention(*_t(q, k, v, bt, start, length)).numpy()
    assert tpa.PLAIN_CALLS["prefill_attention_plain"] == 1
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    for s, n in enumerate(length):
        assert not np.any(got[s, n:])  # padding rows and inactive tiles
    assert np.isfinite(got).all()


# keys per tile of the decode kernel (csrc/paged_attention.cu Decode::kKeys):
# 32 in f32, 64 in bf16
DECODE_TILES = (32, 64)


def _emulate_split_decode(q, k_cache, v_cache, bt, ctx, split, tile):
    """The split-KV decode kernels' arithmetic in plain torch, f32: per
    (sequence, split of ``split`` positions) an online softmax over tiles of
    ``tile`` keys in the log2 domain, one update per tile, for every kv
    head at once; a chain of one split is normalised in place, a longer one
    merged in split order with weights 2^(m_i - M) / sum_j 2^(m_j - M) l_j;
    ctx = 0 gives zeros."""
    S, H, D = q.shape
    _, BS, KV, _ = k_cache.shape
    T = bt.shape[1] * BS
    k = k_cache[bt.long()].reshape(S, T, KV, D)
    v = v_cache[bt.long()].reshape(S, T, KV, D)
    qs = q.reshape(S, KV, H // KV, D) * (1.0 / math.log(2.0) / math.sqrt(D))
    out = torch.zeros_like(qs)
    for s in range(S):
        c = min(int(ctx[s]), T)
        parts = []
        for lo in range(0, c, split):
            hi = min(c, lo + split)
            m = torch.full(qs.shape[1:3], -math.inf)
            l = torch.zeros(qs.shape[1:3])
            acc = torch.zeros(qs.shape[1:])
            for c0 in range(lo, hi, tile):
                end = min(hi, c0 + tile)
                kt, vt = k[s, c0:end], v[s, c0:end]
                x = torch.einsum("kgd,nkd->kgn", qs[s], kt)
                m_new = torch.maximum(m, x.max(-1).values)
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(x - m_new[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum("kgn,nkd->kgd", p,
                                                            vt)
                m = m_new
            parts.append((m, l, acc))
        if len(parts) == 1:
            _, l, acc = parts[0]
            out[s] = acc / l[..., None]
        elif parts:
            mx = torch.stack([m for m, _, _ in parts]).max(0).values
            w = [torch.exp2(m - mx) for m, _, _ in parts]
            den = sum(wi * l for wi, (_, l, _) in zip(w, parts))
            out[s] = sum((wi / den)[..., None] * a
                         for wi, (_, _, a) in zip(w, parts))
    return out.reshape(S, H, D)


def test_decode_split_follows_the_shapes():
    """128 positions a split, more only where a chain would need more than
    32 splits; every split length is a multiple of both kernel tiles."""
    assert [tpa.decode_split(n) for n in (8, 128, 2048, 4096, 4097, 32768)] \
        == [128, 128, 128, 128, 256, 1024]
    assert all(tpa.decode_split(n) % max(DECODE_TILES) == 0
               for n in range(1, 9000, 97))


@pytest.mark.parametrize("tile", DECODE_TILES)
def test_split_kv_decode_matches_plain_and_pallas_on_split_edges(tile):
    """Chains of 512 positions (BS = 8, MB = 64: four splits of 128), at
    contexts on the split edges: 0, 1, split - 1, split, split + 1 and the
    whole chain.  The emulated partials and merge agree with the plain
    version and with the Pallas kernel (interpret mode) in f32."""
    rng = np.random.default_rng(3)
    S, H, KV, D, BS, NB, MB = 6, 4, 2, 16, 8, 400, 64
    k, v, bt = _paged(rng, S, H, KV, D, BS, NB, MB)
    q = rng.standard_normal((S, H, D)).astype(np.float32)
    split = tpa.decode_split(MB * BS)
    assert split == 128 and MB * BS // split == 4
    ctx = np.array([0, 1, split - 1, split, split + 1, MB * BS], np.int32)
    got = _emulate_split_decode(*_t(q, k, v, bt, ctx), split, tile).numpy()
    plain = tpa.decode_attention_plain(*_t(q, k, v, bt, ctx)).numpy()
    want = np.asarray(jpa.paged_decode_attention(*map(jnp.asarray,
                                                      (q, k, v, bt, ctx))))
    np.testing.assert_allclose(got, plain, atol=ATOL, rtol=0)
    np.testing.assert_allclose(plain, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert not np.any(got[0])


def test_prefill_single_row_equals_decode():
    """A one-row chunk at position p is a decode step with ctx = p + 1."""
    q, k, v, bt, ctx = _decode_case(2, 4, 2)
    ctx = np.maximum(ctx, 1)
    qp = q[:, None]  # (S, 1, H, D)
    pre = tpa.paged_prefill_attention(*_t(qp, k, v, bt, ctx - 1,
                                          np.ones_like(ctx)))
    dec = tpa.paged_decode_attention(*_t(q, k, v, bt, ctx))
    np.testing.assert_allclose(pre[:, 0].numpy(), dec.numpy(), atol=ATOL,
                               rtol=0)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros((2, 4, 64), dtype=torch.float64)
    kc = torch.zeros((8, 16, 2, 64), dtype=torch.float64)
    ints = {"block_tables": torch.zeros((2, 4), dtype=torch.int32)}
    with pytest.raises(TypeError, match="bfloat16, float16 or float32"):
        tpa._check_common(q, kc, kc, ints, 4, 64)
    q, kc = q.float(), kc.float()
    with pytest.raises(ValueError, match="head dim"):
        tpa._check_common(q[..., :48], kc[..., :48], kc[..., :48], ints, 4, 48)
    with pytest.raises(ValueError, match="query heads per kv head"):
        tpa._check_common(q, kc[:, :, :1].repeat(1, 1, 3, 1),
                          kc[:, :, :1].repeat(1, 1, 3, 1), ints, 4, 64)
    with pytest.raises(TypeError, match="int32"):
        tpa._check_common(q, kc, kc, {"block_tables": ints[
            "block_tables"].long()}, 4, 64)
    with pytest.raises(ValueError, match="contiguous"):
        tpa._check_common(q, kc, kc, {"block_tables": torch.zeros(
            (4, 2), dtype=torch.int32).T}, 4, 64)
    # contiguous, but 4 bytes off the 16-byte grid the kernels copy
    off = torch.zeros(kc.numel() + 1)[1:].view(kc.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tpa._check_common(q, off, kc, ints, 4, 64)
    assert tpa._check_common(q, kc, kc, ints, 4, 64) == (8, 16, 2)


def test_build_is_from_source_and_raises_without_nvcc(monkeypatch, tmp_path):
    path = build.library_path()
    assert path.parent == build.BUILD_DIR
    assert path.parts[-3:-1] == ("build", "torch_kernels")
    assert [s.name for s in build.SOURCES] == ["paged_attention.cu",
                                               "flash_attention.cu",
                                               "flash_attention_bias.cu",
                                               "flash_attention_bias_f16.cu",
                                               "flash_attention_f16.cu",
                                               "mixed_gemm.cu",
                                               "grouped_matmul.cu",
                                               "fused_adam.cu"]
    assert all(s.is_file() for s in build.SOURCES)
    # a change to any source gives another library name
    for i, src in enumerate(build.SOURCES):
        copy = tmp_path / src.name
        copy.write_bytes(src.read_bytes() + b"// edited\n")
        sources = list(build.SOURCES)
        sources[i] = copy
        monkeypatch.setattr(build, "SOURCES", tuple(sources))
        assert build.library_path().name != path.name
        monkeypatch.undo()
    assert build.library_path() == path
    # a build failure raises; nothing falls back
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(build.os.path, "isfile",
                        lambda p: False)
    monkeypatch.setattr(build, "_LIB", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load()


def test_kernel_source_names_what_it_replaces():
    paged, flash, flash_bias, flash_bias_f16, flash_f16, mixed, grouped, \
        adam = (s.read_text() for s in build.SOURCES)
    assert '#include "flash_attention.cu"' in flash_bias
    assert "DS_FLASH_BIAS_UNIT 1" in flash_bias
    assert '#include "flash_attention.cu"' in flash_bias_f16
    assert "DS_FLASH_BIAS_UNIT 2" in flash_bias_f16
    assert '#include "flash_attention.cu"' in flash_f16
    assert "DS_FLASH_F16_UNIT 1" in flash_f16
    assert "_decode_kernel" in paged and "_prefill_kernel" in paged
    assert 'extern "C" int ds_paged_decode' in paged
    assert 'extern "C" int ds_paged_prefill' in paged
    assert "deepspeed_tpu/ops/pallas/flash_attention.py" in flash
    for name in ("_fwd_kernel", "_bwd_dkdv_kernel", "_bwd_dq_kernel"):
        assert name in flash
    for entry in ("ds_flash_fwd", "ds_flash_bwd_dkdv", "ds_flash_bwd_dq"):
        assert f'extern "C" int {entry}' in flash
        assert entry in build._ENTRIES
    assert "deepspeed_tpu/ops/pallas/mixed_gemm.py" in mixed
    for name in ("_mixed_gemm_kernel", "_int8_gemm_kernel"):
        assert name in mixed
    for entry in ("ds_mixed_gemm", "ds_int8_gemm"):
        assert f'extern "C" int {entry}' in mixed
        assert entry in build._ENTRIES
    for src, ref, name, entry in (
            (grouped, "deepspeed_tpu/ops/pallas/grouped_matmul.py",
             "_gmm_kernel", "ds_grouped_matmul"),
            (adam, "deepspeed_tpu/ops/fused_optimizers.py", "_adam_kernel",
             "ds_fused_adamw")):
        assert ref in src and name in src
        assert f'extern "C" int {entry}' in src
        assert entry in build._ENTRIES


# ---------------------------------------------------------------------------
# the bf16 and f16 prefill kernel's tensor-core arithmetic, emulated on the
# CPU
# ---------------------------------------------------------------------------

PREFILL_TILE = 64  # keys per tile of paged_prefill_tc_kernel
LOG2E = 1.0 / math.log(2.0)
HALF_P = 2.0 ** 14  # the f16 kernel's factor on p (csrc: kHalfP)


def _emulate_tc_prefill(q, k_cache, v_cache, bt, start, length, split):
    """paged_prefill_tc_kernel's arithmetic at the inputs' dtype (bf16 or
    f16): per (sequence, kv head) the query vectors (row, head in group)
    walk 64-key tiles whose rows are gathered through the block table
    (zeros past the chunk's end), S = Q K^T summed in f32 from exact
    products, an online softmax in the log2 domain (a vector keeps key c
    iff c <= min(start + row, end - 1), rows past the chunk keep none), O
    += P V with P split into hi + lo of the dtype (``split``) or rounded to
    it alone, o = acc / l in the dtype.  In f16, p is multiplied by 2^14
    before the split, and l with it."""
    dt = q.dtype
    p_scale = HALF_P if dt == torch.float16 else 1.0
    S, Qp, H, D = q.shape
    BS, KV = k_cache.shape[1], k_cache.shape[2]
    G, MB = H // KV, bt.shape[1]
    scale2 = LOG2E / math.sqrt(D)
    out = torch.zeros(S, Qp, H, D)
    for s in range(S):
        qlen = min(int(length[s]), Qp)
        if qlen == 0:
            continue
        end = min(int(start[s]) + qlen, MB * BS)
        qf = q[s].float().reshape(Qp, KV, G, D).transpose(0, 1) \
            .reshape(KV, Qp * G, D)
        rows = torch.arange(Qp * G) // G
        lim = torch.where(rows < qlen,
                          torch.clamp(int(start[s]) + rows, max=end - 1), -1)
        m = torch.full((KV, Qp * G), -math.inf)
        l = torch.zeros(KV, Qp * G)
        acc = torch.zeros(KV, Qp * G, D)
        for c0 in range(0, int(lim.max()) + 1, PREFILL_TILE):
            c = torch.arange(c0, c0 + PREFILL_TILE)
            live = (c < end)[:, None, None]
            page = bt[s, torch.clamp(c // BS, max=MB - 1).long()].long()
            kt = torch.where(live, k_cache[page, c % BS].float(), 0.0)
            vt = torch.where(live, v_cache[page, c % BS].float(), 0.0)
            keep = c[None, :] <= lim[:, None]
            x = torch.where(keep, (qf @ kt.permute(1, 2, 0)) * scale2,
                            -math.inf)
            m_new = torch.maximum(m, x.max(-1).values)
            m_use = torch.where(m_new == -math.inf, 0.0, m_new)
            alpha = torch.exp2(m - m_use)
            p = torch.where(keep, torch.exp2(x - m_use[..., None]), 0.0) \
                * p_scale
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None]
            hi = p.to(dt).float()
            parts = (hi, (p - hi).to(dt).float()) if split else (hi,)
            for part in parts:
                acc = acc + part @ vt.transpose(0, 1)
            m = m_new
        o = torch.where((l > 0)[..., None],
                        acc / torch.where(l > 0, l, 1.0)[..., None], 0.0)
        out[s] = o.reshape(KV, Qp, G, D).transpose(0, 1).reshape(Qp, H, D)
    return out.to(dt)


def _smoke_prefill_case(dtype):
    """chip_smoke's prefill check on the CPU: its shape (H = 32, KV = 8, D =
    128, block 64, chains of 2048 positions), chunk starts and lengths,
    inputs in ``dtype`` from a numpy seed, and the plain version's output
    (one sequence at a time, to bound the scores' memory)."""
    import chip_smoke as cs

    rng = np.random.default_rng(0)
    S, Qp = len(cs.PREFILL_START), cs.PREFILL_QP
    NB = S * cs.MB

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)

    kc, vc = bf16(NB, cs.BS, cs.KV, cs.D), bf16(NB, cs.BS, cs.KV, cs.D)
    q = bf16(S, Qp, cs.H, cs.D)
    bt = torch.from_numpy(rng.permutation(NB).reshape(S, cs.MB)
                          .astype(np.int32))
    start = torch.tensor(cs.PREFILL_START, dtype=torch.int32)
    length = torch.tensor(cs.PREFILL_LEN, dtype=torch.int32)
    ref = torch.cat([tpa.prefill_attention_plain(
        q[s:s + 1], kc, vc, bt[s:s + 1], start[s:s + 1], length[s:s + 1])
        for s in range(S)])
    return cs, (q, kc, vc, bt, start, length), ref


@pytest.fixture(scope="module")
def smoke_prefill():
    return _smoke_prefill_case(torch.bfloat16)


def test_tc_prefill_f16_split_after_2_14_meets_the_smoke_limit():
    """The f16 kernel's arithmetic (p times 2^14, then split into f16 hi +
    lo; l carries the factor) at the same shape and seed in f16 meets
    chip_smoke's f16 limit against the plain version, and padding rows are
    exactly zero."""
    cs, args, ref = _smoke_prefill_case(torch.float16)
    got = _emulate_tc_prefill(*args, split=True)
    assert got.dtype == torch.float16
    cs.compare_f16(got, ref, "emulated f16 prefill")
    assert cs.f16_excess(got, ref)[1] < 0
    for s, n in enumerate(cs.PREFILL_LEN):
        assert not got[s, n:].any()


def test_tc_prefill_hi_lo_split_meets_the_smoke_limit(smoke_prefill):
    """With P split into bf16 hi + lo, the emulated kernel meets
    chip_smoke's TOL_BF16 against the plain version (9.88e-05 inside it at
    this seed), and padding rows are exactly zero."""
    cs, args, ref = smoke_prefill
    got = _emulate_tc_prefill(*args, split=True)
    cs.compare(got, ref, cs.TOL_BF16, "emulated bf16 prefill")
    assert cs.excess(got, ref, *cs.TOL_BF16)[1] < 0
    for s, n in enumerate(cs.PREFILL_LEN):
        assert not got[s, n:].any()


def test_tc_prefill_p_rounded_to_bf16_breaks_the_smoke_limit(smoke_prefill):
    """P rounded to bf16 alone lies past TOL_BF16 (1.71e-03 at this seed,
    1200-key contexts): that is why the kernel splits P."""
    cs, args, ref = smoke_prefill
    got = _emulate_tc_prefill(*args, split=False)
    with pytest.raises(SystemExit):
        cs.compare(got, ref, cs.TOL_BF16, "emulated bf16 prefill, P bf16")
