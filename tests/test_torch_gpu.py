"""The port's CUDA kernels on a GPU: each held against its plain PyTorch
version, and the engine served through them against the same engine on the
CPU.  Every test here needs an NVIDIA GPU (``cuda`` marker) and skips
without one.  The file imports neither JAX nor the JAX package, so on a GPU
machine without JAX it runs with

    python -m pytest --noconftest -m cuda tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.v2 import engine as te
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.moe import dropless as tdl
from deepspeed_tpu_torch.moe import layer as tml
from deepspeed_tpu_torch.ops import evoformer as tev
from deepspeed_tpu_torch.ops import fused_optimizers as tfo
from deepspeed_tpu_torch.ops import sparse_attention as tsa
from deepspeed_tpu_torch.ops.hopper import flash_attention as tfa
from deepspeed_tpu_torch.ops.hopper import grouped_matmul as tgm
from deepspeed_tpu_torch.ops.hopper import mixed_gemm as tmg
from deepspeed_tpu_torch.ops.hopper import paged_attention as tpa

pytestmark = pytest.mark.cuda

# per dtype (atol, rtol): f32 differs from the plain version only in
# summation order; a bf16 output element may round one ulp (2**-7 of its
# size) the other way, an f16 one one ulp (2**-10 of its size: 2e-3 covers
# it where the element lies just under a power of two)
TOLERANCE = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-4, 1e-2),
             torch.float16: (1e-4, 2e-3)}
# the serving kernels' dtypes on the card
PAGED_DTYPES = dict(argvalues=[torch.float32, torch.bfloat16, torch.float16],
                    ids=["f32", "bf16", "f16"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, H, KV, D, BS, dtype, device):
    rng = np.random.default_rng(seed)
    S, NB, MB, Qp = 5, 48, 8, 40
    k = rng.standard_normal((NB, BS, KV, D)).astype(np.float32)
    v = rng.standard_normal((NB, BS, KV, D)).astype(np.float32)
    bt = rng.permutation(NB)[: S * MB].reshape(S, MB).astype(np.int32)
    q_dec = rng.standard_normal((S, H, D)).astype(np.float32)
    ctx = np.array([5, 0, 17, MB * BS, 1], np.int32)
    q_pre = rng.standard_normal((S, Qp, H, D)).astype(np.float32)
    start = np.array([0, 5, 13, 3, 64], np.int32)  # off the block grid
    length = np.array([Qp, 11, 0, 29, 1], np.int32)

    def dev(a, cast=True):
        t = torch.from_numpy(a).to(device)
        return t.to(dtype) if cast else t

    return ((dev(q_dec), dev(k), dev(v), dev(bt, False), dev(ctx, False)),
            (dev(q_pre), dev(k), dev(v), dev(bt, False), dev(start, False),
             dev(length, False)))


@pytest.mark.parametrize("dtype", **PAGED_DTYPES)
@pytest.mark.parametrize("H,KV,D", [(8, 8, 64), (8, 2, 128), (32, 8, 128),
                                    (8, 1, 64)])
def test_kernels_match_plain(cuda_device, dtype, H, KV, D):
    dec, pre = _inputs(0, H, KV, D, 16, dtype, cuda_device)
    atol, rtol = TOLERANCE[dtype]
    tpa.reset_counts()
    got = tpa.paged_decode_attention(*dec)
    want = tpa.decode_attention_plain(*dec)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    assert not got[1].any()  # ctx = 0
    got = tpa.paged_prefill_attention(*pre)
    want = tpa.prefill_attention_plain(*pre)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    for s, n in enumerate(pre[5].tolist()):
        assert not got[s, n:].any()  # padding rows and inactive tiles
    assert tpa.LAUNCHES == {"paged_decode_attention": 1,
                            "paged_prefill_attention": 1}


@pytest.mark.parametrize("dtype", **PAGED_DTYPES)
@pytest.mark.parametrize("H,KV,D", [(32, 8, 128), (8, 1, 64), (8, 8, 128)])
def test_split_kv_decode_matches_plain(cuda_device, dtype, H, KV, D):
    """Chains of 2048 positions (BS = 64, MB = 32: 16 splits of 128), at
    contexts on the split edges, a partial last split and the whole chain:
    one launch per call, ctx = 0 rows exactly zero."""
    gen = torch.Generator(device=cuda_device).manual_seed(H + D)
    S, BS, MB, NB = 9, 64, 32, 320
    split = tpa.decode_split(MB * BS)
    assert split == 128

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(dtype)

    kc, vc, q = rnd(NB, BS, KV, D), rnd(NB, BS, KV, D), rnd(S, H, D)
    bt = torch.randperm(NB, generator=gen, device=cuda_device)[:S * MB] \
        .reshape(S, MB).to(torch.int32)
    ctx = torch.tensor([0, 1, split - 1, split, split + 1, 700, 1500,
                        MB * BS - 1, MB * BS], dtype=torch.int32,
                       device=cuda_device)
    tpa.reset_counts()
    got = tpa.paged_decode_attention(q, kc, vc, bt, ctx)
    want = tpa.decode_attention_plain(q, kc, vc, bt, ctx)
    atol, rtol = TOLERANCE[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    assert not got[0].any()
    assert tpa.LAUNCHES["paged_decode_attention"] == 1


@pytest.mark.parametrize("dtype", **PAGED_DTYPES)
@pytest.mark.parametrize("BS", [8, 16, 64, 128])
@pytest.mark.parametrize("H,KV,D", [(8, 8, 64), (8, 4, 128), (32, 8, 128),
                                    (8, 1, 64)],
                         ids=["group1", "group2", "group4", "group8"])
def test_prefill_block_sizes_match_plain(cuda_device, dtype, BS, H, KV, D):
    """Chains of 2048 positions at block sizes below, at and above the bf16
    kernel's 64-key tile, 256-row chunks: a full chunk from 0, an empty
    one, one row on a tile edge, chunks crossing tiles and pages from
    starts off both grids, one ending at the chain's end.  One launch;
    padding rows exactly zero."""
    gen = torch.Generator(device=cuda_device).manual_seed(BS + H + D)
    S, Qp, MB = 6, 256, 2048 // BS
    NB = S * MB + 3

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(dtype)

    kc, vc, q = rnd(NB, BS, KV, D), rnd(NB, BS, KV, D), rnd(S, Qp, H, D)
    bt = torch.randperm(NB, generator=gen, device=cuda_device)[:S * MB] \
        .reshape(S, MB).to(torch.int32)
    start = torch.tensor([0, 0, 63, 1000, 1792, 5], dtype=torch.int32,
                         device=cuda_device)
    length = torch.tensor([256, 0, 1, 200, 256, 129], dtype=torch.int32,
                          device=cuda_device)
    tpa.reset_counts()
    got = tpa.paged_prefill_attention(q, kc, vc, bt, start, length)
    want = tpa.prefill_attention_plain(q, kc, vc, bt, start, length)
    atol, rtol = TOLERANCE[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    for s, n in enumerate(length.tolist()):
        assert not got[s, n:].any()
    assert tpa.LAUNCHES["paged_prefill_attention"] == 1


def test_decode_makes_no_host_sync(cuda_device):
    """A decode call waits on nothing: its split count and workspace follow
    from the shapes, never from context_lens."""
    dec, _ = _inputs(2, 32, 8, 128, 16, torch.bfloat16, cuda_device)
    tpa.paged_decode_attention(*dec)  # build, first launch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = tpa.paged_decode_attention(*dec)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.testing.assert_close(out.float(),
                               tpa.decode_attention_plain(*dec).float(),
                               atol=1e-4, rtol=1e-2)


def test_wrappers_raise_on_cuda_input_they_do_not_take(cuda_device):
    dec, pre = _inputs(1, 8, 2, 128, 16, torch.float64, cuda_device)
    with pytest.raises(TypeError, match="bfloat16, float16 or float32"):
        tpa.paged_decode_attention(*dec)
    dec, pre = _inputs(1, 8, 2, 128, 16, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        tpa.paged_prefill_attention(pre[0].transpose(0, 1), *pre[1:])
    with pytest.raises(ValueError, match="head dim"):
        tpa.paged_decode_attention(dec[0][..., :96].contiguous(),
                                   dec[1][..., :96].contiguous(),
                                   dec[2][..., :96].contiguous(), *dec[3:])


def test_engine_on_gpu_matches_cpu(cuda_device):
    """The same small f32 model (head dim 64, GQA) served through the CUDA
    kernels and through the plain versions gives the same greedy tokens."""
    cfg = tt.get_config("tiny", hidden_size=256, intermediate_size=512,
                        num_heads=4, num_kv_heads=2, dtype="float32")
    params = tt.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    v2 = te.V2Config(max_tokens_per_step=16, max_seqs=4, block_size=8,
                     num_blocks=64, max_blocks_per_seq=8, dtype="float32")
    prompts = [list(range(1, 6)), list(range(10, 50))]
    out = []
    for dev in (cuda_device, "cpu"):
        eng = te.InferenceEngineV2(cfg, params, v2, device=dev)
        uids = [eng.put(p, max_new_tokens=8) for p in prompts]
        tpa.reset_counts()
        res = eng.generate_all(burst=4)
        out.append([res[u] for u in uids])
        if dev != "cpu":
            assert tpa.PLAIN_CALLS == {"decode_attention_plain": 0,
                                       "prefill_attention_plain": 0}
            assert all(n > 0 for n in tpa.LAUNCHES.values())
    assert out[0] == out[1]


# flash attention: the mask options of one small case each, (S, H, KV)
# chosen so that tiles are ragged (S not a multiple of 64) and the GQA
# group splits a block's 64 query vectors unevenly (H/KV = 3)
FLASH_CASES = {
    "causal": dict(S=200, H=8, KV=2, mask=dict(causal=True)),
    "full": dict(S=130, H=4, KV=4, mask=dict(causal=False)),
    "window": dict(S=200, H=6, KV=2, mask=dict(causal=True, window=37)),
    "segments": dict(S=150, H=8, KV=8, mask=dict(causal=True,
                                                   segments=(40, 90))),
    "block_mask": dict(S=192, H=8, KV=1, mask=dict(causal=False,
                                                     block=(32, 48))),
    # the bf16 tensor-core kernels' tile edges: 128 query vectors and 64
    # keys per tile, so S and Skv off both grids, GQA groups of 1, 4 and 8,
    # a window ending mid-tile, fully masked rows under a block table, and
    # the training shape's heads at 2048 tokens
    "ragged_kv": dict(S=1000, Skv=2048 + 17, H=8, KV=1,
                      mask=dict(causal=False)),
    "ragged_causal_g1": dict(S=1000, H=4, KV=4, mask=dict(causal=True)),
    "window_mid_tile": dict(S=517, H=8, KV=2, mask=dict(causal=True,
                                                         window=100)),
    "block_mask_gqa": dict(S=600, H=8, KV=2, mask=dict(causal=True,
                                                       block=(64, 128))),
    "causal_2048": dict(S=2048, H=8, KV=2, mask=dict(causal=True)),
    "segments_gqa": dict(S=300, H=8, KV=2, mask=dict(causal=True,
                                                     segments=(100, 250))),
}


def _flash_inputs(seed, B, S, H, KV, D, dtype, device, mask, Skv=None):
    gen = torch.Generator(device=device).manual_seed(seed)
    Skv = S if Skv is None else Skv

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    q, k, v, do = rnd(B, S, H, D), rnd(B, Skv, KV, D), rnd(B, Skv, KV, D), \
        rnd(B, S, H, D)
    seg = bm = None
    bq = bk = 1024
    if "segments" in mask:
        ends = torch.tensor(mask["segments"], device=device)
        seg = torch.bucketize(torch.arange(S, device=device), ends,
                              right=True).to(torch.int32)
        seg = seg[None].repeat(B, 1).contiguous()
    if "block" in mask:
        bq, bk = mask["block"]
        nq, nk = -(-S // bq), -(-Skv // bk)
        bm = (torch.rand((nq, nk), generator=gen, device=device) < 0.5) \
            .to(torch.int32)
        bm[1] = 0  # rows bq..2bq-1 see nothing: o = 0, lse = -inf
        bm[0, 0] = 1
    am = tfa.AttnMask(mask.get("causal", True), mask.get("window", 0), seg,
                      bm, bq, bk)
    return q, k, v, do, am


def _close(got, want, dtype, what, scale=None):
    """f32: summation order only, 1e-4 of the tensor's largest magnitude
    (dq/dk/dv sum over up to S * H/KV rows); bf16: one output ulp (2**-7
    of an element's size) on top of that; f16: two output ulps (2e-3 of an
    element's size) and one ulp under f16's normal range (2**-24)."""
    want = want.float()
    if scale is None:
        scale = max(want.abs().max().item(), 1.0)
    rtol = {torch.float32: 0.0, torch.bfloat16: 1e-2,
            torch.float16: 2e-3}[dtype]
    atol = 1e-4 * scale + (2.0 ** -24 if dtype == torch.float16 else 0.0)
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol,
                               msg=what)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernels_match_plain(cuda_device, dtype, D, case):
    c = FLASH_CASES[case]
    q, k, v, do, am = _flash_inputs(0, 2, c["S"], c["H"], c["KV"], D, dtype,
                                    cuda_device, c["mask"], c.get("Skv"))
    scale = 1.0 / D ** 0.5
    tfa.reset_counts()
    o, lse = tfa.flash_fwd(q, k, v, am, scale)
    o_p, lse_p = tfa.flash_fwd_plain(q, k, v, am, scale)
    _close(o, o_p, dtype, "o")
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_p))
    fin = torch.isfinite(lse_p)
    torch.testing.assert_close(lse[fin], lse_p[fin], atol=1e-4, rtol=0)
    if "block" in c["mask"]:
        bq = c["mask"]["block"][0]
        assert torch.isinf(lse[:, :, bq:2 * bq]).all()
        assert not o[:, bq:2 * bq].any()
    delta = tfa.attention_delta(do, o_p)
    dk, dv = tfa.flash_bwd_dkdv(q, k, v, do, lse_p, delta, am, scale)
    dk_p, dv_p = tfa.flash_bwd_dkdv_plain(q, k, v, do, lse_p, delta, am,
                                          scale)
    _close(dk, dk_p, dtype, "dk")
    _close(dv, dv_p, dtype, "dv")
    dq = tfa.flash_bwd_dq(q, k, v, do, lse_p, delta, am, scale)
    _close(dq, tfa.flash_bwd_dq_plain(q, k, v, do, lse_p, delta, am, scale),
           dtype, "dq")
    assert tfa.LAUNCHES == {"flash_fwd": 1, "flash_bwd_dkdv": 1,
                            "flash_bwd_dq": 1}


def test_flash_autograd_on_gpu_matches_cpu(cuda_device):
    """The public op's gradients through the kernels equal those through
    the plain versions on the CPU (f32, GQA, causal, ragged S), also when
    ``torch.utils.checkpoint`` re-runs the forward."""
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(s, generator=gen) for s in
               ((2, 100, 8, 64), (2, 100, 2, 64), (2, 100, 2, 64)))
    grads = []
    for dev in (cuda_device, "cpu"):
        leaves = [t.to(dev).requires_grad_() for t in (q, k, v)]
        out = torch.utils.checkpoint.checkpoint(
            lambda a, b, c: tfa.flash_attention(a, b, c) ** 2, *leaves,
            use_reentrant=False)
        out.sum().backward()
        grads.append([t.grad.cpu() for t in leaves])
    for g, h in zip(*grads):
        torch.testing.assert_close(g, h, atol=1e-4 * h.abs().max().item(),
                                   rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", ["transposed", "fused_qkv",
                                    "misaligned"])
def test_flash_attention_takes_strided_inputs(cuda_device, dtype, layout):
    """The public op on views the wrappers refuse (a transposed q, q/k/v
    sliced from a fused QKV projection, a q off the 16-byte grid): output
    and gradients, of the views' shapes, equal those of contiguous copies
    on the card and match the plain path on the CPU."""
    B, S, H, KV, D = 2, 200, 8, 2, 128
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    qkv = torch.randn((B, S, H + 2 * KV, D), generator=gen,
                      device=cuda_device).to(dtype)
    q, k, v = qkv.split([H, KV, KV], dim=2)
    if layout == "transposed":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
        k, v = k.contiguous(), v.contiguous()
    elif layout == "misaligned":
        buf = torch.empty(q.numel() + 1, dtype=dtype, device=cuda_device)
        q = buf[1:].view(q.shape).copy_(q)
        k, v = k.contiguous(), v.contiguous()
    do = torch.randn((B, S, H, D), generator=gen, device=cuda_device) \
        .to(dtype)
    results = []
    for dev, copy in ((cuda_device, False), (cuda_device, True),
                      ("cpu", True)):
        leaves = [(t.contiguous() if copy else t).detach().to(dev)
                  .requires_grad_() for t in (q, k, v)]
        if not copy:
            assert leaves[0].stride() == q.stride()  # the view itself
            assert leaves[0].data_ptr() == q.data_ptr()
        tfa.reset_counts()
        o = tfa.flash_attention(*leaves)
        o.backward(do.to(dev))
        if dev != "cpu":
            assert tfa.LAUNCHES == {"flash_fwd": 1, "flash_bwd_dkdv": 1,
                                    "flash_bwd_dq": 1}
        results.append([o.detach().cpu()]
                       + [t.grad.cpu() for t in leaves])
    for name, got, same, want in zip(("o", "dq", "dk", "dv"), *results):
        assert got.shape == want.shape
        torch.testing.assert_close(got, same, atol=0, rtol=0)
        _close(got, want, dtype, name)


def test_flash_wrappers_raise_on_cuda_input_they_do_not_take(cuda_device):
    q, k, v, do, am = _flash_inputs(1, 1, 64, 4, 2, 64, torch.float64,
                                    cuda_device, {})
    with pytest.raises(TypeError, match="bfloat16, float16 or float32"):
        tfa.flash_fwd(q, k, v, am, 0.125)
    with pytest.raises(TypeError, match="bias_kv must be torch.float16 or "
                       "float32 for a torch.float16 forward"):
        tfa.flash_fwd(q.half(), k.half(), v.half(), am, 0.125,
                      bias_kv=torch.zeros((1, 64), dtype=torch.float64,
                                          device=cuda_device))
    q, k, v = q.float(), k.float(), v.float()
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_fwd(q[..., :48].contiguous(), k[..., :48].contiguous(),
                      v[..., :48].contiguous(), am, 0.125)
    with pytest.raises(ValueError, match="multiple of KV"):
        tfa.flash_fwd(q[:, :, :3].contiguous(), k, v, am, 0.125)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_fwd(q.transpose(1, 2).transpose(1, 2)[:, ::2], k[:, ::2],
                      v[:, ::2], am, 0.125)
    with pytest.raises(TypeError, match="int32"):
        tfa.flash_fwd(q, k, v, am._replace(segment_ids=torch.zeros(
            (1, 64), dtype=torch.int64, device=cuda_device)), 0.125)
    bias = torch.zeros((1, 64), device=cuda_device)
    with pytest.raises(ValueError, match="bias_kv must be"):
        tfa.flash_fwd(q, k, v, am, 0.125, bias_kv=bias[:, :32])
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_fwd(q, k, v, am, 0.125, bias_kv=torch.zeros(
            (1, 128), device=cuda_device)[:, ::2])
    with pytest.raises(ValueError, match="bias_qk must be"):
        tfa.flash_fwd(q, k, v, am, 0.125, bias_qk=torch.zeros(
            (1, 4, 64, 63), device=cuda_device))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        tfa.flash_fwd(q, k, v, am, 0.125, bias_kv=bias.half())
    with pytest.raises(ValueError, match="bias_kv is on"):
        tfa.flash_fwd(q, k, v, am, 0.125, bias_kv=bias.cpu())
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.flash_fwd(q, k, v, am, 0.125, bias_kv=torch.zeros(
            65, dtype=torch.bfloat16, device=cuda_device)[1:].view(1, 64))
    # contiguous, but 2 bytes off the 16-byte grid the bf16 kernels copy
    buf = torch.zeros(q.numel() + 1, dtype=torch.bfloat16,
                      device=cuda_device)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.flash_fwd(buf[1:].view(q.shape), k.bfloat16(), v.bfloat16(), am,
                      0.125)
    with pytest.raises(ValueError, match="f32"):
        tfa.flash_bwd_dq(q, k, v, q, torch.zeros((1, 4, 64),
                                                  device=cuda_device,
                                                  dtype=torch.bfloat16),
                         torch.zeros((1, 4, 64), device=cuda_device), am,
                         0.125)


# the forward's additive biases (the evoformer path): B = 4 flattened
# sequences of H = 4 heads; L = 20 and 100 put bf16 bias rows off the
# 16-byte grid (40 and 200 bytes), L = 37 puts f32 rows off it and bf16
# rows off the 4-byte grid (the narrow copies), L = 1000 leaves a ragged
# key tile and query block; batch 1's keys all sit at -1e9 (a padded MSA sequence) and
# batch 0 masks every third key so; bias_qk has B' = 2 (batch b reads
# bias_qk[b // 2])
BIAS_L = (20, 37, 100, 1000)
BIAS_LSE_RTOL = 1e-6  # lse at -1e9: the f32 spacing there is 64


def _bias_inputs(seed, B, L, H, KV, D, dtype, bias_dtype, device, b2_batch):
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, t=dtype):
        return torch.randn(shape, generator=gen, device=device).to(t)

    q, k, v = rnd(B, L, H, D), rnd(B, L, KV, D), rnd(B, L, KV, D)
    bias_kv = rnd(B, L, t=torch.float32)
    bias_kv[1] = -1e9
    bias_kv[0, ::3] = -1e9
    return q, k, v, bias_kv.to(bias_dtype), rnd(b2_batch, H, L, L,
                                                t=bias_dtype)


def _check_bias_fwd(q, k, v, am, bias_kv, bias_qk, dtype):
    scale = 1.0 / q.shape[-1] ** 0.5
    o, lse = tfa.flash_fwd(q, k, v, am, scale, bias_kv, bias_qk)
    o_p, lse_p = tfa.flash_fwd_plain(q, k, v, am, scale, bias_kv, bias_qk)
    _close(o, o_p, dtype, "o")
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_p))
    fin = torch.isfinite(lse_p)
    torch.testing.assert_close(lse[fin], lse_p[fin], atol=1e-4,
                               rtol=BIAS_LSE_RTOL)
    return o, o_p


@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16],
                         ids=["bias_f32", "bias_bf16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("L", BIAS_L)
def test_flash_fwd_bias_matches_plain(cuda_device, dtype, bias_dtype, D, L):
    B, H = 4, 4
    q, k, v, bias_kv, bias_qk = _bias_inputs(
        0, B, L, H, H, D, dtype, bias_dtype, cuda_device, 2)
    am = tfa.AttnMask(causal=False)
    tfa.reset_counts()
    for b1, b2 in ((bias_kv, bias_qk), (bias_kv, None), (None, bias_qk)):
        o, o_p = _check_bias_fwd(q, k, v, am, b1, b2, dtype)
        if b1 is not None:  # the padded sequence: o is the mean of V
            _close(o[1], v[1].float().mean(0, keepdim=True).expand_as(o[1]),
                   dtype, "padded row")
    assert tfa.LAUNCHES == {"flash_fwd": 3, "flash_bwd_dkdv": 0,
                            "flash_bwd_dq": 0}
    assert tfa.BIAS_LAUNCHES == {"flash_fwd_bias": 3}


@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.float16],
                         ids=["bias_f32", "bias_f16"])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("L", BIAS_L)
def test_flash_fwd_f16_bias_matches_plain(cuda_device, bias_dtype, D, L):
    """The f16 forward with its biases (f16 or f32; the bias unit's f16
    instantiations): a masked key sits at -1e4, OpenFold's mask value in
    low precision (-1e9 is -inf in f16), so the padded sequence's scores
    keep their q.k terms and its o is held to the plain version only."""
    B, H = 4, 4
    q, k, v, bias_kv, bias_qk = _bias_inputs(
        0, B, L, H, H, D, torch.float16, torch.float32, cuda_device, 2)
    bias_kv = bias_kv.clamp(min=-1e4).to(bias_dtype)
    bias_qk = bias_qk.to(bias_dtype)
    am = tfa.AttnMask(causal=False)
    tfa.reset_counts()
    for b1, b2 in ((bias_kv, bias_qk), (bias_kv, None), (None, bias_qk)):
        if b1 is None:
            _check_bias_fwd(q, k, v, am, b1, b2, torch.float16)
            continue
        # the padded sequence (batch 1): every score sits near -1e4, where
        # f32's spacing is 2**-10 on both sides, so each p carries a
        # relative error up to 1e4 * 2**-24 and o may move by twice that
        # times max |v|; the other sequences are held to the f16 limit
        scale = 1.0 / D ** 0.5
        o, lse = tfa.flash_fwd(q, k, v, am, scale, b1, b2)
        o_p, lse_p = tfa.flash_fwd_plain(q, k, v, am, scale, b1, b2)
        rest = [0, 2, 3]
        _close(o[rest], o_p[rest], torch.float16, "o")
        torch.testing.assert_close(
            o[1].float(), o_p[1].float(), rtol=2e-3,
            atol=2 * 1e4 * 2.0 ** -24 * v[1].float().abs().max().item(),
            msg="o of the padded sequence")
        torch.testing.assert_close(lse, lse_p, atol=1e-4,
                                   rtol=BIAS_LSE_RTOL)
    assert tfa.LAUNCHES == {"flash_fwd": 3, "flash_bwd_dkdv": 0,
                            "flash_bwd_dq": 0}
    assert tfa.BIAS_LAUNCHES == {"flash_fwd_bias": 3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["causal", "window_mid_tile",
                                  "block_mask_gqa", "segments_gqa"])
def test_flash_fwd_bias_under_masks_matches_plain(cuda_device, dtype, case):
    """Biases under every mask, GQA groups (a block's vectors span heads,
    so the bias_qk tile is gathered per vector) and bias_qk broadcast to
    the whole batch (B' = 1)."""
    c = FLASH_CASES[case]
    q, k, v, _, am = _flash_inputs(0, 2, c["S"], c["H"], c["KV"], 64, dtype,
                                   cuda_device, c["mask"])
    _, _, _, bias_kv, bias_qk = _bias_inputs(
        1, 2, c["S"], c["H"], c["KV"], 64, dtype, torch.bfloat16,
        cuda_device, 1)
    _check_bias_fwd(q, k, v, am, bias_kv, bias_qk, dtype)


def test_evoformer_on_gpu_matches_cpu(cuda_device):
    """evoformer_attention's forward through the bias kernel and its five
    gradients, against the same op on the CPU (plain forward), f32, with a
    padded MSA sequence and L off the 64-key grid."""
    B, N, L, H, D = 1, 3, 100, 4, 32
    gen = torch.Generator().manual_seed(4)
    q, k, v, g = (torch.randn((B, N, L, H, D), generator=gen)
                  for _ in range(4))
    b1 = torch.where(torch.rand((B, N, 1, 1, L), generator=gen) < 0.8,
                     0.0, -1e9)
    b1[:, 1] = -1e9
    b2 = torch.randn((B, 1, H, L, L), generator=gen)
    results = []
    for dev in (cuda_device, "cpu"):
        leaves = [t.to(dev).requires_grad_() for t in (q, k, v, b1, b2)]
        tfa.reset_counts()
        out = tev.evoformer_attention(*leaves[:3], leaves[3:])
        out.backward(g.to(dev))
        if dev != "cpu":
            assert tfa.BIAS_LAUNCHES == {"flash_fwd_bias": 1}
            assert not any(tfa.PLAIN_CALLS.values())
        results.append([out.detach().cpu()] + [t.grad.cpu() for t in leaves])
    for name, got, want in zip(("out", "dq", "dk", "dv", "db1", "db2"),
                               *results):
        _close(got, want, torch.float32, name)


def test_sparse_attention_on_gpu_matches_cpu(cuda_device):
    """sparse_attention with a causal Fixed layout through the flash
    kernels: output and gradients against the CPU's plain path (f32)."""
    cfg = tsa.FixedSparsityConfig(block=64, num_local_blocks=2,
                                  attention="unidirectional")
    gen = torch.Generator().manual_seed(6)
    q = torch.randn((1, 512, 8, 64), generator=gen)
    k, v = (torch.randn((1, 512, 2, 64), generator=gen) for _ in range(2))
    results = []
    for dev in (cuda_device, "cpu"):
        leaves = [t.to(dev).requires_grad_() for t in (q, k, v)]
        tfa.reset_counts()
        out = tsa.sparse_attention(*leaves, cfg)
        (out ** 2).sum().backward()
        if dev != "cpu":
            assert tfa.LAUNCHES == {"flash_fwd": 1, "flash_bwd_dkdv": 1,
                                    "flash_bwd_dq": 1}
        results.append([out.detach().cpu()] + [t.grad.cpu() for t in leaves])
    for name, got, want in zip(("o", "dq", "dk", "dv"), *results):
        _close(got, want, torch.float32, name)


# mixed GEMM: (K, group) with an odd group count; N = 96 leaves a ragged
# column tile; M spans the decode tile (M <= 16) and the larger one, ragged
MG_K, MG_GROUP = 768, 256


def _mixed_inputs(seed, M, K, N, bits, dtype, device, group=MG_GROUP):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((M, K), generator=gen, device=device).to(dtype)
    w = torch.randn((K, N), generator=gen, device=device) / K ** 0.5
    return x, tmg.quantize_gemm_weight(w, bits=bits, group=group)


def _mixed_close(got, want, dtype, what):
    """Both sides sum the same exact bf16 products in f32: f32 output,
    summation order only (1e-5 of the largest output; one dropped 256-row
    group moves outputs by ~50% of their size); bf16 output, one output ulp
    (2**-7 of an element's size) on top; f16 output, one f16 ulp (2e-3 of
    its size)."""
    want = want.float()
    rtol = TOLERANCE[dtype][1]
    torch.testing.assert_close(got.float(), want, rtol=rtol,
                               atol=1e-5 * want.abs().max().item(), msg=what)


def _mixed_launched(bits, M, dtype):
    """One launch, of the kernel that takes M rows and x's dtype:
    mixed_gemm_decode_kernel at M <= 16, the wgmma kernel for bf16 or f16
    x above."""
    name = tmg._KERNEL_NAMES[bits]
    assert tmg.LAUNCHES[name] == 1
    assert tmg.DECODE_LAUNCHES[name] == int(M <= 16)
    assert tmg.WGMMA_LAUNCHES[name] == int(dtype != torch.float32
                                           and M > 16)


@pytest.mark.parametrize("dtype", **PAGED_DTYPES)
@pytest.mark.parametrize("M", [1, 2, 8, 9, 15, 16, 17, 37, 64, 255, 256,
                               300])
@pytest.mark.parametrize("bits", [8, 4, 6])
def test_mixed_gemm_matches_plain(cuda_device, bits, M, dtype):
    """M <= 16 runs the decode kernel (one n8 tile of x rows up to M = 8,
    two above); bf16 or f16 x at M > 16 the wgmma kernel (TMA copies;
    128- and 256-row blocks, ragged last ones; f16 x rounded to bf16 by the
    same entry's pass first), f32 x at M > 16 the mma.sync kernel; N = 96
    leaves a ragged column block."""
    for N in (96, 1024):
        x, qw = _mixed_inputs(M + N, M, MG_K, N, bits, dtype, cuda_device)
        tmg.reset_counts()
        got = tmg.mixed_gemm(x, qw)
        want = tmg.mixed_gemm_plain(x, qw)
        assert got.dtype == dtype and got.shape == (M, N)
        _mixed_close(got, want, dtype, f"bits={bits} M={M} N={N}")
        _mixed_launched(bits, M, dtype)
        assert tmg.DEQUANT_CALLS["mixed_gemm"] == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("splits", [1, 3, 7])
@pytest.mark.parametrize("M", [2, 8, 9, 15, 16, 256])
def test_mixed_gemm_split_k_matches_plain(cuda_device, monkeypatch, M,
                                          splits, dtype):
    """Seven K-groups shared by 1, 3 (2 + 2 + 3) or 7 splits, both 2-byte
    kernels: the wgmma kernel's K-splits, and the decode kernel's blocks
    (8 tiles x splits blocks, each an equal share of the tiles' 112 steps:
    whole tiles, shares of 37 1/3 steps that straddle tiles, or 16), whose
    last block of a tile adds the shares' sums; the partial sums add up,
    and each call leaves the stream's tickets at zero for the next.  f16 x
    at M = 256 puts its bf16 copy in the workspace after the sums."""
    monkeypatch.setattr(tmg, "mixed_gemm_splits", lambda *a: splits)
    monkeypatch.setattr(tmg, "decode_blocks",
                        lambda M, N, *a: -(-N // 128) * splits)
    for bits in (8, 4, 6):
        x, qw = _mixed_inputs(splits + bits, M, 7 * MG_GROUP, 1024, bits,
                              dtype, cuda_device)
        tmg.reset_counts()
        _mixed_close(tmg.mixed_gemm(x, qw), tmg.mixed_gemm_plain(x, qw),
                     dtype, f"bits={bits} splits={splits}")
        _mixed_launched(bits, M, dtype)
    torch.cuda.synchronize()
    for buf in tmg._TICKETS.values():
        assert not buf.any().item()


def test_mixed_gemm_split_k_from_two_threads(cuda_device):
    """Two threads (two in-process replicas' broker threads) launch split-K
    decode GEMMs (M = 8, seven K-groups) on the one default stream, each at
    its own N: every call's partial sums stay its own, and a call never
    writes a buffer that another call has let go."""
    import threading

    cases = [_mixed_inputs(seed, 8, 7 * MG_GROUP, N, 8, torch.bfloat16,
                           cuda_device)
             for seed, N in ((1, 1024), (2, 3072))]
    # more blocks than tiles: every call adds shared tiles through the
    # stream's tickets and its own workspace
    assert all(tmg.decode_blocks(8, qw.out_features, 7 * MG_GROUP, MG_GROUP,
                                 tmg._sm_count(cuda_device))
               > qw.out_features // 128 for _, qw in cases)
    wants = [tmg.mixed_gemm_plain(x, qw) for x, qw in cases]
    outs = [[], []]
    start = threading.Barrier(2)

    def run(i):
        x, qw = cases[i]
        start.wait()
        for _ in range(200):
            outs[i].append(tmg.mixed_gemm(x, qw))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    for i, want in enumerate(wants):
        assert len(outs[i]) == 200
        for j, got in enumerate(outs[i]):
            _mixed_close(got, want, torch.bfloat16, f"thread {i} call {j}")


@pytest.mark.parametrize("dtype", **PAGED_DTYPES)
@pytest.mark.parametrize("bits,K,N", [(8, 99, 33), (4, 200, 50),
                                      (6, 96, 40), (8, 96, 64),
                                      (4, 96, 64)],
                         ids=["int8_k99", "int4_k200", "fp6_k96", "int8_k96",
                              "int4_k96"])
def test_mixed_gemm_unaligned_shapes_match_plain(cuda_device, bits, K, N,
                                                 dtype):
    """One group of K rows (group == K, so the reference's kernel path):
    rows and columns not 16-byte aligned (the decode kernel loads their
    codes byte by byte, x by elements at odd K), or aligned with a group
    that 64-deep K-tiles do not divide (the wgmma kernel's threads copy
    these, not TMA), a partial last K tile (K-step at the decode rows).
    M = 41 also from an x one element past a 16-byte boundary (f16 x: the
    rounding pass's element-wise path, and a tail past its 8-wide chunks)."""
    for M in (2, 5, 9, 15, 16, 40, 41):
        x, qw = _mixed_inputs(K + M, M, K, N, bits, dtype, cuda_device)
        assert tmg.mixed_gemm_on_kernel_path(qw) and qw.group == K
        xs = [x]
        if M == 41:
            xs.append(torch.empty(x.numel() + 1, dtype=dtype,
                                  device=cuda_device)[1:].view(x.shape))
            xs[1].copy_(x)
        for xi in xs:
            tmg.reset_counts()
            _mixed_close(tmg.mixed_gemm(xi, qw), tmg.mixed_gemm_plain(x, qw),
                         dtype, f"bits={bits} K={K} M={M}")
            _mixed_launched(bits, M, dtype)


def test_mixed_gemm_split_k_on_two_streams(cuda_device):
    """Split-K decode GEMMs on two streams at once (each stream its own
    tickets): 100 calls on each, queued in turns so that the two streams'
    kernels overlap, every output against plain; then both streams'
    tickets are back at zero."""
    cases = [_mixed_inputs(seed, 8, 7 * MG_GROUP, N, bits, torch.bfloat16,
                           cuda_device)
             for seed, N, bits in ((3, 1024, 8), (4, 2048, 6))]
    wants = [tmg.mixed_gemm_plain(x, qw) for x, qw in cases]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(100):
        for i, (x, qw) in enumerate(cases):
            with torch.cuda.stream(streams[i]):
                outs[i].append(tmg.mixed_gemm(x, qw))
    torch.cuda.synchronize()
    keys = {(cuda_device.index or 0, s.cuda_stream) for s in streams}
    assert keys <= set(tmg._TICKETS)
    for key in keys:
        assert not tmg._TICKETS[key].any().item()
    for i, want in enumerate(wants):
        for j, got in enumerate(outs[i]):
            _mixed_close(got, want, torch.bfloat16, f"stream {i} call {j}")


@pytest.mark.parametrize("dtype", **PAGED_DTYPES)
@pytest.mark.parametrize("M", [1, 8, 37, 256])
def test_int8_gemm_matches_plain_exactly(cuda_device, M, dtype):
    """The kernel sums each group's int8 products exactly and rescales
    with the plain version's unfused f32 operations, in its order: the two
    agree to the bit."""
    for N in (96, 1024):
        x, qw = _mixed_inputs(M + N + 1, M, MG_K, N, 8, dtype, cuda_device)
        tmg.reset_counts()
        got = tmg.int8_gemm(x, qw)
        torch.testing.assert_close(got, tmg.int8_gemm_plain(x, qw), atol=0,
                                   rtol=0)
        assert tmg.LAUNCHES["int8_gemm"] == 1


@pytest.mark.parametrize("dtype", **PAGED_DTYPES)
@pytest.mark.parametrize("M", [8, 16, 17, 64, 256, 300])
def test_int8_kernels_bit_exact_and_dispatched(cuda_device, M, dtype):
    """int8_gemm_mma_kernel (M <= 16, and N off TMA's 16-byte rows) and
    int8_gemm_wgmma_kernel (M > 16: 128-row blocks, or 256-row blocks where
    they fill the SMs, N = 8448 at M > 128; a ragged last one at M = 300)
    against the plain version to the bit; the counters name the kernel that
    ran."""
    for N in (96, 1024, 40, 8448):
        x, qw = _mixed_inputs(M + N + 2, M, MG_K, N, 8, dtype, cuda_device)
        assert tmg.int8_gemm_on_kernel_path(qw)
        tmg.reset_counts()
        got = tmg.int8_gemm(x, qw)
        torch.testing.assert_close(got, tmg.int8_gemm_plain(x, qw), atol=0,
                                   rtol=0, msg=f"M={M} N={N}")
        wgmma = M > 16 and N % 16 == 0
        assert tmg.LAUNCHES["int8_gemm"] == 1
        assert tmg.WGMMA_LAUNCHES["int8_gemm"] == int(wgmma)
        xc, xs = tmg.quantize_activations_rowwise(x, qw.group)
        assert tmg.int8_uses_wgmma(xc, qw) == wgmma
        # x codes off the 16-byte grid go to the mma.sync kernel, as exact
        shifted = torch.empty(xc.numel() + 1, dtype=torch.int8,
                              device=cuda_device)[1:].view(xc.shape)
        shifted.copy_(xc)
        tmg.reset_counts()
        torch.testing.assert_close(
            tmg.int8_gemm_quantized(shifted, xs, qw, dtype),
            tmg.int8_gemm_quantized_plain(xc, xs, qw, dtype), atol=0, rtol=0)
        assert tmg.WGMMA_LAUNCHES["int8_gemm"] == 0


@pytest.mark.parametrize("group", [128, 512])
@pytest.mark.parametrize("M", [8, 256])
def test_int8_kernels_bit_exact_at_other_groups(cuda_device, M, group):
    """Groups of one K-tile (128) and of four (512, whose s32 sums can pass
    2**22 and take cvt.rn rather than the exact magic-number conversion)."""
    x, qw = _mixed_inputs(M + group, M, 1024, 1024, 8, torch.bfloat16,
                          cuda_device, group=group)
    assert qw.group == group and tmg.int8_gemm_on_kernel_path(qw)
    torch.testing.assert_close(tmg.int8_gemm(x, qw),
                               tmg.int8_gemm_plain(x, qw), atol=0, rtol=0)


def test_int8_kernels_raise_on_groups_they_do_not_take(cuda_device):
    """The W8A8 kernels walk 128-deep K-tiles inside one group: a group of
    64 (off the reference's W8A8 envelope, which int8_gemm serves with the
    dequantize formula) is refused by the kernel entry, not run."""
    x, qw = _mixed_inputs(3, 32, 256, 128, 8, torch.bfloat16, cuda_device,
                          group=64)
    assert not tmg.int8_gemm_on_kernel_path(qw)
    xc, xs = tmg.quantize_activations_rowwise(x, qw.group)
    with pytest.raises(ValueError, match="multiple of 128"):
        tmg.int8_gemm_quantized(xc, xs, qw, torch.bfloat16)
    tmg.reset_counts()
    tmg.int8_gemm(x, qw)
    assert tmg.DEQUANT_CALLS["int8_gemm"] == 1
    assert tmg.LAUNCHES["int8_gemm"] == 0


def test_mixed_gemm_wrappers_raise_on_cuda_input_they_do_not_take(
        cuda_device):
    x, qw = _mixed_inputs(0, 8, 512, 128, 4, torch.float32, cuda_device)
    with pytest.raises(TypeError, match="bfloat16, float16 or float32"):
        tmg.mixed_gemm(x.double(), qw)
    with pytest.raises(ValueError, match="contiguous"):
        tmg.mixed_gemm(x.t().contiguous().t(), qw)
    with pytest.raises(TypeError, match="codes"):
        tmg.mixed_gemm(x, tmg.QuantizedWeight(qw.codes.view(torch.uint8),
                                              qw.scales, 4, 256, 512))
    with pytest.raises(ValueError, match="x K=256"):
        tmg.mixed_gemm(x[:, :256].contiguous(), qw)
    with pytest.raises(ValueError, match="bits must be"):
        tmg.mixed_gemm(x, tmg.QuantizedWeight(qw.codes, qw.scales, 5, 256,
                                              512))
    _, qw8 = _mixed_inputs(1, 8, 512, 128, 8, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        tmg.int8_gemm(x.t().contiguous().t(), qw8)
    with pytest.raises(ValueError, match="bits=8"):
        tmg.int8_gemm(x, qw)


@pytest.mark.parametrize("bits", [8, 4, 6])
def test_quantized_engine_on_gpu_matches_cpu(cuda_device, bits):
    """A small quantized f32 model served through the mixed GEMM kernel and
    through its plain version on the CPU gives the same greedy tokens."""
    cfg = tt.get_config("tiny", hidden_size=256, intermediate_size=512,
                        num_heads=4, num_kv_heads=2, dtype="float32")
    params = tt.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    v2 = te.V2Config(max_tokens_per_step=16, max_seqs=4, block_size=8,
                     num_blocks=64, max_blocks_per_seq=8, dtype="float32",
                     quantize_bits=bits)
    prompts = [list(range(1, 6)), list(range(10, 50))]
    out = []
    for dev in (cuda_device, "cpu"):
        eng = te.InferenceEngineV2(cfg, params, v2, device=dev)
        uids = [eng.put(p, max_new_tokens=8) for p in prompts]
        tmg.reset_counts()
        res = eng.generate_all(burst=4)
        out.append([res[u] for u in uids])
        if dev != "cpu":
            assert sum(tmg.LAUNCHES.values()) > 0
            assert not any(tmg.PLAIN_CALLS.values())
            assert not any(tmg.DEQUANT_CALLS.values())
    assert out[0] == out[1]


# grouped matmul: a layout of T assignments over E experts (one expert left
# empty) with its all-padding tail; K and N off the 64-wide tiles
def _gmm_problem(seed, T, E, K, N, tile_m, dtype, device, transposed=False):
    gen = torch.Generator(device=device).manual_seed(seed)
    ef = torch.randint(0, E, (T,), generator=gen, device=device)
    ef[ef == 1] = 0
    pos, tgroup, sizes, M_pad, used = tgm.tile_aligned_layout(
        ef, E, T, tile_m, with_used_tiles=True)
    lhs = torch.zeros((M_pad, K), device=device, dtype=dtype)
    lhs[pos.long()] = torch.randn((T, K), generator=gen,
                                  device=device).to(dtype)
    shape = (E, N, K) if transposed else (E, K, N)
    rhs = (torch.randn(shape, generator=gen, device=device)
           / K ** 0.5).to(dtype)
    return lhs, rhs, tgroup, sizes, used


@pytest.mark.parametrize("dtype", **PAGED_DTYPES)
@pytest.mark.parametrize("tile_m", [16, 64, 48])
@pytest.mark.parametrize("transposed", [False, True], ids=["nk", "kn_t"])
def test_grouped_matmul_matches_plain(cuda_device, dtype, tile_m,
                                      transposed):
    """Every tile against the plain version; the tiles past the used count
    are zeros written without reading weights (their rows are zero)."""
    for T, K, N in ((16, 200, 136), (300, 512, 72)):
        lhs, rhs, tgroup, sizes, used = _gmm_problem(
            T + tile_m, T, 4, K, N, tile_m, dtype, cuda_device, transposed)
        tgm.reset_counts()
        got = tgm.grouped_matmul(lhs, rhs, tgroup, sizes, tile_m=tile_m,
                                 num_used_tiles=used,
                                 rhs_transposed=transposed)
        want = tgm.grouped_matmul_plain(lhs, rhs, tgroup, tile_m,
                                        rhs_transposed=transposed)
        assert got.dtype == dtype and got.shape == want.shape
        _mixed_close(got, want, dtype, f"T={T} tile_m={tile_m}")
        assert not got[int(used.item()) * tile_m:].any()
        assert tgm.LAUNCHES == {"grouped_matmul": 1}
        assert tgm.WGMMA_LAUNCHES == {"grouped_matmul": int(
            tgm.uses_wgmma(dtype, tile_m, transposed))}
        # without a used count every tile is computed: the same numbers
        torch.testing.assert_close(
            tgm.grouped_matmul(lhs, rhs, tgroup, sizes, tile_m=tile_m,
                               rhs_transposed=transposed), got,
            rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("tile_m", [64, 128])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_grouped_matmul_wgmma_matches_plain(cuda_device, seed, tile_m,
                                            dtype):
    """grouped_matmul_wgmma_kernel at random routings: one expert of more
    than 256 rows (two chunks), an empty expert, K and N off the 64-deep
    K-tiles and 128-wide column blocks; within an output ulp of the plain
    version, the all-padding tail zero, the same numbers without a used
    count (the last expert then also walks the zero tail)."""
    gen = torch.Generator(device=cuda_device).manual_seed(seed)
    E, K, N = 4, 200, 136
    for T in (600, 40):
        ef = torch.randint(0, E, (T,), generator=gen, device=cuda_device)
        ef[: T // 2] = seed % E  # the heavy expert
        ef[ef == (seed + 1) % E] = (seed + 2) % E  # an empty expert
        pos, tgroup, sizes, M_pad, used = tgm.tile_aligned_layout(
            ef, E, T, tile_m, with_used_tiles=True)
        lhs = torch.zeros((M_pad, K), device=cuda_device, dtype=dtype)
        lhs[pos.long()] = torch.randn((T, K), generator=gen,
                                      device=cuda_device).to(dtype)
        rhs = (torch.randn((E, K, N), generator=gen, device=cuda_device)
               / K ** 0.5).to(dtype)
        tgm.reset_counts()
        got = tgm.grouped_matmul(lhs, rhs, tgroup, sizes, tile_m=tile_m,
                                 num_used_tiles=used)
        want = tgm.grouped_matmul_plain(lhs, rhs, tgroup, tile_m)
        _mixed_close(got, want, dtype, f"T={T} seed={seed}")
        assert not got[int(used.item()) * tile_m:].any()
        assert tgm.LAUNCHES == {"grouped_matmul": 1}
        assert tgm.WGMMA_LAUNCHES == {"grouped_matmul": 1}
        torch.testing.assert_close(
            tgm.grouped_matmul(lhs, rhs, tgroup, sizes, tile_m=tile_m), got,
            rtol=0, atol=0)


def test_grouped_matmul_wrapper_raises_on_cuda_input_it_does_not_take(
        cuda_device):
    lhs, rhs, tgroup, sizes, _ = _gmm_problem(0, 16, 4, 64, 64, 16,
                                              torch.bfloat16, cuda_device)
    with pytest.raises(TypeError, match="bfloat16, float16 or float32"):
        tgm.grouped_matmul(lhs.double(), rhs.double(), tgroup, sizes,
                           tile_m=16)
    with pytest.raises(ValueError, match="multiples of 8"):
        tgm.grouped_matmul(lhs[:, :60].contiguous(),
                           rhs[:, :60].contiguous(), tgroup, sizes,
                           tile_m=16)
    with pytest.raises(ValueError, match="int32"):
        tgm.grouped_matmul(lhs, rhs, tgroup.long(), sizes, tile_m=16)
    with pytest.raises(ValueError, match="multiple of 16"):
        tgm.grouped_matmul(lhs, rhs, torch.cat([tgroup, tgroup]), sizes,
                           tile_m=8)
    # the wgmma kernel's TMA copies want 16-byte aligned rows
    wide, wrhs, wtg, wsizes, _ = _gmm_problem(1, 16, 4, 64, 64, 64,
                                              torch.bfloat16, cuda_device)
    off = torch.empty(wide.numel() + 1, dtype=torch.bfloat16,
                      device=cuda_device)[1:].view(wide.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tgm.grouped_matmul(off, wrhs, wtg, wsizes, tile_m=64)


@pytest.mark.parametrize("routing", ["dropless", "capacity"])
def test_moe_block_and_grads_on_gpu_match_cpu(cuda_device, routing):
    """tiny-moe's MoE block forward and backward, f32: on the card the
    grouped GEMM runs forward and, on the transposed weights, for dlhs."""
    cfg = tt.get_config("tiny-moe", dtype="float32", moe_routing=routing)
    params = tt.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu", dtype=torch.float32)
    lp = tt.layer_params(params, 0)["moe"]
    x = torch.randn((2, 24, 64), generator=torch.Generator().manual_seed(1))
    out = []
    for dev in (cuda_device, "cpu"):
        p = {k: v.to(dev).requires_grad_() for k, v in lp.items()}
        xd = x.to(dev).requires_grad_()
        tgm.reset_counts()
        y, aux, z = tml.moe_block_with_losses(xd, p, cfg)
        (y.square().sum() + aux + z).backward()
        if dev != "cpu" and routing == "dropless":
            assert tgm.LAUNCHES == {"grouped_matmul": 6}  # 3 fwd, 3 dlhs
            assert tgm.PLAIN_CALLS == {"grouped_matmul_plain": 0}
        out.append([y.detach().cpu(), xd.grad.cpu()]
                   + [p[k].grad.cpu() for k in sorted(p)])
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * b.abs().max().item())


@pytest.mark.parametrize("routing", ["dropless", "capacity"])
def test_moe_engine_on_gpu_matches_cpu(cuda_device, routing):
    cfg = tt.get_config("tiny-moe", hidden_size=256, intermediate_size=512,
                        num_kv_heads=2, dtype="float32", moe_routing=routing)
    params = tt.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    v2 = te.V2Config(max_tokens_per_step=16, max_seqs=4, block_size=8,
                     num_blocks=64, max_blocks_per_seq=8, dtype="float32")
    prompts = [list(range(1, 6)), list(range(10, 50))]
    out = []
    for dev in (cuda_device, "cpu"):
        eng = te.InferenceEngineV2(cfg, params, v2, device=dev)
        uids = [eng.put(p, max_new_tokens=8) for p in prompts]
        tgm.reset_counts()
        res = eng.generate_all(burst=4)
        out.append([res[u] for u in uids])
        if dev != "cpu" and routing == "dropless":
            assert tgm.LAUNCHES["grouped_matmul"] > 0
            assert tgm.PLAIN_CALLS == {"grouped_matmul_plain": 0}
    assert out[0] == out[1]


def test_dropless_decode_makes_no_host_sync(cuda_device):
    cfg = tt.get_config("tiny-moe", dtype="bfloat16", moe_routing="dropless")
    params = tt.init_params(cfg, torch.Generator(
        device=cuda_device).manual_seed(0), device=cuda_device)
    lp = tt.layer_params(params, 0)["moe"]
    x = torch.randn((1, 8, 64), device=cuda_device, dtype=torch.bfloat16)
    tdl.dropless_moe_block_with_losses(x, lp, cfg)  # build, first launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, _, _ = tdl.dropless_moe_block_with_losses(x, lp, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(y).all()


@pytest.mark.parametrize("p_dtype,g_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.bfloat16),
    (torch.float16, torch.float32), (torch.float32, torch.float16),
    (torch.float16, torch.float16)])
@pytest.mark.parametrize("n,offset", [(1, 0), (4099, 0), (70001, 1)],
                         ids=["one", "ragged", "misaligned"])
def test_fused_adamw_matches_plain(cuda_device, p_dtype, g_dtype, n,
                                   offset):
    """Both sides round every f32 operation once in the same order: within
    1e-6 of each tensor's largest element (b ** step may differ by an ulp
    between powf and torch's pow).  An offset of one element makes the
    pointers misaligned for 16-byte loads."""
    gen = torch.Generator(device=cuda_device).manual_seed(n)

    def rnd(dtype, scale=1.0):
        t = torch.randn(n + offset, generator=gen, device=cuda_device)
        return (t.abs() * scale if scale < 1 else t).to(dtype)[offset:]

    p, g = rnd(p_dtype), rnd(g_dtype)
    m, v = rnd(torch.float32), rnd(torch.float32, 0.1)
    step = torch.tensor(3, dtype=torch.int32, device=cuda_device)
    tfo.reset_counts()
    got = tfo.fused_adamw_flat(p, g, m, v, step, lr=1e-2, weight_decay=0.1)
    want = tfo.adamw_plain(p, g, m, v, step, lr=1e-2, weight_decay=0.1)
    assert tfo.LAUNCHES == {"fused_adamw": 1}
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        # f16 p: an f32 p' one ulp apart may round to the other f16
        # neighbour (one f16 ulp, 2**-10 of its size)
        torch.testing.assert_close(
            a.float(), b.float(), rtol=2e-3 if a.dtype == torch.float16
            else 0, atol=1e-6 * b.float().abs().max().item())


def test_fused_adamw_tree_one_launch(cuda_device):
    cfg = tt.get_config("tiny-moe", dtype="float32")
    params = tt.init_params(cfg, torch.Generator(
        device=cuda_device).manual_seed(0), device=cuda_device,
        dtype=torch.float32)
    state = tfo.init_fused_adam_state(params)
    tfo.reset_counts()
    new, state = tfo.fused_adamw_tree(params, params, state, lr=1e-3)
    new, state = tfo.fused_adamw_tree(new, params, state, lr=1e-3)
    assert tfo.LAUNCHES == {"fused_adamw": 2}
    assert tfo.PLAIN_CALLS == {"adamw_plain": 0}
    assert int(state.step) == 2
    assert new.keys() == params.keys()
    w, w0 = new["layers"]["moe"]["w_in"], params["layers"]["moe"]["w_in"]
    assert w.shape == w0.shape and torch.isfinite(w).all()
    assert not torch.equal(w, w0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_memory_hierarchy_five_stages(cuda_device, dtype):
    """``chip_smoke.py``'s hierarchy phase at a small width: cold, hits
    (copy-on-write), pressure into the host pool and the cold store,
    promotion from both, restart rehydration.  The phase itself fails on
    a broken check (counters, tier identity, bitwise blocks, prefilled
    tokens, spans, first-token logits against a cache-off engine)."""
    import chip_smoke

    cfg = tt.get_config("tiny", hidden_size=256, intermediate_size=512,
                        num_heads=4, num_kv_heads=2, dtype=dtype)
    params = tt.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    out = chip_smoke.run_hierarchy_phase(torch, tpa, params, "test",
                                         cfg=cfg, device="cuda",
                                         dtype=dtype)
    assert all(v > 0 for v in out["counters"].values())
    assert all(v > 0 for v in out["launches"].values())
    assert out["tiers"]["return"].count("host") > 0
    assert out["tiers"]["return"].count("cold") > 0
    assert out["prefilled_tokens"]["hits"] == [17, 100, 500, 30, 30, 30, 30]
    if dtype == "float32":
        assert out["identical_continuations"] == "9 of 9"


@pytest.mark.parametrize("dtype", **PAGED_DTYPES)
@pytest.mark.parametrize("D,Qp", [(64, 40), (64, 256), (128, 5)],
                         ids=["draft_d64", "draft_d64_qp256", "verify_qp5"])
def test_paged_kernels_at_draft_and_verify_shapes(cuda_device, dtype, D, Qp):
    """The paged kernels at the draft model's head dim (H = 32, KV = 8, D =
    64: its decode bodies and mirror prefills) and the prefill kernel at a
    verify's k + 1 = 5 positions per row (D = 128), each against its plain
    version."""
    rng = np.random.default_rng(D + Qp)
    H, KV, BS, S, NB, MB = 32, 8, 64, 4, 40, 8
    atol, rtol = TOLERANCE[dtype]

    def dev(a, cast=True):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
        return t.to(dtype) if cast else t

    k = dev(rng.standard_normal((NB, BS, KV, D)).astype(np.float32))
    v = dev(rng.standard_normal((NB, BS, KV, D)).astype(np.float32))
    bt = dev(rng.permutation(NB)[: S * MB].reshape(S, MB).astype(np.int32),
             False)
    ctx = dev(np.array([1, 64, 300, MB * BS], np.int32), False)
    q = dev(rng.standard_normal((S, H, D)).astype(np.float32))
    torch.testing.assert_close(
        tpa.paged_decode_attention(q, k, v, bt, ctx).float(),
        tpa.decode_attention_plain(q, k, v, bt, ctx).float(), atol=atol,
        rtol=rtol)
    start = dev(np.array([0, 63, 250, MB * BS - Qp], np.int32), False)
    length = dev(np.array([Qp, Qp, 2, Qp], np.int32), False)
    q = dev(rng.standard_normal((S, Qp, H, D)).astype(np.float32))
    tpa.reset_counts()
    got = tpa.paged_prefill_attention(q, k, v, bt, start, length)
    torch.testing.assert_close(
        got.float(),
        tpa.prefill_attention_plain(q, k, v, bt, start, length).float(),
        atol=atol, rtol=rtol)
    assert not got[2, 2:].any()  # rows past the chunk stay zero
    assert tpa.LAUNCHES_BY_HEAD_DIM["paged_prefill_attention", D] == 1


def test_spec_and_adapter_phase_small(cuda_device):
    """``chip_smoke.py``'s speculative and adapter phase at a small width
    in bf16 (target head dim 128, draft head dim 64): exact paged launch
    counts by head dim in both modes, no plain call, no host sync in a
    greedy speculative step, first-token and first-steady-step logits
    against the plain engine (slot-0 rows' first token bit for bit),
    adapter rows against merged-weight engines.  The phase fails on a
    broken check."""
    import chip_smoke

    cfg = tt.get_config("tiny", hidden_size=512, intermediate_size=1024,
                        num_heads=4, num_kv_heads=2, dtype="bfloat16",
                        vocab_size=1024)
    params = tt.init_params(cfg, torch.Generator(
        device=cuda_device).manual_seed(0), device=cuda_device)
    out = chip_smoke.run_spec_phase(
        torch, tpa, params, "test", cfg=cfg,
        draft_shape=dict(hidden_size=256, intermediate_size=512,
                         num_layers=1, tie_embeddings=True))
    assert out["draft"]["spec_steps"] > 0
    assert out["self_draft"]["spec_steps"] > 0
    assert out["adapters_self_draft"]["spec_steps"] > 0


def test_small_model_speculative_card_matches_cpu(cuda_device):
    """``chip_smoke.py``'s small f32 speculative check: both modes and
    self-draft with adapters, tokens identical card vs CPU vs the plain
    engine, and the model as its own draft accepting every draft its
    budget allows."""
    import chip_smoke

    out = chip_smoke.small_spec_agreement(torch, tpa)
    assert set(out) == {"draft", "self_draft", "self_draft_adapters"}


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_v1_quantized_launch_counts(cuda_device, dtype):
    """``chip_smoke.py``'s v1 W8A16 gate at a small width, bf16 and fp16:
    one quantized ``generate`` launches the mixed GEMM once per projection,
    layer and forward, the prefill (M = B * T) on
    ``mixed_gemm_wgmma_kernel``, the decodes (M = B) on
    ``mixed_gemm_decode_kernel``, with no plain or envelope call; tokens in
    the vocab, a second run equal."""
    import chip_smoke

    cfg = tt.get_config("tiny", hidden_size=256, intermediate_size=512,
                        num_heads=4, num_kv_heads=2, dtype=dtype,
                        vocab_size=1024)
    params = tt.init_params(cfg, torch.Generator(
        device=cuda_device).manual_seed(0), device=cuda_device)
    icfg = {"dtype": dtype, "quantize_bits": 8,
            "max_seq_len": chip_smoke.V1_PROMPT + chip_smoke.NEW_TOKENS}
    _, _, toks, _, counts = chip_smoke.v1_run(
        torch, cfg, params, icfg, chip_smoke.v1_prompts(cfg.vocab_size),
        "v1 W8A16 (small)", kernels=[tmg])
    got = chip_smoke.v1_quantized_counts(counts, cfg, "v1 W8A16 (small)")
    assert got["mixed_gemm_wgmma"] == chip_smoke.PROJECTIONS * cfg.num_layers
    assert got["mixed_gemm_decode"] == chip_smoke.PROJECTIONS * \
        cfg.num_layers * (chip_smoke.NEW_TOKENS - 1)
    assert toks.shape[1] == chip_smoke.V1_PROMPT + chip_smoke.NEW_TOKENS


def test_fp16_engines_small(cuda_device):
    """``chip_smoke.py``'s fp16 serving phase at a small width (head dim 64,
    GQA; a small dropless MoE): fp16 plain, W8A16, W4A16 and W6A16 v2
    engines with exact B4/B5/B6 launches and first-token logits against an
    f32 engine's, W8A8 with f16 output on one layer, the v1 engine fp16
    W8A16 against v2, and dropless MoE fp16 with exact B8 launches."""
    import chip_smoke

    small = dict(hidden_size=256, intermediate_size=512, num_heads=4,
                 num_kv_heads=2, dtype="float16")
    cfg = tt.get_config("tiny", vocab_size=1024, **small)
    moe = tt.get_config("tiny-moe", moe_routing="dropless", **small)
    # 64 tokens a mixed step route 128 assignments over 4 experts: tile_m
    # 64, the wgmma kernel, as Mixtral's 256-token steps
    v2 = te.V2Config(max_tokens_per_step=64, max_seqs=4, block_size=16,
                     num_blocks=64, max_blocks_per_seq=8, dtype="float16")
    out = chip_smoke.run_fp16_engines(
        torch, tpa, tmg, tgm, "card", cfg=cfg, moe_cfg=moe,
        prompt_lens=(5, 40, 17, 70), v1_shape=(4, 24), v2=v2)
    for key in ("fp16", "fp16_w8a16"):
        assert out[key]["first_logits_rel_vs_f32"] <= \
            chip_smoke.TOL_LOGITS_F16_QUANT_REL
    assert out["fp16_w8a16"]["launches"]["mixed_gemm_int8_wgmma"] > 0
    assert out["fp16_dropless_moe"]["launches"]["grouped_matmul_wgmma"] > 0
    assert out["int8_gemm_path_f16"]["launches"] == 2 * chip_smoke.PROJECTIONS


def test_small_f16_models_and_adam_path_card_match_cpu(cuda_device):
    """``chip_smoke.py``'s small f16 checks: plain, W8A16 and dropless MoE
    f16 models card vs CPU (first-step logits within
    TOL_LOGITS_F16_REL), and ``fused_adamw_flat`` on f16 parameters, one
    launch a step, card vs CPU."""
    import chip_smoke

    out = chip_smoke.small_f16_agreement(torch, tpa, tmg, tgm)
    assert set(out) == {"plain", "w8a16", "dropless_moe"}
    path = chip_smoke.fused_adam_f16_path(torch, tfo, tt)
    assert path["launches"] == 3


def test_v1_small_models_card_match_cpu(cuda_device):
    """``chip_smoke.py``'s small v1 check: rope, bloom-shaped ALiBi and
    dropless MoE (grouped GEMM on the card) f32 models, greedy tokens
    identical card vs CPU."""
    import chip_smoke

    out = chip_smoke.small_v1_agreement(torch, tgm)
    assert set(out) == {"rope", "alibi", "moe_dropless"}


def test_inprocess_server_on_card_matches_cpu(cuda_device):
    """A small f32 model (head dim 64) behind the HTTP server on the card
    and on the CPU: the same requests give the same tokens, the card's
    through the paged kernels with no plain call."""
    import chip_smoke

    out = chip_smoke.small_serving_agreement(torch, tpa)
    assert out["requests"] == 8 and out["tokens"] == 8 * 12


def test_serving_phase_small(cuda_device):
    """``chip_smoke.py``'s serving phase on ``gpt2-125m`` in f32 (head dim
    64): one in-process replica with exact paged launches against its
    ``engine/step`` spans, /metrics and the lone-engine check; two replicas
    sharing the weights (one more KV pool); the CLI as a subprocess with
    two card workers, one killed mid-stream and respawned, none left after
    the drain."""
    import chip_smoke

    argv = ["--model", "gpt2-125m", "--dtype", "float32",
            "--max_tokens_per_step", "64", "--max_seqs", "8",
            "--block_size", "16", "--num_blocks", "256",
            "--max_blocks_per_seq", "16"]
    out = chip_smoke.run_serving_phase(torch, tpa, "test", argv=argv,
                                       traffic_lens=(17, 200))
    assert out["inprocess"]["decode_bodies"] > 0
    assert out["subprocess"]["respawn_s"] > 0


def test_fleet_phase_small(cuda_device):
    """``chip_smoke.py``'s fleet phase on ``gpt2-125m`` in f32 (head dim
    64): dial-in card workers under the autoscaler (scale-up under load, a
    SIGKILLed worker's stream completed and its lease expired once, idle
    scale-down, a SIGSTOPped external worker replaced and fenced on its
    return, no worker left); disaggregated replicas with a bit-exact
    prefix handoff that leaves only the tail to prefill; a rolling swap
    that halts and rolls back on a wrong probe, then swaps under load;
    fleet adapter register / retire over HTTP against merged weights; and
    the bench's gemm sweep and offered-load sweep."""
    import chip_smoke

    argv = ["--model", "gpt2-125m", "--dtype", "float32",
            "--max_tokens_per_step", "64", "--max_seqs", "8",
            "--block_size", "16", "--num_blocks", "256",
            "--max_blocks_per_seq", "16"]
    out = chip_smoke.run_fleet_phase(
        torch, tpa, tmg, "test", argv=argv, traffic_lens=(17, 200),
        handoff_len=200, rollout_layers=0, adapter_rank=4,
        gemm_shapes=[(4096, 1024)])
    remote = out["remote"]
    assert remote["returnee_rc"] == 3
    assert remote["epochs"]["after"] > remote["epochs"]["before"]
    assert out["disagg"]["handoff_tokens"] == 192
    assert out["rollout"]["streams"] == chip_smoke.ROLLOUT_STREAMS
    assert out["bench"]["gemm_launches"]["mixed_gemm_int8"] > 0


# ---------------------------------------------------------------------------
# the training engine (fp16, remat policies, checkpoints)
# ---------------------------------------------------------------------------


def _f16_close(got, want, what):
    """Two f16 ulps of each finite element (``_close``); inf where the
    plain version is inf, or the largest finite f16 of its sign (f32 values
    either side of 65520 round one ulp apart, to 65504 and to inf)."""
    one = got.isinf() ^ want.isinf()
    finite_side = torch.where(got.isinf(), want, got)[one]
    assert (finite_side.abs() == 65504).all(), what
    both = torch.isfinite(got) & torch.isfinite(want)
    _close(got[both], want[both], torch.float16, what,
           scale=want[both].abs().max().item())


@pytest.mark.parametrize("ds_scale,v_scale", [(2.0 ** 13, 16.0),
                                              (2.0 ** -20, 1.0)],
                         ids=["ds_past_65504", "ds_under_6e-5"])
def test_flash_f16_out_of_range_ds_matches_plain(cuda_device, ds_scale,
                                                 v_scale):
    """dO (and V) scaled so that dS passes f16's largest value or falls
    under its smallest normal one: the f16 kernels' per-row power-of-two
    scaling keeps dK, dV and dQ within two f16 ulps of the plain versions
    (f32 dS), and their inf where a plain gradient overflows."""
    q, k, v, do, am = _flash_inputs(5, 2, 300, 8, 2, 128, torch.float16,
                                    cuda_device, {"causal": True})
    do = (do.float() * ds_scale).half()
    v = (v.float() * v_scale).half()
    scale = 128 ** -0.5
    o_p, lse_p = tfa.flash_fwd_plain(q, k, v, am, scale)
    delta = tfa.attention_delta(do, o_p)
    ds = tfa._recompute(q, k, v, do, lse_p, delta, am, scale)[3].abs()
    if ds_scale > 1:
        assert ds.max() > 65504
    else:
        assert ds.max() < 6.1e-5
    dk, dv = tfa.flash_bwd_dkdv(q, k, v, do, lse_p, delta, am, scale)
    dk_p, dv_p = tfa.flash_bwd_dkdv_plain(q, k, v, do, lse_p, delta, am,
                                          scale)
    dq = tfa.flash_bwd_dq(q, k, v, do, lse_p, delta, am, scale)
    dq_p = tfa.flash_bwd_dq_plain(q, k, v, do, lse_p, delta, am, scale)
    for got, want, what in ((dk, dk_p, "dk"), (dv, dv_p, "dv"),
                            (dq, dq_p, "dq")):
        _f16_close(got, want, what)


def test_flash_f16_overflow_stays_inf(cuda_device):
    """A dO of 60000 over a V scaled by 64: the gradients overflow, and the
    kernels' read inf where the plain versions' do (one f16 ulp from
    65504 either way) and never NaN; their finite elements are sums of
    terms near 1e7 that cancel, held to the inf pattern only."""
    q, k, v, _, am = _flash_inputs(6, 1, 128, 2, 2, 64, torch.float16,
                                   cuda_device, {"causal": True})
    do = torch.full_like(q, 60000.0)
    v = (v.float() * 64).half()
    o_p, lse_p = tfa.flash_fwd_plain(q, k, v, am, 0.125)
    delta = tfa.attention_delta(do, o_p)
    dk, dv = tfa.flash_bwd_dkdv(q, k, v, do, lse_p, delta, am, 0.125)
    dk_p, dv_p = tfa.flash_bwd_dkdv_plain(q, k, v, do, lse_p, delta, am,
                                          0.125)
    dq = tfa.flash_bwd_dq(q, k, v, do, lse_p, delta, am, 0.125)
    dq_p = tfa.flash_bwd_dq_plain(q, k, v, do, lse_p, delta, am, 0.125)
    for got, want, what in ((dk, dk_p, "dk"), (dv, dv_p, "dv"),
                            (dq, dq_p, "dq")):
        assert want.isinf().any() and not got.isnan().any()
        one = got.isinf() ^ want.isinf()
        assert (torch.where(got.isinf(), want, got)[one].abs()
                == 65504).all(), what


def _small_engine(device, config, seed=0, **cfg_over):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.runtime.engine import ModelSpec

    cfg = tt.get_config("tiny", hidden_size=256, intermediate_size=512,
                        num_heads=4, num_kv_heads=2, attn_impl="flash",
                        **cfg_over)
    params = tt.init_params(cfg, torch.Generator().manual_seed(seed),
                            device="cpu", dtype=tt.param_dtype(cfg))
    eng = deepspeed_tpu_torch.initialize(
        model=ModelSpec(loss_fn=lambda p, b, r: tt.loss_fn(p, b, cfg),
                        params=params),
        config=dict({"train_micro_batch_size_per_gpu": 4,
                     "steps_per_print": 10_000}, **config),
        device=device)[0]
    return eng, cfg


def test_fp16_engine_skips_overflow_bit_for_bit(cuda_device):
    """fp16 on the card (f16 flash kernels, f32 master weights): a scale
    of 2**40 overflows, the step leaves parameters and moments bit for bit
    and halves the scale, with no host sync in the step; then the scale
    comes down far enough for updates."""
    eng, cfg = _small_engine(cuda_device, {
        "fp16": {"enabled": True, "initial_scale_power": 40,
                 "hysteresis": 1}}, dtype="float16", param_dtype="float32")
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 64))
    flags = []
    tfa.reset_counts()
    for _ in range(40):
        before = [t.clone() for t in eng._leaves + eng.optimizer.mu
                  + eng.optimizer.nu]
        m = eng.train_batch({"input_ids": ids.astype(np.int32)})
        flags.append(m["overflow"])
        if m["overflow"]:
            after = eng._leaves + eng.optimizer.mu + eng.optimizer.nu
            assert all(torch.equal(a, b) for a, b in zip(after, before))
        elif sum(1 for f in flags if not f) >= 2:
            break
    assert flags[0] == 1.0 and flags[-1] == 0.0
    assert int(eng.skipped_steps) == int(sum(flags))
    assert eng.get_loss_scale() == 2.0 ** (40 - sum(flags))
    assert tfa.PLAIN_CALLS == {"flash_fwd_plain": 0,
                               "flash_bwd_dkdv_plain": 0,
                               "flash_bwd_dq_plain": 0}
    assert tfa.LAUNCHES["flash_bwd_dq"] == cfg.num_layers * len(flags)


@pytest.mark.parametrize("policy", ["everything", "nothing_saveable",
                                    "dots_saveable",
                                    "dots_with_no_batch_dims_saveable",
                                    "save_attn", "save_attn_mlp"])
def test_remat_policy_launch_counts_on_gpu(cuda_device, policy):
    """B1 runs 2 L times a step under every policy but ``everything`` (L),
    B2 and B3 L times; the loss and gradients equal ``nothing_saveable``'s
    bit for bit (deterministic kernels)."""
    import dataclasses

    from deepspeed_tpu_torch.runtime.optimizers import leaves

    cfg = tt.get_config("tiny", hidden_size=256, intermediate_size=512,
                        num_heads=4, num_kv_heads=2, attn_impl="flash",
                        dtype="bfloat16", param_dtype="bfloat16")
    params = tt.init_params(cfg, torch.Generator(cuda_device).manual_seed(
        1), device=cuda_device, dtype=torch.bfloat16)
    flat = leaves(params)
    for t in flat:
        t.requires_grad_(True)
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 128))).to(cuda_device)
    out = []
    for pol in ("nothing_saveable", policy):
        tfa.reset_counts()
        loss = tt.loss_fn(params, {"input_ids": ids},
                          dataclasses.replace(cfg, remat_policy=pol))[0]
        out.append((loss.detach(), torch.autograd.grad(loss, flat),
                    dict(tfa.LAUNCHES)))
    L = cfg.num_layers
    assert out[1][2] == {"flash_fwd": L if policy == "everything" else 2 * L,
                         "flash_bwd_dkdv": L, "flash_bwd_dq": L}
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_train_checkpoint_round_trip_on_gpu(cuda_device, tmp_path):
    """Save on the card, load into a fresh engine: parameters and optimizer
    state bit for bit, and the next steps' losses equal."""
    eng, cfg = _small_engine(cuda_device, {"optimizer": {
        "type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.01}}},
        dtype="bfloat16", param_dtype="bfloat16")
    rng = np.random.default_rng(2)
    batches = [{"input_ids": rng.integers(0, cfg.vocab_size, (4, 64)).astype(
        np.int32)} for _ in range(4)]
    for b in batches[:2]:
        eng.train_batch(b)
    eng.save_checkpoint(str(tmp_path))
    fresh, _ = _small_engine(cuda_device, {"optimizer": {
        "type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.01}}},
        seed=9, dtype="bfloat16", param_dtype="bfloat16")
    fresh.load_checkpoint(str(tmp_path))
    for a, b in zip(eng._leaves + list(eng.optimizer_state_flat().values()),
                    fresh._leaves + list(
                        fresh.optimizer_state_flat().values())):
        assert torch.equal(a, b)
    for b in batches[2:]:
        assert eng.train_batch(b)["loss"] == fresh.train_batch(b)["loss"]


def _small_bf16_cfg(layers):
    return tt.get_config("tiny", hidden_size=256, intermediate_size=512,
                         num_heads=4, num_kv_heads=2, num_layers=layers,
                         attn_impl="flash", dtype="bfloat16",
                         param_dtype="bfloat16")


def test_offload_phase_small(cuda_device):
    """``chip_smoke.py``'s offload phase at a small width: optimizer offload
    plain and delayed, the streamed engine, the NVMe tiers, ZenFlow,
    ``cpu_checkpointing`` and the small f32 agreement, with their gates."""
    import chip_smoke

    a = chip_smoke.optimizer_offload(torch, tfa, _small_bf16_cfg, "test")
    assert a["layers"] == chip_smoke.OFFLOAD_DEPTHS[0]
    assert a["plain"]["host_ms"]["update_ms"] > 0
    b = chip_smoke.param_offload(torch, tfa, 4, a["plain"]["peak_mem_gb"],
                                 _small_bf16_cfg)
    assert b["stream_ins"] == 2 * 4 and b["loss_after"] < b["losses"][0]
    c = chip_smoke.nvme_tiers(torch, tfa, _small_bf16_cfg)
    assert c["read_gb_s"] > 0 and c["write_gb_s"] > 0
    d = chip_smoke.zenflow_run(torch, tfa, _small_bf16_cfg)
    assert d["cold_bytes_transferred"] * chip_smoke.ZENFLOW_INTERVAL == \
        d["plain_offload_grad_bytes"]
    f = chip_smoke.cpu_checkpointing_run(torch, tfa, _small_bf16_cfg)
    assert f["max_abs_err_grads"] >= 0.0
    assert set(chip_smoke.small_offload_agreement(torch, tfa)) == {
        "optimizer", "delayed", "param"}


def test_streamed_engine_keeps_the_stack_on_the_host(cuda_device):
    """``offload_param``: the stack's leaves are page-locked host tensors,
    the card's peak is below the resident engine's by at least the stack's
    bf16 bytes, and the losses equal the resident offload engine's."""
    from deepspeed_tpu_torch.runtime.zero import param_offload as tpo

    rng = np.random.default_rng(3)
    batches = [{"input_ids": rng.integers(0, 256, (4, 512)).astype(
        np.int32)} for _ in range(3)]
    out = {}
    for name, zero in (("resident", {"offload_optimizer": {"device": "cpu"}}),
                       ("streamed", {"offload_param": {"device": "cpu"},
                                     "stage3_param_persistence_threshold":
                                         0})):
        eng, cfg = _small_engine(cuda_device, {
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
            "zero_optimization": {"stage": 0, **zero}},
            dtype="bfloat16", param_dtype="bfloat16", num_layers=8)
        stack = [t for t, p in zip(eng._leaves, eng._paths)
                 if p.startswith("layers/")]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = [eng.train_batch(b)["loss"] for b in batches]
        out[name] = (losses, torch.cuda.max_memory_allocated(),
                     sum(t.numel() * t.element_size() for t in stack))
        if name == "streamed":
            assert all(tpo.is_page_locked(t) for t in stack)
        eng.offloaded_optimizer.close()
    assert out["streamed"][0] == out["resident"][0]
    assert out["streamed"][1] < out["resident"][1] - out["resident"][2]


def test_offload_states_frees_the_card(cuda_device):
    """``offload_states`` moves the optimizer state and the parameters to
    page-locked host memory and frees the card; ``train_batch`` reloads
    them, and the run goes on as an uninterrupted one, bit for bit."""
    cfg = {"optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}
    eng, mcfg = _small_engine(cuda_device, cfg)
    ref, _ = _small_engine(cuda_device, cfg)
    rng = np.random.default_rng(4)
    batches = [{"input_ids": rng.integers(0, mcfg.vocab_size, (4, 64)).astype(
        np.int32)} for _ in range(4)]
    for b in batches[:2]:
        assert eng.train_batch(b)["loss"] == ref.train_batch(b)["loss"]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    eng.offload_states(include=("optim_states", "lp_params"))
    assert all(t.is_pinned() for t in eng._leaves)
    assert torch.cuda.memory_allocated() < before - sum(
        t.numel() * t.element_size() for t in eng._leaves)
    for b in batches[2:]:
        assert eng.train_batch(b)["loss"] == ref.train_batch(b)["loss"]
    assert not eng.states_offloaded
    for a, b in zip(eng._leaves, ref._leaves):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# PEFT: B6 inside a training step, and a small QLoRA model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [4, 8, 6])
def test_b6_at_training_rows_through_frozen_gemm(cuda_device, bits):
    """``mixed_gemm_frozen`` at a training step's M = 4 x 2048 rows (bf16
    x, group 512): the forward on ``mixed_gemm_wgmma_kernel`` against the
    plain version, and the x-gradient (the dequantized weight's transpose,
    as the reference's backward) against the same formula in f32."""
    gen = torch.Generator(device="cuda").manual_seed(bits)
    M, K, N = 8192, 4096, 1024
    w = torch.randn((K, N), generator=gen, device="cuda") / K ** 0.5
    qw = tmg.quantize_gemm_weight(w, bits=bits, group=512)
    assert tmg.mixed_gemm_on_kernel_path(qw)
    x = torch.randn((M, K), generator=gen, device="cuda",
                    dtype=torch.bfloat16).requires_grad_()
    g = torch.randn((M, N), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    name = {4: "mixed_gemm_int4", 8: "mixed_gemm_int8",
            6: "mixed_gemm_fp6"}[bits]
    tmg.reset_counts()
    y = tmg.mixed_gemm_frozen(x, qw)
    assert tmg.WGMMA_LAUNCHES[name] == 1 and not any(
        tmg.PLAIN_CALLS.values())
    atol, rtol = TOLERANCE[torch.bfloat16]
    torch.testing.assert_close(y.float(), tmg.mixed_gemm_plain(
        x.detach(), qw).float(), atol=atol, rtol=rtol)
    (gx,) = torch.autograd.grad(y, x, g)
    want = g.float() @ tmg.dequantize_gemm_weight(qw).to(
        torch.bfloat16).float().t()
    err = (gx.float() - want).abs().max().item()
    assert err <= 1e-2 * want.abs().max().item()  # bf16 output, f32 sums
    assert qw.codes.grad is None


def test_qlora_small_model_card_vs_cpu(cuda_device):
    """``chip_smoke.py``'s peft agreement: a small f32 model with an int4
    LoRA base, three PEFT steps card vs CPU within TOL_TRAIN; then the
    same model in bf16 with a group-512 base, one step on the card: B6 on
    every projection in the forward and the remat recompute, no plain
    call, the codes unchanged and the adapters alone trained."""
    import chip_smoke
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.linear import optimized_linear as tl
    from deepspeed_tpu_torch.runtime.engine import ModelSpec

    small = chip_smoke.small_peft_agreement(torch, tfa)
    assert small["loss_max_rel_diff"] <= chip_smoke.TOL_TRAIN
    cfg = tt.get_config("tiny", hidden_size=512, intermediate_size=1024,
                        num_heads=4, num_kv_heads=2, attn_impl="flash",
                        dtype="bfloat16", param_dtype="bfloat16")
    params = tt.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu", dtype=torch.bfloat16)
    lora = dict(chip_smoke.PEFT_LORA, lora_r=8)
    eng = deepspeed_tpu_torch.initialize(
        model=ModelSpec(loss_fn=lambda p, b, r: tt.loss_fn(p, b, cfg),
                        params=params),
        config={"train_micro_batch_size_per_gpu": 4,
                "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
                "peft": {"lora": lora}, "steps_per_print": 10_000},
        device=cuda_device)[0]
    codes = [p.clone() for p, path in zip(eng._all_leaves, eng._all_paths)
             if path.endswith("codes")]
    assert codes and all(p.endswith(tl.ADAPTER_LEAF_KEYS)
                         for p in eng._paths)
    tmg.reset_counts()
    batch = {"input_ids": np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 64)).astype(np.int32)}
    losses = [eng.train_batch(batch)["loss"] for _ in range(3)]
    assert tmg.WGMMA_LAUNCHES["mixed_gemm_int4"] == \
        3 * 2 * chip_smoke.PROJECTIONS * cfg.num_layers
    assert not any(tmg.PLAIN_CALLS.values()) and losses[-1] < losses[0]
    after = [p for p, path in zip(eng._all_leaves, eng._all_paths)
             if path.endswith("codes")]
    assert all(torch.equal(a, b) for a, b in zip(codes, after))


# ---------------------------------------------------------------------------
# ZeRO stages 1-3 on a world of one over NCCL (tests/torch_dist.py)
# ---------------------------------------------------------------------------


def test_zero_stages_on_an_nccl_world_of_one(cuda_device, tmp_path):
    """A small f32 flash model at stages 0-3 (and qwZ) in a child process
    whose world of one runs NCCL: each stage's losses and parameters
    against stage 0's, the stages' collectives issued through NCCL; and
    qwZ's quantized gather itself (int8 codes and f32 scales through
    NCCL) within one int8 step of the bf16 tensors, in under 0.6 of the
    bf16 gather's bytes."""
    import importlib.util
    import os

    # by path: with --noconftest the tests directory is not a package
    spec = importlib.util.spec_from_file_location(
        "torch_dist", os.path.join(os.path.dirname(__file__),
                                   "torch_dist.py"))
    torch_dist = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(torch_dist)
    launch = torch_dist.launch

    cfg = tt.get_config("tiny", hidden_size=256, intermediate_size=512,
                        num_heads=4, num_kv_heads=2, dtype="float32",
                        attn_impl="flash")
    params = tt.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu", dtype=torch.float32)

    def np_tree(t):
        return {k: np_tree(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.numpy()

    rng = np.random.default_rng(0)
    batches = [{"input_ids": rng.integers(0, 256, (4, 64)).astype(np.int32)}
               for _ in range(3)]
    model = dict(hidden_size=256, intermediate_size=512, num_heads=4,
                 num_kv_heads=2, dtype="float32", attn_impl="flash")
    scenarios = [(name, dict(
        kind="engine", preset="tiny", model=model, params=np_tree(params),
        batches=batches, device="cuda", config={
            "train_micro_batch_size_per_gpu": 4, "steps_per_print": 1000,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
            "zero_optimization": dict(stage=stage, **zero)}))
        for name, stage, zero in (
            ("s0", 0, {}), ("s1", 1, {}), ("s2", 2, {}), ("s3", 3, {}),
            ("qwz", 3, {"zero_quantized_weights": True}))]
    whole = [rng.standard_normal((512, 1024)).astype(np.float32),
             rng.standard_normal((1024, 256)).astype(np.float32)]
    scenarios.append(("qwz_gather", dict(kind="qwz_gather", whole=whole,
                                         dims=[1, 0], device="cuda")))
    res = launch(1, scenarios, tmp_path, timeout=600, device="cuda")[0]
    for name, _ in scenarios:
        assert "error" not in res[name], res[name]["error"]
    base = res["s0"]
    assert base["counts"] == {}
    for name in ("s1", "s2", "s3", "qwz"):
        r = res[name]
        assert r["backend"] == "nccl" and r["counts"]
        # qwZ over an fsdp axis of one rank gathers unquantized leaves, as
        # the reference's qwz_gather_leaf (ROADMAP.md C11)
        for a, b in zip(base["steps"], r["steps"]):
            np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
        for key, w in base["params"].items():
            np.testing.assert_allclose(r["params"][key], w, atol=1e-4,
                                       rtol=0, err_msg=f"{name} {key}")
    q = res["qwz_gather"]
    for got, w in zip(q["gathered"], whole):
        bf = torch.from_numpy(w).bfloat16().float().numpy()
        assert got.shape == w.shape
        assert np.abs(got - bf).max() <= np.abs(bf).max() / 127
    assert 0 < q["bytes"] < 0.6 * q["plain_bytes"]
    assert res["_modules"] == []


def test_zero_offload_on_an_nccl_world_of_one(cuda_device, tmp_path):
    """Offload on a data-parallel world of one over NCCL, a small f32
    flash model: optimizer offload at stages 1-3, ZeRO-Infinity at stage 3
    (the stack's shards page-locked, streamed in by the gathers, their
    gradients copied out) and ZenFlow at stages 2 and 3 (its cold sums and
    hot columns on the card), each against the on-device stage 0's losses
    and parameters (ZenFlow's first loss); no two host buffers of an
    engine overlap."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "torch_dist", os.path.join(os.path.dirname(__file__),
                                   "torch_dist.py"))
    torch_dist = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(torch_dist)

    cfg = tt.get_config("tiny", hidden_size=256, intermediate_size=512,
                        num_heads=4, num_kv_heads=2, dtype="float32",
                        attn_impl="flash")
    params = tt.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu", dtype=torch.float32)

    def np_tree(t):
        return {k: np_tree(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.numpy()

    rng = np.random.default_rng(0)
    batches = [{"input_ids": rng.integers(0, 256, (4, 64)).astype(np.int32)}
               for _ in range(3)]
    model = dict(hidden_size=256, intermediate_size=512, num_heads=4,
                 num_kv_heads=2, dtype="float32", attn_impl="flash")
    cpu = {"offload_optimizer": {"device": "cpu"}}
    scenarios = [(name, dict(
        kind="offload", preset="tiny", model=model, params=np_tree(params),
        batches=batches, device="cuda", config={
            "train_micro_batch_size_per_gpu": 4, "steps_per_print": 1000,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
            "zero_optimization": dict(stage=stage, **zero), **extra}))
        for name, stage, zero, extra in (
            ("s0", 0, {}, {}), ("s1", 1, cpu, {}), ("s2", 2, cpu, {}),
            ("s3", 3, cpu, {}),
            ("infinity", 3, dict(cpu, offload_param={"device": "cpu"},
                                 stage3_param_persistence_threshold=0), {}),
            ("zenflow", 2, cpu, {"zenflow": {"enabled": True,
                                             "topk_ratio": 0.25}}),
            ("zenflow3", 3, cpu, {"zenflow": {"enabled": True,
                                              "topk_ratio": 0.25}}))]
    res = torch_dist.launch(1, scenarios, tmp_path, timeout=600,
                            device="cuda")[0]
    for name, _ in scenarios:
        assert "error" not in res[name], res[name]["error"]
    base = res["s0"]
    for name in ("s1", "s2", "s3", "infinity", "zenflow", "zenflow3"):
        r = res[name]
        assert r["overlaps"] == 0 and r["host_bytes"] > 0
        zenflow = name.startswith("zenflow")
        steps = r["steps"][:1] if zenflow else r["steps"]
        for a, b in zip(base["steps"], steps):
            np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
        if zenflow:
            assert r["zenflow_on"] == ["cuda"], r["zenflow_on"]
        else:
            for key, w in base["params"].items():
                np.testing.assert_allclose(r["params"][key], w, atol=1e-4,
                                           rtol=0, err_msg=f"{name} {key}")
    assert res["infinity"]["stream_in"] == 2 * 2 * 3  # L fwd + L recompute
    assert res["_modules"] == []
