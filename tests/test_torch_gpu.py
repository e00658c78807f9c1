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
from deepspeed_tpu_torch.ops.hopper import paged_attention as tpa

pytestmark = pytest.mark.cuda

# per dtype (atol, rtol): f32 differs from the plain version only in
# summation order; a bf16 output element may round one ulp (2**-7 of its
# size) the other way
TOLERANCE = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-4, 1e-2)}


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
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


def test_wrappers_raise_on_cuda_input_they_do_not_take(cuda_device):
    dec, pre = _inputs(1, 8, 2, 128, 16, torch.float16, cuda_device)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
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
