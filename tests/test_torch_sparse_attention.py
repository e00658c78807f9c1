"""Parity: the port's block-sparse attention
(``deepspeed_tpu_torch.ops.sparse_attention``) against the JAX package's.

Every layout builder must give exactly the reference's table
(``np.array_equal``) for the same config, length and seed; and
``sparse_attention`` (the port's flash op with the layout as its block
mask) must match the reference's (Pallas in interpret mode on the CPU) on
the same numpy-seeded f32 inputs: the output within 2e-5 and dq/dk/dv
within 5e-4, the limits of ``tests/test_flash_attention.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu_torch.ops import sparse_attention as tsa
from deepspeed_tpu_torch.ops.hopper import flash_attention as tfa

from tests.torch_cpu import one_torch_thread  # noqa: F401

FWD_TOL, GRAD_TOL = 2e-5, 5e-4

# (class name, kwargs); each runs bidirectional and unidirectional
LAYOUTS = [
    ("DenseSparsityConfig", dict(block=64)),
    ("FixedSparsityConfig", dict(block=64)),
    ("FixedSparsityConfig", dict(block=32, num_local_blocks=3,
                                 num_global_blocks=2)),
    ("BigBirdSparsityConfig", dict(block=64)),
    ("BigBirdSparsityConfig", dict(block=32, num_random_blocks=2,
                                   num_sliding_window_blocks=5,
                                   num_global_blocks=2)),
    ("BSLongformerSparsityConfig", dict(block=64)),
    ("BSLongformerSparsityConfig", dict(
        block=32, num_sliding_window_blocks=5, global_block_indices=(0, 7),
        global_block_end_indices=(2, 9))),
    ("VariableSparsityConfig", dict(block=64)),
    ("VariableSparsityConfig", dict(block=32, num_random_blocks=1,
                                    local_window_blocks=(1, 3, 2),
                                    global_block_indices=(0, 5))),
]


@pytest.mark.parametrize("attention", ["bidirectional", "unidirectional"])
@pytest.mark.parametrize("idx", range(len(LAYOUTS)),
                         ids=[f"{n[:-14]}{i}" for i, (n, _) in
                              enumerate(LAYOUTS)])
def test_layouts_equal_the_reference(idx, attention):
    name, kw = LAYOUTS[idx]
    for seq_len in (512, 1024, 2048):
        for seed in (0, 1, 7):
            extra = {"seed": seed} if "seed" in getattr(
                tsa, name).__dataclass_fields__ else {}
            got = getattr(tsa, name)(attention=attention, **kw, **extra) \
                .make_layout(seq_len)
            want = getattr(jsa, name)(attention=attention, **kw, **extra) \
                .make_layout(seq_len)
            assert got.dtype == want.dtype and np.array_equal(got, want), \
                (name, seq_len, seed)


def test_layout_refuses_an_indivisible_length():
    cfg = tsa.FixedSparsityConfig(block=64)
    with pytest.raises(ValueError, match="not divisible by block 64"):
        cfg.make_layout(100)


@pytest.mark.parametrize("cfg", [
    dict(cls="FixedSparsityConfig", block=128, num_local_blocks=2,
         attention="unidirectional"),
    dict(cls="BigBirdSparsityConfig", block=128,
         num_sliding_window_blocks=3, attention="unidirectional"),
    dict(cls="BSLongformerSparsityConfig", block=64,
         attention="bidirectional"),
], ids=["fixed_causal", "bigbird_causal", "longformer"])
def test_sparse_attention_and_grads_match_reference(cfg):
    cfg = dict(cfg)
    cls = cfg.pop("cls")
    B, S, H, KV, D = 1, 512, 4, 2, 32
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, KV, D)).astype(np.float32)
            for _ in range(2))
    g = rng.standard_normal((B, S, H, D)).astype(np.float32)

    jcfg = getattr(jsa, cls)(**cfg)

    def loss(q, k, v):
        return (jsa.sparse_attention(q, k, v, jcfg) * g).sum()

    jargs = [jnp.asarray(a) for a in (q, k, v)]
    want = np.asarray(jsa.sparse_attention(*jargs, jcfg))
    want_g = jax.grad(loss, argnums=(0, 1, 2))(*jargs)

    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tfa.reset_counts()
    got = tsa.sparse_attention(*leaves, getattr(tsa, cls)(**cfg))
    (got * torch.from_numpy(g)).sum().backward()
    assert tfa.PLAIN_CALLS == {"flash_fwd_plain": 1,
                               "flash_bwd_dkdv_plain": 1,
                               "flash_bwd_dq_plain": 1}
    np.testing.assert_allclose(got.detach().numpy(), want, atol=FWD_TOL,
                               rtol=FWD_TOL)
    for name, t, w in zip(("dq", "dk", "dv"), leaves, want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=name)
