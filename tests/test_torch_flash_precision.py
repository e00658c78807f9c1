"""Precision of the bf16 flash kernels' arithmetic, emulated on the CPU.

``csrc/flash_attention.cu`` runs the bf16 forward, dK/dV and dQ on the
tensor cores: every product of two bf16 operands (exact in f32) is summed in f32,
and the f32 probabilities p and gradients ds, which the reference keeps in
f32, are split into ``hi = bf16(x)`` and ``lo = bf16(x - hi)`` and fed to
two products each.  This file emulates that arithmetic in plain torch at
the smoke's per-group training shape (S = 2048, G = 4 query heads per kv
head, D = 128, causal, inputs rounded to bf16 as ``chip_smoke.check_flash``
makes them) and holds o, lse, dK and dV to ``chip_smoke``'s own checks and
limits (``TOL_BF16``, ``TOL_F32``, ``GRAD_REL``) against the port's plain
versions, which the kernels meet on the card; dQ likewise
(``_emulate_dq``); and the forward with the evoformer biases
(``_emulate_fwd_bias``) at the smoke's MSA row attention shape.  Rounding p and ds to bf16 alone, without the lo half,
fails those limits; that is why the kernels split.  The plain versions themselves agree with the Pallas kernels
(interpret mode) at a small size.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from deepspeed_tpu.ops.pallas import flash_attention as jfa
from deepspeed_tpu_torch.ops.hopper import flash_attention as tfa

from tests.torch_cpu import one_torch_thread  # noqa: F401

S, G, D = 2048, 4, 128
TILE = 64  # keys per kernel tile (the forward's online-softmax step)
LOG2E = 1.0 / math.log(2.0)


def _bf16_inputs(seed, B, S, H, KV, D):
    """q, k, v, dO from a numpy seed, rounded to bf16."""
    rng = np.random.default_rng(seed)
    shapes = ((B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D))
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(torch.bfloat16) for s in shapes]


def _products(x, split):
    """The A operand of a tensor-core product: hi + lo (two bf16 terms) or
    bf16(x) alone, as f32 values."""
    hi = x.to(torch.bfloat16).float()
    if not split:
        return (hi,)
    return hi, (x - hi).to(torch.bfloat16).float()


def _emulate_fwd(q, k, v, scale, split):
    """The forward kernel's arithmetic for one (batch, kv head): q (S, G, D),
    k and v (S, D); online softmax over 64-key tiles in the log2 domain,
    l summed from the f32 p, o = acc / l.  Returns o (S, G, D) bf16 and
    lse (G, S) f32."""
    n = q.shape[0] * q.shape[1]
    qf = q.float().reshape(n, D)  # vector i = (row i // G, head i % G)
    rows = torch.arange(n) // G
    m = torch.full((n,), -math.inf)
    l = torch.zeros(n)
    acc = torch.zeros(n, D)
    for c0 in range(0, k.shape[0], TILE):
        kt, vt = k[c0:c0 + TILE].float(), v[c0:c0 + TILE].float()
        keep = torch.arange(c0, c0 + kt.shape[0])[None, :] <= rows[:, None]
        s = torch.where(keep, (qf @ kt.T) * (scale * LOG2E), -math.inf)
        m_new = torch.maximum(m, s.max(1).values)
        m_use = torch.where(m_new == -math.inf, 0.0, m_new)
        alpha = torch.exp2(m - m_use)
        p = torch.where(keep, torch.exp2(s - m_use[:, None]), 0.0)
        l = l * alpha + p.sum(1)
        acc = acc * alpha[:, None]
        for part in _products(p, split):
            acc = acc + part @ vt
        m = m_new
    o = acc / l[:, None]
    lse = m * math.log(2.0) + torch.log(l)
    return (o.reshape(q.shape).to(torch.bfloat16),
            lse.reshape(-1, G).T.contiguous())


def _emulate_dkdv(q, k, v, do, lse, delta, scale, split):
    """The dK/dV kernel's arithmetic for one (batch, kv head): p^T =
    exp2(s^T scale log2e - lse log2e) in f32, ds^T = p^T (dp^T - delta)
    scale, dV += p^T dO and dK += ds^T q through the split.  lse and delta
    (G, S).  Returns dk, dv (S, D) bf16."""
    n = q.shape[0] * q.shape[1]
    qf, dof = q.float().reshape(n, D), do.float().reshape(n, D)
    lse2 = lse.T.reshape(n) * LOG2E  # vector order: (row, head)
    dl = delta.T.reshape(n)
    rows = torch.arange(n) // G
    dk, dv = torch.zeros(k.shape[0], D), torch.zeros(k.shape[0], D)
    for c0 in range(0, k.shape[0], 512):
        kt, vt = k[c0:c0 + 512].float(), v[c0:c0 + 512].float()
        keep = torch.arange(c0, c0 + kt.shape[0])[:, None] <= rows[None, :]
        pt = torch.where(keep, torch.exp2((kt @ qf.T) * (scale * LOG2E)
                                          - lse2[None, :]), 0.0)
        dst = pt * ((vt @ dof.T) - dl[None, :]) * scale
        for part in _products(pt, split):
            dv[c0:c0 + 512] += part @ dof
        for part in _products(dst, split):
            dk[c0:c0 + 512] += part @ qf
    return dk.to(torch.bfloat16), dv.to(torch.bfloat16)


def _emulate_dq(q, k, v, do, lse, delta, scale, split):
    """The dQ kernel's arithmetic for one (batch, kv head): per 64-key
    tile, p = exp2(s scale log2e - lse log2e) in f32, ds = p (dp - delta)
    and dQ += ds K through the split, summed in f32; the scale multiplies
    dQ once at the end.  Causal: a tile adds only to the rows that can see
    it.  Returns dq (S, G, D) bf16."""
    n = q.shape[0] * q.shape[1]
    qf, dof = q.float().reshape(n, D), do.float().reshape(n, D)
    lse2 = lse.T.reshape(n) * LOG2E  # vector order: (row, head)
    dl = delta.T.reshape(n)
    rows = torch.arange(n) // G
    dq = torch.zeros(n, D)
    for c0 in range(0, k.shape[0], TILE):
        kt, vt = k[c0:c0 + TILE].float(), v[c0:c0 + TILE].float()
        i0 = c0 * G  # the first vector whose row sees key c0
        keep = torch.arange(c0, c0 + kt.shape[0])[None, :] <= rows[i0:, None]
        p = torch.where(keep, torch.exp2((qf[i0:] @ kt.T) * (scale * LOG2E)
                                         - lse2[i0:, None]), 0.0)
        ds = p * ((dof[i0:] @ vt.T) - dl[i0:, None])
        for part in _products(ds, split):
            dq[i0:] += part @ kt
    return (dq * scale).reshape(q.shape).to(torch.bfloat16)


def _emulate_fwd_bias(q, k, v, bias, scale):
    """The bias forward's arithmetic for one (sequence, head): q, k, v
    (L, D) bf16, bias (L, L) f32 (b1 + b2, summed in f32); per 64-key tile
    x = s scale log2e + bias log2e, then _emulate_fwd's online softmax
    with the split p.  Returns o (L, D) bf16 and lse (L,) f32."""
    L, Dh = q.shape
    qf = q.float()
    m = torch.full((L,), -math.inf)
    l = torch.zeros(L)
    acc = torch.zeros(L, Dh)
    for c0 in range(0, k.shape[0], TILE):
        kt, vt = k[c0:c0 + TILE].float(), v[c0:c0 + TILE].float()
        s = (qf @ kt.T) * (scale * LOG2E) + bias[:, c0:c0 + TILE] * LOG2E
        m_new = torch.maximum(m, s.max(1).values)
        m_use = torch.where(m_new == -math.inf, 0.0, m_new)
        alpha = torch.exp2(m - m_use)
        p = torch.exp2(s - m_use[:, None])
        l = l * alpha + p.sum(1)
        acc = acc * alpha[:, None]
        for part in _products(p, True):
            acc = acc + part @ vt
        m = m_new
    return ((acc / l[:, None]).to(torch.bfloat16),
            m * math.log(2.0) + torch.log(l))


def test_bias_forward_meets_the_smoke_limits():
    """The bias forward's arithmetic at the smoke's MSA row attention call
    (L = 256, H = 8, D = 32; 4 of its 128 sequences, one padded with every
    key at -1e9; bf16 inputs and biases as ``chip_smoke.evoformer_inputs``
    draws them) against flash_fwd_plain: o within TOL_BF16, lse within
    TOL_F32, and the padded sequence's o the mean of V."""
    shape = list(chip_smoke.EVO_CALLS["msa_row"][0])
    shape[1] = 4
    B, N, L, Hh, Dh = shape
    rng = np.random.default_rng(7)

    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)

    q, k, v = (bf16(rng.standard_normal(shape)) for _ in range(3))
    keep = rng.random((B, N, 1, 1, L)) < 0.9
    keep[:, 3] = False
    b1 = bf16(np.where(keep, 0.0, -1e9))
    b2 = bf16(rng.standard_normal((B, 1, Hh, L, L)))
    scale = 1.0 / math.sqrt(Dh)
    flat = [t.reshape(B * N, L, Hh, Dh) for t in (q, k, v)]
    o_p, lse_p = tfa.flash_fwd_plain(*flat, tfa.AttnMask(causal=False),
                                     scale, b1.reshape(B * N, L),
                                     b2.reshape(B, Hh, L, L))
    o = torch.empty_like(o_p)
    lse = torch.empty_like(lse_p)
    for n in range(N):
        for h in range(Hh):
            bias = b1[0, n, 0, 0].float()[None, :] + b2[0, 0, h].float()
            o[n, :, h], lse[n, h] = _emulate_fwd_bias(
                q[0, n, :, h], k[0, n, :, h], v[0, n, :, h], bias, scale)
    chip_smoke.compare(o, o_p, chip_smoke.TOL_BF16, "emulated biased o")
    chip_smoke.compare(lse, lse_p, chip_smoke.TOL_F32,
                       "emulated biased lse")
    mean_v = v[0, 3].float().mean(0, keepdim=True).expand(L, Hh, Dh)
    chip_smoke.compare(o[3], mean_v, chip_smoke.TOL_BF16,
                       "padded sequence vs mean of V")
    assert (lse[3] < -9e8).all()


@pytest.fixture(scope="module")
def training_group():
    """One (batch, kv head) of the training shape, its plain forward and
    dK/dV (the kernels' oracle on the card), as ``check_flash`` runs them."""
    q, k, v, do = _bf16_inputs(0, 1, S, G, 1, D)
    mask = tfa.AttnMask(causal=True)
    scale = 1.0 / math.sqrt(D)
    o_p, lse_p = tfa.flash_fwd_plain(q, k, v, mask, scale)
    delta = tfa.attention_delta(do, o_p)
    dk_p, dv_p = tfa.flash_bwd_dkdv_plain(q, k, v, do, lse_p, delta, mask,
                                          scale)
    dq_p = tfa.flash_bwd_dq_plain(q, k, v, do, lse_p, delta, mask, scale)
    return dict(q=q[0], k=k[0, :, 0], v=v[0, :, 0], do=do[0], scale=scale,
                o=o_p[0], lse=lse_p[0], delta=delta[0], dk=dk_p[0, :, 0],
                dv=dv_p[0, :, 0], dq=dq_p[0])


def _check_fwd(t, split):
    o, lse = _emulate_fwd(t["q"], t["k"], t["v"], t["scale"], split)
    chip_smoke.compare(o, t["o"], chip_smoke.TOL_BF16, "emulated o")
    chip_smoke.compare(lse, t["lse"], chip_smoke.TOL_F32, "emulated lse")


def _check_grad(t, split, which):
    if which == "dq":
        got = _emulate_dq(t["q"], t["k"], t["v"], t["do"], t["lse"],
                          t["delta"], t["scale"], split)
    else:
        dk, dv = _emulate_dkdv(t["q"], t["k"], t["v"], t["do"], t["lse"],
                               t["delta"], t["scale"], split)
        got = dk if which == "dk" else dv
    chip_smoke.compare_grad(got, t[which], False, f"emulated {which}")


def test_hi_lo_split_forward_meets_the_smoke_limits(training_group):
    _check_fwd(training_group, split=True)


@pytest.mark.parametrize("which", ["dk", "dv"])
def test_hi_lo_split_dkdv_meets_the_smoke_limits(training_group, which):
    _check_grad(training_group, True, which)


def test_hi_lo_split_dq_meets_the_smoke_limits(training_group):
    _check_grad(training_group, True, "dq")


def test_p_rounded_to_bf16_breaks_the_forward_limit(training_group):
    """Without the lo half, o misses TOL_BF16: the split is needed."""
    with pytest.raises(SystemExit):
        _check_fwd(training_group, split=False)


@pytest.mark.parametrize("which", ["dk", "dv", "dq"])
def test_p_and_ds_rounded_to_bf16_break_the_gradient_limit(training_group,
                                                           which):
    with pytest.raises(SystemExit):
        _check_grad(training_group, False, which)


def test_plain_versions_match_the_pallas_kernels():
    """flash_fwd_plain (o, lse) and flash_bwd_dkdv_plain against the
    reference's ``_flash_fwd`` and ``_flash_bwd`` in interpret mode, f32 on
    bf16-valued inputs, GQA group 4, D = 128, causal, at the limits of
    tests/test_flash_attention.py (2e-5 forward, 5e-4 gradients)."""
    B, Ss, H, KV, blk = 1, 128, 4, 1, 64
    q, k, v, do = (t.float() for t in _bf16_inputs(1, B, Ss, H, KV, D))
    scale = 1.0 / math.sqrt(D)
    jt = [jnp.asarray(t.numpy()).transpose(0, 2, 1, 3) for t in (q, k, v, do)]
    jo, jlse = jfa._flash_fwd(*jt[:3], None, None, None, scale, True, blk,
                              blk)
    _, jdk, jdv, *_ = jfa._flash_bwd(
        scale, True, blk, blk, 0,
        (*jt[:3], None, None, None, jo, jlse), jt[3])

    def back(a):  # (B, heads, S, D) -> (B, S, heads, D)
        return np.asarray(a).transpose(0, 2, 1, 3)

    mask = tfa.AttnMask(causal=True)
    o, lse = tfa.flash_fwd_plain(q, k, v, mask, scale)
    np.testing.assert_allclose(o.numpy(), back(jo), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               atol=2e-5, rtol=2e-5)
    dk, dv = tfa.flash_bwd_dkdv_plain(q, k, v, do, lse,
                                      tfa.attention_delta(do, o), mask, scale)
    np.testing.assert_allclose(dk.numpy(), back(jdk), atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(dv.numpy(), back(jdv), atol=5e-4, rtol=5e-4)
    assert jax.default_backend() == "cpu"
