"""Parity: the port's fp16 loss scaling (``runtime/loss_scaler.py``) and
fp16 training step against the JAX package's.

- the dynamic loss-scale state machine, exactly, over a scripted series of
  finite and overflowed steps (hysteresis, window, min scale, static);
- ``scale_loss`` / ``unscale_grads`` bit for bit;
- the fp16 engine on a tiny f16 model with f32 master weights against the
  reference's engine: a scale started high enough that the first steps
  overflow, then an injected inf mid-run; the same overflow flags and
  scales step for step, losses within 2e-3 relative (f16 activations,
  summed in another order on each side), final parameters within 2 lr per
  applied step (Adam's normalized step turns a gradient element that
  rounds near zero in f16 into a full step of either sign) and within 1e-5
  on average;
  an overflowed step leaves parameters and optimizer state bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.parallel.topology import MeshTopology
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu.runtime import loss_scaler as jls
from deepspeed_tpu.runtime.engine import ModelSpec as JSpec
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.runtime import loss_scaler as tls
from deepspeed_tpu_torch.runtime.engine import ModelSpec as TSpec

from tests.torch_cpu import one_torch_thread  # noqa: F401

F16_LOSS_RTOL = 2e-3
F16_PARAM_STEP = 2e-3  # 2 lr, per applied step
F16_PARAM_MEAN = 1e-5

SERIES = [True, False, True, True, False, False, True, True, True, True,
          False, True, False, False, False, True, True, True]


def _state(s):
    return (float(s.scale), int(s.good_steps), int(s.hysteresis))


@pytest.mark.parametrize("kw", [
    dict(loss_scale_window=3, hysteresis=2, min_scale=1.0),
    dict(loss_scale_window=2, hysteresis=1, min_scale=2.0 ** 14),
    dict(loss_scale_window=4, hysteresis=3, min_scale=1.0, dynamic=False)],
    ids=["hys2-window3", "hys1-min-2^14", "static"])
def test_loss_scale_state_machine_matches_reference(kw):
    js = jls.init_loss_scale(16, kw["hysteresis"])
    ts = tls.init_loss_scale(16, kw["hysteresis"])
    assert _state(ts) == _state(js)
    for i, ok in enumerate(SERIES):
        js = jls.update_loss_scale(js, jnp.asarray(ok), **kw)
        ts = tls.update_loss_scale(ts, torch.tensor(ok), **kw)
        assert _state(ts) == _state(js), i
    # a static scale starts where it is told
    assert _state(tls.init_loss_scale(static_scale=128.0)) == _state(
        jls.init_loss_scale(static_scale=128.0))


def test_scale_unscale_and_finite_match_reference():
    rng = np.random.default_rng(0)
    g = [rng.standard_normal(s).astype(np.float32) * 1e3 for s in (5, (3, 4))]
    js, ts = jls.init_loss_scale(12), tls.init_loss_scale(12)
    want = jls.unscale_grads([jnp.asarray(a) for a in g], js)
    got = tls.unscale_grads([torch.from_numpy(a.copy()) for a in g], ts)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    loss = np.float32(3.25)
    assert float(tls.scale_loss(torch.tensor(loss), ts)) == float(
        jls.scale_loss(jnp.asarray(loss), js))
    g[1][2, 3] = np.inf
    for arrays in (g[:1], g):
        assert bool(tls.grads_finite([torch.from_numpy(a) for a in arrays])) \
            == bool(jls.grads_finite([jnp.asarray(a) for a in arrays]))


FP16_CFG = {
    "train_batch_size": 4,
    "optimizer": {"type": "adamw",
                  "params": {"lr": 1e-3, "weight_decay": 0.01}},
    "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 4}},
    "fp16": {"enabled": True, "initial_scale_power": 24, "hysteresis": 1,
             "loss_scale_window": 3},
    "steps_per_print": 1000,
}
POISON_STEP = 6  # the loss of this step is multiplied past f32's range


def _poisoned(loss_fn, np_mod):
    """The loss times 1e38 where ``batch['poison']`` is set: inf in the
    loss and every gradient, exactly 1x otherwise."""

    def fn(p, b, r):
        loss, metrics = loss_fn(p, b)
        factor = 1.0 + b["poison"].max() * 1e38
        return loss * factor, metrics

    return fn


def test_fp16_engine_matches_reference():
    kw = dict(dtype="float16", param_dtype="float32", num_kv_heads=2,
              attn_impl="xla", num_layers=2)
    jcfg, tcfg = jt.get_config("tiny", **kw), tt.get_config("tiny", **kw)
    params = jt.init_params(jax.random.PRNGKey(3), jcfg)
    tparams = tt.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                 tcfg, device="cpu", dtype=torch.float32)
    one = MeshTopology.from_config(jconfig.MeshConfig(),
                                   devices=jax.devices()[:1])
    jeng, _, _, _ = deepspeed_tpu.initialize(
        model=JSpec(loss_fn=_poisoned(lambda p, b: jt.loss_fn(
            p, {"input_ids": b["input_ids"]}, jcfg), jnp),
            params=params, param_axes=jt.param_axes(jcfg)),
        config=FP16_CFG, topo=one)
    teng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=TSpec(loss_fn=_poisoned(lambda p, b: tt.loss_fn(
            p, {"input_ids": b["input_ids"]}, tcfg), torch),
            params=tparams), config=FP16_CFG, device="cpu")
    rng = np.random.default_rng(7)
    batch = {"input_ids": rng.integers(0, 256, (4, 32)).astype(np.int32)}
    flags, scales, losses = [], [], []
    for step in range(12):
        b = dict(batch, poison=np.full(
            (4,), float(step == POISON_STEP), np.float32))
        before = {k: v.detach().clone() for k, v in
                  zip(teng._paths, teng._leaves)}
        mu_before = [m.clone() for m in teng.optimizer.mu]
        jm, tm = dict(jeng.train_batch(b)), dict(teng.train_batch(b))
        assert tm["overflow"] == jm["overflow"], step
        assert tm["loss_scale"] == jm["loss_scale"], step
        np.testing.assert_allclose(tm["lr"], jm["lr"], rtol=1e-6)
        if tm["overflow"]:
            for k, v in zip(teng._paths, teng._leaves):
                assert torch.equal(v, before[k]), (step, k)
            for a, b_ in zip(teng.optimizer.mu, mu_before):
                assert torch.equal(a, b_), step
        elif np.isfinite(jm["loss"]):
            np.testing.assert_allclose(tm["loss"], jm["loss"],
                                       rtol=F16_LOSS_RTOL)
        flags.append(tm["overflow"])
        scales.append(tm["loss_scale"])
        losses.append(tm["loss"])
    # the first steps overflow and the scale falls; the poisoned step
    # overflows mid-run; the loss falls once the scale has settled
    assert flags[0] == 1.0 and flags[POISON_STEP] == 1.0
    assert sum(flags) >= 3 and flags[-1] == 0.0
    assert scales[0] == 2.0 ** 24 and scales[-1] < scales[0]
    assert losses[-1] < losses[next(i for i, f in enumerate(flags) if not f)]
    assert int(teng.skipped_steps) == int(jeng.state.skipped_steps) == \
        int(sum(flags))
    assert teng.get_loss_scale() == jeng.get_loss_scale()
    applied = len(flags) - int(sum(flags))
    jp = jax.tree_util.tree_map(np.asarray, jeng.state.params)
    for path, t in zip(teng._paths, teng._leaves):
        node = jp
        for part in path.split("/"):
            node = node[part]
        diff = np.abs(t.detach().numpy() - node)
        assert diff.max() <= F16_PARAM_STEP * applied, (path, diff.max())
        assert diff.mean() <= F16_PARAM_MEAN, (path, diff.mean())


def test_sanity_checks_raise_on_non_finite_unless_overflowed():
    tcfg = tt.get_config("tiny", dtype="float32", num_layers=1)
    params = tt.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    cfg = {"train_batch_size": 2, "sanity_checks": True}
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=TSpec(loss_fn=_poisoned(lambda p, b: tt.loss_fn(
            p, {"input_ids": b["input_ids"]}, tcfg), torch), params=params),
        config=cfg, device="cpu")
    ids = np.zeros((2, 16), np.int32)
    eng.train_batch({"input_ids": ids, "poison": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="sanity_checks: non-finite"):
        eng.train_batch({"input_ids": ids, "poison": np.ones(2, np.float32)})
    # under fp16 the same step overflows, is skipped, and passes the check
    eng16, _, _, _ = deepspeed_tpu_torch.initialize(
        model=TSpec(loss_fn=_poisoned(lambda p, b: tt.loss_fn(
            p, {"input_ids": b["input_ids"]}, tcfg), torch), params=params),
        config=dict(cfg, fp16={"enabled": True}), device="cpu")
    m = eng16.train_batch({"input_ids": ids, "poison": np.ones(2, np.float32)})
    assert m["overflow"] == 1.0
