"""Parity: the port's training step (``deepspeed_tpu_torch.initialize`` ->
``train_batch``) against the JAX package's, piece by piece and whole, on
numpy-seeded inputs in f32 with the reference's weights converted by
``params_from_jax``:

- ``loss_fn`` and ``tiled_loss_fn``: value and gradients (xla and flash
  attention, layers checkpointed), limits 1e-5 (loss) and 1e-4 (grads);
- the LR schedules and AdamW against optax directly, bf16 parameters too;
- three ``train_batch`` steps at gas 1 and 2 with weight decay, clipping
  and WarmupLR: loss, grad_norm and lr within 1e-5 relative per step, final
  parameters within 1e-5;
- the config: typos, the batch arithmetic's errors, refused sections,
  and the sections that run.

The JAX engine runs on a one-device mesh so that both engines see the same
global batch and the same per-step metrics."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.parallel.topology import MeshTopology
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu.runtime.config_utils import ConfigError as JConfigError
from deepspeed_tpu.runtime.engine import ModelSpec as JSpec
from deepspeed_tpu.runtime.lr_schedules import schedules as jsched
from deepspeed_tpu.sequence import tiled_compute as jtc
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.runtime import optimizers as topt
from deepspeed_tpu_torch.runtime.config_utils import ConfigError
from deepspeed_tpu_torch.runtime.engine import ModelSpec as TSpec
from deepspeed_tpu_torch.runtime.lr_schedules import schedules as tsched
from deepspeed_tpu_torch.sequence import tiled_compute as ttc

from tests.torch_cpu import one_torch_thread  # noqa: F401

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
STEP_RTOL = 1e-5  # per-step loss / grad_norm / lr
PARAM_TOL = 1e-5  # final parameters after three steps


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _model(attn_impl, seed=0, **overrides):
    kw = dict(dtype="float32", num_kv_heads=2, attn_impl=attn_impl,
              **overrides)
    jcfg, tcfg = jt.get_config("tiny", **kw), tt.get_config("tiny", **kw)
    params = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = tt.params_from_jax(_np_tree(params), tcfg, device="cpu",
                                 dtype=torch.float32)
    return jcfg, tcfg, params, tparams


def _batch(seed, B=4, S=32, vocab=256, mask=False):
    rng = np.random.default_rng(seed)
    batch = {"input_ids": rng.integers(0, vocab, (B, S)).astype(np.int32)}
    if mask:
        batch["loss_mask"] = (rng.random((B, S)) < 0.8).astype(np.float32)
    return batch


@pytest.mark.parametrize("attn_impl,tiled,overrides", [
    ("xla", False, {}), ("flash", False, {}), ("xla", True, {}),
    ("flash", True, {}), ("xla", False, {"position": "alibi"}),
    ("flash", True, {"parallel_residual": True, "sliding_window": 12})],
    ids=["xla-dense", "flash-dense", "xla-tiled", "flash-tiled",
         "xla-alibi", "flash-window-parallel"])
def test_loss_and_grads_match_reference(attn_impl, tiled, overrides):
    jcfg, tcfg, params, tparams = _model(attn_impl, **overrides)
    batch = _batch(1, mask=tiled)
    if tiled:
        def jloss(p):
            return jtc.tiled_loss_fn(p, jb, jcfg, tile_size=8)

        def tloss(p):
            return ttc.tiled_loss_fn(p, tb, tcfg, tile_size=8)
    else:
        def jloss(p):
            return jt.loss_fn(p, jb, jcfg)

        def tloss(p):
            return tt.loss_fn(p, tb, tcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    leaves = _flat(tparams)
    for t in leaves.values():
        t.requires_grad_(True)
    tl, tm = tloss(tparams)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), atol=LOSS_TOL, rtol=0)
    for key in ("accuracy", "tokens"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   atol=LOSS_TOL, rtol=0)
    jg = _flat(_np_tree(jg))
    assert jg.keys() == leaves.keys()
    for key, g in jg.items():
        np.testing.assert_allclose(leaves[key].grad.numpy(), g,
                                   atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=key)


def test_tiled_mlp_matches_reference():
    jcfg, tcfg, params, tparams = _model("xla")
    jmlp = jax.tree_util.tree_map(lambda a: a[1], params["layers"]["mlp"])
    tmlp = tt.layer_params(tparams, 1)["mlp"]
    x = np.random.default_rng(7).standard_normal((2, 16, 64)).astype(
        np.float32)

    def jf(x):
        return (jtc.tiled_mlp(x, jmlp, jcfg, tile_size=4) ** 2).sum()

    want, want_g = jax.value_and_grad(jf)(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    got = (ttc.tiled_mlp(tx, tmlp, tcfg, tile_size=4) ** 2).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_g),
                               atol=GRAD_TOL, rtol=GRAD_TOL)
    with pytest.raises(ValueError, match="not divisible"):
        ttc.tiled_mlp(tx, tmlp, tcfg, tile_size=5)


def test_remat_off_gives_the_same_gradients_and_bf16_params_get_bf16_grads():
    _, tcfg, _, tparams = _model("xla")
    batch = {k: torch.from_numpy(v) for k, v in _batch(2).items()}
    grads = []
    for policy in ("nothing_saveable", "everything"):
        cfg = dataclasses.replace(tcfg, remat_policy=policy)
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in _flat(tparams).items()}
        tt.loss_fn(_unflat(leaves), batch, cfg)[0].backward()
        grads.append({k: v.grad for k, v in leaves.items()})
    for key in grads[0]:
        torch.testing.assert_close(grads[0][key], grads[1][key], atol=1e-6,
                                   rtol=1e-6)
    cfg = dataclasses.replace(tcfg, param_dtype="bfloat16",
                              dtype="bfloat16")
    p = tt.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                       dtype=tt.param_dtype(cfg))
    leaves = topt.leaves(p)
    for t in leaves:
        t.requires_grad_(True)
    tt.loss_fn(p, batch, cfg)[0].backward()
    assert all(t.grad.dtype == torch.bfloat16 for t in leaves)


def _unflat(flat):
    out = {}
    for key, v in flat.items():
        node = out
        *path, last = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = v
    return out


def test_model_refusals():
    _, tcfg, _, tparams = _model("xla")
    batch = {k: torch.from_numpy(v) for k, v in _batch(3).items()}
    for policy in ("dots", "save_everything"):  # not the reference's names
        with pytest.raises(ValueError, match="unknown remat policy"):
            tt.loss_fn(tparams, batch,
                       dataclasses.replace(tcfg, remat_policy=policy))
    for impl in ("ulysses", "ring"):
        with pytest.raises(NotImplementedError, match="A13"):
            tt.resolve_attention(impl)
    with pytest.raises(ValueError, match="sliding_window"):
        tt.loss_fn(tparams, batch, dataclasses.replace(tcfg,
                                                       sliding_window=8))


def test_schedules_match_reference():
    cases = {
        "WarmupLR": dict(warmup_num_steps=10),
        "WarmupLR_linear": dict(warmup_num_steps=10, warmup_type="linear"),
        "WarmupDecayLR": dict(total_num_steps=30, warmup_num_steps=10),
        "WarmupCosineLR": dict(total_num_steps=30, warmup_num_steps=10),
        "OneCycle": dict(cycle_min_lr=1e-4, cycle_max_lr=1e-2,
                         cycle_first_step_size=5, decay_step_size=3,
                         decay_lr_rate=0.5),
        "LRRangeTest": dict(lr_range_test_staircase=True,
                            lr_range_test_step_size=4),
        "constant": dict(lr=3e-4),
        None: {},
    }
    assert set(tsched.SCHEDULES) == set(jsched.SCHEDULES)
    for name, params in cases.items():
        stype = name.split("_")[0] if name else None
        if name == "WarmupLR_linear":
            stype = "WarmupLR"
        js = jsched.create_scheduler(jconfig.SchedulerConfig(
            type=stype, params=params), base_lr=2e-3)
        ts = tsched.create_scheduler(tconfig.SchedulerConfig(
            type=stype, params=params), base_lr=2e-3)
        # the reference computes in f32: 1e-6 relative, and 5e-8 of the
        # 2e-3 peak lr where a cosine near -1 cancels
        for step in (0, 1, 4, 5, 9, 10, 11, 29, 40):
            np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6,
                                       atol=1e-10, err_msg=f"{name}@{step}")
    with pytest.raises(ConfigError, match="unknown scheduler"):
        tsched.create_scheduler(tconfig.SchedulerConfig(type="Nope"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_optax(dtype):
    """Three AdamW steps with a decay mask and a schedule, f32 gradients on
    parameters of ``dtype``: moments stay f32 and parameters round once per
    step, as optax's ``adamw`` + ``apply_updates`` do."""
    rng = np.random.default_rng(4)
    npdt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    params = {"w": rng.standard_normal((6, 5)).astype(npdt),
              "ln": {"scale": rng.standard_normal(5).astype(npdt)}}
    grads = [{"w": rng.standard_normal((6, 5)).astype(np.float32),
              "ln": {"scale": rng.standard_normal(5).astype(np.float32)}}
             for _ in range(3)]

    def lr(count):
        return 1e-2 * (count + 1)

    mask = {"w": True, "ln": {"scale": False}}
    assert topt.default_weight_decay_mask(params) == mask
    tx = optax.adamw(lr, b1=0.8, b2=0.95, eps=1e-6, weight_decay=0.1,
                     mask=mask)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    tdt = tt.torch_dtype(dtype)
    tp = [torch.from_numpy(np.asarray(params["w"], np.float32)).to(tdt),
          torch.from_numpy(np.asarray(params["ln"]["scale"],
                                      np.float32)).to(tdt)]
    opt = topt.create_optimizer(
        tconfig.OptimizerConfig(type="adamw", params=dict(
            betas=(0.8, 0.95), eps=1e-6, weight_decay=0.1)), lr,
        topt.leaves(mask))
    opt.init(tp)
    for g in grads:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state,
                               jp)
        jp = optax.apply_updates(jp, upd)
        opt.step(tp, [torch.from_numpy(g["w"]),
                      torch.from_numpy(g["ln"]["scale"])])
    assert all(m.dtype == torch.float32 for m in opt.mu + opt.nu)
    for t, j in zip(tp, (jp["w"], jp["ln"]["scale"])):
        assert t.dtype == tdt
        want = np.asarray(j).astype(np.float32)
        if dtype == "bfloat16":  # one rounding apart at most
            np.testing.assert_allclose(t.float().numpy(), want, rtol=2 ** -7,
                                       atol=0)
        else:
            np.testing.assert_allclose(t.numpy(), want, rtol=1e-6,
                                       atol=1e-7)


def test_clip_by_global_norm_matches_optax():
    rng = np.random.default_rng(5)
    g = [rng.standard_normal(s).astype(np.float32) * 3 for s in (7, (3, 4))]
    for max_norm in (0.5, 100.0):
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(a) for a in g], None)
        tg = [torch.from_numpy(a.copy()) for a in g]
        norm = topt.global_norm(tg)
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(
            [jnp.asarray(a) for a in g])), rtol=1e-6)
        topt.clip_by_global_norm(tg, norm, max_norm)
        for t, w in zip(tg, want):
            np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-6)


ENGINE_CFG = {
    "optimizer": {"type": "adamw",
                  "params": {"lr": 1e-3, "weight_decay": 0.01}},
    "gradient_clipping": 1.0,
    "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 3}},
    "steps_per_print": 1000,
}


@pytest.mark.parametrize("gas", [1, 2])
def test_three_engine_steps_match_reference(gas):
    jcfg, tcfg, params, tparams = _model("flash", seed=1)
    cfg = dict(ENGINE_CFG, train_batch_size=8,
               gradient_accumulation_steps=gas)
    one = MeshTopology.from_config(jconfig.MeshConfig(),
                                   devices=jax.devices()[:1])
    jeng, _, _, _ = deepspeed_tpu.initialize(
        model=JSpec(loss_fn=lambda p, b, r: jtc.tiled_loss_fn(
            p, b, jcfg, tile_size=16), params=params,
            param_axes=jt.param_axes(jcfg)), config=cfg, topo=one)
    teng, opt, _, sched = deepspeed_tpu_torch.initialize(
        model=TSpec(loss_fn=lambda p, b, r: ttc.tiled_loss_fn(
            p, b, tcfg, tile_size=16), params=tparams), config=cfg,
        device="cpu")
    assert (teng.train_batch_size, teng.gradient_accumulation_steps,
            teng.train_micro_batch_size_per_device) == \
        (jeng.train_batch_size, jeng.gradient_accumulation_steps,
         jeng.train_micro_batch_size_per_device)
    assert opt is teng.optimizer and sched is teng.lr_schedule
    for step in range(3):
        batch = _batch(10 + step, B=8)
        jm, tm = dict(jeng.train_batch(batch)), dict(teng.train_batch(batch))
        assert set(tm) == set(jm) == {"loss", "accuracy", "tokens",
                                      "grad_norm", "loss_scale", "lr",
                                      "overflow"}
        for key in jm:
            np.testing.assert_allclose(tm[key], jm[key], rtol=STEP_RTOL,
                                       atol=1e-12, err_msg=f"{key}@{step}")
    assert teng.get_global_step() == jeng.get_global_step() == 3
    np.testing.assert_allclose(teng.get_lr(), jeng.get_lr(), rtol=1e-6)
    assert teng.get_loss_scale() == jeng.get_loss_scale() == 1.0
    jp = _flat(_np_tree(jeng.state.params))
    tp = _flat(teng.params)
    for key, w in jp.items():
        np.testing.assert_allclose(tp[key].detach().numpy(), w,
                                   atol=PARAM_TOL, rtol=0, err_msg=key)
    # the caller's tensors are copies the engine never touches
    np.testing.assert_array_equal(_flat(tparams)["layers/attn/wq"].numpy(),
                                  _flat(_np_tree(params))["layers/attn/wq"])
    ev_j, ev_t = jeng.eval_batch(_batch(20, B=8)), teng.eval_batch(
        _batch(20, B=8))
    np.testing.assert_allclose(ev_t["loss"], ev_j["loss"], rtol=STEP_RTOL)
    with pytest.raises(FileNotFoundError, match="checkpoint dir"):
        teng.load_checkpoint("/nonexistent", tag="global_step3",
                             fallback=False)


def test_lazy_metrics_and_batch_checks():
    _, tcfg, _, tparams = _model("xla")
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=TSpec(loss_fn=lambda p, b, r: tt.loss_fn(p, b, tcfg),
                    params=tparams),
        config={"train_micro_batch_size_per_gpu": 2}, device="cpu")
    m = eng.train_batch(_batch(6, B=2))
    assert m._dev is not None  # nothing read yet: still on the device
    assert not isinstance(m, dict) and isinstance(dict(m), dict)
    assert m._dev is None and np.isfinite(m["loss"])
    with pytest.raises(ConfigError, match="train_batch_size"):
        eng.train_batch(_batch(6, B=3))


def test_config_matches_reference_contract():
    # typos raise, at the root and inside a section
    for bad in ({"train_batch_sise": 8}, {"optimizer": {"typ": "adamw"}},
                {"zero_optimization": {"stgae": 0}},
                {"fp16": {"enabeld": True}}):
        with pytest.raises(ConfigError, match="unknown key"):
            tconfig.load_config(bad)
    with pytest.raises(ConfigError, match="must be 0..3"):
        tconfig.load_config({"zero_optimization": {"stage": 4}})
    with pytest.raises(ConfigError, match="int or 'auto'"):
        tconfig.load_config({"train_batch_size": "many"})
    # the batch arithmetic: same results and the same errors as the
    # reference's
    for spec, dp in [
            (dict(train_batch_size=32, train_micro_batch_size_per_gpu=4), 2),
            (dict(train_batch_size=32, gradient_accumulation_steps=2), 4),
            (dict(train_micro_batch_size_per_gpu=3), 2),
            (dict(train_batch_size=12), 3),
            (dict(train_batch_size=30, train_micro_batch_size_per_gpu=4), 2),
            (dict(train_batch_size=30, gradient_accumulation_steps=4), 2),
            (dict(train_batch_size=10, gradient_accumulation_steps="auto"),
             3),
            (dict(train_batch_size=8, train_micro_batch_size_per_gpu=2,
                  gradient_accumulation_steps=3), 1),
            ({}, 1)]:
        try:
            want = jconfig.load_config(dict(spec)).resolve_batch_config(dp)
        except JConfigError as e:
            with pytest.raises(ConfigError) as got:
                tconfig.load_config(dict(spec)).resolve_batch_config(dp)
            assert str(got.value) == str(e)
        else:
            got = tconfig.load_config(dict(spec)).resolve_batch_config(dp)
            assert dataclasses.asdict(got) == want.model_dump()
    # every root key of the reference is known to the port
    assert set(jconfig.DeepSpeedTPUConfig.model_fields) == {
        f.name for f in dataclasses.fields(tconfig.DeepSpeedTPUConfig)}
    # unported sections load, and refuse to run
    for cfg, item in [({"checkpoint": {"engine": "orbax"}}, "A13"),
                      ({"checkpoint": {"load_universal": True}}, "A14"),
                      ({"activation_checkpointing": {
                          "partition_activations": True}}, "A13"),
                      ({"zero_optimization": {"stage": 1}}, "A13"),
                      ({"zero_optimization": {"overlap_comm": True}}, "A13"),
                      ({"pipeline": {"stages": 2}}, "A13"),
                      ({"gradient_compression": {"enabled": True}}, "A13")]:
        c = tconfig.load_config(cfg)
        with pytest.raises(NotImplementedError, match=item):
            c.check_supported()
    # the training engine's sections run (A12, and A14's offload and PEFT)
    for cfg in ({"fp16": {"enabled": True}}, {"sanity_checks": True},
                {"peft": {"lora": {"enabled": True}}},
                {"activation_checkpointing": {"cpu_checkpointing": True}},
                {"zero_optimization": {"offload_optimizer": {
                    "device": "cpu"}}},
                {"checkpoint": {"async_save": True, "engine": "fast"}},
                {"remat": {"policy": "save_attn"}},
                {"activation_checkpointing": {"policy": "dots"}},
                {"data_types": {"master_dtype": "bfloat16"}}):
        tconfig.load_config(cfg).check_supported()
    for cfg in ({"remat": {"policy": "save_nothing"}},
                {"checkpoint": {"integrity": "md5"}}):
        with pytest.raises(ConfigError):
            tconfig.load_config(cfg).check_supported()
    for name in topt.OPTIMIZERS:
        topt.create_optimizer(tconfig.OptimizerConfig(type=name), 1e-3)
    with pytest.raises(ConfigError, match="unknown optimizer"):
        topt.create_optimizer(tconfig.OptimizerConfig(type="adamx"), 1e-3)
    c = tconfig.load_config({"fp16": {"enabled": True}})
    assert c.compute_dtype == "float16" and c.bf16.enabled is False
