"""Parity: ZeRO-Offload / ZeRO-Infinity in the port (``runtime/zero``,
``runtime/zenflow.py``, the engine's offload mode, ``cpu_checkpointing``,
``nvme/ds_io.py``, ``io/bench.py``) against the JAX package's, on a tiny
two-layer f32 model whose weights come from ``params_from_jax`` and on the
same numpy-seeded batches:

- optimizer offload (cpu) against the reference's offloaded engine at
  stage 0 with ``gradient_clipping``: 5 steps (gas 1 and 2), every metric
  and the final parameters within 1e-5;
- the streamed engine (``offload_param``) against the reference's
  ``offload_optimizer`` engine within 1e-5 (the reference on the CPU has no
  host memory space and drops ``offload_param``, as its own test compares);
  ``offload_mask`` equal to the reference's; stream-ins per step;
- the NVMe tiers step for step equal to the CPU tier, with the reference's
  file names and sizes;
- ``delayed_update``: no update at step 1, ``applied_lr``, flush, a save
  that flushes and a load that discards, against the reference within 1e-5;
- ZenFlow (ratio 0.25, update_interval 2, select_interval 4, 8 steps,
  clipping on) against the reference: parameters within 1e-5,
  ``cold_bytes_transferred`` equal;
- offloaded checkpoints written by either package resume in the other as
  an uninterrupted run; ``offload_states`` / ``reload_states``;
- ``cpu_checkpointing`` gradients within ``test_torch_remat``'s 1e-5, the
  tagged tensors packed to the host;
- ``ds_io`` and ``io.bench``: the reference's fields and CLI;
- the reference's ``ConfigError``s, word for word.
"""

import ast
import dataclasses
import json
import os

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
from deepspeed_tpu.runtime import engine as jengine_mod
from deepspeed_tpu.runtime.activation_checkpointing import \
    checkpointing as jck
from deepspeed_tpu.runtime.config_utils import ConfigError as JConfigError
from deepspeed_tpu.runtime.engine import ModelSpec as JSpec
from deepspeed_tpu.runtime.zero import param_offload as jpo
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.runtime.activation_checkpointing import \
    checkpointing as tck
from deepspeed_tpu_torch.runtime.config_utils import ConfigError
from deepspeed_tpu_torch.runtime.engine import ModelSpec as TSpec
from deepspeed_tpu_torch.runtime.zero import param_offload as tpo

from tests.torch_cpu import one_torch_thread  # noqa: F401

TOL = 1e-5
CFG = {
    "train_batch_size": 4,
    "optimizer": {"type": "adamw",
                  "params": {"lr": 1e-3, "weight_decay": 0.01}},
    "gradient_clipping": 0.5,
    "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 3}},
    "steps_per_print": 1000,
}


def _cfg(zero=None, **extra):
    return dict(CFG, zero_optimization={"stage": 0, **(zero or {})},
                **extra)


_MODELS = {}


def _model(seed=1):
    if seed not in _MODELS:
        kw = dict(dtype="float32", num_kv_heads=2, attn_impl="flash",
                  num_layers=2)
        jcfg, tcfg = jt.get_config("tiny", **kw), tt.get_config("tiny", **kw)
        params = jt.init_params(jax.random.PRNGKey(seed), jcfg)
        _MODELS[seed] = (jcfg, tcfg, params,
                         jax.tree_util.tree_map(np.asarray, params))
    return _MODELS[seed]


def _jax_engine(cfg, seed=1):
    jcfg, _, params, _ = _model(seed)
    one = MeshTopology.from_config(jconfig.MeshConfig(),
                                   devices=jax.devices()[:1])
    return deepspeed_tpu.initialize(
        model=JSpec(loss_fn=lambda p, b, r: jt.loss_fn(p, b, jcfg),
                    params=params, param_axes=jt.param_axes(jcfg)),
        config=cfg, topo=one)[0]


_RUNS = {}


def _jax_run(cfg, steps):
    """The reference engine's metrics and parameters after each of
    ``steps`` steps on ``_batch(0..)`` (one run per config)."""
    key = json.dumps(cfg, sort_keys=True)
    if key not in _RUNS or len(_RUNS[key]) < steps:
        eng = _jax_engine(cfg)
        _RUNS[key] = [(dict(eng.train_batch(_batch(step))), _params_of(eng))
                      for step in range(steps)]
    return _RUNS[key][:steps]


def _torch_engine(cfg, seed=1):
    _, tcfg, _, host = _model(seed)
    tparams = tt.params_from_jax(host, tcfg, device="cpu",
                                 dtype=torch.float32)
    return deepspeed_tpu_torch.initialize(
        model=TSpec(loss_fn=lambda p, b, r: tt.loss_fn(p, b, tcfg),
                    params=tparams), config=cfg, device="cpu")[0]


def _batch(step, B=4):
    rng = np.random.default_rng(100 + step)
    return {"input_ids": rng.integers(0, 256, (B, 32)).astype(np.int32)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _params_of(eng):
    if hasattr(eng, "state"):
        return {k: np.asarray(v, np.float32) for k, v in _flat(
            jax.tree_util.tree_map(np.asarray, eng.state.params)).items()}
    return {p: t.detach().float().numpy().copy()
            for p, t in zip(eng._paths, eng._leaves)}


def _same_params(a, b, tol=TOL):
    pa, pb = _params_of(a), _params_of(b)
    assert pa.keys() == pb.keys()
    for k in pa:
        np.testing.assert_allclose(pb[k], pa[k], atol=tol, rtol=0,
                                   err_msg=k)


def _same_metrics(a, b, what):
    a, b = dict(a), dict(b)
    assert set(a) == set(b), (sorted(a), sorted(b))
    for key in a:
        np.testing.assert_allclose(b[key], a[key], rtol=TOL, atol=1e-12,
                                   err_msg=f"{key}@{what}")


# ---------------------------------------------------------------------------
# optimizer offload and the streamed engine
# ---------------------------------------------------------------------------


def _against_run(run, te):
    for step, (jm, jp) in enumerate(run):
        _same_metrics(jm, te.train_batch(_batch(step)), step)
    tp = _params_of(te)
    assert tp.keys() == jp.keys()
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], atol=TOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("gas", [1, 2])
def test_optimizer_offload_matches_reference(gas):
    cfg = _cfg({"offload_optimizer": {"device": "cpu"}},
               gradient_accumulation_steps=gas)
    te = _torch_engine(cfg)
    assert te.offload_enabled and te.offloaded_optimizer is not None
    run = _jax_run(cfg, 5)
    _against_run(run, te)
    assert run[-1][0]["grad_norm"] > 0.5  # the clip acted
    # the host holds the f32 master and the moments; the card, the params
    opt = te.offloaded_optimizer
    assert all(m.dtype == torch.float32 for m in opt.master)
    assert te.optimizer is opt.optimizer


@pytest.mark.parametrize("threshold,gas", [(0, 1), (1000, 2)])
def test_streamed_engine_matches_reference(threshold, gas):
    zero = {"offload_param": {"device": "cpu"},
            "stage3_param_persistence_threshold": threshold}
    te = _torch_engine(_cfg(zero, gradient_accumulation_steps=gas))
    assert te.param_offload_enabled and te.offload_enabled
    mask = {path: j in te._streamed for j, path in enumerate(te._paths)}
    assert mask["layers/attn/wq"] and not mask["embed/tokens"]
    assert mask["layers/ln1/scale"] == (threshold == 0)
    _against_run(_jax_run(_cfg({"offload_optimizer": {"device": "cpu"}},
                               gradient_accumulation_steps=gas), 3), te)


def test_offload_mask_equals_reference():
    jcfg, tcfg, params, host = _model()
    tparams = tt.params_from_jax(host, tcfg, device="cpu",
                                 dtype=torch.float32)
    for min_numel in (0, 1000):
        want = _flat(jpo.offload_mask(params, jt.param_axes(jcfg),
                                      min_numel=min_numel))
        got = _flat(tpo.offload_mask(tparams, min_numel=min_numel))
        assert got == {k: bool(v) for k, v in want.items()}
    assert tpo.resolve_threshold("auto") == 100_000


@pytest.mark.parametrize("policy,per_layer", [("nothing_saveable", 2),
                                              ("everything", 1)])
def test_stream_ins_per_step(policy, per_layer):
    _, tcfg, _, host = _model()
    tcfg = dataclasses.replace(tcfg, remat_policy=policy)
    tparams = tt.params_from_jax(host, tcfg, device="cpu",
                                 dtype=torch.float32)
    eng = deepspeed_tpu_torch.initialize(
        model=TSpec(loss_fn=lambda p, b, r: tt.loss_fn(p, b, tcfg),
                    params=tparams),
        config=_cfg({"offload_param": {"device": "cpu"},
                     "stage3_param_persistence_threshold": 0}),
        device="cpu")[0]
    L = tcfg.num_layers
    for step in range(2):
        tpo.reset_counts()
        eng.train_batch(_batch(step))
        assert tpo.COUNTS["stream_in"] == per_layer * L
    tpo.reset_counts()
    eng.eval_batch(_batch(5))
    assert tpo.COUNTS["stream_in"] == L
    # no engine streams outside its own calls
    tpo.reset_counts()
    tt.loss_fn(tparams, {"input_ids": torch.from_numpy(
        _batch(0)["input_ids"])}, tcfg)
    assert tpo.COUNTS["stream_in"] == 0


def test_nvme_tiers_equal_cpu_tier_with_reference_files(tmp_path):
    cpu = _torch_engine(_cfg({"offload_optimizer": {"device": "cpu"},
                              "offload_param": {"device": "cpu"},
                              "stage3_param_persistence_threshold": 0}))
    tdir, jdir = str(tmp_path / "torch"), str(tmp_path / "jax")

    def nvme(d):
        return _cfg({"offload_optimizer": {"device": "nvme",
                                           "nvme_path": d},
                     "offload_param": {"device": "nvme", "nvme_path": d},
                     "stage3_param_persistence_threshold": 0})

    te = _torch_engine(nvme(tdir))
    opt = te.offloaded_optimizer
    assert opt.master is None and opt._swapped_out  # paged between steps
    for step in range(2):
        a, b = cpu.train_batch(_batch(step)), te.train_batch(_batch(step))
        assert dict(a) == dict(b)
        assert opt.master is None
    _same_params(cpu, te, tol=0)
    opt.drain()
    # the reference engine on the CPU drops offload_param but keeps its
    # NVMe master tier; both write the same files
    je = _jax_engine(nvme(jdir))
    for step in range(2):
        je.train_batch(_batch(step))
    je.offloaded_optimizer.drain()

    def files(d):
        return {f: os.path.getsize(os.path.join(d, f))
                for f in os.listdir(d) if f.endswith(".bin")}

    for sub in ("", "master"):
        want, got = files(os.path.join(jdir, sub)), files(
            os.path.join(tdir, sub))
        assert got == want and got
    for f in files(jdir):  # the moments (and counts) after two steps
        a = np.fromfile(os.path.join(jdir, f), np.uint8)
        b = np.fromfile(os.path.join(tdir, f), np.uint8)
        if a.size == 4:
            assert np.array_equal(a, b), f
        else:
            np.testing.assert_allclose(b.view(np.float32),
                                       a.view(np.float32), atol=TOL,
                                       err_msg=f)
    master = opt.master_for_checkpoint()
    for m, p in zip(master, te._leaves):
        np.testing.assert_array_equal(m.numpy(), p.detach().numpy())


@pytest.mark.parametrize("params", [{"weight_decay": 0.1},
                                    {"weight_decay": 0.1,
                                     "adam_w_mode": False}, {}],
                         ids=["adamw", "adam-l2", "adam"])
def test_one_pass_host_adam_equals_plain_step(params):
    """``ops/cpu_adam.py``'s loop (the offloaded engine's Adam) against
    the plain PyTorch step: parameters and moments within a few f32
    roundings at their scale (~1) after 4 steps (PyTorch's kernels contract
    some products into fused multiply-adds, the loop does not)."""
    from deepspeed_tpu_torch.ops import cpu_adam
    from deepspeed_tpu_torch.runtime import optimizers as topt

    rng = np.random.default_rng(8)
    shapes = [(64, 33), (1000,), (2, 5, 7)]
    params0 = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in shapes]
    runs = []
    for fused in (False, True):
        opt = topt.create_optimizer(
            tconfig.OptimizerConfig(type="adam", params=params),
            lambda c: 1e-2 / (c + 1), [True, False, True])
        ps = [p.clone() for p in params0]
        opt.init(ps)
        assert cpu_adam.supported(opt, ps)
        before = cpu_adam.CALLS["cpu_adam"]
        for step in range(4):
            gs = [torch.from_numpy(np.random.default_rng(step).standard_normal(
                s).astype(np.float32)) for s in shapes]
            (cpu_adam.adam_step if fused else topt.Optimizer.step)(
                opt, ps, gs)
        assert cpu_adam.CALLS["cpu_adam"] - before == (12 if fused else 0)
        runs.append(ps + opt.mu + opt.nu)
    for a, b in zip(*runs):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# the delayed update
# ---------------------------------------------------------------------------


def test_delayed_update_matches_reference_flows(tmp_path):
    cfg = _cfg({"offload_optimizer": {"device": "cpu",
                                      "delayed_update": True}})
    je, te = _jax_engine(cfg), _torch_engine(cfg)
    p0 = _params_of(te)
    lrs = []
    for step in range(4):
        jm, tm = dict(je.train_batch(_batch(step))), dict(
            te.train_batch(_batch(step)))
        _same_metrics(jm, tm, step)
        if step == 0:  # nothing to apply yet: the parameters are as built
            assert "applied_lr" not in tm
            for k, v in _params_of(te).items():
                np.testing.assert_array_equal(v, p0[k])
        else:  # the previous batch's update, at the previous batch's lr
            assert tm["applied_lr"] == pytest.approx(lrs[-1], rel=1e-6)
        lrs.append(tm["lr"])
        _same_params(je, te)
    assert te._pending and je._pending_grads is not None
    je.flush_delayed_update()
    te.flush_delayed_update()
    assert not te._pending and je._pending_grads is None
    _same_params(je, te)
    # a save flushes; a load discards the pending gradients
    te.train_batch(_batch(4))
    assert te._pending
    te.save_checkpoint(str(tmp_path / "ck"))
    assert not te._pending
    saved = _params_of(te)
    te.train_batch(_batch(5))
    assert te._pending
    te.load_checkpoint(str(tmp_path / "ck"))
    assert not te._pending
    for k, v in _params_of(te).items():
        np.testing.assert_array_equal(v, saved[k])
    # eval flushes too
    te.train_batch(_batch(6))
    te.eval_batch(_batch(7))
    assert not te._pending


# ---------------------------------------------------------------------------
# ZenFlow
# ---------------------------------------------------------------------------


def test_zenflow_matches_reference():
    cfg = _cfg({"offload_optimizer": {"device": "cpu"}}, zenflow={
        "enabled": True, "topk_ratio": 0.25, "update_interval": 2,
        "select_interval": 4})
    je, te = _jax_engine(cfg), _torch_engine(cfg)
    jz, tz = je.zenflow_optimizer, te.zenflow_optimizer
    assert tz.update_interval == jz.update_interval == 2
    assert tz.select_interval == jz.select_interval == 4
    for step in range(8):
        _same_metrics(je.train_batch(_batch(step)),
                      te.train_batch(_batch(step)), step)
        if step == 0:  # a hot step moves no cold byte
            assert tz.cold_bytes_transferred == 0
        assert tz.cold_bytes_transferred == jz.cold_bytes_transferred
        # the same hot columns
        for a, b in zip(jax.tree_util.tree_leaves(jz._indices),
                        tz._indices):
            assert sorted(np.asarray(a).tolist()) == sorted(b.tolist())
    assert tz.cold_bytes_transferred > 0
    _same_params(je, te)
    # the compact state is O(topk_ratio) of the matrices
    full = sum(p.numel() for p in te._leaves if p.ndim >= 2)
    compact = sum(h.numel() for h, p in zip(tz._hot_master, te._leaves)
                  if p.ndim >= 2)
    assert compact <= 0.3 * full


def test_zenflow_save_flushes_and_load_resets(tmp_path):
    """The reference's flow (``tests/test_offload_overlap.py``): a save
    mid-interval flushes the cold sums; a load drops the card's selective
    state so the restored weights survive the next step."""
    te = _torch_engine(_cfg({"offload_optimizer": {"device": "cpu"}},
                            zenflow={"enabled": True, "topk_ratio": 0.25,
                                     "update_interval": 4}))
    zf = te.zenflow_optimizer
    for step in range(2):  # mid-interval: the cold sums are not empty
        te.train_batch(_batch(step))
    assert zf._steps_since_flush == 2 and zf.cold_bytes_transferred == 0
    te.save_checkpoint(str(tmp_path / "t"))
    assert zf._steps_since_flush == 0 and zf.cold_bytes_transferred > 0
    assert all(float(a.abs().max()) == 0.0 for a in zf._cold_acc)
    saved = _params_of(te)
    for step in range(2, 5):
        te.train_batch(_batch(step))
    te.load_checkpoint(str(tmp_path / "t"))
    assert zf._indices is None and zf._hot_master is None
    for k, v in _params_of(te).items():
        np.testing.assert_allclose(v, saved[k], atol=1e-6)
    master = te.offloaded_optimizer.master
    for m, p in zip(master, te._leaves):
        np.testing.assert_array_equal(m.numpy(), p.detach().numpy())
    m = dict(te.train_batch(_batch(5)))  # re-selects, trains on
    assert np.isfinite(m["loss"]) and zf._indices is not None


# ---------------------------------------------------------------------------
# checkpoints and state offload
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_offloaded_checkpoint_crosses_packages(saver, tmp_path):
    cfg = _cfg({"offload_optimizer": {"device": "cpu"}})
    make = {"jax": _jax_engine, "torch": _torch_engine}
    first = make[saver](cfg)
    for step in range(2):
        first.train_batch(_batch(step))
    first.save_checkpoint(str(tmp_path), client_state={"epoch": 1})
    second = make["torch" if saver == "jax" else "jax"](cfg, seed=5)
    path, client = second.load_checkpoint(str(tmp_path))
    assert path.endswith("global_step2") and client == {"epoch": 1}
    for step in range(2, 4):
        _same_metrics(first.train_batch(_batch(step)),
                      second.train_batch(_batch(step)), step)
    _same_params(first, second)


def test_offload_and_reload_states():
    cfg = _cfg()
    eng, ref = _torch_engine(cfg), _torch_engine(cfg)
    batches = [_batch(s) for s in range(4)]
    for b in batches[:2]:
        _same_metrics(ref.train_batch(b), eng.train_batch(b), "pre")
    eng.offload_states()  # default: the optimizer state
    assert eng.states_offloaded
    assert all(t.device.type == "cpu" for lst in eng.optimizer._leaf_state()
               for t in lst if t is not None)
    eng.offload_states(include=("lp_params",))
    assert all(p.device.type == "cpu" for p in eng._leaves)
    eng.eval_batch(batches[0])  # reloads the parameters only
    assert eng._offloaded_states == {"optim_states": True}
    eng.reload_states()
    assert not eng.states_offloaded
    eng.offload_states()  # train_batch reloads by itself
    for b in batches[2:]:
        _same_metrics(ref.train_batch(b), eng.train_batch(b), "post")
    _same_params(ref, eng, tol=0)
    with pytest.raises(ConfigError):
        eng.offload_states(include=("hp_params_nope",))
    with pytest.raises(ConfigError):
        eng.offload_states(device="nvme")
    # under offload_optimizer the state is on the host already
    off = _torch_engine(_cfg({"offload_optimizer": {"device": "cpu"}}))
    off.offload_states()
    assert not off.states_offloaded


# ---------------------------------------------------------------------------
# cpu_checkpointing
# ---------------------------------------------------------------------------


def test_cpu_checkpointing_matches_reference():
    rng = np.random.default_rng(9)
    w1, w2 = (rng.standard_normal((16, 16)).astype(np.float32) * 0.3
              for _ in range(2))
    x = rng.standard_normal((3, 4, 16)).astype(np.float32)

    def jf(x):
        h = jnp.tanh(x @ w1)
        h = jck.checkpoint_name(h, "ckpt")
        m = jck.checkpoint_name(jnp.tanh(h @ w2), "mlp_out")
        return jnp.einsum("bsd,btd->bst", m, h)

    def tf(x):
        h = torch.tanh(x @ torch.from_numpy(w1))
        h = tck.checkpoint_name(h, "ckpt")
        m = tck.checkpoint_name(torch.tanh(h @ torch.from_numpy(w2)),
                                "mlp_out")
        return torch.einsum("bsd,btd->bst", m, h)

    jcfg = jconfig.ActivationCheckpointingConfig(cpu_checkpointing=True)
    tcfg = tconfig.ActivationCheckpointingConfig(cpu_checkpointing=True)
    want, want_g = jax.value_and_grad(
        lambda x: (jck.checkpoint(jf, x, cfg=jcfg) ** 2).sum())(
            jnp.asarray(x))
    before = dict(tck.HOST_SAVED)
    tx = torch.from_numpy(x).requires_grad_()
    got = (tck.checkpoint(tf, tx, cfg=tcfg) ** 2).sum()
    assert tck.HOST_SAVED["tensors"] > before["tensors"]
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_g),
                               atol=1e-5, rtol=1e-5)
    assert tck.get_policy(tcfg) == tck.CPU_POLICY


def test_cpu_checkpointing_over_model_layers():
    """The model's layers tag ``attn_out`` and ``mlp_out`` as the
    reference's do; under ``cpu_checkpointing`` the gradients equal the
    uncheckpointed model's.  Those tensors feed only residual adds, whose
    backward reads no input, so nothing is packed to the host (and no other
    tensor passes for a tagged one)."""
    _, tcfg, _, host = _model()
    tcfg = dataclasses.replace(tcfg, remat_policy="everything")
    batch = {"input_ids": torch.from_numpy(_batch(3)["input_ids"])}
    tparams = tt.params_from_jax(host, tcfg, device="cpu",
                                 dtype=torch.float32)
    keys = list(_flat(tparams))

    def tree_of(ls):
        tree = {}
        for k, v in zip(keys, ls):
            node = tree
            *path, last = k.split("/")
            for part in path:
                node = node.setdefault(part, {})
            node[last] = v
        return tree

    def loss(*ls):
        return tt.loss_fn(tree_of(ls), batch, tcfg)[0]

    grads = []
    for cpu in (False, True):
        leaves = [v.detach().clone().requires_grad_()
                  for v in _flat(tparams).values()]
        before = tck.HOST_SAVED["tensors"]
        tl = tck.checkpoint(loss, *leaves, cfg=tconfig.
                            ActivationCheckpointingConfig(
                                cpu_checkpointing=cpu))
        assert tck.HOST_SAVED["tensors"] == before
        tl.backward()
        grads.append([leaf.grad for leaf in leaves])
    for k, a, b in zip(keys, *grads):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# ds_io and io.bench
# ---------------------------------------------------------------------------


def test_ds_io_matches_reference(tmp_path, capsys):
    from deepspeed_tpu.nvme import ds_io as jio
    from deepspeed_tpu_torch.nvme import ds_io as tio

    want = jio.run_bench(str(tmp_path / "j.dat"), op="write", size_mb=4,
                         block_size=1 << 18, queue_depth=4, thread_count=2)
    got = tio.run_bench(str(tmp_path / "t.dat"), op="write", size_mb=4,
                        block_size=1 << 18, queue_depth=4, thread_count=2)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    assert got.gbps > 0 and got.size_bytes == want.size_bytes == 4 << 20
    results = tio.run_sweep(str(tmp_path / "sweep"), op="read", size_mb=2,
                            block_sizes=[1 << 18], queue_depths=[2, 4],
                            thread_counts=[1, 2])
    assert len(results) == 4
    assert results[0].gbps >= results[-1].gbps  # fastest first
    cfg = tio.generate_aio_config(results)
    assert cfg.keys() == jio.generate_aio_config(results).keys()
    assert set(cfg["aio"]) == {f.name for f in dataclasses.fields(
        tconfig.AIOConfig)} - {"use_gds"}
    qd = tio.queue_depth_sweep(str(tmp_path / "qd"), op="write", size_mb=2,
                               depths=(1, 4), backends=("threads",))
    assert [r.queue_depth for r in qd] == [1, 4]
    outs = []
    for mod, name in ((jio, "j"), (tio, "t")):
        assert mod.main(["bench", "--path", str(tmp_path / f"c{name}.dat"),
                         "--op", "write", "--size_mb", "2",
                         "--queue_depth", "2", "--threads", "1"]) == 0
        outs.append(json.loads(capsys.readouterr().out.strip()
                               .splitlines()[-1]))
    assert outs[0].keys() == outs[1].keys() and outs[1]["gbps"] > 0
    with pytest.raises(ValueError, match="refuses to overwrite"):
        open(tmp_path / "exists.dat", "wb").close()
        tio.run_bench(str(tmp_path / "exists.dat"), op="write", size_mb=1)


def test_io_bench_matches_reference(monkeypatch, tmp_path):
    from deepspeed_tpu.io import bench as jbench
    from deepspeed_tpu_torch.io import bench as tbench

    monkeypatch.chdir(tmp_path)
    want, got = jbench.run(1), tbench.run(1)
    assert got.keys() == want.keys()
    assert got["payload_mb"] == want["payload_mb"]
    assert got["value"] == got["speedup_durable"] > 0


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------


def _reference_config_errors():
    tree = ast.parse(open(jengine_mod.__file__).read())
    return {node.exc.args[0].value for node in ast.walk(tree)
            if isinstance(node, ast.Raise) and isinstance(node.exc, ast.Call)
            and getattr(node.exc.func, "id", "") == "ConfigError"
            and node.exc.args and isinstance(node.exc.args[0], ast.Constant)}


@pytest.mark.parametrize("case", [
    {"fp16": {"enabled": True}, "bf16": {"enabled": False},
     "zero_optimization": {"offload_optimizer": {"device": "cpu"}}},
    {"fp16": {"enabled": True}, "bf16": {"enabled": False},
     "zero_optimization": {"offload_param": {"device": "cpu"}}},
    {"zenflow": {"enabled": True}},
    {"zenflow": {"enabled": True}, "zero_optimization": {
        "offload_optimizer": {"device": "cpu"},
        "offload_param": {"device": "cpu"}}},
    {"peft": {"lora": {"enabled": True}},
     "zero_optimization": {"offload_optimizer": {"device": "nvme"}}},
    {"peft": {"lora": {"enabled": True}}, "zenflow": {"enabled": True}},
], ids=["fp16-optimizer", "fp16-param", "zenflow-alone", "zenflow-param",
        "peft-offload", "peft-zenflow"])
def test_offload_config_errors_are_the_references(case):
    with pytest.raises(ConfigError) as got:
        tconfig.load_config(dict(case)).check_supported()
    assert str(got.value) in _reference_config_errors()
    if "offload_param" not in case.get("zero_optimization", {}) or \
            "fp16" in case:
        # the reference raises the same on the CPU (where it drops
        # offload_param only after its fp16 check)
        with pytest.raises(JConfigError) as want:
            _jax_engine(dict(CFG, **case))
        assert str(want.value) == str(got.value)


def test_offload_config_runs_and_later_items_refuse():
    for cfg in ({"zero_optimization": {"offload_optimizer": {
                    "device": "nvme", "nvme_path": "/x",
                    "delayed_update": True}}},
                {"zero_optimization": {"offload_param": {"device": "cpu"},
                                       "stage3_param_persistence_threshold":
                                           "auto"}},
                {"aio": {"block_size": 4096, "queue_depth": 4}},
                {"zenflow": {"enabled": True}, "zero_optimization": {
                    "offload_optimizer": {"device": "cpu"}}},
                {"activation_checkpointing": {"cpu_checkpointing": True}},
                # offload and ZenFlow at stages 1-3 (A13 part 2)
                {"zero_optimization": {
                    "stage": 2, "offload_optimizer": {"device": "cpu"}}},
                {"zenflow": {"enabled": True}, "zero_optimization": {
                    "stage": 1, "offload_optimizer": {"device": "cpu"}}},
                {"zero_optimization": {
                    "stage": 3, "offload_optimizer": {"device": "nvme"},
                    "offload_param": {"device": "nvme"}}}):
        tconfig.load_config(cfg).check_supported()
    # tensor parallelism is a later part of A13, offloaded or not
    with pytest.raises(NotImplementedError, match="A13"):
        tconfig.load_config({"mesh": {"tensor_parallel_size": 2},
                             "zero_optimization": {
            "stage": 2, "offload_optimizer": {"device": "cpu"}}}
        ).check_supported()
    # PEFT runs (tests/test_torch_peft.py); with offload, the reference's
    # ConfigError
    tconfig.load_config({"peft": {"lora": {"enabled": True}}}
                        ).check_supported()
    with pytest.raises(ConfigError, match="peft.lora \\+ offload"):
        tconfig.load_config({"peft": {"lora": {"enabled": True}},
                             "zero_optimization": {"offload_optimizer": {
                                 "device": "cpu"}}}).check_supported()
    with pytest.raises(ConfigError, match="must be one of"):
        tconfig.load_config({"zero_optimization": {"offload_optimizer": {
            "device": "gpu"}}})
    from deepspeed_tpu_torch.parallel.topology import MeshTopology
    from deepspeed_tpu_torch.runtime import zero

    # the sharding names are ported (A13)
    topo = MeshTopology({"fsdp": 2}, devices=[0, 1])
    assert zero.rules_for_params(3, topo).fsdp_fallback
    with zero.Init(topo) as ctx:
        shard = ctx.init_sharded(lambda: {"w": torch.ones(4, 6)},
                                 {"w": ("embed", "mlp")})
    assert shard["w"].shape == (2, 6)
    assert zero.shard_pytree({"w": torch.ones(4, 6)}, {"w": (None, "embed")},
                             zero.rules_for_params(3, topo),
                             topo)["w"].shape == (4, 3)
