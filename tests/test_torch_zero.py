"""ZeRO stages 1-3 on the port against the JAX package (ROADMAP.md A13,
part 1): the sharding rules, bucket plans and logical axes exactly (host
logic), and the training engine on gloo worlds of 1, 2 and 4
(``tests/torch_dist.py``: groups of scenarios in process sets, each group
and each reference run computed once in a test run, whichever xdist worker
asks first) against the
reference's engine on the matching ``jax.devices()[:n]`` sub-mesh — the
same numpy-seeded weights and batches, three steps, losses to 1e-5 and
parameters to 1e-4 — plus each stage against the port's own stage 0 at a
world of one, MiCS, qwZ, qgZ and 1-bit, checkpoints moved between stages,
the fp32 export of a stage-3 checkpoint, stage 3's resident and gathered
bytes, the comms counts of each stage, and the refusals that still name
A13.
"""

import dataclasses
import functools
import math

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.linear import optimized_linear as jl
from deepspeed_tpu.linear.config import LoRAConfig as JLoRAConfig
from deepspeed_tpu.models import encoder as je
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.ops import quantizer as jq
from deepspeed_tpu.parallel.topology import MeshTopology as JTopo
from deepspeed_tpu.runtime import coalesce as jco
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu.runtime.config_utils import ConfigError as JConfigError
from deepspeed_tpu.runtime.engine import ModelSpec as JSpec
from deepspeed_tpu.runtime.zero import sharding as jsh
from deepspeed_tpu.sequence import tiled_compute as jtc
from deepspeed_tpu_torch.linear import optimized_linear as tl
from deepspeed_tpu_torch.linear.config import LoRAConfig as TLoRAConfig
from deepspeed_tpu_torch.models import encoder as te
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.ops import quantizer as tq
from deepspeed_tpu_torch.parallel.topology import MeshTopology as TTopo
from deepspeed_tpu_torch.runtime import coalesce as tco
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.runtime.config_utils import ConfigError
from deepspeed_tpu_torch.runtime.zero import sharding as tsh

from tests.torch_cpu import one_torch_thread  # noqa: F401
from tests.torch_dist import launch, shared

LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
FLASH = dict(dtype="float32", num_kv_heads=2, attn_impl="flash")
XLA = dict(dtype="float32", num_kv_heads=2, attn_impl="xla")
BASE = {"gradient_clipping": 1.0, "steps_per_print": 1000,
        "optimizer": {"type": "adamw",
                      "params": {"lr": 1e-3, "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_num_steps": 3}}}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batches(n=3, B=8, S=32, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 256, (B, S)).astype(np.int32)}
            for _ in range(n)]


def _weights(model):
    return _np_tree(jt.init_params(jax.random.PRNGKey(1),
                                   jt.get_config("tiny", **model)))


def _cfg(stage, gas=1, zero=None, **extra):
    return dict(BASE, train_batch_size=8, gradient_accumulation_steps=gas,
                zero_optimization=dict({"stage": stage}, **(zero or {})),
                **extra)


#: name -> (world, model, config); the reference runs each on a sub-mesh
CASES = {
    "stage1": (2, XLA, _cfg(1)),
    "stage2": (2, XLA, _cfg(2)),
    "stage3": (2, FLASH, _cfg(3, gas=2)),
    "qwz": (2, XLA, _cfg(3, zero={"zero_quantized_weights": True})),
    "qgz": (2, XLA, _cfg(2, zero={"zero_quantized_gradients": True})),
    "onebit": (2, XLA, _cfg(2, gradient_compression={
        "enabled": True, "freeze_step": 1})),
    "dp2xfsdp2_stage2": (4, XLA, _cfg(2, mesh={"data_parallel_size": 2,
                                               "fsdp_size": 2})),
    # MiCS: fsdp = the shard size (2), dp = the replica groups (2)
    "mics": (4, XLA, _cfg(3, zero={"mics_shard_size": 2})),
}
_ONEBIT = _cfg(2, gradient_compression={"enabled": True, "freeze_step": 1})
#: name -> (the saving engine's config, the loading engine's, fp32 export)
#: the cases whose eval is held against the reference's
EVAL_CASES = ("stage1", "stage3", "qwz")
CKPT = {"ckpt_1to3": (_cfg(1), _cfg(3), False),
        "ckpt_3to1": (_cfg(3), _cfg(1), True),
        # 1-bit's residuals are saved and restored: the next compressed
        # step is the saving engine's own
        "ckpt_onebit": (_ONEBIT, _ONEBIT, False)}


def _scenario(name, model, config):
    return (name, dict(kind="engine", preset="tiny", model=model,
                       params=_weights(model), config=config,
                       batches=_batches()))


#: the port's scenarios in process sets of their world's size, each run
#: once for the whole test run: group -> (world, its scenarios' names)
GROUPS = {
    "s12": (2, ["stage1", "stage2"]),
    "s3": (2, ["stage3", "qwz"]),
    "wire": (2, ["qgz", "onebit"]),
    "w4": (4, ["dp2xfsdp2_stage2", "mics"]),
    "ckpt": (2, sorted(CKPT) + ["refuse_lamb", "refuse_param_offload"]),
    # world of one: each stage against stage 0
    "w1": (1, [f"w1_stage{s}" for s in (0, 1, 2, 3)]),
}
GROUP_OF = {n: g for g, (_, names) in GROUPS.items() for n in names}


def _port_scenario(name, tmp_path_factory):
    """The port's scenario ``name`` (a ``tests/torch_dist.py`` job)."""
    if name in CASES:
        return _scenario(name, *CASES[name][1:])
    if name in CKPT:
        save, load, export = CKPT[name]
        return (name, dict(
            kind="checkpoint", preset="tiny", model=XLA,
            params=_weights(XLA), batches=_batches(seed=3),
            dir=str(tmp_path_factory.mktemp(name)), save_config=save,
            load_config=load, export=export))
    if name.startswith("w1_stage"):
        return _scenario(name, FLASH, _cfg(int(name[-1])))
    config = dict(_cfg(2), optimizer={"type": "lamb"}) \
        if name == "refuse_lamb" else _cfg(2, zero={
            "offload_optimizer": {"device": "cpu"},
            "offload_param": {"device": "cpu"}})
    return (name, dict(kind="engine", preset="tiny", model=XLA,
                       params=_weights(XLA), config=config,
                       batches=_batches(1)))


def _run_group(group, tmp_path_factory):
    """{name: every rank's result} of ``group``'s process set, and the
    modules its ranks loaded."""
    world, names = GROUPS[group]
    runs = launch(world, [_port_scenario(n, tmp_path_factory)
                          for n in names],
                  tmp_path_factory.mktemp(f"group_{group}"))
    return {k: [r[k] for r in runs] for k in runs[0]}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """name -> every rank's result of the port's scenario ``name``; its
    group runs once in the whole test run (``torch_dist.shared``), and
    every group read is checked for ranks that imported JAX."""
    def get(name):
        res = shared(tmp_path_factory, f"zero_{GROUP_OF[name]}",
                     lambda: _run_group(GROUP_OF[name], tmp_path_factory))
        assert res["_modules"] == [[]] * len(res["_modules"])
        return res[name]

    return get


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """case -> the reference's (parameters, steps, shard report, eval) of
    ``case``, once in the whole test run."""
    return lambda case: shared(
        tmp_path_factory, f"zero_ref_{case}",
        lambda: _reference(*CASES[case], eval_case=case in EVAL_CASES))


def _ok(results):
    for r in results:
        assert not (isinstance(r, dict) and "error" in r), r["error"]
    return results


def _reference(world, model, config, eval_case=False):
    jcfg = jt.get_config("tiny", **model)
    params = jt.init_params(jax.random.PRNGKey(1), jcfg)
    zero = config["zero_optimization"]
    mesh = jconfig.MeshConfig(**config.get("mesh", {}))
    # the reference folds the mesh itself only on all of jax.devices():
    # fold it the same way for the sub-mesh
    if zero["stage"] >= 3 and zero.get("mics_shard_size", -1) > 0:
        mesh = jconfig.MeshConfig(**{**mesh.model_dump(), "fsdp_size":
                                     zero["mics_shard_size"],
                                     "data_parallel_size": "auto"})
    elif zero["stage"] >= 3 and mesh.fsdp_size in ("auto", 1):
        mesh = jconfig.MeshConfig(**{**mesh.model_dump(),
                                     "fsdp_size": "auto",
                                     "data_parallel_size": 1})
    topo = JTopo.from_config(mesh, devices=jax.devices()[:world])
    eng, _, _, _ = deepspeed_tpu.initialize(
        model=JSpec(loss_fn=lambda p, b, r: jtc.tiled_loss_fn(
            p, b, jcfg, tile_size=16), params=params,
            param_axes=jt.param_axes(jcfg)), config=config, topo=topo)
    steps = [dict(eng.train_batch(b)) for b in _batches()]
    # an eval compiles a program of its own: the cases whose eval differs
    # (a replicated, a sharded and a quantized-gather engine) take one
    ev = eng.eval_batch(_batches()[0]) if eval_case else None
    return (_flat(_np_tree(eng.state.params)), steps, eng.shard_report(), ev)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_engine_matches_reference(port, ref, name):
    res = _ok(port(name))
    want, steps, rep, ev = ref(name)
    for r in res:  # every rank reports the same (replicated) metrics
        assert len(r["steps"]) == 3
        for k, (jm, tm) in enumerate(zip(steps, r["steps"])):
            assert set(tm) == set(jm)
            # stage 3 reports the global batch's tokens as the reference's
            # does (ROADMAP.md C10), stages 1-2 each rank's average, as
            # the reference's explicit data-parallel step does
            np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=LOSS_TOL,
                                       err_msg=f"loss@{k}")
            for key in ("grad_norm", "lr", "tokens", "loss_scale",
                        "overflow"):
                np.testing.assert_allclose(tm[key], jm[key], rtol=1e-4,
                                           atol=1e-7, err_msg=f"{key}@{k}")
    got = res[0]["params"]
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, atol=PARAM_TOL, rtol=0,
                                   err_msg=key)
    assert res[0]["report"]["total_bytes"] == rep["total_bytes"]
    assert res[0]["report"]["per_device_bytes"] == rep["per_device_bytes"]
    if name in EVAL_CASES:
        np.testing.assert_allclose(res[0]["eval"]["loss"], ev["loss"],
                                   rtol=LOSS_TOL)


def test_each_stage_matches_stage0_at_world_one(port):
    base = _ok(port("w1_stage0"))[0]
    for s in (1, 2, 3):
        r = _ok(port(f"w1_stage{s}"))[0]
        for k, (a, b) in enumerate(zip(base["steps"], r["steps"])):
            np.testing.assert_allclose(b["loss"], a["loss"], rtol=LOSS_TOL,
                                       err_msg=f"stage {s} step {k}")
        for key, w in base["params"].items():
            np.testing.assert_allclose(r["params"][key], w, atol=PARAM_TOL,
                                       rtol=0, err_msg=f"stage {s} {key}")


def _layer_bytes(shapes):
    return sum(4 * math.prod(s[1:]) for k, s in shapes.items()
               if k.startswith("layers/"))


def test_collectives_per_stage(port):
    """The comms logger's counts of three steps at a world of one (gas 1,
    2 layers): every stage issues its collectives over groups of one."""
    L, steps = 2, 3
    counts = {s: _ok(port(f"w1_stage{s}"))[0]["counts"]
              for s in range(4)}
    assert counts[0] == {}
    dp = "('dp', 'fsdp')"
    # one bucket of the 11 gradients (all-reduced, or at stage 2 reduce-
    # scattered), the metrics' all-reduce, one all-gather of the updated
    # shards
    assert counts[1] == {f"all_reduce@{dp}": 2 * steps,
                         f"all_gather@{dp}": steps}
    assert counts[2] == {f"reduce_scatter@{dp}": steps,
                         f"all_reduce@{dp}": steps,
                         f"all_gather@{dp}": steps}
    # stage 3: the embedding and final norm once a micro-batch, each layer
    # in forward and again in the remat recompute; a reduce-scatter a layer
    # and one for the top in backward; the shards' gradients over dp; the
    # metrics over the world
    assert counts[3] == {"all_gather@fsdp": steps * (1 + 2 * L),
                         "reduce_scatter@fsdp": steps * (1 + L),
                         "all_reduce@dp": steps,
                         f"all_reduce@{dp}": steps}


def test_stage3_holds_shards_and_gathers_per_layer(port):
    r2 = _ok(port("stage3"))
    full = _ok(port("w1_stage3"))[0]
    total = sum(v.size * 4 for v in full["params"].values())
    assert full["resident"] == total
    shapes = {k: v.shape for k, v in full["params"].items()}
    layer = _layer_bytes(shapes)  # one layer's leaves, whole
    top = total - 2 * layer
    for r in r2:
        # the tiny model's every dim divides by 2: each rank holds half
        assert r["resident"] == total // 2
        # alive at once: the top leaves and at most two layers, never all
        assert top + layer <= r["peak_live"] <= top + 2 * layer
    assert full["peak_live"] <= top + 2 * layer
    # qwZ gathers int8 codes and f32 block scales, not the weights
    q = _ok(port("qwz"))[0]
    assert "all_gather@fsdp" in q["bytes"]
    s3 = _ok(port("stage3"))[0]
    assert q["bytes"]["all_gather@fsdp"] < s3["bytes"]["all_gather@fsdp"] / 2


@pytest.mark.parametrize("name", sorted(CKPT))
def test_checkpoint_moves_between_stages(port, name):
    res = _ok(port(name))
    for r in res:
        np.testing.assert_allclose(r["eval_loaded"]["loss"],
                                   r["eval_saved"]["loss"], rtol=1e-6)
        np.testing.assert_allclose(r["step_loaded"]["loss"],
                                   r["step_saved"]["loss"], rtol=1e-6)
        np.testing.assert_allclose(r["step_loaded"]["grad_norm"],
                                   r["step_saved"]["grad_norm"], rtol=1e-5)
        if name == "ckpt_onebit":
            assert r["onebit_file"]
    if CKPT[name][2]:
        from safetensors.numpy import load_file

        fp32 = res[0]["fp32"]
        model = load_file(res[0]["path"] + "/model.safetensors")
        assert set(fp32) == set(model)
        for k, v in model.items():
            assert fp32[k].dtype == np.float32
            np.testing.assert_array_equal(fp32[k], v.astype(np.float32))


def test_engine_refusals_on_a_world(port):
    err = port("refuse_lamb")[0]["error"]
    assert "NotImplementedError" in err and "A13" in err and "lamb" in err
    # offload runs on a world (tests/test_torch_zero_offload.py);
    # offload_param below stage 3 on one is a later part of A13
    err = port("refuse_param_offload")[0]["error"]
    assert "NotImplementedError" in err and "A13" in err
    assert "offload_param" in err


def test_ranks_import_no_jax(port):
    """Every group's ranks import no JAX (the ``port`` fixture checks each
    group a test reads); here the world of one's."""
    assert _ok(port("w1_stage0"))


# ---------------------------------------------------------------------------
# host logic, exactly the reference's
# ---------------------------------------------------------------------------


TOPOS = [(2, {}), (4, {"data_parallel_size": 2, "fsdp_size": 2}),
         (8, {"fsdp_size": 8, "data_parallel_size": 1}),
         (8, {"fsdp_size": 4}), (1, {})]


def _topos(n, mesh):
    return (JTopo.from_config(jconfig.MeshConfig(**mesh),
                              devices=jax.devices()[:n]),
            TTopo.from_config(tconfig.MeshConfig(**mesh),
                              devices=list(range(n))))


def _spec_map_jax(shardings):
    return {jax.tree_util.keystr(p): tuple(s.spec) for p, s in
            jax.tree_util.tree_flatten_with_path(shardings)[0]}


def _spec_map_torch(shardings):
    return {p: s.spec for p, s in tsh.leaves_with_path(shardings)}


@functools.lru_cache(None)
def _dense_trees():
    jcfg = jt.get_config("tiny", **XLA)
    tcfg = tt.get_config("tiny", **XLA)
    return (jt.init_params(jax.random.PRNGKey(0), jcfg), jt.param_axes(jcfg),
            tt.init_params(tcfg, torch.Generator().manual_seed(0),
                           device="meta", dtype=torch.float32),
            tt.param_axes(tcfg))


@functools.lru_cache(None)
def _lora_trees(quantize):
    model = dict(XLA, hidden_size=64)
    jcfg, tcfg = jt.get_config("tiny", **model), tt.get_config("tiny", **model)
    q = {"quantize_base": quantize}
    if quantize:
        q["quantization"] = {"q_bits": 8, "mantissa_bits": 0,
                             "group_size": 64}
    jp, ja = jl.apply_lora(jt.init_params(jax.random.PRNGKey(0), jcfg),
                           jt.param_axes(jcfg), jax.random.PRNGKey(1),
                           JLoRAConfig(enabled=True, lora_r=4, **q))
    tp, ta = tl.apply_lora(
        tt.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu",
                       dtype=torch.float32), tt.param_axes(tcfg),
        torch.Generator().manual_seed(1),
        TLoRAConfig(enabled=True, lora_r=4, **q))
    return jp, ja, tp, ta


@pytest.mark.parametrize("tree", ["dense", "lora", "qlora"])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("n,mesh", TOPOS)
def test_sharding_rules_match_reference(tree, stage, n, mesh):
    jtop, ttop = _topos(n, mesh)
    jp, ja, tp, ta = _dense_trees() if tree == "dense" else \
        _lora_trees(tree == "qlora")
    jax_axes = _spec_like(ja)
    assert _spec_like(ta) == jax_axes
    for jr, tr in ((jsh.rules_for_params(stage, jtop),
                    tsh.rules_for_params(stage, ttop)),
                   (jsh.rules_for_optimizer(stage, jtop),
                    tsh.rules_for_optimizer(stage, ttop))):
        assert (tr.rules, tr.fsdp_fallback) == (jr.rules, jr.fsdp_fallback)
        js = jsh.sharding_for_tree(jp, ja, jr, jtop)
        ts = tsh.sharding_for_tree(tp, ta, tr, ttop)
        assert _spec_map_torch(ts) == _spec_map_jax(js)
        assert tsh.shard_accounting(tp, ts) == jsh.shard_accounting(jp, js)
        # shard_dims_for over the data-parallel world
        sizes = {ax: jtop.size(ax) for ax in ("dp", "fsdp")}
        # (each list follows its package's leaf order: compare by path)
        tpaths = [p for p, _ in tsh.leaves_with_path(tp)]
        jpaths = [jax.tree_util.keystr(p) for p, _ in
                  jax.tree_util.tree_flatten_with_path(jp)[0]]
        assert dict(zip(tpaths, tco.shard_dims_for(
            tp, ts, ("dp", "fsdp"), sizes))) == dict(zip(
                jpaths, jco.shard_dims_for(jp, js, ("dp", "fsdp"), sizes)))


def _spec_like(axes):
    """An axes tree as nested plain containers (LoRA nodes by field)."""
    if isinstance(axes, dict):
        return {k: _spec_like(v) for k, v in axes.items()}
    if isinstance(axes, (jl.LoRAWeight, tl.LoRAWeight)):
        return ("lora", _spec_like(axes.base), axes.lora_a, axes.lora_b)
    if isinstance(axes, (jl.QuantizedBaseWeight, tl.QuantizedBaseWeight)):
        return ("qbase", axes.codes, axes.scales, axes.layout)
    return axes


@pytest.mark.parametrize("overrides", [
    {}, {"norm": "layernorm", "position": "learned"},
    {"tie_embeddings": False, "embed_norm": True},
    {"num_experts": 4, "moe_use_residual": True},
    {"activation": "gelu"}])
def test_param_axes_match_reference(overrides):
    jcfg = jt.get_config("tiny", **overrides)
    tcfg = tt.get_config("tiny", **overrides)
    assert tt.param_axes(tcfg) == jt.param_axes(jcfg)
    jp = _np_tree(jt.init_params(jax.random.PRNGKey(0), jcfg))
    jp["layers"]["attn"]["bq"] = np.zeros((2, 64), np.float32)
    assert tt.param_axes(tcfg, params=jp) == jt.param_axes(jcfg, params=jp)
    ecfg = je.EncoderConfig(vocab_size=64, hidden_size=32, num_layers=2,
                            num_heads=4, intermediate_size=64)
    assert te.param_axes(ecfg) == je.param_axes(ecfg)
    assert te.param_axes(ecfg, params={"embed": 1, "layers": 1}) == \
        je.param_axes(ecfg, params={"embed": 1, "layers": 1})


def test_expand_axes_for_lora_matches_reference():
    jp, ja, tp, ta = _lora_trees(True)
    jcfg = jt.get_config("tiny", **dict(XLA, hidden_size=64))
    tcfg = tt.get_config("tiny", **dict(XLA, hidden_size=64))
    assert _spec_like(tt.param_axes(tcfg, params=tp)) == \
        _spec_like(jt.param_axes(jcfg, params=jp))
    for bws in (0, 1, 2):
        assert _spec_like(tl.expand_axes_for_lora(
            tt.param_axes(tcfg), tp, bws)) == _spec_like(
            jl.expand_axes_for_lora(jt.param_axes(jcfg), jp, bws))


def _shape_tree(seed):
    rng = np.random.default_rng(seed)
    shapes = [(8, 4), (16,), (4, 6, 2), (2, 8), (32,), (3,), (4, 4)]
    dtypes = [np.float32, np.float32, np.float32, np.float16, np.float32,
              np.float32, np.float16]
    return [rng.standard_normal(s).astype(d) for s, d in zip(shapes, dtypes)]


@pytest.mark.parametrize("cap", [1, 40, 100, 10_000])
@pytest.mark.parametrize("world", [1, 2])
def test_bucket_plans_match_reference(cap, world):
    arrays = _shape_tree(cap)
    dims = [0, 0, 1, 1, None, None, 0] if world > 1 else None
    jplan = jco.plan_buckets(arrays, cap, world=world, shard_dims=dims)
    tensors = [torch.from_numpy(a) for a in arrays]
    tplan = tco.plan_buckets(tensors, cap, world=world, shard_dims=dims)
    assert tplan.stats() == jplan.stats()
    assert [(b.scatter, [dataclasses.astuple(s) for s in b.slots])
            for b in tplan.buckets] == \
        [(b.scatter, [dataclasses.astuple(s) for s in b.slots])
         for b in jplan.buckets]
    for jb, tb in zip(jplan.buckets, tplan.buckets):
        if tb.scatter:
            jf = np.asarray(jco.flatten_bucket_shard_major(jb, arrays, world))
            tf = tco.flatten_bucket_shard_major(tb, tensors, world)
            np.testing.assert_array_equal(tf.numpy(), jf)
            for (i, a), (_, b) in zip(
                    jco.unflatten_bucket_shard_major(jb, jf, world),
                    tco.unflatten_bucket_shard_major(tb, tf, world)):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
                np.testing.assert_array_equal(b.numpy(), arrays[i])
            chunk = jf.reshape(world, -1)[world - 1].copy()
            for (i, a), (_, b) in zip(
                    jco.unflatten_bucket_shard(jb, chunk, world),
                    tco.unflatten_bucket_shard(tb, torch.from_numpy(chunk),
                                               world)):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        else:
            jf = np.asarray(jco.flatten_bucket(jb, arrays))
            tf = tco.flatten_bucket(tb, tensors)
            np.testing.assert_array_equal(tf.numpy(), jf)
            for (i, a), (_, b) in zip(jco.unflatten_bucket(jb, jf),
                                      tco.unflatten_bucket(tb, tf)):
                np.testing.assert_array_equal(b.numpy(), arrays[i])
    with pytest.raises(ValueError) as e_t:
        tco.plan_buckets(tensors, 0)
    with pytest.raises(ValueError) as e_j:
        jco.plan_buckets(arrays, 0)
    assert str(e_t.value) == str(e_j.value)


@pytest.mark.parametrize("zero", [
    {}, {"reduce_bucket_size": 1000}, {"allreduce_bucket_size": 7,
                                       "reduce_bucket_size": 9},
    {"reduce_bucket_size": "auto", "allgather_bucket_size": 0},
    {"allgather_bucket_size": 123}])
def test_bucket_sizes_resolve_as_reference(zero):
    jz = jconfig.load_config({"zero_optimization": zero}).zero_optimization
    tz = tconfig.load_config({"zero_optimization": zero}).zero_optimization
    assert tco.resolve_bucket_numel(tz) == jco.resolve_bucket_numel(jz)
    assert tco.resolve_allgather_numel(tz) == jco.resolve_allgather_numel(jz)


def test_fp12_packing_matches_reference():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4096, (3, 64)).astype(np.int32)
    packed = tq.pack_fp12(torch.from_numpy(codes))
    want = np.asarray(jq.pack_fp12(codes))
    np.testing.assert_array_equal(packed.numpy(), want)
    np.testing.assert_array_equal(tq.unpack_fp12(packed).numpy(), codes)
    x = rng.standard_normal((5, 100)).astype(np.float32)
    tp, ts = tq.quantize_minifloat(torch.from_numpy(x), bits=12)
    jp, js = jq.quantize_minifloat(x, bits=12)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tq.dequantize_minifloat(tp, ts, bits=12, shape=x.shape).numpy(),
        np.asarray(jq.dequantize_minifloat(jp, js, bits=12, shape=x.shape)))
    # stochastic rounding: the same law (unbiased, in range), other draws
    c, s = tq.quantize_stochastic(torch.from_numpy(x), seed=3)
    deq = tq.dequantize_blockwise(c, s, shape=x.shape)
    assert float((deq - torch.from_numpy(x)).abs().max()) <= \
        float(s.max()) + 1e-6


# ---------------------------------------------------------------------------
# configs: the reference's ConfigErrors word for word; A13's later parts
# ---------------------------------------------------------------------------


REFERENCE_ERRORS = [
    {"zero_optimization": {"stage": 3, "zero_quantized_gradients": True}},
    {"zero_optimization": {"stage": 2, "zero_quantized_weights": True}},
    {"zero_optimization": {"stage": 0, "zero_quantized_gradients": True,
                           "offload_optimizer": {"device": "cpu"}}},
    {"gradient_compression": {"enabled": True},
     "zero_optimization": {"stage": 3}},
    {"gradient_compression": {"enabled": True},
     "zero_optimization": {"stage": 1, "zero_quantized_gradients": True}},
    {"gradient_compression": {"enabled": True}, "fp16": {"enabled": True}},
    {"gradient_compression": {"enabled": True},
     "peft": {"lora": {"enabled": True}}},
]


@pytest.mark.parametrize("config", REFERENCE_ERRORS,
                         ids=[str(i) for i in range(len(REFERENCE_ERRORS))])
def test_reference_config_errors_word_for_word(config):
    jcfg = jt.get_config("tiny", **XLA)
    one = JTopo.from_config(jconfig.MeshConfig(), devices=jax.devices()[:1])
    with pytest.raises(JConfigError) as want:
        deepspeed_tpu.initialize(
            model=JSpec(loss_fn=lambda p, b, r: jt.loss_fn(p, b, jcfg),
                        params=jt.init_params(jax.random.PRNGKey(0), jcfg),
                        param_axes=jt.param_axes(jcfg)),
            config=dict(config, train_batch_size=2), topo=one)
    with pytest.raises(ConfigError) as got:
        tconfig.load_config(config).check_supported()
    assert str(got.value) == str(want.value)


STILL_A13 = {
    "pipeline": {"pipeline": {"stages": 2}},
    "moe": {"moe": {"enabled": True}},
    "sequence_parallel": {"sequence_parallel": {"enabled": True}},
    "tensor_parallel": {"tensor_parallel": {"enabled": True}},
    "mesh_tp": {"mesh": {"tensor_parallel_size": 2}},
    "mesh_pp": {"mesh": {"pipeline_parallel_size": 2}},
    "mesh_sp": {"mesh": {"sequence_parallel_size": 2}},
    "mesh_ep": {"mesh": {"expert_parallel_size": 2}},
    "orbax": {"checkpoint": {"engine": "orbax"}},
    "partition_activations": {"activation_checkpointing": {
        "partition_activations": True}},
}


@pytest.mark.parametrize("name", sorted(STILL_A13))
def test_remaining_a13_keys_refuse(name):
    with pytest.raises(NotImplementedError, match="A13"):
        tconfig.load_config(STILL_A13[name]).check_supported()


@pytest.mark.parametrize("config", [
    {"zero_optimization": {"stage": 1}},
    {"zero_optimization": {"stage": 3, "zero_quantized_weights": True,
                           "mics_shard_size": 2,
                           "zero_hpz_partition_size": 2,
                           "stage3_prefetch_bucket_size": 10}},
    {"zero_optimization": {"stage": 2, "zero_quantized_gradients": True,
                           "overlap_comm": True, "reduce_bucket_size": 10,
                           "allgather_bucket_size": 10,
                           "contiguous_gradients": False}},
    {"gradient_compression": {"enabled": True},
     "comms_logger": {"enabled": True}, "prescale_gradients": True,
     "gradient_predivide_factor": 2.0, "sparse_gradients": True,
     "mesh": {"data_parallel_size": 2, "fsdp_size": 2}},
    # A13 part 2: offload, ZenFlow and PEFT at stages 1-3
    {"zero_optimization": {"stage": 1, "offload_optimizer": {
        "device": "cpu"}}},
    {"zero_optimization": {"stage": 3, "offload_param": {"device": "cpu"}}},
    {"zenflow": {"enabled": True}, "zero_optimization": {
        "stage": 2, "offload_optimizer": {"device": "cpu"}}},
    {"peft": {"lora": {"enabled": True}}, "zero_optimization": {"stage": 3}}])
def test_data_parallel_keys_are_taken(config):
    tconfig.load_config(config).check_supported()
