"""ZeRO-Offload and ZeRO-Infinity on a data-parallel world (ROADMAP.md A13,
part 2) against the JAX package: the port's engine on gloo worlds of 1, 2
and 4 (``tests/torch_dist.py``: groups of scenarios in process sets, each
group and each reference run computed once in a test run) against
the reference's engine on the matching ``jax.devices()[:n]`` sub-mesh —
the same numpy-seeded weights and batches, three steps,
losses to 1e-5 and parameters to 1e-4 (``test_torch_zero.py``'s limits):

- optimizer offload at stages 0 (a world of two), 1, 2 and 3, and stage 3
  at a world of four;
- ``offload_param`` at stage 3 (ZeRO-Infinity: the streamed shards in host
  memory; the reference on the CPU has no host memory space and drops
  ``offload_param``, as ``test_torch_offload.py`` compares);
- the NVMe tiers at stages 2 and 3 under ``tmp_path``, the rank in every
  file's name;
- ``delayed_update`` at stage 2 with ``applied_lr`` and the flush;
- ZenFlow at stages 1 and 3: every rank's hot columns equal to the
  reference's, in its order;
- LoRA at stage 3 over a dense and an int4 base (the reference's own LoRA
  tree);
- an offloaded stage-2 checkpoint loaded by a stage-3 engine and by the
  reference; ``offload_states`` at a world of two;
- each rank's host bytes 1/W of a world of one's, and no two host
  buffers of a rank overlapping;
- ROADMAP.md C10: stage 3 under a ``loss_mask`` whose token counts differ
  between the ranks gives the reference's global-batch loss, tokens,
  accuracy and parameters, unscaled;
- ROADMAP.md C11: qwZ at a world of one gathers unquantized leaves, so its
  loss is unquantized stage 3's.
"""

import os
import types

import jax
import numpy as np
import pytest

import deepspeed_tpu
from deepspeed_tpu.linear import optimized_linear as jl
from deepspeed_tpu.linear.config import LoRAConfig as JLoRAConfig
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.parallel.topology import MeshTopology as JTopo
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu.runtime.engine import ModelSpec as JSpec
from deepspeed_tpu.sequence import tiled_compute as jtc

from tests.torch_cpu import one_torch_thread  # noqa: F401
from tests.torch_dist import launch, shared

LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
# the XLA attention path: the reference's flash path on the CPU runs its
# Pallas kernel interpreted, at twice an engine's compile time
XLA = dict(dtype="float32", num_kv_heads=2, attn_impl="xla")
BASE = {"gradient_clipping": 1.0, "steps_per_print": 1000,
        "optimizer": {"type": "adamw",
                      "params": {"lr": 1e-3, "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_num_steps": 3}}}
CPU = {"device": "cpu"}
ZENFLOW = {"enabled": True, "topk_ratio": 0.25, "update_interval": 1,
           "select_interval": 2}
LORA = {"enabled": True, "lora_r": 4, "lora_alpha": 8}


def _cfg(stage, zero=None, gas=1, **extra):
    return dict(BASE, train_batch_size=8, gradient_accumulation_steps=gas,
                zero_optimization=dict({"stage": stage}, **(zero or {})),
                **extra)


def _off(stage, **zero):
    return _cfg(stage, dict({"offload_optimizer": CPU}, **zero))


def _batches(n=3, mask=False, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"input_ids": rng.integers(0, 256, (8, 32)).astype(np.int32)}
        if mask:
            # rows of rank 0 (the first half of each micro-batch of 4)
            # count every token, rank 1's a random prefix of theirs
            m = np.zeros((8, 32), np.float32)
            for r in range(8):
                m[r, :32 if (r // 2) % 2 == 0 else rng.integers(1, 9)] = 1
            b["loss_mask"] = m
        out.append(b)
    return out


def _weights(model, lora=None):
    """(the reference's tree, its axes, the port's picklable copy)."""
    jcfg = jt.get_config("tiny", **model)
    params = jt.init_params(jax.random.PRNGKey(1), jcfg)
    axes = jt.param_axes(jcfg)
    if lora is not None:
        params, axes = jl.apply_lora(params, axes, jax.random.PRNGKey(7),
                                     JLoRAConfig(**lora))
    return params, axes, _picklable(params)


def _picklable(node):
    """A reference tree as numpy arrays and plain namespaces with the
    nodes' fields (``params_from_jax`` reads nodes by their fields), so a
    rank unpickles it without the JAX package."""
    if isinstance(node, dict):
        return {k: _picklable(v) for k, v in node.items()}
    if isinstance(node, jl.LoRAWeight):
        return types.SimpleNamespace(
            base=_picklable(node.base), lora_a=np.asarray(node.lora_a),
            lora_b=np.asarray(node.lora_b), scaling=float(node.scaling))
    if isinstance(node, jl.QuantizedBaseWeight):
        return types.SimpleNamespace(
            codes=np.asarray(node.codes), scales=np.asarray(node.scales),
            q_bits=node.q_bits, mantissa_bits=node.mantissa_bits,
            group_size=node.group_size,
            inner_shape=tuple(node.inner_shape), layout=node.layout)
    return np.asarray(node)


#: name -> (world, model, config, batches, LoRA config or None); the
#: reference runs each (ZeRO-Infinity and the NVMe tiers: its CPU tier
#: without offload_param) on a sub-mesh
CASES = {
    "off_stage0": (2, XLA, _off(0), _batches(), None),
    "off_stage1": (2, XLA, _off(1), _batches(), None),
    "off_stage2": (2, XLA, _off(2), _batches(), None),
    "off_stage3": (2, XLA, _off(3), _batches(), None),
    # a world of four: ZeRO-Infinity
    "infinity_stage3": (4, XLA, _cfg(3, {
        "offload_optimizer": CPU, "offload_param": CPU,
        "stage3_param_persistence_threshold": 0}, gas=2), _batches(), None),
    "delayed_stage2": (2, XLA, _off(2, offload_optimizer=dict(
        CPU, delayed_update=True)), _batches(), None),
    "zenflow_stage1": (2, XLA, dict(_off(1), zenflow=ZENFLOW), _batches(),
                       None),
    "zenflow_stage3": (2, XLA, dict(_off(3), zenflow=ZENFLOW), _batches(),
                       None),
    "lora_stage3": (2, XLA, dict(_cfg(3), peft={"lora": LORA}), _batches(),
                    LORA),
    "qlora_stage3": (2, XLA, dict(_cfg(3), peft={"lora": dict(
        LORA, quantize_base=True, quantization={
            "q_bits": 4, "mantissa_bits": 0, "group_size": 32})}),
        _batches(), dict(LORA, quantize_base=True, quantization={
            "q_bits": 4, "mantissa_bits": 0, "group_size": 32})),
    "c10_stage3": (2, XLA, _cfg(3, gas=2), _batches(mask=True), None),
}
#: the cases whose reference is another case's (the same numbers)
SAME_AS = {"nvme_stage2": "off_stage2", "nvme_stage3": "off_stage3",
           "states_stage2": "off_stage2"}
#: the worlds of one: host bytes against the world of two, qwZ (C11)
W1 = {f"w1_stage{s}": _off(s) for s in (1, 2, 3)}
W1["w1_infinity"] = CASES["infinity_stage3"][2]
#: the cases whose eval is held against the reference's (an eval compiles
#: a program of its own)
EVAL_CASES = ("off_stage3", "lora_stage3")


def _nvme(stage, d):
    tiers = {"offload_optimizer": {"device": "nvme", "nvme_path": d}}
    if stage >= 3:
        tiers["offload_param"] = {"device": "nvme", "nvme_path": d}
    return _cfg(stage, tiers)


def _scenario(name, model, config, batches, params, **kw):
    return (name, dict(kind="offload", preset="tiny", model=model,
                       params=params, config=config, batches=batches, **kw))


#: the port's scenarios in process sets of their world's size, each run
#: once for the whole test run: group -> (world, its scenarios' names)
GROUPS = {
    "off": (2, ["off_stage0", "off_stage1", "off_stage2", "off_stage3"]),
    "infinity": (4, ["infinity_stage3"]),
    "tiers": (2, ["nvme_stage2", "nvme_stage3", "states_stage2"]),
    "update": (2, ["delayed_stage2", "zenflow_stage1", "zenflow_stage3"]),
    "lora": (2, ["lora_stage3", "qlora_stage3"]),
    "c10": (2, ["c10_stage3"]),
    "ckpt": (2, ["ckpt_lora3", "ckpt_2to3"]),
    "w1": (1, list(W1) + ["w1_qwz", "w1_plain3"]),
}
GROUP_OF = {n: g for g, (_, names) in GROUPS.items() for n in names}


def _port_scenario(name, tmp_path_factory):
    """The port's scenario ``name`` (a ``tests/torch_dist.py`` job)."""
    if name in CASES:
        _, model, config, batches, lora = CASES[name]
        return _scenario(name, model, config, batches,
                         _weights(model, lora)[2], flush="delayed" in name)
    plain = _weights(XLA)[2]
    if name.startswith("nvme_stage"):
        d = str(tmp_path_factory.mktemp(name))
        return _scenario(name, XLA, _nvme(int(name[-1]), d), _batches(),
                         plain, nvme=d)
    if name == "states_stage2":
        return _scenario(name, XLA, _off(2), _batches(), plain, states=True)
    if name == "ckpt_lora3":
        return (name, dict(
            kind="checkpoint", preset="tiny", model=XLA,
            params=_weights(XLA, LORA)[2], batches=_batches(seed=3),
            dir=str(tmp_path_factory.mktemp(name)), merged=True,
            save_config=CASES["lora_stage3"][2],
            load_config=dict(_cfg(1), peft={"lora": LORA})))
    if name == "ckpt_2to3":
        return (name, dict(
            kind="checkpoint", preset="tiny", model=XLA, params=plain,
            batches=_batches(seed=3), dir=str(tmp_path_factory.mktemp(name)),
            save_config=_off(2), load_config=_off(3)))
    if name in W1:
        return _scenario(name, XLA, W1[name], _batches(), plain)
    zero = {"zero_quantized_weights": True} if name == "w1_qwz" else {}
    return (name, dict(kind="engine", preset="tiny", model=XLA,
                       params=plain, config=_cfg(3, zero),
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
        res = shared(tmp_path_factory, f"zero_offload_{GROUP_OF[name]}",
                     lambda: _run_group(GROUP_OF[name], tmp_path_factory))
        assert res["_modules"] == [[]] * len(res["_modules"])
        return res[name]

    return get


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """case -> the reference's results of ``case``, once in the whole test
    run."""
    return lambda case: shared(
        tmp_path_factory, f"zero_offload_ref_{case}",
        lambda: _reference(*CASES[case], name=case))


def _reference_load(ckpt_results):
    """The reference's stage-2 engine, two steps trained, then the port's
    checkpoint loaded: its eval and its next step on the third batch."""
    loader = _jax_engine(2, XLA, _off(2))
    batches = _batches(seed=3)
    for b in batches[:2]:
        loader.train_batch(b)
    # the directory the port's engines saved under
    loader.load_checkpoint(os.path.dirname(os.path.dirname(
        _ok(ckpt_results)[0]["path"])))
    return {"eval": dict(loader.eval_batch(batches[2])),
            "step": dict(loader.train_batch(batches[2]))}


def _ok(results):
    for r in results:
        assert not (isinstance(r, dict) and "error" in r), r["error"]
    return results


def _mesh(world, config):
    zero = config["zero_optimization"]
    mesh = jconfig.MeshConfig()
    if zero["stage"] >= 3:  # the reference folds dp into fsdp itself only
        mesh = jconfig.MeshConfig(fsdp_size="auto", data_parallel_size=1)
    return JTopo.from_config(mesh, devices=jax.devices()[:world])


def _jax_engine(world, model, config, lora=None):
    jcfg = jt.get_config("tiny", **model)
    params, axes, _ = _weights(model, lora)
    if lora is not None:
        axes = jt.param_axes(jcfg, params=params)
    eng, _, _, _ = deepspeed_tpu.initialize(
        model=JSpec(loss_fn=lambda p, b, r: jtc.tiled_loss_fn(
            p, b, jcfg, tile_size=16), params=params, param_axes=axes),
        config=config, topo=_mesh(world, config))
    return eng


def _reference(world, model, config, batches, lora, name=""):
    eng = _jax_engine(world, model, config, lora)
    steps, hot = [], []
    for b in batches:
        steps.append(dict(eng.train_batch(b)))
        z = eng.zenflow_optimizer
        if z is not None:
            hot.append({k: np.asarray(v) for k, v in
                        _flat(z._indices).items()})
    eng.flush_delayed_update()
    out = {"steps": steps, "hot": hot,
           "params": _flat(jax.tree_util.tree_map(np.asarray,
                                                  eng.state.params))}
    if name in EVAL_CASES:
        out["eval"] = eng.eval_batch(batches[0])
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif isinstance(v, jl.LoRAWeight):
            out.update(_flat({"lora_a": v.lora_a, "lora_b": v.lora_b},
                             f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _same_steps(got, want, extra=()):
    for k, (jm, tm) in enumerate(zip(want, got)):
        tm = {k_: v for k_, v in tm.items() if not k_.startswith("_")}
        assert set(tm) == set(jm), (sorted(tm), sorted(jm))
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=LOSS_TOL,
                                   err_msg=f"loss@{k}")
        for key in ("grad_norm", "lr", "tokens", "accuracy") + extra:
            if key in jm:
                np.testing.assert_allclose(tm[key], jm[key], rtol=1e-4,
                                           atol=1e-7, err_msg=f"{key}@{k}")


def _same_params(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, atol=PARAM_TOL, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("name", sorted(CASES) + sorted(SAME_AS))
def test_offloaded_engine_matches_reference(port, ref, name):
    res = _ok(port(name))
    want = ref(SAME_AS.get(name, name))
    world = CASES[SAME_AS.get(name, name)][0]
    assert len(res) == world
    delayed = "delayed" in name
    for r in res:  # every rank reports the same (world) metrics
        _same_steps(r["steps"], want["steps"],
                    ("applied_lr",) if delayed else ())
        assert r["overlaps"] == 0  # no two host buffers of a rank overlap
        np.testing.assert_allclose(r["eval"]["loss"],
                                   res[0]["eval"]["loss"], rtol=1e-6)
    wanted = want["params"]
    if CASES.get(name, (None,) * 5)[4] is not None:
        # PEFT checkpoints the trainable factors alone
        wanted = {k: v for k, v in wanted.items()
                  if k.endswith(("/lora_a", "/lora_b"))}
    _same_params(res[0]["params"], wanted)
    if name in EVAL_CASES:
        np.testing.assert_allclose(res[0]["eval"]["loss"],
                                   want["eval"]["loss"], rtol=LOSS_TOL)
    if delayed:  # no update at step 1; then the previous batch's lr
        steps = res[0]["steps"]
        assert "applied_lr" not in steps[0]
        for a, b in zip(steps, steps[1:]):
            assert b["applied_lr"] == pytest.approx(a["lr"], rel=1e-6)
    if name == "states_stage2":
        assert all(r["steps"][0]["_evicted"] for r in res)


@pytest.mark.parametrize("name", ["zenflow_stage1", "zenflow_stage3"])
def test_zenflow_hot_columns_are_the_references(port, ref, name):
    """Every rank selects the whole leaves' hot columns of the reference,
    in ``jax.lax.top_k``'s order, at every step (selected at steps 1 and
    3)."""
    want = ref(name)["hot"]
    assert len(want) == 3
    for r in _ok(port(name)):
        assert len(r["hot"]) == len(want)
        for got_step, want_step in zip(r["hot"], want):
            assert set(got_step) == set(want_step)
            for k, w in want_step.items():
                np.testing.assert_array_equal(got_step[k], w, err_msg=k)


def test_zenflow_keeps_lax_top_k_tie_order():
    import torch

    from deepspeed_tpu_torch.runtime.config import ZenFlowConfig
    from deepspeed_tpu_torch.runtime.zenflow import ZenFlowOptimizer

    # equal energies: the lower index first, as jax.lax.top_k
    g = np.ones((3, 16), np.float32)
    g[:, [3, 11]] = 2.0
    zf = ZenFlowOptimizer(None, ZenFlowConfig(topk_ratio=0.25), None)
    got = zf._select([torch.from_numpy(g)])[0].numpy()
    energy = (g ** 2).sum(0)
    want = np.asarray(jax.lax.top_k(energy, 4)[1])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [3, 11, 0, 1])


def test_host_bytes_are_a_partition(port):
    """A rank's host holds its partition alone: at stages 1-3 each rank
    of two holds half of a world of one's bytes, and under ZeRO-Infinity
    each rank of four a quarter."""
    for s in ("1", "2", "3"):
        one = _ok(port(f"w1_stage{s}"))[0]["host_bytes"]
        for r in _ok(port(f"off_stage{s}")):
            assert r["host_bytes"] * 2 == one, (s, r["host_bytes"], one)
    one = _ok(port("w1_infinity"))[0]
    for r in _ok(port("infinity_stage3")):
        assert r["host_bytes"] * 4 == one["host_bytes"]
        # each layer streams in, in forward and again in the recompute,
        # each of the two micro-batches of the three steps
        assert r["stream_in"] == one["stream_in"] == 3 * 2 * 2 * 2


def test_nvme_files_carry_the_rank(port):
    for name in ("nvme_stage2", "nvme_stage3"):
        for rank, r in enumerate(_ok(port(name))):
            opt = [f for f in r["files"] if f.endswith(".bin")]
            assert opt and all(f.startswith(("rank0_", "rank1_"))
                               for f in opt), r["files"]
            assert any(f.startswith(f"rank{rank}_opt_") for f in opt)
        if name == "nvme_stage3":
            assert "master" in r["files"]


def test_offloaded_checkpoint_moves_to_stage3_and_the_reference(
        port, tmp_path_factory):
    res = _ok(port("ckpt_2to3"))
    for r in res:
        np.testing.assert_allclose(r["eval_loaded"]["loss"],
                                   r["eval_saved"]["loss"], rtol=1e-6)
        np.testing.assert_allclose(r["step_loaded"]["loss"],
                                   r["step_saved"]["loss"], rtol=1e-6)
        np.testing.assert_allclose(r["step_loaded"]["grad_norm"],
                                   r["step_saved"]["grad_norm"], rtol=1e-5)
    loaded = shared(tmp_path_factory, "zero_offload_ref_loader",
                    lambda: _reference_load(res))
    np.testing.assert_allclose(loaded["eval"]["loss"],
                               res[0]["eval_saved"]["loss"], rtol=LOSS_TOL)
    np.testing.assert_allclose(loaded["step"]["loss"],
                               res[0]["step_saved"]["loss"], rtol=LOSS_TOL)


def test_lora_stage3_adapter_checkpoint_and_merged_export(port):
    """A stage-3 LoRA engine writes an adapter-only checkpoint that a
    stage-1 LoRA engine resumes from, and exports merged weights: every
    projection ``base + scaling · lora_a @ lora_b`` of the whole tensors,
    in a plain model's layout."""
    from safetensors.numpy import load_file

    res = _ok(port("ckpt_lora3"))
    for r in res:
        np.testing.assert_allclose(r["eval_loaded"]["loss"],
                                   r["eval_saved"]["loss"], rtol=1e-6)
        np.testing.assert_allclose(r["step_loaded"]["loss"],
                                   r["step_saved"]["loss"], rtol=1e-6)
    r = res[0]
    assert "adapter_model.safetensors" in r["files"]
    assert "model.safetensors" not in r["files"]
    adapters = load_file(r["path"] + "/adapter_model.safetensors")
    plain = _weights(XLA)[2]
    merged = r["merged"]
    assert set(merged) == set(_flat(plain))
    scaling = LORA["lora_alpha"] / LORA["lora_r"]
    for proj in ("attn/wq", "mlp/w_out"):
        a = adapters[f"layers/{proj}/lora_a"]
        b = adapters[f"layers/{proj}/lora_b"]
        base = _flat(plain)[f"layers/{proj}"]
        np.testing.assert_allclose(merged[f"layers/{proj}"],
                                   base + scaling * a @ b, atol=1e-5)
    np.testing.assert_array_equal(merged["embed/tokens"],
                                  _flat(plain)["embed/tokens"])


def test_c10_stage3_loss_is_the_global_token_mean(port, ref):
    """Token counts differ between the ranks: the port's stage-3 loss,
    tokens, accuracy and parameters are the reference's global-batch
    ones, as they come (nothing rescaled)."""
    res = _ok(port("c10_stage3"))
    want = ref("c10_stage3")
    masks = [b["loss_mask"] for b in CASES["c10_stage3"][3]]
    assert masks[0][:2].sum() != masks[0][2:4].sum()
    for r in res:
        _same_steps(r["steps"], want["steps"])
    _same_params(res[0]["params"], want["params"])


def test_c11_qwz_at_world_one_gathers_unquantized(port):
    q = _ok(port("w1_qwz"))[0]
    plain = _ok(port("w1_plain3"))[0]
    assert q["steps"][0]["loss"] == plain["steps"][0]["loss"]
    assert q["bytes"]["all_gather@fsdp"] == plain["bytes"]["all_gather@fsdp"]


def test_ranks_import_no_jax(port):
    """Every group's ranks import no JAX (the ``port`` fixture checks each
    group a test reads); here the offloaded stage-2 step's."""
    assert _ok(port("off_stage2"))
