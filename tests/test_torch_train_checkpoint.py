"""Parity: the port's training checkpoints (``runtime/checkpoint/engine.py``
through ``TrainingEngine.save_checkpoint`` / ``load_checkpoint``) and
``checkpoint_utils.py`` against the JAX package's, on a tiny f32 model.

- a checkpoint written by either engine after 2 steps loads into the
  other, and the next 2 steps of the loading engine equal the saving
  engine's own within 1e-5 (losses, grad norms, final parameters);
- saved before any step from the same weights, ``model.safetensors`` and
  ``optimizer.safetensors`` are byte for byte the reference's, for f32,
  bf16 (``bf16_keys``) and f16 (``F16``) parameters;
- the ``fast`` engine's files hold the same tensors;
- verify, fallback past a truncated and a bit-flipped tag,
  ``keep_n_latest``, tag validation, an async save that equals the state at
  save time although a step ran during the write, a recorded async failure;
- two fault sites in a subprocess, each with a time limit: a kill before
  the commit leaves a ``.tmp`` that the next save collects, a kill before
  the ``latest`` pointer moves still resumes from the newest commit;
- ``checkpoint_utils fp32`` / ``hf-llama`` write the reference CLI's files.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu import checkpoint_utils as jcu
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.parallel.topology import MeshTopology
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu.runtime.engine import ModelSpec as JSpec
from deepspeed_tpu_torch import checkpoint_utils as tcu
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.runtime.checkpoint import engine as tce
from deepspeed_tpu_torch.runtime.engine import ModelSpec as TSpec
from deepspeed_tpu_torch.utils import faults

from tests.torch_cpu import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESUME_TOL = 1e-5
SUBPROCESS_S = 120
CFG = {
    "train_batch_size": 4,
    "optimizer": {"type": "adamw",
                  "params": {"lr": 1e-3, "weight_decay": 0.01}},
    "gradient_clipping": 1.0,
    "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 3}},
    "steps_per_print": 1000,
}


def _model(seed=0, **over):
    kw = dict(dtype="float32", num_kv_heads=2, attn_impl="xla",
              num_layers=2)
    kw.update(over)
    jcfg, tcfg = jt.get_config("tiny", **kw), tt.get_config("tiny", **kw)
    params = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    host = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, tcfg, params, host


def _jax_engine(jcfg, params, cfg=CFG):
    one = MeshTopology.from_config(jconfig.MeshConfig(),
                                   devices=jax.devices()[:1])
    return deepspeed_tpu.initialize(
        model=JSpec(loss_fn=lambda p, b, r: jt.loss_fn(p, b, jcfg),
                    params=params, param_axes=jt.param_axes(jcfg)),
        config=cfg, topo=one)[0]


def _torch_engine(tcfg, host, cfg=CFG, dtype=torch.float32):
    tparams = tt.params_from_jax(host, tcfg, device="cpu", dtype=dtype)
    return deepspeed_tpu_torch.initialize(
        model=TSpec(loss_fn=lambda p, b, r: tt.loss_fn(p, b, tcfg),
                    params=tparams), config=cfg, device="cpu")[0]


def _batch(step):
    rng = np.random.default_rng(100 + step)
    return {"input_ids": rng.integers(0, 256, (4, 32)).astype(np.int32)}


def _params_of(eng):
    if hasattr(eng, "state"):
        return {k: np.asarray(v, np.float32) for k, v in
                jax_flat(jax.tree_util.tree_map(np.asarray,
                                                eng.state.params)).items()}
    return {p: t.detach().float().numpy().copy()
            for p, t in zip(eng._paths, eng._leaves)}


def jax_flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(jax_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_checkpoint_crosses_packages_and_resumes(saver, tmp_path):
    jcfg, tcfg, params, host = _model(1)
    first = _jax_engine(jcfg, params) if saver == "jax" else \
        _torch_engine(tcfg, host)
    for step in range(2):
        first.train_batch(_batch(step))
    first.save_checkpoint(str(tmp_path), client_state={"epoch": 3})
    second = _torch_engine(tcfg, host) if saver == "jax" else \
        _jax_engine(jcfg, params)
    path, client = second.load_checkpoint(str(tmp_path))
    assert path.endswith("global_step2") and client == {"epoch": 3}
    assert second.get_global_step() == 2
    for step in range(2, 4):
        a, b = dict(first.train_batch(_batch(step))), dict(
            second.train_batch(_batch(step)))
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(b[key], a[key], rtol=RESUME_TOL,
                                       err_msg=f"{key}@{step}")
    pa, pb = _params_of(first), _params_of(second)
    assert pa.keys() == pb.keys()
    for k in pa:
        np.testing.assert_allclose(pb[k], pa[k], atol=RESUME_TOL, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_saved_files_are_the_references_bytes(dtype, tmp_path):
    jcfg, tcfg, params, host = _model(2, param_dtype=dtype)
    jparams = jax.tree_util.tree_map(lambda a: a.astype(dtype), params)
    jeng = _jax_engine(jcfg, jparams)
    teng = _torch_engine(tcfg, jax.tree_util.tree_map(np.asarray, jparams),
                         dtype=tt.torch_dtype(dtype))
    jeng.save_checkpoint(str(tmp_path / "j"))
    teng.save_checkpoint(str(tmp_path / "t"))
    for name in ("model.safetensors", "optimizer.safetensors"):
        a = (tmp_path / "j" / "global_step0" / name).read_bytes()
        b = (tmp_path / "t" / "global_step0" / name).read_bytes()
        assert a == b, name
    meta = json.loads((tmp_path / "t" / "global_step0" /
                       "engine_state.json").read_text())
    jmeta = json.loads((tmp_path / "j" / "global_step0" /
                        "engine_state.json").read_text())
    assert set(meta) == set(jmeta)
    assert {k: meta[k] for k in ("step", "skipped_steps", "loss_scale",
                                 "zero_stage")} == \
        {k: jmeta[k] for k in ("step", "skipped_steps", "loss_scale",
                               "zero_stage")}
    if dtype == "float16":
        flat = tce._load_tree_flat(str(tmp_path / "t" / "global_step0" /
                                       "model.safetensors"))
        assert all(v.dtype == torch.float16 for v in flat.values())


def test_fast_engine_writes_the_same_tensors(tmp_path):
    _, tcfg, _, host = _model(3)
    eng = _torch_engine(tcfg, host, cfg=dict(CFG, checkpoint={
        "engine": "fast"}))
    eng.train_batch(_batch(0))
    eng.save_checkpoint(str(tmp_path / "fast"))
    eng.config.checkpoint.engine = "native"
    eng.save_checkpoint(str(tmp_path / "native"))
    for name in ("model.safetensors", "optimizer.safetensors"):
        a = tce._load_tree_flat(str(tmp_path / "fast" / "global_step1" / name))
        b = tce._load_tree_flat(str(tmp_path / "native" / "global_step1" /
                                    name))
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert not tce.verify_checkpoint(str(tmp_path / "fast" / "global_step1"))


def test_verify_fallback_pruning_and_tag_validation(tmp_path):
    _, tcfg, _, host = _model(4)
    cfg = dict(CFG, checkpoint={"keep_n_latest": 2})
    eng = _torch_engine(tcfg, host, cfg=cfg)
    snaps = {}
    for step in range(3):
        eng.train_batch(_batch(step))
        eng.save_checkpoint(str(tmp_path))
        snaps[step + 1] = _params_of(eng)
    assert sorted(os.listdir(tmp_path)) == ["global_step2", "global_step3",
                                            "latest"]
    assert tce.checkpoint_candidates(str(tmp_path)) == ["global_step3",
                                                        "global_step2"]
    # a truncated newest tag: verify names it, the load falls back
    model = tmp_path / "global_step3" / "model.safetensors"
    model.write_bytes(model.read_bytes()[:1000])
    assert any("size" in p for p in tce.verify_checkpoint(
        str(tmp_path / "global_step3")))
    fresh = _torch_engine(tcfg, host, cfg=cfg)
    path, _ = fresh.load_checkpoint(str(tmp_path))
    assert path.endswith("global_step2") and fresh.get_global_step() == 2
    for k, v in _params_of(fresh).items():
        np.testing.assert_array_equal(v, snaps[2][k])
    with pytest.raises(tce.CheckpointIntegrityError):
        _torch_engine(tcfg, host, cfg=cfg).load_checkpoint(
            str(tmp_path), fallback=False)
    # a bit flip in the older one: nothing valid is left
    opt = tmp_path / "global_step2" / "optimizer.safetensors"
    raw = bytearray(opt.read_bytes())
    raw[-5] ^= 0x10
    opt.write_bytes(bytes(raw))
    assert tce.find_latest_valid_checkpoint(str(tmp_path)) is None
    with pytest.raises(tce.CheckpointIntegrityError, match="2 tag"):
        fresh.load_checkpoint(str(tmp_path))
    # tag validation: a checkpoint of another ZeRO stage warns or fails
    eng.config.checkpoint.tag_validation = "Fail"
    with pytest.raises(ValueError, match="zero_stage"):
        tce._validate_tag(eng, {"zero_stage": 2})
    eng.config.checkpoint.tag_validation = "Ignore"
    tce._validate_tag(eng, {"zero_stage": 2})
    # the optimizer structure must match unless told otherwise
    sgd = _torch_engine(tcfg, host, cfg=dict(CFG, optimizer={
        "type": "sgd", "params": {"lr": 1e-3}}))
    eng.config.checkpoint.tag_validation = "Warn"
    eng.save_checkpoint(str(tmp_path / "again"))
    with pytest.raises(ValueError, match="optimizer structure"):
        sgd.load_checkpoint(str(tmp_path / "again"))
    sgd.load_checkpoint(str(tmp_path / "again"), load_optimizer_states=False)
    assert sgd.get_global_step() == 3


def test_async_save_snapshots_then_writes(tmp_path):
    _, tcfg, _, host = _model(5)
    eng = _torch_engine(tcfg, host, cfg=dict(CFG, checkpoint={
        "async_save": True}))
    eng.train_batch(_batch(0))
    want = _params_of(eng)
    faults.configure({"ckpt.write.model": "delay:0.5"})
    try:
        eng.save_checkpoint(str(tmp_path))
        eng.train_batch(_batch(1))  # in place, during the write
    finally:
        faults.reset()
    tce.wait_for_async_saves()
    fresh = _torch_engine(tcfg, host)
    fresh.load_checkpoint(str(tmp_path))
    for k, v in _params_of(fresh).items():
        np.testing.assert_array_equal(v, want[k])
    # a failed async save is recorded and re-raised
    faults.configure({"ckpt.write.meta": "ioerror"})
    try:
        eng.save_checkpoint(str(tmp_path))
        with pytest.raises(IOError, match="injected fault"):
            tce.wait_for_async_saves()
    finally:
        faults.reset()
    assert tce.find_latest_valid_checkpoint(str(tmp_path)) == "global_step1"


_CHILD = r"""
import sys
sys.path.insert(0, {repo!r})
import numpy as np, torch
import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.runtime.engine import ModelSpec
cfg = tt.get_config("tiny", dtype="float32", num_layers=1)
params = tt.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
eng = deepspeed_tpu_torch.initialize(
    model=ModelSpec(loss_fn=lambda p, b, r: tt.loss_fn(p, b, cfg),
                    params=params), config={{"train_batch_size": 2}},
    device="cpu")[0]
ids = np.zeros((2, 16), np.int32)
for _ in range(2):
    eng.train_batch({{"input_ids": ids}})
    eng.save_checkpoint({out!r})
"""


@pytest.mark.parametrize("site,committed,latest", [
    ("ckpt.commit", ["global_step1"], "global_step1"),
    ("ckpt.latest", ["global_step1", "global_step2"], "global_step1")])
def test_fault_site_kill_leaves_a_loadable_checkpoint(site, committed,
                                                      latest, tmp_path):
    out = str(tmp_path / "ckpt")
    env = dict(os.environ, DSTPU_FAULTS=f"{site}=exit:71@2")
    proc = subprocess.run([sys.executable, "-c", _CHILD.format(
        repo=REPO, out=out)], env=env, capture_output=True, text=True,
        timeout=SUBPROCESS_S)
    assert proc.returncode == 71, proc.stderr[-2000:]
    names = sorted(os.listdir(out))
    assert [n for n in names if n.startswith("global_step")
            and not n.endswith(".tmp")] == committed
    assert ("global_step2.tmp" in names) == (site == "ckpt.commit")
    assert open(os.path.join(out, "latest")).read() == latest
    # the newest commit loads, pointer or not
    _, tcfg, _, _ = _model()
    cfg = tt.get_config("tiny", dtype="float32", num_layers=1)
    eng = deepspeed_tpu_torch.initialize(
        model=TSpec(loss_fn=lambda p, b, r: tt.loss_fn(p, b, cfg),
                    params=tt.init_params(cfg, torch.Generator().manual_seed(
                        1), device="cpu")),
        config={"train_batch_size": 2}, device="cpu")[0]
    path, _ = eng.load_checkpoint(out)
    assert path.endswith(committed[-1])
    # the next save collects the orphaned staging dir
    eng.save_checkpoint(out)
    assert not [n for n in os.listdir(out) if n.endswith(".tmp")]


def test_checkpoint_utils_write_the_reference_cli_files(tmp_path):
    # the CLI's hf-llama permutes q and k with the default config's 8
    # heads of 64, in both packages: a model of that width
    _, tcfg, _, host = _model(6, hidden_size=512, num_heads=8,
                              num_kv_heads=8, intermediate_size=128,
                              tie_embeddings=False, param_dtype="bfloat16")
    eng = _torch_engine(tcfg, host, dtype=torch.bfloat16)
    eng.save_checkpoint(str(tmp_path / "ck"))
    ck = str(tmp_path / "ck")
    jcu.to_fp32(ck, str(tmp_path / "j32.safetensors"))
    tcu.main(["fp32", ck, str(tmp_path / "t32.safetensors")])
    jcu.to_hf_llama(ck, str(tmp_path / "jhf"), 2)
    tcu.main(["hf-llama", ck, str(tmp_path / "thf"), "--num-layers", "2"])
    for a, b in (("j32.safetensors", "t32.safetensors"),
                 ("jhf/model.safetensors", "thf/model.safetensors")):
        ja = tce._load_tree_flat(str(tmp_path / a))
        tb = tce._load_tree_flat(str(tmp_path / b))
        assert ja.keys() == tb.keys()
        for k in ja:
            assert ja[k].dtype == tb[k].dtype and torch.equal(ja[k], tb[k]), k
        assert (tmp_path / a).read_bytes() == (tmp_path / b).read_bytes()
    assert "lm_head.weight" in tb
