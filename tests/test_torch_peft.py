"""Parity: the port's PEFT subsystem (``deepspeed_tpu_torch/linear/``,
``ops/quantizer.py``'s block codecs, the engine's PEFT mode, adapter-only
checkpoints, merged export, LoRA trees served by v1 and v2) against the JAX
package's, on numpy-seeded inputs, the reference's LoRA trees converted by
``params_from_jax``:

- the config's errors and the engine's PEFT refusals, word for word;
- ``quantize_base_weight`` codes and scales bit for bit for fp8, fp6, int8
  and int4, stacked and not, with a group shrink, and the flat codecs;
- ``lora_forward`` and its gradients to x, A and B within 1e-5 in f32 (a
  dense base and each quantized one); in bf16 the B6 path (the kernel's
  plain version here) against the reference's Pallas kernel in interpret
  mode within 1e-2 of max|ref| (both round the output to bf16, 2^-8, after
  sums of the same exact bf16 products in another order);
- ``merge_lora_weights`` within 1e-6 of max, ``graft_adapter_pack``, and
  the path names of ``trainable_mask`` / ``adapter_only_flat``;
- three ``train_batch`` steps of a tiny model with a dense base and with
  each quantized base: losses and grad norms within 1e-5 relative,
  adapters within 1e-4, the base bit for bit unchanged, the optimizer
  state's leaf names the reference's; fp16 PEFT's overflow flags and loss
  scales equal to the reference's;
- adapter-only checkpoints: the files at step 0 byte for byte the
  reference's, each package's checkpoint resumed by the other, and the two
  load errors;
- ``export_merged_weights`` against the reference's file (1e-6 of max);
- v1 and v2 serving a LoRA tree: greedy tokens identical; v1's
  ``quantize_bits`` error.

JAX engines are built once per base format (module cache)."""

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
from deepspeed_tpu.inference import engine as jv1
from deepspeed_tpu.inference.v2 import engine as jv2
from deepspeed_tpu.linear import config as jlc
from deepspeed_tpu.linear import optimized_linear as jl
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.ops import quantizer as jqz
from deepspeed_tpu.parallel.topology import MeshTopology
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu.runtime.checkpoint import engine as jck
from deepspeed_tpu.runtime.config_utils import ConfigError as JConfigError
from deepspeed_tpu.runtime.engine import ModelSpec as JSpec
from deepspeed_tpu.utils.tree_io import flatten_with_paths as jflat
from deepspeed_tpu_torch.inference import engine as tv1
from deepspeed_tpu_torch.inference.v2 import engine as tv2
from deepspeed_tpu_torch.linear import config as tlc
from deepspeed_tpu_torch.linear import optimized_linear as tl
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.ops import quantizer as tqz
from deepspeed_tpu_torch.ops.hopper import mixed_gemm as tmg
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.runtime.checkpoint import engine as tck
from deepspeed_tpu_torch.runtime.config_utils import ConfigError
from deepspeed_tpu_torch.runtime.engine import ModelSpec as TSpec

from tests.torch_cpu import one_torch_thread  # noqa: F401

F32_TOL = 1e-5
BF16_REL = 1e-2
STEP_RTOL = 1e-5
ADAPTER_TOL = 1e-4
MERGE_REL = 1e-6

#: (q_bits, mantissa_bits) of each base, None: dense
FORMATS = {"dense": None, "fp8": (8, 3), "fp6": (6, 2), "int8": (8, 0),
           "int4": (4, 0)}
LORA = {"enabled": True, "lora_r": 4, "lora_alpha": 8}
CFG = {"train_batch_size": 8,
       "optimizer": {"type": "adamw",
                     "params": {"lr": 1e-3, "weight_decay": 0.01}},
       "gradient_clipping": 1.0, "steps_per_print": 1000}


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _lora_cfg(fmt, group=64):
    lora = dict(LORA)
    if FORMATS[fmt] is not None:
        q, m = FORMATS[fmt]
        lora.update(quantize_base=True, quantization={
            "q_bits": q, "mantissa_bits": m, "group_size": group})
    return lora


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in jflat(tree).items()}


def _tflat(tree):
    return {k: v.detach().cpu() for k, v in tck.flatten_with_paths(
        tree).items()}


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("peft", [
    {"lora": {"lora_r": 0}},
    {"lora": {"base_weight_sharding": -1}},
    {"lora": {"quantization": {"q_bits": 5, "mantissa_bits": 0}}},
    {"lora": {"quantization": {"q_bits": 8, "mantissa_bits": 2}}},
    {"lora": {"quantization": {"group_size": 6}}},
    {"lora": {"quantization": {"group_size": 0}}},
    {"lora": {"rank": 4}},
], ids=["r0", "sharding", "qbits", "mantissa", "group6", "group0", "typo"])
def test_config_errors_are_the_references(peft):
    with pytest.raises(JConfigError) as want:
        jconfig.load_config({"peft": peft})
    with pytest.raises(ConfigError) as got:
        tconfig.load_config({"peft": peft})
    if "rank" in peft["lora"]:  # pydantic's text and the port's differ
        assert "rank" in str(got.value) and "rank" in str(want.value)
    else:
        assert str(got.value) == str(want.value)


def test_config_sections_and_scaling():
    cfg = tconfig.load_config({"peft": {"lora": dict(
        LORA, quantize_base=True, quantization={"q_bits": 4,
                                                "mantissa_bits": 0})}})
    ref = jconfig.load_config({"peft": {"lora": dict(
        LORA, quantize_base=True, quantization={"q_bits": 4,
                                                "mantissa_bits": 0})}})
    assert isinstance(cfg.peft, tlc.PEFTConfig)
    assert cfg.peft.lora.scaling == ref.peft.lora.scaling == 2.0
    assert cfg.peft.lora.target_modules == ref.peft.lora.target_modules \
        == tlc.DEFAULT_TARGET_MODULES
    assert (cfg.peft.lora.quantization.group_size ==
            ref.peft.lora.quantization.group_size)
    default = tlc.QuantizationConfig()
    assert (default.q_bits, default.mantissa_bits) == (8, 3)  # fp8 e4m3
    cfg.check_supported()  # PEFT runs


@pytest.mark.parametrize("extra", [
    {"zero_optimization": {"offload_optimizer": {"device": "cpu"}}},
    {"zenflow": {"enabled": True}},
    {"zero_optimization": {"zero_quantized_weights": True}},
], ids=["offload", "zenflow", "qwz"])
def test_peft_refusals_are_the_references(extra):
    jcfg = jt.get_config("tiny", dtype="float32")
    cfg = dict(CFG, peft={"lora": LORA}, **extra)
    with pytest.raises(JConfigError) as want:
        deepspeed_tpu.initialize(model=JSpec(
            loss_fn=lambda p, b, r: jt.loss_fn(p, b, jcfg),
            params=jt.init_params(jax.random.PRNGKey(0), jcfg),
            param_axes=jt.param_axes(jcfg)), config=cfg,
            topo=MeshTopology.from_config(jconfig.MeshConfig(),
                                          devices=jax.devices()[:1]))
    with pytest.raises(ConfigError) as got:
        tconfig.load_config(cfg).check_supported()
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# codecs and the quantized base
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["fp8", "fp6", "int8", "int4"])
@pytest.mark.parametrize("shape,group", [((64, 32), 64), ((2, 200, 128), 256),
                                         ((3, 96, 16), 32)],
                         ids=["2d", "stacked_shrink", "stacked"])
def test_quantize_base_weight_bit_exact(fmt, shape, group):
    w = _rand(1, *shape, scale=0.1)
    w.reshape(-1)[0] = 3.0  # one block's absmax maps onto the format's max
    q, m = FORMATS[fmt]
    qcfg = jlc.QuantizationConfig(q_bits=q, mantissa_bits=m,
                                  group_size=group)
    jq = jl.quantize_base_weight(jnp.asarray(w), qcfg)
    tq = tl.quantize_base_weight(torch.from_numpy(w), tlc.QuantizationConfig(
        q_bits=q, mantissa_bits=m, group_size=group))
    assert (tq.layout, tq.group_size, tq.inner_shape, tq.shape) == (
        jq.layout, jq.group_size, tuple(jq.inner_shape), jq.shape)
    codes = np.asarray(jq.codes)
    assert tq.codes.numpy().dtype == codes.dtype
    assert tq.codes.numpy().tobytes() == codes.tobytes()
    assert tq.scales.numpy().tobytes() == np.asarray(jq.scales).tobytes()
    np.testing.assert_array_equal(tq.dequantize(torch.float32).numpy(),
                                  np.asarray(jq.dequantize(jnp.float32)))


@pytest.mark.parametrize("codec", ["int8", "int4", "fp8", "fp6"])
def test_flat_codecs_bit_exact(codec):
    x = _rand(2, 1000, scale=0.3)  # 1000: the last block is padded
    x[5] = 0.0
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    if codec in ("int8", "int4"):
        bits = int(codec[3:])
        jc, js = jqz.quantize_blockwise(xj, bits=bits, block_size=64)
        tc, ts = tqz.quantize_blockwise(xt, bits=bits, block_size=64)
        back = (jqz.dequantize_blockwise(jc, js, bits, 64, shape=x.shape),
                tqz.dequantize_blockwise(tc, ts, bits, 64, shape=x.shape))
    elif codec == "fp8":
        jc, js = jqz.quantize_fp8(xj, block_size=64)
        tc, ts = tqz.quantize_fp8(xt, block_size=64)
        back = (jqz.dequantize_fp8(jc, js, shape=x.shape),
                tqz.dequantize_fp8(tc, ts, shape=x.shape))
        jc = jax.lax.bitcast_convert_type(jc, jnp.uint8)
        tc = tc.view(torch.uint8)
    else:
        jc, js = jqz.quantize_minifloat(xj, bits=6, block_size=64)
        tc, ts = tqz.quantize_minifloat(xt, bits=6, block_size=64)
        back = (jqz.dequantize_minifloat(jc, js, bits=6, shape=x.shape),
                tqz.dequantize_minifloat(tc, ts, bits=6, shape=x.shape))
    assert tc.numpy().tobytes() == np.asarray(jc).tobytes()
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    np.testing.assert_array_equal(back[1].numpy(), np.asarray(back[0]))
    # an all-zero block keeps scale 1
    zc, zs = tqz.quantize_fp8(torch.zeros(64))
    assert zs.item() == 1.0 and not zc.float().any()


# ---------------------------------------------------------------------------
# lora_forward
# ---------------------------------------------------------------------------


def _lora_pair(fmt, K=128, N=128, r=4, seed=3, group=64):
    """(reference LoRAWeight, port LoRAWeight) on the same weights, B
    random so that the adapter counts."""
    w = _rand(seed, K, N) / np.sqrt(K)
    lcfg = jlc.LoRAConfig(**_lora_cfg(fmt, group))
    node = jl.init_lora_weight(jax.random.PRNGKey(seed), jnp.asarray(w),
                               lcfg)
    node.lora_b = jnp.asarray(_rand(seed + 1, r, N, scale=0.1))
    tnode = tt.params_from_jax({"w": _np(node)}, tt.get_config("tiny"),
                               device="cpu", dtype=torch.float32)["w"]
    return node, tnode


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_lora_forward_and_grads_f32(fmt):
    jw, tw = _lora_pair(fmt)
    x, g = _rand(4, 2, 8, 128), _rand(5, 2, 8, 128)

    def jloss(x, a, b):
        n = jl.LoRAWeight(jw.base, a, b, jw.scaling)
        return jnp.sum(jl.lora_forward(x, n) * g)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jw.lora_a,
                                                jw.lora_b)
    xt = torch.from_numpy(x).requires_grad_()
    a = tw.lora_a.clone().requires_grad_()
    b = tw.lora_b.clone().requires_grad_()
    y = tl.lora_forward(xt, tl.LoRAWeight(tw.base, a, b, tw.scaling))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(
        jl.lora_forward(jnp.asarray(x), jw)), atol=F32_TOL, rtol=0)
    (y * torch.from_numpy(g)).sum().backward()
    for got, ref in zip((xt.grad, a.grad, b.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=F32_TOL * np.abs(ref).max(), rtol=0)
    base = tw.base if fmt == "dense" else tw.base.codes
    assert base.grad is None and not base.requires_grad


@pytest.mark.parametrize("fmt", ["fp6", "int8", "int4"])
def test_lora_forward_bf16_runs_b6_like_the_reference(fmt):
    jw, tw = _lora_pair(fmt, K=256, N=256, group=128)  # B6's envelope
    x = _rand(6, 16, 256)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = np.asarray(jl.lora_forward(jnp.asarray(x, jnp.bfloat16), jw),
                      np.float32)
    tmg.reset_counts()
    got = tl.lora_forward(xb, tw)
    assert tmg.PLAIN_CALLS["mixed_gemm_plain"] == 1  # B6's plain version
    assert tmg.DEQUANT_CALLS["mixed_gemm"] == 0
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err < BF16_REL
    # the gradient reaches x through the frozen base, not the codes
    xg = xb.clone().requires_grad_()
    tl.lora_forward(xg, tw).float().sum().backward()
    assert xg.grad is not None and tmg.PLAIN_CALLS["mixed_gemm_plain"] == 2
    # stacked (3-D) codes or f32 x dequantize the detached base instead
    tmg.reset_counts()
    tl.lora_forward(torch.from_numpy(x), tw)
    assert tmg.PLAIN_CALLS["mixed_gemm_plain"] == 0


def test_optimized_linear_module():
    gen = torch.Generator().manual_seed(0)
    cfg = tlc.LoRAConfig(enabled=True, lora_r=4, quantize_base=True,
                         quantization=tlc.QuantizationConfig(
                             q_bits=4, mantissa_bits=0, group_size=64))
    lin = tl.OptimizedLinear.init(gen, 64, 32, cfg, device="cpu")
    assert [n for n, _ in lin.named_parameters()] == ["lora_a", "lora_b"]
    assert {n for n, _ in lin.named_buffers()} == {"base_codes",
                                                   "base_scales"}
    x = torch.randn(3, 64, generator=gen)
    want = x @ lin.weight.base.dequantize(torch.float32)
    torch.testing.assert_close(lin(x), want)  # B = 0: the base alone
    lin(x).sum().backward()
    assert lin.lora_b.grad is not None
    if not torch.cuda.is_available():  # the card is the default device
        with pytest.raises(RuntimeError, match="CUDA"):
            tl.OptimizedLinear.init(gen, 64, 32, cfg)


# ---------------------------------------------------------------------------
# tree surgery
# ---------------------------------------------------------------------------


def test_merge_graft_and_paths():
    jcfg = jt.get_config("tiny", dtype="float32", num_kv_heads=2)
    params = jt.init_params(jax.random.PRNGKey(0), jcfg)
    for fmt in ("dense", "int4"):
        jp, _ = _lora_tree(jcfg, params, fmt, 1)
        for node in (jp["layers"]["attn"]["wq"], jp["layers"]["mlp"]["w_in"]):
            node.lora_b = jnp.asarray(_rand(7, *node.lora_b.shape, scale=0.1))
        tp = tt.params_from_jax(_np(jp), tt.get_config("tiny"),
                                device="cpu", dtype=torch.float32)
        assert tl.has_lora(tp) and not tl.has_lora(tl.merge_lora_weights(tp))
        # paths of the whole tree, of the mask, and of the adapter payload
        assert list(_tflat(tp)) == list(jflat(jp))
        tmask = tck.flatten_with_paths(tl.trainable_mask(tp))
        jmask = jflat(jl.trainable_mask(jp))
        assert tmask == {k: bool(v) for k, v in jmask.items()}
        assert list(tl.adapter_only_flat(_tflat(tp))) == list(
            jl.adapter_only_flat(jflat(jp)))
        sub = tck.flatten_with_paths(tl.trainable_subtree(
            tp, tl.trainable_mask(tp)))
        assert list(sub) == list(jflat(jl.trainable_subtree(
            jp, jl.trainable_mask(jp))))
        want = _flat_np(jl.merge_lora_weights(jp))
        got = _tflat(tl.merge_lora_weights(tp))
        assert list(got) == list(want)
        for k, w in want.items():
            assert got[k].numpy().dtype == w.dtype, k
            np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                       atol=MERGE_REL * np.abs(w).max())
    # a registry pack grafted onto a plain tree, then merged
    tplain = tt.params_from_jax(_np(params), tt.get_config("tiny"),
                                device="cpu", dtype=torch.float32)
    L, K, N = params["layers"]["attn"]["wq"].shape
    pack = {"wq": (_rand(8, L, K, 4), _rand(9, L, 4, N))}
    want = _flat_np(jl.merge_lora_weights(jl.graft_adapter_pack(
        params, pack)))
    got = _tflat(tl.merge_lora_weights(tl.graft_adapter_pack(tplain, pack)))
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=MERGE_REL * np.abs(w).max())
    with pytest.raises(ValueError, match="not found"):
        tl.graft_adapter_pack(tplain, {"nope": pack["wq"]})
    with pytest.raises(ValueError, match="wants a weight of shape"):
        tl.graft_adapter_pack(tplain, {"wk": pack["wq"]})


def test_apply_lora_wraps_targets_and_skips_moe():
    cfg = tt.get_config("tiny-moe", dtype="float32")
    params = tt.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    lcfg = tlc.LoRAConfig(enabled=True, lora_r=4, quantize_base=True,
                          quantization=tlc.QuantizationConfig(
                              q_bits=8, mantissa_bits=0, group_size=64))
    out, axes = tl.apply_lora(params, None, torch.Generator().manual_seed(1),
                              lcfg)
    assert axes is None  # no axes in, none out
    for k in ("wq", "wk", "wv", "wo"):
        node = out["layers"]["attn"][k]
        assert isinstance(node, tl.LoRAWeight)
        assert isinstance(node.base, tl.QuantizedBaseWeight)
        assert node.base.layout == "gemm" and not node.lora_b.any()
        assert node.base.shape == tuple(params["layers"]["attn"][k].shape)
        L, K, _ = node.base.shape
        assert node.lora_a.shape == (L, K, 4)
        std = float(node.lora_a.std()) * np.sqrt(K)
        assert 0.8 < std < 1.2  # A ~ N(0, 1/K)
    assert out["layers"]["moe"] is params["layers"]["moe"]
    with pytest.raises(TypeError, match="dict parameter tree"):
        tl.apply_lora([1], None, torch.Generator(), lcfg)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _model(**over):
    kw = dict(dtype="float32", num_kv_heads=2, attn_impl="xla")
    kw.update(over)
    jcfg, tcfg = jt.get_config("tiny", **kw), tt.get_config("tiny", **kw)
    return jcfg, tcfg, jt.init_params(jax.random.PRNGKey(1), jcfg)


def _batch(step, B=8):
    rng = np.random.default_rng(50 + step)
    return {"input_ids": rng.integers(0, 256, (B, 32)).astype(np.int32)}


def _lora_tree(jcfg, params, fmt, seed):
    """The reference's ``apply_lora`` under one ``jax.jit`` (eagerly, its
    codecs compile op by op; both packages then take the same tree), and
    the expanded axes."""
    lcfg = jlc.LoRAConfig(**_lora_cfg(fmt))
    axes = jt.param_axes(jcfg)
    lp = jax.jit(lambda p, k: jl.apply_lora(p, axes, k, lcfg)[0])(
        params, jax.random.PRNGKey(seed))
    return lp, jl.expand_axes_for_lora(axes, lp)


def _engines(fmt, cfg=None, model=None, pdtype=torch.float32):
    """(reference engine, port engine) on the same LoRA tree, drawn by the
    reference's ``apply_lora``."""
    jcfg, tcfg, params = model or _model()
    cfg = dict(cfg or CFG, peft={"lora": _lora_cfg(fmt)})
    lp, la = _lora_tree(jcfg, params, fmt, 7)
    one = MeshTopology.from_config(jconfig.MeshConfig(),
                                   devices=jax.devices()[:1])
    jeng = deepspeed_tpu.initialize(model=JSpec(
        loss_fn=lambda p, b, r: jt.loss_fn(p, b, jcfg), params=lp,
        param_axes=la), config=cfg, topo=one)[0]
    tparams = tt.params_from_jax(_np(lp), tcfg, device="cpu", dtype=pdtype)
    teng = deepspeed_tpu_torch.initialize(model=TSpec(
        loss_fn=lambda p, b, r: tt.loss_fn(p, b, tcfg), params=tparams),
        config=cfg, device="cpu")[0]
    return jeng, teng


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``trained(fmt)``: both engines after three steps, each step's
    metrics, the port's parameters before the first step, and the
    directory of both engines' checkpoints at steps 0 and 2 (``j/``,
    ``t/``); built once per format."""
    runs = {}

    def run(fmt):
        if fmt not in runs:
            jeng, teng = _engines(fmt)
            ckpt = tmp_path_factory.mktemp(f"ckpt_{fmt}")
            before = _tflat(teng.params)
            steps = []
            for s in range(3):
                if s in (0, 2):
                    jeng.save_checkpoint(str(ckpt / "j"))
                    teng.save_checkpoint(str(ckpt / "t"))
                steps.append((dict(jeng.train_batch(_batch(s))),
                              dict(teng.train_batch(_batch(s)))))
            runs[fmt] = jeng, teng, before, steps, ckpt
        return runs[fmt]

    return run


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_three_peft_steps_match_reference(fmt, trained):
    jeng, teng, before, steps, _ = trained(fmt)
    assert teng.peft_enabled and jeng.peft_enabled
    for s, (jm, tm) in enumerate(steps):
        for key in ("loss", "grad_norm", "lr", "accuracy"):
            np.testing.assert_allclose(tm[key], jm[key], rtol=STEP_RTOL,
                                       atol=1e-12, err_msg=f"{key}@{s}")
    want = _flat_np(jeng.state.params)
    got = _tflat(teng.params)
    assert list(got) == list(want)
    for k, w in want.items():
        if k.split("/")[-1] in tl.ADAPTER_LEAF_KEYS:
            np.testing.assert_allclose(got[k].numpy(), w, atol=ADAPTER_TOL,
                                       rtol=0, err_msg=k)
        else:  # frozen: embeddings, norms and the (quantized) bases
            assert got[k].numpy().tobytes() == before[k].numpy().tobytes()
            assert got[k].numpy().tobytes() == w.tobytes(), k
    # gradients and optimizer state for the adapters alone
    assert teng._paths == [k for k in teng._all_paths
                           if k.split("/")[-1] in tl.ADAPTER_LEAF_KEYS]
    assert all(p.requires_grad for p in teng._leaves)
    assert not any(p.requires_grad for p in teng._all_leaves
                   if all(p is not q for q in teng._leaves))
    assert sorted(teng.optimizer_state_flat()) == sorted(
        jflat(jeng.state.opt_state))


def test_fp16_peft_flags_and_scales_match_reference():
    cfg = dict(CFG, fp16={"enabled": True, "initial_scale_power": 24,
                          "hysteresis": 1})
    jeng, teng = _engines("int8", cfg, model=_model(
        dtype="float16", param_dtype="float32"))
    for s in range(3):
        jm, tm = dict(jeng.train_batch(_batch(s))), dict(
            teng.train_batch(_batch(s)))
        assert tm["overflow"] == jm["overflow"], s
        assert tm["loss_scale"] == jm["loss_scale"], s
        if not jm["overflow"]:
            np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-3)
    assert int(teng.skipped_steps) == int(jeng.state.skipped_steps)
    assert teng.get_loss_scale() == jeng.get_loss_scale()


def test_adapter_checkpoints_cross_packages(trained):
    _, _, _, steps, ckpt = trained("int4")
    for f in ("adapter_model.safetensors", "optimizer.safetensors"):
        assert (ckpt / "j" / "global_step0" / f).read_bytes() == (
            ckpt / "t" / "global_step0" / f).read_bytes(), f
    for name in ("j", "t"):
        d = ckpt / name / "global_step2"
        assert not (d / "model.safetensors").exists()
        assert json.loads((d / "engine_state.json").read_text())[
            "peft_adapter_only"] is True
    # each package resumes the other's step-2 checkpoint: its third step
    # is the saver's own
    jload, tload = _engines("int4")
    tload.load_checkpoint(str(ckpt / "j"))
    jload.load_checkpoint(str(ckpt / "t"))
    assert tload.get_global_step() == jload.get_global_step() == 2
    jm, tm = steps[2]
    for saver, loader in ((jm, tload), (tm, jload)):
        got = dict(loader.train_batch(_batch(2)))
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got[key], saver[key], rtol=STEP_RTOL,
                                       err_msg=key)


def test_peft_load_errors_are_the_references(tmp_path):
    jcfg, tcfg, params = _model()
    jpeft, tpeft = _engines("dense")
    tpeft.save_checkpoint(str(tmp_path / "adapter"))
    plain = deepspeed_tpu_torch.initialize(model=TSpec(
        loss_fn=lambda p, b, r: tt.loss_fn(p, b, tcfg),
        params=tt.params_from_jax(_np(params), tcfg, device="cpu",
                                  dtype=torch.float32)),
        config=CFG, device="cpu")[0]
    jplain = deepspeed_tpu.initialize(model=JSpec(
        loss_fn=lambda p, b, r: jt.loss_fn(p, b, jcfg), params=params,
        param_axes=jt.param_axes(jcfg)), config=CFG,
        topo=MeshTopology.from_config(jconfig.MeshConfig(),
                                      devices=jax.devices()[:1]))[0]
    with pytest.raises(ValueError) as want:
        jplain.load_checkpoint(str(tmp_path / "adapter"))
    with pytest.raises(ValueError) as got:
        plain.load_checkpoint(str(tmp_path / "adapter"))
    assert str(got.value) == str(want.value)
    assert "adapter-only (PEFT) checkpoint" in str(got.value)
    plain.save_checkpoint(str(tmp_path / "full"))
    with pytest.raises(KeyError) as want:
        jpeft.load_checkpoint(str(tmp_path / "full"))
    with pytest.raises(KeyError) as got:
        tpeft.load_checkpoint(str(tmp_path / "full"))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("fmt", ["dense", "int4"])
def test_export_merged_weights_matches_reference(fmt, tmp_path, trained):
    jeng, teng, _, _, _ = trained(fmt)
    jdir = jck.export_merged_weights(jeng, str(tmp_path), tag="j")
    tdir = teng.export_merged_weights(str(tmp_path), tag="t")
    want = jck._load_tree_flat(os.path.join(jdir, "model.safetensors"))
    got = tck._load_tree_flat(os.path.join(tdir, "model.safetensors"))
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].numpy().dtype == np.asarray(w).dtype, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=MERGE_REL * np.abs(w).max() + 1e-4
                                   * (k.split("/")[-1] in ("wq", "wk", "wv",
                                                           "wo", "w_in",
                                                           "w_out",
                                                           "w_gate")),
                                   err_msg=k)
    with open(os.path.join(tdir, "engine_state.json")) as f:
        assert json.load(f)["merged_lora"] is True
    merged = tck.load_merged_params(tdir, tl.merge_lora_weights(teng.params))
    assert not tl.has_lora(merged)


# ---------------------------------------------------------------------------
# serving a LoRA tree
# ---------------------------------------------------------------------------


def _served_tree(fmt):
    jcfg = jt.get_config("tiny", dtype="float32", num_kv_heads=2)
    params = jt.init_params(jax.random.PRNGKey(0), jcfg)
    lp, _ = _lora_tree(jcfg, params, fmt, 3)
    for grp in ("attn", "mlp"):
        for k, node in lp["layers"][grp].items():
            if isinstance(node, jl.LoRAWeight):
                node.lora_b = jnp.asarray(_rand(
                    hash(k) % 1000, *node.lora_b.shape, scale=0.5))
    tcfg = tt.get_config("tiny", dtype="float32", num_kv_heads=2)
    return jcfg, lp, tcfg, tt.params_from_jax(_np(lp), tcfg, device="cpu",
                                              dtype=torch.float32)


@pytest.mark.parametrize("fmt", ["int8"])
def test_v1_and_v2_serve_a_lora_tree(fmt):
    jcfg, lp, tcfg, tp = _served_tree(fmt)
    prompts = np.random.default_rng(0).integers(1, 256, (2, 9),
                                                dtype=np.int64)
    icfg = {"dtype": "float32", "max_seq_len": 64}
    want = jv1.InferenceEngine(model_config=jcfg, params=lp,
                               config=dict(icfg)).generate(
        prompts, max_new_tokens=6)
    got = tv1.InferenceEngine(model_config=tcfg, params=tp,
                              config=dict(icfg), device="cpu").generate(
        prompts, max_new_tokens=6)
    np.testing.assert_array_equal(got, want)
    v2 = dict(max_tokens_per_step=32, max_seqs=4, block_size=8,
              num_blocks=64, max_blocks_per_seq=8, dtype="float32")
    jeng = jv2.InferenceEngineV2(jcfg, lp, jv2.V2Config(**v2))
    teng = tv2.InferenceEngineV2(tcfg, tp, tv2.V2Config(**v2), device="cpu")
    ju = jeng.put(list(prompts[0]), max_new_tokens=6)
    tu = teng.put(list(prompts[0]), max_new_tokens=6)
    assert teng.generate_all()[tu] == jeng.generate_all()[ju]
    # quantize_bits with an unmerged LoRA tree: the reference's v1 error
    with pytest.raises(ValueError) as jerr:
        jv1.InferenceEngine(model_config=jcfg, params=lp,
                            config=dict(icfg, quantize_bits=8))
    with pytest.raises(ValueError) as terr:
        tv1.InferenceEngine(model_config=tcfg, params=tp,
                            config=dict(icfg, quantize_bits=8), device="cpu")
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("policy", tt.REMAT_POLICIES)
def test_every_remat_policy_runs_the_lora_nodes(policy):
    """Each remat policy gives the adapters' gradients of ``everything``
    (no recompute) on a tree of LoRA nodes over an int8 base, in bf16 on
    the mixed GEMM's path (its plain version here): the recompute is the
    same arithmetic, so the gradients are equal bit for bit."""
    cfg = tt.get_config("tiny", dtype="bfloat16", num_kv_heads=2,
                        hidden_size=128, intermediate_size=256)
    params = tt.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu", dtype=torch.float32)
    lcfg = tlc.LoRAConfig(**_lora_cfg("int8", group=128))
    tree, _ = tl.apply_lora(params, None, torch.Generator().manual_seed(1),
                            lcfg)
    gen = torch.Generator().manual_seed(2)
    tree = tl.tree_map(lambda t: t.normal_(0.0, 0.1, generator=gen)
                       if t.dim() == 3 and t.shape[1] == 4 else t, tree)
    leaves = [t.requires_grad_() for t in tl.tree_leaves(
        tl.trainable_subtree(tree, tl.trainable_mask(tree)))]
    tokens = torch.from_numpy(_batch(0, B=2)["input_ids"])

    def grads(name):
        c = dataclasses.replace(cfg, remat_policy=name)
        tmg.reset_counts()
        loss, _ = tt.loss_fn(tree, {"input_ids": tokens}, c)
        return torch.autograd.grad(loss, leaves), tmg.PLAIN_CALLS[
            "mixed_gemm_plain"]

    (want, n_want), (got, n_got) = grads("everything"), grads(policy)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # seven projections a layer; every other policy's recompute runs them
    # again, as the reference's remat recomputes its kernel forward
    assert n_want == 7 * cfg.num_layers
    assert n_got == (1 if policy == "everything" else 2) * n_want, n_got
