"""Parity: the port's MoE layers (``deepspeed_tpu_torch/moe/``) and MoE
models against the JAX package's, on numpy-seeded inputs in f32 with the
reference's weights converted by ``params_from_jax``.

* ``top_k_gating`` and ``expert_choice_gating``: combine weights, dispatch
  mask, aux and z losses and load within 1e-5 (the mask exactly).
* ``moe_block_with_losses`` for capacity, dropless and expert-choice
  routing, plain and PR-MoE: y, aux and z within 1e-5.  Router logits get a
  bias that separates the top-k from the rest, so no tie can break another
  way (``jax.lax.top_k`` takes the lower index, ``torch.topk`` promises
  nothing).
* Dropless ``y`` does not depend on the layout's m-tile: 16, 64 and the
  TPU's 512 agree within 1e-6 of max|y| (f32 products of differently
  blocked matmuls).
* ``tiny-moe``'s loss within 1e-5 and gradients within 1e-4 against
  ``loss_fn`` (dropless and capacity).
* The v2 engine on ``tiny-moe``: greedy tokens identical to the JAX
  engine's for dropless and capacity routing, MHA and GQA, one request,
  chunked prefill with burst decode, and a scheduling fuzz with
  cancellations; expert-choice routing refused as the reference refuses it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import engine as je
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.moe import layer as jl
from deepspeed_tpu_torch.inference.v2 import engine as te
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.moe import dropless as tdl
from deepspeed_tpu_torch.moe import layer as tl
from deepspeed_tpu_torch.moe import sharded_moe as tsm
from deepspeed_tpu_torch.ops.hopper import grouped_matmul as tg

from tests.torch_cpu import one_torch_thread  # noqa: F401

TOL = 1e-5
GRAD_TOL = 1e-4
V2_KW = dict(max_tokens_per_step=32, max_seqs=4, block_size=8, num_blocks=64,
             max_blocks_per_seq=8, dtype="float32")
SPLIT_KW = dict(V2_KW, max_tokens_per_step=16)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _moe_params(name, routing, seed=0):
    jcfg = jt.get_config(name, dtype="float32", moe_routing=routing)
    tcfg = tt.get_config(name, dtype="float32", moe_routing=routing)
    params = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    lp = jax.tree_util.tree_map(lambda a: np.array(a[0]),
                                params["layers"]["moe"])
    return jcfg, tcfg, lp


def _separated_logits(rng, B, S, E, k):
    """Router logits whose top-k stand clear of the rest and of each other
    (no tie for either framework to break)."""
    logits = rng.standard_normal((B, S, E)).astype(np.float32) * 0.1
    for b in range(B):
        for s in range(S):
            order = rng.permutation(E)
            logits[b, s, order[:k]] += 2.0 + np.arange(k)[::-1]
    return logits


@pytest.mark.parametrize("top_k", [1, 2])
def test_top_k_gating_matches_reference(top_k):
    rng = np.random.default_rng(top_k)
    logits = _separated_logits(rng, 2, 24, 4, top_k)
    # a skewed router: expert 0 over capacity, so tokens are dropped
    logits[:, :, 0] += 3.0
    want = jl.top_k_gating(jnp.asarray(logits), 4, top_k, 1.0)
    got = tl.top_k_gating(torch.from_numpy(logits), 4, top_k, 1.0)
    np.testing.assert_array_equal(got.dispatch_mask.numpy(),
                                  np.asarray(want.dispatch_mask))
    assert not got.dispatch_mask.all(-1).any()  # capacity dropped some
    for name in ("combine_weights", "aux_loss", "z_loss", "load"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=TOL, rtol=0, err_msg=name)


def test_expert_choice_gating_matches_reference():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 20, 4)).astype(np.float32)
    want = jl.expert_choice_gating(jnp.asarray(logits), 4, 1.0)
    got = tl.expert_choice_gating(torch.from_numpy(logits), 4, 1.0)
    np.testing.assert_array_equal(got.dispatch_mask.numpy(),
                                  np.asarray(want.dispatch_mask))
    for name in ("combine_weights", "aux_loss", "z_loss", "load"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("routing", ["capacity", "dropless",
                                     "expert_choice"])
@pytest.mark.parametrize("name", ["tiny-moe", "tiny-prmoe"])
def test_moe_block_matches_reference(name, routing):
    jcfg, tcfg, lp = _moe_params(name, routing)
    rng = np.random.default_rng(len(name) + len(routing))
    x = rng.standard_normal((2, 13, 64)).astype(np.float32)
    jy, ja, jz = jl.moe_block_with_losses(
        jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, lp), jcfg)
    ty, ta, tz = tl.moe_block_with_losses(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in lp.items()},
        tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL, rtol=0)
    np.testing.assert_allclose(ta.item(), float(ja), atol=TOL, rtol=0)
    np.testing.assert_allclose(tz.item(), float(jz), atol=TOL, rtol=0)
    y2 = tl.dense_moe_block(torch.from_numpy(x),
                            {k: torch.from_numpy(v) for k, v in lp.items()},
                            tcfg)
    torch.testing.assert_close(y2, ty, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_dropless_independent_of_tile_m(dtype):
    _, tcfg, lp = _moe_params("tiny-moe", "dropless")
    p = {k: torch.from_numpy(v).to(dtype) for k, v in lp.items()}
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (3, 11, 64)).astype(np.float32)).to(dtype)
    tg.reset_counts()
    ys = [tdl.dropless_moe_block_with_losses(x, p, tcfg, tile_m=m)[0]
          for m in (16, 64, 512)]
    assert tg.PLAIN_CALLS["grouped_matmul_plain"] == 9  # 3 GEMMs each
    scale = ys[0].float().abs().max().item()
    for y in ys[1:]:
        assert (y.float() - ys[0].float()).abs().max().item() <= 1e-6 * scale
    # the default tile: 16 rows at decode sizes, 64 above
    assert tdl.default_tile_m(16, 8) == 16 and tdl.default_tile_m(512, 8) == 64


def test_dropless_combine_adds_in_assignment_order():
    """bf16: each token's k weighted rows are added in order with one
    rounding per add, as the reference's scatter-add does."""
    _, tcfg, lp = _moe_params("tiny-moe", "dropless")
    cfg = dataclasses.replace(tcfg, moe_top_k=3, dtype="bfloat16")
    jcfg = jt.get_config("tiny-moe", moe_routing="dropless", moe_top_k=3,
                         dtype="bfloat16")
    x = np.random.default_rng(4).standard_normal((2, 7, 64)).astype(
        np.float32)
    xb = torch.from_numpy(x).bfloat16()
    p = {k: torch.from_numpy(v).bfloat16() for k, v in lp.items()}
    got = tdl.dropless_moe_block_with_losses(xb, p, cfg)[0]
    from deepspeed_tpu.moe import dropless as jdl

    want = jdl.dropless_moe_block_with_losses(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
        {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
         for k, v in p.items()}, jcfg)[0]
    # the expert GEMMs round to bf16 on both sides from f32 sums taken in
    # another order, so rows may differ by a bf16 ulp or two of the largest
    # output; an add of the k rows in another order or precision would
    # show as well
    diff = np.abs(got.float().numpy() - np.asarray(want, np.float32))
    assert diff.max() <= 2 ** -7 * np.abs(np.asarray(want, np.float32)).max()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("routing", ["dropless", "capacity"])
def test_loss_and_grads_match_reference(routing):
    kw = dict(dtype="float32", num_kv_heads=2, moe_routing=routing)
    jcfg, tcfg = jt.get_config("tiny-moe", **kw), tt.get_config("tiny-moe",
                                                                 **kw)
    params = jt.init_params(jax.random.PRNGKey(1), jcfg)
    tparams = tt.params_from_jax(_np_tree(params), tcfg, device="cpu",
                                 dtype=torch.float32)
    batch = {"input_ids": np.random.default_rng(2).integers(
        0, 256, (2, 24)).astype(np.int32)}
    (jloss, _), jgrad = jax.value_and_grad(
        lambda p: jt.loss_fn(p, {"input_ids": jnp.asarray(
            batch["input_ids"])}, jcfg), has_aux=True)(params)
    leaves = _flat(tparams)
    for t in leaves.values():
        t.requires_grad_(True)
    tloss, _ = tt.loss_fn(tparams, {"input_ids": torch.from_numpy(
        batch["input_ids"])}, tcfg)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=TOL, rtol=0)
    jg = _flat(_np_tree(jgrad))
    assert jg.keys() == leaves.keys()
    assert any("moe" in k for k in jg)
    for key, g in jg.items():
        np.testing.assert_allclose(leaves[key].grad.numpy(), g,
                                   atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=key)


def test_init_params_layout_matches_reference():
    for name, kw in (("tiny-moe", {}), ("tiny-prmoe", {}),
                     ("tiny-moe", {"activation": "gelu"})):
        jp = jt.init_params(jax.random.PRNGKey(0), jt.get_config(name, **kw))
        tp = tt.init_params(tt.get_config(name, **kw),
                            torch.Generator().manual_seed(0), device="cpu")
        want = {k: v.shape for k, v in _flat(_np_tree(jp)).items()}
        got = {k: tuple(v.shape) for k, v in _flat(tp).items()}
        assert got == want


def test_sharded_moe_refused():
    _, tcfg, lp = _moe_params("tiny-moe", "capacity")
    with pytest.raises(NotImplementedError, match="A13"):
        tsm.sharded_moe_block(torch.zeros(1, 2, 64), lp, tcfg)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module",
                params=[("dropless", None), ("dropless", 2),
                        ("capacity", None), ("capacity", 2)],
                ids=["dropless-mha", "dropless-gqa", "capacity-mha",
                     "capacity-gqa"])
def model(request):
    routing, kv = request.param
    kw = dict(dtype="float32", num_kv_heads=kv, moe_routing=routing)
    jcfg = jt.get_config("tiny-moe", **kw)
    params = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = tt.get_config("tiny-moe", **kw)
    tparams = tt.params_from_jax(_np_tree(params), tcfg, device="cpu")
    return jcfg, params, tcfg, tparams


def _engines(model, v2_kw):
    jcfg, params, tcfg, tparams = model
    return (je.InferenceEngineV2(jcfg, params, je.V2Config(**v2_kw)),
            te.InferenceEngineV2(tcfg, tparams, te.V2Config(**v2_kw),
                                 device="cpu"))


def test_engine_single_request_identical(model):
    jeng, teng = _engines(model, V2_KW)
    ju, tu = jeng.put([5, 6, 7, 8], 6), teng.put([5, 6, 7, 8], 6)
    assert teng.generate_all()[tu] == jeng.generate_all()[ju]
    assert teng.free_blocks == teng.total_blocks


def test_engine_chunked_prefill_and_burst_identical(model):
    jeng, teng = _engines(model, SPLIT_KW)
    prompts = [[1, 2, 3], list(range(9, 30)), [11, 12], list(range(40, 75))]
    ju = [jeng.put(p, max_new_tokens=5) for p in prompts]
    tu = [teng.put(p, max_new_tokens=5) for p in prompts]
    jr, tr = jeng.generate_all(burst=4), teng.generate_all(burst=4)
    assert [tr[u] for u in tu] == [jr[u] for u in ju]
    assert teng.burst_steps == jeng.burst_steps > 0


def test_engine_fuzz_with_cancellation_identical(model):
    rng = np.random.default_rng(11)
    jeng, teng = _engines(model, SPLIT_KW)
    live = []
    for _ in range(24):
        op = rng.random()
        if op < 0.3 and jeng.num_running + jeng.num_waiting < 6:
            p = rng.integers(0, 256, size=int(rng.integers(1, 30))).tolist()
            n = int(rng.integers(1, 8))
            live.append(jeng.put(p, max_new_tokens=n))
            assert teng.put(p, max_new_tokens=n) == live[-1]
        elif op < 0.4 and live:
            uid = live.pop(int(rng.integers(len(live))))
            assert jeng.cancel(uid) == teng.cancel(uid)
        else:
            assert teng.step() == jeng.step()
        assert teng.free_blocks == jeng.free_blocks
    assert teng.generate_all(burst=4) == jeng.generate_all(burst=4)
    assert teng.free_blocks == teng.total_blocks


def test_engine_refuses_expert_choice(model):
    _, _, tcfg, tparams = model
    cfg = dataclasses.replace(tcfg, moe_routing="expert_choice")
    with pytest.raises(ValueError, match="expert_choice"):
        te.InferenceEngineV2(cfg, tparams, te.V2Config(**V2_KW),
                             device="cpu")


def test_engine_router_stays_f32():
    """The engine casts weights to its compute dtype at load, but keeps the
    router (read in f32 by the reference) in f32."""
    cfg = tt.get_config("tiny-prmoe")
    params = tt.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu", dtype=torch.float32)
    eng = te.InferenceEngineV2(cfg, params, te.V2Config(**dict(
        V2_KW, dtype="bfloat16")), device="cpu")
    moe = eng.params["layers"]["moe"]
    assert moe["router"].dtype == moe["coef"].dtype == torch.float32
    assert moe["w_in"].dtype == torch.bfloat16
    uid = eng.put([1, 2, 3], max_new_tokens=3)
    assert len(eng.generate_all()[uid]) == 6
