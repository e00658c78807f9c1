"""Parity: the port's v2 serving engine (``deepspeed_tpu_torch``) against
the JAX package's, on ``tiny`` in f32 with the reference's weights converted
by ``params_from_jax``.  Greedy tokens must be identical — one request,
concurrent requests with chunked (multi-step) prefill, burst decode,
cancellation under a scheduling fuzz — for MHA and GQA; the first mixed
step's logits agree to 1e-4.  The JAX side's Pallas kernels run in
interpret mode on the CPU; the port's wrappers run their plain versions."""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import engine as je
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.inference.v2 import engine as te
from deepspeed_tpu_torch.models import transformer as tt

from tests.torch_cpu import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the V2Config of tests/test_inference_v2.py's greedy checks
V2_KW = dict(max_tokens_per_step=32, max_seqs=4, block_size=8, num_blocks=64,
             max_blocks_per_seq=8, dtype="float32")
# a token budget below the longer prompts: their prefill spans several
# SplitFuse steps, with chunk starts off the block grid
SPLIT_KW = dict(V2_KW, max_tokens_per_step=16)


@pytest.fixture(scope="module", params=[None, 2], ids=["mha", "gqa"])
def model(request):
    kv = request.param
    jcfg = jt.get_config("tiny", dtype="float32", num_kv_heads=kv)
    params = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = tt.get_config("tiny", dtype="float32", num_kv_heads=kv)
    tparams = tt.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                 tcfg, device="cpu")
    return jcfg, params, tcfg, tparams


def _engines(model, v2_kw):
    jcfg, params, tcfg, tparams = model
    return (je.InferenceEngineV2(jcfg, params, je.V2Config(**v2_kw)),
            te.InferenceEngineV2(tcfg, tparams, te.V2Config(**v2_kw),
                                 device="cpu"))


def _serve_both(model, v2_kw, prompts, max_new, **gen_kw):
    jeng, teng = _engines(model, v2_kw)
    ju = [jeng.put(p, max_new_tokens=max_new) for p in prompts]
    tu = [teng.put(p, max_new_tokens=max_new) for p in prompts]
    jr, tr = jeng.generate_all(**gen_kw), teng.generate_all(**gen_kw)
    return [jr[u] for u in ju], [tr[u] for u in tu], jeng, teng


def test_single_request_greedy_identical(model):
    want, got, _, teng = _serve_both(model, V2_KW, [[5, 6, 7, 8]], 6)
    assert got == want
    assert len(got[0]) == 4 + 6
    assert teng.free_blocks == teng.total_blocks  # every block returned


def test_concurrent_chunked_prefill_identical(model):
    prompts = [[1, 2, 3], list(range(9, 30)), [11, 12], list(range(40, 75))]
    want, got, jeng, teng = _serve_both(model, SPLIT_KW, prompts, 5,
                                        burst=4)
    assert got == want
    assert teng.burst_steps == jeng.burst_steps > 0
    assert teng.fast_steps == jeng.fast_steps


def test_burst_matches_single_step(model):
    prompts = [[3, 1, 4, 1, 5], list(range(20, 41))]
    want, got4, _, _ = _serve_both(model, SPLIT_KW, prompts, 7, burst=4)
    # single-step decode on the port alone: the reference's tokens are
    # want, whatever its burst
    teng1 = _engines(model, SPLIT_KW)[1]
    uids = [teng1.put(p, max_new_tokens=7) for p in prompts]
    res = teng1.generate_all(burst=1)
    got1 = [res[u] for u in uids]
    assert got4 == want and got1 == want
    assert teng1.burst_steps == 0 and teng1.fast_steps > 0


def test_first_mixed_step_logits(model):
    jcfg, params, tcfg, tparams = model
    jeng, teng = _engines(model, SPLIT_KW)
    prompts = [list(range(1, 12)), [7, 8], list(range(30, 50))]
    for eng in (jeng, teng):
        for p in prompts:
            eng.put(p, max_new_tokens=3)
    teng._flush_table()
    picks = teng._schedule()
    batch = teng.builder.build(picks)
    assert batch.num_tokens == 16 and len(picks) == 3  # budget-cut prefill
    got = te.ragged_forward(teng.params, teng.caches, batch, teng.model_cfg,
                            teng.cfg, teng.rope)
    fwd = je.build_ragged_forward(jeng.model_cfg, jeng.cfg)
    want, _, _ = fwd(jeng.params, jeng.caches, *map(jnp.asarray, (
        batch.token_ids, batch.position_ids, batch.seq_index,
        batch.block_tables, batch.context_lens, batch.logits_rows,
        batch.chunk_start, batch.chunk_len)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    assert got.shape == (SPLIT_KW["max_seqs"], tcfg.vocab_size)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_fuzz_identical(model, seed):
    """Random arrivals, steps and cancellations, the same on both engines:
    every step emits the same tokens and the pools stay in step."""
    rng = np.random.default_rng(seed)
    jeng, teng = _engines(model, SPLIT_KW)
    live = []
    for _ in range(30):
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
        assert (teng.num_running, teng.num_waiting) == \
            (jeng.num_running, jeng.num_waiting)
    tr, jr = teng.generate_all(burst=4), jeng.generate_all(burst=4)
    assert tr == jr
    assert teng.free_blocks == teng.total_blocks


def test_sampling_deterministic_per_seed(model):
    _, _, tcfg, tparams = model
    prompts = [[1, 2, 3], list(range(10, 28))]

    def run(seed, pinned_greedy=False):
        eng = te.InferenceEngineV2(tcfg, tparams, te.V2Config(**SPLIT_KW),
                                   device="cpu")
        uids = [eng.put(prompts[0], max_new_tokens=8,
                        temperature=0.0 if pinned_greedy else None),
                eng.put(prompts[1], max_new_tokens=8)]
        res = eng.generate_all(temperature=1.0, seed=seed, burst=4)
        return [res[u][len(p):] for u, p in zip(uids, prompts)]

    a, b, c = run(7), run(7), run(8)
    assert a == b  # same seed, same tokens
    assert a != c  # another seed draws otherwise
    assert all(0 <= t < tcfg.vocab_size for row in a + c for t in row)
    # a greedy row next to sampled rows stays bit-identical to greedy alone
    mixed = run(7, pinned_greedy=True)
    alone = te.InferenceEngineV2(tcfg, tparams, te.V2Config(**SPLIT_KW),
                                 device="cpu")
    uid = alone.put(prompts[0], max_new_tokens=8)
    assert mixed[0] == alone.generate_all()[uid][3:]


def test_sample_rows_greedy_takes_first_max():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0]])
    got = te.sample_rows(logits, np.zeros(2, np.float32), 0,
                         np.zeros(2, np.int32))
    assert got.tolist() == [1, 0]
    assert got.dtype == torch.int32


def test_prefill_scatter_coords_match_reference():
    rng = np.random.default_rng(3)
    max_seqs, Qp = 4, 8
    seq_index = np.array([0, 0, 1, 2, 3, 3, -1, -1, -1], np.int32)
    chunk_start = np.array([0, 5, 2, 9], np.int32)
    position_ids = np.where(seq_index >= 0,
                            chunk_start[np.clip(seq_index, 0, 3)]
                            + np.array([0, 1, 0, 0, 0, 1, 0, 0, 0]), 0
                            ).astype(np.int32)
    want = je.prefill_scatter_coords(*map(jnp.asarray, (
        seq_index, position_ids, chunk_start)), max_seqs, Qp)
    got = te.prefill_scatter_coords(*map(torch.from_numpy, (
        seq_index, position_ids, chunk_start)), max_seqs, Qp)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # padding tokens carry positive out-of-range sentinels; scattering only
    # the real rows leaves the chunk layout finite and every real row set
    scat_row, scat_col = got[0], got[1]
    assert (scat_row[6:] == max_seqs).all() and (scat_col[6:] == Qp).all()
    q = torch.from_numpy(rng.standard_normal((9, 2)).astype(np.float32))
    q[6:] = float("nan")
    real = torch.nonzero(torch.from_numpy(seq_index) >= 0).flatten()
    q_seq = torch.zeros((max_seqs, Qp, 2))
    q_seq[scat_row[real], scat_col[real]] = q[real]
    assert torch.isfinite(q_seq).all()
    torch.testing.assert_close(q_seq[got[2], got[3]][:6], q[:6])


def test_default_device_is_the_card(monkeypatch, model):
    _, _, tcfg, tparams = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        te.InferenceEngineV2(tcfg, tparams, te.V2Config(**V2_KW))


@pytest.mark.parametrize("over,match", [
    ({"spec_mode": "banana"}, "spec_mode"),
    ({"spec_mode": "self_draft", "spec_k": 0}, "spec_k"),
    ({"spec_mode": "draft"}, "draft_params"),
    ({"adapter_slots": 1, "adapter_rank": 4}, "adapter_slots must be >= 2"),
    ({"adapter_slots": 4, "adapter_rank": 0}, "adapter_rank"),
    ({"adapter_slots": 4, "adapter_rank": 4, "spec_mode": "draft"},
     "self_draft"),
], ids=["spec_mode", "spec_k", "draft_model", "adapter_slots",
        "adapter_rank", "adapters_with_draft"])
def test_v2config_validation_matches_reference(model, over, match):
    """Every V2Config the reference takes runs in the port (``_LATER`` is
    empty); the ones it refuses, the port refuses with the same error."""
    jcfg, params, tcfg, tparams = model
    assert te._LATER == {}
    with pytest.raises(ValueError, match=match) as jerr:
        je.InferenceEngineV2(jcfg, params, je.V2Config(**{**V2_KW, **over}))
    with pytest.raises(ValueError, match=match) as terr:
        te.InferenceEngineV2(tcfg, tparams, te.V2Config(**{**V2_KW, **over}),
                             device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_v2config_fields_match_reference():
    import dataclasses

    jf = {f.name: f.default for f in dataclasses.fields(je.V2Config)}
    tf = {f.name: f.default for f in dataclasses.fields(te.V2Config)}
    assert jf == tf


def test_moe_and_alibi_refused(model):
    """MoE models are served (tests/test_torch_moe.py) except with
    expert-choice routing, which the reference refuses too (non-causal);
    ALiBi models wait for the v1 engine."""
    _, _, _, tparams = model
    for name, kw, err in (
            ("tiny-moe", {"moe_routing": "expert_choice"}, ValueError),
            ("tiny", {"position": "alibi"}, NotImplementedError)):
        with pytest.raises(err):
            te.InferenceEngineV2(tt.get_config(name, dtype="float32", **kw),
                                 tparams, te.V2Config(**V2_KW), device="cpu")


def test_admission_and_cancel(model):
    _, _, tcfg, tparams = model
    eng = te.InferenceEngineV2(tcfg, tparams, te.V2Config(**V2_KW),
                               device="cpu")
    with pytest.raises(te.AdmissionError, match="max context"):
        eng.put(list(range(60)), max_new_tokens=10)  # 70 > 8 * 8
    with pytest.raises(te.AdmissionError, match="adapter"):
        eng.put([1, 2], adapter_slot=1)
    uids = [eng.put([1, 2, 3], max_new_tokens=20, strict=True)
            for _ in range(4)]
    with pytest.raises(te.AdmissionError, match="slots"):
        eng.put([1], max_new_tokens=1, strict=True)
    eng.step()
    assert eng.cancel(uids[0]) and not eng.cancel(uids[0])
    res = eng.generate_all()
    assert uids[0] not in res and all(len(res[u]) == 23 for u in uids[1:])
    assert eng.free_blocks == eng.total_blocks == V2_KW["num_blocks"] - 1


def test_port_imports_no_jax():
    """The port, a CPU engine run (plain, W8A16, speculative in both modes,
    with an adapter registry, dropless MoE, and with the whole memory
    hierarchy on: prefix cache, host pool, cold store, promote-ahead,
    restart rehydration, tracing), int8_gemm, a CPU
    training step, a fused AdamW update, evoformer and block-sparse
    attention and the op registry never import JAX, the JAX package,
    ml_dtypes, pydantic or optax."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        import deepspeed_tpu_torch
        from deepspeed_tpu_torch.inference.v2.engine import (
            InferenceEngineV2, V2Config)
        from deepspeed_tpu_torch.models import transformer as tfm
        from deepspeed_tpu_torch.runtime.engine import ModelSpec
        from deepspeed_tpu_torch.sequence.tiled_compute import tiled_loss_fn
        from deepspeed_tpu_torch.inference.quantization import quantized_bytes
        from deepspeed_tpu_torch.ops.hopper import mixed_gemm as mg
        cfg = tfm.get_config("tiny", dtype="float32", num_kv_heads=2)
        params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
        for bits in (0, 8):
            eng = InferenceEngineV2(cfg, params, V2Config(
                max_tokens_per_step=16, max_seqs=4, block_size=8,
                num_blocks=64, max_blocks_per_seq=8, dtype="float32",
                quantize_bits=bits), device="cpu")
            uid = eng.put(list(range(1, 21)), max_new_tokens=5)
            out = eng.generate_all(burst=4)[uid]
            assert len(out) == 25, out
        assert quantized_bytes(eng.params)["quantized"] > 0
        import logging
        from deepspeed_tpu_torch.serving.adapters import AdapterRegistry
        # the registry logs each registration at INFO; warnings stay shown
        logging.getLogger("dstpu_torch").setLevel(logging.WARNING)
        for spec in (dict(spec_mode="draft"), dict(spec_mode="self_draft",
                                                   adapter_slots=2,
                                                   adapter_rank=2)):
            seng = InferenceEngineV2(cfg, params, V2Config(
                max_tokens_per_step=16, max_seqs=4, block_size=8,
                num_blocks=64, max_blocks_per_seq=8, dtype="float32",
                spec_k=2, **spec), draft_params=params, draft_config=cfg,
                device="cpu")
            slot = 0
            if seng.adapter_stack is not None:
                reg = AdapterRegistry(seng)
                reg.register("a", pack={"wq": (np.ones((2, 64, 2), "f4"),
                                               np.ones((2, 2, 64), "f4"))})
                slot = reg.acquire("a")
            uid = seng.put(list(range(1, 21)), max_new_tokens=5,
                           adapter_slot=slot)
            assert len(seng.generate_all()[uid]) == 25
            assert seng.spec_stats()["steps"] > 0
        import tempfile
        from deepspeed_tpu_torch.observability import recorder, tracer
        root = tempfile.mkdtemp()
        hier = dict(max_tokens_per_step=16, max_seqs=4, block_size=8,
                    num_blocks=64, max_blocks_per_seq=8, dtype="bfloat16",
                    enable_prefix_cache=True, kv_host_pool_bytes=1,
                    kv_promote_ahead=True, kv_coldstore_dir=root)
        prompt = list(range(1, 41))
        outs = []
        for restart in (False, True):
            heng = InferenceEngineV2(cfg, params, V2Config(**hier),
                                     device="cpu")
            if restart:
                assert heng.rehydrate_coldstore()["adopted"] > 0
            for p in (prompt, prompt[:20] + [7, 7, 7]):
                uid = heng.put(p, max_new_tokens=4)
                outs.append(heng.generate_all(burst=4)[uid])
            heng.prefix_cache.evict(100)
            heng.prefix_cache.check_consistency()
            stats = heng.prefix_stats()
            heng.close()
        assert stats["promotions"] > 0 and stats["rehydrated_blocks"] > 0
        assert outs[:2] == outs[2:], outs
        assert tracer.spans(name="engine/step") and recorder.snapshot()[
            "steps"]
        qw = mg.quantize_gemm_weight(torch.ones(256, 128))
        assert mg.int8_gemm(torch.ones(2, 256), qw).shape == (2, 128)
        tcfg = tfm.get_config("tiny", dtype="float32", num_kv_heads=2,
                              attn_impl="flash")
        spec = ModelSpec(loss_fn=lambda p, b, r: tiled_loss_fn(
            p, b, tcfg, tile_size=8), params=params)
        engine, _, _, _ = deepspeed_tpu_torch.initialize(model=spec, config={
            "train_micro_batch_size_per_gpu": 2,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}},
            device="cpu")
        ids = np.random.default_rng(0).integers(0, 256, (2, 16))
        loss = engine.train_batch({"input_ids": ids})["loss"]
        assert np.isfinite(loss), loss
        from deepspeed_tpu_torch.ops import fused_optimizers as fo
        mcfg = tfm.get_config("tiny-moe", dtype="float32",
                              moe_routing="dropless")
        meng = InferenceEngineV2(mcfg, tfm.init_params(
            mcfg, torch.Generator().manual_seed(0), device="cpu"),
            V2Config(max_tokens_per_step=16, max_seqs=4, block_size=8,
                     num_blocks=64, max_blocks_per_seq=8, dtype="float32"),
            device="cpu")
        uid = meng.put(list(range(1, 21)), max_new_tokens=5)
        assert len(meng.generate_all(burst=4)[uid]) == 25
        state = fo.init_fused_adam_state(params)
        fo.fused_adamw_tree(params, params, state, lr=1e-3)
        from deepspeed_tpu_torch.accelerator.cuda_accelerator import (
            CudaAccelerator)
        from deepspeed_tpu_torch.ops import op_registry
        from deepspeed_tpu_torch.ops import sparse_attention as sa
        ev = CudaAccelerator().create_op_builder("evoformer_attn").load()
        assert sorted(op_registry.available_ops()) == [
            "async_io", "evoformer_attn", "flash_attention", "fused_adam",
            "grouped_gemm", "paged_attention", "quantizer"]
        x = torch.randn(1, 2, 16, 2, 8, requires_grad=True)
        ev.DS4Sci_EvoformerAttention(x, x, x, [torch.zeros(1, 2, 1, 1, 16),
                                               torch.zeros(1, 1, 2, 16, 16)
                                               ]).sum().backward()
        y = torch.randn(1, 64, 2, 8, requires_grad=True)
        sa.sparse_attention(y, y, y, sa.FixedSparsityConfig(
            block=16, attention="unidirectional")).sum().backward()
        assert x.grad is not None and y.grad is not None
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith(("jax.", "deepspeed_tpu.",
                                              "pydantic", "optax",
                                              "ml_dtypes"))
               or m in ("deepspeed_tpu", "triton")]
        assert not bad, bad
        print("clean")
    """)
    # ~20 s on a loaded 8-core CPU box (imports, three engines, a
    # training step): six times that before the run is called hung
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"
