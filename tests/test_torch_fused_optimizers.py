"""Parity: the port's fused AdamW (``deepspeed_tpu_torch/ops/
fused_optimizers.py``) against the JAX package's, whose Pallas kernel runs
in interpret mode on the CPU, on numpy-seeded inputs.

* ``fused_adamw_flat``: two steps with weight decay, n not a multiple of
  the reference's ``block`` (which pads), f32 and bf16 parameters: p, m and
  v within 1e-6 of the reference, relative to each tensor's largest
  element (both sides round every f32 operation once; only ``b ** step``
  and the order XLA fuses in may differ in the last bit).
* ``fused_adamw_tree`` over a nested parameter tree and
  ``init_fused_adam_state``: the same, leaf by leaf, with the flat state in
  JAX's sorted-key order.
* Counters: the CPU path runs the plain version, one call per update.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import fused_optimizers as jfo
from deepspeed_tpu_torch.ops import fused_optimizers as tfo

from tests.torch_cpu import one_torch_thread  # noqa: F401

REL = 1e-6
HYPER = dict(lr=1e-2, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.1)


def _close(got, want, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= REL * scale, what


def _to_torch(a):
    a = np.array(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,block", [(1000, 256), (4099, 1024)])
def test_flat_two_steps_match_reference(n, block, dtype):
    rng = np.random.default_rng(n)
    p = rng.standard_normal(n).astype(np.float32).astype(
        ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32)
    m = np.zeros(n, np.float32)
    v = np.zeros(n, np.float32)
    jp, jm, jv = jnp.asarray(p), jnp.asarray(m), jnp.asarray(v)
    tp, tm, tv = _to_torch(p), _to_torch(m), _to_torch(v)
    tfo.reset_counts()
    for step in (1, 2):
        g = rng.standard_normal(n).astype(np.float32)
        jp, jm, jv = jfo.fused_adamw_flat(
            jp, jnp.asarray(g), jm, jv, jnp.asarray(step, jnp.int32),
            block=block, **HYPER)
        tp, tm, tv = tfo.fused_adamw_flat(
            tp, torch.from_numpy(g), tm, tv,
            torch.tensor(step, dtype=torch.int32), block=block, **HYPER)
        assert tp.dtype == (torch.bfloat16 if dtype == "bfloat16"
                            else torch.float32)
        _close(tp.float().numpy(), np.asarray(jp, np.float32), "p")
        _close(tm.numpy(), jm, "m")
        _close(tv.numpy(), jv, "v")
    assert tfo.PLAIN_CALLS == {"adamw_plain": 2}
    assert tfo.LAUNCHES == {"fused_adamw": 0}


def test_step_as_int_equals_step_as_tensor():
    rng = np.random.default_rng(3)
    p, g = (torch.from_numpy(rng.standard_normal(77).astype(np.float32))
            for _ in range(2))
    m, v = torch.zeros(77), torch.zeros(77)
    a = tfo.fused_adamw_flat(p, g, m, v, 3, **HYPER)
    b = tfo.fused_adamw_flat(p, g, m, v, torch.tensor(3, dtype=torch.int32),
                             **HYPER)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def _tree(rng):
    return {"layers": {"w": rng.standard_normal((3, 5, 7)).astype(np.float32),
                       "b": rng.standard_normal((3, 7)).astype(np.float32)},
            "embed": rng.standard_normal((11, 5)).astype(np.float32),
            "a_scale": rng.standard_normal(5).astype(np.float32)}


def _to_torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _to_torch_tree(v) for k, v in tree.items()}
    return _to_torch(tree)


def test_tree_matches_reference():
    rng = np.random.default_rng(8)
    params = _tree(rng)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tparams = _to_torch_tree(params)
    jstate = jfo.init_fused_adam_state(jparams)
    tstate = tfo.init_fused_adam_state(tparams)
    assert tstate.m.shape == jstate.m.shape and tstate.step.item() == 0
    tfo.reset_counts()
    for _ in range(2):
        grads = _tree(rng)
        jparams, jstate = jfo.fused_adamw_tree(
            jparams, jax.tree_util.tree_map(jnp.asarray, grads), jstate,
            **HYPER)
        tparams, tstate = tfo.fused_adamw_tree(
            tparams, _to_torch_tree(grads), tstate, **HYPER)
    assert tfo.PLAIN_CALLS == {"adamw_plain": 2}  # one update per call
    assert int(tstate.step) == int(jstate.step) == 2
    _close(tstate.m.numpy(), jstate.m, "m")
    _close(tstate.v.numpy(), jstate.v, "v")
    flat_t = {"layers/w": tparams["layers"]["w"], "layers/b":
              tparams["layers"]["b"], "embed": tparams["embed"],
              "a_scale": tparams["a_scale"]}
    flat_j = {"layers/w": jparams["layers"]["w"], "layers/b":
              jparams["layers"]["b"], "embed": jparams["embed"],
              "a_scale": jparams["a_scale"]}
    for key, t in flat_t.items():
        assert tuple(t.shape) == flat_j[key].shape
        _close(t.numpy(), flat_j[key], key)
    assert list(tparams) == list(params)  # the caller's key order


def test_refusals():
    with pytest.raises(ValueError, match="unsupported device"):
        tfo.fused_adamw_flat(torch.zeros(4, device="meta"),
                             torch.zeros(4, device="meta"),
                             torch.zeros(4, device="meta"),
                             torch.zeros(4, device="meta"),
                             torch.ones((), dtype=torch.int32,
                                        device="meta"), lr=1e-3)
