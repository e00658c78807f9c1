"""Parity: the named remat policies (``models/transformer.py``) and
``runtime/activation_checkpointing/checkpointing.py`` against the JAX
package's.

- each of the reference's six policies: the loss and every gradient of a
  tiny two-layer flash-attention model equal to the reference's within
  1e-5 (the reference evaluated once per layer structure: a policy moves
  no value), and the flash forward's runs per step (``PLAIN_CALLS`` on the
  CPU; launches of B1 on the card) equal to the reference's Pallas
  forwards per step, counted in its gradient's jaxpr: 2 per layer under
  every policy but ``everything`` (the reference's Pallas forward is not a
  dot, and its backward needs o and lse, so the checkpointed layer runs it
  again), 1 under ``everything``; B2 and B3 once per layer;
- a serial and a parallel-residual layer under ``save_attn`` /
  ``save_attn_mlp``;
- ``checkpointing.checkpoint(fn, *args)`` under each config policy
  against ``jax.checkpoint`` with the reference's ``get_policy``, the
  ``cpu_checkpointing`` policy's name (it runs: ``test_torch_offload.py``)
  and the refusal of ``partition_activations`` (A13).
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu.runtime.activation_checkpointing import \
    checkpointing as jck
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.ops.hopper import flash_attention as fa
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.runtime.activation_checkpointing import \
    checkpointing as tck

from tests.torch_cpu import one_torch_thread  # noqa: F401

REMAT_TOL = 1e-5
LAYERS = 2


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _unflat(flat):
    out = {}
    for key, v in flat.items():
        node = out
        *path, last = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = v
    return out


@functools.lru_cache(maxsize=None)
def _reference(parallel_residual: bool):
    """The reference's loss and gradients of the test model under
    ``nothing_saveable`` (a policy moves no value, so one evaluation per
    layer structure serves every policy), and its inputs."""
    kw = dict(dtype="float32", num_kv_heads=2, attn_impl="flash",
              num_layers=LAYERS, parallel_residual=parallel_residual)
    jcfg = jt.get_config("tiny", **kw)
    params = jt.init_params(jax.random.PRNGKey(4), jcfg)
    ids = np.random.default_rng(4).integers(0, 256, (2, 32)).astype(np.int32)
    jl, jg = jax.value_and_grad(lambda p: jt.loss_fn(
        p, {"input_ids": jnp.asarray(ids)}, jcfg)[0])(params)
    return params, ids, float(jl), _flat(jax.tree_util.tree_map(
        np.asarray, jg))


@pytest.mark.parametrize("policy,extra", [
    ("everything", {}), ("nothing_saveable", {}), ("dots_saveable", {}),
    ("dots_with_no_batch_dims_saveable", {}), ("save_attn", {}),
    ("save_attn_mlp", {}), ("save_attn", {"parallel_residual": True}),
    ("save_attn_mlp", {"parallel_residual": True})],
    ids=["everything", "nothing", "dots", "dots_no_batch", "save_attn",
         "save_attn_mlp", "save_attn-parallel", "save_attn_mlp-parallel"])
def test_remat_policy_matches_reference(policy, extra):
    kw = dict(dtype="float32", num_kv_heads=2, attn_impl="flash",
              num_layers=LAYERS, remat_policy=policy, **extra)
    jcfg, tcfg = jt.get_config("tiny", **kw), tt.get_config("tiny", **kw)
    params, ids, jl, jg = _reference(bool(extra))
    tparams = tt.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                 tcfg, device="cpu", dtype=torch.float32)
    tb = {"input_ids": torch.from_numpy(ids)}
    # the reference's Pallas forwards per step under this policy: the layer
    # body is scanned, so its gradient's jaxpr holds each call once a layer
    pallas = str(jax.make_jaxpr(jax.grad(lambda p: jt.loss_fn(
        p, {"input_ids": jnp.asarray(ids)}, jcfg)[0]))(params)).count(
        "pallas_call")
    want_fwd = (pallas - 2) * LAYERS  # the backward's dK/dV and dQ: 2
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in _flat(tparams).items()}
    fa.reset_counts()
    tl = tt.loss_fn(_unflat(leaves), tb, tcfg)[0]
    tl.backward()
    assert fa.PLAIN_CALLS == {
        "flash_fwd_plain": want_fwd, "flash_bwd_dkdv_plain": LAYERS,
        "flash_bwd_dq_plain": LAYERS}
    assert want_fwd == (LAYERS if policy == "everything" else 2 * LAYERS)
    np.testing.assert_allclose(tl.item(), jl, atol=REMAT_TOL, rtol=0)
    for key, g in jg.items():
        np.testing.assert_allclose(leaves[key].grad.numpy(), g,
                                   atol=REMAT_TOL, rtol=REMAT_TOL,
                                   err_msg=key)


@pytest.mark.parametrize("policy", ["everything", "nothing", "dots",
                                    "dots_with_no_batch_dims"])
def test_checkpoint_function_matches_reference(policy):
    rng = np.random.default_rng(9)
    w1, w2 = (rng.standard_normal((16, 16)).astype(np.float32) * 0.3
              for _ in range(2))
    x = rng.standard_normal((3, 4, 16)).astype(np.float32)

    def jf(x):
        h = jnp.tanh(x @ w1)
        h = jck.checkpoint_name(h, "ckpt")
        return jnp.einsum("bsd,btd->bst", h @ w2, h)

    def tf(x):
        h = torch.tanh(x @ torch.from_numpy(w1))
        h = tck.checkpoint_name(h, "ckpt")
        return torch.einsum("bsd,btd->bst", h @ torch.from_numpy(w2), h)

    jcfg = jconfig.ActivationCheckpointingConfig(policy=policy)
    tcfg = tconfig.ActivationCheckpointingConfig(policy=policy)
    want, want_g = jax.value_and_grad(
        lambda x: (jck.checkpoint(jf, x, cfg=jcfg) ** 2).sum())(
            jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    got = (tck.checkpoint(tf, tx, cfg=tcfg) ** 2).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_g),
                               atol=REMAT_TOL, rtol=REMAT_TOL)
    assert tck.get_policy(tcfg) == tck.POLICIES[policy]


def test_checkpointing_refusals_and_configure():
    assert tck.get_policy(tconfig.ActivationCheckpointingConfig(
        cpu_checkpointing=True)) == tck.CPU_POLICY
    with pytest.raises(NotImplementedError, match="A13"):
        tck.get_policy(tconfig.ActivationCheckpointingConfig(
            partition_activations=True))
    with pytest.raises(ValueError, match="unknown activation-checkpoint"):
        tck.get_policy(tconfig.ActivationCheckpointingConfig(policy="most"))
    tck.configure(tconfig.ActivationCheckpointingConfig(), policy="dots")
    try:
        assert tck.get_policy() == "dots_saveable"
    finally:
        tck.configure(tconfig.ActivationCheckpointingConfig())
    # every config policy name of the reference is one of the port's
    assert set(re.findall(r'"(\w+)": pols\.',
                          open(jck.__file__).read())) == set(tck.POLICIES)
