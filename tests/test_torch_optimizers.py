"""Parity: the port's optimizers (``runtime/optimizers.py``,
``runtime/compressed_optimizer.py``) against the reference's
``create_optimizer`` (optax, and ``onebit_adam``) on the same seeded
parameters and gradients.

Each of LAMB, Lion, SGD (momentum, Nesterov), Adagrad, Adafactor, Muon and
1-bit Adam (``freeze_step`` 2, so the 5 steps cross it) runs 5 steps with
a WarmupLR schedule; parameters agree within 1e-6 (f32, every operation
rounded once on both sides, in another order or by another library), or
within 1e-5 of the parameter's own movement over the 5 steps (1-bit Adam
divides a compressed gradient by a second moment frozen after 2 steps,
and an element whose moment is tiny moves by ~100 lr, carrying f32's
relative error with it), and the state carries the reference's optax
paths with the same values.  The parameter tree has a leaf of each rank and two leaves whose two largest
dimensions reach 128 (Adafactor factors them), 2-D leaves for Muon and
weight-decay masks for the optimizers that take one.  The fp16 engine's
mode (the count on the device, ``finite`` false) leaves every parameter
and state tensor bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu.runtime.optimizers import create_optimizer as jcreate
from deepspeed_tpu.runtime.optimizers import \
    default_weight_decay_mask as jmask
from deepspeed_tpu.runtime.lr_schedules import schedules as jsched
from deepspeed_tpu.utils.tree_io import flatten_with_paths as jflat
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.runtime import optimizers as topt
from deepspeed_tpu_torch.runtime.lr_schedules import schedules as tsched

from tests.torch_cpu import one_torch_thread  # noqa: F401

OPT_TOL = 1e-6
MOVE_REL = 1e-5  # of the parameter's own movement


def _assert_close(got, want, start, what=""):
    got, want, start = (np.asarray(x, np.float32) for x in (got, want, start))
    limit = OPT_TOL + MOVE_REL * np.abs(want - start)
    over = np.abs(got - want) - limit
    assert over.max() <= 0, (what, float(np.abs(got - want).max()))


SHAPES = {"embed": {"tokens": (256, 160)}, "final_norm": {"scale": (64,)},
          "layers": {"attn": {"wq": (2, 160, 128)},
                     "ln1": {"scale": (2, 64)}},
          "lm_head": {"w": (48, 40)}}
CASES = {
    "lamb": {"lr": 1e-2, "weight_decay": 0.1},
    "lion": {"lr": 1e-3, "weight_decay": 0.1},
    "sgd": {"lr": 1e-1, "momentum": 0.9},
    "sgd_nesterov": {"lr": 1e-1, "momentum": 0.9, "nesterov": True},
    "adagrad": {"lr": 1e-1},
    "adafactor": {"lr": 1e-2},
    "muon": {"lr": 1e-2},
    "onebitadam": {"lr": 1e-2, "freeze_step": 2, "weight_decay": 0.01},
}


def _tree(fn, shapes=SHAPES, prefix=""):
    return {k: _tree(fn, v, f"{prefix}{k}/") if isinstance(v, dict)
            else fn(prefix + k, v) for k, v in shapes.items()}


def _run(name, params_cfg, steps=5):
    rng = np.random.default_rng(11)
    p0 = _tree(lambda k, s: rng.standard_normal(s).astype(np.float32))
    grads = [_tree(lambda k, s: rng.standard_normal(s).astype(np.float32))
             for _ in range(steps)]
    otype = "sgd" if name.startswith("sgd") else name
    sched_j = jsched.warmup_lr(warmup_num_steps=3,
                               warmup_max_lr=params_cfg["lr"])
    sched_t = tsched.warmup_lr(warmup_num_steps=3,
                               warmup_max_lr=params_cfg["lr"])
    wd = params_cfg.get("weight_decay")
    jopt = optax.chain(jcreate(jconfig.OptimizerConfig(
        type=otype, params=params_cfg), sched_j,
        jmask(p0) if wd else None))
    tleaves = topt.leaves(p0)
    tpaths = topt.leaf_paths(p0)
    tparams = [torch.from_numpy(a.copy()) for a in tleaves]
    mask = topt.leaves(topt.default_weight_decay_mask(p0)) if wd else None
    topt_ = topt.create_optimizer(tconfig.OptimizerConfig(
        type=otype, params=params_cfg), sched_t, mask)
    topt_.init(tparams)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    jstate = jopt.init(jp)
    for g in grads:
        jg = jax.tree_util.tree_map(jnp.asarray, g)
        upd, jstate = jopt.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        topt_.step(tparams, [torch.from_numpy(a.copy())
                             for a in topt.leaves(g)])
    return jp, jstate, tparams, tpaths, topt_, tleaves


@pytest.mark.parametrize("name", list(CASES))
def test_optimizer_matches_reference(name):
    jp, jstate, tparams, tpaths, opt, start = _run(name, CASES[name])
    want = jflat(jp)
    for path, t, p0 in zip(tpaths, tparams, start):
        _assert_close(t.numpy(), np.asarray(want[path]), p0, path)
    jst = {k: np.asarray(v) for k, v in jflat(jstate).items()}
    tst = {"0/" + k: v for k, v in opt.state_flat(tpaths).items()}
    assert tst.keys() == jst.keys()
    for k, v in jst.items():
        got = tst[k].numpy()
        assert got.dtype == v.dtype and got.shape == v.shape, k
        np.testing.assert_allclose(got, v, atol=OPT_TOL, rtol=1e-5,
                                   err_msg=k)
    # the state loads back from the reference's flat tree
    opt.load_state_flat({k[2:]: torch.from_numpy(v.copy())
                         for k, v in jst.items()}, tpaths)
    assert opt.count == 5


@pytest.mark.parametrize("name", ["adamw", "lamb", "adafactor", "muon",
                                  "onebitadam"])
def test_skipped_step_on_device_count_leaves_state_bit_for_bit(name):
    params_cfg = dict(CASES.get(name, {"lr": 1e-2, "weight_decay": 0.1}))
    _, _, tparams, tpaths, opt, start = _run(name, params_cfg, steps=3)
    opt.count_on_device("cpu")
    before = ([t.clone() for t in tparams],
              {k: v.clone() for k, v in opt.state_flat(tpaths).items()})
    grads = [torch.full_like(t, float("inf")) for t in tparams]
    opt.step(tparams, grads, finite=torch.tensor(False))
    for a, b in zip(tparams, before[0]):
        assert torch.equal(a, b)
    after = opt.state_flat(tpaths)
    for k, v in before[1].items():
        assert torch.equal(after[k], v), k
    # a finite step on the device count moves like a host-count step
    g = [torch.ones_like(t) for t in tparams]
    twin = _run(name, params_cfg, steps=3)
    opt.step(tparams, g, finite=torch.tensor(True))
    twin[4].step(twin[2], [x.clone() for x in g])
    assert int(opt.count) == twin[4].count == 4
    for a, b, p0 in zip(tparams, twin[2], start):
        _assert_close(a.numpy(), b.numpy(), p0)
