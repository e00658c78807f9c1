"""Fused AdamW over one flat vector — the port of
``deepspeed_tpu/ops/fused_optimizers.py``.

:func:`fused_adamw_flat` runs ``_adam_kernel``'s update in one pass over
flat (N,) tensors: read p, g, m and v, write p, m and v.  In f32, in the
reference's order::

    m' = b1 m + (1 - b1) g
    v' = b2 v + (1 - b2) g g
    bc1 = 1 - b1^step,  bc2 = 1 - b2^step      (f32)
    p' = p - lr (m'/bc1 / (sqrt(v'/bc2) + eps) + wd p)

CUDA tensors launch the hand-written kernel of ``csrc/fused_adam.cu``
(:data:`LAUNCHES`), which reads ``step`` from device memory, so a call
never waits for the device; CPU tensors run :func:`adamw_plain`
(:data:`PLAIN_CALLS`), also the kernel's oracle on the card.  Any N works:
the reference pads to its TPU ``block``, which changes no result, so
``block`` is accepted and unused.

:func:`fused_adamw_tree` flattens a parameter tree into one such update
(the multi-tensor-apply role), one launch per call.  As in the reference,
no engine uses it: ``runtime/optimizers.py`` reads no ``fused`` switch.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple, Union

import torch

from .hopper import build

#: launches of the kernel, counted where the wrapper launches it
LAUNCHES = {"fused_adamw": 0}
#: calls of the plain version (the CPU path and the kernel's oracle)
PLAIN_CALLS = {"adamw_plain": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS):
        for key in counts:
            counts[key] = 0


def _step_tensor(step: Union[int, torch.Tensor], device: torch.device
                 ) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.reshape(1).to(device=device, dtype=torch.int32)
    return torch.tensor([step], dtype=torch.int32, device=device)


def adamw_plain(params: torch.Tensor, grads: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, step: torch.Tensor, lr: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.0
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch AdamW with the kernel's arithmetic (module doc): every
    operation in f32, the new parameters in their own dtype."""
    PLAIN_CALLS["adamw_plain"] += 1
    p = params.float()
    g = grads.float()
    m_new = b1 * m + (1.0 - b1) * g
    v_new = b2 * v + (1.0 - b2) * g * g
    s = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=s.device), s)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=s.device), s)
    update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps) \
        + weight_decay * p
    return (p - lr * update).to(params.dtype), m_new, v_new


def _check(params, grads, m, v, step) -> None:
    if params.dtype not in _DTYPE_CODES or grads.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_adamw kernel takes float32, bfloat16 or "
                        f"float16 params and grads, got {params.dtype}, "
                        f"{grads.dtype}")
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"fused_adamw: m and v must be float32, got "
                        f"{m.dtype}, {v.dtype}")
    n = params.numel()
    for name, t in (("grads", grads), ("m", m), ("v", v), ("step", step)):
        if t.device != params.device:
            raise ValueError(f"{name} is on {t.device}, params on "
                             f"{params.device}")
        if name != "step" and t.numel() != n:
            raise ValueError(f"{name} has {t.numel()} elements, params {n}")
    for name, t in (("params", params), ("grads", grads), ("m", m),
                    ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"fused_adamw: {name} must be contiguous")


def fused_adamw_flat(params: torch.Tensor, grads: torch.Tensor,
                     m: torch.Tensor, v: torch.Tensor,
                     step: Union[int, torch.Tensor], lr: float,
                     b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                     weight_decay: float = 0.0, block: int = 1 << 16
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """AdamW update over a flat (N,) parameter vector; m and v are f32,
    ``step`` (the count including this update) an int or an int32 tensor.
    Returns (new_params, new_m, new_v)."""
    del block
    st = _step_tensor(step, params.device)
    if params.device.type == "cpu":
        return adamw_plain(params.reshape(-1), grads.reshape(-1),
                           m.reshape(-1), v.reshape(-1), st, lr, b1, b2,
                           eps, weight_decay)
    if params.device.type != "cuda":
        raise ValueError(f"fused_adamw_flat: unsupported device "
                         f"{params.device}")
    _check(params, grads, m, v, st)
    n = params.numel()
    p_out = torch.empty(n, dtype=params.dtype, device=params.device)
    m_out = torch.empty(n, dtype=torch.float32, device=params.device)
    v_out = torch.empty(n, dtype=torch.float32, device=params.device)
    if n == 0:
        return p_out, m_out, v_out
    lib = build.load()
    err = lib.ds_fused_adamw(
        _DTYPE_CODES[params.dtype], _DTYPE_CODES[grads.dtype],
        params.data_ptr(), grads.data_ptr(), m.data_ptr(), v.data_ptr(),
        st.data_ptr(), p_out.data_ptr(), m_out.data_ptr(), v_out.data_ptr(),
        n, lr, b1, b2, 1.0 - b1, 1.0 - b2, eps, weight_decay,
        torch._C._cuda_getCurrentRawStream(
            params.device.index if params.device.index is not None
            else torch.cuda.current_device()))
    build.check(lib, err, "fused_adamw launch")
    LAUNCHES["fused_adamw"] += 1
    return p_out, m_out, v_out


class FusedAdamState(NamedTuple):
    step: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor


def _leaves(tree: Any) -> List[torch.Tensor]:
    """Leaves in ``jax.tree_util`` order: dict keys sorted."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _leaves(tree[key])]
    return [tree]


def _unflatten(tree: Any, it) -> Any:
    if isinstance(tree, dict):
        out: Dict[Any, Any] = {}
        for key in sorted(tree):
            out[key] = _unflatten(tree[key], it)
        return {key: out[key] for key in tree}  # the caller's key order
    return next(it)


def fused_adamw_tree(params, grads, state: FusedAdamState, lr: float,
                     b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                     weight_decay: float = 0.0):
    """Every leaf of a (nested-dict) parameter tree in one fused update:
    leaves flattened into one f32 vector (sorted-key order, as JAX
    flattens), one :func:`fused_adamw_flat` call, the results cut back into
    each leaf's shape and dtype.  Returns (new_params, new_state)."""
    leaves = _leaves(params)
    gleaves = _leaves(grads)
    flat_p = torch.cat([x.reshape(-1).float() for x in leaves])
    flat_g = torch.cat([g.reshape(-1).float() for g in gleaves])
    step = state.step + 1
    p_new, m_new, v_new = fused_adamw_flat(
        flat_p, flat_g, state.m, state.v, step, lr, b1, b2, eps,
        weight_decay)
    outs, off = [], 0
    for x in leaves:
        outs.append(p_new[off:off + x.numel()].reshape(x.shape).to(x.dtype))
        off += x.numel()
    return _unflatten(params, iter(outs)), FusedAdamState(step, m_new, v_new)


def init_fused_adam_state(params) -> FusedAdamState:
    leaves = _leaves(params)
    n = sum(x.numel() for x in leaves)
    dev = leaves[0].device
    return FusedAdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          m=torch.zeros(n, dtype=torch.float32, device=dev),
                          v=torch.zeros(n, dtype=torch.float32, device=dev))
