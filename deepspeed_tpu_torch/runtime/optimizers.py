"""Optimizer factory — the port of ``deepspeed_tpu/runtime/optimizers.py``.

The reference builds optax transformations; the port writes the same
formulas out in plain torch, updating parameters and state in place to
save memory.  Common to all of them:

- gradients arrive in f32; optimizer state is f32 wherever optax's
  steady state is (the reference feeds f32 grads, so its moments leave the
  first update in f32, ``engine.py:652-683``); Adafactor's factored
  statistics keep the parameter's dtype, as optax casts them;
- the update is scaled by -lr(count) (optax's ``scale_by_schedule``) and
  added to each parameter in f32, rounded into the parameter's dtype once
  (``optax.apply_updates``);
- each optimizer names its state with optax's tree paths
  (:meth:`Optimizer.state_flat`, e.g. ``0/mu/<param path>`` and
  ``2/count`` for AdamW), so a checkpoint of either package loads into the
  other.

The optimizers, each with optax's arithmetic:

- ``adam``/``adamw``: ``optax.adam``/``adamw`` (mu, nu; bias correction
  with count + 1; eps outside the square root; decoupled decay under the
  mask, or classic L2 added to the gradient with ``adam_w_mode=False``);
- ``lamb``: ``optax.lamb`` (Adam's direction, decoupled decay, then each
  leaf scaled by ||p|| / ||u||, 1 where either is 0);
- ``lion``: ``optax.lion`` (sign of the interpolated momentum, decay on
  every leaf);
- ``sgd``: ``optax.sgd`` with ``trace`` momentum (plain or Nesterov);
- ``adagrad``: ``optax.adagrad`` (sum of squares from 0.1, rsqrt(s + eps));
- ``adafactor``: ``optax.adafactor``'s defaults (second moments factored
  into row and column statistics for leaves whose two largest dimensions
  are at least 128, the 1 - (t + 1)^-0.8 decay schedule, updates clipped to
  block RMS 1, scaled by max(RMS(p), 1e-3));
- ``muon``: ``optax.contrib.muon`` (2-D leaves: Nesterov momentum, five
  Newton-Schulz iterations, scaled by sqrt(max(1, n / m)); every other
  leaf: Nesterov AdamW without decay);
- ``onebitadam`` (and ``zerooneadam``, ``onebitlamb``, as in the
  reference): ``runtime/compressed_optimizer.OneBitAdam``.

``torch.optim`` is not used: its moments live in the parameter dtype and
its arithmetic is not optax's.  The fused AdamW kernel
(``ops/fused_optimizers.py``) is an entry of its own, as in the
reference, whose ``fused`` switch no code reads.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch

from ..utils.tree_io import node_items, node_rebuild
from .config import OptimizerConfig
from .config_utils import ConfigError

Schedule = Union[float, Callable[[int], float]]


def leaves(tree: Any) -> List[Any]:
    """The leaves of a parameter tree, in key order (a node object's
    children in its field order: ``utils/tree_io.node_items``)."""
    items = node_items(tree)
    if items is None:
        return [tree]
    return [x for _, v in items for x in leaves(v)]


def leaf_paths(tree: Any, prefix: str = "") -> List[str]:
    """The slash-joined path of each of :func:`leaves`' leaves (a LoRA
    node's: ``.../wq/lora_a``, ``.../wq/base/codes``)."""
    items = node_items(tree)
    if items is None:
        return [prefix]
    return [p for key, v in items
            for p in leaf_paths(v, f"{prefix}/{key}" if prefix else key)]


def default_weight_decay_mask(params: Any) -> Any:
    """Decay matrices; skip norms, biases and scales (the reference's
    rule, on the same nested-dict layout and paths; a node object's mask
    is the node with booleans for children)."""

    def build(node, path):
        items = node_items(node)
        if items is not None:
            return node_rebuild(node, [build(v, f"{path}/{k}")
                                       for k, v in items])
        name = path.lower()
        if any(s in name for s in ("ln", "norm", "bias", "scale")):
            return False
        return getattr(node, "ndim", 0) >= 2

    return build(params, "")


def _zeros(params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [torch.zeros_like(p, dtype=torch.float32) for p in params]


def _count(n: int, device) -> torch.Tensor:
    return torch.tensor(n, dtype=torch.int32, device=device)


class Optimizer:
    """Base: the learning rate, the count, the step, and the state by optax
    path.

    ``step(params, grads, finite=None)`` takes f32 gradients aligned with
    ``params`` and updates the parameters and the state in place, leaf by
    leaf (``_update``).  The count is an int, or a 0-d int32 tensor on the
    device (:meth:`count_on_device`, the fp16 engine's mode): then every
    quantity it feeds (bias corrections, the learning rate) is computed on
    the device, and a 0-d bool ``finite`` keeps each leaf's old parameter
    and state where it is false (an overflowed step leaves them bit for bit,
    and the count does not move), all without a host sync.

    Subclasses define ``_update(i, p, g, count, lr)`` and ``_state()``,
    ``{optax path (with '{}' for a parameter path): value}`` where a value
    is a list of per-leaf tensors (None where a leaf has none) or the count
    (an int)."""

    def __init__(self, learning_rate: Schedule):
        self.learning_rate = learning_rate
        self.count: Union[int, torch.Tensor] = 0

    def lr(self, count) -> Union[float, torch.Tensor]:
        """The schedule at ``count``: a float, or a 0-d tensor for a count
        on the device."""
        lr = self.learning_rate
        lr = lr(count) if callable(lr) else lr
        return lr if isinstance(lr, torch.Tensor) else float(lr)

    def count_on_device(self, device) -> None:
        """Hold the count as a 0-d int32 tensor on ``device``."""
        self.count = _count(int(self.count), device)

    def init(self, params: List[torch.Tensor]) -> None:
        raise NotImplementedError

    def _update(self, i: int, p: torch.Tensor, g: torch.Tensor, count,
                lr) -> None:
        raise NotImplementedError

    def _state(self) -> Dict[str, Any]:
        raise NotImplementedError

    def _leaf_state(self) -> List[List[Optional[torch.Tensor]]]:
        return [v for v in self._state().values() if isinstance(v, list)]

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor],
             finite: Optional[torch.Tensor] = None) -> None:
        count = self.count
        lr = self.lr(count)
        lists = self._leaf_state() if finite is not None else []
        for i, (p, g) in enumerate(zip(params, grads)):
            if finite is None:
                self._update(i, p, g, count, lr)
                continue
            held = [p] + [lst[i] for lst in lists if lst[i] is not None]
            backup = [t.clone() for t in held]
            self._update(i, p, g, count, lr)
            for t, b in zip(held, backup):
                t.copy_(torch.where(finite, t, b))
            del backup
        self.count = count + 1 if finite is None else \
            torch.where(finite, count + 1, count)

    def state_flat(self, paths: List[str], device=None) -> Dict[str, Any]:
        """``{optax path: tensor}`` of the whole state (the counts as 0-d
        int32 tensors), the reference's checkpoint keys."""
        flat: Dict[str, Any] = {}
        for key, val in self._state().items():
            if not isinstance(val, list):
                flat[key] = _count(int(val), device or "cpu")
            else:
                for path, t in zip(paths, val):
                    if t is not None:
                        flat[key.format(path)] = t
        return flat

    @torch.no_grad()
    def load_state_flat(self, flat: Dict[str, Any],
                        paths: List[str]) -> None:
        """Copy a checkpoint's state (``{optax path: tensor}``) into this
        optimizer's, in place; raises ``KeyError`` on a missing path and
        ``ValueError`` on a shape mismatch."""
        counts = {}
        for key, val in self._state().items():
            if not isinstance(val, list):
                if key not in flat:
                    raise KeyError(f"checkpoint missing tensor {key!r}")
                counts[key] = int(flat[key])
                continue
            for path, t in zip(paths, val):
                if t is None:
                    continue
                name = key.format(path)
                if name not in flat:
                    raise KeyError(f"checkpoint missing tensor {name!r}")
                src = torch.as_tensor(flat[name])
                if tuple(src.shape) != tuple(t.shape):
                    raise ValueError(f"{name}: checkpoint shape "
                                     f"{tuple(src.shape)} != {tuple(t.shape)}")
                t.copy_(src.to(t.device, t.dtype))
        if len(set(counts.values())) > 1:
            raise ValueError(f"optimizer counts disagree: {counts}")
        if counts:
            n = next(iter(counts.values()))
            self.count = n if isinstance(self.count, int) else _count(
                n, self.count.device)


@torch.no_grad()
def _apply(p: torch.Tensor, upd: torch.Tensor, step_size: float) -> None:
    """p <- p + step_size * upd, added in f32 and rounded once (``upd`` is
    overwritten)."""
    upd.mul_(step_size).add_(p)
    p.copy_(upd)


def _decay(u: torch.Tensor, p: torch.Tensor, wd: float) -> torch.Tensor:
    """``optax.add_decayed_weights``: u + wd * p, the product in p's
    dtype."""
    return u.add_((p * wd).float())


class Adam(Optimizer):
    """Adam / AdamW (optax's ``scale_by_adam``), optionally Nesterov (the
    adam half of ``optax.contrib.muon``).  ``layout`` gives the optax paths
    of the adam state and of the schedule's count."""

    def __init__(self, learning_rate: Schedule, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, decoupled: bool = True,
                 mask: Optional[List[bool]] = None, nesterov: bool = False,
                 layout: Sequence[str] = ("0", "2")):
        super().__init__(learning_rate)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.decoupled = decoupled
        self.mask = mask
        self.nesterov = nesterov
        self.layout = tuple(layout)
        self.mu: List[torch.Tensor] = []
        self.nu: List[torch.Tensor] = []

    def init(self, params: List[torch.Tensor]) -> None:
        self.count = 0
        self.mu, self.nu = _zeros(params), _zeros(params)
        if self.mask is None:
            self.mask = [True] * len(params)

    def _state(self):
        adam, sched = self.layout
        return {f"{adam}/count": self.count, f"{adam}/mu/{{}}": self.mu,
                f"{adam}/nu/{{}}": self.nu, f"{sched}/count": self.count}

    def direction(self, g, mu, nu, count) -> torch.Tensor:
        """Update mu and nu in place; return Adam's direction (f32, new) at
        ``count``, the count after this update."""
        b1, b2 = self.b1, self.b2
        mu.mul_(b1).add_(g, alpha=1.0 - b1)
        nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        upd = (nu / (1.0 - b2 ** count)).sqrt_().add_(self.eps)
        if self.nesterov:
            m_hat = (mu / (1.0 - b1 ** (count + 1))).mul_(b1).add_(
                g / (1.0 - b1 ** count), alpha=1.0 - b1)
        else:
            m_hat = mu / (1.0 - b1 ** count)
        return torch.div(m_hat, upd, out=upd)

    def _update(self, i, p, g, count, lr) -> None:
        wd, decay = self.weight_decay, self.mask[i]
        if wd and decay and not self.decoupled:
            g = g + (p * wd).float()
        upd = self.direction(g, self.mu[i], self.nu[i], count + 1)
        if wd and decay and self.decoupled:
            _decay(upd, p, wd)
        _apply(p, upd, -lr)


class Lamb(Adam):
    """``optax.lamb``: Adam's direction plus decoupled decay, scaled per
    leaf by the trust ratio ||p|| / ||u|| (1 where either norm is 0)."""

    def __init__(self, learning_rate, **kw):
        super().__init__(learning_rate, decoupled=True, layout=("0", "3"),
                         **kw)

    def _update(self, i, p, g, count, lr) -> None:
        upd = self.direction(g, self.mu[i], self.nu[i], count + 1)
        if self.weight_decay and self.mask[i]:
            _decay(upd, p, self.weight_decay)
        pn = torch.linalg.vector_norm(p)
        un = torch.linalg.vector_norm(upd)
        ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn),
                            pn / un)
        upd.mul_(ratio.float())
        _apply(p, upd, -lr)


class Lion(Optimizer):
    """``optax.lion``: u = sign((1 - b1) g + b1 m) + wd p, then
    m <- (1 - b2) g + b2 m."""

    def __init__(self, learning_rate, b1: float = 0.9, b2: float = 0.99,
                 weight_decay: float = 0.0):
        super().__init__(learning_rate)
        self.b1, self.b2, self.weight_decay = b1, b2, weight_decay
        self.mu: List[torch.Tensor] = []

    def init(self, params) -> None:
        self.count = 0
        self.mu = _zeros(params)

    def _state(self):
        return {"0/count": self.count, "0/mu/{}": self.mu,
                "2/count": self.count}

    def _update(self, i, p, g, count, lr) -> None:
        b1, b2, mu = self.b1, self.b2, self.mu[i]
        upd = torch.sign(g * (1.0 - b1) + mu * b1)
        mu.mul_(b2).add_(g, alpha=1.0 - b2)
        _apply(p, _decay(upd, p, self.weight_decay), -lr)


class SGD(Optimizer):
    """``optax.sgd`` with ``trace`` momentum: t <- g + momentum t; the
    update is t, or g + momentum t with Nesterov."""

    def __init__(self, learning_rate, momentum: float = 0.0,
                 nesterov: bool = False):
        super().__init__(learning_rate)
        self.momentum, self.nesterov = momentum, nesterov
        self.trace: List[torch.Tensor] = []

    def init(self, params) -> None:
        self.count = 0
        self.trace = _zeros(params)

    def _state(self):
        return {"0/trace/{}": self.trace, "1/count": self.count}

    def _update(self, i, p, g, count, lr) -> None:
        m, t = self.momentum, self.trace[i]
        t.mul_(m).add_(g)
        upd = g + t * m if self.nesterov else t.clone()
        _apply(p, upd, -lr)


class Adagrad(Optimizer):
    """``optax.adagrad``: s <- g^2 + s (from 0.1), u = g rsqrt(s + eps)
    where s > 0."""

    def __init__(self, learning_rate, eps: float = 1e-10,
                 initial_accumulator_value: float = 0.1):
        super().__init__(learning_rate)
        self.eps, self.initial = eps, initial_accumulator_value
        self.sum_of_squares: List[torch.Tensor] = []

    def init(self, params) -> None:
        self.count = 0
        self.sum_of_squares = [torch.full_like(p, self.initial,
                                               dtype=torch.float32)
                               for p in params]

    def _state(self):
        return {"0/sum_of_squares/{}": self.sum_of_squares,
                "1/count": self.count}

    def _update(self, i, p, g, count, lr) -> None:
        s = self.sum_of_squares[i]
        s.addcmul_(g, g)
        inv = torch.where(s > 0, torch.rsqrt(s + self.eps),
                          torch.zeros_like(s))
        _apply(p, inv.mul_(g), -lr)


def _factored_dims(shape, min_dim: int):
    """optax's ``_factored_dims``: the two largest axes (second largest,
    largest), or None when a leaf is 1-D or its second largest axis is
    under ``min_dim``."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: (shape[i], i))
    if shape[order[-2]] < min_dim:
        return None
    return order[-2], order[-1]


class Adafactor(Optimizer):
    """``optax.adafactor(learning_rate)`` with its defaults: factored
    second moments (``min_dim_size_to_factor`` 128, decay 0.8, eps 1e-30),
    updates clipped to block RMS 1, times lr, times max(RMS(p), 1e-3),
    negated.  The statistics are held in the parameter's dtype, and a
    factored leaf's unused ``v`` (an unfactored one's ``v_row``/``v_col``)
    is the (1,) placeholder optax keeps."""

    def __init__(self, learning_rate, min_dim_size_to_factor: int = 128,
                 decay_rate: float = 0.8, eps: float = 1e-30,
                 clipping_threshold: float = 1.0, min_scale: float = 1e-3):
        super().__init__(learning_rate)
        self.min_dim, self.decay_rate, self.eps = (min_dim_size_to_factor,
                                                   decay_rate, eps)
        self.clip, self.min_scale = clipping_threshold, min_scale
        self.v_row: List[torch.Tensor] = []
        self.v_col: List[torch.Tensor] = []
        self.v: List[torch.Tensor] = []
        self.dims: List[Optional[tuple]] = []

    def init(self, params) -> None:
        self.count = 0
        self.v_row, self.v_col, self.v, self.dims = [], [], [], []
        for p in params:
            dims = _factored_dims(tuple(p.shape), self.min_dim)
            one = torch.zeros((1,), dtype=p.dtype, device=p.device)
            if dims is None:
                self.v_row.append(one)
                self.v_col.append(one.clone())
                self.v.append(torch.zeros_like(p))
            else:
                d1, d0 = dims
                shape = list(p.shape)
                self.v_row.append(torch.zeros(shape[:d0] + shape[d0 + 1:],
                                              dtype=p.dtype, device=p.device))
                self.v_col.append(torch.zeros(shape[:d1] + shape[d1 + 1:],
                                              dtype=p.dtype, device=p.device))
                self.v.append(one.clone())
            self.dims.append(dims)

    def _state(self):
        return {"0/count": self.count, "0/v_row/{}": self.v_row,
                "0/v_col/{}": self.v_col, "0/v/{}": self.v,
                "2/count": self.count}

    def _update(self, i, p, g, count, lr) -> None:
        # the decay schedule 1 - (t + 1)^-0.8 in f32, as optax computes it
        t = (count + 1).float() if isinstance(count, torch.Tensor) else \
            torch.tensor(float(count + 1), dtype=torch.float32)
        beta = (1.0 - t ** (-self.decay_rate)).to(p.device)
        gsq = g * g + self.eps
        dims = self.dims[i]
        if dims is not None:
            d1, d0 = dims
            vr = (self.v_row[i].float() * beta
                  + gsq.mean(d0) * (1.0 - beta)).to(p.dtype)
            vc = (self.v_col[i].float() * beta
                  + gsq.mean(d1) * (1.0 - beta)).to(p.dtype)
            self.v_row[i].copy_(vr)
            self.v_col[i].copy_(vc)
            rd1 = d1 - 1 if d1 > d0 else d1
            row_factor = (vr / vr.mean(rd1, keepdim=True)).pow(-0.5)
            col_factor = vc.pow(-0.5)
            upd = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
        else:
            v = (self.v[i].float() * beta + gsq * (1.0 - beta)).to(p.dtype)
            self.v[i].copy_(v)
            upd = g * v.pow(-0.5)
        upd = upd.float()
        rms = torch.sqrt((upd * upd).mean())
        upd = upd / torch.clamp(rms / self.clip, min=1.0)
        upd = upd * lr
        prms = torch.sqrt((p * p).mean())
        scale = torch.where(prms <= self.min_scale,
                            torch.full_like(prms, self.min_scale), prms)
        upd = upd * scale.float()
        _apply(p, upd, -1.0)


def _newton_schulz(x: torch.Tensor, steps: int = 5,
                   coeffs=(3.4445, -4.7750, 2.0315),
                   eps: float = 1e-8) -> torch.Tensor:
    """optax's ``orthogonalize_via_newton_schulz`` of a 2-D f32 matrix."""
    transposed = x.shape[0] > x.shape[1]
    if transposed:
        x = x.T
    x = x / (torch.linalg.vector_norm(x) + eps)
    a_, b_, c_ = (torch.tensor(c, dtype=x.dtype) for c in coeffs)
    for _ in range(steps):
        a = x @ x.T
        b = b_ * a + (c_ * a) @ a  # optax's ``c2 * a @ a``: (c2 a) a
        x = a_ * x + b @ x
    return x.T if transposed else x


class Muon(Optimizer):
    """``optax.contrib.muon(learning_rate)``: every 2-D leaf takes
    Nesterov momentum (beta 0.95, bias-corrected), five Newton-Schulz
    iterations and the factor sqrt(max(1, n / m)); every other leaf takes
    Nesterov AdamW (b1 0.9, b2 0.999, eps 1e-8, no decay).  The state is
    optax's ``partition``: ``inner_states/muon/...`` and
    ``inner_states/adam/...``, each holding only its own leaves."""

    def __init__(self, learning_rate, beta: float = 0.95, eps: float = 1e-8,
                 ns_steps: int = 5, ns_coeffs=(3.4445, -4.7750, 2.0315)):
        super().__init__(learning_rate)
        self.beta, self.eps, self.ns_steps = beta, eps, ns_steps
        self.ns_coeffs = ns_coeffs
        self.adam = Adam(learning_rate, eps=eps, nesterov=True)
        self.is_muon: List[bool] = []
        self.mu: List[Optional[torch.Tensor]] = []

    def init(self, params) -> None:
        self.count = 0
        self.is_muon = [p.dim() == 2 for p in params]
        self.mu = [torch.zeros_like(p, dtype=torch.float32) if m else None
                   for p, m in zip(params, self.is_muon)]
        self.adam.init(params)
        self.adam.mu = [None if m else t
                        for t, m in zip(self.adam.mu, self.is_muon)]
        self.adam.nu = [None if m else t
                        for t, m in zip(self.adam.nu, self.is_muon)]
        self.ns = torch.tensor(self.ns_coeffs, dtype=torch.float32,
                               device=params[0].device if params else "cpu")

    def _state(self):
        m, a = "inner_states/muon/inner_state", "inner_states/adam/inner_state"
        return {f"{a}/0/count": self.count, f"{a}/0/mu/{{}}": self.adam.mu,
                f"{a}/0/nu/{{}}": self.adam.nu, f"{a}/2/count": self.count,
                f"{m}/0/count": self.count, f"{m}/0/mu/{{}}": self.mu,
                f"{m}/2/count": self.count}

    def state_flat(self, paths, device=None):
        flat = super().state_flat(paths, device)
        flat["inner_states/muon/inner_state/0/ns_coeffs"] = self.ns
        return flat

    def _update(self, i, p, g, count, lr) -> None:
        count = count + 1
        if not self.is_muon[i]:
            upd = self.adam.direction(g, self.adam.mu[i], self.adam.nu[i],
                                      count)
            _apply(p, upd, -lr)
            return
        beta, mu = self.beta, self.mu[i]
        mu.mul_(beta).add_(g, alpha=1.0 - beta)
        m_hat = (mu / (1.0 - beta ** (count + 1))).mul_(beta).add_(
            g / (1.0 - beta ** count), alpha=1.0 - beta)
        upd = _newton_schulz(m_hat, self.ns_steps, self.ns_coeffs, self.eps)
        m, n = p.shape
        _apply(p, upd * math.sqrt(max(1.0, n / m)), -lr)


#: optimizer types of the reference that the port builds (lower case,
#: underscores dropped)
OPTIMIZERS = ("adam", "fusedadam", "cpuadam", "adamw", "fusedadamw", "lamb",
              "fusedlamb", "lion", "fusedlion", "sgd", "adagrad", "adafactor",
              "muon", "onebitadam", "zerooneadam", "onebitlamb")


def create_optimizer(cfg: OptimizerConfig, learning_rate: Schedule,
                     weight_decay_mask: Optional[List[bool]] = None
                     ) -> Optimizer:
    """The base optimizer from config (reference: ``create_optimizer``);
    its state paths are those of the reference's optax transformation."""
    name = cfg.type.lower().replace("_", "")
    p = cfg.params
    wd = p.get("weight_decay", 0.0)
    betas = p.get("betas", (0.9, 0.999))
    kw = dict(b1=betas[0], b2=betas[1], eps=p.get("eps", 1e-8))
    if name in ("adam", "fusedadam", "cpuadam"):
        if p.get("adam_w_mode", True) and wd:
            return Adam(learning_rate, weight_decay=wd, decoupled=True,
                        mask=weight_decay_mask, **kw)
        if wd:  # classic L2: chain(add_decayed_weights, adam)
            return Adam(learning_rate, weight_decay=wd, decoupled=False,
                        mask=weight_decay_mask, layout=("1/0", "1/1"), **kw)
        return Adam(learning_rate, layout=("0", "1"), **kw)
    if name in ("adamw", "fusedadamw"):
        return Adam(learning_rate, weight_decay=wd, decoupled=True,
                    mask=weight_decay_mask, **kw)
    if name in ("lamb", "fusedlamb"):
        return Lamb(learning_rate, weight_decay=wd, mask=weight_decay_mask,
                    **kw)
    if name in ("lion", "fusedlion"):
        betas = p.get("betas", (0.9, 0.99))
        return Lion(learning_rate, b1=betas[0], b2=betas[1], weight_decay=wd)
    if name == "sgd":
        return SGD(learning_rate, momentum=p.get("momentum", 0.0),
                   nesterov=p.get("nesterov", False))
    if name == "adagrad":
        return Adagrad(learning_rate, eps=p.get("eps", 1e-10))
    if name == "adafactor":
        return Adafactor(learning_rate)
    if name == "muon":
        return Muon(learning_rate)
    if name in ("onebitadam", "zerooneadam", "onebitlamb"):
        from .compressed_optimizer import OneBitAdam

        return OneBitAdam(learning_rate, weight_decay=wd,
                          freeze_step=p.get("freeze_step", 100),
                          mask=weight_decay_mask, **kw)
    raise ConfigError(f"unknown optimizer type {cfg.type!r}")


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, f32, on the device."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t.float()) for t in tensors]))


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], norm: torch.Tensor,
                        max_norm: float) -> None:
    """``optax.clip_by_global_norm`` in place: g / norm * max_norm where
    norm >= max_norm, g untouched otherwise (no host sync)."""
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
