"""ZenFlow: importance-aware selective updates for stall-free offloading —
the port of ``deepspeed_tpu/runtime/zenflow.py``.

The top-k gradient *columns* (last axis) of each matrix are applied on the
card every step, with a compact f32 master and the user's optimizer state
over just those columns; the other columns accumulate on the card and go
through the offloaded host optimizer once every ``update_interval`` steps
(one device-to-host copy of their mean).  As in the reference:

* **hot path** (every step, on the card): the compact gradient (the hot
  columns of every matrix, every other leaf whole) is clipped by its own
  global norm (``gradient_clipping``), updated by a second instance of the
  engine's optimizer (its count restarts at each re-selection, and the
  learning-rate schedule with it) and scattered back into the parameters;
* **cold path**: the other columns accumulate in f32 on the card; no
  device-to-host copy happens on a hot step;
* **flush**: the hot columns are written into the host master first (the
  card's are authoritative), the cold mean is clipped by its own norm and
  copied to the host once (``cold_bytes_transferred``), the host optimizer
  steps, the parameters come back and the hot columns are applied again on
  top, so the two streams never apply twice;
* **re-selection** every ``select_interval`` steps, only on a flush
  boundary: the columns are picked again from the current gradients and
  the compact state starts fresh.

The selection uses ``torch.topk``, whose order among equal energies is not
``jax.lax.top_k``'s (lower index first); gradients without ties select the
same columns.  The variable-batch ``lr_scale`` is refused with the data
pipeline (ROADMAP.md A14), so the port's hot and cold steps take none.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch

from .config import ZenFlowConfig
from .optimizers import Optimizer, clip_by_global_norm, global_norm


def _is_matrix(t: torch.Tensor) -> bool:
    return t.ndim >= 2


def _k_for(t: torch.Tensor, ratio: float) -> int:
    return max(1, int(t.shape[-1] * ratio))


class ZenFlowOptimizer:
    """Selective device update plus an interval-flushed offloaded cold
    update.  ``step(params, grads)`` updates ``params`` (the engine's
    device tensors) in place from the f32 ``grads``.  ``optimizer`` is a
    second instance of the engine's optimizer (``create_optimizer`` with
    the same settings) for the compact columns;
    ``host_opt`` the :class:`~.zero.offload.OffloadedOptimizer` that owns
    the full master and state."""

    def __init__(self, optimizer: Optimizer, cfg: ZenFlowConfig, host_opt,
                 clip: float = 0.0):
        self.optimizer = optimizer
        self.cfg = cfg
        self.clip = float(clip or 0.0)
        self.update_interval = (4 if cfg.update_interval in (None, "auto")
                                else int(cfg.update_interval))
        sel = cfg.select_interval
        self.select_interval = (4 * self.update_interval
                                if sel in (None, "auto") else int(sel))
        self.host_opt = host_opt
        self._step = 0
        self._indices: Optional[List[torch.Tensor]] = None
        self._hot_master: Optional[List[torch.Tensor]] = None
        self._cold_acc: Optional[List[torch.Tensor]] = None
        self.cold_bytes_transferred = 0
        self._steps_since_flush = 0

    # -- selection --------------------------------------------------------

    def _select(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        out = []
        for g in grads:
            if not _is_matrix(g):  # marker: the whole leaf is hot
                out.append(torch.zeros((0,), dtype=torch.long,
                                       device=g.device))
                continue
            energy = g.float().square().sum(tuple(range(g.ndim - 1)))
            out.append(torch.topk(energy, _k_for(g, self.cfg.topk_ratio))
                       .indices)
        return out

    @staticmethod
    def _gather(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
        if not _is_matrix(x):
            return x.float()
        return x.index_select(-1, i).float()

    def _reselect(self, params: List[torch.Tensor],
                  grads: List[torch.Tensor]) -> None:
        """Pick the hot columns from the current gradients; rebuild the
        compact master and a fresh compact state.  A departing column's
        value lives in the host master (synced at the previous flush)."""
        self._indices = self._select(grads)
        self._hot_master = [self._gather(p.detach(), i)
                            for p, i in zip(params, self._indices)]
        self.optimizer.init(self._hot_master)
        if self._cold_acc is None:
            self._cold_acc = [torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device) for g in grads]

    @staticmethod
    @torch.no_grad()
    def _put_back(params, indices, hot) -> None:
        for p, i, h in zip(params, indices, hot):
            if not _is_matrix(p):
                p.copy_(h)
            else:
                p.index_copy_(p.ndim - 1, i, h.to(p.dtype))

    # -- reconciliation ---------------------------------------------------

    @torch.no_grad()
    def _sync_hot_into_host_master(self) -> None:
        """Write the card's authoritative hot columns into the host
        master."""
        master = self.host_opt.master_for_checkpoint()
        for m, i, h in zip(master, self._indices, self._hot_master):
            h = h.detach().cpu()
            if i.numel() == 0:  # an always-hot leaf: the card's value wins
                m.copy_(h)
            else:
                m.index_copy_(m.ndim - 1, i.cpu(), h)
        if getattr(self.host_opt, "_param_nvme", False):
            self.host_opt._master_out()

    # -- the step ---------------------------------------------------------

    @torch.no_grad()
    def step(self, params: List[torch.Tensor],
             grads: List[torch.Tensor]) -> None:
        self._step += 1
        # (step - 1) % sel == 0 fires on every legal interval, sel = 1 too
        reselect_due = self._indices is None or (
            self.select_interval > 0 and self._step > 1
            and (self._step - 1) % self.select_interval == 0)
        if reselect_due:
            # only on a flush boundary: pending cold sums in columns about
            # to turn hot, and unsynced hot columns leaving, would be lost
            if self._steps_since_flush > 0:
                self._flush(params)
            self._reselect(params, grads)
        gc = [self._gather(g, i) for g, i in zip(grads, self._indices)]
        if self.clip > 0:
            clip_by_global_norm(gc, global_norm(gc), self.clip)
        self.optimizer.step(self._hot_master, gc)
        self._put_back(params, self._indices, self._hot_master)
        for a, g, i in zip(self._cold_acc, grads, self._indices):
            if _is_matrix(g):
                a.add_(g.float())
                a.index_fill_(a.ndim - 1, i, 0.0)
        self._steps_since_flush += 1
        if self._step % self.update_interval == 0:
            self._flush(params)

    def flush(self, params: List[torch.Tensor]) -> None:
        """Apply a partly accumulated cold sum now (before a save: saving
        mid-interval must not drop it)."""
        if self._steps_since_flush:
            self._flush(params)

    @torch.no_grad()
    def _flush(self, params: List[torch.Tensor]) -> None:
        """The amortized cold update: one device-to-host copy of the cold
        mean through the host optimizer, then the hot columns again."""
        scale = 1.0 / max(1, self._steps_since_flush)
        self._steps_since_flush = 0
        cold_mean = [a * scale for a in self._cold_acc]
        self._sync_hot_into_host_master()
        self.cold_bytes_transferred += sum(c.numel() * c.element_size()
                                           for c in cold_mean)
        self.host_opt.step(cold_mean, out=params)
        del cold_mean
        self._put_back(params, self._indices, self._hot_master)
        for a in self._cold_acc:
            a.zero_()

    # -- checkpoint surface -----------------------------------------------

    def state_for_checkpoint(self):
        return self.host_opt.state_for_checkpoint()

    def load_state(self, flat: Any, paths=None) -> None:
        self.host_opt.load_state(flat, paths)

    def reset_master(self, params: List[torch.Tensor]) -> None:
        self.host_opt.reset_master(params)
        # every device-side selective value is stale against the new master
        self.reset_after_load()

    def reset_after_load(self) -> None:
        """Drop the card's selective state after a checkpoint load: stale
        hot columns or cold sums must not land on the restored weights
        (the caller resets the host master)."""
        self._indices = None
        self._hot_master = None
        if self._cold_acc is not None:
            for a in self._cold_acc:
                a.zero_()
        self._steps_since_flush = 0

