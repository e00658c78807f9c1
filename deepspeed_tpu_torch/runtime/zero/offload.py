"""ZeRO-Offload / ZeRO-Infinity optimizer offload — the port of
``deepspeed_tpu/runtime/zero/offload.py``.

The dataflow is the reference's:

    card: forward + backward -> f32 gradients (clipped on the host)
    host: f32 master + optimizer state; the update (the port's own
          optimizer, ``runtime/optimizers.py``, on host tensors; Adam and
          AdamW in one pass a leaf, ``ops/cpu_adam.py``, as the
          reference's XLA:CPU program fuses it)
    card: the updated parameters, in their own dtype, copied back

:class:`OffloadedOptimizer` holds the f32 master, the optimizer state and
an f32 gradient buffer per leaf in host memory (page-locked when the engine
runs on the card, :class:`~.param_offload.HostArena`).  ``stage_grads``
queues the gradients' device-to-host copies on the compute stream and
records an event, so a host that waits for them does not wait for work
queued after them; ``step`` waits on that event, clips, updates, and
writes the parameters back through two page-locked staging buffers (each
chunk cast to the parameter's dtype on the host, then copied to the card on
the compute stream, behind whatever the card was doing).  Parameters that
live on the host (``offload_param``) are written in place once the card
has finished reading them.

``offload_optimizer.device: nvme`` pages the optimizer state to
``opt_{i}.bin`` (the reference's files, in the reference's flatten order:
the counts too) through the AIO library, written behind after each update
and read ahead by :meth:`prefetch` while the card computes.
``offload_param.device: nvme`` pages the f32 master (``master_{i}.bin``,
:class:`~.param_offload.ParamSwapper`).
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import torch

from ...ops import cpu_adam
from ...utils.logging import logger
from ..optimizers import Optimizer
from .param_offload import HostArena, ParamSwapper, host_view

#: elements per host -> device staging chunk
STAGE_ELEMS = 32 << 20


def _default_swap_dir() -> str:
    """The reference's default swap directory, under this process's
    temporary directory."""
    return os.path.join(tempfile.gettempdir(), "dstpu_nvme_swap")


class OffloadedOptimizer:
    """Host-resident optimizer for ZeRO-Offload / Infinity.

    ``optimizer`` is the port's optimizer, not yet initialized; ``params``
    the engine's leaves (device or host tensors); ``paths`` their tree
    paths (the checkpoint's keys); ``clip`` the ``gradient_clipping``
    norm, applied to the whole gradient list as the reference's optax
    chain does."""

    def __init__(self, optimizer: Optimizer, params: List[torch.Tensor],
                 cfg: Any, aio: Any = None, param_cfg: Any = None,
                 paths: Optional[List[str]] = None, clip: float = 0.0,
                 device: Any = None, arena: Optional[HostArena] = None):
        self.optimizer = optimizer
        self.clip = float(clip or 0.0)
        self.device = torch.device(device) if device is not None \
            else params[0].device
        self.paths = paths or [str(i) for i in range(len(params))]
        self.arena = arena or HostArena(self.device)
        self._param_dtypes = [p.dtype for p in params]
        self._shapes = [tuple(p.shape) for p in params]
        self._param_nvme = param_cfg is not None and \
            getattr(param_cfg, "device_str", "none") == "nvme"
        self._mswap: Optional[ParamSwapper] = None
        if self._param_nvme:
            mdir = os.path.join(param_cfg.nvme_path or _default_swap_dir(),
                                "master")
            self._mswap = ParamSwapper(mdir, aio_cfg=aio, prefix="master")
        self._nvme = cfg.device_str == "nvme"

        # the f32 master (pageable when it pages to NVMe between steps)
        host = self.arena if not self._param_nvme else \
            HostArena("cpu")
        self.master: Optional[List[torch.Tensor]] = [
            host.copy_of(p, torch.float32) for p in params]
        self.grads = [self.arena.empty(s, torch.float32)
                      for s in self._shapes]
        self._grads_ready: Optional[torch.cuda.Event] = None
        self._norm: Optional[torch.Tensor] = None
        # the last step's phases: ``update_ms`` (host clock), ``d2h_ms`` and
        # ``h2d_ms`` (CUDA events around the copies, on the card)
        self.timings: Dict[str, float] = {}
        self._events: Dict[str, torch.cuda.Event] = {}
        optimizer.init(self.master)
        if not self._nvme:  # the state page-locked, leaf by leaf
            for lst in optimizer._leaf_state():
                for i, t in enumerate(lst):
                    if t is not None and t.numel() > 1:
                        lst[i] = self.arena.adopt(t)
        # per dtype: two staging buffers, and the event of each one's last
        # copy to the card
        self._stage: Dict[torch.dtype, List[torch.Tensor]] = {}
        self._stage_events: Dict[tuple, torch.cuda.Event] = {}

        self._mom_reads: list = []
        self._swapped_out = False
        if self._nvme:
            from ...nvme.aio_handle import AsyncIOHandle
            from ..config import AIOConfig

            aio = aio or AIOConfig()
            self._aio = AsyncIOHandle(block_size=aio.block_size,
                                      queue_depth=aio.queue_depth,
                                      thread_count=aio.thread_count)
            self._swap_dir = cfg.nvme_path or _default_swap_dir()
            os.makedirs(self._swap_dir, exist_ok=True)
            self._entries = self._state_entries()
            self.swap_out_async()
        if self._param_nvme:
            self._master_out()
        logger.info(
            "offloaded optimizer: %d leaves, %.3f GB host tensors, %.3f GB "
            "page-locked, moments on %s, master on %s", len(params),
            self.arena.tensor_bytes / 1e9, self.arena.pinned_bytes / 1e9,
            "nvme" if self._nvme else "host",
            "nvme" if self._param_nvme else "host")

    # -- nvme paging of the optimizer state -------------------------------

    def _state_entries(self) -> list:
        """``(list or None, index, key)`` of each state tensor in the
        reference's flatten order (``state_flat``'s): a count has no list."""
        entries = []
        for key, val in self.optimizer._state().items():
            if isinstance(val, list):
                entries += [(val, i, key) for i, t in enumerate(val)
                            if t is not None]
            else:
                entries.append((None, 0, key))
        return entries

    def swap_out_async(self) -> None:
        """Write the optimizer state to NVMe and drop the host copies
        (reference ``swap_out_async``)."""
        if not self._nvme or self._swapped_out:
            return
        self._specs = []
        for n, (lst, i, _) in enumerate(self._entries):
            if lst is None:
                t = torch.tensor(int(self.optimizer.count),
                                 dtype=torch.int32)
            else:
                t = lst[i].contiguous()
                lst[i] = None
            self._specs.append((tuple(t.shape), t.dtype))
            self._aio.pwrite(os.path.join(self._swap_dir, f"opt_{n}.bin"),
                             host_view(t))
        self._swapped_out = True

    def _moments_read_ahead(self) -> None:
        if not self._nvme or not self._swapped_out or self._mom_reads:
            return
        self._aio.wait_all()  # the writes land before the files are read
        for n, ((lst, i, _), (shape, dtype)) in enumerate(
                zip(self._entries, self._specs)):
            if lst is None:
                continue
            buf = torch.empty(shape, dtype=dtype)
            req = self._aio.pread(
                os.path.join(self._swap_dir, f"opt_{n}.bin"), host_view(buf))
            self._mom_reads.append((req, buf, lst, i))

    def prefetch(self) -> None:
        """Start reading the paged state and master back while the card
        computes (reference ``prefetch``); ``step`` waits on the reads."""
        self._moments_read_ahead()
        if self._param_nvme and self.master is None:
            self._mswap.read_ahead()

    def swap_in(self) -> None:
        if not self._nvme or not self._swapped_out:
            return
        self._moments_read_ahead()
        for req, buf, lst, i in self._mom_reads:
            self._aio.wait(req)
            lst[i] = buf
        self._mom_reads = []
        self._swapped_out = False

    def drain(self) -> None:
        """Block until every NVMe write and read has landed."""
        if self._nvme:
            self._aio.wait_all()
        if self._mswap is not None:
            self._mswap.drain()

    def _master_in(self) -> None:
        if self._param_nvme and self.master is None:
            self.master = self._mswap.wait_in()

    def _master_out(self) -> None:
        if self._param_nvme:
            self._mswap.write_behind(self.master)
            self.master = None

    # -- the step ---------------------------------------------------------

    @torch.no_grad()
    def stage_grads(self, grads: List[Optional[torch.Tensor]],
                    norm: Optional[torch.Tensor] = None) -> None:
        """Queue the copies of the f32 ``grads`` (None: already in the
        buffer, e.g. streamed) into the host buffers and record an event;
        ``norm`` is their global norm (computed here when None), read by
        the clip at :meth:`step`."""
        self._mark("d2h_start")
        for buf, g in zip(self.grads, grads):
            if g is not None:
                buf.copy_(g, non_blocking=True)
        self._mark("d2h_end")
        if norm is None and self.clip > 0:
            from ..optimizers import global_norm

            norm = global_norm([g if g is not None else b
                                for g, b in zip(grads, self.grads)])
        self._norm = norm
        if self.device.type == "cuda":
            self._grads_ready = torch.cuda.Event()
            self._grads_ready.record(torch.cuda.current_stream(self.device))

    @torch.no_grad()
    def step(self, grads: Optional[List[torch.Tensor]] = None,
             out: Optional[List[torch.Tensor]] = None) -> List[torch.Tensor]:
        """f32 gradients (``grads``, or those :meth:`stage_grads` queued) ->
        the updated parameters in their dtypes: written into ``out`` (the
        engine's tensors, on the card or the host) when given, else
        returned as new host tensors."""
        if grads is not None:
            self.stage_grads(grads)
        if self._grads_ready is not None:
            self._grads_ready.synchronize()
            self._grads_ready = None
        self._master_in()
        self.swap_in()
        if self.clip > 0:
            norm = float(self._norm) if self._norm is not None else None
            if norm is not None and not norm < self.clip:
                # optax.clip_by_global_norm: g / norm * max_norm
                n = torch.tensor(norm, dtype=torch.float32)
                for g in self.grads:
                    g.div_(n).mul_(self.clip)
        self._norm = None
        t0 = time.perf_counter()
        if cpu_adam.supported(self.optimizer, self.master):
            cpu_adam.adam_step(self.optimizer, self.master, self.grads)
        else:
            self.optimizer.step(self.master, self.grads)
        self.timings["update_ms"] = (time.perf_counter() - t0) * 1e3
        self._mark("h2d_start")
        result = self._push(out)
        self._mark("h2d_end")
        self.swap_out_async()
        self._master_out()
        return result

    def _mark(self, name: str) -> None:
        if self.device.type == "cuda":
            ev = self._events[name] = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))

    def read_timings(self) -> Dict[str, float]:
        """The last step's phases in ms (waits for the card)."""
        ev = self._events
        for name in ("d2h", "h2d"):
            if f"{name}_end" in ev:
                ev[f"{name}_end"].synchronize()
                self.timings[f"{name}_ms"] = ev[f"{name}_start"].elapsed_time(
                    ev[f"{name}_end"])
        return dict(self.timings)

    def _stage_buffers(self, dtype: torch.dtype) -> List[torch.Tensor]:
        if dtype not in self._stage:
            self._stage[dtype] = [self.arena.empty((STAGE_ELEMS,), dtype)
                                  for _ in range(2)]
        return self._stage[dtype]

    def _push(self, out: Optional[List[torch.Tensor]]) -> List[torch.Tensor]:
        if out is None:
            return [m.to(d) for m, d in zip(self.master, self._param_dtypes)]
        on_host = [i for i, o in enumerate(out) if o.device.type == "cpu"]
        on_card = [i for i, o in enumerate(out) if o.device.type != "cpu"]
        if on_card:
            stream = torch.cuda.current_stream(self.device)
            slot = 0
            for i in on_card:
                src, dst = self.master[i].view(-1), out[i].view(-1)
                stage = self._stage_buffers(dst.dtype)
                for a in range(0, src.numel(), STAGE_ELEMS):
                    n = min(STAGE_ELEMS, src.numel() - a)
                    key = (dst.dtype, slot)
                    if key in self._stage_events:
                        # its last copy has left the buffer
                        self._stage_events.pop(key).synchronize()
                    buf = stage[slot][:n]
                    buf.copy_(src[a:a + n])
                    dst[a:a + n].copy_(buf, non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record(stream)
                    self._stage_events[key] = ev
                    slot ^= 1
        if on_host:
            if self.device.type == "cuda":
                # the card may still be copying these parameters in
                torch.cuda.current_stream(self.device).synchronize()
            for i in on_host:
                out[i].copy_(self.master[i])
        return out

    # -- checkpoint surface ---------------------------------------------

    def state_for_checkpoint(self) -> Optimizer:
        """The optimizer, its state resident (read back from NVMe)."""
        self.swap_in()
        return self.optimizer

    def master_for_checkpoint(self) -> List[torch.Tensor]:
        self._master_in()
        return self.master

    @torch.no_grad()
    def load_state(self, flat: Any, paths: Optional[List[str]] = None
                   ) -> None:
        """Load a checkpoint's optimizer state (``{optax path: tensor}``)."""
        self.swap_in()
        self.optimizer.load_state_flat(flat, paths or self.paths)
        if self._nvme:
            self.swap_out_async()

    @torch.no_grad()
    def reset_master(self, params: List[torch.Tensor]) -> None:
        """Rebuild the f32 master from (checkpoint-loaded) parameters; a
        stale master would overwrite them at the next step."""
        self._master_in()
        for m, p in zip(self.master, params):
            m.copy_(p.detach())
        self._master_out()

    def close(self) -> None:
        self.drain()
        self.arena.release()
