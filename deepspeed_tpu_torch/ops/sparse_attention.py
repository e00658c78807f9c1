"""Block-sparse attention: sparsity layouts and the entry point — the port
of ``deepspeed_tpu/ops/sparse_attention.py``.

The layouts are plain ``(num_blocks, num_blocks)`` boolean numpy tables,
built by a copy of the JAX package's builders (the port imports nothing of
it), so the same config and seed give the same table.  The entry point runs
the port's :func:`~deepspeed_tpu_torch.ops.hopper.flash_attention.
flash_attention` with the table as its ``block_mask`` and ``block_q =
block_k = config.block``: on CUDA tensors the hand-written flash kernels
skip every (query tile, key tile) pair that the table drops, so compute and
device-memory traffic scale with the kept blocks.

Layout semantics match the reference builders:
* ``Fixed`` — local blocks + periodic global columns chosen from the tail
  of each local window (`sparsity_config.py: FixedSparsityConfig`);
* ``BigBird`` — random + sliding-window + global blocks
  (`BigBirdSparsityConfig`);
* ``BSLongformer`` — sliding window + explicit global block indices
  (`BSLongformerSparsityConfig`);
* ``Variable`` — custom local window list + global indices
  (`VariableSparsityConfig`);
* ``Dense`` — all blocks kept (sanity/baseline).

All builders honour ``attention="unidirectional"`` (causal) by lower-
triangularising the layout; the kernels additionally apply the exact
element-level causal mask inside diagonal blocks.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from .hopper.flash_attention import flash_attention


@dataclasses.dataclass
class SparsityConfig:
    """Base layout builder. ``block`` is the block-sparse granularity
    (the JAX package's default 128; the flash kernels pick their own tiles
    and mask inside them, so any block works)."""

    block: int = 128
    different_layout_per_head: bool = False  # layouts are shared across heads
    attention: str = "bidirectional"  # or "unidirectional" (causal)

    @property
    def causal(self) -> bool:
        return self.attention == "unidirectional"

    def num_blocks(self, seq_len: int) -> int:
        if seq_len % self.block != 0:
            raise ValueError(
                f"seq_len {seq_len} not divisible by block {self.block}")
        return seq_len // self.block

    def make_layout(self, seq_len: int) -> np.ndarray:
        """(num_blocks, num_blocks) bool keep-table."""
        raise NotImplementedError

    def _finalize(self, layout: np.ndarray) -> np.ndarray:
        if self.causal:
            layout = np.tril(layout)
        # a row with no kept blocks attends to nothing → NaN-free but useless;
        # always keep the diagonal so every query sees itself
        n = layout.shape[0]
        layout[np.arange(n), np.arange(n)] = True
        return layout

    @staticmethod
    def _apply_global_blocks(layout: np.ndarray, starts: Sequence[int],
                             ends: Optional[Sequence[int]]) -> None:
        """Mark global rows+columns: ``starts[i]`` .. ``ends[i]`` (exclusive;
        ``ends=None`` → single blocks) attend everywhere and are attended by
        everyone."""
        starts = list(starts)
        ends = list(ends) if ends is not None else [s + 1 for s in starts]
        for s, e in zip(starts, ends):
            layout[s:e, :] = True
            layout[:, s:e] = True

    def _add_random_blocks(self, layout: np.ndarray,
                           rng: np.random.RandomState, num: int) -> None:
        """Per row, keep ``num`` random blocks (row-causal when
        unidirectional). Seeded: deterministic across SPMD processes."""
        if not num:
            return
        n = layout.shape[0]
        for i in range(n):
            hi = i + 1 if self.causal else n
            cand = np.arange(hi)
            if len(cand):
                layout[i, rng.choice(cand, size=min(num, len(cand)),
                                     replace=False)] = True


@dataclasses.dataclass
class DenseSparsityConfig(SparsityConfig):
    """All blocks kept — the dense baseline expressed as a layout."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self.num_blocks(seq_len)
        return self._finalize(np.ones((n, n), bool))


@dataclasses.dataclass
class FixedSparsityConfig(SparsityConfig):
    """Local windows + periodic global columns (Sparse Transformer style;
    reference: ``FixedSparsityConfig``). Each query block attends to its
    local window of ``num_local_blocks`` and to ``num_global_blocks``
    columns taken from the tail of every preceding window."""

    num_local_blocks: int = 4
    num_global_blocks: int = 1

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self.num_blocks(seq_len)
        L, G = self.num_local_blocks, self.num_global_blocks
        layout = np.zeros((n, n), bool)
        for i in range(n):
            w = i // L
            start = w * L
            layout[i, start:min(start + L, n)] = True  # local window
            # global columns: last G blocks of each earlier window
            for pw in range(w):
                tail = (pw + 1) * L
                layout[i, max(tail - G, 0):tail] = True
        return self._finalize(layout)


@dataclasses.dataclass
class BigBirdSparsityConfig(SparsityConfig):
    """Random + sliding-window + global blocks (reference:
    ``BigBirdSparsityConfig``). Random blocks are drawn with a fixed seed so
    the layout is deterministic across processes (the reference draws per
    construction; determinism matters under SPMD)."""

    num_random_blocks: int = 1
    num_sliding_window_blocks: int = 3
    num_global_blocks: int = 1
    seed: int = 0

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self.num_blocks(seq_len)
        W, G, R = (self.num_sliding_window_blocks, self.num_global_blocks,
                   self.num_random_blocks)
        layout = np.zeros((n, n), bool)
        half = W // 2
        for i in range(n):
            layout[i, max(i - half, 0):min(i + half + 1, n)] = True  # window
        self._add_random_blocks(layout, np.random.RandomState(self.seed), R)
        self._apply_global_blocks(layout, range(G), None)
        return self._finalize(layout)


@dataclasses.dataclass
class BSLongformerSparsityConfig(SparsityConfig):
    """Sliding window + explicit global blocks (reference:
    ``BSLongformerSparsityConfig``)."""

    num_sliding_window_blocks: int = 3
    global_block_indices: Sequence[int] = (0,)
    global_block_end_indices: Optional[Sequence[int]] = None

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self.num_blocks(seq_len)
        layout = np.zeros((n, n), bool)
        half = self.num_sliding_window_blocks // 2
        for i in range(n):
            layout[i, max(i - half, 0):min(i + half + 1, n)] = True
        self._apply_global_blocks(layout, self.global_block_indices,
                                  self.global_block_end_indices)
        return self._finalize(layout)


@dataclasses.dataclass
class VariableSparsityConfig(SparsityConfig):
    """Custom local-window ladder + global indices (reference:
    ``VariableSparsityConfig``). ``local_window_blocks`` lists successive
    window sizes from the sequence start; the last entry repeats."""

    num_random_blocks: int = 0
    local_window_blocks: Sequence[int] = (4,)
    global_block_indices: Sequence[int] = (0,)
    global_block_end_indices: Optional[Sequence[int]] = None
    seed: int = 0

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self.num_blocks(seq_len)
        layout = np.zeros((n, n), bool)
        # walk the ladder of local windows
        i = 0
        widx = 0
        windows: List[int] = list(self.local_window_blocks)
        while i < n:
            w = windows[min(widx, len(windows) - 1)]
            layout[i:i + w, i:i + w] = True
            i += w
            widx += 1
        self._add_random_blocks(layout, np.random.RandomState(self.seed),
                                self.num_random_blocks)
        self._apply_global_blocks(layout, self.global_block_indices,
                                  self.global_block_end_indices)
        return self._finalize(layout)


def sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     config: SparsityConfig,
                     sm_scale: Optional[float] = None,
                     segment_ids=None) -> torch.Tensor:
    """Block-sparse attention with the layout from ``config``.

    q: (B, S, H, D); k/v: (B, S, KV, D). Equivalent to dense attention under
    the layout's block mask (exact causal masking inside diagonal blocks when
    ``config.attention == 'unidirectional'``); the flash kernels skip
    masked tiles. Differentiable.
    """
    S = q.shape[1]
    layout = config.make_layout(S)
    return flash_attention(q, k, v, causal=config.causal, sm_scale=sm_scale,
                           block_q=config.block, block_k=config.block,
                           segment_ids=segment_ids, block_mask=layout)
