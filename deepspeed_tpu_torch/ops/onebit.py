"""1-bit compressed all-reduce (the wire path of 1-bit Adam) — the port
of ``deepspeed_tpu/ops/onebit.py``.

Error-compensated sign compression of the gradient traffic itself, the
reference's two-phase scheme (its ``runtime/comm/nccl.py
compressed_allreduce`` role) over the ``comm`` facade's groups:

1. each worker adds its error-feedback residual, chunks the flattened
   gradient into W pieces, compresses each piece to sign bits (packed 8 a
   byte) + per-block f32 scales (mean |x|), and all-to-alls them — worker
   w receives everyone's chunk w;
2. worker w decompresses and sums its chunk, compresses the sum (with a
   second, "server" residual), and all-gathers the result.

Each rank holds its own residuals: ``worker`` (the padded vector) and
``server`` (its chunk).  Wire volume per device ≈ n/8 bytes sent + n/8
received (plus scales, 4/block bytes per element), against ~8n for an f32
ring all-reduce.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

_BIT_WEIGHTS = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.int32)


def pack_signs(x: torch.Tensor) -> torch.Tensor:
    """(..., 8k) float → (..., k) uint8; bit j of byte i = x[8i+j] >= 0."""
    bits = (x >= 0).to(torch.int32)
    bits = bits.reshape(*x.shape[:-1], x.shape[-1] // 8, 8)
    w = _BIT_WEIGHTS.to(x.device)
    return (bits * w).sum(-1).to(torch.uint8)


def unpack_signs(packed: torch.Tensor, out_len: int) -> torch.Tensor:
    """(..., k) uint8 → (..., 8k) float32 of ±1 (bit set → +1)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    signs = bits.to(torch.float32) * 2.0 - 1.0
    return signs.reshape(*packed.shape[:-1], out_len)


def _block_scales(x: torch.Tensor, block: int) -> torch.Tensor:
    """mean(|x|) per contiguous block of the last axis (len % block == 0)."""
    shaped = x.reshape(*x.shape[:-1], x.shape[-1] // block, block)
    return shaped.abs().mean(dim=-1)


def _apply_scales(signs: torch.Tensor, scales: torch.Tensor, block: int
                  ) -> torch.Tensor:
    shaped = signs.reshape(*signs.shape[:-1], signs.shape[-1] // block, block)
    return (shaped * scales[..., None]).reshape(signs.shape)


def chunk_len(n: int, world: int, block: int) -> int:
    """Per-worker chunk length: covers n, divisible by the scale block (and
    hence by 8 — block must be a multiple of 8)."""
    assert block % 8 == 0, "scale block must pack whole bytes"
    return -(-n // (world * block)) * block


def onebit_all_reduce(x: torch.Tensor, worker_residual: torch.Tensor,
                      server_residual: torch.Tensor,
                      axis_names: Sequence[str], world: int,
                      block: int = 2048, topo=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The mean of ``x`` over the ranks of ``axis_names`` with ~1-bit wire
    traffic.

    x: the local gradient (any shape).
    worker_residual: (n_pad,) f32 — this worker's error feedback.
    server_residual: (chunk,) f32 — feedback for the chunk this worker owns.
    Returns (mean estimate (x.shape, x.dtype), new worker residual, new
    server residual)."""
    from ..comm import all_gather, all_to_all

    n = x.numel()
    c = chunk_len(n, world, block)
    n_pad = c * world

    flat = torch.zeros((n_pad,), dtype=torch.float32, device=x.device)
    flat[:n] = x.reshape(-1).to(torch.float32) / world
    corrected = flat + worker_residual
    chunks = corrected.reshape(world, c)

    # phase 1: compress chunks, all_to_all so worker w holds chunk w from
    # every source
    scales = _block_scales(chunks, block)            # (W, c/block)
    packed = pack_signs(chunks)                      # (W, c/8) uint8
    local_decomp = _apply_scales(
        unpack_signs(packed, c), scales, block)      # what others will see
    new_worker_residual = corrected - local_decomp.reshape(-1)

    recv_codes = all_to_all(packed, axis_names, 0, 0, topo=topo)
    recv_scales = all_to_all(scales, axis_names, 0, 0, topo=topo)
    # (W, c/8) / (W, c/block): row s = source s's version of MY chunk
    contrib = _apply_scales(unpack_signs(recv_codes, c), recv_scales, block)
    mine = contrib.sum(dim=0)                        # (c,) — sum of /W terms

    # phase 2: compress the reduced chunk, all_gather
    corrected2 = mine + server_residual
    scales2 = _block_scales(corrected2[None], block)[0]   # (c/block,)
    packed2 = pack_signs(corrected2[None])[0]             # (c/8,)
    decomp2 = _apply_scales(unpack_signs(packed2[None], c),
                            scales2[None], block)[0]
    new_server_residual = corrected2 - decomp2

    all_codes = all_gather(packed2, axis_names, tiled=False, topo=topo)
    all_scales = all_gather(scales2, axis_names, tiled=False, topo=topo)
    full = _apply_scales(unpack_signs(all_codes, c), all_scales, block)
    out = full.reshape(-1)[:n].reshape(x.shape).to(x.dtype)
    return out, new_worker_residual, new_server_residual


def residual_shapes(n: int, world: int, block: int = 2048
                    ) -> Tuple[int, int]:
    """(worker_residual_len, server_residual_len) for a leaf of n elements."""
    c = chunk_len(n, world, block)
    return c * world, c


def payload_bytes(n: int, world: int, block: int = 2048) -> int:
    """Bytes this scheme moves per device (send, phase 1 + 2) for n values."""
    c = chunk_len(n, world, block)
    n_pad = c * world
    signs = n_pad // 8 + c // 8
    scales = 4 * (n_pad // block + c // block)
    return signs + scales
