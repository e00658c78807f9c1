"""Mixed-precision GEMM: quantized weights times high-precision activations
— the port of ``deepspeed_tpu/ops/pallas/mixed_gemm.py``.

* :class:`QuantizedWeight` holds the reference's layouts: codes int8
  ``(..., K, N)`` (bits 8), int8 ``(..., ceil(K/2), N)`` with two K-rows per
  byte, the even row in the low nibble (bits 4), or uint8
  ``(..., 3 ceil(K/4), N)`` with four FP6 e3m2 K-rows per three bytes (bits
  6); f32 scales ``(..., K/group, N)``.
* :func:`mixed_gemm` ``(x (..., K), qw) -> (..., N)`` in x's dtype computes
  what ``_mixed_gemm_kernel`` computes: per K-group, codes → f32 × the
  group's scale row → bf16; x → bf16; f32 accumulation.
* :func:`int8_gemm` is W8A8: activations quantized per (row, K-group)
  outside the kernel (:func:`quantize_activations_rowwise`), an exact int32
  product per group, rescaled into an f32 accumulator by x-scale ⊗ w-scale.
* :func:`mixed_gemm_frozen` is differentiable in x only (a frozen base).

**The reference's shape envelope.**  The reference takes its Pallas kernel
only for shapes it can tile (``mixed_gemm.py:379-383`` and ``:326-330``);
elsewhere it computes ``x @ dequant(W)`` in x's dtype, without the bf16
rounding and, for ``int8_gemm``, without quantizing x.  The port decides the
same test from the shapes before any launch and computes the same formula
there, counted in :data:`DEQUANT_CALLS`: that is the reference's function
for those shapes, not a fallback.  Inside the envelope, CUDA tensors launch
the hand-written kernels of ``csrc/mixed_gemm.cu`` on the current stream
(:data:`LAUNCHES`) or raise on what they do not take:
``mixed_gemm_decode_kernel`` for M <= 16 rows (:data:`DECODE_LAUNCHES`;
:func:`decode_blocks` blocks, each an equal share of the tiles' K-steps,
whose shared tiles are added up in the same launch through the stream's
tickets, :func:`_tickets`), ``mixed_gemm_wgmma_kernel`` for bf16 or f16 x
at M > 16 (:data:`WGMMA_LAUNCHES`), ``mixed_gemm_mma_kernel`` for f32 x at
M > 16; f16 x is rounded to bf16, as the reference rounds any x (by the
decode kernel as it loads x; above 16 rows by a rounding pass that the same
C entry launches first, into the workspace), and y is written in f16;
W8A8 runs ``int8_gemm_wgmma_kernel`` at M > 16 where TMA takes the rows
(N a multiple of 16, 16-byte aligned arrays; also counted in
:data:`WGMMA_LAUNCHES`) and ``int8_gemm_mma_kernel`` elsewhere
(:func:`int8_uses_wgmma`).  CPU tensors run the plain versions
(:func:`mixed_gemm_plain`, :func:`int8_gemm_plain`, :data:`PLAIN_CALLS`),
which are also the kernels' oracle on the card.

The reference's TPU tile overrides and autotuner hook (``set_gemm_tiles``,
``clear_gemm_tiles``) choose TPU tiles only and change no result; they are
not ported (``ROADMAP.md``, autotuning).
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Any, Optional, Tuple

import torch

from ..quantizer import (minifloat_decode, minifloat_encode, minifloat_max,
                         pack_fp6, pack_int4, unpack_fp6, unpack_int4)
from . import build

#: launches of each kernel, counted where the wrapper launches it; the mixed
#: GEMM counts per code width (one template of one kernel each)
LAUNCHES = {"mixed_gemm_int8": 0, "mixed_gemm_int4": 0, "mixed_gemm_fp6": 0,
            "int8_gemm": 0}
#: of those launches, the ones of the wgmma kernels: per code width
#: ``mixed_gemm_wgmma_kernel`` (bf16 or f16 x, M > 16), and
#: ``int8_gemm_wgmma_kernel`` (:func:`int8_uses_wgmma`)
WGMMA_LAUNCHES = {"mixed_gemm_int8": 0, "mixed_gemm_int4": 0,
                  "mixed_gemm_fp6": 0, "int8_gemm": 0}
#: of the mixed GEMM's launches, the ones of ``mixed_gemm_decode_kernel``
#: (M <= 16 rows), per code width
DECODE_LAUNCHES = {"mixed_gemm_int8": 0, "mixed_gemm_int4": 0,
                   "mixed_gemm_fp6": 0}
#: calls of each plain version (the CPU path and the kernels' oracle)
PLAIN_CALLS = {"mixed_gemm_plain": 0, "int8_gemm_plain": 0}
#: calls outside the reference's kernel envelope (its dequantize formula)
DEQUANT_CALLS = {"mixed_gemm": 0, "int8_gemm": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the 2-byte activation types, which take the bf16 kernels' paths
_HALF_TYPES = (torch.bfloat16, torch.float16)
# the kernels' (rows, columns) per block and resident blocks per SM, for
# the split-K choice (csrc): Dec for M <= 16 (8 warps on 128 columns, at
# most 128 registers a thread and two blocks per SM for one n8 tile of x
# rows, M <= 8; one block for two); above, WgSmem for bf16 or f16 x (128
# rows up to M = 128, else 256) and MmaSmem for f32 x
_SMALL_M = 16
_DECODE_COLS = 128
_MMA_TILE = (128, 128, 2)
_INT8_BK = 128  # the W8A8 kernels' K-tile: a group is whole tiles
_SM_COUNT: dict = {}
_KERNEL_NAMES = {8: "mixed_gemm_int8", 4: "mixed_gemm_int4",
                 6: "mixed_gemm_fp6"}
_CODE_DTYPES = {8: torch.int8, 4: torch.int8, 6: torch.uint8}
# the decode kernel's split-K tickets, one buffer per (device, stream)
_TICKETS: dict = {}
_TICKETS_LOCK = threading.Lock()


def reset_counts() -> None:
    for counts in (LAUNCHES, WGMMA_LAUNCHES, DECODE_LAUNCHES, PLAIN_CALLS,
                   DEQUANT_CALLS):
        for key in counts:
            counts[key] = 0


@dataclasses.dataclass
class QuantizedWeight:
    """Weight codes + per-(K-group, N) scales for ``x @ W`` (layouts in the
    module doc).  ``k`` is the true K: int4 and fp6 pad K to their pack
    multiple, so their code rows only bound it."""

    codes: torch.Tensor
    scales: torch.Tensor
    bits: int
    group: int
    k: int = 0

    def __post_init__(self):
        if self.k == 0:
            if self.bits != 8:
                raise ValueError(
                    f"QuantizedWeight(bits={self.bits}) requires the true K "
                    f"via k= (codes rows give only the padded K)")
            self.k = self.codes.shape[-2]

    @property
    def k_features(self) -> int:
        return self.k

    @property
    def out_features(self) -> int:
        return self.codes.shape[-1]

    def to(self, device: Any) -> "QuantizedWeight":
        """The same weight on ``device``; codes and scales keep their
        dtypes."""
        return QuantizedWeight(self.codes.to(device), self.scales.to(device),
                               self.bits, self.group, self.k)

    def __getitem__(self, i) -> "QuantizedWeight":
        """Layer ``i`` of a stacked ``(L, ...)`` weight (views)."""
        return QuantizedWeight(self.codes[i], self.scales[i], self.bits,
                               self.group, self.k)


def aligned_divisor(n: int, cap: int, align: int = 8) -> Optional[int]:
    """Largest divisor of ``n`` ≤ ``cap`` that is a multiple of ``align``;
    ``n`` itself when ``n ≤ cap``; None when there is none (the reference's
    tile rule, ``flash_attention.py:51``)."""
    if n <= cap:
        return n
    for d in range(cap - cap % align, align - 1, -align):
        if n % d == 0:
            return d
    return None


def quantize_gemm_weight(w: torch.Tensor, bits: int = 8,
                         group: int = 256) -> QuantizedWeight:
    """Symmetric per-(K-group, column) quantization of ``w`` (..., K, N),
    where ``w`` lies.  ``bits=6`` stores FP6 e3m2 codes whose scales map
    each group's absmax to the fp6 max (28)."""
    if bits not in (8, 6, 4):
        raise ValueError(f"quantize bits must be 4, 6 or 8, got {bits}")
    *lead, K, N = w.shape
    if K % group != 0:  # shrink the group to a divisor (odd K still works)
        group = aligned_divisor(K, group, 1) or K
    wf = w.to(torch.float32).reshape(*lead, K // group, group, N)
    if bits == 6:
        scale = wf.abs().amax(dim=-2, keepdim=True) / minifloat_max(3, 2)
        scale = torch.where(scale == 0.0, 1.0, scale)
        codes = minifloat_encode(wf / scale, 3, 2).reshape(*lead, K, N)
        if K % 4:  # pad zero K-rows to the 4-per-3-bytes pack multiple
            codes = torch.cat([codes, codes.new_zeros(
                (*lead, (-K) % 4, N))], dim=-2)
        # pack along K: move K last, pack, move back
        codes = pack_fp6(codes.movedim(-2, -1)).movedim(-1, -2).contiguous()
        return QuantizedWeight(codes, scale[..., 0, :], bits, group, k=K)
    qmax = (1 << (bits - 1)) - 1
    scale = wf.abs().amax(dim=-2, keepdim=True) / qmax
    scale = torch.where(scale == 0.0, 1.0, scale)
    codes = torch.clamp(torch.round(wf / scale), -qmax - 1, qmax)
    codes = codes.reshape(*lead, K, N).to(torch.int8)
    if bits == 4:
        if K % 2:  # pad a zero K-row so two codes always pack per byte
            codes = torch.cat([codes, codes.new_zeros((*lead, 1, N))], dim=-2)
        codes = pack_int4(codes[..., 0::2, :], codes[..., 1::2, :])
    return QuantizedWeight(codes, scale[..., 0, :], bits, group, k=K)


def dequantize_gemm_weight(qw: QuantizedWeight) -> torch.Tensor:
    """The f32 weight ``(..., K, N)`` the codes stand for."""
    codes = qw.codes
    if qw.bits == 6:
        codes = unpack_fp6(codes.movedim(-2, -1)).movedim(-1, -2)
        vals = minifloat_decode(codes, 3, 2)[..., :qw.k_features, :]
        *lead, K, N = vals.shape
        v = vals.reshape(*lead, K // qw.group, qw.group, N)
        return (v * qw.scales[..., :, None, :]).reshape(*lead, K, N)
    if qw.bits == 4:
        lo, hi = unpack_int4(codes)
        # interleave: byte row r holds K-rows 2r (lo nibble), 2r+1 (hi)
        codes = torch.stack([lo, hi], dim=-2).reshape(
            *qw.codes.shape[:-2], 2 * qw.codes.shape[-2], qw.out_features)
        codes = codes[..., :qw.k_features, :]  # drop odd-K zero padding
    *lead, K, N = codes.shape
    w = codes.to(torch.float32).reshape(*lead, K // qw.group, qw.group, N)
    return (w * qw.scales[..., :, None, :]).reshape(*lead, K, N)


def quantize_activations_rowwise(x2: torch.Tensor, group: int
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(row, K-group) symmetric int8 quantization of (M, K)
    activations: codes int8 (M, K), scales f32 (M, K/group)."""
    M, K = x2.shape
    xg = x2.to(torch.float32).reshape(M, K // group, group)
    scale = xg.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.where(scale == 0.0, 1.0, scale)
    codes = torch.clamp(torch.round(xg / scale), -128, 127).to(torch.int8)
    return codes.reshape(M, K), scale[..., 0]


# ---------------------------------------------------------------------------
# the reference's kernel envelope, from the shapes alone
# ---------------------------------------------------------------------------


def _check_2d(name: str, qw: QuantizedWeight, K: int) -> None:
    if qw.codes.dim() != 2:
        raise ValueError(f"{name} wants per-layer (K, N) codes; got "
                         f"{tuple(qw.codes.shape)} — slice stacked layers "
                         "first (layer_params)")
    if K != qw.k_features:
        raise ValueError(f"x K={K} != weight K={qw.k_features} — a partial "
                         "product would be silently wrong")


def mixed_gemm_on_kernel_path(qw: QuantizedWeight) -> bool:
    """Whether the reference runs its Pallas kernel for this weight
    (``mixed_gemm.py:379-383``): N tiles, K splits into whole groups, and
    the codes of a group pack whole (int4: an even group; fp6: a group of
    a multiple of 32)."""
    return _mixed_envelope(qw.k_features, qw.out_features, qw.group, qw.bits)


@functools.lru_cache(maxsize=None)
def _mixed_envelope(K: int, N: int, g: int, bits: int) -> bool:
    return (aligned_divisor(N, 256, 128) is not None and K % g == 0
            and (bits != 4 or g % 2 == 0)
            and (bits != 6 or (g % 4 == 0 and (g // 4 * 3) % 8 == 0))
            and (g % 128 == 0 or g == K))


def int8_gemm_on_kernel_path(qw: QuantizedWeight) -> bool:
    """Whether the reference runs its W8A8 kernel (``mixed_gemm.py:326-330``):
    N tiles and K splits into whole groups of a multiple of 128."""
    return _int8_envelope(qw.k_features, qw.out_features, qw.group)


@functools.lru_cache(maxsize=None)
def _int8_envelope(K: int, N: int, g: int) -> bool:
    return (aligned_divisor(N, 256, 128) is not None and K % g == 0
            and g % 128 == 0)


def _rows(lead) -> int:
    M = 1
    for d in lead:
        M *= d
    return M


def _dequant_matmul(x2: torch.Tensor, qw: QuantizedWeight) -> torch.Tensor:
    """The reference's formula off its kernel envelope, in x's dtype."""
    return x2 @ dequantize_gemm_weight(qw).to(x2.dtype)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def mixed_gemm_plain(x: torch.Tensor, qw: QuantizedWeight) -> torch.Tensor:
    """Plain PyTorch ``x (M, K) @ dequant(qw)`` with the kernel's numerics:
    the weight dequantized in f32 and rounded to bf16, x rounded to bf16,
    the (exact) bf16 products summed in f32, the result in x's dtype."""
    PLAIN_CALLS["mixed_gemm_plain"] += 1
    w = dequantize_gemm_weight(qw).to(torch.bfloat16).to(torch.float32)
    xb = x.to(torch.bfloat16).to(torch.float32)
    return (xb @ w).to(x.dtype)


def int8_gemm_plain(x: torch.Tensor, qw: QuantizedWeight) -> torch.Tensor:
    """Plain PyTorch W8A8 of x (M, K): x quantized per (row, group), then
    :func:`int8_gemm_quantized_plain`."""
    xc, xs = quantize_activations_rowwise(x, qw.group)
    return int8_gemm_quantized_plain(xc, xs, qw, x.dtype)


def int8_gemm_quantized_plain(xc: torch.Tensor, xs: torch.Tensor,
                              qw: QuantizedWeight, dtype: torch.dtype
                              ) -> torch.Tensor:
    """Plain PyTorch W8A8 on quantized activations (codes (M, K), scales
    (M, K/group)) with the kernel's numerics: per group the exact integer
    product (summed in f64, exact for any K) and ``acc += f32(i) * xs * ws``
    in the kernel's order, group by group; the result in ``dtype``."""
    PLAIN_CALLS["int8_gemm_plain"] += 1
    M, K = xc.shape
    g = qw.group
    acc = torch.zeros((M, qw.out_features), dtype=torch.float32,
                      device=xc.device)
    for j in range(K // g):
        i = (xc[:, j * g:(j + 1) * g].to(torch.float64)
             @ qw.codes[j * g:(j + 1) * g].to(torch.float64))
        acc = acc + i.to(torch.float32) * xs[:, j:j + 1] * qw.scales[j]
    return acc.to(dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _stream(device: torch.device) -> int:
    """The raw handle of the current CUDA stream (the cheap query that
    torch's own compiled kernels use)."""
    return torch._C._cuda_getCurrentRawStream(
        device.index if device.index is not None
        else torch.cuda.current_device())


def _check_x(name: str, x2: torch.Tensor) -> None:
    if x2.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} takes bfloat16, float16 or float32 "
                        f"activations, got {x2.dtype}")
    if not x2.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")


@functools.lru_cache(maxsize=None)
def _code_rows(bits: int, K: int) -> int:
    return {8: K, 4: -(-K // 2), 6: 3 * -(-K // 4)}[bits]


def _check_weight(name: str, qw: QuantizedWeight, device: torch.device
                  ) -> None:
    codes, scales = qw.codes, qw.scales
    if codes.dtype != _CODE_DTYPES[qw.bits] or scales.dtype != torch.float32:
        raise TypeError(f"{name}: bits={qw.bits} wants "
                        f"{_CODE_DTYPES[qw.bits]} codes and float32 scales, "
                        f"got {codes.dtype}, {scales.dtype}")
    N, K = qw.out_features, qw.k_features
    if codes.shape != (_code_rows(qw.bits, K), N) or K % qw.group or \
            scales.shape != (K // qw.group, N):
        raise ValueError(f"{name}: codes {tuple(codes.shape)} and scales "
                         f"{tuple(scales.shape)} do not fit K={K}, "
                         f"N={N}, group={qw.group}")
    if codes.device != device or scales.device != device:
        raise ValueError(f"{name}: codes on {codes.device}, scales on "
                         f"{scales.device}, x on {device}")
    if not (codes.is_contiguous() and scales.is_contiguous()):
        raise ValueError(f"{name}: codes and scales must be contiguous")


def _on_cuda(name: str, x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return True


def _mixed_tile(M: int, bf16: bool):
    """(rows, columns, blocks per SM) of the M > 16 kernel for M rows
    (``bf16``: 2-byte x, bf16 or f16, on the wgmma kernel)."""
    if not bf16:
        return _MMA_TILE
    return (128 if M <= 128 else 256), 128, 1


def mixed_gemm_splits(M: int, N: int, groups: int, sms: int,
                      bf16: bool = True) -> int:
    """How many K-splits the mixed GEMM kernel above 16 rows takes: enough
    for its output tiles to fill the card's resident blocks, at most one
    per group."""
    bm, bn, per_sm = _mixed_tile(M, bf16)
    tiles = -(-M // bm) * -(-N // bn)
    return max(1, min(groups, per_sm * sms // tiles))


def decode_steps(K: int, group: int) -> int:
    """``mixed_gemm_decode_kernel``'s K-steps of 16 rows: ceil(group / 16)
    a group (the last one partial where 16 does not divide the group)."""
    return K // group * -(-group // 16)


#: K-steps a decode block takes at least (two for each of its 8 warps)
_DECODE_MIN_STEPS = 16


def decode_blocks(M: int, N: int, K: int, group: int, sms: int) -> int:
    """How many blocks ``mixed_gemm_decode_kernel`` runs: as many as the
    card holds at once (8 warps, at most 128 registers a thread: two an SM
    for one n8 tile of x rows, M <= 8, one for two), each an equal share of
    the 128-column tiles' K-steps in tile order (a tile split between
    blocks is added up in the kernel), every block at least
    _DECODE_MIN_STEPS steps."""
    per_sm = 2 if M <= 8 else 1
    steps = -(-N // _DECODE_COLS) * decode_steps(K, group)
    return max(1, min(per_sm * sms, steps // _DECODE_MIN_STEPS))


def _tickets(device: torch.device, stream: int, tiles: int) -> torch.Tensor:
    """The decode kernel's split-K tickets for launches on ``stream``: an
    int32 per 128-column tile, zero between launches (the last block of a
    tile resets its own).  Launches on one stream run in turn and share
    one buffer; another stream's, which may run at the same time, get
    another.  A buffer grows only by a new zeroed one allocated on its
    stream (``torch.zeros`` is queued there), and the caching allocator
    hands the old one's memory only to work queued later on that stream.
    The lock keeps two threads from growing one stream's buffer at once;
    the caller holds the tensor until its launch is queued."""
    key = (device.index, stream)
    with _TICKETS_LOCK:
        buf = _TICKETS.get(key)
        if buf is None or buf.numel() < tiles:
            size = max(tiles, 2 * (0 if buf is None else buf.numel()))
            buf = torch.zeros(size, dtype=torch.int32, device=device)
            _TICKETS[key] = buf
        return buf


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def _mixed_gemm_cuda(x2: torch.Tensor, qw: QuantizedWeight) -> torch.Tensor:
    M, K = x2.shape
    N = qw.out_features
    _check_x("mixed_gemm", x2)
    _check_weight("mixed_gemm", qw, x2.device)
    out = torch.empty((M, N), dtype=x2.dtype, device=x2.device)
    if M == 0 or N == 0:
        return out
    bf16 = x2.dtype in _HALF_TYPES  # the wgmma kernel above 16 rows
    decode = M <= _SMALL_M
    sms = _sm_count(x2.device)
    # the decode kernel's blocks, or the split count above 16 rows
    splits = decode_blocks(M, N, K, qw.group, sms) if decode else \
        mixed_gemm_splits(M, N, K // qw.group, sms, bf16)
    stream = _stream(x2.device)
    # the partial sums of shared tiles (decode: two segments a block, M rows
    # of 128 columns) or of the K-splits, then f16 x rounded to bf16 above
    # 16 rows (M * K, from a 16-byte boundary): one buffer per call from
    # the caching allocator on the launch stream: calls from several
    # threads on one stream never share it, and it is reused only after
    # this call's sum
    ws = tickets = None
    sums = 0 if splits == 1 else (2 * splits * M * _DECODE_COLS if decode
                                  else splits * M * N)
    x_bf16 = 0 if decode or x2.dtype != torch.float16 else -(-M * K // 2)
    if sums or x_bf16:
        ws = torch.empty(-(-sums // 4) * 4 + x_bf16, dtype=torch.float32,
                         device=x2.device)
    if decode and splits > 1:
        tickets = _tickets(x2.device, stream, -(-N // _DECODE_COLS))
    lib = build.load()
    err = lib.ds_mixed_gemm(
        _DTYPE_CODES[x2.dtype], qw.bits, x2.data_ptr(), qw.codes.data_ptr(),
        qw.scales.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if tickets is None else tickets.data_ptr(),
        M, N, K, qw.group, splits, stream)
    build.check(lib, err, "mixed_gemm launch")
    name = _KERNEL_NAMES[qw.bits]
    LAUNCHES[name] += 1
    if decode:
        DECODE_LAUNCHES[name] += 1
    elif bf16:
        WGMMA_LAUNCHES[name] += 1
    return out


def int8_uses_wgmma(xc: torch.Tensor, qw: QuantizedWeight) -> bool:
    """Whether W8A8 on the quantized rows ``xc`` (M, K) runs
    ``int8_gemm_wgmma_kernel``: more than 16 rows, and rows that TMA copies
    (N a multiple of 16; x codes, weight codes and scales 16-byte aligned).
    Otherwise ``int8_gemm_mma_kernel`` runs, which takes any N: a dispatch
    on the shape, not a fallback."""
    return (xc.shape[0] > _SMALL_M and qw.out_features % 16 == 0
            and all(t.data_ptr() % 16 == 0
                    for t in (xc, qw.codes, qw.scales)))


def int8_gemm_quantized(xc: torch.Tensor, xs: torch.Tensor,
                        qw: QuantizedWeight, dtype: torch.dtype
                        ) -> torch.Tensor:
    """The W8A8 kernels on CUDA activations already quantized by
    :func:`quantize_activations_rowwise` (codes (M, K) int8, scales
    (M, K/group) f32); the result in ``dtype`` (bf16, f16 or f32)."""
    if xc.device.type != "cuda":
        raise ValueError(f"int8_gemm_quantized: the kernel needs CUDA "
                         f"tensors, got {xc.device}")
    M, K = xc.shape
    N = qw.out_features
    if xc.dtype != torch.int8 or xs.dtype != torch.float32 or tuple(
            xs.shape) != (M, K // qw.group) or dtype not in _DTYPE_CODES:
        raise TypeError("int8_gemm_quantized takes int8 codes (M, K), "
                        "float32 scales (M, K/group) and a bfloat16, "
                        "float16 or float32 output dtype")
    if not xc.is_contiguous():
        raise ValueError("int8_gemm: x codes must be contiguous")
    _check_weight("int8_gemm", qw, xc.device)
    if qw.group % _INT8_BK:
        raise ValueError(f"int8_gemm kernels take groups of a multiple of "
                         f"{_INT8_BK} K-rows, got group={qw.group}")
    out = torch.empty((M, N), dtype=dtype, device=xc.device)
    if M == 0 or N == 0:
        return out
    # (K/group, M) with rows a multiple of 4 floats apart (16 bytes, as TMA
    # and the 16-byte copies want): a group's row scales in a row
    pitch = -(-M // 4) * 4
    xs_t = torch.empty((K // qw.group, pitch), dtype=torch.float32,
                       device=xc.device)
    xs_t[:, :M].copy_(xs.t())
    wgmma = int8_uses_wgmma(xc, qw)
    lib = build.load()
    err = lib.ds_int8_gemm(
        _DTYPE_CODES[dtype], int(wgmma), xc.data_ptr(), xs_t.data_ptr(),
        pitch, qw.codes.data_ptr(), qw.scales.data_ptr(), out.data_ptr(), M,
        N, K, qw.group, _stream(xc.device))
    build.check(lib, err, "int8_gemm launch")
    LAUNCHES["int8_gemm"] += 1
    if wgmma:
        WGMMA_LAUNCHES["int8_gemm"] += 1
    return out


def _int8_gemm_cuda(x2: torch.Tensor, qw: QuantizedWeight) -> torch.Tensor:
    _check_x("int8_gemm", x2)
    xc, xs = quantize_activations_rowwise(x2, qw.group)
    return int8_gemm_quantized(xc, xs, qw, x2.dtype)


def _flat(x: torch.Tensor, K: int) -> torch.Tensor:
    return x if x.dim() == 2 else x.reshape(_rows(x.shape[:-1]), K)


def mixed_gemm(x: torch.Tensor, qw: QuantizedWeight) -> torch.Tensor:
    """``x (..., K) @ dequant(qw)`` in x's dtype (see the module doc)."""
    if qw.bits not in _KERNEL_NAMES:
        raise ValueError(f"mixed_gemm: bits must be 4, 6 or 8, got {qw.bits}")
    K = x.shape[-1]
    _check_2d("mixed_gemm", qw, K)
    x2 = _flat(x, K)
    if not mixed_gemm_on_kernel_path(qw):
        DEQUANT_CALLS["mixed_gemm"] += 1
        out = _dequant_matmul(x2, qw)
    elif _on_cuda("mixed_gemm", x2):
        out = _mixed_gemm_cuda(x2, qw)
    else:
        out = mixed_gemm_plain(x2, qw)
    return out if x.dim() == 2 else out.reshape(*x.shape[:-1], out.shape[1])


def int8_gemm(x: torch.Tensor, qw: QuantizedWeight) -> torch.Tensor:
    """W8A8 ``quant(x) @ qw`` in x's dtype (see the module doc).  ``qw``
    must be bits=8 per-layer (K, N) codes with x's K."""
    if qw.bits != 8:
        raise ValueError(f"int8_gemm needs bits=8 weights, got {qw.bits}")
    K = x.shape[-1]
    _check_2d("int8_gemm", qw, K)
    x2 = _flat(x, K)
    if not int8_gemm_on_kernel_path(qw):
        DEQUANT_CALLS["int8_gemm"] += 1
        out = _dequant_matmul(x2, qw)
    elif _on_cuda("int8_gemm", x2):
        out = _int8_gemm_cuda(x2, qw)
    else:
        out = int8_gemm_plain(x2, qw)
    return out if x.dim() == 2 else out.reshape(*x.shape[:-1], out.shape[1])


# ---------------------------------------------------------------------------
# frozen-weight entry point: differentiable in x, never in the codes
# ---------------------------------------------------------------------------


class _FrozenGemm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, qw):
        ctx.qw = qw
        return mixed_gemm(x, qw)

    @staticmethod
    def backward(ctx, g):
        # dx = g @ W^T with W dequantized in g's dtype, outside any kernel
        # (the reference's _frozen_gemm_bwd); the weight gets no gradient
        w = dequantize_gemm_weight(ctx.qw).to(g.dtype)
        return g @ w.transpose(-1, -2), None


def mixed_gemm_frozen(x: torch.Tensor, qw: QuantizedWeight) -> torch.Tensor:
    """:func:`mixed_gemm` inside a differentiated graph: the gradient flows
    to ``x`` only."""
    return _FrozenGemm.apply(x, qw)

