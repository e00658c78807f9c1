"""Code packing, minifloat (FP6 e3m2) coding and the block-scaled codecs —
the port of the part of ``deepspeed_tpu/ops/quantizer.py`` that
``ops/hopper/mixed_gemm.py`` and a LoRA layer's quantized frozen base
(``linear/optimized_linear.py``) need: int4 nibble packing, the minifloat
encode / decode, the FP6 4-codes-in-3-bytes packing, and the flat
block-scaled int8 / int4, fp8 e4m3 and fp6 quantizers with their decodes.

Every function computes the reference's integers and floats exactly:
``quantize_gemm_weight`` and the block quantizers give the reference's
codes bit for bit.  The fp12, stochastic-rounding and compressed
all-reduce quantizers arrive with the collectives item (``ROADMAP.md``
A13).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch


def pack_int4(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Pack two int4 code planes (int8 tensors, same shape) into bytes:
    ``lo`` in the low nibble, ``hi`` in the high one."""
    b = (lo.to(torch.int32) & 0xF) | ((hi.to(torch.int32) & 0xF) << 4)
    # the byte's two's-complement value, so the cast to int8 never wraps
    return torch.where(b >= 128, b - 256, b).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bytes → (lo, hi) sign-extended int8 code planes."""
    b = packed.to(torch.int32)  # sign-extends the byte
    lo = ((b & 0xF) ^ 8) - 8  # sign-extends the low nibble
    hi = b >> 4  # arithmetic shift: the high nibble, signed
    return lo.to(torch.int8), hi.to(torch.int8)


def _minifloat_magnitudes(ebits: int, mbits: int) -> torch.Tensor:
    """All 2^(ebits+mbits) representable magnitudes, ascending, f32 (no
    inf/nan: the whole exponent range encodes values)."""
    bias = (1 << (ebits - 1)) - 1
    mags = []
    for e in range(1 << ebits):
        for m in range(1 << mbits):
            if e == 0:  # subnormal
                mags.append(m * 2.0 ** (1 - bias - mbits))
            else:
                mags.append((1 + m * 2.0 ** -mbits) * 2.0 ** (e - bias))
    return torch.tensor(mags, dtype=torch.float32)


def minifloat_max(ebits: int, mbits: int) -> float:
    bias = (1 << (ebits - 1)) - 1
    return float((2 - 2.0 ** -mbits) * 2.0 ** ((1 << ebits) - 1 - bias))


def minifloat_encode(x: torch.Tensor, ebits: int, mbits: int) -> torch.Tensor:
    """float → sign-magnitude integer codes of width 1+ebits+mbits, int32
    (round to nearest by a midpoint search over the magnitude table; a tie
    takes the smaller magnitude, as ``jnp.searchsorted``'s left side)."""
    mags = _minifloat_magnitudes(ebits, mbits).to(x.device)
    mids = (mags[:-1] + mags[1:]) / 2.0
    xf = x.to(torch.float32)
    idx = torch.searchsorted(mids, xf.abs().contiguous(), right=False)
    sign = (xf < 0).to(torch.int32)
    return (sign << (ebits + mbits)) | idx.to(torch.int32)


def minifloat_decode(codes: torch.Tensor, ebits: int, mbits: int,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Arithmetic decode of sign | e | m codes.  2^(e - bias) is built from
    the f32 exponent field by bit view, not ``exp2``, so that a round trip
    through :func:`minifloat_encode` is exact."""
    bias = (1 << (ebits - 1)) - 1
    c = codes.to(torch.int32)
    m = (c & ((1 << mbits) - 1)).to(torch.float32)
    e = (c >> mbits) & ((1 << ebits) - 1)
    sign = 1.0 - 2.0 * ((c >> (ebits + mbits)) & 1).to(torch.float32)
    sub = m * 2.0 ** (1 - bias - mbits)
    pow2 = ((e - bias + 127) << 23).to(torch.int32).view(torch.float32)
    nrm = (1.0 + m * 2.0 ** -mbits) * pow2
    return (sign * torch.where(e == 0, sub, nrm)).to(dtype)


def pack_fp6(codes: torch.Tensor) -> torch.Tensor:
    """(..., 4k) 6-bit codes → (..., 3k) uint8 (the reference's 4:3
    pack)."""
    c = codes.to(torch.int32).reshape(*codes.shape[:-1], -1, 4)
    c0, c1, c2, c3 = c.unbind(-1)
    b0 = (c0 & 63) | ((c1 & 3) << 6)
    b1 = ((c1 >> 2) & 15) | ((c2 & 15) << 4)
    b2 = ((c2 >> 4) & 3) | ((c3 & 63) << 2)
    out = torch.stack([b0, b1, b2], dim=-1)
    return out.reshape(*codes.shape[:-1], -1).to(torch.uint8)


def unpack_fp6(packed: torch.Tensor) -> torch.Tensor:
    """(..., 3k) bytes → (..., 4k) 6-bit codes, int32."""
    b = packed.to(torch.int32).reshape(*packed.shape[:-1], -1, 3)
    b0, b1, b2 = b.unbind(-1)
    c0 = b0 & 63
    c1 = ((b0 >> 6) & 3) | ((b1 & 15) << 2)
    c2 = ((b1 >> 4) & 15) | ((b2 & 3) << 4)
    c3 = (b2 >> 2) & 63
    out = torch.stack([c0, c1, c2, c3], dim=-1)
    return out.reshape(*packed.shape[:-1], -1)


# ---------------------------------------------------------------------------
# flat block-scaled codecs (the reference's quantize_blockwise, quantize_fp8,
# quantize_minifloat and their decodes)
# ---------------------------------------------------------------------------


def _block_reshape(x: torch.Tensor, block_size: int
                   ) -> Tuple[torch.Tensor, int]:
    """x flattened, zero-padded to whole blocks, as (nblocks, block_size)."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block_size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, block_size), pad


def _block_scales(blocks: torch.Tensor, qmax: float) -> torch.Tensor:
    """Each block's absmax over ``qmax``, 1 for an all-zero block."""
    scale = blocks.abs().amax(dim=1, keepdim=True) / qmax
    return torch.where(scale == 0.0, 1.0, scale)


def _crop(flat: torch.Tensor, shape: Optional[Sequence[int]],
          dtype: torch.dtype) -> torch.Tensor:
    if shape is not None:
        flat = flat[:math.prod(shape)].reshape(tuple(shape))
    return flat.to(dtype)


def quantize_blockwise(x: torch.Tensor, bits: int = 8, block_size: int = 256
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric block quantization of x's flat values → (codes int8
    (nblocks, block_size), or two int4 codes a byte for ``bits=4``; f32
    scales (nblocks,))."""
    if bits not in (8, 4):
        raise ValueError(f"quantize_blockwise takes bits 8 or 4, got {bits}")
    blocks, _ = _block_reshape(x.to(torch.float32), block_size)
    qmax = (1 << (bits - 1)) - 1  # 127 / 7
    scale = _block_scales(blocks, qmax)
    codes = torch.clamp(torch.round(blocks / scale), -qmax - 1,
                        qmax).to(torch.int8)
    if bits == 4:
        codes = pack_int4(codes[:, 0::2], codes[:, 1::2])
    return codes, scale[:, 0]


def dequantize_blockwise(codes: torch.Tensor, scales: torch.Tensor,
                         bits: int = 8, block_size: int = 256,
                         shape: Optional[Sequence[int]] = None,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The values :func:`quantize_blockwise` coded (the first
    ``prod(shape)`` of them in ``shape``, when given), in ``dtype``."""
    if bits not in (8, 4):
        raise ValueError(f"dequantize_blockwise takes bits 8 or 4, got "
                         f"{bits}")
    if bits == 4:
        lo, hi = unpack_int4(codes)
        codes = torch.stack([lo, hi], dim=-1).reshape(codes.shape[0], -1)
    out = codes.to(torch.float32) * scales[:, None]
    return _crop(out.reshape(-1), shape, dtype)


#: e4m3's largest finite value: a block's absmax maps onto it
FP8_MAX = float(torch.finfo(torch.float8_e4m3fn).max)  # 448


def quantize_fp8(x: torch.Tensor, block_size: int = 256
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-scaled fp8 e4m3 → (codes ``torch.float8_e4m3fn`` (nblocks,
    block_size), f32 scales (nblocks,)); each block's absmax maps to 448,
    and the cast rounds to nearest even, as the reference's."""
    blocks, _ = _block_reshape(x.to(torch.float32), block_size)
    scale = _block_scales(blocks, FP8_MAX)
    return (blocks / scale).to(torch.float8_e4m3fn), scale[:, 0]


def dequantize_fp8(codes: torch.Tensor, scales: torch.Tensor,
                   shape: Optional[Sequence[int]] = None,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """fp8 codes times their block's scale, as int8 blocks are."""
    return dequantize_blockwise(codes.to(torch.float32), scales, bits=8,
                                block_size=codes.shape[1], shape=shape,
                                dtype=dtype)


def _check_minifloat(bits: int) -> None:
    if bits != 6:
        raise ValueError(f"the port's minifloat codec is fp6 (bits=6), got "
                         f"bits={bits}; fp12 arrives with ROADMAP.md A13")


def quantize_minifloat(x: torch.Tensor, bits: int = 6, block_size: int = 256
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-scaled fp6 e3m2 → (packed uint8 (nblocks, 3 block_size / 4),
    f32 scales (nblocks,)); each block's absmax maps to the format's max
    (28)."""
    _check_minifloat(bits)
    if block_size % 4:
        raise ValueError(f"fp6 packs 4 codes in 3 bytes: block_size "
                         f"{block_size} is not a multiple of 4")
    blocks, _ = _block_reshape(x.to(torch.float32), block_size)
    scale = _block_scales(blocks, minifloat_max(3, 2))
    return pack_fp6(minifloat_encode(blocks / scale, 3, 2)), scale[:, 0]


def dequantize_minifloat(packed: torch.Tensor, scales: torch.Tensor,
                         bits: int = 6,
                         shape: Optional[Sequence[int]] = None,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    _check_minifloat(bits)
    vals = minifloat_decode(unpack_fp6(packed), 3, 2) * scales[:, None]
    return _crop(vals.reshape(-1), shape, dtype)
