"""Code packing and minifloat (FP6 e3m2) coding for the mixed GEMM — the
port of the part of ``deepspeed_tpu/ops/quantizer.py`` that
``ops/hopper/mixed_gemm.py`` needs: int4 nibble packing, the minifloat
encode / decode, and the FP6 4-codes-in-3-bytes packing.

Every function computes the reference's integers and floats exactly:
``quantize_gemm_weight`` gives the reference's codes bit for bit.  The
blockwise, fp8, fp12, stochastic-rounding and compressed all-reduce
quantizers arrive with the collectives and offload items (``ROADMAP.md``
A13, A14).
"""

from __future__ import annotations

from typing import Tuple

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
