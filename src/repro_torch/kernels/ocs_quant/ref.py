"""Plain PyTorch version of the Eq. 7 code kernels (and the port's
monotone-code arithmetic itself).

The IEEE-754 sign-flip trick orders floats as unsigned integers::

    code(b) = ~b            if the sign bit is set   (negative values)
    code(b) = b | SIGN_BIT  otherwise

All bit arithmetic runs on ``int64`` masked to the float's width, since
PyTorch lacks shifts and most other ops on ``uint16``/``uint32``.  Codes
come out as ``uint8`` (D <= 8), ``uint16`` (D <= 16) or ``uint32``.
"""

from __future__ import annotations

import torch

# 16/32-bit dtype -> the signed int dtype that carries its bits
_SIGNED = {torch.float32: torch.int32, torch.uint32: torch.int32,
           torch.bfloat16: torch.int16, torch.float16: torch.int16,
           torch.uint16: torch.int16}
# float dtype -> (exponent mask, mantissa mask, -inf bits)
_NAN = {torch.float32: (0x7F800000, 0x007FFFFF, 0xFF800000),
        torch.bfloat16: (0x7F80, 0x007F, 0xFF80),
        torch.float16: (0x7C00, 0x03FF, 0xFC00)}


def width(dtype: torch.dtype) -> int:
    """Bits of a float dtype the codes cover (float32, bfloat16, float16)."""
    if dtype not in _NAN:
        raise ValueError(f"unsupported dtype for monotone code: {dtype}")
    return 8 * dtype.itemsize


def code_dtype(bits: int) -> torch.dtype:
    if bits <= 8:
        return torch.uint8
    return torch.uint16 if bits <= 16 else torch.uint32


def to_int64(u: torch.Tensor) -> torch.Tensor:
    """Unsigned words (uint8/16/32, or their int16/int32 bit views) as
    non-negative int64."""
    if u.dtype in (torch.uint16, torch.int16):
        return u.view(torch.int16).to(torch.int64) & 0xFFFF
    if u.dtype in (torch.uint32, torch.int32):
        return u.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return u.to(torch.int64)


def from_int64(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Non-negative int64 words (< 2^width) cast to an unsigned dtype or
    reinterpreted as a float dtype of the same width."""
    sview = _SIGNED.get(dtype)
    if sview is None:                                   # uint8
        return x.to(dtype)
    w = 8 * sview.itemsize
    return (x - ((x >> (w - 1)) << w)).to(sview).view(dtype)  # 2's compl.


def monotone_code_int64(x: torch.Tensor) -> torch.Tensor:
    """Full-width order code of ``x`` as non-negative int64."""
    w = width(x.dtype)
    mask = (1 << w) - 1
    sign = 1 << (w - 1)
    b = x.contiguous().view(_SIGNED[x.dtype]).to(torch.int64) & mask
    return torch.where((b & sign) != 0, ~b & mask, b | sign)


def encode(x: torch.Tensor, bits: int) -> torch.Tensor:
    """D-bit code: the top ``bits`` of the full order code."""
    w = width(x.dtype)
    if not 1 <= bits <= w:
        raise ValueError(f"bits must be in [1, {w}], got {bits}")
    return from_int64(monotone_code_int64(x) >> (w - bits), code_dtype(bits))


def decode(code: torch.Tensor, bits: int, dtype: torch.dtype) -> torch.Tensor:
    """Lowest float of each D-bit bucket; the lowest bucket (negative-NaN
    bit space once zero-filled) decodes to -inf, as does any NaN."""
    w = width(dtype)
    mask = (1 << w) - 1
    sign = 1 << (w - 1)
    full = (to_int64(code) << (w - bits)) & mask
    b = torch.where((full & sign) == 0, ~full & mask, full & ~sign)
    exp, man, neg_inf = _NAN[dtype]
    nan = ((b & exp) == exp) & ((b & man) != 0)
    return from_int64(torch.where(nan, neg_inf, b), dtype)
