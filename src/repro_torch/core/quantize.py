"""Monotone D-bit quantization of floating-point features (paper Eq. 7).

The OCS protocol maps a feature ``h`` to a backoff period ``g(h) = 2^D -
INT(h)`` where ``INT`` reads the float's bit pattern as an integer (paper
§III, footnote 2).  The sign-flip trick (``kernels/ocs_quant/ref.py``) is a
strictly increasing embedding of floats into unsigned integers; its top D
bits are the paper's D-bit code, still monotone, so the max over workers of
the codes selects a true argmax worker up to D-bit resolution.

``quantize``/``dequantize`` launch the ``ocs_quant`` CUDA kernels for a
tensor on the card (codes of at most 16 bits; a wider code raises there)
and run the plain version for a tensor on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ocs_quant import ops, ref

def monotone_code(x: torch.Tensor) -> torch.Tensor:
    """Order-embed floats into unsigned ints: x < y  <=>  code(x) < code(y)
    (-0.0 orders just below +0.0).  ``uint32`` for float32, ``uint16``
    for bfloat16/float16."""
    w = ref.width(x.dtype)
    return ref.from_int64(ref.monotone_code_int64(x), ref.code_dtype(w))


def monotone_decode(code: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`monotone_code` (no NaN clamp)."""
    w = ref.width(dtype)
    mask, sign = (1 << w) - 1, 1 << (w - 1)
    c = ref.to_int64(code) & mask
    b = torch.where((c & sign) == 0, ~c & mask, c & ~sign)
    return ref.from_int64(b, dtype)


def quantize(x: torch.Tensor, bits: int) -> torch.Tensor:
    """D-bit monotone code in ``[0, 2^bits)`` (top ``bits`` of the code)."""
    w = ref.width(x.dtype)
    if not 1 <= bits <= w:
        raise ValueError(f"bits must be in [1, {w}], got {bits}")
    return ops.encode(x, bits)


def dequantize(code: torch.Tensor, bits: int, dtype: torch.dtype
               ) -> torch.Tensor:
    """Lowest float of each D-bit bucket (low bits zero-filled), so
    ``dequantize(quantize(x))`` rounds x toward -inf and the pooled max is
    a value some worker can send; the lowest bucket decodes to -inf."""
    return ops.decode(code, bits, dtype)


def backoff_code(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Paper Eq. 7: ``g(h) = 2^D - 1 - code``, strictly decreasing in h,
    in the same integer width as :func:`quantize`."""
    q = quantize(x, bits)
    back = ((1 << bits) - 1) - ref.to_int64(q)
    return ref.from_int64(back, q.dtype)
