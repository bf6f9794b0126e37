"""Wrappers of the Eq. 7 code kernels (``csrc/ocs_quant.cu``).

``encode``/``decode`` take the plain version (``ref.py``) for a tensor on
the CPU and launch the CUDA kernel for a tensor on the card.  The kernel
covers D <= 16 (``uint8``/``uint16`` codes), which are the codes the TPU
kernel covers; a wider code on the card raises.  A fake tensor (a trace,
either device) goes through the custom ops ``repro_torch::ocs_encode`` and
``repro_torch::ocs_decode``, whose fake impls give the outputs alone.
``quantize_st`` is ``decode(encode(x))`` with a straight-through gradient,
the JAX package's ``custom_vjp`` of the same name.
"""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch import kernels
from repro_torch.kernels.ocs_quant import ref

MAX_KERNEL_BITS = 16


def _check_bits(bits: int, dtype: torch.dtype) -> None:
    w = ref.width(dtype)
    if not 1 <= bits <= w:
        raise ValueError(f"bits must be in [1, {w}], got {bits}")
    if bits > MAX_KERNEL_BITS:
        raise ValueError(
            f"bits={bits}: the ocs_quant CUDA kernel covers codes of at most "
            f"{MAX_KERNEL_BITS} bits (uint8/uint16)")


def _check_decode(code: torch.Tensor, bits: int, dtype: torch.dtype):
    _check_bits(bits, dtype)
    if code.dtype != ref.code_dtype(bits):
        raise ValueError(f"{bits}-bit codes are {ref.code_dtype(bits)}, "
                         f"got {code.dtype}")


@torch.library.custom_op("repro_torch::ocs_encode", mutates_args=(),
                         device_types="cpu")
def _encode(x: torch.Tensor, bits: int) -> torch.Tensor:
    return ref.encode(x, bits)


@_encode.register_kernel("cuda")
def _encode_kernel(x, bits):
    _check_bits(bits, x.dtype)
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=ref.code_dtype(bits), device=x.device)
    kernels.check_operands(x, out)
    kernels.launch("ocs_quant.encode", "ocs_encode", x.device,
                   x.data_ptr(), out.data_ptr(), x.numel(),
                   x.element_size(), out.element_size(), bits)
    return out


@_encode.register_fake
def _(x, bits):
    if x.device.type == "cpu":
        ref.width(x.dtype)
    else:
        _check_bits(bits, x.dtype)
    return x.new_empty(x.shape, dtype=ref.code_dtype(bits))


def encode(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Float tensor -> D-bit monotone codes of the same shape."""
    if is_fake(x):
        return _encode(x, bits)
    if x.device.type == "cpu":
        return ref.encode(x, bits)
    return _encode_kernel(x, bits)


@torch.library.custom_op("repro_torch::ocs_decode", mutates_args=(),
                         device_types="cpu")
def _decode(code: torch.Tensor, bits: int,
            dtype: torch.dtype) -> torch.Tensor:
    return ref.decode(code, bits, dtype)


@_decode.register_kernel("cuda")
def _decode_kernel(code, bits, dtype):
    _check_decode(code, bits, dtype)
    code = code.contiguous()
    out = torch.empty(code.shape, dtype=dtype, device=code.device)
    kernels.check_operands(code, out)
    kernels.launch("ocs_quant.decode", "ocs_decode", code.device,
                   code.data_ptr(), out.data_ptr(), code.numel(),
                   code.element_size(), kernels.KIND[dtype], bits)
    return out


@_decode.register_fake
def _(code, bits, dtype):
    if code.device.type != "cpu":
        _check_decode(code, bits, dtype)
    return code.new_empty(code.shape, dtype=dtype)


def decode(code: torch.Tensor, bits: int, dtype: torch.dtype) -> torch.Tensor:
    """D-bit codes -> the lowest float of each bucket (lowest -> -inf)."""
    if is_fake(code):
        return _decode(code, bits, dtype)
    if code.device.type == "cpu":
        return ref.decode(code, bits, dtype)
    return _decode_kernel(code, bits, dtype)


class _QuantizeST(torch.autograd.Function):
    """Forward ``decode(encode(x))``; backward the identity."""

    @staticmethod
    def forward(ctx, x, bits):
        return decode(encode(x, bits), bits, x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def quantize_st(x: torch.Tensor, bits: int) -> torch.Tensor:
    """dequantize(encode(x)) with a straight-through gradient: each value
    becomes its D-bit bucket's lowest float, and the cotangent passes
    through unchanged."""
    return _QuantizeST.apply(x, bits)
