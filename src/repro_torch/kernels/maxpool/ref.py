"""Plain PyTorch version of the worker max-pool kernels.

``maxpool_fused`` pools over ``dim``; the winner is the first maximum (NaN
above every number, as ``jnp.argmax``) and the value returned is the
winner's own element, except that a tie of -0.0 and +0.0 pools to +0.0,
as ``jnp.max`` does.  Unsigned codes are compared as int64, since PyTorch
has no reductions on ``uint16``/``uint32``.

``maxpool_decode`` is ``maxpool_fused`` over D-bit codes composed with the
Eq. 7 ``decode`` (``ocs_quant.ref``), optionally with a worker mask and the
code of a given winner: the fused pooling epilogue of a channel site.
Given the float features in place of codes it encodes them first
(``ocs_quant.ref.encode``), as its kernel does in registers.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.ocs_quant.ref import (decode, encode, from_int64,
                                              to_int64)

_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32)


def maxpool_fused(h: torch.Tensor, dim: int = 0):
    """h -> (pooled (h without ``dim``), winner int32 of the same shape)."""
    dim = dim % h.ndim
    key = to_int64(h) if h.dtype in _UNSIGNED else h.float()
    n = h.shape[dim]
    # NaN ranks above everything; among equals the lowest index wins
    nan = torch.isnan(key) if key.is_floating_point() else None
    if nan is not None:
        key = torch.where(nan, torch.inf, key)
    best = key.amax(dim=dim, keepdim=True)
    hit = key == best
    if nan is not None:
        any_nan = nan.any(dim=dim, keepdim=True)
        hit = torch.where(any_nan, nan, hit)
    idx = torch.arange(n, device=h.device).reshape(
        (n,) + (1,) * (h.ndim - dim - 1))
    winner = torch.where(hit, idx, n).amin(dim=dim, keepdim=True)
    if h.dtype in _UNSIGNED:
        value = from_int64(key.gather(dim, winner), h.dtype)
    else:
        # a tie of -0.0 and +0.0 pools to +0.0 (IEEE maximum, as jnp.max)
        value = h.gather(dim, winner)
        pos_zero = ((h == 0) & ~torch.signbit(h)).any(dim=dim, keepdim=True)
        value = torch.where((value == 0) & pos_zero, torch.zeros_like(value),
                            value)
    return value.squeeze(dim), winner.squeeze(dim).to(torch.int32)


class PoolDecode(NamedTuple):
    """What :func:`maxpool_decode` writes; an output not asked for is
    None."""

    pooled: torch.Tensor                # floats of the asked dtype
    max_code: Optional[torch.Tensor]    # codes' dtype
    argmax: Optional[torch.Tensor]      # int32
    correct: Optional[torch.Tensor]     # bool


def pool_layout(codes: torch.Tensor, dim: int):
    """(batch, workers, elements) of ``codes`` pooled over ``dim``, and the
    shape of one output: the axes before ``dim`` are the batch, those after
    it the pooled elements."""
    dim = dim % codes.ndim
    return (math.prod(codes.shape[:dim]), codes.shape[dim],
            math.prod(codes.shape[dim + 1:]),
            codes.shape[:dim] + codes.shape[dim + 1:])


def check_mask(mask: torch.Tensor, batch: int, n: int) -> None:
    if mask.shape not in ((n,), (batch, n)):
        raise ValueError(f"mask must be ({n},) or ({batch}, {n}), got "
                         f"{tuple(mask.shape)}")


def maxpool_decode(codes: torch.Tensor, bits: int, dtype: torch.dtype, *,
                   mask: Optional[torch.Tensor] = None,
                   winner: Optional[torch.Tensor] = None, dim: int = 1,
                   max_code: bool = False, argmax: bool = False,
                   correct: bool = False,
                   out: Optional[PoolDecode] = None) -> PoolDecode:
    """Pool D-bit ``codes`` over the worker axis ``dim`` and decode.

    ``codes`` may be the float features themselves, whose D-bit codes are
    pooled.  A worker whose ``mask`` ((N,) or (batch, N) bool) is False
    counts as code 0, as ``jnp.max(jnp.where(mask, codes, 0))``;
    ``max_code`` is the max, ``argmax`` its first index.  With ``winner``
    (int32, the output's shape) ``pooled`` decodes the winner's own code
    and ``correct`` says whether it equals the max; without, ``pooled``
    decodes the max.  The fields of ``out`` that are not None are written
    in place."""
    if correct and winner is None:
        raise ValueError("correct compares the winner's code: pass winner")
    if codes.is_floating_point():
        codes = encode(codes, bits)
    batch, n, e, out_shape = pool_layout(codes, dim)
    c64 = to_int64(codes).reshape(batch, n, e)
    masked = c64
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=torch.bool, device=codes.device)
        check_mask(mask, batch, n)
        masked = torch.where(mask.expand(batch, n)[:, :, None], c64, 0)
    best, arg = maxpool_fused(from_int64(masked, codes.dtype), 1)
    picked = best
    if winner is not None:
        sel = c64.gather(1, winner.reshape(batch, 1, e).long())[:, 0]
        picked = from_int64(sel, codes.dtype)
    pooled = decode(picked, bits, dtype)
    res = PoolDecode(
        pooled=pooled.reshape(out_shape),
        max_code=best.reshape(out_shape) if max_code else None,
        argmax=arg.reshape(out_shape) if argmax else None,
        correct=(sel == to_int64(best)).reshape(out_shape) if correct
        else None)
    if out is None:
        return res
    return PoolDecode(*(a if o is None or a is None else o.copy_(a)
                        for a, o in zip(res, out)))


def maxpool_winner_bwd(winner: torch.Tensor, g: torch.Tensor, n: int,
                       dim: int = 0) -> torch.Tensor:
    """Scatter ``g`` one-hot into the winner's row of a new axis ``dim``
    of size ``n`` (Eq. 6).  Other rows hold ``g * 0``, a zero with g's
    sign, as the pooling laws' ``g * onehot`` backward computes it (the
    TPU kernel writes +0.0 there)."""
    dim = dim % (g.ndim + 1)
    idx = torch.arange(n, device=g.device, dtype=torch.int32).reshape(
        (n,) + (1,) * (g.ndim - dim))
    onehot = idx == winner.unsqueeze(dim)
    gx = g.unsqueeze(dim)
    return torch.where(onehot, gx, gx * 0)
