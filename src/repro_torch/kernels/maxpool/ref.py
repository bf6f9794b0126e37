"""Plain PyTorch version of the worker max-pool kernels.

``maxpool_fused`` pools over ``dim``; the winner is the first maximum (NaN
above every number, as ``jnp.argmax``) and the value returned is the
winner's own element, except that a tie of -0.0 and +0.0 pools to +0.0,
as ``jnp.max`` does.  Unsigned codes are compared as int64, since PyTorch
has no reductions on ``uint16``/``uint32``.

``maxpool_ties`` is the pooled max with the tie mask of the
``tie_break="all"`` law, ``h == max`` packed 16 workers to a ``uint16``
word, and ``ties_bwd`` that law's backward from the mask,
``g * (h == max)``.  ``maxpool_fwd`` is the forward kernel's contract:
the pooled max with the winner, the mask, both or neither.

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
        # the winner's own bits (a float gather may rewrite a NaN's); a
        # tie of -0.0 and +0.0 pools to +0.0 (IEEE maximum, as jnp.max)
        words = torch.int16 if h.element_size() == 2 else torch.int32
        value = h.view(words).gather(dim, winner).view(h.dtype)
        pos_zero = ((h == 0) & ~torch.signbit(h)).any(dim=dim, keepdim=True)
        value = torch.where((value == 0) & pos_zero, torch.zeros_like(value),
                            value)
    return value.squeeze(dim), winner.squeeze(dim).to(torch.int32)


TIE_BITS = 16
"""Workers per tie-mask word: the mask of ``n`` workers pooled over axis
``dim`` has ``ceil(n / 16)`` ``uint16`` words in place of that axis, bit
``r`` of word ``w`` for worker ``16 w + r``."""


def tie_words(n: int) -> int:
    return -(-n // TIE_BITS)


def maxpool_ties(h: torch.Tensor, dim: int = 0):
    """h -> (pooled max over ``dim``, tie mask): bit k set where ``h[k] ==
    max``, compared as ``h``'s values (-0.0 and +0.0 tie; a NaN max ties
    no worker) or, for unsigned codes, as integers."""
    pooled = maxpool_fused(h, dim)[0]
    return pooled, _tie_mask(h, pooled, dim % h.ndim)


def _tie_mask(h: torch.Tensor, pooled: torch.Tensor,
              dim: int) -> torch.Tensor:
    n = h.shape[dim]
    if h.dtype in _UNSIGNED:
        tied = to_int64(h) == to_int64(pooled).unsqueeze(dim)
    else:
        tied = h == pooled.unsqueeze(dim)
    # pad the worker axis to whole words, then weigh each bit
    pad = tie_words(n) * TIE_BITS - n
    tied = torch.cat([tied, tied.new_zeros(tied.shape[:dim] + (pad,)
                                           + tied.shape[dim + 1:])], dim)
    words = tied.reshape(tied.shape[:dim] + (-1, TIE_BITS)
                         + tied.shape[dim + 1:]).to(torch.int64)
    weight = (1 << torch.arange(TIE_BITS, device=h.device)).reshape(
        (TIE_BITS,) + (1,) * (h.ndim - dim - 1))
    return from_int64((words * weight).sum(dim + 1), torch.uint16)


def ties_bwd(ties: torch.Tensor, g: torch.Tensor, n: int,
             dim: int = 0) -> torch.Tensor:
    """The ``"all"`` law's backward from the tie mask: a new axis ``dim``
    of size ``n``, ``g`` in the rows whose bit is set and ``g * 0`` (a
    zero with g's sign, NaN for a non-finite g) elsewhere, as ``g * (h ==
    max)`` computes it."""
    dim = dim % (g.ndim + 1)
    k = torch.arange(n, device=g.device)
    words = to_int64(ties).index_select(dim, k // TIE_BITS)
    shift = (k % TIE_BITS).reshape((n,) + (1,) * (g.ndim - dim))
    hit = ((words >> shift) & 1) == 1
    gx = g.unsqueeze(dim)
    return torch.where(hit, gx, gx * 0)


class PoolFwd(NamedTuple):
    """What :func:`maxpool_fwd` writes; an output not asked for is None."""

    pooled: torch.Tensor                # h's dtype
    winner: Optional[torch.Tensor]      # int32, the first argmax
    ties: Optional[torch.Tensor]        # uint16 tie-mask words


def maxpool_fwd(h: torch.Tensor, dim: int = 0, *, winner: bool = True,
                ties: bool = False) -> PoolFwd:
    """The pooled max over ``dim`` with the first argmax and the tie mask
    where asked."""
    pooled, arg = maxpool_fused(h, dim)
    return PoolFwd(pooled, arg if winner else None,
                   _tie_mask(h, pooled, dim % h.ndim) if ties else None)


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
