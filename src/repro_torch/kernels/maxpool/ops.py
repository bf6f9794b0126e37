"""Wrappers of the worker max-pool kernels (``csrc/maxpool.cu``).

Each takes the plain version (``ref.py``) for a tensor on the CPU and
launches the CUDA kernel for a tensor on the card.  The pooled axis is
``dim``; the axes before it are a batch (the p_miss lanes) and the axes
after it are the pooled elements, so the kernels see a ``(B, N, E)``
layout.  Each takes a fake tensor (a trace, either device) through a
custom op (``repro_torch::maxpool_fwd``, ``maxpool_ties_bwd``,
``maxpool_decode``, ``maxpool_winner_bwd``) whose fake impl gives its
outputs alone, shapes, types and strides; real tensors take the direct
path, since a custom op's first call in a process costs seconds of
imports.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch import kernels
from repro_torch.kernels.maxpool import ref
from repro_torch.kernels.ocs_quant.ref import code_dtype

MAX_DECODE_BITS = 16

_FWD_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.uint8,
               torch.uint16)
_BWD_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _fwd_shapes(h: torch.Tensor, dim: int, winner: bool, ties: bool):
    """(shape, dtype) of each output the forward writes, in order."""
    out = h.shape[:dim] + h.shape[dim + 1:]
    words = h.shape[:dim] + (ref.tie_words(h.shape[dim]),) + h.shape[dim + 1:]
    return ([(out, h.dtype)] + [(out, torch.int32)] * winner
            + [(words, torch.uint16)] * ties)


@torch.library.custom_op("repro_torch::maxpool_fwd", mutates_args=(),
                         device_types="cpu")
def _fwd(h: torch.Tensor, dim: int, winner: bool,
         ties: bool) -> List[torch.Tensor]:
    res = ref.maxpool_fwd(h, dim, winner=winner, ties=ties)
    return [t.contiguous() for t in res if t is not None]


def _check_fwd(h: torch.Tensor) -> None:
    if h.dtype not in _FWD_DTYPES:
        raise ValueError(f"maxpool kernel takes {_FWD_DTYPES}, got {h.dtype}")
    kernels.check_cuda(h)


@_fwd.register_kernel("cuda")
def _fwd_kernel(h, dim, winner, ties):
    _check_fwd(h)
    h = h.contiguous()
    res = [torch.empty(shape, dtype=dt, device=h.device)
           for shape, dt in _fwd_shapes(h, dim, winner, ties)]
    kernels.check_operands(h, *res)
    it = iter(res[1:])
    kernels.launch("maxpool.fwd", "maxpool_fwd", h.device, h.data_ptr(),
                   res[0].data_ptr(),
                   next(it).data_ptr() if winner else None,
                   next(it).data_ptr() if ties else None,
                   math.prod(h.shape[:dim]), h.shape[dim],
                   math.prod(h.shape[dim + 1:]), kernels.KIND[h.dtype])
    return res


@_fwd.register_fake
def _(h, dim, winner, ties):
    return [h.new_empty(shape, dtype=dt)
            for shape, dt in _fwd_shapes(h, dim, winner, ties)]


def maxpool_fwd(h: torch.Tensor, dim: int = 0, *, winner: bool = True,
                ties: bool = False) -> ref.PoolFwd:
    """h -> the pooled max over ``dim`` and, where asked, the first argmax
    (int32) and the tie mask (``ceil(n / 16)`` uint16 words in place of
    ``dim``; see ``ref.maxpool_ties``), in one launch that writes only
    those."""
    dim = dim % h.ndim
    if is_fake(h):
        got = iter(_fwd(h, dim, winner, ties))
    elif h.device.type == "cpu":
        return ref.maxpool_fwd(h, dim, winner=winner, ties=ties)
    else:
        got = iter(_fwd_kernel(h, dim, winner, ties))
    return ref.PoolFwd(next(got), next(got) if winner else None,
                       next(got) if ties else None)


def maxpool_fused(h: torch.Tensor, dim: int = 0):
    """h -> (pooled max over ``dim``, first argmax int32)."""
    return tuple(maxpool_fwd(h, dim)[:2])


def maxpool_ties(h: torch.Tensor, dim: int = 0):
    """h -> (pooled max over ``dim``, tie mask): the ``tie_break="all"``
    law's forward, one launch that writes no winner."""
    out = maxpool_fwd(h, dim, winner=False, ties=True)
    return out.pooled, out.ties


def _check_decode(codes: torch.Tensor, bits: int, dtype: torch.dtype,
                  mask: Optional[torch.Tensor], winner: Optional[torch.Tensor],
                  dim: int, correct: bool):
    """What the decode kernel takes; returns the contiguous operands, the
    mask's lane stride and the pooled layout."""
    if dtype not in _BWD_DTYPES:
        raise ValueError(f"maxpool decode writes {_BWD_DTYPES}, got {dtype}")
    floats = codes.is_floating_point()
    if floats and codes.dtype not in _BWD_DTYPES:
        raise ValueError(f"maxpool decode reads floats of {_BWD_DTYPES}, "
                         f"got {codes.dtype}")
    top = min(MAX_DECODE_BITS, 8 * dtype.itemsize,
              8 * codes.element_size() if floats else MAX_DECODE_BITS)
    if not 1 <= bits <= top:
        raise ValueError(f"maxpool decode takes codes of 1 to "
                         f"{MAX_DECODE_BITS} bits, got bits={bits}")
    if not floats and codes.dtype != code_dtype(bits):
        raise ValueError(f"{bits}-bit codes are {code_dtype(bits)}, got "
                         f"{codes.dtype}")
    if correct and winner is None:
        raise ValueError("correct compares the winner's code: pass winner")
    batch, n, e, out_shape = ref.pool_layout(codes, dim)
    mask_stride = 0
    if mask is not None:
        if mask.dtype != torch.bool:
            raise ValueError(f"mask must be bool, got {mask.dtype}")
        if mask.ndim == 2 and mask.stride(0) == 0:
            mask = mask[0]                  # one (N,) row expanded over lanes
        ref.check_mask(mask, batch, n)
        mask = mask.contiguous()
        mask_stride = 0 if mask.ndim == 1 else n
    if winner is not None:
        if winner.dtype != torch.int32 or winner.shape != out_shape:
            raise ValueError(f"winner must be int32 of shape {out_shape}, "
                             f"got {winner.dtype} {tuple(winner.shape)}")
        winner = winner.contiguous()
    return (codes.contiguous(), mask, mask_stride, winner,
            (batch, n, e, out_shape))


def _decode_kernel(codes, bits, dtype, mask, winner, dim, max_code, argmax,
                   correct, out: Optional[ref.PoolDecode]) -> ref.PoolDecode:
    """One launch of the decode kernel on CUDA tensors, writing the fields
    of ``out`` that are not None."""
    codes, mask, mask_stride, winner, (batch, n, e, out_shape) = \
        _check_decode(codes, bits, dtype, mask, winner, dim, correct)
    operands = [t for t in (codes, mask, winner) if t is not None]
    given = out if out is not None else ref.PoolDecode(None, None, None,
                                                       None)
    wants = (True, max_code, argmax, correct)
    dtypes = (dtype, code_dtype(bits), torch.int32, torch.bool)

    def output(want: bool, dt: torch.dtype, t: Optional[torch.Tensor]):
        if not want:
            return None
        if t is None:
            return torch.empty(out_shape, dtype=dt, device=codes.device)
        if t.shape != out_shape or t.dtype != dt:
            raise ValueError(f"out tensors are {dt} of shape {out_shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        return t

    res = ref.PoolDecode(*map(output, wants, dtypes, given))
    operands += [t for t in res if t is not None]
    kernels.check_operands(*operands)

    def ptr(t: Optional[torch.Tensor]):
        return None if t is None else t.data_ptr()

    kernels.launch("maxpool.decode", "maxpool_decode", codes.device,
                   codes.data_ptr(), ptr(mask), mask_stride, ptr(winner),
                   *map(ptr, res), batch, n, e, kernels.KIND[codes.dtype],
                   kernels.KIND[dtype], bits)
    return res


@torch.library.custom_op("repro_torch::maxpool_decode", mutates_args=(),
                         device_types="cpu")
def _decode(codes: torch.Tensor, bits: int, dtype: torch.dtype,
            mask: Optional[torch.Tensor], winner: Optional[torch.Tensor],
            dim: int, max_code: bool, argmax: bool,
            correct: bool) -> List[torch.Tensor]:
    res = ref.maxpool_decode(codes, bits, dtype, mask=mask, winner=winner,
                             dim=dim, max_code=max_code, argmax=argmax,
                             correct=correct)
    return [t.contiguous() for t in res if t is not None]


@_decode.register_kernel("cuda")
def _(codes, bits, dtype, mask, winner, dim, max_code, argmax, correct):
    return [t for t in _decode_kernel(codes, bits, dtype, mask, winner, dim,
                                      max_code, argmax, correct, None)
            if t is not None]


@_decode.register_fake
def _(codes, bits, dtype, mask, winner, dim, max_code, argmax, correct):
    if codes.device.type != "cpu":
        _check_decode(codes, bits, dtype, mask, winner, dim, correct)
    elif correct and winner is None:
        raise ValueError("correct compares the winner's code: pass winner")
    out_shape = ref.pool_layout(codes, dim)[3]
    kinds = ([dtype] + [code_dtype(bits)] * max_code + [torch.int32] * argmax
             + [torch.bool] * correct)
    return [codes.new_empty(out_shape, dtype=dt) for dt in kinds]


def maxpool_decode(codes: torch.Tensor, bits: int, dtype: torch.dtype, *,
                   mask: Optional[torch.Tensor] = None,
                   winner: Optional[torch.Tensor] = None, dim: int = 1,
                   max_code: bool = False, argmax: bool = False,
                   correct: bool = False,
                   out: Optional[ref.PoolDecode] = None) -> ref.PoolDecode:
    """D-bit codes, or the float features whose codes the kernel forms as
    it loads them -> their pooled max over ``dim`` decoded to ``dtype``, in
    one launch: ``pooled`` always, ``max_code``/``argmax``/``correct`` only
    where asked (see ``ref.maxpool_decode``).  Codes of at most 16 bits, as
    the code kernels.  The fields of ``out`` that are not None are
    contiguous tensors of the output's shape that the kernel writes in
    place of new ones (on a fake tensor, the custom op's outputs are
    copied into them)."""
    if is_fake(codes):
        if mask is not None:
            mask = torch.as_tensor(mask, device=codes.device)
        got = iter(_decode(codes, bits, dtype, mask, winner, dim % codes.ndim,
                           max_code, argmax, correct))
        res = ref.PoolDecode(*(next(got) if want else None for want in
                               (True, max_code, argmax, correct)))
        if out is None:
            return res
        return ref.PoolDecode(*(a if o is None or a is None else o.copy_(a)
                                for a, o in zip(res, out)))
    if codes.device.type == "cpu":
        return ref.maxpool_decode(codes, bits, dtype, mask=mask,
                                  winner=winner, dim=dim, max_code=max_code,
                                  argmax=argmax, correct=correct, out=out)
    return _decode_kernel(codes, bits, dtype, mask, winner, dim, max_code,
                          argmax, correct, out)


def _check_winner_bwd(winner: torch.Tensor, g: torch.Tensor) -> None:
    if g.dtype not in _BWD_DTYPES:
        raise ValueError(f"winner bwd takes {_BWD_DTYPES}, got {g.dtype}")
    if winner.dtype != torch.int32 or winner.shape != g.shape:
        raise ValueError(f"winner must be int32 of g's shape {g.shape}, got "
                         f"{winner.dtype} {winner.shape}")


@torch.library.custom_op("repro_torch::maxpool_winner_bwd", mutates_args=(),
                         device_types="cpu")
def _winner_bwd(winner: torch.Tensor, g: torch.Tensor, n: int,
                dim: int) -> torch.Tensor:
    return ref.maxpool_winner_bwd(winner, g, n, dim).contiguous()


@_winner_bwd.register_kernel("cuda")
def _winner_bwd_kernel(winner, g, n, dim):
    _check_winner_bwd(winner, g)
    g, winner = g.contiguous(), winner.contiguous()
    out = torch.empty(g.shape[:dim] + (n,) + g.shape[dim:], dtype=g.dtype,
                      device=g.device)
    kernels.check_operands(winner, g, out)
    kernels.launch("maxpool.winner_bwd", "maxpool_winner_bwd", g.device,
                   winner.data_ptr(), g.data_ptr(), out.data_ptr(),
                   math.prod(g.shape[:dim]), n, math.prod(g.shape[dim:]),
                   kernels.KIND[g.dtype])
    return out


@_winner_bwd.register_fake
def _(winner, g, n, dim):
    if g.device.type != "cpu":
        _check_winner_bwd(winner, g)
    return g.new_empty(g.shape[:dim] + (n,) + g.shape[dim:])


def maxpool_winner_bwd(winner: torch.Tensor, g: torch.Tensor, n: int,
                       dim: int = 0) -> torch.Tensor:
    """(winner int32, g) -> gradient with a new worker axis ``dim`` of
    size ``n``: g in the winner's row, ``g * 0`` elsewhere (see ``ref``)."""
    dim = dim % (g.ndim + 1)
    if is_fake(g):
        return _winner_bwd(winner, g, n, dim)
    if g.device.type == "cpu":
        return ref.maxpool_winner_bwd(winner, g, n, dim)
    return _winner_bwd_kernel(winner, g, n, dim)


@torch.library.custom_op("repro_torch::maxpool_ties_bwd", mutates_args=(),
                         device_types="cpu")
def _ties_bwd(ties: torch.Tensor, g: torch.Tensor, n: int,
              dim: int) -> torch.Tensor:
    return ref.ties_bwd(ties, g, n, dim).contiguous()


def _check_ties_bwd(ties: torch.Tensor, g: torch.Tensor, n: int,
                    dim: int) -> None:
    if g.dtype not in _BWD_DTYPES:
        raise ValueError(f"ties bwd takes {_BWD_DTYPES}, got {g.dtype}")
    words = g.shape[:dim] + (ref.tie_words(n),) + g.shape[dim:]
    if ties.dtype != torch.uint16 or ties.shape != words:
        raise ValueError(f"ties must be uint16 of shape {tuple(words)}, got "
                         f"{ties.dtype} {tuple(ties.shape)}")
    kernels.check_cuda(ties, g)


@_ties_bwd.register_kernel("cuda")
def _ties_bwd_kernel(ties, g, n, dim):
    _check_ties_bwd(ties, g, n, dim)
    g, ties = g.contiguous(), ties.contiguous()
    out = torch.empty(g.shape[:dim] + (n,) + g.shape[dim:], dtype=g.dtype,
                      device=g.device)
    kernels.check_operands(ties, g, out)
    kernels.launch("maxpool.ties_bwd", "maxpool_ties_bwd", g.device,
                   ties.data_ptr(), g.data_ptr(), out.data_ptr(),
                   math.prod(g.shape[:dim]), n, math.prod(g.shape[dim:]),
                   kernels.KIND[g.dtype])
    return out


@_ties_bwd.register_fake
def _(ties, g, n, dim):
    return g.new_empty(g.shape[:dim] + (n,) + g.shape[dim:])


def maxpool_ties_bwd(ties: torch.Tensor, g: torch.Tensor, n: int,
                     dim: int = 0) -> torch.Tensor:
    """(tie mask, g) -> gradient with a new worker axis ``dim`` of size
    ``n``: g in the tied rows, ``g * 0`` elsewhere (see ``ref.ties_bwd``)."""
    dim = dim % (g.ndim + 1)
    if is_fake(g):
        return _ties_bwd(ties, g, n, dim)
    if g.device.type == "cpu":
        return ref.ties_bwd(ties, g, n, dim)
    return _ties_bwd_kernel(ties, g, n, dim)
