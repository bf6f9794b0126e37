"""Wrappers of the worker max-pool kernels (``csrc/maxpool.cu``).

Both take the plain version (``ref.py``) for a tensor on the CPU and launch
the CUDA kernel for a tensor on the card.  The pooled axis is ``dim``; the
axes before it are a batch (the p_miss lanes) and the axes after it are
the pooled elements, so the kernels see a ``(B, N, E)`` layout.
"""

from __future__ import annotations

import math

import torch

from repro_torch import kernels
from repro_torch.kernels.maxpool import ref

_FWD_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.uint8,
               torch.uint16)
_BWD_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def maxpool_fused(h: torch.Tensor, dim: int = 0):
    """h -> (pooled max over ``dim``, first argmax int32)."""
    if h.device.type == "cpu":
        return ref.maxpool_fused(h, dim)
    if h.dtype not in _FWD_DTYPES:
        raise ValueError(f"maxpool kernel takes {_FWD_DTYPES}, got {h.dtype}")
    dim = dim % h.ndim
    h = h.contiguous()
    out_shape = h.shape[:dim] + h.shape[dim + 1:]
    v = torch.empty(out_shape, dtype=h.dtype, device=h.device)
    w = torch.empty(out_shape, dtype=torch.int32, device=h.device)
    kernels.check_operands(h, v, w)
    kernels.launch("maxpool.fwd", "maxpool_fwd", h.device,
                   h.data_ptr(), v.data_ptr(), w.data_ptr(),
                   math.prod(h.shape[:dim]), h.shape[dim],
                   math.prod(h.shape[dim + 1:]), kernels.KIND[h.dtype])
    return v, w


def maxpool_winner_bwd(winner: torch.Tensor, g: torch.Tensor, n: int,
                       dim: int = 0) -> torch.Tensor:
    """(winner int32, g) -> gradient with a new worker axis ``dim`` of
    size ``n``: g in the winner's row, ``g * 0`` elsewhere (see ``ref``)."""
    if g.device.type == "cpu":
        return ref.maxpool_winner_bwd(winner, g, n, dim)
    if g.dtype not in _BWD_DTYPES:
        raise ValueError(f"winner bwd takes {_BWD_DTYPES}, got {g.dtype}")
    if winner.dtype != torch.int32 or winner.shape != g.shape:
        raise ValueError(f"winner must be int32 of g's shape {g.shape}, got "
                         f"{winner.dtype} {winner.shape}")
    dim = dim % (g.ndim + 1)
    g, winner = g.contiguous(), winner.contiguous()
    out = torch.empty(g.shape[:dim] + (n,) + g.shape[dim:], dtype=g.dtype,
                      device=g.device)
    kernels.check_operands(winner, g, out)
    kernels.launch("maxpool.winner_bwd", "maxpool_winner_bwd", g.device,
                   winner.data_ptr(), g.data_ptr(), out.data_ptr(),
                   math.prod(g.shape[:dim]), n, math.prod(g.shape[dim:]),
                   kernels.KIND[g.dtype])
    return out
