"""Plain PyTorch version of the worker max-pool kernels.

``maxpool_fused`` pools over ``dim``; the winner is the first maximum (NaN
above every number, as ``jnp.argmax``) and the value returned is the
winner's own element, except that a tie of -0.0 and +0.0 pools to +0.0,
as ``jnp.max`` does.  Unsigned codes are compared as int32, since PyTorch
has no reductions on ``uint16``.
"""

from __future__ import annotations

import torch

_UNSIGNED = (torch.uint8, torch.uint16)


def maxpool_fused(h: torch.Tensor, dim: int = 0):
    """h -> (pooled (h without ``dim``), winner int32 of the same shape)."""
    dim = dim % h.ndim
    key = h.to(torch.int32) if h.dtype in _UNSIGNED else h.float()
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
        value = h.to(torch.int32).gather(dim, winner).to(h.dtype)
    else:
        # a tie of -0.0 and +0.0 pools to +0.0 (IEEE maximum, as jnp.max)
        value = h.gather(dim, winner)
        pos_zero = ((h == 0) & ~torch.signbit(h)).any(dim=dim, keepdim=True)
        value = torch.where((value == 0) & pos_zero, torch.zeros_like(value),
                            value)
    return value.squeeze(dim), winner.squeeze(dim).to(torch.int32)


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
