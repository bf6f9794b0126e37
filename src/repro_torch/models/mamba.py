"""Mamba (S6 selective state-space) mixer of jamba-1.5's hybrid layers, the
JAX package's ``models/mamba.py``.

Channel-parallel layout: ``d_inner`` is split over the worker axis.
Everything between the in- and the out-projection (depthwise conv, the
dt/B/C projections, the selective scan) is per channel, so per worker;
the out-projection is worker-factored and fuses through
:func:`repro_torch.models.fusion.worker_reduce`, as an MLP's
down-projection does.

The recurrence ``h_t = a_t * h_{t-1} + b_t`` runs as a Python loop over
time in the JAX ``lax.scan`` body's order by default; ``cfg.mamba_assoc_scan``
takes the JAX package's ``jax.lax.associative_scan`` form instead, whose
odd/even recursion :func:`_assoc_scan` follows pair for pair.  No kernel
backs either: the JAX package has none.

Decode keeps (the conv window, the SSM state) in the cache: O(1) per token.

Under a mesh whose model axis splits the workers, a rank holds its
workers' block of every leaf (``A_log`` and ``D`` too) and of the
``conv`` and ``h`` caches, and runs the mixer on them; the input enters
the in-projection behind the model group's *f* copy.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import fusion, layers


def mamba_init(cfg, gen: torch.Generator) -> dict:
    n, di = cfg.n_workers, cfg.d_inner
    assert di % n == 0, (cfg.name, di, n)
    dl = di // n                       # channels per worker
    st, dr = cfg.ssm_state_dim, cfg.dt_rank_
    pdt = cfg.param_dtype
    p = {
        # in-proj -> (x, z), the channels split over the workers
        "w_in": layers.param(gen, (n, cfg.d_model, 2 * dl), pdt,
                             scale=cfg.d_model ** -0.5),
        # depthwise causal conv over time
        "w_conv": layers.param(gen, (n, dl, cfg.conv_width), pdt,
                               scale=1.0 / cfg.conv_width),
        "b_conv": layers.param(gen, (n, dl), pdt, mode="zeros"),
        # x -> (dt_rank, B, C)
        "w_xdbc": layers.param(gen, (n, dl, dr + 2 * st), pdt,
                               scale=dl ** -0.5),
        # dt_rank -> channels (the dt up-projection)
        "w_dt": layers.param(gen, (n, dr, dl), pdt, scale=dr ** -0.5),
        "b_dt": layers.param(gen, (n, dl), pdt, mode="zeros"),
        "A_log": a_log_init(n, dl, st, gen.device),
        "D": layers.param(gen, (n, dl), pdt, mode="ones"),
        "w_out": layers.param(gen, (n, dl, cfg.d_model), pdt,
                              scale=di ** -0.5),
    }
    p.update(fusion.fusion_init(cfg, gen, cfg.d_model))
    return p


def mamba_axes(cfg) -> dict:
    """:func:`mamba_init`'s logical axes."""
    p = {"w_in": ("worker", "embed", "ff_local"),
         "w_conv": ("worker", "ff_local", "conv"),
         "b_conv": ("worker", "ff_local"),
         "w_xdbc": ("worker", "ff_local", None),
         "w_dt": ("worker", None, "ff_local"),
         "b_dt": ("worker", "ff_local"),
         "A_log": ("worker", "ff_local", "state"),
         "D": ("worker", "ff_local"),
         "w_out": ("worker", "ff_local", "embed")}
    p.update(fusion.fusion_axes(cfg))
    return p


def a_log_init(n: int, dl: int, st: int, device=None) -> torch.Tensor:
    """S4D-real initialisation: A = -(1..st) per channel, stored as its
    log, float32 whatever ``param_dtype`` is (the JAX ``Tagged_A``)."""
    a = torch.arange(1, st + 1, dtype=torch.float32, device=device)
    return torch.log(a)[None, None, :].repeat(n, dl, 1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """x: (N, B, S, C) depthwise causal conv, w: (N, C, W)."""
    width, s = w.shape[-1], x.shape[2]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + pad[:, :, i:i + s, :] * w[:, None, None, :, i]
    return out + b[:, None, None, :]


def _combine(left, right):
    """The associative operator of ``h_t = a_t h_{t-1} + b_t``: the JAX
    package's ``comb``."""
    al, bl = left
    ar, br = right
    return al * ar, ar * bl + br


def _along(x: torch.Tensor, axis: int, sl: slice) -> torch.Tensor:
    return x[(slice(None),) * axis + (sl,)]


def _interleave(even: torch.Tensor, odd: torch.Tensor,
                axis: int) -> torch.Tensor:
    """even at 0, 2, 4, ... and odd at 1, 3, ... along ``axis``."""
    n_odd = odd.shape[axis]
    pairs = torch.stack((_along(even, axis, slice(0, n_odd)), odd),
                        axis + 1).flatten(axis, axis + 1)
    if even.shape[axis] == n_odd:
        return pairs
    return torch.cat((pairs, _along(even, axis, slice(n_odd, None))), axis)


def _assoc_scan(a: torch.Tensor, b: torch.Tensor, axis: int):
    """``jax.lax.associative_scan(_combine, (a, b), axis=axis)``: the same
    recursion (adjacent pairs combined, the half scanned, the even
    elements completed from the odd ones), so the same pairs combine in
    the same order."""
    n = a.shape[axis]
    if n < 2:
        return a, b
    first, second = slice(0, -1, 2), slice(1, None, 2)
    odd = _assoc_scan(*_combine((_along(a, axis, first),
                                 _along(b, axis, first)),
                                (_along(a, axis, second),
                                 _along(b, axis, second))), axis)
    if n % 2 == 0:
        odd_head = tuple(_along(e, axis, slice(0, -1)) for e in odd)
    else:
        odd_head = odd
    rest = slice(2, None, 2)
    even = _combine(odd_head, (_along(a, axis, rest), _along(b, axis, rest)))
    even = tuple(torch.cat((_along(e0, axis, slice(0, 1)), e), axis)
                 for e0, e in zip((a, b), even))
    return tuple(_interleave(e, o, axis) for e, o in zip(even, odd))


def _ssm_scan(cfg, a: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
              h0: Optional[torch.Tensor]):
    """The linear recurrence h_t = a_t * h_{t-1} + bx_t; y_t = sum_s c_t h_t.

    a, bx: (N, B, S, C, St); c: (N, B, S, St).  Returns y (N, B, S, C) and
    the last state."""
    if cfg.mamba_assoc_scan and h0 is None:
        _, hh = _assoc_scan(a, bx, axis=2)
        y = torch.einsum("nbsct,nbst->nbsc", hh, c)
        return y, hh[:, :, -1]
    n, b, _, ch, st = a.shape
    h = (torch.zeros((n, b, ch, st), dtype=a.dtype, device=a.device)
         if h0 is None else h0)
    ys = []
    # unbind: its backward stacks the steps' gradients once
    for at, bxt, ct in zip(a.unbind(2), bx.unbind(2), c.unbind(2)):
        h = at * h + bxt
        ys.append(torch.einsum("nbct,nbt->nbc", h, ct))
    return torch.stack(ys, 2), h


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): max(x, 0) +
    log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def _per_worker(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("nbsc,ncr->nbsr", x, w) as one product batched over the
    workers (no copy of ``w``)."""
    n, b, s, c = x.shape
    return torch.matmul(x.reshape(n, b * s, c), w).reshape(n, b, s, -1)


def _ssm_inner(cfg, p, xc: torch.Tensor, h0):
    """xc: (N, B, S, C) post-conv activations -> (y, h_last)."""
    d = cfg.dtype
    st, dr = cfg.ssm_state_dim, cfg.dt_rank_
    dbc = _per_worker(xc, p["w_xdbc"].to(d))                 # (N,B,S,r+2St)
    dt_low, bmat, cmat = torch.split(dbc, [dr, st, st], dim=-1)
    dt = _softplus(_per_worker(dt_low, p["w_dt"].to(d))
                   + p["b_dt"].to(d)[:, None, None, :])      # (N, B, S, C)
    a_mat = -torch.exp(p["A_log"].float())                   # (N, C, St)
    a_disc = torch.exp(dt.float()[..., None]
                       * a_mat[:, None, None])               # (N,B,S,C,St)
    bx = (dt * xc).float()[..., None] \
        * bmat.float()[:, :, :, None, :]                     # (N,B,S,C,St)
    y, h_last = _ssm_scan(cfg, a_disc, bx, cmat.float(), h0)
    y = y.to(d) + xc * p["D"].to(d)[:, None, None, :]
    return y, h_last


def _out(cfg, p, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The gated out-projection's worker partials, fused."""
    partial = fusion.worker_partial(y * F.silu(z), p["w_out"].to(cfg.dtype),
                                    "nbsc,ncd->nbsd")
    return fusion.worker_reduce(cfg, p, partial)


def _in_proj(cfg, p, x: torch.Tensor):
    """x (B, S, d) -> (xraw, z), each (N, B, S, C)."""
    b, s, e = x.shape
    (x,) = fusion.copy_in(fusion.worker_axis(cfg, p["w_in"].shape[0]), x)
    xi = torch.matmul(x.reshape(1, b * s, e), p["w_in"].to(cfg.dtype))
    return xi.reshape(-1, b, s, xi.shape[-1]).chunk(2, dim=-1)


def mamba_full(cfg, p: dict, x: torch.Tensor, return_cache: bool = False):
    """Training / prefill path. x: (B, S, d) -> (B, S, d); with
    ``return_cache`` also the decode cache: the last ``conv_width - 1``
    rows of the conv input (so S >= conv_width - 1) and the last state."""
    d = cfg.dtype
    xraw, z = _in_proj(cfg, p, x)
    xc = F.silu(_causal_conv(xraw, p["w_conv"].to(d), p["b_conv"].to(d)))
    y, h_last = _ssm_inner(cfg, p, xc, None)
    out = _out(cfg, p, y, z)
    if return_cache:
        w = cfg.conv_width
        return out, {"conv": xraw[:, :, -(w - 1):, :], "h": h_last}
    return out


MAMBA_CACHE_AXES = {
    "conv": ("worker", "batch", None, "ff_local"),
    "h": ("worker", "batch", "ff_local", "state"),
}


def init_cache(cfg, batch: int, dtype, device=None) -> dict:
    """The conv window and the SSM state of the active mesh's share of
    the workers (all of them without one)."""
    n = fusion.local_workers(cfg)
    dl = cfg.d_inner // cfg.n_workers
    return {
        "conv": torch.zeros((n, batch, cfg.conv_width - 1, dl), dtype=dtype,
                            device=device),
        "h": torch.zeros((n, batch, dl, cfg.ssm_state_dim),
                         dtype=torch.float32, device=device),
    }


def mamba_step(cfg, p: dict, x: torch.Tensor, cache: dict):
    """Decode step. x: (B, 1, d) -> ((B, 1, d), new cache); O(1) state
    update."""
    d = cfg.dtype
    xraw, z = _in_proj(cfg, p, x)                            # (N, B, 1, C)
    # conv window: (N, B, W-1, C) ++ the current row
    win = torch.cat([cache["conv"], xraw], dim=2)
    w = p["w_conv"].to(d)                                    # (N, C, W)
    xc = torch.einsum("nbwc,ncw->nbc", win, w) + p["b_conv"].to(d)[:, None]
    xc = F.silu(xc)[:, :, None, :]                           # (N, B, 1, C)
    y, h_last = _ssm_inner(cfg, p, xc, cache["h"])
    return _out(cfg, p, y, z), {"conv": win[:, :, 1:], "h": h_last}
