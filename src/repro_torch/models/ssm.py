"""xLSTM mixers (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM
(scalar memory), the JAX package's ``models/ssm.py``.

Layout, as in the JAX package: mLSTM's q/k are whole on every worker,
the *value* dimension of each head is split over the worker axis, so the
matrix memory ``C = v kᵀ`` is row-split, the read-out ``y = C q`` stays
per worker, and the down-projection is worker-factored and fuses through
:func:`repro_torch.models.fusion.worker_reduce` (under ``tp_fusion="max"``
the ``maxpool.fwd`` kernel).  The sLSTM recurrence is whole on every
worker and has no fusion site.

The time recurrences are Python loops over the sequence in the JAX
``lax.scan`` bodies' operations and float order (no kernel backs them:
the JAX package has none); mLSTM's loop keeps only what depends on the
carried memory (:func:`_mlstm_scan`).  Decode carries (C, n, m) / (h, c, n, m) in the
cache: O(1) per token.

Under a mesh whose model axis splits the workers, a rank holds its
workers' ``w_v`` and ``w_down`` and their rows of the memory ``C``; ``n``
and ``m`` stay whole on every rank (the JAX package's
``MLSTM_CACHE_AXES``).  Its read-out is its workers' share, so q, k, the
gates, the value projection's input and the output gate's z enter the
split work behind the model group's *f* copy, and the replicated
``w_up``/``w_q``/``w_k``/``w_gates`` get their whole gradients from the
group's sum.  The sLSTM runs whole on every rank.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import fusion, layers
from repro_torch.parallel import sharding

NEG_INIT = -1e9          # the stabiliser m's start: exp(m) is 0


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm_dims(cfg) -> Tuple[int, int, int, int, int]:
    """(N, d_inner, heads, head dim, head dim per worker)."""
    n, di, h = cfg.n_workers, cfg.d_inner, cfg.n_heads
    dh = di // h
    assert dh % n == 0, (cfg.name, dh, n)
    return n, di, h, dh, dh // n


def mlstm_init(cfg, gen: torch.Generator) -> dict:
    n, di, h, dh, dhl = _mlstm_dims(cfg)
    pdt = cfg.param_dtype
    p = {
        "w_up": layers.param(gen, (cfg.d_model, 2 * di), pdt,
                             scale=cfg.d_model ** -0.5),
        "w_q": layers.param(gen, (di, h, dh), pdt, scale=di ** -0.5),
        "w_k": layers.param(gen, (di, h, dh), pdt, scale=di ** -0.5),
        "w_v": layers.param(gen, (n, di, h, dhl), pdt, scale=di ** -0.5),
        "w_gates": layers.param(gen, (di, 2 * h), pdt, scale=di ** -0.5),
        "b_gates": layers.param(gen, (2 * h,), pdt, mode="zeros"),
        "w_down": layers.param(gen, (n, h * dhl, cfg.d_model), pdt,
                               scale=di ** -0.5),
    }
    p.update(fusion.fusion_init(cfg, gen, cfg.d_model))
    return p


def mlstm_axes(cfg) -> dict:
    """:func:`mlstm_init`'s logical axes."""
    p = {"w_up": ("embed", None), "w_q": (None, None, None),
         "w_k": (None, None, None), "w_v": ("worker", None, None, None),
         "w_gates": (None, None), "b_gates": (None,),
         "w_down": ("worker", None, "embed")}
    p.update(fusion.fusion_axes(cfg))
    return p


def _mlstm_scan(q, k, v, i_raw, f_raw, state):
    """Stabilised exponential-gated matrix-memory recurrence.

    q, k: (B, S, H, Dh) f32; v: (N, B, S, H, Dhl); i_raw, f_raw: (B, S, H).
    state: (C (N, B, H, Dhl, Dh), n (B, H, Dh), m (B, H)).
    Returns y (N, B, S, H, Dhl) and the new state.

    Every element goes through the JAX scan body's operations in its
    order; what does not depend on the carried memory is computed for all
    steps at once: the gates once the stabiliser chain m is known, the
    input terms ``ip (v kᵀ)`` and ``ip k``, and the normaliser from the
    stacked n.  The loop over time keeps the chain m (two (B, H) ops a
    step) and, a step, ``C = fp C + ip v kᵀ``, ``n = fp n + ip k`` and the
    read-out ``C q``."""
    f_log = F.logsigmoid(f_raw)
    c_mat, n_vec, m = state
    fm, ms = [], []
    for ft, it in zip(f_log.unbind(1), i_raw.unbind(1)):
        fm.append(ft + m)
        m = torch.maximum(fm[-1], it)
        ms.append(m)
    m_all = torch.stack(ms, 1)                             # (B, S, H)
    fp = torch.exp(torch.stack(fm, 1) - m_all)
    ip = torch.exp(i_raw - m_all)
    c_in = ip[None, :, :, :, None, None] * (v[..., None]
                                            * k[None, :, :, :, None, :])
    n_in = ip[..., None] * k                               # (B, S, H, Dh)
    ys, ns = [], []
    # unbind, not an index a step: its backward stacks the steps' gradients
    # once, where an index's writes a zero gradient of the whole tensor
    for fpt, ct, nt, qt in zip(fp.unbind(1), c_in.unbind(2), n_in.unbind(1),
                               q.unbind(1)):
        c_mat = fpt[None, :, :, None, None] * c_mat + ct
        n_vec = fpt[..., None] * n_vec + nt
        ys.append(torch.matmul(c_mat, qt[None, ..., None])[..., 0])
        ns.append(n_vec)
    denom = torch.clamp_min(torch.abs(torch.einsum(
        "bshd,bshd->bsh", torch.stack(ns, 1), q)), 1.0)
    y = torch.stack(ys, 2) / denom[None, :, :, :, None]
    return y, (c_mat, n_vec, m)


# (C, n, m): C worker-leading, its rows on axis 1
MLSTM_CACHE_AXES = (("worker", "batch", None, None, None),
                    ("batch", None, None), ("batch", None))


def mlstm_state_init(cfg, batch: int, device=None,
                     n_local: Optional[int] = None) -> Tuple:
    """(C, n, m) for ``batch`` rows; C holds ``n_local`` workers (the
    active mesh's share of them for ``None``)."""
    _, _, h, dh, dhl = _mlstm_dims(cfg)
    n = fusion.local_workers(cfg) if n_local is None else n_local
    f32 = torch.float32
    return (torch.zeros((n, batch, h, dhl, dh), dtype=f32, device=device),
            torch.zeros((batch, h, dh), dtype=f32, device=device),
            torch.full((batch, h), NEG_INIT, dtype=f32, device=device))


def _mlstm_core(cfg, p, x, state):
    d = cfg.dtype
    n_all, di, h, dh, dhl = _mlstm_dims(cfg)
    n = p["w_v"].shape[0]                          # this rank's workers
    axis = fusion.worker_axis(cfg, n)
    b, s, _ = x.shape
    up = torch.matmul(x, p["w_up"].to(d))                  # (B, S, 2di)
    xt, z = up.chunk(2, dim=-1)
    q = torch.einsum("bsd,dhk->bshk", xt, p["w_q"].to(d)).float()
    k = (torch.einsum("bsd,dhk->bshk", xt, p["w_k"].to(d))
         * (dh ** -0.5)).float()
    gates = (torch.matmul(xt, p["w_gates"].to(d))
             + p["b_gates"].to(d)).float()                 # (B, S, 2H)
    q, k, gates, xv, z = fusion.copy_in(axis, q, k, gates, xt, z)
    v = torch.einsum("bsd,ndhk->nbshk", xv, p["w_v"].to(d)).float()
    i_raw, f_raw = gates.chunk(2, dim=-1)
    y, state = _mlstm_scan(q, k, v, i_raw, f_raw, state)
    y = y.reshape(n, b, s, h * dhl).to(d)
    # the output gate: z grouped to match the worker-split feature layout,
    # this rank's workers of it
    zg = z.reshape(b, s, h, n_all, dhl).permute(3, 0, 1, 2, 4)
    zg = sharding.split_dim(zg, axis).reshape(n, b, s, h * dhl)
    y = y * F.silu(zg)
    partial = fusion.worker_partial(y, p["w_down"].to(d))
    return fusion.worker_reduce(cfg, p, partial), state


def mlstm_full(cfg, p: dict, x: torch.Tensor, return_cache: bool = False):
    state = mlstm_state_init(cfg, x.shape[0], x.device, p["w_v"].shape[0])
    out, state = _mlstm_core(cfg, p, x, state)
    return (out, state) if return_cache else out


def mlstm_step(cfg, p: dict, x: torch.Tensor, cache: Tuple):
    """x: (B, 1, d) -> (out, new state)."""
    return _mlstm_core(cfg, p, x, cache)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(cfg, gen: torch.Generator) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    pdt = cfg.param_dtype
    return {
        "w": layers.param(gen, (d, 4 * d), pdt, scale=d ** -0.5),
        "r": layers.param(gen, (h, dh, 4 * dh), pdt, scale=dh ** -0.5),
        "b": layers.param(gen, (4 * d,), pdt, mode="zeros"),
    }


def slstm_axes(cfg) -> dict:
    """:func:`slstm_init`'s logical axes."""
    return {"w": (None, None), "r": (None, None, None), "b": (None,)}


SLSTM_CACHE_AXES = (("batch", None), ("batch", None),
                    ("batch", None), ("batch", None))


def slstm_state_init(cfg, batch: int, device=None) -> Tuple:
    """(h, c, n, m): n starts at 1, m at ``NEG_INIT``."""
    shape, f32 = (batch, cfg.d_model), torch.float32
    z = torch.zeros(shape, dtype=f32, device=device)
    return (z, z.clone(), torch.ones(shape, dtype=f32, device=device),
            torch.full(shape, NEG_INIT, dtype=f32, device=device))


def _slstm_scan(cfg, p, wx, state):
    """wx: (B, S, 4d) precomputed input contributions -> (hs (B, S, d),
    state)."""
    heads, d = cfg.n_heads, cfg.d_model
    dh = d // heads
    r_mat = p["r"].float()
    h, c, n, m = state
    b = h.shape[0]
    hs = []
    for wxt in wx.unbind(1):
        # (B, H, 4dh) -> (B, 4, H, dh) -> (B, 4d): wx's [z|i|f|o] chunking
        rec = torch.einsum("bhd,hdk->bhk", h.reshape(b, heads, dh), r_mat)
        rec = rec.reshape(b, heads, 4, dh).transpose(1, 2).reshape(b, 4 * d)
        z_raw, i_raw, f_raw, o_raw = (wxt + rec).chunk(4, dim=-1)
        zt = torch.tanh(z_raw)
        ot = torch.sigmoid(o_raw)
        fm = F.logsigmoid(f_raw) + m
        m_new = torch.maximum(fm, i_raw)
        fp = torch.exp(fm - m_new)
        ip = torch.exp(i_raw - m_new)
        c = fp * c + ip * zt
        n = fp * n + ip
        h = ot * c / torch.clamp_min(n, 1.0)
        m = m_new
        hs.append(h)
    return torch.stack(hs, 1), (h, c, n, m)


def _slstm_core(cfg, p, x, state):
    d = cfg.dtype
    wx = (torch.matmul(x, p["w"].to(d)) + p["b"].to(d)).float()
    hs, state = _slstm_scan(cfg, p, wx, state)
    return hs.to(d), state


def slstm_full(cfg, p: dict, x: torch.Tensor, return_cache: bool = False):
    out, state = _slstm_core(cfg, p, x,
                             slstm_state_init(cfg, x.shape[0], x.device))
    return (out, state) if return_cache else out


def slstm_step(cfg, p: dict, x: torch.Tensor, cache: Tuple):
    """x: (B, 1, d) -> (out, new state)."""
    return _slstm_core(cfg, p, x, cache)
