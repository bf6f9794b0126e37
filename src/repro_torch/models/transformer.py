"""Block and stack composition: (mixer x ffn) blocks over the layer periods.

A config's layer plan is a cyclic pattern of ``(mixer, ffn)`` pairs
(``ModelConfig.layer_plan``); the stacked parameters carry one subtree per
position of the period, each leaf with a leading period axis, exactly the
JAX package's tree.  Where the JAX package scans over that axis
(``lax.scan``), the port loops over it in Python.  The port builds
``attn``/``attn_nocausal`` mixers and ``mlp`` or ``moe`` FFNs
(``repro_torch.configs.check_ported``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import random as jr
from repro_torch import tree
from repro_torch.models import attention, fusion, layers, mlp, moe


def _check_block(mixer: str, ffn: str) -> None:
    if mixer not in ("attn", "attn_nocausal") or ffn not in ("mlp", "moe"):
        raise NotImplementedError(
            f"block ({mixer!r}, {ffn!r}) is not ported yet (ROADMAP queue "
            "1, item 17b: SSM/mamba/xLSTM)")


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------

def block_init(cfg, gen: torch.Generator, mixer: str, ffn: str) -> dict:
    _check_block(mixer, ffn)
    return {"norm1": layers.norm_init(cfg, gen),
            "mixer": attention.attn_init(cfg, gen),
            "norm2": layers.norm_init(cfg, gen),
            "ffn": (mlp.mlp_init if ffn == "mlp" else moe.moe_init)(cfg,
                                                                    gen)}


def _ffn(cfg, p: dict, x: torch.Tensor, ffn: str):
    """The block's FFN on the residual stream: (x, aux)."""
    h = layers.norm_apply(cfg, p["norm2"], x)
    if ffn == "moe":
        y, aux = moe.moe_apply(cfg, p["ffn"], h)
        return x + y, aux
    return x + mlp.mlp_apply(cfg, p["ffn"], h), _zero(x)


def block_full(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
               mixer: str, ffn: str):
    """Training / prefill block. Returns (x, aux_loss)."""
    _check_block(mixer, ffn)
    h = layers.norm_apply(cfg, p["norm1"], x)
    x = x + attention.attn_full(cfg, p["mixer"], h, positions,
                                causal=(mixer == "attn"))
    return _ffn(cfg, p, x, ffn)


def block_cache_init(cfg, mixer: str, batch: int, max_seq: int, dtype,
                     device=None) -> dict:
    _check_block(mixer, "mlp")
    return {"self": attention.init_cache(cfg, batch, max_seq, dtype, device)}


def block_step(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
               cache: dict, mixer: str, ffn: str, protocol=None, rng=None):
    """Decode step. x: (B,1,d). Returns (x, cache, aux).

    With a ``protocol`` an mlp FFN's worker-partial fusion routes through
    the simulated channel (``mlp_apply(protocol=, rng=)``) and the return
    grows a fourth element, the channel-accounting dict of this block's
    fusion site (``fusion.chan_zeros()`` for a moe FFN, whose fusions stay
    on ``tp_fusion`` as the mixer's do).  The KV cache is updated in place
    (``attention.attn_step``)."""
    _check_block(mixer, ffn)
    h = layers.norm_apply(cfg, p["norm1"], x)
    out, new_self = attention.attn_step(cfg, p["mixer"], h, positions,
                                        cache["self"])
    new_cache = dict(cache, self=new_self)
    x = x + out
    if protocol is None or ffn == "moe":
        x, aux = _ffn(cfg, p, x, ffn)
        if protocol is None:
            return x, new_cache, aux
        return x, new_cache, aux, fusion.chan_zeros(x.device)
    h = layers.norm_apply(cfg, p["norm2"], x)
    y, acct = mlp.mlp_apply(cfg, p["ffn"], h, protocol=protocol, rng=rng)
    return x + y, new_cache, _zero(x), fusion.chan_from_acct(acct)


def block_prefill(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
                  mixer: str, ffn: str, max_seq: int):
    """Full-sequence forward that also materializes the decode cache,
    padded with zeros to ``max_seq``.  Returns (x, cache, aux)."""
    _check_block(mixer, ffn)
    h = layers.norm_apply(cfg, p["norm1"], x)
    out, kv = attention.attn_full(cfg, p["mixer"], h, positions,
                                  causal=(mixer == "attn"), return_kv=True)
    if max_seq > kv["k"].shape[1]:
        buf = attention.init_cache(cfg, x.shape[0], max_seq, cfg.dtype,
                                   x.device)
        for name in ("k", "v"):
            buf[name][:, :kv[name].shape[1]] = kv[name]
        kv = buf
    x, aux = _ffn(cfg, p, x + out, ffn)
    return x, {"self": kv}, aux


# ---------------------------------------------------------------------------
# stack: a loop over periods
# ---------------------------------------------------------------------------

def _period(stacked, i: int):
    """Period ``i`` of a stacked tree (views: writes land in the stack)."""
    return tree.map(lambda v: v[i], stacked)


def _n_periods(values) -> int:
    return tree.leaves(values)[0].shape[0]


def _periods(stacked) -> list:
    """Every period of a stacked tree, as views from one ``unbind`` per
    leaf: its backward stacks the periods' gradients once, where an index
    per period (:func:`_period`) writes a zero gradient of the whole stack
    for every period and autograd adds them up."""
    per_leaf = [v.unbind(0) for v in tree.leaves(stacked)]
    return [tree.unflatten(stacked, [views[i] for views in per_leaf])
            for i in range(_n_periods(stacked))]


def stack_init(cfg, gen: torch.Generator, plan, n_periods: int) -> dict:
    periods = [{f"pos{i}": block_init(cfg, gen, mixer, ffn)
                for i, (mixer, ffn) in enumerate(plan)}
               for _ in range(n_periods)]
    return tree.map(lambda *xs: torch.stack(xs), *periods)


def stack_full(cfg, values: dict, x: torch.Tensor, positions: torch.Tensor,
               plan):
    """values: the stacked tree; x: (B,S,d). Returns (x, aux)."""
    aux = _zero(x)
    for pp in _periods(values):
        for i, (mixer, ffn) in enumerate(plan):
            x, a = block_full(cfg, pp[f"pos{i}"], x, positions, mixer, ffn)
            aux = aux + a
    return x, aux


def stack_step(cfg, values: dict, x: torch.Tensor, positions: torch.Tensor,
               cache: dict, plan, protocol=None, rng=None):
    """Decode step through the whole stack; the stacked cache is updated in
    place and returned.  Returns (x, cache, aux).

    With a ``protocol`` (and ``rng``, the tick's sensing key) every mlp-FFN
    fusion site aggregates through the simulated channel under the key
    ``fold_in(split(rng, n_periods)[period], position)``, the JAX
    package's keys, and the return grows a fourth element: the summed
    channel-accounting dict of the whole stack."""
    chan_mode = protocol is not None
    n = _n_periods(values)
    keys = jr.split(rng, n) if chan_mode else None
    chan = fusion.chan_zeros(x.device) if chan_mode else None
    aux = _zero(x)
    for period in range(n):
        pp, pc = _period(values, period), _period(cache, period)
        for i, (mixer, ffn) in enumerate(plan):
            key = f"pos{i}"
            if chan_mode:
                # only an mlp site draws sensing bits: a moe block's key
                # would be ~170 int64 launches of unused threefry
                x, _, a, ch = block_step(
                    cfg, pp[key], x, positions, pc[key], mixer, ffn,
                    protocol=protocol, rng=(jr.fold_in(keys[period], i)
                                            if ffn == "mlp" else None))
                chan = fusion.chan_merge(chan, ch)
            else:
                x, _, a = block_step(cfg, pp[key], x, positions, pc[key],
                                     mixer, ffn)
            aux = aux + a
    if chan_mode:
        return x, cache, aux, chan
    return x, cache, aux


def stack_prefill(cfg, values: dict, x: torch.Tensor, positions: torch.Tensor,
                  plan, max_seq: int):
    """Full forward that also builds the stacked decode cache."""
    aux = _zero(x)
    caches = []
    for period in range(_n_periods(values)):
        pp = _period(values, period)
        cache: Dict[str, Any] = {}
        for i, (mixer, ffn) in enumerate(plan):
            x, cache[f"pos{i}"], a = block_prefill(
                cfg, pp[f"pos{i}"], x, positions, mixer, ffn, max_seq)
            aux = aux + a
        caches.append(cache)
    return x, tree.map(lambda *xs: torch.stack(xs), *caches), aux


def stack_cache_init(cfg, plan, n_periods: int, batch: int, max_seq: int,
                     dtype, device=None) -> dict:
    one = {f"pos{i}": block_cache_init(cfg, mixer, batch, max_seq, dtype,
                                       device)
           for i, (mixer, _) in enumerate(plan)}
    return tree.map(
        lambda v: v[None].repeat((n_periods,) + (1,) * v.ndim), one)
