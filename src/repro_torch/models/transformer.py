"""Block and stack composition: (mixer x ffn) blocks over the layer periods.

A config's layer plan is a cyclic pattern of ``(mixer, ffn)`` pairs
(``ModelConfig.layer_plan``); the stacked parameters carry one subtree per
position of the period, each leaf with a leading period axis, exactly the
JAX package's tree.  Where the JAX package scans over that axis
(``lax.scan``), the port loops over it in Python.  Mixers: ``attn``/
``attn_nocausal`` (a KV cache), ``mamba``, ``mlstm`` and ``slstm`` (a
recurrent state); FFNs: ``mlp``, ``moe`` or ``none`` (no ``norm2``, no
``ffn``, aux 0: the xLSTM blocks).  An encoder-decoder's decoder blocks
carry a cross-attention (``norm_cross``, ``cross``) over the encoder's
output between the mixer and the FFN; its cache is the encoder's keys and
values (``cache["cross"]``), which the prefill writes and decoding reads.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, NamedTuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch import random as jr
from repro_torch import tree
from repro_torch.models import attention, fusion, layers, mamba, mlp, moe, ssm
from repro_torch.parallel import sharding

ATTENTION = ("attn", "attn_nocausal")


class Recurrent(NamedTuple):
    """A mixer whose cache is a recurrent state: its parameters, its
    full-sequence and one-token forwards, its state for a batch (the
    active mesh's share of the workers), the fewest prompt tokens from
    which a prefill builds that state, and the batch axis of each of the
    state's tensors (a tree of the state's structure)."""
    init: Callable
    full: Callable
    step: Callable
    state_init: Callable        # (cfg, batch, dtype, device) -> state
    min_prompt: Callable        # cfg -> int
    rows: Any


RECURRENT = {
    # a prefill caches the prompt's last conv_width - 1 conv inputs
    "mamba": Recurrent(mamba.mamba_init, mamba.mamba_full, mamba.mamba_step,
                       mamba.init_cache, lambda cfg: cfg.conv_width - 1,
                       {"conv": 1, "h": 1}),
    "mlstm": Recurrent(
        ssm.mlstm_init, ssm.mlstm_full, ssm.mlstm_step,
        lambda cfg, batch, dtype, device: ssm.mlstm_state_init(
            cfg, batch, device), lambda cfg: 1, (1, 0, 0)),
    "slstm": Recurrent(
        ssm.slstm_init, ssm.slstm_full, ssm.slstm_step,
        lambda cfg, batch, dtype, device: ssm.slstm_state_init(
            cfg, batch, device), lambda cfg: 1, (0, 0, 0, 0)),
}


# each recurrent mixer's logical parameter axes
RECURRENT_AXES = {"mamba": mamba.mamba_axes, "mlstm": ssm.mlstm_axes,
                  "slstm": ssm.slstm_axes}
# and the logical axes of its state
RECURRENT_CACHE_AXES = {"mamba": mamba.MAMBA_CACHE_AXES,
                        "mlstm": ssm.MLSTM_CACHE_AXES,
                        "slstm": ssm.SLSTM_CACHE_AXES}


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------

def block_init(cfg, gen: torch.Generator, mixer: str, ffn: str,
               cross: bool = False) -> dict:
    p = {"norm1": layers.norm_init(cfg, gen)}
    if mixer in ATTENTION:
        p["mixer"] = attention.attn_init(cfg, gen)
    else:
        p["mixer"] = RECURRENT[mixer].init(cfg, gen)
    if cross:
        p["norm_cross"] = layers.norm_init(cfg, gen)
        p["cross"] = attention.attn_init(cfg, gen)
    if ffn != "none":
        p["norm2"] = layers.norm_init(cfg, gen)
        p["ffn"] = (mlp.mlp_init if ffn == "mlp" else moe.moe_init)(cfg, gen)
    return p


def block_axes(cfg, mixer: str, ffn: str, cross: bool = False) -> dict:
    """:func:`block_init`'s logical axes."""
    p = {"norm1": layers.norm_axes(cfg),
         "mixer": (attention.attn_axes(cfg) if mixer in ATTENTION
                   else RECURRENT_AXES[mixer](cfg))}
    if cross:
        p["norm_cross"] = layers.norm_axes(cfg)
        p["cross"] = attention.attn_axes(cfg)
    if ffn != "none":
        p["norm2"] = layers.norm_axes(cfg)
        p["ffn"] = (mlp.mlp_axes if ffn == "mlp" else moe.moe_axes)(cfg)
    return p


def _ffn(cfg, p: dict, x: torch.Tensor, ffn: str):
    """The block's FFN on the residual stream: (x, aux)."""
    if ffn == "none":
        return x, _zero(x)
    h = layers.norm_apply(cfg, p["norm2"], x)
    if ffn == "moe":
        y, aux = moe.moe_apply(cfg, p["ffn"], h)
        return x + y, aux
    return x + mlp.mlp_apply(cfg, p["ffn"], h), _zero(x)


def _cross_full(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
                enc_out):
    """(the residual stream after the block's cross-attention over
    ``enc_out``, the encoder's keys and values); ``(x, None)`` for a block
    without one."""
    if "cross" not in p:
        return x, None
    h = layers.norm_apply(cfg, p["norm_cross"], x)
    out, kv = attention.attn_full(cfg, p["cross"], h, positions,
                                  causal=False, kv_x=enc_out, return_kv=True)
    return x + out, kv


def block_full(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
               mixer: str, ffn: str, enc_out=None):
    """Training / prefill block. Returns (x, aux_loss)."""
    h = layers.norm_apply(cfg, p["norm1"], x)
    if mixer in ATTENTION:
        out = attention.attn_full(cfg, p["mixer"], h, positions,
                                  causal=(mixer == "attn"))
    else:
        out = RECURRENT[mixer].full(cfg, p["mixer"], h)
    x, _ = _cross_full(cfg, p, x + out, positions, enc_out)
    return _ffn(cfg, p, x, ffn)


def block_cache_init(cfg, mixer: str, batch: int, max_seq: int, dtype,
                     device=None, cross_len: int = 0) -> dict:
    if mixer in ATTENTION:
        c = {"self": attention.init_cache(cfg, batch, max_seq, dtype,
                                          device)}
    else:
        c = {"self": RECURRENT[mixer].state_init(cfg, batch, dtype, device)}
    if cross_len:
        c["cross"] = attention.init_cache(cfg, batch, cross_len, dtype,
                                          device)
    return c


def block_cache_axes(cfg, mixer: str, has_cross: bool) -> dict:
    """:func:`block_cache_init`'s logical axes."""
    c = {"self": dict(attention.CACHE_AXES) if mixer in ATTENTION
         else RECURRENT_CACHE_AXES[mixer]}
    if has_cross:
        c["cross"] = dict(attention.CACHE_AXES)
    return c


def block_step(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
               cache: dict, mixer: str, ffn: str, protocol=None, rng=None):
    """Decode step. x: (B,1,d). Returns (x, cache, aux).

    With a ``protocol`` an mlp FFN's worker-partial fusion routes through
    the simulated channel (``mlp_apply(protocol=, rng=)``) and the return
    grows a fourth element, the channel-accounting dict of this block's
    fusion site (``fusion.chan_zeros()`` for a moe or no FFN; the mixer's
    fusions stay on ``tp_fusion``).  An attention mixer writes its KV
    cache in place (``attention.attn_step``); a recurrent mixer returns
    its new state in the returned cache and leaves ``cache`` as it was."""
    h = layers.norm_apply(cfg, p["norm1"], x)
    if mixer in ATTENTION:
        out, new_self = attention.attn_step(cfg, p["mixer"], h, positions,
                                            cache["self"])
    else:
        out, new_self = RECURRENT[mixer].step(cfg, p["mixer"], h,
                                              cache["self"])
    new_cache = dict(cache, self=new_self)
    x = x + out
    if "cross" in p:
        h = layers.norm_apply(cfg, p["norm_cross"], x)
        out, _ = attention.attn_step(cfg, p["cross"], h, positions,
                                     cache["cross"], cross=True)
        x = x + out
    if protocol is None or ffn != "mlp":
        x, aux = _ffn(cfg, p, x, ffn)
        if protocol is None:
            return x, new_cache, aux
        return x, new_cache, aux, fusion.chan_zeros(x.device)
    h = layers.norm_apply(cfg, p["norm2"], x)
    y, acct = mlp.mlp_apply(cfg, p["ffn"], h, protocol=protocol, rng=rng)
    return x + y, new_cache, _zero(x), fusion.chan_from_acct(acct)


def _seq_block(cfg, kv: dict, length: int) -> dict:
    """The keys and values ``kv`` (B, S, Kv, Dh) as a cache of ``length``
    positions, zero past ``S``; under a ``kv_seq`` split
    (``sharding.cache_splits``) this rank's block of it."""
    _, seq = sharding.cache_splits(kv["k"].shape[0], length)
    if seq is None and length <= kv["k"].shape[1]:
        return kv
    local = sharding.local_size(length, seq)
    lo = 0 if seq is None else seq.index * local
    hi = min(lo + local, kv["k"].shape[1])
    buf = attention.init_cache(cfg, kv["k"].shape[0], local, cfg.dtype,
                               kv["k"].device)
    if hi > lo:
        for name in ("k", "v"):
            buf[name][:, :hi - lo] = kv[name][:, lo:hi]
    return buf


def block_prefill(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
                  mixer: str, ffn: str, max_seq: int, enc_out=None):
    """Full-sequence forward that also materializes the decode cache: a
    KV cache padded with zeros to ``max_seq``, or the recurrent state
    after the last position; with a cross-attention also the encoder's
    keys and values, unpadded.  Under a ``kv_seq`` split each KV cache is
    this rank's block of its sequence.  Returns (x, cache, aux)."""
    h = layers.norm_apply(cfg, p["norm1"], x)
    if mixer not in ATTENTION:
        out, kv = RECURRENT[mixer].full(cfg, p["mixer"], h,
                                        return_cache=True)
    else:
        out, kv = attention.attn_full(cfg, p["mixer"], h, positions,
                                      causal=(mixer == "attn"),
                                      return_kv=True)
        kv = _seq_block(cfg, kv, max(max_seq, kv["k"].shape[1]))
    cache = {"self": kv}
    x, ckv = _cross_full(cfg, p, x + out, positions, enc_out)
    if ckv is not None:
        cache["cross"] = _seq_block(cfg, ckv, ckv["k"].shape[1])
    x, aux = _ffn(cfg, p, x, ffn)
    return x, cache, aux


# ---------------------------------------------------------------------------
# stack: a loop over periods
# ---------------------------------------------------------------------------

def _period(stacked, i: int):
    """Period ``i`` of a stacked tree (views: writes land in the stack);
    a parameter leaf split over the fsdp axis gathered
    (``sharding.fsdp_period``)."""
    return tree.map(lambda v: sharding.fsdp_period(v, v[i]), stacked)


def _n_periods(values) -> int:
    return tree.leaves(values)[0].shape[0]


def stack_init(cfg, gen: torch.Generator, plan, n_periods: int,
               cross: bool = False) -> dict:
    """The stacked tree, its periods drawn from ``gen`` one after another.
    Each leaf is allocated once with its period axis and each period's
    draws are copied into it, so the peak is the stack and one period,
    not the periods and their stacked copy; a single period is the stack
    itself, viewed with its period axis."""

    def one_period():
        return {f"pos{i}": block_init(cfg, gen, mixer, ffn, cross=cross)
                for i, (mixer, ffn) in enumerate(plan)}

    def fill(stacked, period, drawn):
        tree.map(lambda dst, src: dst[period].copy_(src), stacked, drawn)

    first = one_period()
    if n_periods == 1:
        return tree.map(lambda v: v[None], first)
    stacked = tree.map(lambda v: torch.empty(
        (n_periods,) + tuple(v.shape), dtype=v.dtype, device=v.device),
        first)
    fill(stacked, 0, first)
    del first
    for period in range(1, n_periods):
        fill(stacked, period, one_period())
    return stacked


def stack_axes(cfg, plan, cross: bool = False) -> dict:
    """:func:`stack_init`'s logical axes: each block's, behind the period
    axis ``"layers"``."""
    def stacked(ax):
        if isinstance(ax, tuple):
            return ("layers",) + ax
        return {k: stacked(v) for k, v in ax.items()}
    return {f"pos{i}": stacked(block_axes(cfg, mixer, ffn, cross))
            for i, (mixer, ffn) in enumerate(plan)}


# the matmul outputs that remat_policy="dots" keeps, as JAX's
# dots_saveable keeps dot_general's
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def stack_full(cfg, values: dict, x: torch.Tensor, positions: torch.Tensor,
               plan, enc_out=None):
    """values: the stacked tree; x: (B,S,d); ``enc_out`` the encoder's
    output for the cross-attentions. Returns (x, aux).

    With ``cfg.remat`` (and autograd recording) each period's body runs
    under ``torch.utils.checkpoint``, as the JAX package wraps its scan
    body in ``jax.checkpoint``: the backward recomputes the period's
    forward, everything (``remat_policy="full"``) or all but the matmul
    outputs (``"dots"``).  The period's parameters are gathered inside
    the body (``sharding.fsdp_period``) under the forward's mesh scope, so
    under FSDP the recompute gathers them again."""
    aux = _zero(x)
    leaves = tree.leaves(values)
    # the recompute runs in the backward, after the model entry's mesh
    # scopes (batch split, FSDP) closed: it reinstates the forward's
    scope = sharding.context()

    def period(x, aux, *views):
        with sharding.restored(scope):
            pp = tree.unflatten(values, [sharding.fsdp_period(leaf, view)
                                         for leaf, view in zip(leaves, views)])
            for i, (mixer, ffn) in enumerate(plan):
                x, a = block_full(cfg, pp[f"pos{i}"], x, positions, mixer,
                                  ffn, enc_out)
                aux = aux + a
        return x, aux

    if cfg.remat and torch.is_grad_enabled():
        # every draw in a period takes an explicit threefry key
        # (repro_torch.random), none torch's global generator, so the
        # recompute draws the same bits without preserve_rng_state
        run = functools.partial(
            checkpoint, use_reentrant=False, preserve_rng_state=False,
            context_fn=(functools.partial(create_selective_checkpoint_contexts,
                                          _dots_saveable)
                        if cfg.remat_policy == "dots" else noop_context_fn))
    else:
        def run(f, *args):
            return f(*args)
    # the periods as views from one unbind per leaf: its backward stacks
    # the periods' gradients once, where an index per period (_period)
    # writes a zero gradient of the whole stack for every period and
    # autograd adds them up
    per_leaf = [v.unbind(0) for v in leaves]
    for i in range(_n_periods(values)):
        x, aux = run(period, x, aux, *(views[i] for views in per_leaf))
    return x, aux


def stack_step(cfg, values: dict, x: torch.Tensor, positions: torch.Tensor,
               cache: dict, plan, protocol=None, rng=None):
    """Decode step through the whole stack; the stacked cache is updated in
    place (the KV rows at ``positions``, every recurrent state whole) and
    returned.  Returns (x, cache, aux).

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
                # only an mlp site draws sensing bits: another block's key
                # would be ~170 int64 launches of unused threefry
                x, c, a, ch = block_step(
                    cfg, pp[key], x, positions, pc[key], mixer, ffn,
                    protocol=protocol, rng=(jr.fold_in(keys[period], i)
                                            if ffn == "mlp" else None))
                chan = fusion.chan_merge(chan, ch)
            else:
                x, c, a = block_step(cfg, pp[key], x, positions, pc[key],
                                     mixer, ffn)
            if mixer in RECURRENT:
                # the new state into the period's views of the stack
                tree.map(lambda dst, src: dst.copy_(src), pc[key]["self"],
                         c["self"])
            aux = aux + a
    if chan_mode:
        return x, cache, aux, chan
    return x, cache, aux


def stack_prefill(cfg, values: dict, x: torch.Tensor, positions: torch.Tensor,
                  plan, max_seq: int, enc_out=None):
    """Full forward that also builds the stacked decode cache."""
    aux = _zero(x)
    caches = []
    for period in range(_n_periods(values)):
        pp = _period(values, period)
        cache: Dict[str, Any] = {}
        for i, (mixer, ffn) in enumerate(plan):
            x, cache[f"pos{i}"], a = block_prefill(
                cfg, pp[f"pos{i}"], x, positions, mixer, ffn, max_seq,
                enc_out)
            aux = aux + a
        caches.append(cache)
    return x, tree.map(lambda *xs: torch.stack(xs), *caches), aux


def stack_cache_init(cfg, plan, n_periods: int, batch: int, max_seq: int,
                     dtype, device=None, cross_len: int = 0) -> dict:
    one = {f"pos{i}": block_cache_init(cfg, mixer, batch, max_seq, dtype,
                                       device, cross_len)
           for i, (mixer, _) in enumerate(plan)}
    return tree.map(
        lambda v: v[None].repeat((n_periods,) + (1,) * v.ndim), one)


def stack_cache_axes(cfg, plan, has_cross: bool) -> dict:
    """:func:`stack_cache_init`'s logical axes: each block's, behind the
    period axis ``"layers"``."""
    def stacked(ax):
        if isinstance(ax, dict):
            return {k: stacked(v) for k, v in ax.items()}
        if all(a is None or isinstance(a, str) for a in ax):
            return ("layers",) + ax
        return tuple(stacked(a) for a in ax)
    return {f"pos{i}": stacked(block_cache_axes(cfg, mixer, has_cross))
            for i, (mixer, _) in enumerate(plan)}


def cache_rows(plan, cache: dict) -> dict:
    """The batch axis of every leaf of a stacked cache (a tree of its
    structure): axis 1 of an attention cache, past the period axis, and
    of a recurrent state's whole tensors; axis 2 of the worker-leading
    ones (mLSTM's memory, mamba's conv window and state)."""
    out = {}
    for i, (mixer, _) in enumerate(plan):
        c = cache[f"pos{i}"]
        state = (RECURRENT[mixer].rows if mixer in RECURRENT
                 else tree.map(lambda t: 0, c["self"]))
        axes = {"self": tree.map(lambda r: r + 1, state)}
        if "cross" in c:
            axes["cross"] = tree.map(lambda t: 1, c["cross"])
        out[f"pos{i}"] = axes
    return out


def min_prompt(cfg, plan) -> int:
    """The fewest prompt tokens from whose prefill every layer of ``plan``
    builds its cache."""
    return max([1] + [RECURRENT[mixer].min_prompt(cfg) for mixer, _ in plan
                      if mixer in RECURRENT])


def recurrent_leaves(plan, cache: dict) -> List[torch.Tensor]:
    """The stacked cache's recurrent-state tensors (the mamba, mLSTM and
    sLSTM positions), which a decode step overwrites whole."""
    return [leaf for i, (mixer, _) in enumerate(plan) if mixer in RECURRENT
            for leaf in tree.leaves(cache[f"pos{i}"])]
