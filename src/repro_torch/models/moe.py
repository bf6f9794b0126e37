"""Mixture-of-Experts FFN (the JAX package's ``models/moe.py``).

Routing is per sequence: the top ``k`` experts of the router's softmax
(equal probabilities go to the lower expert index, as ``lax.top_k``
orders them), their weights normalised, the ``(token, expert)`` entries
sorted by expert (stable, so by token within an expert) and ranked within
their expert; an entry ranked at or past the capacity is dropped
(Switch/GShard semantics: JAX's out-of-bounds ``mode="drop"`` scatter
writes nothing).  The router adds the Switch load-balancing loss.  The
experts' SwiGLU FFNs are products batched over the expert axis.

The fusion law does not apply inside an expert: an expert's FFN is whole
on one worker, so there is no worker-partial reduction to replace.  A
shared expert (llama4) is an ``mlp`` and fuses by ``tp_fusion``.

Deterministic on CUDA.  Rows move between token, entry and expert-buffer
space only by gathers (:class:`_Route`), whose backward is another gather
through the inverse map, and the ``k`` rows of a token are added by a
loop over ``k`` in ascending expert order — the order in which the JAX
package's sequential scatter-add on the CPU adds them — never through
atomics (``index_add_``, ``scatter_add_``, ``gather``'s own backward).

Under a mesh whose model axis splits the experts (``w_up``/``w_gate``/
``w_down`` hold ``E/R`` of them), every rank routes the whole tokens with
the replicated router, builds only its experts' slots of the ``(E, B*cap,
d)`` buffer from the tokens behind the model group's *f* copy, and runs
its experts' products; the slot outputs are gathered over the group in
rank order (the backward keeps the rank's block, unsummed: what consumes
them is replicated) and the one-device combine runs on every rank, so the
MoE output is the one-rank run's wherever the per-expert products are.
Under a data axis the load-balancing loss's expert means and counts are
summed over the data group first, so every rank holds the whole batch's
loss.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers, mlp
from repro_torch.parallel import comm
from repro_torch.parallel import sharding


def moe_init(cfg, gen: torch.Generator) -> dict:
    """The JAX package's tree: a float32 router ``(d, E)`` whatever
    ``param_dtype`` is, ``w_up``/``w_gate`` ``(E, d, f)`` and ``w_down``
    ``(E, f, d)``, and ``shared`` (an ``mlp``) with ``moe_shared_expert``."""
    e, d = cfg.n_experts, cfg.d_model
    f = cfg.moe_d_ff or cfg.d_ff
    p = {
        "router": layers.param(gen, (d, e), torch.float32, scale=d ** -0.5),
        "w_up": layers.param(gen, (e, d, f), cfg.param_dtype,
                             scale=d ** -0.5),
        "w_gate": layers.param(gen, (e, d, f), cfg.param_dtype,
                               scale=d ** -0.5),
        "w_down": layers.param(gen, (e, f, d), cfg.param_dtype,
                               scale=f ** -0.5),
    }
    if cfg.moe_shared_expert:
        p["shared"] = mlp.mlp_init(cfg, gen, d_ff=cfg.moe_d_ff or cfg.d_ff)
    return p


def moe_axes(cfg) -> dict:
    """:func:`moe_init`'s logical axes."""
    p = {"router": ("embed", None),
         "w_up": ("experts", "embed", "ff_local"),
         "w_gate": ("experts", "embed", "ff_local"),
         "w_down": ("experts", "ff_local", "embed")}
    if cfg.moe_shared_expert:
        p["shared"] = mlp.mlp_axes(cfg)
    return p


def _capacity(cfg, tokens_per_seq: int) -> int:
    return max(1, math.ceil(
        tokens_per_seq * cfg.experts_per_token / cfg.n_experts
        * cfg.capacity_factor))


# ---------------------------------------------------------------------------
# deterministic row movement
# ---------------------------------------------------------------------------

class _TakeUnique(torch.autograd.Function):
    """``x.gather(dim, idx)`` where ``idx`` holds no index twice along
    ``dim``; the backward writes each cotangent with ``scatter_`` (no
    additions), where ``gather``'s own backward is a ``scatter_add_``."""

    @staticmethod
    def forward(ctx, x, dim, idx):
        ctx.save_for_backward(idx)
        ctx.dim, ctx.shape = dim, x.shape
        return x.gather(dim, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        grad = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        return grad.scatter_(ctx.dim, idx, g), None, None


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` (R, d) at ``idx`` (M,); the index R takes a zero
    row."""
    r = x.shape[0]
    out = x.index_select(0, idx.clamp(max=r - 1))
    return out.masked_fill_((idx >= r)[:, None], 0)


def _sum_in_order(parts: torch.Tensor) -> torch.Tensor:
    """(M, m, d) -> (M, d): the m rows added one after another, in
    order."""
    acc = parts[:, 0]
    for j in range(1, parts.shape[1]):
        acc = acc + parts[:, j]
    return acc


class _Route(torch.autograd.Function):
    """Rows of ``x`` (R, d) taken by ``take`` (M,) into (M, d), the index R
    a zero row.  Each row of ``x`` is taken by at most ``m`` indices, and
    ``back`` (R * m,) lists them, row by row, in the order its cotangent
    adds them (the index M: none).  Both directions are gathers."""

    @staticmethod
    def forward(ctx, x, take, back):
        ctx.save_for_backward(back)
        ctx.m = back.numel() // x.shape[0]
        return _rows(x, take)

    @staticmethod
    def backward(ctx, g):
        (back,) = ctx.saved_tensors
        parts = _rows(g, back).view(-1, ctx.m, g.shape[-1])
        return _sum_in_order(parts), None, None


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def _route(cfg, probs: torch.Tensor, cap: int):
    """probs (B, S, E) float32 -> the routing of every sequence.

    Returns ``(e_flat, w_flat, order, e_s, pos)``: ``e_flat``/``w_flat``
    (B, S*k) the expert and normalised weight of entry ``t*k + j``, the
    k entries of a token in ascending expert order; ``order`` the stable
    sort of the entries by expert; ``e_s`` and ``pos`` the sorted
    entries' expert and rank within it, ``pos == cap`` for a dropped
    entry."""
    b, s, e = probs.shape
    k = cfg.experts_per_token
    # lax.top_k: the k largest, equal values to the lower index first
    idx = torch.sort(probs, dim=-1, descending=True, stable=True)[1][..., :k]
    w = _TakeUnique.apply(probs, -1, idx)
    w = w / torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-9)
    # a token's entries by ascending expert: the stable sort by expert
    # below orders (expert, token) pairs as from the top-k order
    idx, perm = torch.sort(idx, dim=-1)
    w = _TakeUnique.apply(w, -1, perm)
    e_flat, w_flat = idx.reshape(b, s * k), w.reshape(b, s * k)
    order = torch.sort(e_flat, dim=-1, stable=True)[1]
    e_s = e_flat.gather(1, order)
    experts = torch.arange(e, device=probs.device).expand(b, e)
    start = torch.searchsorted(e_s, experts.contiguous())   # first of each
    pos = torch.arange(s * k, device=probs.device) - start.gather(1, e_s)
    pos = torch.where(pos < cap, pos, cap)
    return e_flat, w_flat, order, e_s, pos


def _route_one_seq(cfg, probs: torch.Tensor, cap: int):
    """probs (B, S, E) -> ``(expert_idx, pos_in_expert, token_idx,
    weight)``, each (B, S*k) in the sorted order: the JAX package's
    ``_route_one_seq`` of every sequence, ``pos == cap`` for dropped
    entries."""
    _, w_flat, order, e_s, pos = _route(cfg, probs, cap)
    t_s = torch.div(order, cfg.experts_per_token, rounding_mode="floor")
    return e_s, pos, t_s, _TakeUnique.apply(w_flat, 1, order)


def _maps(cfg, b: int, s: int, cap: int, order, e_s, pos):
    """The index maps between entries (``b*S*k + t*k + j``) and expert
    buffer slots (``e*B*cap + b*cap + pos``, the buffer laid out (E, B,
    cap) for the batched expert products): ``entry_slot`` (B*S*k,), the
    sentinel ``E*B*cap`` for a dropped entry, and ``slot_entry``
    (E*B*cap,), the sentinel ``B*S*k`` for an empty slot."""
    e, k = cfg.n_experts, cfg.experts_per_token
    dev = order.device
    n_slots, n_entries = e * b * cap, b * s * k
    row = torch.arange(b, device=dev)[:, None]
    slot_s = torch.where(pos < cap, e_s * (b * cap) + row * cap + pos,
                         n_slots).reshape(-1)
    entry_s = (order + row * (s * k)).reshape(-1)
    entry_slot = torch.empty(n_entries, dtype=torch.int64, device=dev)
    entry_slot[entry_s] = slot_s                     # a permutation
    slot_entry = torch.full((n_slots + 1,), n_entries, dtype=torch.int64,
                            device=dev)
    slot_entry[slot_s] = entry_s         # repeats only into the sentinel
    return entry_slot, slot_entry[:n_slots]


def _router(p: dict, x: torch.Tensor) -> torch.Tensor:
    logits = torch.matmul(x.float(), p["router"].float())
    return torch.softmax(logits, dim=-1)                   # (B, S, E)


def _experts(cfg, p: dict, buf: torch.Tensor) -> torch.Tensor:
    """buf (E, B*cap, d) -> (E, B*cap, d): each expert's SwiGLU."""
    dt = cfg.dtype
    gate = torch.bmm(buf, p["w_gate"].to(dt))
    up = torch.bmm(buf, p["w_up"].to(dt))
    return torch.bmm(F.silu(gate) * up, p["w_down"].to(dt))


def _aux(cfg, probs: torch.Tensor, e_flat: torch.Tensor) -> torch.Tensor:
    """Switch load balancing: ``E * sum_e f_e * P_e``, ``f_e`` the share
    of entries routed to expert e (capacity drops included), over the
    whole batch where the data axis splits its rows."""
    # bincount's integers, from a scatter of ones into the experts' counts:
    # its output's shape does not depend on the data, so a fake-tensor
    # trace (the dry-run) runs it
    e = e_flat.reshape(-1).long()
    counts = torch.zeros(cfg.n_experts, dtype=torch.int64,
                         device=e.device).scatter_add_(0, e,
                                                       torch.ones_like(e))
    rows = sharding.batch_axis()
    if rows is None:
        me = torch.mean(probs, dim=(0, 1))
        entries = e_flat.numel()
    else:
        b, s, _ = probs.shape
        me = comm.reduce_from_group(torch.sum(probs, dim=(0, 1)),
                                    rows.group) / (b * s * rows.size)
        counts = comm.all_reduce(counts, "sum", rows.group)
        entries = e_flat.numel() * rows.size
    dispatch_frac = counts.float() * (1.0 / entries)
    return cfg.n_experts * torch.sum(dispatch_frac * me)


class _Slots:
    """The expert buffer slots a rank builds: those of its experts, the
    block ``[lo, hi)`` of the ``E*B*cap`` slots (all of them where the
    mesh does not split the experts)."""

    def __init__(self, cfg, p: dict, per_expert: int):
        e = cfg.n_experts
        local = p["w_up"].shape[0]
        ways = sharding.logical_axis("experts")
        if ways is not None and e % ways.size:
            raise ValueError(f"{e} experts over a {ways.size}-way "
                             f"{ways.name} axis")
        self.axis = sharding.split_of("experts", local, e)
        first = 0 if self.axis is None else self.axis.index * local
        self.lo, self.hi = first * per_expert, (first + local) * per_expert
        self.shape = (local, per_expert)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """The dispatch's input behind the model group's *f* copy where
        the experts are split: each rank's slots give its share of the
        tokens' gradient."""
        if self.axis is None:
            return x
        return comm.copy_to_group(x, self.axis.group)

    def dispatch(self, rows: torch.Tensor, slot_src: torch.Tensor,
                 src_slot: torch.Tensor) -> torch.Tensor:
        """The rank's slots (E_local, B*cap, d) taken from ``rows`` by
        ``slot_src`` (a slot's row) whose rows go to ``src_slot`` (a row's
        slots)."""
        if self.axis is None:
            buf = _Route.apply(rows, slot_src, src_slot)
        else:
            mine = (src_slot >= self.lo) & (src_slot < self.hi)
            back = torch.where(mine, src_slot - self.lo, self.hi - self.lo)
            buf = _Route.apply(rows, slot_src[self.lo:self.hi], back)
        return buf.view(*self.shape, rows.shape[-1])

    def gather(self, out_buf: torch.Tensor) -> torch.Tensor:
        """Every expert's slot outputs (E, B*cap, d) from the rank's."""
        if self.axis is None:
            return out_buf
        return comm.gather_from_group(out_buf, self.axis.group, 0)


def _finish(cfg, p: dict, x: torch.Tensor, y: torch.Tensor, probs,
            e_flat) -> Tuple[torch.Tensor, torch.Tensor]:
    if cfg.moe_shared_expert:
        y = y + mlp.mlp_apply(cfg, p["shared"], x)
    return y, _aux(cfg, probs, e_flat)


# ---------------------------------------------------------------------------
# the two forms of the JAX package
# ---------------------------------------------------------------------------

def moe_apply(cfg, p: dict, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    if cfg.moe_impl == "gather":
        return moe_apply_gather(cfg, p, x)
    return moe_apply_sort_scatter(cfg, p, x)


def moe_apply_sort_scatter(cfg, p: dict, x: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar).  Each token's
    row repeated k times (its k entries) is placed into its experts'
    slots; the slots' outputs are gathered back per entry, weighted and
    added over the token's k entries."""
    b, s, d = x.shape
    k = cfg.experts_per_token
    cap = _capacity(cfg, s)
    dt = cfg.dtype
    probs = _router(p, x)
    e_flat, w_flat, order, e_s, pos = _route(cfg, probs, cap)
    entry_slot, slot_entry = _maps(cfg, b, s, cap, order, e_s, pos)

    # dispatch: (B*S*k, d) entries -> (E, B*cap, d); the k copies of a
    # token add up in the repeat's backward (a reduction)
    slots = _Slots(cfg, p, b * cap)
    xk = slots.copy(x.to(dt)).reshape(b * s, 1, d).expand(
        b * s, k, d).reshape(-1, d)
    buf = slots.dispatch(xk, slot_entry, entry_slot)
    out_buf = slots.gather(_experts(cfg, p, buf))

    # combine: each entry's slot output, weighted, added over k in order
    vals = _Route.apply(out_buf.reshape(-1, d), entry_slot, slot_entry)
    vals = vals * w_flat.reshape(-1, 1).to(dt)
    y = _sum_in_order(vals.view(b * s, k, d)).view(b, s, d)
    return _finish(cfg, p, x, y, probs, e_flat)


def moe_apply_gather(cfg, p: dict, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's gather-dispatch form: each slot gathers its
    token's row (the slot -> token inverse map), the slots' outputs are
    weighted in expert space and added back into token space.  The same
    products and sums as :func:`moe_apply_sort_scatter` in the same
    order, so the same values."""
    b, s, d = x.shape
    k = cfg.experts_per_token
    cap = _capacity(cfg, s)
    dt = cfg.dtype
    probs = _router(p, x)
    e_flat, w_flat, order, e_s, pos = _route(cfg, probs, cap)
    entry_slot, slot_entry = _maps(cfg, b, s, cap, order, e_s, pos)
    n_entries = b * s * k
    slot_token = torch.where(
        slot_entry < n_entries,
        torch.div(slot_entry, k, rounding_mode="floor"), b * s)
    w_slot = _Route.apply(w_flat.reshape(-1, 1), slot_entry, entry_slot)

    # dispatch: a gather of token rows; a token's k slots add up in the
    # backward in ascending expert order
    slots = _Slots(cfg, p, b * cap)
    buf = slots.dispatch(slots.copy(x.to(dt)).reshape(b * s, d),
                         slot_token, entry_slot)
    out_buf = slots.gather(_experts(cfg, p, buf))
    out_buf = out_buf.reshape(-1, d) * w_slot.to(dt)

    vals = _Route.apply(out_buf, entry_slot, slot_entry)
    y = _sum_in_order(vals.view(b * s, k, d)).view(b, s, d)
    return _finish(cfg, p, x, y, probs, e_flat)
