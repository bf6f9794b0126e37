"""Fault injection for the wireless channel: bursty sensing, worker dropout
and graceful degradation (the JAX package's ``faults/model.py``).

:class:`FaultModel` upgrades the sensing channel to a Gilbert–Elliott
two-state Markov chain with per-state miss probabilities, adds an evolving
per-worker offline mask, and names a :class:`DegradePolicy` for what the
aggregator does when an OCS frame resolves nothing.

Chain mechanics (one :func:`aggregate` call = one contention frame):

* sensing state: ``bad' = bad ? (u >= p_bg) : (u < p_gb)`` per worker;
  the miss probability fed to the contention is ``where(bad',
  p_miss_bad, p_miss_good)``;
* dropout: ``offline' = offline ? (u >= p_recover) : (u < p_drop)``;
  offline workers leave the contention mask entirely;
* degradation: when no worker is online the frame resolves nothing, and
  the policy fills the pooled value with zeros (``zero_fill``), the last
  resolved frame from a carried cache (``stale``), or first spends a
  bounded retransmission budget with exponential backoff (``retry``).

The chain uniforms come from ``fold_in(rng, tag)`` side streams whose
tags are disjoint from the contention's round indices, so the sensing
stream is untouched: a :meth:`FaultModel.iid` model reproduces the plain
``Protocol.aggregate`` path bit for bit.  The draws are the JAX package's
(``repro_torch.random`` is threefry bit for bit).

Gradients (paper Eq. 5-6 extended): on a resolved frame the cotangent
routes to the winner as before; on a dropped frame nothing reaches ``h``
and the cotangent of the pooled value routes to the stale cache
(``stale``) or vanishes (``zero_fill``/``retry``).

Shapes.  A single channel: probabilities ``()`` or per-worker ``(N,)``,
state ``bad``/``offline`` ``(N,)``, ``stale`` the pooled shape, ``age``/
``consec`` ``()``, key ``(2,)``.  A lane stack (one channel per p_miss
lane, the curve engine's): every leaf gains a leading lane axis, the
probabilities as ``(L, 1)`` or ``(L, N)`` (:func:`stack_models`).  On a
CUDA tensor the pool runs the contention kernel and the pooling epilogue
with a per-lane ``p_keep`` and ``online`` mask, and its backward one
winner-routed scatter.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch import random as jr
from repro_torch.core import fedocs, ocs
from repro_torch.kernels.maxpool import ops as maxpool_ops
from repro_torch.kernels.maxpool.ref import PoolDecode
from repro_torch.protocol.protocol import mean_f32

POLICIES = ("zero_fill", "stale", "retry")

# fold_in tags of the fault side streams: far above any round or sub-slot
# index the contention folds in, so the sensing stream stays unchanged
_CHAIN_TAG = 0x000C5A17   # Gilbert–Elliott sensing-state chain
_DROP_TAG = 0x000D2079    # worker-dropout chain
_RETRY_TAG = 0x000AE771   # retry-recovery re-draws

_LEAVES = ("p_gb", "p_bg", "p_miss_good", "p_miss_bad", "p_drop",
           "p_recover")


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class DegradePolicy:
    """What the aggregator does when a frame resolves nothing.

    ``zero_fill`` emits zeros for the dropped frame; ``stale`` replays the
    last resolved pooled value from the carried cache; ``retry`` spends up
    to ``retry_budget`` retransmission attempts (each re-drawing worker
    recovery and billing a full contention frame plus an exponential
    backoff wait) before degrading to zeros."""

    kind: str = "zero_fill"
    retry_budget: int = 0

    def __post_init__(self):
        if self.kind not in POLICIES:
            raise ValueError(
                f"unknown degrade policy {self.kind!r}; valid: {POLICIES}")
        if self.kind == "retry" and self.retry_budget < 1:
            raise ValueError("retry policy needs retry_budget >= 1")
        if self.kind != "retry" and self.retry_budget != 0:
            raise ValueError(
                f"retry_budget is only meaningful for kind='retry', "
                f"got {self.retry_budget} with {self.kind!r}")

    @classmethod
    def zero_fill(cls) -> "DegradePolicy":
        return cls(kind="zero_fill")

    @classmethod
    def stale(cls) -> "DegradePolicy":
        return cls(kind="stale")

    @classmethod
    def retry(cls, budget: int = 2) -> "DegradePolicy":
        return cls(kind="retry", retry_budget=budget)


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """The channel fault process: six float32 probability tensors (scalar
    or per-worker ``(N,)``; lane-stacked ``(L, 1)``/``(L, N)``) and the
    policy.  Construct with :meth:`iid`, :meth:`gilbert_elliott` or
    :meth:`burst` (+ :meth:`with_dropout` / :meth:`with_policy`)."""

    p_gb: torch.Tensor          # P(good -> bad) per frame
    p_bg: torch.Tensor          # P(bad -> good) per frame
    p_miss_good: torch.Tensor   # sensing miss prob in the good state
    p_miss_bad: torch.Tensor    # sensing miss prob in the bad state
    p_drop: torch.Tensor        # P(online -> offline) per frame
    p_recover: torch.Tensor     # P(offline -> online) per frame
    policy: DegradePolicy = DegradePolicy()

    @classmethod
    def iid(cls, p_miss, *, policy: Optional[DegradePolicy] = None
            ) -> "FaultModel":
        """Identical states, no dropout: bit for bit the i.i.d. ``p_miss``
        channel (the reduction witness)."""
        p, z = _f32(p_miss), _f32(0.0)
        return cls(p_gb=z, p_bg=z, p_miss_good=p, p_miss_bad=p, p_drop=z,
                   p_recover=_f32(1.0),
                   policy=policy or DegradePolicy.zero_fill())

    @classmethod
    def gilbert_elliott(cls, *, p_gb, p_bg, p_miss_good=0.0, p_miss_bad=0.5,
                        policy: Optional[DegradePolicy] = None
                        ) -> "FaultModel":
        return cls(p_gb=_f32(p_gb), p_bg=_f32(p_bg),
                   p_miss_good=_f32(p_miss_good),
                   p_miss_bad=_f32(p_miss_bad), p_drop=_f32(0.0),
                   p_recover=_f32(1.0),
                   policy=policy or DegradePolicy.zero_fill())

    @classmethod
    def burst(cls, *, burst_len: float, gap_len: float, p_miss_bad=0.5,
              p_miss_good=0.0, policy: Optional[DegradePolicy] = None
              ) -> "FaultModel":
        """Gilbert–Elliott by mean sojourn times: bad spans average
        ``burst_len`` frames, good spans ``gap_len`` frames."""
        if burst_len < 1.0 or gap_len < 1.0:
            raise ValueError(
                f"burst_len/gap_len are mean sojourns in frames, >= 1 "
                f"(got {burst_len}, {gap_len})")
        return cls.gilbert_elliott(
            p_gb=1.0 / gap_len, p_bg=1.0 / burst_len,
            p_miss_good=p_miss_good, p_miss_bad=p_miss_bad, policy=policy)

    def with_dropout(self, p_drop, p_recover=0.25) -> "FaultModel":
        return dataclasses.replace(self, p_drop=_f32(p_drop),
                                   p_recover=_f32(p_recover))

    def with_policy(self, policy: DegradePolicy) -> "FaultModel":
        return dataclasses.replace(self, policy=policy)

    def to(self, device) -> "FaultModel":
        """The same model with its probabilities on ``device``."""
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in _LEAVES})


def stack_models(models: Sequence[FaultModel], n_workers: int,
                 device=None) -> FaultModel:
    """One lane per model: each probability stacked to ``(L, 1)``, or to
    ``(L, N)`` where some lane has it per worker.  The models must share
    one policy."""
    policies = {fm.policy for fm in models}
    if len(policies) != 1:
        raise ValueError(
            f"all fault lanes must share one DegradePolicy, got {policies}")
    leaves = {}
    for f in _LEAVES:
        xs = [getattr(fm, f) for fm in models]
        width = n_workers if any(x.ndim for x in xs) else 1
        leaves[f] = torch.stack([x.to(device).expand(width) for x in xs])
    return FaultModel(policy=models[0].policy, **leaves)


def _as_lane(model: FaultModel) -> FaultModel:
    """A single channel's model as a lane stack of one: ``(1, 1)`` or
    ``(1, N)`` probabilities."""
    return dataclasses.replace(model, **{
        f: getattr(model, f).reshape(1, -1) for f in _LEAVES})


@dataclasses.dataclass(frozen=True)
class FaultState:
    """The carried fault state of one channel (or, lane-stacked, of each).

    ``stale`` caches the last resolved pooled value (the ``stale``
    policy's replay source, carried whatever the policy), ``age`` counts
    frames since the last resolved frame, ``consec`` consecutive dropped
    frames."""

    bad: torch.Tensor       # (N,) bool — sensing chain state
    offline: torch.Tensor   # (N,) bool — dropout chain state
    stale: torch.Tensor     # pooled-shape cache of the last resolved frame
    age: torch.Tensor       # () int32 — frames since last resolution
    consec: torch.Tensor    # () int32 — consecutive dropped frames

    def map(self, fn) -> "FaultState":
        """``fn`` applied to every tensor (``.to(device)``, a lane stack)."""
        return FaultState(**{f.name: fn(getattr(self, f.name))
                             for f in dataclasses.fields(self)})


def init_state(n_workers: int, pooled_shape: Tuple[int, ...] = (),
               dtype=torch.float32, device=None) -> FaultState:
    """All-good initial state: every worker online, chain in the good
    state, an empty stale cache of the pooled shape ``h.shape[1:]``."""
    return FaultState(
        bad=torch.zeros((n_workers,), dtype=torch.bool, device=device),
        offline=torch.zeros((n_workers,), dtype=torch.bool, device=device),
        stale=torch.zeros(pooled_shape, dtype=dtype, device=device),
        age=torch.zeros((), dtype=torch.int32, device=device),
        consec=torch.zeros((), dtype=torch.int32, device=device))


@dataclasses.dataclass(frozen=True)
class FaultAccounting:
    """Channel accounting of one fault-aware aggregation (one value per
    lane in a lane stack).  The first four fields keep the
    ``ProtocolAccounting`` names; ``contention_slots`` includes the retry
    bill."""

    rounds: torch.Tensor            # int32
    collisions: torch.Tensor        # int32
    contention_slots: torch.Tensor  # int32 — core slots + retry_slots
    correct_frac: torch.Tensor      # float32 — 0.0 on a dropped frame
    dropped_frames: torch.Tensor    # int32 — sub-frames that resolved nothing
    stale_age: torch.Tensor         # int32 — frames since last resolution
    offline_workers: torch.Tensor   # int32
    retry_slots: torch.Tensor       # int32 — extra airtime spent retrying
    outage: torch.Tensor            # int32 — 1 if this frame was dropped


# ---------------------------------------------------------------------------
# chain evolution (side-stream keys; the sensing stream untouched)
# ---------------------------------------------------------------------------

def step_chains(model: FaultModel, state: FaultState, rng: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Markov step of both chains: ``(new_bad, new_offline)``.  ``rng``
    is ``(2,)`` for a single channel or ``(L, 2)`` for a lane stack (one
    key per lane, folded with each tag)."""
    n = state.bad.shape[-1]
    # both side streams in one fold_in and one draw (the same bits as two)
    u = _tagged_uniform(rng, range(_CHAIN_TAG, _DROP_TAG + 1,
                                   _DROP_TAG - _CHAIN_TAG), n)
    u_s, u_d = u[..., 0, :], u[..., 1, :]
    new_bad = torch.where(state.bad, u_s >= model.p_bg, u_s < model.p_gb)
    new_offline = torch.where(state.offline, u_d >= model.p_recover,
                              u_d < model.p_drop)
    return new_bad, new_offline


def _tagged_uniform(rng: torch.Tensor, tags: range, n: int) -> torch.Tensor:
    """``uniform(fold_in(rng, tag), (n,))`` for each tag, stacked on the
    axis before the last: ``rng (..., 2)`` -> ``(..., len(tags), n)``.
    The tags are a ``range``, made on the key's device by one ``arange``
    (no host copy)."""
    data = torch.arange(tags.start, tags.stop, tags.step, dtype=torch.int64,
                        device=rng.device)
    return jr.uniform(jr.fold_in(rng.unsqueeze(-2), data), (n,),
                      torch.float32)


def effective_p_miss(model: FaultModel, bad: torch.Tensor) -> torch.Tensor:
    """Per-worker sensing miss probability under the chain state."""
    return torch.where(bad, model.p_miss_bad, model.p_miss_good)


def _retry_recover(model: FaultModel, offline: torch.Tensor,
                   rng: torch.Tensor, frame_slots: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bounded retransmission over a lane stack: while a lane is in total
    outage, re-draw worker recovery up to ``retry_budget`` times, billing
    each attempt a full contention frame plus an exponential-backoff wait.
    ``offline (L, N)``, ``rng (L, 2)`` -> (offline, retry_slots (L,))."""
    budget = model.policy.retry_budget
    # every attempt's draw at once: uniform(fold_in(kr, a)) for each a
    u_all = _tagged_uniform(jr.fold_in(rng, _RETRY_TAG), range(budget),
                            offline.shape[-1])
    retry_slots = torch.zeros(offline.shape[:-1], dtype=torch.int32,
                              device=offline.device)
    for a in range(budget):                       # unrolled: the budget is
        outage = ~(~offline).any(-1)              # policy metadata
        u = u_all[..., a, :]
        retry_slots = retry_slots + outage.to(torch.int32) * (
            frame_slots + 2 ** a)
        offline = torch.where(outage[:, None],
                              offline & (u >= model.p_recover), offline)
    return offline, retry_slots


# ---------------------------------------------------------------------------
# the fault-aware pooling law: degraded frames never invent gradient signal
# ---------------------------------------------------------------------------

class _FaultPool(torch.autograd.Function):
    """Lane-leading noisy pooling + outage gating + the stale-cache carry.

    ``h (L, N, ..., K)``, or with ``with_ideal`` ``(L+1, N, ..., K)`` whose
    last lane is the ideal ``maxpool_quantized(bits, "first")`` run (the
    curve engine's lane stack, as ``fedocs.stack_pool``); ``rng (L, 2)``,
    ``p_eff (L, N)``, ``online (L, N)``, ``stale (L, ..., K)``.

    Outputs ``(pooled, new_stale, ok, rounds, collisions,
    contention_slots, correct)``.  A lane with an online worker (``ok``)
    pools bit for bit as the plain noisy law; a dark lane's raw pool is no
    value (a column with no contender may decode to -inf), so it is
    selected away with ``torch.where``, never multiplied by 0.  The
    backward is one winner-routed scatter: lane l's winner receives
    ``(g_pooled + g_new_stale) * okf``, and ``g * onehot`` keeps the signs
    of the zeros that the JAX package's ``g * (okf * onehot)`` gives."""

    @staticmethod
    def forward(ctx, h, rng, p_eff, online, stale, bits, max_rounds,
                backend, stale_fill, with_ideal):
        lanes, n = rng.shape[0], h.shape[1]
        stack = h.shape[0]
        flat = h.reshape(stack, n, -1)
        pooled = torch.empty((stack, flat.shape[2]), dtype=h.dtype,
                             device=h.device)
        winner = torch.empty(pooled.shape, dtype=torch.int32,
                             device=h.device)
        _, _, res = fedocs._maxpool_noisy_impl(
            flat[:lanes], rng, p_eff, bits, max_rounds, backend, online,
            out=(pooled[:lanes], winner[:lanes]))
        if with_ideal:
            maxpool_ops.maxpool_decode(
                flat[lanes:], bits, h.dtype, argmax=True,
                out=PoolDecode(pooled[lanes:], None, winner[lanes:], None))
        ok = online.any(-1)
        okb = ok.reshape((lanes,) + (1,) * (stale.ndim - 1))
        raw = pooled[:lanes].reshape(stale.shape)
        fill = stale if stale_fill else torch.zeros_like(stale)
        new_stale = torch.where(okb, raw, stale)
        pooled[:lanes] = torch.where(okb, raw, fill).reshape(lanes, -1)
        okf = ok.to(h.dtype)
        ctx.save_for_backward(winner, okf)
        ctx.h_shape, ctx.lanes, ctx.stale_fill = h.shape, lanes, stale_fill
        acct = (ok, res.rounds, res.collisions, res.contention_slots,
                res.correct)
        ctx.mark_non_differentiable(*acct)
        ctx.set_materialize_grads(False)
        return (pooled.reshape((stack,) + h.shape[2:]), new_stale, *acct)

    @staticmethod
    def backward(ctx, g_pooled, g_new_stale, *_acct):
        winner, okf = ctx.saved_tensors
        stack, n = ctx.h_shape[:2]
        lanes = ctx.lanes
        if g_pooled is None:
            g_pooled = torch.zeros(ctx.h_shape[:1] + ctx.h_shape[2:],
                                   dtype=okf.dtype, device=okf.device)
        g_lanes = g_pooled[:lanes]
        # the JAX package's cotangent of an unused output is a zero: add
        # it all the same, for the signs of the zeros it gives
        g_stale = (torch.zeros_like(g_lanes) if g_new_stale is None
                   else g_new_stale)
        g_sum = g_lanes + g_stale
        okb = okf.reshape((lanes,) + (1,) * (g_sum.ndim - 1))
        g_route = g_pooled.reshape(stack, -1).clone()
        g_route[:lanes] = (g_sum * okb).reshape(lanes, -1)
        d_h = maxpool_ops.maxpool_winner_bwd(winner, g_route, n, dim=1)
        # on a dropped frame the cache passes through to new_stale and,
        # under the stale policy, is the pooled output as well
        d_stale = None
        if ctx.needs_input_grad[4]:
            d_stale = (1.0 - okb) * (g_stale + (
                g_lanes if ctx.stale_fill else torch.zeros_like(g_lanes)))
        return (d_h.reshape(ctx.h_shape), None, None, None, d_stale, None,
                None, None, None, None)


def _aggregate_lanes(protocol, model: FaultModel, state: FaultState,
                     h: torch.Tensor, rng: torch.Tensor, with_ideal: bool
                     ) -> Tuple[torch.Tensor, FaultState, FaultAccounting]:
    if protocol.kind != "ocs":
        raise ValueError(
            f"fault injection needs an OCS protocol, got {protocol.kind!r}")
    n = h.shape[1]
    rng, model = rng.to(h.device), model.to(h.device)
    new_bad, new_offline = step_chains(model, state, rng)
    lanes = new_bad.shape[0]
    retry_slots = torch.zeros((lanes,), dtype=torch.int32, device=h.device)
    m_frames = math.prod(h.shape[2:])         # pooled elements of a lane
    if model.policy.kind == "retry":
        frame_slots = (protocol.bits + ocs.host_id_bits(n)) * m_frames
        new_offline, retry_slots = _retry_recover(model, new_offline, rng,
                                                  frame_slots)
    online = ~new_offline
    p_eff = effective_p_miss(model, new_bad)
    pooled, new_stale, ok, rounds, collisions, slots, correct = \
        _FaultPool.apply(h, rng, p_eff, online, state.stale, protocol.bits,
                         protocol.max_rounds, protocol.backend,
                         model.policy.kind == "stale", with_ideal)
    zero = torch.zeros((), dtype=torch.int32, device=h.device)
    age = torch.where(ok, zero, state.age + 1)
    consec = torch.where(ok, zero, state.consec + 1)
    new_state = FaultState(bad=new_bad, offline=new_offline, stale=new_stale,
                           age=age, consec=consec)
    frac = mean_f32(correct.to(torch.float32))
    acct = FaultAccounting(
        rounds=rounds, collisions=collisions,
        contention_slots=slots + retry_slots,
        correct_frac=torch.where(ok, frac, torch.zeros_like(frac)),
        dropped_frames=torch.where(ok, zero, zero + m_frames),
        stale_age=age,
        offline_workers=new_offline.sum(-1, dtype=torch.int32),
        retry_slots=retry_slots,
        outage=(~ok).to(torch.int32))
    return pooled, new_state, acct


def aggregate(protocol, model: FaultModel, state: FaultState,
              h: torch.Tensor, rng: torch.Tensor, *, lanes: bool = False
              ) -> Tuple[torch.Tensor, FaultState, FaultAccounting]:
    """Fault-aware OCS aggregation: one contention frame under the fault
    process.

    Evolves both Markov chains, runs the (possibly retried) contention
    with the effective per-worker miss probabilities and the offline
    workers out of the mask, applies the degrade policy on outage, and
    bills everything through :class:`FaultAccounting`.  ``protocol``
    supplies ``bits``/``max_rounds``/``backend``; its own ``p_miss`` is
    superseded by the model's.  ``h (N, ..., K)`` and a ``(2,)`` key; with
    ``lanes`` a lane-stacked model and state, ``h (L, N, ..., K)`` and
    ``(L, 2)`` keys.  Returns ``(pooled, new_state, accounting)``."""
    if lanes:
        return _aggregate_lanes(protocol, model, state, h, rng, False)
    pooled, st, acct = _aggregate_lanes(
        protocol, _as_lane(model), state.map(lambda t: t[None]), h[None],
        rng[None], False)
    return (pooled[0], st.map(lambda t: t[0]),
            FaultAccounting(**{f.name: getattr(acct, f.name)[0]
                               for f in dataclasses.fields(acct)}))


def aggregate_with_ideal(protocol, model: FaultModel, state: FaultState,
                         h: torch.Tensor, rng: torch.Tensor
                         ) -> Tuple[torch.Tensor, FaultState,
                                    FaultAccounting]:
    """The curve engine's lane stack ``h (L+1, N, ..., K)``: lanes
    ``0..L-1`` as ``aggregate(..., lanes=True)`` and lane ``L`` pooled by
    the ideal ``maxpool_quantized(bits, "first")``, in one call with one
    backward launch.  State and accounting cover the L fault lanes."""
    return _aggregate_lanes(protocol, model, state, h, rng, True)
