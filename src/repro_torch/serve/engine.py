"""Channel-in-the-loop serving: slot-based continuous batching with the
wireless aggregation protocol inside the decode tick (the JAX package's
``serve/engine.py``).

A fixed budget of B slots decodes in lock-step.  Each tick decodes through
the stack (optionally aggregating every mlp-FFN worker fusion through a
simulated :class:`repro_torch.protocol.Protocol` channel), picks the next
token greedily and advances the positions, all on the engine's device; the
host reads the tick's tokens, positions and channel slots back in one
copy.  Finished slots (EOS, budget or length cap) retire and refill from
the arrival queue by a single-request prefill whose cache (KV rows,
recurrent states) is copied into the batch cache at the slot, in place,
along each leaf's batch axis (``model.cache_rows``: axis 1 of a stacked
KV buffer, axis 2 of a stacked mLSTM memory or mamba state, whose axis 1
is the workers').  A prompt has at least ``model.min_prompt()`` tokens: a
mamba layer caches the last ``conv_width - 1`` rows of its prompt.

Under a mesh (``sharding.use_mesh`` around the engine's construction and
its runs) the batch cache is this rank's block (``model.cache_init``): a
data split gives each rank its block of the slots, whose prefills only
that rank copies in; a ``kv_seq`` split gives each rank its block of
every slot's positions, and the prefill's cache is that block already.
Every rank decodes the whole batch's tokens and returns every request.

Airtime accounting: the contention core measures the channel slots each
tick consumed (``ProtocolAccounting`` summed over the stack's
``channel_sites``), and a :class:`ChannelClock` converts ticks + slots to
wall time, so every :class:`Completion` carries its latency decomposed
into compute ticks and channel slots.

Fault injection (``ServeConfig.fault``, a ``repro_torch.faults
.FaultModel``): each tick steps the Gilbert–Elliott and dropout chains,
rebinds the protocol's ``p_miss`` and ``online`` mask, and on an outage
tick (every worker offline) lets the model's policy decide what the slots
emit: ``stale`` repeats the last token, ``zero_fill`` emits 0, ``retry``
holds the tick (token, position) within its budget.  A held tick leaves
the KV cache as the decode wrote it: the decode writes each layer's row at
``positions`` before that layer's attention reads it, and the next tick
writes the same rows again, so no copy of the KV cache is needed to undo
it.  A recurrent state (mamba, mLSTM, sLSTM) is overwritten whole by the
decode and would advance twice: under a ``retry`` policy each tick copies
the recurrent leaves before the decode and puts them back where the tick
does not commit (``torch.where(commit, new, old)``, on the device, as the
JAX tick selects its cache); other policies always commit and pay
nothing.

``ServeConfig(greedy=False)`` samples each tick's tokens with
``random.categorical`` under ``fold_in(fold_in(PRNGKey(seed), 0x5A),
tick)``, the JAX package's key (the prefill's first token stays the
argmax, as there).

``dispatch_counts()["tick"]`` counts decode ticks.  The JAX package's
``trace_counts`` has no counterpart: nothing here compiles.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import faults
from repro_torch import random as jr
from repro_torch import tree
from repro_torch.parallel import sharding
from repro_torch.protocol import Protocol

_DISPATCH_COUNTS = {"tick": 0}


def dispatch_counts() -> Dict[str, int]:
    return dict(_DISPATCH_COUNTS)


def reset_dispatch_counts() -> None:
    _DISPATCH_COUNTS["tick"] = 0


@dataclasses.dataclass(frozen=True)
class ChannelClock:
    """Converts the engine's discrete accounting to wall time.

    ``tick_us`` is the compute cost of one lock-step decode tick;
    ``slot_us`` the airtime of one channel sub-slot (contention bit-slots
    and payload bits are both billed in ``contention_slots`` units)."""

    tick_us: float = 50.0
    slot_us: float = 1.0

    def __post_init__(self):
        if self.tick_us <= 0 or self.slot_us <= 0:
            raise ValueError("ChannelClock times must be positive")

    def latency_us(self, ticks: int, slots: int) -> float:
        return ticks * self.tick_us + slots * self.slot_us


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Typed serving surface.

    ``protocol=None`` serves channel-free.  An OCS protocol must carry a
    bound ``p_miss``; ``ServeEngine.run(requests, protocol=...)``
    overrides it per run.  ``fault`` (a ``repro_torch.faults.FaultModel``)
    runs the channel under bursts and worker outages; ``greedy=False``
    samples the decoded tokens instead of taking the argmax."""

    batch_slots: int = 4
    max_seq: int = 128
    eos_id: int = 1
    greedy: bool = True
    protocol: Optional[Protocol] = None
    fault: Optional[faults.FaultModel] = None
    clock: ChannelClock = dataclasses.field(default_factory=ChannelClock)
    seed: int = 0

    def __post_init__(self):
        if self.batch_slots < 1:
            raise ValueError("batch_slots must be >= 1")
        if self.max_seq < 2:
            raise ValueError("max_seq must be >= 2")
        if self.protocol is not None and self.protocol.kind == "concat":
            raise ValueError(
                "concat protocols cannot serve in-block fusion (the fused "
                "width N*K does not match the residual width K)")
        if self.fault is not None and self.protocol is None:
            raise ValueError(
                "fault injection needs a channel protocol (fault models "
                "perturb the sensing channel)")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int = 32
    arrival_tick: int = 0        # Poisson load generators set this


@dataclasses.dataclass
class Completion:
    """One served request under the channel budget.

    ``latency_ticks`` spans arrival to retirement (queue wait included);
    ``channel_slots`` is the measured contention+payload airtime the
    shared channel consumed over that span; ``uplink_bits`` the analytic
    uplink (``Protocol.comm_load`` per aggregate call x channel sites x
    channel-decoded tokens).  All three channel fields are 0 when serving
    channel-free.  Under fault injection ``degraded_tokens`` counts the
    tokens emitted on outage ticks (the policy's filler) and
    ``retry_ticks`` the ticks the batch was held re-contending."""

    rid: int
    tokens: List[int]
    prompt_len: int
    latency_ticks: int = 0
    channel_slots: int = 0
    uplink_bits: int = 0
    degraded_tokens: int = 0
    retry_ticks: int = 0

    def latency_us(self, clock: ChannelClock) -> float:
        return clock.latency_us(self.latency_ticks, self.channel_slots)


_UNSET = object()


class ServeEngine:
    """Slot-batched serving engine over an optional simulated channel.

    ``device`` defaults to ``cuda`` and raises without a GPU; pass
    ``device="cpu"`` to serve on the CPU (the kernels' plain versions)."""

    def __init__(self, model, values, config: ServeConfig, *, device=None):
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServeEngine runs on cuda by default and no "
                               "GPU is visible; pass device='cpu'")
        self.m = model
        self.device = dev
        self.values = tree.map(lambda t: t.to(dev), values)
        self.config = config
        self.B = config.batch_slots
        self.max_seq = config.max_seq
        self.eos = config.eos_id
        self._sites = model.channel_sites()
        self._d_model = model.cfg.d_model
        self._n_workers = model.cfg.n_workers
        self.cache = model.cache_init(self.B, self.max_seq, dev)
        self._cache_rows = model.cache_rows(self.cache)
        # the slots of this rank's block, under a data split of them
        rows, _ = sharding.cache_splits(self.B, self.max_seq)
        self._slots = sharding.local_size(self.B, rows)
        self._first_slot = 0 if rows is None else rows.index * self._slots
        # the cache's recurrent states, which a held retry tick restores
        self._recurrent = model.recurrent_leaves(self.cache)
        self._min_prompt = model.min_prompt()
        self._base_key = jr.PRNGKey(config.seed, dev)
        self._sample_key = jr.fold_in(self._base_key, 0x5A)
        self._reset()

    # -- analytic uplink accounting ----------------------------------------

    def _uplink_bits_per_tick(self, protocol: Optional[Protocol]) -> int:
        """Per-slot analytic uplink bits of one channel-decoded token."""
        if protocol is None:
            return 0
        load = protocol.comm_load(self._n_workers, self._d_model)
        return load.uplink_bits * self._sites

    # -- slot management ----------------------------------------------------

    def _reset(self) -> None:
        """Clear slot state between runs (the cache is reused: a prefill
        copy overwrites a slot's rows end to end before it activates)."""
        self.positions = torch.zeros((self.B,), dtype=torch.int32,
                                     device=self.device)
        self.cur_token = torch.zeros((self.B, 1), dtype=torch.int32,
                                     device=self.device)
        self.active = np.zeros((self.B,), bool)
        self.budget = np.zeros((self.B,), np.int64)
        self.slot_req: List[Optional[Request]] = [None] * self.B
        self.outputs: Dict[int, Completion] = {}

    @torch.no_grad()
    def _insert(self, slot: int, req: Request):
        if len(req.prompt) < self._min_prompt:
            raise ValueError(
                f"request {req.rid}: a prompt of {len(req.prompt)} tokens; "
                f"this model's prefill builds its cache from at least "
                f"{self._min_prompt}")
        tokens = torch.as_tensor(np.asarray(req.prompt, np.int32),
                                 device=self.device)[None]
        logits, cache1 = self.m.prefill(self.values, {"tokens": tokens},
                                        max_seq=self.max_seq)

        at = slot - self._first_slot
        if 0 <= at < self._slots:
            # e.g. (periods, B, S, kv, hd) <- (periods, 1, S, kv, hd)
            tree.map(lambda batch_leaf, one_leaf, axis: batch_leaf.narrow(
                axis, at, 1).copy_(one_leaf), self.cache, cache1,
                self._cache_rows)
        tok = int(torch.argmax(logits, -1)[0])
        self.cur_token[slot, 0] = tok
        self.positions[slot] = len(req.prompt)
        self.active[slot] = True
        self.budget[slot] = req.max_new_tokens - 1
        self.slot_req[slot] = req
        self.outputs[req.rid] = Completion(
            rid=req.rid, tokens=[tok], prompt_len=len(req.prompt))

    def _retire(self, slot: int):
        self.active[slot] = False
        self.slot_req[slot] = None

    @torch.no_grad()
    def _tick(self, protocol: Optional[Protocol], tick: int, fault=None):
        """One decode tick over all B slots; returns (next tokens,
        positions, channel slots of the tick, flags) read back in one
        copy.  ``flags`` is None without ``fault``, else ``(ok,
        retrying)``: whether some worker was online, and whether the tick
        was held for a retry."""
        # the tick's one host read: the tokens, positions, slots and flags
        host = self._tick_device(protocol, tick, fault).cpu().numpy() \
            .astype(np.int64)
        chan = protocol is not None
        slots = int(host[2 * self.B]) if chan else 0
        flags = None if fault is None else (bool(host[2 * self.B + 1]),
                                            bool(host[2 * self.B + 2]))
        return host[:self.B], host[self.B:2 * self.B], slots, flags

    def _tick_device(self, protocol: Optional[Protocol], tick: int,
                     fault=None) -> torch.Tensor:
        """The tick's device part: decode, pick, advance the slots' state
        on the device, and return ``[tokens (B), positions (B), slots (1)
        where a protocol is given, flags (2) where a fault is]`` as one
        int32 tensor on the device, which :meth:`_tick` reads back."""
        held = None
        if fault is not None and fault.policy.kind == "retry":
            held = [t.clone() for t in self._recurrent]
        if protocol is None:
            logits, self.cache = self.m.decode_step(
                self.values, self.cur_token, self.positions, self.cache)
            chan_slots = None
        else:
            rng = jr.fold_in(self._base_key, tick)
            if fault is not None:
                # one Markov step of the burst and dropout chains a tick,
                # bound into the protocol's p_miss and worker mask
                new_bad, new_offline = faults.step_chains(
                    fault, self.fstate, rng)
                online = ~new_offline
                protocol = protocol.with_p_miss(faults.effective_p_miss(
                    fault, new_bad)).with_online(online)
            logits, self.cache, chan = self.m.decode_step_channel(
                self.values, self.cur_token, self.positions, self.cache,
                protocol, rng)
            chan_slots = chan["contention_slots"].reshape(1)
        if self.config.greedy:
            nxt = torch.argmax(logits, -1).to(torch.int32)
        else:
            nxt = jr.categorical(jr.fold_in(self._sample_key, tick),
                                 logits).to(torch.int32)
        new_positions = self.positions + 1
        flags = None
        if fault is not None:
            nxt, new_positions, flags, commit = self._degrade(
                fault, nxt, new_positions, online, new_bad, new_offline)
            for new, old in zip(self._recurrent, held or ()):
                new.copy_(torch.where(commit, new, old))
        self.positions = new_positions
        self.cur_token = nxt[:, None]
        parts = [nxt, new_positions]
        if chan_slots is not None:
            parts.append(chan_slots.to(torch.int32))
        if flags is not None:
            parts.append(flags)
        return torch.cat(parts)

    def _degrade(self, fault, nxt, new_positions, online, new_bad,
                 new_offline):
        """The policy on an outage tick (every worker offline: the pooled
        fusions resolved nothing and the decode's tokens are no value):
        what the slots emit, whether the tick commits, and the carried
        chain state.  Returns (tokens, positions, flags int32 (2,), commit
        (a 0-d bool on the device))."""
        st = self.fstate
        ok = online.any()
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        consec = torch.where(ok, zero, st.consec + 1)
        age = torch.where(ok, zero, st.age + 1)
        kind = fault.policy.kind
        cur = self.cur_token[:, 0]
        if kind == "retry":
            retrying = ~ok & (consec <= fault.policy.retry_budget)
        else:
            retrying = torch.zeros((), dtype=torch.bool, device=self.device)
        # stale repeats the last token; zero_fill and a spent retry emit 0
        degraded = cur if kind == "stale" else torch.zeros_like(nxt)
        nxt = torch.where(ok, nxt, degraded)
        # a retry tick makes no progress: token and position hold
        commit = ok | ~retrying
        nxt = torch.where(commit, nxt, cur)
        positions = torch.where(commit, new_positions, self.positions)
        self.fstate = faults.FaultState(bad=new_bad, offline=new_offline,
                                        stale=st.stale, age=age,
                                        consec=consec)
        flags = torch.stack([ok, retrying]).to(torch.int32)
        return nxt, positions, flags, commit

    # -- main loop ----------------------------------------------------------

    def run(self, requests: List[Request],
            protocol=_UNSET, fault=_UNSET) -> Dict[int, Completion]:
        """Serve ``requests`` to completion; returns ``{rid: Completion}``.

        Requests are admitted FIFO by ``arrival_tick`` (ties keep
        submission order); with no slot busy and no arrival due, the tick
        counter jumps to the next arrival.  ``protocol`` overrides the
        config's (``None`` for an explicitly channel-free run), and
        ``fault`` the config's fault model: outage ticks then degrade
        completions by its policy instead of wedging the queue."""
        proto = self.config.protocol if protocol is _UNSET else protocol
        fm = self.config.fault if fault is _UNSET else fault
        if fm is not None and proto is None:
            raise ValueError("fault injection needs a channel protocol")
        if fm is not None:
            fm = fm.to(self.device)
            self.fstate = faults.init_state(self._n_workers,
                                            device=self.device)
        bits_per_tok = self._uplink_bits_per_tick(proto)
        self._reset()
        pending = sorted(requests, key=lambda r: r.arrival_tick)
        admissible: List[Request] = []
        tick = 0
        total_slots = 0                       # cumulative measured airtime
        slots_at_arrival: Dict[int, int] = {}
        arrival_of: Dict[int, int] = {}
        while pending or admissible or self.active.any():
            while pending and pending[0].arrival_tick <= tick:
                r = pending.pop(0)
                admissible.append(r)
                slots_at_arrival[r.rid] = total_slots
                arrival_of[r.rid] = r.arrival_tick
            if not self.active.any() and not admissible:
                tick = pending[0].arrival_tick   # idle: jump to next arrival
                continue
            for slot in range(self.B):
                if not self.active[slot] and admissible:
                    self._insert(slot, admissible.pop(0))
            _DISPATCH_COUNTS["tick"] += 1
            nxt, pos, slots, flags = self._tick(proto, tick, fm)
            tick += 1
            total_slots += slots
            if flags is not None and flags[1]:
                # a retry tick: the batch held position re-contending; the
                # stall is billed to every request in flight
                for slot in range(self.B):
                    if self.active[slot]:
                        self.outputs[self.slot_req[slot].rid].retry_ticks \
                            += 1
                continue
            degraded = flags is not None and not flags[0]
            for slot in range(self.B):
                if not self.active[slot]:
                    continue
                req = self.slot_req[slot]
                out = self.outputs[req.rid]
                out.tokens.append(int(nxt[slot]))
                out.uplink_bits += bits_per_tok
                if degraded:
                    out.degraded_tokens += 1
                self.budget[slot] -= 1
                done = (int(nxt[slot]) == self.eos
                        or self.budget[slot] <= 0
                        or int(pos[slot]) >= self.max_seq - 1)
                if done:
                    out.latency_ticks = tick - arrival_of[req.rid]
                    out.channel_slots = (
                        total_slots - slots_at_arrival[req.rid])
                    self._retire(slot)
        return self.outputs

