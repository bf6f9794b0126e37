"""Wireless-aggregation protocols as values.

One frozen :class:`Protocol` carries every protocol-side knob and answers
the questions its consumers ask:

  * ``protocol.aggregate(h, rng) -> (pooled, ProtocolAccounting)`` — the
    aggregation law, with the winner-routed backward (paper Eq. 5-6);
  * ``protocol.aggregate_with_ideal(h, rng)`` — an OCS lane stack with the
    ideal reference run as its last lane, pooled in one call;
  * ``protocol.comm_load(n_workers, k)`` — the analytic uplink/latency
    accounting (paper §I / §IV), its payload bits resolved from the
    protocol itself;
  * ``protocol.output_dim(n_workers, k)`` — the fused width the head sees.

``p_miss`` (scalar or per-worker ``(N,)``; lane-stacked ``(L,)`` or
``(L, N)`` with ``lanes=True``) and ``online`` are the state a run varies;
the other fields are fixed.  ``backend`` keeps the JAX package's names:
``"scan"`` and ``"pallas"`` give the same bits, and the device decides what
runs — a CUDA tensor goes through the contention kernel either way.

    Protocol.ocs(bits=8, p_miss=0.05)      # noisy-OCS channel in the loop
    Protocol.ideal_max(bits=16)            # error-free quantized max-pool
    Protocol.max() / .mean() / .concat() / .sum()   # paper baselines
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.core import channel, fedocs, ocs

KINDS = ("sum", "max", "ideal_max", "ocs", "mean", "concat")

# string-mode names (fedocs.VALID_MODES) -> Protocol kinds
_MODE_TO_KIND = {
    "sum": "sum",
    "max": "max",
    "max_q16": "ideal_max",
    "max_q8": "ideal_max",
    "max_noisy": "ocs",
    "mean": "mean",
    "concat": "concat",
}


@dataclasses.dataclass(frozen=True)
class ProtocolAccounting:
    """Measured channel accounting of one ``Protocol.aggregate`` call.

    Non-trivial only for ``kind="ocs"``; the ideal kinds consume no
    simulated channel and report zeros.  ``collisions`` counts collided
    (sub-frame, round) events, ``rounds`` the rounds until every sub-frame
    resolved, ``contention_slots`` the sub-slots billed to unresolved
    sub-frames, ``correct_frac`` the fraction of elements whose winner held
    the true max code.  With lanes every field has a leading lane axis.
    """

    rounds: torch.Tensor            # int32
    collisions: torch.Tensor        # int32
    contention_slots: torch.Tensor  # int32
    correct_frac: torch.Tensor      # float32

    @staticmethod
    def zeros(shape=(), device=None) -> "ProtocolAccounting":
        z = torch.zeros(shape, dtype=torch.int32, device=device)
        return ProtocolAccounting(
            rounds=z, collisions=z, contention_slots=z,
            correct_frac=torch.ones(shape, dtype=torch.float32,
                                    device=device))


def mean_f32(x: torch.Tensor) -> torch.Tensor:
    """The mean over the last axis as XLA computes ``jnp.mean`` of float32:
    the sum times ``1/n``, which is not always the sum divided by n."""
    return x.sum(-1) * (1.0 / x.shape[-1])


def _accounting(rounds, collisions, slots, correct) -> ProtocolAccounting:
    """The noisy laws' accounting outputs as a ``ProtocolAccounting``."""
    frac = mean_f32(correct.to(torch.float32))
    return ProtocolAccounting(
        rounds=rounds, collisions=collisions, contention_slots=slots,
        correct_frac=frac)


def _ocs_pool(h, rng, p_miss, online, bits, max_rounds, backend):
    """Lane-leading noisy pooling with the core's accounting.  The
    backward routes the cotangent to the winner and gives rng, p_miss and
    online no gradient."""
    pooled, *acct = fedocs.noisy_pool(h, rng, p_miss, online, bits,
                                      max_rounds, backend)
    return pooled, _accounting(*acct)


@dataclasses.dataclass(frozen=True)
class Protocol:
    """One wireless aggregation protocol as a frozen value.

    Build it with the named constructors (:meth:`ocs`, :meth:`ideal_max`,
    :meth:`max`, :meth:`mean`, :meth:`concat`, :meth:`sum`, or
    :meth:`from_mode` for the legacy string-mode names).
    """

    kind: str                       # one of KINDS
    bits: Optional[int] = None      # D, backoff/payload depth
    tie_break: str = "all"          # gradient routing at code ties
    max_rounds: int = 3             # ocs: re-contention bound
    backend: str = "scan"           # ocs: "scan" | "pallas" (same bits)
    n_channels: int = 1             # OFDMA channels (comm_load latency)
    payload_bits: Optional[int] = None   # comm_load override; None derives
    #   it (D-bit code payload for ocs/ideal_max, 32-bit float otherwise)
    p_miss: Any = None              # () or (N,) miss probability, or with
    #   lanes (L,) / (L, N); None = unbound (bind via with_p_miss)
    online: Any = None              # (N,) or (L, N) bool worker-up mask;
    #   None = all workers contend

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown protocol kind {self.kind!r}; valid: {KINDS}")
        if self.kind in ("ideal_max", "ocs", "max"):
            if self.bits is None or not 1 <= self.bits <= 32:
                raise ValueError(
                    f"{self.kind} protocol needs bits in [1, 32], "
                    f"got {self.bits}")
        if self.tie_break not in ("all", "first"):
            raise ValueError(f"unknown tie_break {self.tie_break!r}")
        if self.kind == "ocs":
            if self.backend not in ocs.NOISY_BACKENDS:
                raise ValueError(
                    f"unknown ocs backend {self.backend!r}; "
                    f"valid: {ocs.NOISY_BACKENDS}")
            if self.max_rounds < 1:
                raise ValueError("max_rounds must be >= 1")
        if self.n_channels < 1:
            raise ValueError("n_channels must be >= 1")

    # -- constructors -------------------------------------------------------

    @classmethod
    def sum(cls, *, n_channels: int = 1) -> "Protocol":
        """All-reduce(add) fusion (Megatron-style TP reference)."""
        return cls(kind="sum", n_channels=n_channels)

    @classmethod
    def max(cls, *, bits: int = 16, tie_break: str = "all",
            n_channels: int = 1) -> "Protocol":
        """Ideal float max-pool (paper Eq. 4): the D ``bits`` drive the
        contention accounting only; the winner transmits its full float."""
        return cls(kind="max", bits=bits, tie_break=tie_break,
                   n_channels=n_channels, payload_bits=32)

    @classmethod
    def ideal_max(cls, bits: int, *, tie_break: str = "all",
                  n_channels: int = 1) -> "Protocol":
        """Error-free quantized max-pool on D-bit monotone codes (Eq. 7):
        the winner's uplink payload is the D-bit code itself."""
        return cls(kind="ideal_max", bits=bits, tie_break=tie_break,
                   n_channels=n_channels)

    @classmethod
    def ocs(cls, bits: int = 16, p_miss=None, *, max_rounds: int = 3,
            backend: str = "scan", n_channels: int = 1,
            payload_bits: Optional[int] = None) -> "Protocol":
        """The paper's OCS channel with imperfect carrier sensing in the
        loop: quantized D-bit contention, per-sub-slot miss detection,
        lowest-index capture after ``max_rounds``."""
        return cls(kind="ocs", bits=bits, tie_break="first",
                   max_rounds=max_rounds, backend=backend,
                   n_channels=n_channels, payload_bits=payload_bits,
                   p_miss=p_miss)

    @classmethod
    def mean(cls, *, n_channels: int = 1) -> "Protocol":
        """Mean-pool baseline (paper "Avg. Workers Embed")."""
        return cls(kind="mean", n_channels=n_channels)

    @classmethod
    def concat(cls, *, n_channels: int = 1) -> "Protocol":
        """Concat baseline (paper "Concat Workers Embed", O(N*K) uplink)."""
        return cls(kind="concat", n_channels=n_channels)

    @classmethod
    def from_mode(cls, mode: str, *, tie_break: str = "all",
                  bits: int = 16, max_rounds: int = 3,
                  backend: str = "scan", p_miss=None) -> "Protocol":
        """Map a legacy ``fedocs.VALID_MODES`` string to a Protocol."""
        kind = _MODE_TO_KIND.get(mode)
        if kind is None:
            raise ValueError(
                f"unknown aggregation mode {mode!r}; "
                f"valid: {tuple(_MODE_TO_KIND)}")
        if mode == "max_q16":
            return cls.ideal_max(16, tie_break=tie_break)
        if mode == "max_q8":
            return cls.ideal_max(8, tie_break=tie_break)
        if mode == "max_noisy":
            return cls.ocs(bits=bits, p_miss=p_miss, max_rounds=max_rounds,
                           backend=backend)
        if mode == "max":
            return cls.max(bits=bits, tie_break=tie_break)
        return cls(kind=kind)

    # -- protocol state -----------------------------------------------------

    def with_p_miss(self, p_miss) -> "Protocol":
        """Bind (or rebind) the miss probability, e.g. a stack of lanes."""
        return dataclasses.replace(self, p_miss=p_miss)

    def with_online(self, online) -> "Protocol":
        """Bind (or rebind) the worker-up mask: dark workers leave the
        contention entirely."""
        return dataclasses.replace(self, online=online)

    # -- the aggregation law ------------------------------------------------

    def aggregate(self, h: torch.Tensor, rng: Optional[torch.Tensor] = None,
                  *, lanes: bool = False
                  ) -> Tuple[torch.Tensor, ProtocolAccounting]:
        """Pool a worker-leading feature tensor ``h: (N, ..., K)``.

        Returns ``(pooled, accounting)``.  ``kind="ocs"`` also needs
        ``rng`` (the sensing key, ``(2,)``) and a bound ``p_miss``.  With
        ``lanes`` every input carries a leading lane axis: ``h (L, N, ...,
        K)``, ``rng (L, 2)``, ``p_miss (L,)`` or ``(L, N)``, and so do the
        pooled value and the accounting.
        """
        dim = 1 if lanes else 0
        shape = h.shape[:1] if lanes else ()
        if self.kind != "ocs":
            zeros = ProtocolAccounting.zeros(shape, h.device)
            if self.kind == "sum":
                return torch.sum(h, dim=dim), zeros
            if self.kind == "max":
                return fedocs.maxpool(h, self.tie_break, dim), zeros
            if self.kind == "ideal_max":
                return (fedocs.maxpool_quantized(h, self.bits, self.tie_break,
                                                 dim), zeros)
            if self.kind == "mean":
                return fedocs.meanpool(h, dim), zeros
            return fedocs.concat(h, dim), zeros
        p, online = self._channel_state(h, rng)
        if not lanes:
            h, rng, p = h[None], rng[None], p[None]
        pooled, acct = _ocs_pool(h, rng.to(h.device), p, online, self.bits,
                                 self.max_rounds, self.backend)
        if lanes:
            return pooled, acct
        return pooled[0], ProtocolAccounting(
            **{f.name: getattr(acct, f.name)[0]
               for f in dataclasses.fields(acct)})

    def aggregate_with_ideal(self, h: torch.Tensor, rng: torch.Tensor
                             ) -> Tuple[torch.Tensor, ProtocolAccounting]:
        """Pool a lane stack ``h (L+1, N, ..., K)`` in one call: lanes
        ``0..L-1`` as ``self.aggregate(h[:L], rng, lanes=True)`` (``rng (L,
        2)``, a bound ``(L,)`` or ``(L, N)`` ``p_miss``) and lane ``L`` as
        ``Protocol.ideal_max(self.bits, tie_break="first").aggregate(h[L:],
        lanes=True)``, the ideal run that the OCS winner matches at
        ``p_miss=0``.  Returns ``(pooled (L+1, ..., K)``, the noisy lanes'
        accounting).  The backward routes every lane's cotangent to its
        winner in one pass; its gradient equals that of the two calls
        concatenated but for the sign of zeros (``fedocs.stack_pool``)."""
        if self.kind != "ocs":
            raise ValueError(f"aggregate_with_ideal pools OCS lanes, not "
                             f"{self.kind!r}")
        p, online = self._channel_state(h, rng)
        pooled, *acct = fedocs.stack_pool(h, rng.to(h.device), p, online,
                                          self.bits, self.max_rounds,
                                          self.backend)
        return pooled, _accounting(*acct)

    def _channel_state(self, h: torch.Tensor, rng):
        """The OCS channel's bound state on h's device: ``(p_miss float32,
        online bool or None)``; raises without rng or a bound p_miss."""
        if rng is None:
            raise ValueError(
                "Protocol.ocs aggregation needs rng (the sensing PRNG key)")
        if self.p_miss is None:
            raise ValueError(
                "Protocol.ocs has no p_miss bound; construct with "
                "Protocol.ocs(bits, p_miss=...) or bind via with_p_miss()")
        p = torch.as_tensor(self.p_miss, dtype=torch.float32,
                            device=h.device)
        online = None if self.online is None else torch.as_tensor(
            self.online, dtype=torch.bool, device=h.device)
        return p, online

    # -- derived protocol facts --------------------------------------------

    def output_dim(self, n_workers: int, k: int) -> int:
        """Fused feature width the head sees: N*K for concat, K otherwise."""
        return n_workers * k if self.kind == "concat" else k

    def resolved_payload_bits(self) -> int:
        """The explicit override if set, else the D-bit code width for the
        quantized-payload kinds (ocs/ideal_max), else a 32-bit float."""
        if self.payload_bits is not None:
            return self.payload_bits
        if self.kind in ("ocs", "ideal_max"):
            return self.bits
        return 32

    def comm_load(self, n_workers: int, k: int) -> channel.CommLoad:
        """Analytic per-round uplink/downlink accounting (paper §I / §IV)."""
        cfg = channel.ChannelConfig(payload_bits=self.resolved_payload_bits(),
                                    n_channels=self.n_channels)
        if self.kind in ("max", "ideal_max", "ocs"):
            return channel.ocs_load(n_workers, k, bits=self.bits, cfg=cfg)
        if self.kind in ("mean", "sum"):
            # every worker transmits every element; the server reduces
            return channel.mean_load(n_workers, k, cfg=cfg)
        return channel.concat_load(n_workers, k, cfg=cfg)
