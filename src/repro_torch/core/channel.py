"""Wireless-channel communication-load accounting (paper §I / §IV).

Pure-python bookkeeping that turns protocol outcomes into the byte/slot
tables the paper argues from: max-pooling via OCS costs O(K) payloads
(independent of N) against O(N·K) for concat/mean collection.  Also provides
the ICI-side accounting used to cross-check the dry-run's parsed collective
bytes for the TP fusion modes (DESIGN.md §2).

The per-method loaders (``ocs_load``/``concat_load``/``mean_load``) are the
*primitives*; consumers should go through
``repro_torch.protocol.Protocol.comm_load(n_workers, k)``, which resolves the
``ChannelConfig`` — in particular ``payload_bits`` — from the protocol
object itself (ONE source of truth: the D-bit code payload for the
quantized kinds, a full float otherwise) instead of re-deriving it ad hoc
at every call site.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    payload_bits: int = 32          # bits per transmitted feature element
    contention_slot_bits: int = 1   # a blocking signal occupies one bit-slot
    ack_bits: int = 8               # per-sub-frame ACK broadcast by the server
    n_channels: int = 1             # OFDMA parallel channels


# frozen, so one shared instance is a safe signature default (a call in a
# default expression would allocate per-import and trips flake8-bugbear B008)
_DEFAULT_CFG = ChannelConfig()


@dataclasses.dataclass(frozen=True)
class CommLoad:
    """Uplink/downlink load for one aggregation round (forward + backward)."""

    method: str
    n_workers: int
    k_elems: int
    uplink_payload_msgs: int        # feature elements sent worker -> server
    uplink_overhead_bits: int       # contention + ACK overhead
    downlink_msgs: int              # gradient elements server -> worker(s)
    latency_slots: int              # serialized channel occupancy (slots)
    payload_bits: int = 32          # bits per payload message (ChannelConfig)

    @property
    def uplink_bits(self) -> int:
        return self.uplink_payload_msgs * self.payload_bits + self.uplink_overhead_bits

    def as_row(self) -> str:
        return (f"{self.method},{self.n_workers},{self.k_elems},"
                f"{self.uplink_payload_msgs},{self.uplink_overhead_bits},"
                f"{self.downlink_msgs},{self.latency_slots},"
                f"{self.payload_bits}")


def ocs_load(n_workers: int, k_elems: int, bits: int,
             cfg: ChannelConfig = _DEFAULT_CFG) -> CommLoad:
    """FedOCS: K payloads uplink (N-independent), one O(K) broadcast down."""
    id_bits = max(1, math.ceil(math.log2(max(n_workers, 2))))
    contention = k_elems * (bits + id_bits) * cfg.contention_slot_bits
    acks = k_elems * cfg.ack_bits
    payload_slots = k_elems * cfg.payload_bits
    return CommLoad(
        method="fedocs_maxpool",
        n_workers=n_workers,
        k_elems=k_elems,
        uplink_payload_msgs=k_elems,
        uplink_overhead_bits=contention + acks,
        downlink_msgs=k_elems,      # broadcast dL/dv once (paper Eq. 5-6)
        latency_slots=(contention + acks + payload_slots) // cfg.n_channels,
        payload_bits=cfg.payload_bits,
    )


def concat_load(n_workers: int, k_elems: int,
                cfg: ChannelConfig = _DEFAULT_CFG) -> CommLoad:
    """Concat baseline: every worker sends all K elements; grads return per worker."""
    msgs = n_workers * k_elems
    return CommLoad(
        method="concat",
        n_workers=n_workers,
        k_elems=k_elems,
        uplink_payload_msgs=msgs,
        uplink_overhead_bits=0,
        downlink_msgs=msgs,         # dL/dh_n differs per worker
        latency_slots=msgs * cfg.payload_bits // cfg.n_channels,
        payload_bits=cfg.payload_bits,
    )


def mean_load(n_workers: int, k_elems: int,
              cfg: ChannelConfig = _DEFAULT_CFG) -> CommLoad:
    """Mean-pool baseline: every worker still transmits every element."""
    msgs = n_workers * k_elems
    return CommLoad(
        method="mean_pool",
        n_workers=n_workers,
        k_elems=k_elems,
        uplink_payload_msgs=msgs,
        uplink_overhead_bits=0,
        downlink_msgs=k_elems,      # same gradient broadcast to all
        latency_slots=msgs * cfg.payload_bits // cfg.n_channels,
        payload_bits=cfg.payload_bits,
    )


def avg_pred_load(n_workers: int, n_classes: int,
                  cfg: ChannelConfig = _DEFAULT_CFG) -> CommLoad:
    """Prediction-averaging baseline: each worker uploads a class distribution."""
    msgs = n_workers * n_classes
    return CommLoad(
        method="avg_preds",
        n_workers=n_workers,
        k_elems=n_classes,
        uplink_payload_msgs=msgs,
        uplink_overhead_bits=0,
        downlink_msgs=0,            # no backward needed at inference
        latency_slots=msgs * cfg.payload_bits // cfg.n_channels,
        payload_bits=cfg.payload_bits,
    )


# ---------------------------------------------------------------------------
# ICI-side analytical model (cross-check for dry-run parsed collective bytes)
# ---------------------------------------------------------------------------

def ring_allreduce_bytes(elem_bytes: int, payload_elems: int, n_shards: int) -> int:
    """Per-device bytes moved by a ring all-reduce (reduce-scatter + all-gather)."""
    return 2 * (n_shards - 1) * payload_elems * elem_bytes // n_shards


def ring_allgather_bytes(elem_bytes: int, payload_elems: int, n_shards: int) -> int:
    """Per-device bytes for a ring all-gather of per-shard payloads."""
    return (n_shards - 1) * payload_elems * elem_bytes


def tp_fusion_bytes(mode: str, k_elems: int, n_shards: int,
                    dtype_bytes: int = 2) -> int:
    """Collective bytes per device for one TP block fusion of a K-elem feature."""
    if mode in ("sum", "max"):
        return ring_allreduce_bytes(dtype_bytes, k_elems, n_shards)
    if mode == "max_q16":
        return ring_allreduce_bytes(2, k_elems, n_shards)
    if mode == "max_q8":
        return ring_allreduce_bytes(1, k_elems, n_shards)
    if mode == "concat":
        return ring_allgather_bytes(dtype_bytes, k_elems, n_shards)
    raise ValueError(f"unknown fusion mode {mode}")
