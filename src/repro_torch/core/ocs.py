"""Opportunistic Carrier Sensing (OCS) max-pooling — paper §III, Alg. 1.

Each element k is one sub-frame.  Every worker contends with its word
``[D-bit value code | id code]`` MSB first: in each sub-slot the workers
whose bit is 1 transmit a blocking signal, and a silent worker that hears
one quits.  The id code is the complement of the worker's index, so among
workers tied at the max code the lowest index wins (the fusion center's
ACK of one decodable preamble).

Two cores, both lane-leading (``h (L, N, K)``, a padded worker axis with
a ``mask`` of real workers), so one call serves a whole sweep group or
every p_miss lane of a training step:

  * ``ocs_maxpool_core`` — the clean Alg. 1 of the paper's §IV accounting
    (every sensing worker hears).  It quantizes through the ``ocs_quant``
    encode and runs the tournament as torch ops over ``bits +
    max_id_bits`` sub-slots, as the JAX package's ``lax.scan`` does (the
    JAX core has no Pallas kernel either); ``id_bits`` may differ per
    lane, and sub-slots past a lane's ``bits + id_bits`` are inert.
  * ``ocs_maxpool_noisy_core`` — missed sensing: a worker misses a
    blocking signal with probability ``p_miss`` per sub-slot; missed
    detections leave false survivors, whose payloads collide, and the
    survivors re-contend, up to ``max_rounds`` rounds, after which the
    lowest index captures the channel.  The core hands the float features
    to two wrappers: the ``ocs_contention`` tournament (words, sensing
    draws and accounting) and the ``maxpool.decode`` pooling epilogue.  On
    a CUDA tensor each is one kernel that forms the Eq. 7 codes in
    registers; on the CPU their plain versions encode, build the words,
    draw the packed sensing planes and loop over rounds and sub-slots.
    The draws are the JAX package's: ``sensing_heard`` at key
    ``fold_in(fold_in(rng, r), d)`` for round r, sub-slot d, each an
    ``(N, K)`` block, so the stream depends on the padded N.

``ocs_maxpool``, ``ocs_maxpool_multichannel`` and ``ocs_maxpool_noisy``
are the single-round wrappers (all workers real, no lane axis), and
``reference_maxpool`` the argmax oracle the tests hold the cores to.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch

from repro_torch import random as jr
from repro_torch.core import quantize as qz
from repro_torch.kernels.maxpool import ops as maxpool_ops
from repro_torch.kernels.maxpool.ref import PoolDecode
from repro_torch.kernels.ocs_contention.ref import lane_mask
from repro_torch.kernels.ocs_quant.ref import from_int64, to_int64

NOISY_BACKENDS = ("scan", "pallas")


@dataclasses.dataclass(frozen=True)
class OCSResult:
    """Outcome of one clean max-pooling round, one row per lane."""

    winner: torch.Tensor            # (L, K) int32 — worker sending element k
    value: torch.Tensor             # (L, K) float — the winner's h
    pooled_code: torch.Tensor       # (L, K) uint — max D-bit code
    ties: torch.Tensor              # (L, K) int32 — workers at the max code
    contention_slots: torch.Tensor  # (L,) int32 — sub-slots consumed
    blocking_tx: torch.Tensor       # (L,) int32 — blocking transmissions
    payload_tx: torch.Tensor        # (L,) int32 — payloads sent (== K)
    concat_payload_tx: torch.Tensor  # (L,) int32 — N*K, the concat baseline


@dataclasses.dataclass(frozen=True)
class MultichannelOCSResult:
    """OFDMA variant: the single-channel ``result`` (its
    ``contention_slots`` stays the total) and the striped wall-clock
    ``latency_slots = ceil(contention_slots / n_channels)``."""

    result: OCSResult
    latency_slots: torch.Tensor     # () int32


@dataclasses.dataclass(frozen=True)
class NoisyOCSResult:
    """Outcome under imperfect sensing, one row per lane."""

    winner: torch.Tensor            # (L, K) int32 — final payload transmitter
    correct: torch.Tensor           # (L, K) bool  — winner holds the max code
    collisions: torch.Tensor        # (L,) int32 — collided (sub-frame, round)
    rounds: torch.Tensor            # (L,) int32 — rounds until all resolved
    contention_slots: torch.Tensor  # (L,) int32 — sub-slots billed to the
    #   sub-frames still unresolved at the start of each round


def host_id_bits(n_workers: int) -> int:
    """ID sub-slots needed to tie-break N workers: ceil(log2(max(N, 2)))."""
    return max(1, math.ceil(math.log2(max(n_workers, 2))))


def ocs_maxpool_core(h: torch.Tensor, mask, id_bits, *, bits: int,
                     max_id_bits: int) -> OCSResult:
    """Batched Algorithm 1 over a padded worker axis.

    Args:
      h:           (L, N, K) features of L lanes; padded rows are ignored.
      mask:        (N,) or (L, N) bool — real workers (>= 1 per lane).
      id_bits:     tie-break sub-slots of each lane's real worker count
                   (``host_id_bits(n)``), an int or an (L,) tensor.
      bits:        D, the backoff quantization depth.
      max_id_bits: the scan-length bound, ``>= id_bits`` of every lane.

    The accounting equals, bit for bit, an unpadded ``ocs_maxpool`` of
    each lane at its real worker count: sub-slots past ``bits + id_bits``
    are gated off, so neither ``contention_slots`` nor ``blocking_tx``
    see them.
    """
    if bits + max_id_bits > 32:
        raise ValueError(
            f"contention word overflows uint32: bits={bits} + "
            f"max_id_bits={max_id_bits} > 32")
    lanes, n, k = h.shape
    dev = h.device
    qcodes = qz.quantize(h, bits)                              # (L, N, K)
    codes = to_int64(qcodes)
    m = lane_mask(mask, lanes, n, dev)
    idb = torch.as_tensor(id_bits, dtype=torch.int64,
                          device=dev).expand(lanes)
    # [ value code | id code ], the id codes of padded rows wrapping mod
    # 2^32 as the JAX package's uint32 arithmetic does (they never contend)
    ids = (((1 << idb) - 1)[:, None] - torch.arange(n, device=dev)) \
        & 0xFFFFFFFF
    word = ((codes << idb[:, None, None]) | ids[:, :, None]) & 0xFFFFFFFF
    total = bits + idb                                          # (L,)
    alive = m[:, :, None].expand(lanes, n, k)
    blocks = torch.zeros((lanes,), dtype=torch.int64, device=dev)
    for d in range(bits + max_id_bits):
        active = (d < total)[:, None, None]
        shift = torch.clamp(total - 1 - d, min=0)[:, None, None]
        tx = alive & (((word >> shift) & 1) == 1) & active      # blockers
        any_tx = tx.any(dim=1, keepdim=True)
        # a sensing worker quits iff someone transmitted (Alg. 1 l. 3-4);
        # an inactive (padding) sub-slot transmits nothing
        alive = alive & (tx | ~any_tx)
        blocks += tx.sum(dim=(1, 2))

    # after the value and id sub-slots one real worker survives per element
    winner = alive.to(torch.int8).argmax(dim=1)                 # (L, K)
    masked = torch.where(m[:, :, None], codes, 0)
    pooled = masked.amax(dim=1)
    ties = ((codes == pooled[:, None]) & m[:, :, None]).sum(dim=1)
    value = h.gather(1, winner[:, None]).squeeze(1)
    i32 = torch.int32
    return OCSResult(
        winner=winner.to(i32), value=value,
        pooled_code=from_int64(pooled, qcodes.dtype), ties=ties.to(i32),
        contention_slots=(k * total).to(i32), blocking_tx=blocks.to(i32),
        payload_tx=torch.full((lanes,), k, dtype=i32, device=dev),
        concat_payload_tx=(m.sum(dim=1) * k).to(i32))


def _single(res):
    """A lane-leading result's fields without the lane axis."""
    return type(res)(**{f.name: getattr(res, f.name)[0]
                        for f in dataclasses.fields(res)})


def ocs_maxpool(h: torch.Tensor, bits: int = 16) -> OCSResult:
    """One round of Algorithm 1 over ``h (N, K)`` (all workers real).
    ``winner``/``pooled_code`` are exactly ``argmax/max`` of the D-bit
    codes with the lowest index winning a tie (:func:`reference_maxpool`).
    Fields come back without the lane axis."""
    if h.ndim != 2:
        raise ValueError(f"h must be (N, K), got {tuple(h.shape)}")
    n = h.shape[0]
    id_bits = host_id_bits(n)
    return _single(ocs_maxpool_core(
        h[None], torch.ones((n,), dtype=torch.bool, device=h.device),
        id_bits, bits=bits, max_id_bits=id_bits))


def ocs_maxpool_multichannel(h: torch.Tensor, bits: int = 16,
                             n_channels: int = 4) -> MultichannelOCSResult:
    """Multi-channel (OFDMA) variant (paper §III, ref. [16]): the K
    sub-frames striped over ``n_channels`` orthogonal channels.  Selection
    and transmission counts are :func:`ocs_maxpool`'s; only the wall-clock
    ``latency_slots`` divides."""
    res = ocs_maxpool(h, bits)
    return MultichannelOCSResult(
        result=res,
        latency_slots=(res.contention_slots + n_channels - 1) // n_channels)


def reference_maxpool(h: torch.Tensor, bits: int):
    """The argmax oracle of the protocol outcome over ``h (N, K)``:
    (winner int32, value, pooled_code)."""
    codes = qz.quantize(h, bits)
    c = to_int64(codes)
    pooled = c.amax(dim=0)
    winner = (c == pooled[None]).to(torch.int8).argmax(dim=0)
    value = h.gather(0, winner[None]).squeeze(0)
    return winner.to(torch.int32), value, from_int64(pooled, codes.dtype)


def sensing_keep_prob(p_miss, dtype=torch.float32, lanes: bool = False
                      ) -> torch.Tensor:
    """Per-sub-slot hear probability ``1 - p_miss`` shaped to broadcast
    over an (N, K) slot: ``()`` for a scalar, ``(N, 1)`` for a per-worker
    ``(N,)`` vector.  With ``lanes`` the leading axis is the lane axis:
    ``(L,)`` gives ``(L, 1, 1)`` and ``(L, N)`` gives ``(L, N, 1)``."""
    dt = dtype if dtype.is_floating_point else torch.float32
    p = torch.as_tensor(p_miss, dtype=dt)
    base = p.ndim - int(lanes)
    if base not in (0, 1):
        raise ValueError(f"p_miss must be scalar or (N,) per lane, got "
                         f"shape {tuple(p.shape)}")
    keep = 1.0 - p
    return keep.reshape(keep.shape + (1,) * (2 - base)) if lanes or base \
        else keep


def sensing_heard(key: torch.Tensor, p_keep: torch.Tensor, n: int,
                  k: int) -> torch.Tensor:
    """One sub-slot of sensing draws: heard[..., n, k] ~ Bern(p_keep).

    ``key`` may carry leading dims (lanes, rounds, sub-slots); ``p_keep``
    broadcasts against ``key.shape[:-1] + (n, k)``.  The one place the
    sensing randomness is drawn, for both the plain loop and the packed
    draws of the contention kernel."""
    return jr.bernoulli(key, p_keep, (n, k))


def ocs_maxpool_noisy_core(h: torch.Tensor, mask, id_bits: int,
                           rng: torch.Tensor, p_miss, *, bits: int,
                           max_id_bits: int, max_rounds: int = 3,
                           backend: str = "scan", with_pooled: bool = False,
                           out: Optional[Tuple[torch.Tensor, torch.Tensor]]
                           = None
                           ) -> Union[NoisyOCSResult,
                                      Tuple[NoisyOCSResult, torch.Tensor]]:
    """Batched imperfect-sensing core over a padded worker axis.

    Args:
      h:       (L, N, K) features of L lanes; padded worker rows ignored.
      mask:    (N,) or (L, N) bool — real workers.
      id_bits: tie-break sub-slots of the real worker count.
      rng:     (L, 2) sensing keys, one per lane.
      p_miss:  (L,) or (L, N) miss probabilities.
      bits, max_id_bits, max_rounds: as in the JAX core; the scan runs
               ``bits + max_id_bits`` sub-slots, those past
               ``bits + id_bits`` inert.
      backend: ``"scan"`` or ``"pallas"``; both give the same bits, and
               the device decides: a CUDA tensor runs the kernel.
      with_pooled: also return the pooled value ``(L, K)`` in h's dtype,
               the winner's D-bit payload decoded (the noisy law's
               forward), as ``(result, pooled)``.
      out:     ``(pooled, winner)``, contiguous ``(L, K)`` tensors of h's
               dtype and int32 to write the pooled value and the winner
               into (slices of a larger stack, say).
    """
    if bits + max_id_bits > 32:
        raise ValueError(
            f"contention word overflows uint32: bits={bits} + "
            f"max_id_bits={max_id_bits} > 32")
    if backend not in NOISY_BACKENDS:
        raise ValueError(
            f"unknown noisy-OCS backend {backend!r}; valid: {NOISY_BACKENDS}")
    lanes, n, k = h.shape
    id_bits = int(id_bits)
    n_slots = bits + max_id_bits
    p_keep = sensing_keep_prob(
        torch.as_tensor(p_miss, device=h.device), h.dtype, lanes=True)
    m = lane_mask(mask, lanes, n, h.device)
    pooled_out, winner_out = (None, None) if out is None else out

    # imported here: the wrapper draws through this module's sensing_heard
    from repro_torch.kernels.ocs_contention import ops as contention_ops

    # the tournament over the words of h's codes, with its accounting
    con = contention_ops.noisy_contention(
        h, m, bits, id_bits, rng, p_keep, n_slots=n_slots,
        max_rounds=max_rounds, out=winner_out)
    # one pooling epilogue: the true max code of the real workers, whether
    # the winner holds it, and the winner's payload decoded
    pooled = maxpool_ops.maxpool_decode(
        h, bits, h.dtype, mask=m, winner=con.winner, correct=True,
        out=PoolDecode(pooled_out, None, None, None))
    res = NoisyOCSResult(winner=con.winner, correct=pooled.correct,
                         collisions=con.collisions, rounds=con.rounds,
                         contention_slots=con.contention_slots)
    return (res, pooled.pooled) if with_pooled else res


def ocs_maxpool_noisy(h: torch.Tensor, rng: torch.Tensor, bits: int = 16,
                      p_miss=0.0, max_rounds: int = 3,
                      backend: str = "scan") -> NoisyOCSResult:
    """One round of Alg. 1 with miss detection over ``h (N, K)`` (all
    workers real), one key ``rng (2,)``, ``p_miss`` scalar or ``(N,)``.
    Fields come back without the lane axis."""
    if h.ndim != 2:
        raise ValueError(f"h must be (N, K), got {tuple(h.shape)}")
    n = h.shape[0]
    id_bits = host_id_bits(n)
    res = ocs_maxpool_noisy_core(
        h[None], torch.ones((n,), dtype=torch.bool, device=h.device),
        id_bits, rng[None], torch.as_tensor(p_miss)[None], bits=bits,
        max_id_bits=id_bits, max_rounds=max_rounds, backend=backend)
    return _single(res)
