"""Plain PyTorch version of the noisy contention kernel.

``contend`` replays the tournament over the kernel's packed operands (bit
``n_slots - 1 - d`` of ``heard[l, r, n, k]`` is sub-slot d's sensing draw)
as a loop over rounds and sub-slots on boolean ``(L, N, K)`` alive masks,
and returns the counts reduced over K: the same contract as
``ops.contend``.  ``noisy_contention`` forms the contention words from the
float features (``contention_words``: the Eq. 7 code above the id code),
draws the sensing stream (``draw_heard_packed``), runs ``contend`` over it
and reduces the counts into each lane's accounting: the same contract as
``ops.noisy_contention``, whose kernel does all of it in one launch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import random as jr
from repro_torch.kernels.ocs_quant.ref import encode, from_int64, to_int64


class Contention(NamedTuple):
    """What :func:`noisy_contention` returns, one row per lane."""

    winner: torch.Tensor            # (L, K) int32
    contending: torch.Tensor        # (L, max_rounds) int32
    collided: torch.Tensor          # (L, max_rounds) int32
    rounds: torch.Tensor            # (L,) int32 rounds with contention
    collisions: torch.Tensor        # (L,) int32 collided (sub-frame, round)
    contention_slots: torch.Tensor  # (L,) int32 sub-slots billed


def id_codes(n_workers: int, id_bits: int, device=None) -> torch.Tensor:
    """Per-worker tie-break codes ``2^id_bits - 1 - index`` (int64, taken
    mod 2^32): the lowest index wins the max.  Indices past
    ``2^id_bits`` wrap and must be masked out (padded workers)."""
    idx = torch.arange(n_workers, dtype=torch.int64, device=device)
    return (((1 << int(id_bits)) - 1) - idx) & 0xFFFFFFFF


def contention_words(h: torch.Tensor, bits: int,
                     id_bits: int) -> torch.Tensor:
    """h (L, N, K) floats -> (L, N, K) ``uint32`` words ``[bits-bit Eq. 7
    code | id code]`` (``bits + id_bits <= 32``)."""
    codes = to_int64(encode(h, bits))
    word = (codes << int(id_bits)) | id_codes(h.shape[1], id_bits,
                                              h.device)[:, None]
    return from_int64(word, torch.uint32)


def accounting(contending: torch.Tensor, collided: torch.Tensor,
               total_bits: int):
    """Per-round counts (L, max_rounds) -> each lane's (rounds,
    collisions, contention slots), int32."""
    slots = (total_bits * contending.sum(-1)).to(torch.int32)
    rounds = (contending > 0).sum(-1).to(torch.int32)
    collisions = collided.sum(-1).to(torch.int32)
    return rounds, collisions, slots


def lane_mask(mask, lanes: int, n: int, device=None) -> torch.Tensor:
    """A ``(N,)`` or ``(L, N)`` worker mask as a bool ``(L, N)``."""
    mask = torch.as_tensor(mask, dtype=torch.bool, device=device)
    if mask.shape not in ((n,), (lanes, n)):
        raise ValueError(f"mask must be ({n},) or ({lanes}, {n}), got "
                         f"{tuple(mask.shape)}")
    return mask.expand(lanes, n)


def draw_heard_packed(rng: torch.Tensor, p_keep: torch.Tensor, n: int,
                      k: int, *, n_slots: int,
                      max_rounds: int) -> torch.Tensor:
    """The sensing draws of the JAX package's scan (``ocs.sensing_heard``
    at key ``fold_in(fold_in(rng, r), d)``) in one batched draw, packed into
    one 32-bit plane word per (lane, round, worker, element).

    rng (L, 2) keys, p_keep (L, 1, 1) or (L, N, 1) -> (L, max_rounds, N, K)
    ``uint32`` where bit ``n_slots - 1 - d`` of ``[l, r, n, k]`` is lane l's
    sub-slot d draw in round r."""
    # imported here: core.ocs imports this module
    from repro_torch.core import ocs

    dev = rng.device
    r_keys = jr.fold_in(rng[:, None], torch.arange(max_rounds, device=dev))
    rd_keys = jr.fold_in(r_keys[:, :, None],
                         torch.arange(n_slots, device=dev))  # (L, R, S, 2)
    p = p_keep.reshape(p_keep.shape[:1] + (1, 1) + p_keep.shape[1:])
    heard = ocs.sensing_heard(rd_keys, p, n, k)               # (L,R,S,N,K)
    plane = 1 << torch.arange(n_slots - 1, -1, -1, device=dev)
    packed = (heard.to(torch.int64) * plane[:, None, None]).sum(dim=2)
    return from_int64(packed, torch.uint32)


def noisy_contention(h: torch.Tensor, mask: torch.Tensor, bits: int,
                     id_bits: int, rng: torch.Tensor, p_keep: torch.Tensor,
                     *, n_slots: int, max_rounds: int,
                     out: Optional[torch.Tensor] = None) -> Contention:
    """The words of ``h`` (``contention_words``), the sensing stream
    (``draw_heard_packed``), the tournament over them (``contend``) and the
    accounting; the winner is written into ``out`` where given."""
    lanes, n, k = h.shape
    total = int(bits) + int(id_bits)
    word = contention_words(h, bits, id_bits)
    heard = draw_heard_packed(rng, p_keep, n, k, n_slots=n_slots,
                              max_rounds=max_rounds)
    winner, contending, collided = contend(word, heard, mask, total,
                                           n_slots=n_slots,
                                           max_rounds=max_rounds)
    if out is not None:
        winner = out.copy_(winner)
    return Contention(winner, contending, collided,
                      *accounting(contending, collided, total))


def contend(word: torch.Tensor, heard: torch.Tensor, mask: torch.Tensor,
            total_bits: int, *, n_slots: int, max_rounds: int):
    """word (L, N, K) and heard (L, max_rounds, N, K) 32-bit words, mask
    (N,) or (L, N) -> (winner (L, K) int32, contending (L, max_rounds)
    int32, collided (L, max_rounds) int32)."""
    lanes, n, k = word.shape
    w = to_int64(word)
    hd = to_int64(heard)
    alive = lane_mask(mask, lanes, n)[:, :, None].expand(lanes, n, k)
    done = torch.zeros((lanes, k), dtype=torch.bool, device=word.device)
    contending, collided = [], []
    for r in range(max_rounds):
        contending.append((~done).sum(-1))
        for d in range(min(n_slots, total_bits)):
            tx = alive & (((w >> (total_bits - 1 - d)) & 1) == 1)
            hbit = ((hd[:, r] >> (n_slots - 1 - d)) & 1) == 1
            any_tx = tx.any(dim=1, keepdim=True)
            alive = alive & (tx | ~(any_tx & hbit))
        coll = alive.sum(dim=1) > 1
        collided.append(coll.sum(-1))
        done = done | ~coll
    winner = alive.to(torch.int8).argmax(dim=1)   # first survivor
    return (winner.to(torch.int32),
            torch.stack(contending, -1).to(torch.int32),
            torch.stack(collided, -1).to(torch.int32))
