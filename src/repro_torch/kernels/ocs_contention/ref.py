"""Plain PyTorch version of the noisy contention kernel.

``contend`` replays the tournament over the kernel's packed operands (bit
``n_slots - 1 - d`` of ``heard[l, r, n, k]`` is sub-slot d's sensing draw)
as a loop over rounds and sub-slots on boolean ``(L, N, K)`` alive masks,
and returns the counts reduced over K: the same contract as
``ops.contend``.  ``noisy_contention`` is ``draw_heard_packed`` followed by
``contend``: the same contract as ``ops.noisy_contention``, whose kernel
hashes the sensing bits in place.
"""

from __future__ import annotations

import torch

from repro_torch import random as jr
from repro_torch.kernels.ocs_quant.ref import from_int64, to_int64


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


def noisy_contention(word: torch.Tensor, mask: torch.Tensor,
                     total_bits: int, rng: torch.Tensor,
                     p_keep: torch.Tensor, *, n_slots: int,
                     max_rounds: int):
    """Draw the sensing stream (``draw_heard_packed``) and run the
    tournament over it (``contend``)."""
    lanes, n, k = word.shape
    heard = draw_heard_packed(rng, p_keep, n, k, n_slots=n_slots,
                              max_rounds=max_rounds)
    return contend(word, heard, mask, total_bits, n_slots=n_slots,
                   max_rounds=max_rounds)


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
