"""Plain PyTorch version of the noisy contention kernel.

Replays the tournament over the kernel's packed operands (bit ``n_slots -
1 - d`` of ``heard[l, r, n, k]`` is sub-slot d's sensing draw) as a loop
over rounds and sub-slots on boolean ``(L, N, K)`` alive masks, and returns
the counts reduced over K: the same contract as ``ops.contend``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ocs_quant.ref import to_int64


def lane_mask(mask, lanes: int, n: int, device=None) -> torch.Tensor:
    """A ``(N,)`` or ``(L, N)`` worker mask as a bool ``(L, N)``."""
    mask = torch.as_tensor(mask, dtype=torch.bool, device=device)
    if mask.shape not in ((n,), (lanes, n)):
        raise ValueError(f"mask must be ({n},) or ({lanes}, {n}), got "
                         f"{tuple(mask.shape)}")
    return mask.expand(lanes, n)


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
