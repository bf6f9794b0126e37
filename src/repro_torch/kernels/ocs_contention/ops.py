"""Wrapper of the noisy contention kernel (``csrc/ocs_contention.cu``) and
the packing of the sensing draws it consumes.

Every operand is lane-leading: one launch runs the tournament of all
p_miss lanes.  ``draw_heard_packed`` makes the per-(round, sub-slot)
Bernoulli draws of the JAX package's scan (``ocs.sensing_heard`` at key
``fold_in(fold_in(rng, r), d)``) in one batched draw and packs them into
one 32-bit plane word per (lane, round, worker, element).
"""

from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch import random as jr
from repro_torch.core import ocs
from repro_torch.kernels.ocs_contention import ref
from repro_torch.kernels.ocs_quant.ref import from_int64


def draw_heard_packed(rng: torch.Tensor, p_keep: torch.Tensor, n: int,
                      k: int, *, n_slots: int,
                      max_rounds: int) -> torch.Tensor:
    """rng (L, 2) keys, p_keep (L, 1, 1) or (L, N, 1) -> (L, max_rounds,
    N, K) ``uint32`` where bit ``n_slots - 1 - d`` of ``[l, r, n, k]`` is
    lane l's sub-slot d draw in round r."""
    dev = rng.device
    r_keys = jr.fold_in(rng[:, None], torch.arange(max_rounds, device=dev))
    rd_keys = jr.fold_in(r_keys[:, :, None],
                         torch.arange(n_slots, device=dev))  # (L, R, S, 2)
    p = p_keep.reshape(p_keep.shape[:1] + (1, 1) + p_keep.shape[1:])
    heard = ocs.sensing_heard(rd_keys, p, n, k)               # (L,R,S,N,K)
    plane = 1 << torch.arange(n_slots - 1, -1, -1, device=dev)
    packed = (heard.to(torch.int64) * plane[:, None, None]).sum(dim=2)
    return from_int64(packed, torch.uint32)


def contend(word: torch.Tensor, heard: torch.Tensor, mask: torch.Tensor,
            total_bits: int, *, n_slots: int, max_rounds: int):
    """The whole noisy tournament over packed planes.

    word (L, N, K) and heard (L, max_rounds, N, K) 32-bit words (``uint32``
    or their ``int32`` view), mask (N,) or (L, N) of real workers,
    ``total_bits`` the live sub-slots (``bits + id_bits``; sub-slots past
    it are inert) -> (winner (L, K) int32, contending (L, max_rounds)
    int32, collided (L, max_rounds) int32).
    """
    if not 1 <= n_slots <= 32:
        raise ValueError(f"n_slots must be in [1, 32], got {n_slots}")
    lanes, n, k = word.shape
    if heard.shape != (lanes, max_rounds, n, k):
        raise ValueError(f"heard must be {(lanes, max_rounds, n, k)}, got "
                         f"{tuple(heard.shape)}")
    if word.device.type == "cpu":
        return ref.contend(word, heard, mask, int(total_bits),
                           n_slots=n_slots, max_rounds=max_rounds)
    if not 1 <= n <= 64:
        raise ValueError(f"the contention kernel takes 1..64 workers, got {n}")
    for t in (word, heard):
        if t.dtype not in (torch.uint32, torch.int32):
            raise ValueError(f"32-bit words expected, got {t.dtype}")
    m = ref.lane_mask(mask, lanes, n, word.device)
    m8 = (m[:1] if mask.ndim == 1 else m).to(torch.uint8).contiguous()
    word, heard = word.contiguous(), heard.contiguous()
    winner = torch.empty((lanes, k), dtype=torch.int32, device=word.device)
    counts = torch.zeros((2, lanes, max_rounds), dtype=torch.int32,
                         device=word.device)
    kernels.check_operands(word, heard, m8, winner, counts)
    kernels.launch("ocs_contention.contend", "ocs_contend", word.device,
                   word.data_ptr(), heard.data_ptr(), m8.data_ptr(),
                   winner.data_ptr(), counts[0].data_ptr(),
                   counts[1].data_ptr(), lanes, n, k, n_slots, max_rounds,
                   int(total_bits), 0 if mask.ndim == 1 else n)
    return winner, counts[0], counts[1]


def noisy_contention(word: torch.Tensor, mask: torch.Tensor,
                     total_bits: int, rng: torch.Tensor,
                     p_keep: torch.Tensor, *, n_slots: int,
                     max_rounds: int):
    """Draw the sensing stream and run the tournament (see ``contend``)."""
    lanes, n, k = word.shape
    heard = draw_heard_packed(rng, p_keep, n, k, n_slots=n_slots,
                              max_rounds=max_rounds)
    return contend(word, heard, mask, total_bits, n_slots=n_slots,
                   max_rounds=max_rounds)
