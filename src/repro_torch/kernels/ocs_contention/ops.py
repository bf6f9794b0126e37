"""Wrappers of the noisy contention kernel (``csrc/ocs_contention.cu``).

Every operand is lane-leading: one launch runs the tournament of all
p_miss lanes.  ``noisy_contention`` is what the protocol core calls: on a
CUDA tensor its kernel hashes each sensing bit it reads in place (the
threefry stream of ``ref.draw_heard_packed``, bit for bit) and no sensing
tensor exists; on the CPU it is ``ref.noisy_contention``.  ``contend``
takes pre-drawn packed planes, the TPU kernel's interface.
"""

from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels.ocs_contention import ref
from repro_torch.kernels.ocs_quant.ref import from_int64

MAX_ROUNDS = 64      # csrc/ocs_contention.cu: kMaxRounds


def _check_kernel_operands(word: torch.Tensor, n_slots: int,
                           max_rounds: int) -> None:
    n = word.shape[1]
    if not 1 <= n <= 64:
        raise ValueError(f"the contention kernel takes 1..64 workers, got {n}")
    if not 1 <= max_rounds <= MAX_ROUNDS:
        raise ValueError(f"the contention kernel takes 1..{MAX_ROUNDS} "
                         f"rounds, got {max_rounds}")
    if word.dtype not in (torch.uint32, torch.int32):
        raise ValueError(f"32-bit words expected, got {word.dtype}")


def _mask_and_outputs(word: torch.Tensor, mask: torch.Tensor,
                      max_rounds: int):
    """The (1 or L, N) uint8 mask, its lane stride, and the outputs."""
    lanes, n, k = word.shape
    m = ref.lane_mask(mask, lanes, n, word.device)
    m8 = (m[:1] if mask.ndim == 1 else m).to(torch.uint8).contiguous()
    winner = torch.empty((lanes, k), dtype=torch.int32, device=word.device)
    counts = torch.zeros((2, lanes, max_rounds), dtype=torch.int32,
                         device=word.device)
    return m8, (0 if mask.ndim == 1 else n), winner, counts


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
    _check_kernel_operands(word, n_slots, max_rounds)
    if heard.dtype not in (torch.uint32, torch.int32):
        raise ValueError(f"32-bit words expected, got {heard.dtype}")
    word, heard = word.contiguous(), heard.contiguous()
    m8, mask_stride, winner, counts = _mask_and_outputs(word, mask,
                                                        max_rounds)
    kernels.check_operands(word, heard, m8, winner, counts)
    kernels.launch("ocs_contention.contend", "ocs_contend", word.device,
                   word.data_ptr(), heard.data_ptr(), m8.data_ptr(),
                   winner.data_ptr(), counts[0].data_ptr(),
                   counts[1].data_ptr(), lanes, n, k, n_slots, max_rounds,
                   int(total_bits), mask_stride)
    return winner, counts[0], counts[1]


def noisy_contention(word: torch.Tensor, mask: torch.Tensor,
                     total_bits: int, rng: torch.Tensor,
                     p_keep: torch.Tensor, *, n_slots: int,
                     max_rounds: int):
    """The tournament under the sensing stream of ``rng``.

    word (L, N, K) 32-bit words, mask (N,) or (L, N), rng (L, 2) int64 keys,
    p_keep (L, 1, 1) or (L, N, 1) hear probabilities in float32, bfloat16
    or float16 (the draw's type) -> the outputs of ``contend``, equal bit
    for bit to ``ref.noisy_contention``."""
    if not 1 <= n_slots <= 32:
        raise ValueError(f"n_slots must be in [1, 32], got {n_slots}")
    lanes, n, k = word.shape
    if word.device.type == "cpu":
        return ref.noisy_contention(word, mask, int(total_bits), rng, p_keep,
                                    n_slots=n_slots, max_rounds=max_rounds)
    _check_kernel_operands(word, n_slots, max_rounds)
    if p_keep.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"p_keep must be float32, bfloat16 or float16, got "
                         f"{p_keep.dtype}")
    p = p_keep.reshape(lanes, -1)
    if p.shape[1] not in (1, n) or rng.shape != (lanes, 2):
        raise ValueError(f"p_keep (L, 1, 1) or (L, N, 1) and rng (L, 2) for "
                         f"L={lanes}, N={n}; got {tuple(p_keep.shape)} and "
                         f"{tuple(rng.shape)}")
    p_bits = p.contiguous().view(torch.int32 if p.dtype == torch.float32
                                 else torch.int16)
    keys = from_int64(rng, torch.uint32).contiguous()
    word = word.contiguous()
    m8, mask_stride, winner, counts = _mask_and_outputs(word, mask,
                                                        max_rounds)
    kernels.check_operands(word, keys, p_bits, m8, winner, counts)
    kernels.launch("ocs_contention.noisy", "ocs_noisy", word.device,
                   word.data_ptr(), m8.data_ptr(), keys.data_ptr(),
                   p_bits.data_ptr(), kernels.KIND[p.dtype],
                   int(p.shape[1] > 1), winner.data_ptr(),
                   counts[0].data_ptr(), counts[1].data_ptr(), lanes, n, k,
                   n_slots, max_rounds, int(total_bits), mask_stride)
    return winner, counts[0], counts[1]
