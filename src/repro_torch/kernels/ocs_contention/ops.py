"""Wrappers of the noisy contention kernel (``csrc/ocs_contention.cu``).

Every operand is lane-leading: one launch runs the tournament of all
p_miss lanes.  ``noisy_contention`` is what the protocol core calls: on a
CUDA tensor its kernel reads the float features, forms each worker's
contention word in registers, hashes each sensing bit it reads in place
(the threefry stream of ``ref.draw_heard_packed``, bit for bit) and writes
each lane's accounting; no code, word or sensing tensor exists.  On the
CPU it is ``ref.noisy_contention``.  ``contend`` takes pre-formed words and
pre-drawn packed planes, the TPU kernel's interface.  Both take a fake
tensor (a trace, either device) through a custom op
(``repro_torch::ocs_noisy``, ``repro_torch::ocs_contend``) whose fake impl
gives the outputs alone; real tensors take the direct path.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch import kernels
from repro_torch.kernels.ocs_contention import ref
from repro_torch.kernels.ocs_quant.ref import width

MAX_ROUNDS = 64      # csrc/ocs_contention.cu: kMaxRounds
MAX_WORKERS = 64     # two workers per lane of a warp
_FLOATS = (torch.float32, torch.bfloat16, torch.float16)


def _check_kernel_operands(n: int, max_rounds: int) -> None:
    if not 1 <= n <= MAX_WORKERS:
        raise ValueError(f"the contention kernel takes 1..{MAX_WORKERS} "
                         f"workers, got {n}")
    if not 1 <= max_rounds <= MAX_ROUNDS:
        raise ValueError(f"the contention kernel takes 1..{MAX_ROUNDS} "
                         f"rounds, got {max_rounds}")


def _kernel_mask(mask: torch.Tensor, lanes: int, n: int, device):
    """The mask as the kernel reads it, (1 or L, N) bytes, and its lane
    stride: one (N,) row (also a row expanded over the lanes) or one row
    per lane."""
    mask = torch.as_tensor(mask, device=device)
    if mask.dtype != torch.bool:
        mask = mask.to(torch.bool)
    if mask.ndim == 2 and mask.stride(0) == 0:
        mask = mask[0]                  # one (N,) row expanded over lanes
    ref.lane_mask(mask, lanes, n, device)        # checks the shape
    return mask.contiguous(), (0 if mask.ndim == 1 else n)


def _check_contend(word, heard, n: int, max_rounds: int) -> None:
    _check_kernel_operands(n, max_rounds)
    for t in (word, heard):
        if t.dtype not in (torch.uint32, torch.int32):
            raise ValueError(f"32-bit words expected, got {t.dtype}")


def _contend_kernel(word, heard, mask, total_bits, n_slots, max_rounds):
    lanes, n, k = word.shape
    _check_contend(word, heard, n, max_rounds)
    word, heard = word.contiguous(), heard.contiguous()
    m, mask_stride = _kernel_mask(mask, lanes, n, word.device)
    winner = torch.empty((lanes, k), dtype=torch.int32, device=word.device)
    counts = torch.zeros((2, lanes, max_rounds), dtype=torch.int32,
                         device=word.device)
    kernels.check_operands(word, heard, m, winner, counts)
    kernels.launch("ocs_contention.contend", "ocs_contend", word.device,
                   word.data_ptr(), heard.data_ptr(), m.data_ptr(),
                   winner.data_ptr(), counts[0].data_ptr(),
                   counts[1].data_ptr(), lanes, n, k, n_slots, max_rounds,
                   int(total_bits), mask_stride)
    return [winner, counts[0], counts[1]]


@torch.library.custom_op("repro_torch::ocs_contend", mutates_args=(),
                         device_types="cpu")
def _contend(word: torch.Tensor, heard: torch.Tensor, mask: torch.Tensor,
             total_bits: int, n_slots: int,
             max_rounds: int) -> List[torch.Tensor]:
    return list(ref.contend(word, heard, mask, total_bits, n_slots=n_slots,
                            max_rounds=max_rounds))


_contend.register_kernel("cuda")(_contend_kernel)


@_contend.register_fake
def _(word, heard, mask, total_bits, n_slots, max_rounds):
    lanes, n, k = word.shape
    if word.device.type != "cpu":
        _check_contend(word, heard, n, max_rounds)
    return [word.new_empty((lanes, k), dtype=torch.int32)] + [
        word.new_empty((lanes, max_rounds), dtype=torch.int32)
        for _ in range(2)]


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
    if is_fake(word):
        mask = torch.as_tensor(mask, dtype=torch.bool, device=word.device)
        return tuple(_contend(word, heard, mask, int(total_bits), n_slots,
                              max_rounds))
    if word.device.type == "cpu":
        return ref.contend(word, heard, mask, int(total_bits),
                           n_slots=n_slots, max_rounds=max_rounds)
    return tuple(_contend_kernel(word, heard, mask, total_bits, n_slots,
                                 max_rounds))


def noisy_contention(h: torch.Tensor, mask: torch.Tensor, bits: int,
                     id_bits: int, rng: torch.Tensor, p_keep: torch.Tensor,
                     *, n_slots: int, max_rounds: int,
                     out: Optional[torch.Tensor] = None) -> ref.Contention:
    """The tournament of the features ``h`` under the sensing stream of
    ``rng``.

    h (L, N, K) float32, bfloat16 or float16 features, each worker's word
    ``[bits-bit Eq. 7 code | id code]`` (``ref.contention_words``, ``bits
    + id_bits <= 32``); mask (N,) or (L, N); rng (L, 2) int64 keys; p_keep
    (L, 1, 1) or (L, N, 1) hear probabilities in float32, bfloat16 or
    float16 (the draw's type); ``out`` an (L, K) int32 tensor to write the
    winner into -> ``ref.Contention``, equal bit for bit to
    ``ref.noisy_contention``."""
    if not 1 <= n_slots <= 32:
        raise ValueError(f"n_slots must be in [1, 32], got {n_slots}")
    lanes, n, k = h.shape
    if not 1 <= bits <= width(h.dtype) or id_bits < 0 or \
            bits + id_bits > 32:
        raise ValueError(f"bits={bits}, id_bits={id_bits}: a word is 1 to "
                         f"{width(h.dtype)} code bits and the id bits, at "
                         "most 32")
    if out is not None and (out.shape != (lanes, k) or
                            out.dtype != torch.int32 or
                            not out.is_contiguous()):
        raise ValueError(f"out must be contiguous int32 of shape "
                         f"{(lanes, k)}, got {out.dtype} {tuple(out.shape)}")
    if is_fake(h):
        mask = torch.as_tensor(mask, dtype=torch.bool, device=h.device)
        got = _noisy(h, mask, int(bits), int(id_bits), rng, p_keep,
                     n_slots, max_rounds)
        if out is not None:
            got[0] = out.copy_(got[0])
        return ref.Contention(*got)
    if h.device.type == "cpu":
        return ref.noisy_contention(h, mask, bits, id_bits, rng, p_keep,
                                    n_slots=n_slots, max_rounds=max_rounds,
                                    out=out)
    return ref.Contention(*_noisy_kernel(h, mask, bits, id_bits, rng, p_keep,
                                         n_slots, max_rounds, out))


def _check_noisy(h, rng, p_keep, max_rounds: int) -> None:
    lanes, n, k = h.shape
    _check_kernel_operands(n, max_rounds)
    for name, t in (("h", h), ("p_keep", p_keep)):
        if t.dtype not in _FLOATS:
            raise ValueError(f"{name} must be float32, bfloat16 or float16, "
                             f"got {t.dtype}")
    p = p_keep.reshape(lanes, -1)
    if p.shape[1] not in (1, n) or rng.shape != (lanes, 2) or \
            rng.dtype != torch.int64:
        raise ValueError(f"p_keep (L, 1, 1) or (L, N, 1) and int64 rng "
                         f"(L, 2) for L={lanes}, N={n}; got "
                         f"{tuple(p_keep.shape)} and {rng.dtype} "
                         f"{tuple(rng.shape)}")


def _noisy_kernel(h, mask, bits, id_bits, rng, p_keep, n_slots, max_rounds,
                  out=None) -> List[torch.Tensor]:
    """One launch of the noisy kernel on CUDA tensors: the winner (written
    into ``out`` where given), the per-round counts and the accounting."""
    lanes, n, k = h.shape
    _check_noisy(h, rng, p_keep, max_rounds)
    p = p_keep.reshape(lanes, -1).contiguous()
    h, rng = h.contiguous(), rng.contiguous()
    m, mask_stride = _kernel_mask(mask, lanes, n, h.device)
    winner = out if out is not None else torch.empty(
        (lanes, k), dtype=torch.int32, device=h.device)
    # one zeroed buffer: the per-round counts and each lane's (rounds,
    # collisions, contention slots)
    buf = torch.zeros((2 * max_rounds + 3) * lanes, dtype=torch.int32,
                      device=h.device)
    counts = buf[:2 * max_rounds * lanes].view(2, lanes, max_rounds)
    acct = buf[2 * max_rounds * lanes:].view(3, lanes)
    kernels.check_operands(h, m, rng, p, winner, buf)
    kernels.launch("ocs_contention.noisy", "ocs_noisy", h.device,
                   h.data_ptr(), kernels.KIND[h.dtype], int(bits),
                   int(id_bits), m.data_ptr(), rng.data_ptr(), p.data_ptr(),
                   kernels.KIND[p.dtype], int(p.shape[1] > 1),
                   winner.data_ptr(), counts[0].data_ptr(),
                   counts[1].data_ptr(), acct.data_ptr(), lanes, n, k,
                   n_slots, max_rounds, mask_stride)
    return [winner, counts[0], counts[1], acct[0], acct[1], acct[2]]


@torch.library.custom_op("repro_torch::ocs_noisy", mutates_args=(),
                         device_types="cpu")
def _noisy(h: torch.Tensor, mask: torch.Tensor, bits: int, id_bits: int,
           rng: torch.Tensor, p_keep: torch.Tensor, n_slots: int,
           max_rounds: int) -> List[torch.Tensor]:
    return list(ref.noisy_contention(h, mask, bits, id_bits, rng, p_keep,
                                     n_slots=n_slots, max_rounds=max_rounds))


@_noisy.register_kernel("cuda")
def _(h, mask, bits, id_bits, rng, p_keep, n_slots, max_rounds):
    return _noisy_kernel(h, mask, bits, id_bits, rng, p_keep, n_slots,
                         max_rounds)


@_noisy.register_fake
def _(h, mask, bits, id_bits, rng, p_keep, n_slots, max_rounds):
    lanes, n, k = h.shape
    if h.device.type != "cpu":
        _check_noisy(h, rng, p_keep, max_rounds)
    return ([h.new_empty((lanes, k), dtype=torch.int32)]
            + [h.new_empty((lanes, max_rounds), dtype=torch.int32)
               for _ in range(2)]
            + [h.new_empty((lanes,), dtype=torch.int32) for _ in range(3)])
