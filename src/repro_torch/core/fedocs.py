"""FedOCS feature aggregation — the paper's pooling laws on worker-leading
tensors ``h: (N, ..., K)``.

  * ``maxpool``            max over workers (paper Eq. 4)
  * ``maxpool_quantized``  max over D-bit monotone codes (Eq. 7), decoded
  * ``maxpool_noisy``      the winner of the simulated noisy OCS channel
                           sends its D-bit payload (channel in the loop)
  * ``meanpool``/``concat`` the paper's baselines

Backward (paper Eq. 5-6): the cotangent of the pooled feature goes to the
winning worker only, as ``g * onehot``.  ``tie_break="all"`` instead gives
every worker tied at the max the full cotangent; ``"first"`` gives it to
the lowest tied index, which is what the OCS protocol transmits.

The laws are ``torch.autograd.Function``s.  On a CUDA tensor their
forwards run the Eq. 7 encode kernel, then the max-pool kernel (``max``)
or the fused pooling epilogue ``maxpool.decode`` (the quantized laws,
after the contention kernel for the noisy one), and their backwards the
winner-routed scatter kernel.  The
noisy law is lane-leading (``h: (L, N, ..., K)``, one key and one
``p_miss`` per lane) so that every p_miss lane of a step pools in one
call (:func:`noisy_pool`); :func:`maxpool_noisy` takes a single run.
"""

from __future__ import annotations

import torch

from repro_torch.core import ocs
from repro_torch.core import quantize as qz
from repro_torch.kernels.maxpool import ops as maxpool_ops

VALID_MODES = ("sum", "max", "max_q16", "max_q8", "max_noisy", "mean",
               "concat")


def _winner_mask(h: torch.Tensor, pooled: torch.Tensor, tie_break: str,
                 dim: int = 0) -> torch.Tensor:
    """Mask (h's dtype) of the workers receiving gradient."""
    mask = (h == pooled.unsqueeze(dim)).to(h.dtype)
    if tie_break == "all":
        return mask
    if tie_break == "first":
        n = h.shape[dim]
        idx = torch.arange(n, device=h.device).reshape(
            (n,) + (1,) * (h.ndim - dim - 1))
        first = torch.where(mask > 0, idx, n).amin(dim=dim, keepdim=True)
        return (idx == first).to(h.dtype) * mask
    raise ValueError(f"unknown tie_break {tie_break!r}")


def _check_tie_break(tie_break: str) -> None:
    if tie_break not in ("all", "first"):
        raise ValueError(f"unknown tie_break {tie_break!r}")


class _MaxPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, tie_break, dim):
        pooled, winner = maxpool_ops.maxpool_fused(h, dim)
        ctx.tie_break, ctx.dim, ctx.n = tie_break, dim, h.shape[dim]
        ctx.save_for_backward(winner if tie_break == "first" else h,
                              pooled)
        return pooled

    @staticmethod
    def backward(ctx, g):
        saved, pooled = ctx.saved_tensors
        if ctx.tie_break == "first":
            grad = maxpool_ops.maxpool_winner_bwd(saved, g, ctx.n, ctx.dim)
        else:
            grad = g.unsqueeze(ctx.dim) * _winner_mask(saved, pooled, "all",
                                                       ctx.dim)
        return grad, None, None


def maxpool(h: torch.Tensor, tie_break: str = "all",
            dim: int = 0) -> torch.Tensor:
    """Max over the worker axis ``dim`` with a winner-routed backward."""
    _check_tie_break(tie_break)
    return _MaxPool.apply(h, tie_break, dim % h.ndim)


class _MaxPoolQuantized(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, bits, tie_break, dim):
        codes = qz.quantize(h, bits)
        first = tie_break == "first"
        # one launch: the pooled value and what the backward routes by
        out = maxpool_ops.maxpool_decode(codes, bits, h.dtype, dim=dim,
                                         argmax=first, max_code=not first)
        ctx.tie_break, ctx.dim, ctx.n = tie_break, dim, h.shape[dim]
        if first:
            ctx.save_for_backward(out.argmax)
        else:
            ctx.save_for_backward(codes, out.max_code)
        return out.pooled

    @staticmethod
    def backward(ctx, g):
        if ctx.tie_break == "first":
            (winner,) = ctx.saved_tensors
            grad = maxpool_ops.maxpool_winner_bwd(winner, g, ctx.n, ctx.dim)
        else:
            # straight-through: every worker whose code won the contention
            codes, pooled_code = ctx.saved_tensors
            mask = codes == pooled_code.unsqueeze(ctx.dim)
            grad = g.unsqueeze(ctx.dim) * mask.to(g.dtype)
        return grad, None, None, None


def maxpool_quantized(h: torch.Tensor, bits: int, tie_break: str = "all",
                      dim: int = 0) -> torch.Tensor:
    """Max over D-bit monotone codes (an all-reduce(max) on uint8/uint16
    codes), decoded to the winning bucket's float."""
    _check_tie_break(tie_break)
    return _MaxPoolQuantized.apply(h, bits, tie_break, dim % h.ndim)


# ---------------------------------------------------------------------------
# channel-in-the-loop max-pool: noisy-OCS winner selection in the forward
# ---------------------------------------------------------------------------

def _maxpool_noisy_impl(h, rng, p_miss, bits, max_rounds, backend,
                        online=None):
    """Lane-leading protocol-outcome pooling.

    h (L, N, ..., K), rng (L, 2), p_miss (L,) or (L, N), online None or
    (N,)/(L, N) bool -> (pooled (L, ..., K), winner (L, M) int32 with M the
    flattened element count, the core's ``NoisyOCSResult``)."""
    lanes, n = h.shape[:2]
    flat = h.reshape(lanes, n, -1)
    id_bits = ocs.host_id_bits(n)
    mask = (torch.ones((n,), dtype=torch.bool, device=h.device)
            if online is None else online)
    res, pooled = ocs.ocs_maxpool_noisy_core(
        flat, mask, id_bits, rng, p_miss, bits=bits, max_id_bits=id_bits,
        max_rounds=max_rounds, backend=backend, with_pooled=True)
    return pooled.reshape((lanes,) + h.shape[2:]), res.winner, res


class _NoisyPool(torch.autograd.Function):
    """The noisy law with its accounting as extra, non-differentiable
    outputs: (pooled, rounds, collisions, contention_slots, correct)."""

    @staticmethod
    def forward(ctx, h, rng, p_miss, online, bits, max_rounds, backend):
        pooled, winner, res = _maxpool_noisy_impl(
            h, rng, p_miss, bits, max_rounds, backend, online)
        ctx.save_for_backward(winner)
        ctx.h_shape = h.shape
        acct = (res.rounds, res.collisions, res.contention_slots,
                res.correct)
        ctx.mark_non_differentiable(*acct)
        return (pooled, *acct)

    @staticmethod
    def backward(ctx, g, *_acct):
        # Eq. 6 for the actual transmitter; rng, p_miss and online get none
        (winner,) = ctx.saved_tensors
        lanes, n = ctx.h_shape[:2]
        grad = maxpool_ops.maxpool_winner_bwd(
            winner, g.reshape(lanes, -1), n, dim=1)
        return grad.reshape(ctx.h_shape), None, None, None, None, None, None


def noisy_pool(h, rng, p_miss, online, bits, max_rounds, backend):
    """Lane-leading noisy pooling: (pooled, rounds, collisions,
    contention_slots, correct), the pooled value differentiable."""
    return _NoisyPool.apply(h, rng, p_miss, online, bits, max_rounds,
                            backend)


def maxpool_noisy(h: torch.Tensor, rng: torch.Tensor, p_miss,
                  bits: int = 16, max_rounds: int = 3,
                  backend: str = "scan") -> torch.Tensor:
    """Max-pool ``h (N, ..., K)`` through the simulated OCS channel (Alg.
    1 + misses) with sensing key ``rng (2,)`` and ``p_miss`` scalar or
    ``(N,)``.

    The winner of each element is the noisy protocol's outcome and sends
    its D-bit payload; the backward routes the cotangent to it alone.  At
    ``p_miss=0`` this is ``maxpool_quantized(h, bits, "first")``, forward
    and backward.  :func:`noisy_pool` is the lane-stacked form."""
    p = torch.as_tensor(p_miss, dtype=torch.float32, device=h.device)
    return noisy_pool(h[None], rng[None], p[None], None, bits, max_rounds,
                      backend)[0][0]


# ---------------------------------------------------------------------------
# baselines
# ---------------------------------------------------------------------------

def meanpool(h: torch.Tensor, dim: int = 0) -> torch.Tensor:
    return torch.mean(h, dim=dim)


def concat(h: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """(N, ..., K) -> (..., N*K): all-gather + feature concat."""
    moved = torch.movedim(h, dim, -2)                   # (..., N, K)
    return moved.reshape(moved.shape[:-2] + (-1,))
