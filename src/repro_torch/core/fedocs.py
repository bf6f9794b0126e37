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
forwards run the max-pool kernel (``max``: with the tie mask for
``"all"``, the winner for ``"first"``) or the fused pooling epilogue
``maxpool.decode`` over the float features (the quantized laws, after
the contention kernel for the noisy one; both form the Eq. 7 codes in
registers), and their backwards the winner-routed scatter kernel or,
for ``max`` with ``"all"``, the tie-routed one.  The
noisy law is lane-leading (``h: (L, N, ..., K)``, one key and one
``p_miss`` per lane) so that every p_miss lane of a step pools in one
call (:func:`noisy_pool`); :func:`maxpool_noisy` takes a single run.
:func:`stack_pool` pools the training curves' lane stack, the noisy
lanes and one ideal ``"first"`` lane, with one backward launch.
"""

from __future__ import annotations

import torch

from repro_torch.core import ocs
from repro_torch.core import quantize as qz
from repro_torch.kernels.maxpool import ops as maxpool_ops
from repro_torch.kernels.maxpool.ref import PoolDecode

VALID_MODES = ("sum", "max", "max_q16", "max_q8", "max_noisy", "mean",
               "concat")


def _check_tie_break(tie_break: str) -> None:
    if tie_break not in ("all", "first"):
        raise ValueError(f"unknown tie_break {tie_break!r}")


class _MaxPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, tie_break, dim):
        ctx.tie_break, ctx.dim, ctx.n = tie_break, dim, h.shape[dim]
        if tie_break == "all":
            # the tie mask is all the backward reads: h is not kept
            pooled, ties = maxpool_ops.maxpool_ties(h, dim)
            ctx.save_for_backward(ties)
        else:
            pooled, winner = maxpool_ops.maxpool_fused(h, dim)
            ctx.save_for_backward(winner)
        return pooled

    @staticmethod
    def backward(ctx, g):
        (saved,) = ctx.saved_tensors
        bwd = (maxpool_ops.maxpool_ties_bwd if ctx.tie_break == "all"
               else maxpool_ops.maxpool_winner_bwd)
        return bwd(saved, g, ctx.n, ctx.dim), None, None


def maxpool(h: torch.Tensor, tie_break: str = "all",
            dim: int = 0) -> torch.Tensor:
    """Max over the worker axis ``dim`` with a winner-routed backward."""
    _check_tie_break(tie_break)
    return _MaxPool.apply(h, tie_break, dim % h.ndim)


class _MaxPoolQuantized(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, bits, tie_break, dim):
        ctx.tie_break, ctx.dim, ctx.n = tie_break, dim, h.shape[dim]
        if tie_break == "first":
            # one launch from the floats: the pooled value and the winner
            out = maxpool_ops.maxpool_decode(h, bits, h.dtype, dim=dim,
                                             argmax=True)
            ctx.save_for_backward(out.argmax)
            return out.pooled
        # the straight-through backward needs every worker's code
        codes = qz.quantize(h, bits)
        out = maxpool_ops.maxpool_decode(codes, bits, h.dtype, dim=dim,
                                         max_code=True)
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
                        online=None, out=None):
    """Lane-leading protocol-outcome pooling.

    h (L, N, ..., K), rng (L, 2), p_miss (L,) or (L, N), online None or
    (N,)/(L, N) bool -> (pooled (L, ..., K), winner (L, M) int32 with M the
    flattened element count, the core's ``NoisyOCSResult``); ``out`` as
    the core's, (L, M) tensors to write the pooled value and winner into."""
    lanes, n = h.shape[:2]
    flat = h.reshape(lanes, n, -1)
    id_bits = ocs.host_id_bits(n)
    mask = (torch.ones((n,), dtype=torch.bool, device=h.device)
            if online is None else online)
    res, pooled = ocs.ocs_maxpool_noisy_core(
        flat, mask, id_bits, rng, p_miss, bits=bits, max_id_bits=id_bits,
        max_rounds=max_rounds, backend=backend, with_pooled=True, out=out)
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


class _StackPool(torch.autograd.Function):
    """The training curves' lane stack ``h (L+1, N, ..., K)``: lanes
    ``0..L-1`` through the noisy law, lane ``L`` through the quantized law
    with ``tie_break="first"`` (the ideal reference run), written into one
    pooled ``(L+1, ..., K)`` tensor and one ``(L+1, M)`` winner buffer.
    Outputs (pooled, rounds, collisions, contention_slots, correct), the
    accounting of the noisy lanes.  The backward is one winner-routed
    scatter over all ``L+1`` lanes: each lane's own ``g * onehot``, the
    gradient of each law, with no slices to sum."""

    @staticmethod
    def forward(ctx, h, rng, p_miss, online, bits, max_rounds, backend):
        lanes, n = h.shape[0] - 1, h.shape[1]
        flat = h.reshape(lanes + 1, n, -1)
        pooled = torch.empty((lanes + 1, flat.shape[2]), dtype=h.dtype,
                             device=h.device)
        winner = torch.empty(pooled.shape, dtype=torch.int32,
                             device=h.device)
        _, _, res = _maxpool_noisy_impl(
            flat[:lanes], rng, p_miss, bits, max_rounds, backend, online,
            out=(pooled[:lanes], winner[:lanes]))
        maxpool_ops.maxpool_decode(
            flat[lanes:], bits, h.dtype, argmax=True,
            out=PoolDecode(pooled[lanes:], None, winner[lanes:], None))
        ctx.save_for_backward(winner)
        ctx.h_shape = h.shape
        acct = (res.rounds, res.collisions, res.contention_slots,
                res.correct)
        ctx.mark_non_differentiable(*acct)
        # the accounting's cotangents are never read: no zero fills
        ctx.set_materialize_grads(False)
        return (pooled.reshape((lanes + 1,) + h.shape[2:]), *acct)

    @staticmethod
    def backward(ctx, g, *_acct):
        (winner,) = ctx.saved_tensors
        stack, n = ctx.h_shape[:2]
        grad = maxpool_ops.maxpool_winner_bwd(
            winner, g.reshape(stack, -1), n, dim=1)
        return grad.reshape(ctx.h_shape), None, None, None, None, None, None


def stack_pool(h, rng, p_miss, online, bits, max_rounds, backend):
    """Pool a lane stack ``h (L+1, N, ..., K)``: the ``L`` noisy lanes
    (``rng (L, 2)``, ``p_miss (L,)`` or ``(L, N)``, ``online``) and, last,
    the ideal ``maxpool_quantized(bits, "first")`` lane -> (pooled (L+1,
    ..., K), rounds, collisions, contention_slots, correct), the pooled
    value differentiable.  Equal, forward and backward, to ``noisy_pool``
    of the first L lanes and ``maxpool_quantized`` of the last,
    concatenated, but for the sign of the gradient's zeros: each lane keeps
    its law's ``g * onehot`` (``-0.0`` off the winner for a negative g),
    where pooling two slices of h apart sums their zero-filled gradients
    and so makes those zeros ``+0.0``."""
    return _StackPool.apply(h, rng, p_miss, online, bits, max_rounds,
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
