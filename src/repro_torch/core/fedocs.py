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
from repro_torch.kernels.ocs_quant import ref as code_ref
from repro_torch.parallel import comm

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
# the laws over a model group: each rank holds a contiguous block of workers
# ---------------------------------------------------------------------------
#
# Rank ``r`` of the group (an ``Axis`` of ``repro_torch.parallel.sharding``)
# pools its own workers with the kernel, and one all-reduce over the group
# combines the local results into the pooled value of the whole stack, the
# same bits on every rank.  Workers are contiguous by rank, so the law's
# first argmax is on the lowest rank whose local max equals the pooled
# value, at that rank's own first argmax.  The backward stays local: each
# rank routes the cotangent to its own winners, as the one-rank law routes
# it to those rows of the stack.


def _max_key(m: torch.Tensor, index: int, size: int) -> torch.Tensor:
    """An integer key of a rank's local max whose max over the ranks
    decodes (:func:`_from_key`) to the law's pooled value: a number's
    full-width order code (-0.0 just below +0.0, so a tie of the two pools
    to +0.0, as ``jnp.max``), and a NaN above every number, the lowest
    rank's first, keeping that NaN's own bits.  int32 for 16-bit floats,
    int64 for float32: a backend's own max of floats has no rule for
    signed zeros and NaNs."""
    w = 8 * m.element_size()
    raw = code_ref.to_int64(m.view(torch.int16 if w == 16 else torch.int32))
    key = torch.where(torch.isnan(m), ((1 + size - index) << w) | raw,
                      code_ref.monotone_code_int64(m))
    return key.to(torch.int32 if w == 16 else torch.int64)


def _from_key(key: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    w = 8 * dtype.itemsize
    mask, sign = (1 << w) - 1, 1 << (w - 1)
    k = key.to(torch.int64)
    low = k & mask
    bits = torch.where((low & sign) == 0, ~low & mask, low & ~sign)
    return code_ref.from_int64(torch.where(k > mask, low, bits), dtype)


def _owner(eq: torch.Tensor, axis) -> torch.Tensor:
    """Whether this rank holds the law's first argmax of each element:
    the lowest rank where ``eq`` holds, by an all-reduce(min) of the rank
    index (uint8 where the group has fewer than 256 ranks)."""
    dt = torch.uint8 if axis.size < 256 else torch.int32
    cand = torch.where(eq, axis.index, axis.size).to(dt)
    return comm.all_reduce(cand, "min", axis.group) == axis.index


class _MaxPoolOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, tie_break, axis):
        ctx.tie_break, ctx.n = tie_break, h.shape[0]
        local = maxpool_ops.maxpool_fwd(h, 0, winner=tie_break == "first",
                                        ties=tie_break == "all")
        key = _max_key(local.pooled, axis.index, axis.size)
        pooled = _from_key(comm.all_reduce(key, "max", axis.group), h.dtype)
        eq = local.pooled == pooled
        if tie_break == "all":
            ctx.save_for_backward(local.ties, eq)
        else:
            eq = eq | (torch.isnan(local.pooled) & torch.isnan(pooled))
            ctx.save_for_backward(local.winner, _owner(eq, axis))
        return pooled

    @staticmethod
    def backward(ctx, g):
        saved, mine = ctx.saved_tensors
        # g where this rank's workers can hold the max, g * 0 (g's sign)
        # where none can, as the one-rank law's rows there
        g = torch.where(mine, g, g * 0)
        bwd = (maxpool_ops.maxpool_ties_bwd if ctx.tie_break == "all"
               else maxpool_ops.maxpool_winner_bwd)
        return bwd(saved, g, ctx.n, 0), None, None


def maxpool_over(h: torch.Tensor, tie_break: str, axis) -> torch.Tensor:
    """:func:`maxpool` (over axis 0) of the stack whose workers are split
    over ``axis``'s ranks, ``h`` this rank's block: ``maxpool.fwd`` over
    the local workers and an all-reduce(max) of an order key of their max;
    ``"first"`` adds an all-reduce(min) of the owning rank."""
    _check_tie_break(tie_break)
    return _MaxPoolOver.apply(h, tie_break, axis)


class _MaxPoolQuantizedOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, bits, tie_break, axis):
        ctx.tie_break, ctx.n = tie_break, h.shape[0]
        if tie_break == "first":
            local = maxpool_ops.maxpool_decode(h, bits, h.dtype, dim=0,
                                               max_code=True, argmax=True)
        else:
            codes = qz.quantize(h, bits)
            local = maxpool_ops.maxpool_decode(codes, bits, h.dtype, dim=0,
                                               max_code=True)
        code = comm.all_reduce(local.max_code, "max", axis.group)
        if tie_break == "first":
            eq = (code_ref.to_int64(local.max_code)
                  == code_ref.to_int64(code))
            ctx.save_for_backward(local.argmax, _owner(eq, axis))
        else:
            ctx.save_for_backward(codes, code)
        return qz.dequantize(code, bits, h.dtype)

    @staticmethod
    def backward(ctx, g):
        if ctx.tie_break == "first":
            winner, mine = ctx.saved_tensors
            return (maxpool_ops.maxpool_winner_bwd(
                winner, torch.where(mine, g, g * 0), ctx.n, 0),
                None, None, None)
        codes, pooled_code = ctx.saved_tensors
        mask = codes == pooled_code.unsqueeze(0)
        return g.unsqueeze(0) * mask.to(g.dtype), None, None, None


def maxpool_quantized_over(h: torch.Tensor, bits: int, tie_break: str,
                           axis) -> torch.Tensor:
    """:func:`maxpool_quantized` (over axis 0) of the stack whose workers
    are split over ``axis``'s ranks: the local workers' D-bit codes and
    their max, an all-reduce(max) of the codes themselves (uint8 for
    D <= 8), then the Eq. 7 decode."""
    _check_tie_break(tie_break)
    return _MaxPoolQuantizedOver.apply(h, bits, tie_break, axis)


# ---------------------------------------------------------------------------
# baselines
# ---------------------------------------------------------------------------

def meanpool(h: torch.Tensor, dim: int = 0) -> torch.Tensor:
    return torch.mean(h, dim=dim)


def concat(h: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """(N, ..., K) -> (..., N*K): all-gather + feature concat."""
    moved = torch.movedim(h, dim, -2)                   # (..., N, K)
    return moved.reshape(moved.shape[:-2] + (-1,))
