"""Compressed data-parallel all-reduce as a policy object (the JAX
package's ``optim/compressed_allreduce.py``).

:class:`CompressedAllReduce` puts top-k sparsification with error feedback
(``optim/grad_compression.py``) behind one entry point,

    ``reduce(grads, err, rank_dim=...) -> (reduced, new_err, DPAccounting)``

and bills the payload from the **kept-element counts** of the exact-k
masks, so the number in :class:`DPAccounting` is a measurement that equals
the analytic bill, not the ``2 * k_frac`` estimate the per-leaf k floor
makes wrong for small leaves.

The DP ranks are a tensor axis on one device (``rank_dim``, where the JAX
package names a vmap axis), or ``torch.distributed`` ranks (``group``,
where it names a mesh axis), or both: each rank then holds a block of the
rank axis.  Either way the ranks' sparse leaves are gathered into the one
``rank_dim`` layout and summed in fixed rank order by explicit adds, so
every placement, the card and the CPU sum the same values in the same
order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.optim import grad_compression
from repro_torch.parallel import comm


@dataclasses.dataclass(frozen=True)
class DPAccounting:
    """Measured payload accounting of one ``CompressedAllReduce.reduce``,
    int32, totalled over the ranks (one value per lane of the leading
    axes before ``rank_dim``):

    * ``payload_bits`` — bits shipped: per leaf, kept nonzeros x
      (value_bits + index bits), summed over leaves and ranks; equal to
      ``CompressedAllReduce.payload_bits(tree) * n_ranks``;
    * ``kept_elems`` — kept (transmitted) elements over leaves and ranks;
    * ``dense_bits`` — what an uncompressed all-reduce ships (elements x
      value_bits x n_ranks).
    """

    payload_bits: torch.Tensor
    kept_elems: torch.Tensor
    dense_bits: torch.Tensor


def _leaf_index_bits(n: int) -> int:
    """Bits to address one element of an n-element leaf (>= 1)."""
    return max(1, math.ceil(math.log2(max(n, 2))))


def _leaf_sizes(tree_):
    leaves = tree.leaves(tree_)
    if not leaves:
        raise ValueError("CompressedAllReduce: tree has no leaves")
    return [int(np.prod(np.shape(leaf))) for leaf in leaves]


@dataclasses.dataclass(frozen=True)
class CompressedAllReduce:
    """One DP gradient-compression policy, all static.  Build it with
    :meth:`topk`.

    * ``k_frac`` — kept fraction per tensor; each leaf keeps exactly
      ``max(1, int(n * k_frac))`` largest-|.| entries (error feedback
      accumulates the rest, the dtype-cast residual included).
    * ``value_bits`` — wire width of one kept value (32 = raw float32).
    * ``index_bits`` — wire width of one kept index; ``None`` derives
      ``ceil(log2(n))`` per leaf, an int fixes a uniform width.
    """

    k_frac: float
    value_bits: int = 32
    index_bits: Optional[int] = None

    def __post_init__(self):
        if not (0.0 < self.k_frac <= 1.0):
            raise ValueError(f"k_frac must be in (0, 1], got {self.k_frac}")
        if not (1 <= self.value_bits <= 32):
            raise ValueError(
                f"value_bits must be in [1, 32], got {self.value_bits}")
        if self.index_bits is not None and self.index_bits < 1:
            raise ValueError(
                f"index_bits must be >= 1 or None, got {self.index_bits}")

    @classmethod
    def topk(cls, k_frac: float, *, value_bits: int = 32,
             index_bits: Optional[int] = None) -> "CompressedAllReduce":
        """Top-k magnitude sparsification with error feedback."""
        return cls(k_frac=float(k_frac), value_bits=value_bits,
                   index_bits=index_bits)

    def init_error(self, params):
        """Zero error-feedback memory shaped like ``params`` (float32)."""
        return grad_compression.init_error(params)

    # -- analytic payload facts (host-side ints) ----------------------------

    def leaf_index_bits(self, n: int) -> int:
        return (self.index_bits if self.index_bits is not None
                else _leaf_index_bits(n))

    def leaf_payload_bits(self, n: int) -> int:
        """Wire bits of ONE rank's push of an n-element leaf."""
        kept = grad_compression.topk_count(n, self.k_frac)
        return kept * (self.value_bits + self.leaf_index_bits(n))

    def payload_bits(self, tree_) -> int:
        """Analytic wire bits of ONE rank's push of the whole tree."""
        return sum(self.leaf_payload_bits(n) for n in _leaf_sizes(tree_))

    def dense_bits(self, tree_) -> int:
        """Wire bits of an uncompressed push of the tree (one rank)."""
        return sum(n * self.value_bits for n in _leaf_sizes(tree_))

    def payload_fraction(self, tree_) -> float:
        """Achieved compression ratio against dense (one rank)."""
        return self.payload_bits(tree_) / self.dense_bits(tree_)

    # -- the reduction law --------------------------------------------------

    def reduce(self, grads, err, *, rank_dim: Optional[int] = None,
               group=None) -> Tuple[object, object, DPAccounting]:
        """Compress, all-reduce and bill one gradient tree.

        With ``rank_dim=None`` ``grads``/``err`` are one rank's trees and
        this is the degenerate 1-rank all-reduce: ``reduced`` is the rank's
        own sparse tree.  With ``rank_dim=r`` every leaf is ``(*lanes,
        n_ranks, *leaf_shape)`` with ``r`` lane axes: each (lane, rank)
        sparsifies its own leaf, ``reduced`` is the ranks' sparse leaves
        summed in rank order (``(*lanes, *leaf_shape)``), ``new_err`` keeps
        the rank axis, and the accounting is totalled over the ranks, one
        value per lane.  ``reduced`` is NOT divided by the rank count.

        ``group`` (a ``torch.distributed`` process group, the JAX
        package's ``axis_name``) adds the group's ranks to the rank axis:
        each rank sparsifies its own leaves, one ``all_gather`` over the
        group puts every rank's sparse leaves and counts into the
        ``rank_dim`` layout in group-rank order (a new leading rank axis
        for ``rank_dim=None``), and the same left fold sums them, so the
        sum is bitwise the one-device sum.  Every rank gets the whole
        reduction; ``new_err`` stays the rank's own.
        """
        batch = 0 if rank_dim is None else rank_dim + 1
        sparse_leaves, new_err_leaves = [], []
        payload = kept_total = None
        dense = 0
        for g, e in zip(tree.leaves(grads), tree.leaves(err)):
            sparse, new_err, kept = grad_compression.compress_counted(
                g, e, self.k_frac, batch)
            n = math.prod(g.shape[batch:])
            bits = kept * (self.value_bits + self.leaf_index_bits(n))
            payload = bits if payload is None else payload + bits
            kept_total = kept if kept_total is None else kept_total + kept
            dense += n * self.value_bits
            sparse_leaves.append(sparse)
            new_err_leaves.append(new_err)
        if payload is None:
            raise ValueError("CompressedAllReduce: tree has no leaves")
        if group is not None:
            if rank_dim is None:                # one rank's tree: a rank axis
                rank_dim = 0
                sparse_leaves = [s.unsqueeze(0) for s in sparse_leaves]
                payload, kept_total = payload[None], kept_total[None]
            parts = comm.all_gather(sparse_leaves + [payload, kept_total],
                                    group)
            sparse_leaves = [torch.cat([p[i] for p in parts], dim=rank_dim)
                             for i in range(len(sparse_leaves))]
            payload = torch.cat([p[-2] for p in parts], dim=-1)
            kept_total = torch.cat([p[-1] for p in parts], dim=-1)
        if rank_dim is not None:
            ranks = payload.shape[-1]
            reduced_leaves = []
            for s in sparse_leaves:
                total = s.select(rank_dim, 0)
                for d in range(1, ranks):       # fixed rank order
                    total = total + s.select(rank_dim, d)
                reduced_leaves.append(total)
            payload = payload.sum(dim=-1, dtype=torch.int32)
            kept_total = kept_total.sum(dim=-1, dtype=torch.int32)
            dense *= ranks
        else:
            reduced_leaves = sparse_leaves
        acct = DPAccounting(
            payload_bits=payload, kept_elems=kept_total,
            dense_bits=torch.full(payload.shape, dense, dtype=torch.int32,
                                  device=payload.device))
        return (tree.unflatten(grads, reduced_leaves),
                tree.unflatten(grads, new_err_leaves), acct)
