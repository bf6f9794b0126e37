"""Winner-sparse gradient compression with error feedback (the JAX
package's ``optim/grad_compression.py``).

The FedOCS backward is exactly sparse (only argmax winners receive
gradient — paper Eq. 6).  This module generalizes that into a top-k
magnitude sparsifier with error feedback for the data-parallel gradient
reduction: each DP rank keeps the k largest-magnitude entries per tensor,
accumulates the residual locally, and adds it to the next step's gradient.

Three invariants, as in the JAX package:

* ``topk_mask`` keeps **exactly** ``k = max(1, int(n * k_frac))`` entries
  per tensor, and a tie at the threshold goes to the lowest flat index
  (``lax.top_k``'s order).  ``torch.topk`` promises no order among ties on
  the card, so the selection is a stable descending sort of ``|x|``.
* The error memory accumulates the **dtype-cast residual** too: it is
  taken against the value actually sent (``sparse`` in ``g``'s dtype), so
  ``sparse.float() + new_err == g.float() + err`` exactly.
* ``payload_fraction`` bills the **per-leaf** k floors.

Every function takes ``batch_dims`` leading axes of independent tensors
(the (lane, rank) stack of the DP curves), so one call per leaf serves the
whole stack.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch import tree


def topk_count(n: int, k_frac: float) -> int:
    """Number of entries kept for a tensor of ``n`` elements."""
    return max(1, int(n * k_frac))


def topk_mask(x: torch.Tensor, k_frac: float,
              batch_dims: int = 0) -> torch.Tensor:
    """Boolean mask keeping exactly the k largest-|x| entries of each
    tensor (the axes after the first ``batch_dims``), ties to the lowest
    flat index."""
    lead = x.shape[:batch_dims]
    flat = x.reshape(lead + (-1,)).abs()
    k = topk_count(flat.shape[-1], k_frac)
    idx = torch.sort(flat, dim=-1, descending=True, stable=True).indices
    mask = torch.zeros(flat.shape, dtype=torch.bool, device=x.device)
    mask.scatter_(-1, idx[..., :k], True)
    return mask.reshape(x.shape)


def compress_counted(g: torch.Tensor, err: torch.Tensor, k_frac: float,
                     batch_dims: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sparse gradient in ``g``'s dtype, new float32 error memory, kept
    count per tensor as int32 of the ``batch_dims`` shape)."""
    corrected = g.float() + err
    mask = topk_mask(corrected, k_frac, batch_dims)
    sparse = torch.where(mask, corrected, 0.0).to(g.dtype)
    new_err = corrected - sparse.float()
    kept = mask.reshape(g.shape[:batch_dims] + (-1,)).sum(
        dim=-1, dtype=torch.int32)
    return sparse, new_err, kept


def compress(g: torch.Tensor, err: torch.Tensor, k_frac: float,
             batch_dims: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sparse gradient, new error memory)."""
    sparse, new_err, _ = compress_counted(g, err, k_frac, batch_dims)
    return sparse, new_err


def compress_tree(grads, err_tree, k_frac: float, batch_dims: int = 0):
    """:func:`compress` leaf by leaf: (sparse tree, new error tree)."""
    out = [compress(g, e, k_frac, batch_dims)
           for g, e in zip(tree.leaves(grads), tree.leaves(err_tree))]
    return (tree.unflatten(grads, [o[0] for o in out]),
            tree.unflatten(grads, [o[1] for o in out]))


def init_error(params):
    """Zero float32 error memory shaped like ``params``."""
    return tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def payload_fraction(tree_, k_frac: float) -> float:
    """Analytic DP payload ratio against a dense all-reduce (value + index
    at 2x per kept element), with the per-leaf k floor: ``2 * sum_i
    max(1, int(n_i * k_frac)) / sum_i n_i``, capped at 1."""
    leaves = tree.leaves(tree_)
    if not leaves:
        raise ValueError("payload_fraction: tree has no leaves")
    sizes = [int(np.prod(np.shape(leaf))) for leaf in leaves]
    kept = sum(topk_count(n, k_frac) for n in sizes)
    return min(1.0, 2.0 * kept / sum(sizes))
