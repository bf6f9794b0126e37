"""Parameters across the two packages.

``params_from_jax`` turns the JAX package's ``vertical.init`` pytree — as
numpy arrays, e.g. ``jax.tree.map(np.asarray, params)`` — into the port's
dict of torch tensors, with the same nesting (dicts, lists) and leading
worker axis on the encoder leaves, so both packages start from the same
values.  This module imports neither package's JAX side: the caller
converts to numpy.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree_of_numpy, device=None):
    """Nested dicts/lists/tuples of arrays -> the same nesting of tensors
    (copies, so the result owns its memory)."""
    if isinstance(tree_of_numpy, dict):
        return {k: params_from_jax(v, device)
                for k, v in tree_of_numpy.items()}
    if isinstance(tree_of_numpy, (list, tuple)):
        return type(tree_of_numpy)(params_from_jax(v, device)
                                   for v in tree_of_numpy)
    return torch.from_numpy(np.array(tree_of_numpy)).to(device)
