"""Parameters across the two packages.

``params_from_jax`` turns a JAX package parameter tree (``vertical.init``,
or the value tree of ``models.model.init``) — as numpy arrays, e.g.
``jax.tree.map(np.asarray, params)`` — into the port's dict of torch
tensors with the same nesting (dicts, lists) and the same leaf layout, so
both packages start from the same values.  This module imports neither
package's JAX side: the caller converts to numpy.
"""

from __future__ import annotations

import numpy as np
import torch

# ml_dtypes types (JAX's bfloat16 and float8) by numpy name -> the unsigned
# word they are stored in and the torch type of the same bits
_ML_DTYPES = {"bfloat16": (np.uint16, torch.bfloat16),
              "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
              "float8_e5m2": (np.uint8, torch.float8_e5m2)}


def _tensor(a) -> torch.Tensor:
    """One array as a tensor of the same type and bits; ``torch.from_numpy``
    refuses ``ml_dtypes`` arrays, so those go across as their raw words."""
    a = np.array(a)
    if a.dtype.name in _ML_DTYPES:
        word, dtype = _ML_DTYPES[a.dtype.name]
        return torch.from_numpy(a.view(word)).view(dtype)
    if a.dtype.kind == "V":
        raise TypeError(f"no torch type for numpy {a.dtype}")
    return torch.from_numpy(a)


def params_from_jax(tree_of_numpy, device=None):
    """Nested dicts/lists/tuples of arrays -> the same nesting of tensors
    (copies, so the result owns its memory), bit for bit, ``bfloat16``
    leaves included."""
    if isinstance(tree_of_numpy, dict):
        return {k: params_from_jax(v, device)
                for k, v in tree_of_numpy.items()}
    if isinstance(tree_of_numpy, (list, tuple)):
        return type(tree_of_numpy)(params_from_jax(v, device)
                                   for v in tree_of_numpy)
    return _tensor(tree_of_numpy).to(device)
