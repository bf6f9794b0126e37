"""Nested dict/list/tuple containers of tensors (the port's pytrees).

Leaves come out in JAX's order: dict keys sorted, sequences in order, so a
reduction over leaves (the optimizer's global norm) sums in the same order
as ``jax.tree.leaves`` does.
"""

from __future__ import annotations

from typing import Any, Callable, List


def leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def map(fn: Callable, tree, *rest):  # noqa: A001 (mirrors jax.tree.map)
    """Apply ``fn`` leafwise over ``tree`` and trees of the same structure."""
    if isinstance(tree, dict):
        return {k: map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def unflatten(tree, new_leaves: List[Any]):
    """Rebuild ``tree``'s structure around ``new_leaves`` (in leaf order)."""
    return _build(tree, iter(new_leaves))


def _build(t, it):
    # module level, not a closure over itself: a self-referencing closure
    # is a reference cycle that kept the iterator, and so every leaf of
    # ``new_leaves``, alive until the cyclic garbage collector ran
    if isinstance(t, dict):
        built = {k: _build(t[k], it) for k in sorted(t)}
        return {k: built[k] for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_build(x, it) for x in t)
    return next(it)
