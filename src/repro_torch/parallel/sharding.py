"""Logical-axis sharding over ``torch.distributed`` ranks (the JAX
package's ``parallel/sharding.py``).

Every parameter has a tuple of logical axis names (``m.axes()``, the tree
the JAX package's ``split_tree`` returns); :data:`DEFAULT_RULES` maps them
to mesh axes, :func:`resolve_axes` gives a per-dim spec on a mesh and
:func:`sharding_for_shape` drops (replicates) a dim its mesh axis does not
divide, as in JAX.  Where GSPMD partitions a global array, the port gives
each rank its block of every leaf (:func:`shard_values`): the contiguous
slice along each dim that a mesh axis splits, at this rank's coordinate on
that axis.  :func:`gather_values` puts the whole leaves back together by a
rank-ordered ``all_gather`` over the axis that split them.

Inside :func:`use_mesh` the model functions take their extents from the
leaves they are given and call the collectives GSPMD would insert
(:mod:`repro_torch.parallel.comm`); outside it, or on a mesh whose axes
all have size 1, they run their single-device code op for op.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch import tree
from repro_torch.parallel import comm

# logical axis -> mesh axis (or tuple of mesh axes). Axes absent from the
# active mesh are dropped at resolution time, so one rule table serves the
# (data, model) and (pod, data, model) meshes.
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "worker": "model",        # FedOCS worker axis == TP shard axis
    "heads": "model",
    "kv_heads": "model",
    "experts": "model",
    "vocab": "model",
    "ff": "model",
    "embed": None,
    "ff_local": None,
    "seq": None,
    "kv_seq": "data",         # sequence-parallel KV cache (long-context decode)
    "layers": None,
    "conv": None,
    "state": None,
    "fsdp": ("pod", "data"),  # ZeRO axis for optimizer state / master weights
    None: None,
}

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's placement: the mesh and one spec entry per dim (``None``,
    a mesh axis name, or a tuple of them), as JAX's ``NamedSharding``."""

    mesh: Any
    spec: Spec


def is_axes(x) -> bool:
    """Whether ``x`` is one leaf's axes: a tuple of names or ``None``."""
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def map_axes(fn, axes_tree, *rest):
    """``fn(axes, *leaves)`` over an axes tree and trees of its structure
    (dicts and lists; a tuple of names is a leaf)."""
    if is_axes(axes_tree):
        return fn(axes_tree, *rest)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, axes_tree[k], *(r[k] for r in rest))
                for k in axes_tree}
    return type(axes_tree)(map_axes(fn, a, *(r[i] for r in rest))
                           for i, a in enumerate(axes_tree))


def mesh_axis_sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def resolve_axes(logical_axes: Sequence[Optional[str]], mesh,
                 rules: dict = DEFAULT_RULES) -> Spec:
    """logical axis names -> a spec valid on ``mesh``: per dim ``None``,
    one mesh axis name, or a tuple of them."""
    names = set(mesh.axis_names)
    spec = []
    for ax in logical_axes:
        mapped = rules.get(ax, None)
        if mapped is None:
            spec.append(None)
            continue
        if isinstance(mapped, str):
            mapped = (mapped,)
        present = tuple(m for m in mapped if m in names)
        if not present:
            spec.append(None)
        elif len(present) == 1:
            spec.append(present[0])
        else:
            spec.append(present)
    return tuple(spec)


def _entry_names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _entry_of(names: Tuple[str, ...]):
    """The spec entry of the mesh axes ``names``: ``None``, one name, or
    the tuple of them."""
    if not names:
        return None
    return names[0] if len(names) == 1 else names


def sharding_for_shape(logical_axes, shape, mesh,
                       rules: dict = DEFAULT_RULES) -> NamedSharding:
    """The spec of :func:`resolve_axes` with every dim that its mesh
    extent does not divide replicated (36 heads or a 122753 vocab over a
    16-way axis stay whole).  A mesh axis that an earlier dim's entry
    names, divided or not, leaves a later dim whole: a decode cache's
    ``kv_seq`` under :data:`DEFAULT_RULES`, which map it and ``batch``
    both to ``data`` (JAX refuses such a spec; the cache's rows take the
    axis)."""
    sizes = mesh_axis_sizes(mesh)
    spec, taken = [], set()
    for entry, dim in zip(resolve_axes(logical_axes, mesh, rules),
                          tuple(shape)):
        names = tuple(nm for nm in _entry_names(entry) if nm not in taken)
        taken.update(_entry_names(entry))
        ways = math.prod(sizes[nm] for nm in names)
        spec.append(_entry_of(names) if dim % ways == 0 else None)
    return NamedSharding(mesh, tuple(spec))


def tree_shardings_for_values(axes_tree, values_tree, mesh,
                              rules: dict = DEFAULT_RULES):
    """Per-leaf shape-aware shardings (axes zipped with the values'
    shapes, which may be the whole leaves or anything with ``.shape``)."""
    return map_axes(lambda ax, v: sharding_for_shape(ax, v.shape, mesh,
                                                     rules),
                    axes_tree, values_tree)


# ---------------------------------------------------------------------------
# the mesh context
# ---------------------------------------------------------------------------

class _MeshCtx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: dict = DEFAULT_RULES
        self.leaf_shardings = None
        self.state_shardings = None
        self.batch_axis = None
        self.fsdp = None


_CTX = _MeshCtx()
_CTX_FIELDS = ("mesh", "rules", "leaf_shardings", "state_shardings",
               "batch_axis", "fsdp")


def context() -> tuple:
    """The mesh context as it stands: the mesh and its rules, the leaf
    shardings, the batch split and the FSDP scope."""
    return tuple(getattr(_CTX, k) for k in _CTX_FIELDS)


@contextlib.contextmanager
def restored(state: tuple):
    """The mesh context :func:`context` read, reinstated: a recompute that
    runs in the backward, after the forward's scopes closed
    (``torch.utils.checkpoint``), splits and gathers as its forward did."""
    prev = context()
    for k, v in zip(_CTX_FIELDS, state):
        setattr(_CTX, k, v)
    try:
        yield
    finally:
        for k, v in zip(_CTX_FIELDS, prev):
            setattr(_CTX, k, v)


@contextlib.contextmanager
def use_mesh(mesh, rules: dict = DEFAULT_RULES):
    """Run the model functions on this rank's blocks of ``mesh`` under
    ``rules``."""
    prev = _CTX.mesh, _CTX.rules
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def active_mesh():
    return _CTX.mesh


def active_rules() -> dict:
    return _CTX.rules


@contextlib.contextmanager
def use_leaf_shardings(shardings, state=None):
    """Name the shardings of the parameter leaves (a flat list in leaf
    order) for the optimizer's global norm: a leaf split over the model
    axis adds its blocks' squares over the model group, a replicated leaf
    counts once.  A leaf split over the fsdp axis is gathered where the
    model uses it (:func:`fsdp_scope`).  ``state``, the shardings of the
    optimizer state's leaves of each parameter (in the same order), names
    those that ZeRO splits over the fsdp axis: the optimizer updates this
    rank's block of them (``optim/optimizers.py``)."""
    prev = _CTX.leaf_shardings, _CTX.state_shardings
    _CTX.leaf_shardings, _CTX.state_shardings = shardings, state
    try:
        yield
    finally:
        _CTX.leaf_shardings, _CTX.state_shardings = prev


def leaf_shardings():
    return _CTX.leaf_shardings


def state_shardings():
    return _CTX.state_shardings


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it, or several taken together: its
    size, this rank's index on it and the process group of the ranks that
    differ only there.  ``name`` is the axis's name, or a tuple of the
    names it combines."""

    name: Any
    size: int
    index: int
    group: Any


def mesh_axis(mesh, name: str) -> Optional[Axis]:
    """``mesh``'s axis ``name`` where it spans more than one rank, else
    ``None``."""
    if mesh is None or name not in mesh.axis_names:
        return None
    size = mesh_axis_sizes(mesh)[name]
    if size == 1:
        return None
    return Axis(name, size, mesh.axis_index(name), mesh.group(name))


def logical_axis(logical: str) -> Optional[Axis]:
    """The active mesh's axis that ``logical`` maps to under the active
    rules, where it spans more than one rank; ``None`` outside a mesh,
    for an unmapped axis, or a size-1 one.  A logical axis over several
    mesh axes of more than one rank (``batch`` over ``("pod", "data")``)
    is one combined axis: its size is theirs multiplied, its index the
    row-major one over them (the order in which JAX splits a dim over
    several axes), its group the mesh's group of their plane."""
    mesh = _CTX.mesh
    if mesh is None:
        return None
    entry = resolve_axes((logical,), mesh, _CTX.rules)[0]
    return mesh_axes(mesh, _entry_names(entry))


def mesh_axes(mesh, names: Sequence[str]) -> Optional[Axis]:
    """The axis over ``mesh``'s axes ``names`` that span more than one
    rank, combined where there are several; ``None`` where none does."""
    axes = [a for a in (mesh_axis(mesh, nm) for nm in names)
            if a is not None]
    if len(axes) < 2:
        return axes[0] if axes else None
    wide = tuple(a.name for a in axes)
    group = mesh.group(wide)
    if group is None:
        raise ValueError(f"the mesh has no group over {wide}")
    size, index = _index_on(mesh, wide)
    return Axis(wide, size, index, group)


def split_of(logical: str, local: int, whole: int) -> Optional[Axis]:
    """The mesh axis that splits a dim of ``whole`` entries of which a leaf
    holds ``local``: ``None`` where it holds them all, else the axis that
    ``logical`` maps to, which must split them so."""
    if local == whole:
        return None
    axis = logical_axis(logical)
    if axis is None or local * axis.size != whole:
        raise ValueError(f"{local} of {whole} {logical} entries, but the "
                         f"active mesh does not split them so")
    return axis


def batch_split(batch: int) -> Optional[Axis]:
    """The mesh axis that splits a batch of ``batch`` rows: the one
    ``"batch"`` maps to, where it divides them."""
    axis = logical_axis("batch")
    return axis if axis is not None and batch % axis.size == 0 else None


@contextlib.contextmanager
def split_batch(batch: int):
    """Around a model entry point called with ``batch`` rows: yields
    :func:`batch_split`'s axis, which :func:`batch_axis` returns inside."""
    prev = _CTX.batch_axis
    _CTX.batch_axis = batch_split(batch)
    try:
        yield _CTX.batch_axis
    finally:
        _CTX.batch_axis = prev


def batch_axis() -> Optional[Axis]:
    """The axis that splits the rows of the model call in progress."""
    return _CTX.batch_axis


def split_dim(x: torch.Tensor, axis: Optional[Axis],
              dim: int = 0) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (``x`` itself for no
    axis)."""
    if axis is None:
        return x
    size = x.shape[dim] // axis.size
    return x.narrow(dim, axis.index * size, size)


# ---------------------------------------------------------------------------
# decode caches: a rank's rows and its kv_seq block
# ---------------------------------------------------------------------------

def kv_seq_axis() -> Optional[Axis]:
    """The axis that splits a decode cache's sequence under the active
    mesh and rules: the mesh axes ``kv_seq`` maps to that the cache's rows
    (``batch``) do not already take (:func:`sharding_for_shape`'s rule),
    combined as :func:`mesh_axes` combines them; ``None`` outside a mesh
    or where they are one rank.  The long-context rules
    (``launch/mesh.rules_for``) map ``batch`` to nothing and ``kv_seq`` to
    ``(pod,) data``; the other cells' rules and :data:`DEFAULT_RULES`
    leave the sequence whole."""
    mesh = _CTX.mesh
    if mesh is None:
        return None
    batch, seq = resolve_axes(("batch", "kv_seq"), mesh, _CTX.rules)
    return mesh_axes(mesh, [nm for nm in _entry_names(seq)
                            if nm not in _entry_names(batch)])


def kv_seq_block(local: int) -> Tuple[Optional[Axis], int]:
    """``(kv_seq_axis(), offset)`` for a cache leaf that holds ``local``
    positions: this rank's block starts at global position ``offset``, so
    local row ``t`` is position ``offset + t`` of a sequence of ``local *
    axis.size``."""
    axis = kv_seq_axis()
    return axis, 0 if axis is None else axis.index * local


def cache_splits(batch: int, seq: int) -> Tuple[Optional[Axis],
                                                Optional[Axis]]:
    """The axes that split a decode cache of ``batch`` rows and ``seq``
    positions under the active mesh and rules, ``(rows, sequence)``, as
    :func:`sharding_for_shape` places its ``("batch", "kv_seq")`` dims
    (``None`` for a dim held whole).  The sequence axis must divide
    ``seq``: a decode step reads a split from the rules alone."""
    mesh = _CTX.mesh
    if mesh is None:
        return None, None
    spec = sharding_for_shape(("batch", "kv_seq"), (batch, seq), mesh,
                              _CTX.rules).spec
    seq_axis = kv_seq_axis()
    if seq_axis is not None and spec[1] is None:
        raise ValueError(f"a cache of {seq} positions over a "
                         f"{seq_axis.size}-way kv_seq axis")
    return mesh_axes(mesh, _entry_names(spec[0])), seq_axis


def local_size(n: int, axis: Optional[Axis]) -> int:
    """A rank's share of ``n`` entries that ``axis`` splits (all of them
    for no axis)."""
    return n if axis is None else n // axis.size


# ---------------------------------------------------------------------------
# blocks of leaves
# ---------------------------------------------------------------------------

def _index_on(mesh, names: Tuple[str, ...]) -> Tuple[int, int]:
    """(ways, this rank's block index) of a dim split over ``names``,
    row-major over them as JAX orders a multi-axis dim."""
    sizes = mesh_axis_sizes(mesh)
    ways, index = 1, 0
    for nm in names:
        ways *= sizes[nm]
        index = index * sizes[nm] + mesh.axis_index(nm)
    return ways, index


def block_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of a rank's block of a leaf of ``shape`` under ``spec``."""
    sizes = mesh_axis_sizes(mesh)
    return tuple(d // math.prod(sizes[nm] for nm in _entry_names(e))
                 for d, e in zip(shape, spec))


def block(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``spec`` (a
    view)."""
    for dim, entry in enumerate(spec):
        names = _entry_names(entry)
        if not names:
            continue
        ways, index = _index_on(mesh, names)
        size = x.shape[dim] // ways
        x = x.narrow(dim, index * size, size)
    return x


def shard_values(values, axes, mesh, rules: dict = DEFAULT_RULES):
    """This rank's blocks of the whole leaves ``values``, as contiguous
    copies (a leaf that stays whole is the leaf itself)."""
    def one(ax, v):
        spec = sharding_for_shape(ax, v.shape, mesh, rules).spec
        b = block(v, spec, mesh)
        return b.contiguous().clone() if b is not v else v
    return map_axes(one, axes, values)


def gather_leaves(blocks: Sequence[torch.Tensor], specs: Sequence[Spec],
                  mesh) -> list:
    """The whole leaves of ``blocks`` (one spec each): for each spec entry
    that splits a dim over ranks (one mesh axis, or several taken together
    as :func:`mesh_axes` combines them), one rank-ordered ``all_gather``
    of every block that it splits, concatenated along that dim.  Every
    rank of the mesh calls it with the same leaves."""
    out = list(blocks)
    entries = []
    for sp in specs:
        for entry in sp:
            names = _entry_names(entry)
            if names and names not in entries:
                entries.append(names)
    # one mesh axis before the combined ones, each in the mesh's order
    entries.sort(key=lambda names: (len(names), [mesh.axis_names.index(nm)
                                                 for nm in names]))
    for names in entries:
        ax = mesh_axes(mesh, names)
        if ax is None:
            continue
        at = [(i, d) for i, sp in enumerate(specs)
              for d, entry in enumerate(sp) if _entry_names(entry) == names]
        parts = comm.all_gather([out[i] for i, _ in at], ax.group)
        for j, (i, d) in enumerate(at):
            out[i] = torch.cat([p[j] for p in parts], dim=d)
    return out


def gather_values(values, shardings):
    """The whole leaves of a tree of blocks, given their
    :class:`NamedSharding` tree (the structure of ``values``)."""
    leaves = tree.leaves(values)
    shd = flat_shardings(shardings)
    if not shd:
        return values
    whole = gather_leaves(leaves, [s.spec for s in shd], shd[0].mesh)
    return tree.unflatten(values, whole)


def flat_shardings(shardings) -> list:
    """The :class:`NamedSharding` leaves of a tree, in leaf order."""
    return [s for s in tree.leaves(shardings)
            if isinstance(s, NamedSharding)]


def replicated(mesh, ndim: int) -> NamedSharding:
    return NamedSharding(mesh, (None,) * ndim)


# ---------------------------------------------------------------------------
# ZeRO-1 optimizer-state axes: the fsdp axis on the largest unsharded and
# divisible dim of each parameter (the placements of the AdamW state, and
# of the parameters under FSDP: placement below)
# ---------------------------------------------------------------------------

def _resolves_unsharded(ax, mesh_names, rules) -> bool:
    """True if this logical axis maps to no axis of the mesh."""
    mapped = rules.get(ax, None)
    if mapped is None:
        return True
    if isinstance(mapped, str):
        mapped = (mapped,)
    return not any(m in mesh_names for m in mapped)


def zero_axes(axes: Tuple[Optional[str], ...], shape: Tuple[int, ...],
              fsdp_size: int, mesh_names=(), rules: dict = DEFAULT_RULES
              ) -> Tuple[Optional[str], ...]:
    """Add the fsdp axis to the largest effectively unsharded divisible
    dim (an axis like 'embed'/'ff_local' resolves to None and is
    eligible); idempotent."""
    if fsdp_size <= 1 or "fsdp" in axes:
        return axes
    best, best_dim = None, 0
    for i, (ax, dim) in enumerate(zip(axes, shape)):
        if (_resolves_unsharded(ax, mesh_names, rules)
                and dim % fsdp_size == 0 and dim > best_dim):
            best, best_dim = i, dim
    if best is None:
        return axes
    out = list(axes)
    out[best] = "fsdp"
    return tuple(out)


def zero_axes_tree(axes_tree, values_tree, mesh,
                   rules: dict = DEFAULT_RULES):
    """Per-leaf ZeRO axes given the leaves' shapes."""
    sizes = mesh_axis_sizes(mesh)
    names = set(mesh.axis_names)
    fsdp_axes = rules.get("fsdp", ())
    if isinstance(fsdp_axes, str):
        fsdp_axes = (fsdp_axes,)
    fsdp_size = math.prod(sizes[a] for a in fsdp_axes if a in sizes) \
        if fsdp_axes else 1
    return map_axes(lambda ax, v: zero_axes(ax, tuple(v.shape), fsdp_size,
                                            names, rules),
                    axes_tree, values_tree)


# ---------------------------------------------------------------------------
# ZeRO and FSDP: leaves split over the fsdp axis
# ---------------------------------------------------------------------------

def fsdp_axis() -> Optional[Axis]:
    """The active mesh's fsdp axis (``("pod", "data")`` combined on the
    multi-pod mesh), where it spans more than one rank."""
    return logical_axis("fsdp")


def fsdp_dim(spec: Spec) -> Optional[int]:
    """The dim of a leaf's spec that the active mesh's fsdp axis splits;
    ``None`` where none does, or where that axis is one rank."""
    if fsdp_axis() is None:
        return None
    names = _entry_names(resolve_axes(("fsdp",), _CTX.mesh, _CTX.rules)[0])
    for d, entry in enumerate(spec):
        if _entry_names(entry) == names:
            return d
    return None


@contextlib.contextmanager
def fsdp_scope(values):
    """Around a model entry point called with the parameter tree
    ``values``: the leaves that the leaf shardings (:func:`use_leaf_shardings`)
    split over the fsdp axis are gathered where the model takes them
    (:func:`fsdp_whole`, :func:`fsdp_period`), and what autograd saves of
    a gathered leaf is kept as its block and gathered again in the
    backward (``comm.regather_saved``)."""
    shd = _CTX.leaf_shardings
    axis = fsdp_axis() if _CTX.mesh is not None else None
    dims = {}
    if axis is not None and shd is not None and _CTX.fsdp is None:
        leaves = tree.leaves(values)
        dims = {id(leaf): fsdp_dim(s.spec) for leaf, s in zip(leaves, shd)
                if fsdp_dim(s.spec) is not None}
        if dims and len(shd) != len(leaves):
            raise ValueError(f"{len(shd)} leaf shardings for {len(leaves)} "
                             f"parameters")
    if not dims:
        yield
        return
    _CTX.fsdp = (dims, axis)
    try:
        with comm.regather_saved():
            yield
    finally:
        _CTX.fsdp = None


def _gather(block: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    rows = _CTX.batch_axis
    if rows is not None and rows.name != axis.name:
        raise NotImplementedError(
            f"FSDP over {axis.name} with the batch split over {rows.name}")
    return comm.gather_block(block, axis.group, dim, rows is not None)


def fsdp_whole(leaf: torch.Tensor) -> torch.Tensor:
    """The whole of a parameter leaf that :func:`fsdp_scope` names split
    over the fsdp axis; the leaf itself otherwise."""
    if _CTX.fsdp is None or id(leaf) not in _CTX.fsdp[0]:
        return leaf
    dims, axis = _CTX.fsdp
    return _gather(leaf, dims[id(leaf)], axis)


def fsdp_period(stacked: torch.Tensor, view: torch.Tensor) -> torch.Tensor:
    """The whole of ``view``, a period of the stacked parameter leaf
    ``stacked`` (its index on the period axis), where :func:`fsdp_scope`
    names ``stacked`` split over the fsdp axis; ``view`` otherwise."""
    if _CTX.fsdp is None or id(stacked) not in _CTX.fsdp[0]:
        return view
    dims, axis = _CTX.fsdp
    if dims[id(stacked)] == 0:
        raise NotImplementedError("FSDP over the period axis")
    return _gather(view, dims[id(stacked)] - 1, axis)


# ---------------------------------------------------------------------------
# the placement of a model's parameters and AdamW state
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a model's parameters and its AdamW state live on a mesh:
    ``axes`` and ``shardings``, the values' logical axes and
    :class:`NamedSharding` tree (the fsdp axis added where FSDP splits the
    values), and ``state_axes`` and ``state_shardings``, those of the
    master weights and both moments (ZeRO: the fsdp axis added), each a
    tree of the values' structure."""

    axes: Any
    shardings: Any
    state_axes: Any
    state_shardings: Any


def placement(axes, whole, mesh, rules: dict = DEFAULT_RULES,
              fsdp: bool = False) -> Placement:
    """The placement of parameters of logical axes ``axes`` whose whole
    leaves are ``whole`` (or anything with their shapes): the values
    split over the mesh axes their logical axes map to, and with ``fsdp``
    over the fsdp axis too; the AdamW master and moments split over the
    fsdp axis (:func:`zero_axes_tree`).  The dry-run's placements
    (``launch/dryrun.place``) and ``trainer.train``'s under ZeRO and
    FSDP."""
    if fsdp:
        axes = zero_axes_tree(axes, whole, mesh, rules)
    state_axes = zero_axes_tree(axes, whole, mesh, rules)
    return Placement(
        axes, tree_shardings_for_values(axes, whole, mesh, rules),
        state_axes, tree_shardings_for_values(state_axes, whole, mesh,
                                              rules))
