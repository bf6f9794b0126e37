"""Lane placement over ``torch.distributed`` ranks (the JAX package's
``sim/shard.py``).

The grid runners shard one leading "lane" axis over ranks: ``run_sweep``
the scenario axis of each group, ``run_curves`` the ``p_miss`` lanes, and
``run_curves_dp`` lanes x data-parallel ranks on a 2-D mesh.  A rank is a
process with one device (``torchrun``, or ``repro_torch.parallel.comm
.spawn``); ``n_devices`` counts ranks of the default process group:

* ``None`` means all of them, or 1 when no group is initialised (the JAX
  package's "every local device");
* ``k`` uses ranks ``0..k-1``, and raises ``ValueError`` when the group
  has fewer, or when there is no group and ``k > 1``.

Every rank of the default group calls the engine and gets the whole
result, as JAX's single controller does; a rank the placement leaves out
computes nothing and receives it.  Placement changes no result: lanes are
padded to a multiple of the rank count by repeating row 0
(:func:`pad_lanes`), rank ``r`` runs its contiguous block
(:func:`block`), and :func:`gather_lanes` collects the blocks in rank order
and drops the padding.  In place of ``shard_1d``/``shard_2d`` (``shard_map``
has no torch counterpart) an engine runs its block and gathers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.parallel import comm


def resolve_devices(n_devices: Optional[int]) -> int:
    """The rank count of an engine's placement (see the module doc)."""
    world = comm.world_size()
    if n_devices is None:
        return world
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if n > world:
        where = (f"the process group has {world} rank(s)"
                 if comm.initialized() else "no process group is initialised")
        raise ValueError(f"n_devices={n} ranks asked for, but {where}")
    return n


def lane_devices(n_devices: Optional[int], n_lanes: int) -> int:
    """Ranks actually used for ``n_lanes`` lanes (``None`` = the world)."""
    if n_devices is None:
        n_devices = comm.world_size()
    return max(1, min(int(n_devices), n_lanes))


def dp_mesh_shape(n_devices: Optional[int], n_lanes: int,
                  dp_shards: int) -> Tuple[int, int]:
    """Split ``n_devices`` into (lane-mesh size, DP-mesh size).

    The DP axis lies either wholly on ranks (``n_d == dp_shards``) or
    wholly in the tensor (``n_d == 1``), never split, so the gathered
    stacking order is the same in every placement; lanes take the ranks
    that remain."""
    if n_devices is None:
        n_devices = comm.world_size()
    n_devices = int(n_devices)
    n_d = dp_shards if 1 < dp_shards <= n_devices else 1
    n_s = max(1, min(n_devices // n_d, n_lanes))
    return n_s, n_d


def pad_lanes(x, n_devices: int):
    """Pad axis 0 of an array or tensor up to a multiple of ``n_devices``
    by repeating row 0.  The padding rows ride along as inert lanes and
    are dropped after the gather."""
    pad = (-x.shape[0]) % n_devices
    if not pad:
        return x
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x[:1].expand((pad,) + x.shape[1:])])
    return np.concatenate([x, np.repeat(x[:1], pad, axis=0)], axis=0)


def block(x, n_blocks: int, index: int):
    """Block ``index`` of ``n_blocks`` equal blocks of axis 0 (of a padded
    lane axis)."""
    size = x.shape[0] // n_blocks
    return x[index * size:(index + 1) * size]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Ranks ``0..size-1`` of the default group laid out on the lane axis
    ``"s"`` and, for a 2-D mesh, the DP axis ``"d"``.

    ``ranks[c]`` is the global rank at coordinate ``c`` (row-major, as
    ``jax.make_mesh`` lays out devices); ``groups["d"]`` is this rank's
    process group along the DP axis, where that spans more than one rank
    (the engines' collectives on the lane axis use the default group)."""

    ranks: np.ndarray
    groups: Dict[str, object]

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.ranks.shape

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def coord(self) -> Optional[Tuple[int, ...]]:
        """This rank's coordinates; ``None`` for a rank the mesh leaves
        out."""
        r = comm.rank()
        if r >= self.size:
            return None
        return tuple(int(i) for i in np.unravel_index(r, self.shape))

    def owners(self) -> List[int]:
        """The ranks holding lane blocks ``0, 1, ...`` of the first axis:
        coordinate 0 on every other axis."""
        return [int(r) for r in self.ranks.reshape(self.shape[0], -1)[:, 0]]


def mesh_1d(n_devices: int) -> Mesh:
    """A 1-D lane mesh over ranks ``0..n_devices-1``."""
    return Mesh(np.arange(n_devices), {})


def mesh_2d(n_s: int, n_d: int) -> Mesh:
    """A 2-D (lanes x data-parallel ranks) mesh over ranks ``0..n_s*n_d-1``.

    Each row along ``"d"`` gets a process group for the DP reduction.
    With a process group initialised every rank of the default group must
    call this, in the same order (``dist.new_group`` is collective), the
    ranks the mesh leaves out too."""
    ranks = np.arange(n_s * n_d).reshape(n_s, n_d)
    groups = {}
    if n_d > 1 and comm.initialized():
        me = comm.rank()
        for row in ranks:
            g = dist.new_group([int(r) for r in row])
            if me in row:
                groups["d"] = g
    return Mesh(ranks, groups)


class _Leaf:
    """A tensor's (shape, dtype) standing in for it in a broadcast tree."""

    __slots__ = ("spec",)

    def __init__(self, spec):
        self.spec = spec


def gather_blocks(blk, mesh: Mesh, device) -> List:
    """Every lane block of ``mesh``, in lane order: one tree per owner
    rank (:meth:`Mesh.owners`), each the ``blk`` tree that rank passed.

    Every rank of the default group calls this.  Ranks of the mesh pass
    their block (a dict/list/tuple tree of tensors, the same structure,
    shapes and types on each); ranks it leaves out pass ``None`` and learn
    the structure from the first owner.  Without a process group the
    one-rank mesh's block comes back as it is."""
    if not comm.initialized():
        return [blk]
    owners = mesh.owners()
    if mesh.size < comm.world_size():
        # some rank holds no block: it takes the shapes from the first owner
        meta = [None if blk is None else tree.map(
            lambda t: _Leaf((tuple(t.shape), t.dtype)), blk)]
        dist.broadcast_object_list(meta, src=owners[0])
        like = meta[0]
    else:
        like = None
    if blk is None:
        spec_list = [leaf.spec for leaf in tree.leaves(like)]
        parts = comm.all_gather(None, spec_list=spec_list, device=device)
        structure = like
    else:
        parts = comm.all_gather(tree.leaves(blk))
        structure = blk
    return [tree.unflatten(structure, parts[r]) for r in owners]


def gather_lanes(blk, n_lanes: int, mesh: Mesh, device):
    """:func:`gather_blocks` with each leaf's blocks concatenated on axis
    0 and the padding dropped: leaves ``(n_lanes, ...)`` on every rank."""
    blocks = gather_blocks(blk, mesh, device)
    return tree.map(lambda *bs: torch.cat(bs)[:n_lanes], *blocks)
