"""Meshes over ``torch.distributed`` ranks and per-cell sharding rules (the
JAX package's ``launch/mesh.py``).

A mesh is a ``(data, model)`` grid, or a ``(pod, data, model)`` one, over
the ranks of the default process group, one process per device
(``torchrun``, or ``repro_torch.parallel.comm.spawn``).  The ranks lie
row-major on it, as ``jax.make_mesh`` lays a mesh out: rank ``r`` of a
``(data, model)`` mesh sits at ``(r // model, r % model)``.  Each rank
holds the process group of every line through it along one axis of
more than one rank (``model``: the ranks that split the workers, heads
and vocabulary; ``data``: the ranks that split the batch; ``pod``), and
where ``pod`` and ``data`` both do, the group of the plane through it
along both (``("pod", "data")``: the batch and the ``fsdp`` axis of the
multi-pod mesh).  :func:`make_production_mesh` gives the dry-run's
(16, 16) and (2, 16, 16) meshes; a dry-run builds them over a fake
process group of 256 or 512 ranks (``launch/dryrun.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch.distributed as dist

from repro_torch.parallel import comm
from repro_torch.parallel import sharding as sh


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Ranks laid out on named axes.  ``devices`` holds the global ranks
    (``devices.shape`` is the mesh's shape, as a JAX mesh's devices);
    ``groups[name]`` is this rank's process group along ``name`` where
    that axis spans more than one rank, ``groups[names]`` the group of
    a pair of :data:`COMBINED` axes that both do."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]
    groups: Dict[str, Any]

    @property
    def shape(self) -> Dict[str, int]:
        return sh.mesh_axis_sizes(self)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coord(self) -> Tuple[int, ...]:
        """This rank's coordinates on the mesh."""
        r = comm.rank()
        if r >= self.size:
            raise ValueError(f"rank {r} is not on a mesh of {self.size}")
        return tuple(int(i) for i in np.unravel_index(r, self.devices.shape))

    def axis_index(self, name: str) -> int:
        return self.coord()[self.axis_names.index(name)]

    def group(self, name):
        """The group along ``name``: one axis name or a tuple of them."""
        return self.groups.get(name)


# the pairs of axes that a logical axis maps to together (``batch`` and
# ``fsdp`` over ``("pod", "data")``): their planes get a group of their own
COMBINED = (("pod", "data"),)


def make_mesh(data: int = 1, model: int = 1, pod: Optional[int] = None
              ) -> Mesh:
    """A ``(data, model)`` mesh, or with ``pod`` a ``(pod, data, model)``
    one, over ranks ``0 .. size - 1`` of the default group, which must
    have exactly that many.  Every rank calls it, in the same order as
    its other ``new_group`` calls (the groups' creation is collective).
    Without a process group only the mesh of one rank exists."""
    names = ("data", "model") if pod is None else ("pod", "data", "model")
    shape = (data, model) if pod is None else (pod, data, model)
    size = math.prod(shape)
    world = comm.world_size()
    if size != world:
        where = (f"the process group has {world} rank(s)"
                 if comm.initialized() else "no process group is initialised")
        raise ValueError(f"a {' x '.join(map(str, shape))} mesh needs {size} "
                         f"ranks, but {where}")
    ranks = np.arange(size).reshape(shape)
    groups: Dict[Any, Any] = {}
    if comm.initialized():
        me = comm.rank()
        wide = [nm for nm, n in zip(names, shape) if n > 1]
        along = [(nm,) for nm in wide] + [
            c for c in COMBINED if all(nm in wide for nm in c)]
        for axes in along:
            # the lines along ``axes``: those axes last, row-major
            at = [names.index(nm) for nm in axes]
            rest = [i for i in range(len(names)) if i not in at]
            lines = ranks.transpose(rest + at).reshape(
                -1, math.prod(shape[i] for i in at))
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if me in line:
                    groups[axes[0] if len(axes) == 1 else axes] = g
    return Mesh(ranks, names, groups)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The dry-run's meshes: (16, 16) over ``(data, model)``, or (2, 16,
    16) over ``(pod, data, model)``."""
    return make_mesh(16, 16, pod=2 if multi_pod else None)


def make_debug_mesh(data: int = 2, model: int = 2) -> Mesh:
    """A small mesh for the multi-rank tests."""
    return make_mesh(data, model)


def rules_for(shape_name: str, global_batch: int, mesh) -> dict:
    """Per-cell logical-axis rule table.

    Long-context decode cells cannot shard their batch (B=1); the KV cache
    sequence is sharded over the data(+pod) axes instead.  Other cells
    shard the batch over (pod, data) and keep kv_seq local."""
    rules = dict(sh.DEFAULT_RULES)
    sizes = sh.mesh_axis_sizes(mesh)
    batch_ways = sizes.get("pod", 1) * sizes.get("data", 1)
    if global_batch % batch_ways != 0 or shape_name == "long_500k":
        rules["batch"] = None
        rules["kv_seq"] = ("pod", "data") if "pod" in sizes else ("data",)
    else:
        rules["kv_seq"] = None
    return rules
