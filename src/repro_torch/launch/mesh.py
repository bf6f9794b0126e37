"""Meshes over ``torch.distributed`` ranks and per-cell sharding rules (the
JAX package's ``launch/mesh.py``).

A mesh is a ``(data, model)`` grid over the ranks of the default process
group, one process per device (``torchrun``, or
``repro_torch.parallel.comm.spawn``).  Rank ``r`` sits at ``(r // model,
r % model)``, as ``jax.make_mesh`` lays a 2-D mesh out, and holds the
process group of its row (the ``model`` axis: the ranks that split the
workers, heads and vocabulary) and of its column (the ``data`` axis: the
ranks that split the batch).  ``make_production_mesh`` comes with the
dry-run (ROADMAP queue 1, item 19c).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch.distributed as dist

from repro_torch.parallel import comm
from repro_torch.parallel import sharding as sh


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Ranks laid out on named axes.  ``devices`` holds the global ranks
    (``devices.shape`` is the mesh's shape, as a JAX mesh's devices);
    ``groups[name]`` is this rank's process group along ``name`` where
    that axis spans more than one rank."""

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

    def group(self, name: str):
        return self.groups.get(name)


def make_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A ``(data, model)`` mesh over ranks ``0 .. data * model - 1`` of the
    default group, which must have exactly that many.  Every rank calls
    it, in the same order as its other ``new_group`` calls (the groups'
    creation is collective).  Without a process group only the 1 x 1 mesh
    exists."""
    world = comm.world_size()
    if data * model != world:
        where = (f"the process group has {world} rank(s)"
                 if comm.initialized() else "no process group is initialised")
        raise ValueError(f"a {data} x {model} mesh needs {data * model} "
                         f"ranks, but {where}")
    ranks = np.arange(data * model).reshape(data, model)
    groups: Dict[str, Any] = {}
    if comm.initialized():
        me = comm.rank()
        for name, lines in (("model", ranks), ("data", ranks.T)):
            if lines.shape[1] == 1:
                continue
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if me in line:
                    groups[name] = g
    return Mesh(ranks, ("data", "model"), groups)


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
