"""Checkpointing in the JAX package's on-disk layout (its
``checkpoint/checkpointer.py``), so that a checkpoint written by either
package restores in the port.

Layout per checkpoint:
    <dir>/step_<N>/
        index.json            tree keys, shapes, dtypes, extra
        shard_0.npz           the raw buffers
        COMMIT                written last -> completeness marker
    <dir>/latest              text file with the newest committed step

A checkpoint is written into a temporary directory that ``os.replace``
moves into place, so a crash mid-write never leaves a torn ``step_<N>``
with a ``COMMIT``; ``latest_step`` ignores directories without one.

Keys are the JAX package's path strings: dict keys (sorted), ``#i`` for a
list or tuple index, ``.field`` for a dataclass field (a ``FaultState``
flattens to ``aux/.bad``, ..., ``aux/.consec``), joined by ``/``.  A
``bfloat16`` leaf is stored as its raw 2-byte words (numpy ``V2``, as
``np.asarray`` of a JAX bf16 array saves) with ``"bfloat16"`` in the
index's ``dtypes``; ``restore`` rebuilds the type from the index.  The
index's ``"axes"`` holds each leaf's logical axes where ``save`` is given
them, in the JAX package's format.

Leaves are stored whole, so a checkpoint restores onto any mesh (elastic
re-meshing).  Under a mesh, ``save`` takes the leaves' shardings, gathers
every leaf over the ranks that split it (the model axis's blocks, and a
ZeRO or FSDP block over the fsdp axis alike), and rank 0 writes while the
others wait at a barrier; ``restore(shardings=)`` reads the whole leaves
and keeps this rank's block of each, a ZeRO block where the shardings
split the state so.  A checkpoint is thus the same file whatever mesh
and placement wrote it; the index's ``"axes"`` says how its writer split
each leaf (``trainer.train`` with a ``sharding.Placement`` names the
optimizer state's ZeRO axes under each state leaf's own key).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.convert import _ML_DTYPES
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as sh

SEP = "/"

# torch types stored as raw words, by the numpy name the index records
_WORDS = {dtype: (name, word) for name, (word, dtype) in _ML_DTYPES.items()}


def _flatten_with_paths(tree, prefix: Tuple[str, ...] = (),
                        is_leaf=None) -> Dict[str, Any]:
    """Leaves of ``tree`` by their JAX path strings, in JAX's leaf order
    (``None`` is an empty subtree, as in JAX); a ``NamedSharding``, and
    whatever ``is_leaf`` accepts, is a leaf."""
    if tree is None:
        return {}
    if isinstance(tree, sh.NamedSharding) or (is_leaf and is_leaf(tree)):
        return {SEP.join(prefix): tree}
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"#{i}", x) for i, x in enumerate(tree)]
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [(f".{f.name}", getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    else:
        return {SEP.join(prefix): tree}
    flat: Dict[str, Any] = {}
    for name, sub in items:
        flat.update(_flatten_with_paths(sub, prefix + (name,), is_leaf))
    return flat


def _rebuild(tree, leaves: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    """``tree``'s structure with each leaf replaced by ``leaves[path]``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, leaves, prefix + (f"#{i}",))
                          for i, x in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), leaves,
                             prefix + (f".{f.name}",))
            for f in dataclasses.fields(tree)})
    return leaves[SEP.join(prefix)]


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(array to store, dtype name for the index)."""
    if not isinstance(leaf, torch.Tensor):
        a = np.asarray(leaf)
        return a, str(a.dtype)
    t = leaf.detach().cpu()
    if t.dtype in _WORDS:
        name, word = _WORDS[t.dtype]
        raw = t.view(torch.int16 if np.dtype(word).itemsize == 2
                     else torch.int8).numpy()
        return raw.view(f"V{raw.itemsize}"), name
    a = t.numpy()
    return a, str(a.dtype)


def _from_numpy(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    """The tensor of a loaded array, sharing its memory (a copy only of an
    array that is not writable)."""
    if not a.flags.writeable:
        a = a.copy()
    if dtype_name in _ML_DTYPES:
        word, dtype = _ML_DTYPES[dtype_name]
        return torch.from_numpy(a.view(word)).view(dtype)
    return torch.from_numpy(a)


def save(ckpt_dir: str, step: int, values, axes_tree=None,
         extra: Optional[Dict[str, Any]] = None, shardings=None) -> str:
    """Write one checkpoint of ``values`` (nested dicts, lists, tuples and
    dataclasses of tensors) and, with ``axes_tree``, each leaf's logical
    axes; returns its directory.  With ``shardings`` (a tree of
    ``NamedSharding`` matching ``values``, as ``restore`` takes it) the
    leaves are this rank's blocks: every rank calls ``save``, the leaves
    are gathered whole, rank 0 writes and every rank waits for it at a
    barrier of the default group."""
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    if shardings is None:
        _write(ckpt_dir, final, step, values, axes_tree, extra)
        return final
    flat = _flatten_with_paths(values)
    shd = _flatten_with_paths(shardings)
    whole = sh.gather_leaves(list(flat.values()),
                             [shd[k].spec if k in shd else () for k in flat],
                             next(iter(shd.values())).mesh)
    if comm.rank() == 0:
        _write(ckpt_dir, final, step, dict(zip(flat, whole)), axes_tree,
               extra)
    if comm.initialized():
        dist.barrier()
    return final


def _write(ckpt_dir, final, step, values, axes_tree, extra) -> None:
    """Write one checkpoint's directory and move the pointer to it."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        arrays, dtypes = {}, {}
        for k, v in _flatten_with_paths(values).items():
            arrays[k], dtypes[k] = _to_numpy(v)
        np.savez(os.path.join(tmp, "shard_0.npz"), **arrays)
        axes = {} if axes_tree is None else {
            k: list(v) for k, v in _flatten_with_paths(
                axes_tree, is_leaf=sh.is_axes).items()}
        index = {
            "step": step,
            "keys": sorted(arrays),
            "shapes": {k: list(a.shape) for k, a in arrays.items()},
            "dtypes": dtypes,
            "axes": axes,
            "extra": extra or {},
            "n_hosts": 1,
        }
        with open(os.path.join(tmp, "index.json"), "w") as f:
            json.dump(index, f)
        with open(os.path.join(tmp, "COMMIT"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    with open(os.path.join(ckpt_dir, ".latest_tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(ckpt_dir, ".latest_tmp"),
               os.path.join(ckpt_dir, "latest"))


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest *committed* step (ignores torn/uncommitted directories)."""
    marker = os.path.join(ckpt_dir, "latest")
    candidates = []
    if os.path.exists(marker):
        with open(marker) as f:
            try:
                candidates.append(int(f.read().strip()))
            except ValueError:
                pass
    if os.path.isdir(ckpt_dir):
        for name in os.listdir(ckpt_dir):
            if name.startswith("step_"):
                path = os.path.join(ckpt_dir, name)
                if os.path.exists(os.path.join(path, "COMMIT")):
                    candidates.append(int(name[len("step_"):]))
    return max(candidates) if candidates else None


def restore(ckpt_dir: str, step: Optional[int] = None, template=None,
            shardings=None, device=None) -> Tuple[Any, int, Dict[str, Any]]:
    """Load a checkpoint: ``(tree, step, extra)``.

    ``template`` is a tree of the same structure (its leaves only name
    the paths; a ``None`` subtree is skipped).  Each leaf comes back with
    the type the index records, on ``device``, or where ``device`` is
    None on the device of the template's leaf (the CPU for a leaf that is
    no tensor).  ``shardings``, a tree of ``NamedSharding`` matching the
    template, keeps this rank's block of each leaf (any mesh: the elastic
    path); a leaf it does not name stays whole."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)
    if template is None:
        raise ValueError("restore requires a structure template")
    flat_template = _flatten_with_paths(template)
    # only the leaves the template names are read
    data = {}
    for name in os.listdir(path):
        if name.startswith("shard_") and name.endswith(".npz"):
            with np.load(os.path.join(path, name)) as z:
                for k in z.files:
                    if k in flat_template:
                        data[k] = z[k]
    missing = set(flat_template) - set(data)
    if missing:
        raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")

    flat_shd = (_flatten_with_paths(shardings)
                if shardings is not None else {})

    def materialize(key, like):
        t = _from_numpy(data.pop(key), index["dtypes"][key])
        if key in flat_shd:
            t = sh.block(t, flat_shd[key].spec,
                         flat_shd[key].mesh).contiguous()
        if device is not None:
            return t.to(device)
        return t.to(like.device) if isinstance(like, torch.Tensor) else t

    leaves = {k: materialize(k, v) for k, v in flat_template.items()}
    return _rebuild(template, leaves), step, index.get("extra", {})
