"""Optimizers on parameter trees (nested dicts/lists of tensors).

``opt.init(params) -> state``; ``opt.update_inplace(grads, state,
params) -> (params, state, stats)`` writes the new values into
``params`` and ``state`` (the JAX package's donated train-state buffers;
``grads`` are read, not written), one leaf at a time, so a step holds
one copy of the state and a leaf's temporaries, not two copies of the
state.  ``opt.update`` is the functional form: the same update applied
to copies, nothing passed in is written.  Master weights and moments
are float32 whatever the parameters' dtype.  ``lane_dims`` leading axes
of every leaf are independent runs (the p_miss lanes): the global norm,
and so the clipping, is taken per lane.

Under a mesh whose model axis splits some leaves, the leaves are this
rank's blocks and ``repro_torch.parallel.sharding.use_leaf_shardings``
names their shardings: the global norm adds a split leaf's squares over
the model group and counts a replicated leaf once, so every rank clips by
the norm of the whole tree.

ZeRO and FSDP (``sharding.use_leaf_shardings(..., state=)``, the
placements of the dry-run): where the optimizer state's shardings split a
leaf over the fsdp axis, AdamW updates this rank's block of master, m and
v from its block of the gradient, and gathers the new parameter blocks
over the fsdp group (ZeRO: the parameter is whole on the rank) or keeps
them (FSDP: the parameter and its gradient are blocks too).  The norm is
the whole tree's, from the whole gradients (an FSDP gradient gathered a
leaf at a time), so the step is bitwise the unsplit step: AdamW is
elementwise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import tree
from repro_torch.parallel import comm
from repro_torch.parallel import sharding


def global_norm(grads, lane_dims: int = 0) -> torch.Tensor:
    """sqrt of the sum of squares over all leaves, per lane.

    The leaves' sums are added one by one, elementwise over the lanes, and
    each lane's sum of a leaf is summed in an order that depends neither on
    the other lanes nor on how many there are, so a lane's norm is the same
    in a stack of any height (a rank's block of lanes, or the whole stack).
    The reduction that keeps that order differs by device.  On the CPU one
    reduction over the stacked lane axis keeps it (with more than one lane
    it sums each lane serially, in parallel over the lanes).  On the card
    such a reduction splits each lane over thread blocks by the number of
    lanes, so each lane gets a reduction of its own there."""
    split = _model_split(grads, lane_dims)
    if split is not None:
        return _split_norm(grads, *split)
    total = None
    for x in _whole_leaves(grads):
        sq = torch.square(x.float())
        if lane_dims and sq.is_cuda:
            runs = sq.reshape((-1,) + sq.shape[lane_dims:])
            s = torch.stack([_sum_from(r, 0) for r in runs]).reshape(
                sq.shape[:lane_dims])
        else:
            s = _sum_from(sq, lane_dims)
        total = s if total is None else total + s
    return torch.sqrt(total)


def _fsdp_dims(n: int) -> list:
    """Per parameter leaf, the dim that the fsdp axis splits under the
    named leaf shardings (FSDP), else ``None``."""
    shd = sharding.leaf_shardings()
    if shd is None or sharding.active_mesh() is None:
        return [None] * n
    return [sharding.fsdp_dim(s.spec) for s in shd]


def _gather_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole of this rank's block ``x`` along ``dim`` of the fsdp
    axis."""
    return comm.gather_from_group(x, sharding.fsdp_axis().group, dim)


def _whole_leaves(grads):
    """The gradient leaves in order, an FSDP block gathered whole as it is
    taken."""
    leaves = tree.leaves(grads)
    for x, d in zip(leaves, _fsdp_dims(len(leaves))):
        yield x if d is None else _gather_dim(x, d)


def _model_split(grads, lane_dims: int):
    """``(model axis, which leaves it splits)`` under a mesh with a model
    axis of more than one rank; ``None`` otherwise."""
    axis = sharding.mesh_axis(sharding.active_mesh(), "model")
    if axis is None:
        return None
    shd = sharding.leaf_shardings()
    n = len(tree.leaves(grads))
    if shd is None or len(shd) != n:
        raise ValueError(
            "the global norm over a model axis needs the shardings of the "
            "leaves (sharding.use_leaf_shardings, or trainer.train's "
            "shardings=)")
    if lane_dims:
        raise NotImplementedError("lane axes over a model axis")
    return axis, [any("model" in ((e,) if isinstance(e, str) else e or ())
                      for e in s.spec) for s in shd]


def _split_norm(grads, axis, split) -> torch.Tensor:
    """The whole tree's norm from this rank's blocks: the split leaves'
    squares summed over the model group, the replicated ones once."""
    parts = {True: None, False: None}
    for x, is_split in zip(_whole_leaves(grads), split):
        s = torch.sum(torch.square(x.float()))
        parts[is_split] = s if parts[is_split] is None else \
            parts[is_split] + s
    zero = torch.zeros((), dtype=torch.float32,
                       device=tree.leaves(grads)[0].device)
    total = comm.all_reduce(
        zero if parts[True] is None else parts[True], "sum", axis.group)
    if parts[False] is not None:
        total = total + parts[False]
    return torch.sqrt(total)


def _sum_from(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum over the axes of ``x`` from ``dim`` on."""
    return torch.sum(x, dim=tuple(range(dim, x.ndim)))


def _clip_scale(grads, max_norm: float, lane_dims: int):
    gn = global_norm(grads, lane_dims)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)

    def clip(x):
        s = scale.reshape(scale.shape + (1,) * (x.ndim - lane_dims))
        return (x.float() * s).to(x.dtype)

    return clip, gn


def clip_by_global_norm(grads, max_norm: float, lane_dims: int = 0):
    clip, gn = _clip_scale(grads, max_norm, lane_dims)
    return tree.map(clip, grads), gn


def _zero_dims(n: int) -> list:
    """Per parameter leaf, the dim of its optimizer state that ZeRO splits
    over the fsdp axis while the parameter is whole on the rank (the
    state's shardings named with ``use_leaf_shardings(..., state=)``),
    else ``None``: the rank updates that block and gathers the
    parameter."""
    state = sharding.state_shardings()
    if state is None or sharding.active_mesh() is None:
        return [None] * n
    if len(state) != n:
        raise ValueError(f"{len(state)} state shardings for {n} parameters")
    return [None if p is not None else sharding.fsdp_dim(s.spec)
            for p, s in zip(_fsdp_dims(n), state)]


def zero_blocks(params):
    """This rank's block of each parameter leaf where the state shardings
    named with ``use_leaf_shardings(..., state=)`` split its state over
    the fsdp axis and the parameter is whole (ZeRO): the tree AdamW's
    master weights and moments are of.  ``params`` itself where no leaf
    is so split."""
    leaves = tree.leaves(params)
    dims = _zero_dims(len(leaves))
    if all(d is None for d in dims):
        return params
    return tree.unflatten(params, [
        p if d is None else sharding.split_dim(p, sharding.fsdp_axis(), d)
        for p, d in zip(leaves, dims)])


def _step_counter(params) -> torch.Tensor:
    """The int32 step counter, on the parameters' device: the update
    advances it in place."""
    return torch.zeros((), dtype=torch.int32,
                       device=tree.leaves(params)[0].device)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update_inplace: Callable

    def update(self, grads, state, params):
        return self.update_inplace(grads, tree.map(torch.Tensor.clone, state),
                                   tree.map(torch.Tensor.clone, params))


def adamw(lr_fn: Callable, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          max_grad_norm: Optional[float] = 1.0,
          moment_dtype=torch.float32, lane_dims: int = 0) -> Optimizer:
    """AdamW with decoupled weight decay, bias correction, global-norm
    clipping and float32 master weights."""

    def init(params):
        return {
            "step": _step_counter(params),
            "master": tree.map(lambda p: p.detach().float().clone(), params),
            "m": tree.map(lambda p: torch.zeros(p.shape, dtype=moment_dtype,
                                                device=p.device), params),
            "v": tree.map(lambda p: torch.zeros(p.shape, dtype=moment_dtype,
                                                device=p.device), params),
        }

    def update_inplace(grads, state, params):
        stats = {}
        clip = None
        if max_grad_norm is not None:
            clip, stats["grad_norm"] = _clip_scale(grads, max_grad_norm,
                                                   lane_dims)
        state["step"].add_(1)
        dev = tree.leaves(params)[0].device
        # the schedule and the bias corrections on the counter's device:
        # no host value enters the step
        stepf = state["step"].to(torch.float32)
        lr = lr_fn(stepf).to(dev)
        b1t = (1 - torch.full_like(stepf, b1).pow(stepf)).to(dev)
        b2t = (1 - torch.full_like(stepf, b2).pow(stepf)).to(dev)
        leaves = tree.leaves(params)
        zero = _zero_dims(len(leaves))
        for g, m, v, master, p, zd in zip(
                tree.leaves(grads), tree.leaves(state["m"]),
                tree.leaves(state["v"]), tree.leaves(state["master"]),
                leaves, zero):
            if zd is not None:
                # ZeRO: this rank's block of the whole gradient
                g = sharding.split_dim(g, sharding.fsdp_axis(), zd)
            g = (clip(g) if clip is not None else g).float()
            if m.dtype == torch.float32:
                m_new = m.mul_(b1).add_(g * (1 - b1))
                v_new = v.mul_(b2).add_((1 - b2) * g * g)
            else:
                m_new = b1 * m.float() + (1 - b1) * g
                v_new = b2 * v.float() + (1 - b2) * g * g
            del g
            step_ = (m_new / b1t).div_((v_new / b2t).sqrt_().add_(eps))
            step_.add_(weight_decay * master)
            master.sub_(step_.mul_(lr))
            del step_
            if m_new is not m:
                m.copy_(m_new)
                v.copy_(v_new)
            if zd is None:
                p.copy_(master)
            else:
                p.copy_(_gather_dim(master.to(p.dtype), zd))
        stats["lr"] = lr
        return params, state, stats

    return Optimizer(init=init, update_inplace=update_inplace)


def sgd(lr_fn: Callable, momentum: float = 0.9,
        max_grad_norm: Optional[float] = None,
        lane_dims: int = 0) -> Optimizer:
    def init(params):
        return {"step": _step_counter(params),
                "mom": tree.map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device), params)}

    def update_inplace(grads, state, params):
        stats = {}
        clip = None
        if max_grad_norm is not None:
            clip, stats["grad_norm"] = _clip_scale(grads, max_grad_norm,
                                                   lane_dims)
        state["step"].add_(1)
        lr = lr_fn(state["step"].to(torch.float32)).to(
            tree.leaves(params)[0].device)
        for g, mo, p in zip(tree.leaves(grads), tree.leaves(state["mom"]),
                            tree.leaves(params)):
            g = clip(g) if clip is not None else g
            mo.mul_(momentum).add_(g.float())
            p.copy_(p.float() - lr * mo)
        stats["lr"] = lr
        return params, state, stats

    return Optimizer(init=init, update_inplace=update_inplace)
