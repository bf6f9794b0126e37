"""Optimizers on parameter trees (nested dicts/lists of tensors).

``opt.init(params) -> state``; ``opt.update(grads, state, params) ->
(new_params, new_state, stats)``, functional: nothing is updated in
place.  Master weights and moments are float32 whatever the parameters'
dtype.  ``lane_dims`` leading axes of every leaf are independent runs (the
p_miss lanes): the global norm, and so the clipping, is taken per lane.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import tree


def global_norm(grads, lane_dims: int = 0) -> torch.Tensor:
    """sqrt of the sum of squares over all leaves, per lane.

    The leaves' sums are added one by one, elementwise over the lanes: a
    reduction across a stacked lane axis may take another order for some
    lanes than for others, and lanes that saw the same gradients must get
    the same norm."""
    total = None
    for x in tree.leaves(grads):
        sq = torch.sum(torch.square(x.float()),
                       dim=tuple(range(lane_dims, x.ndim)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float, lane_dims: int = 0):
    gn = global_norm(grads, lane_dims)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)

    def clip(x):
        s = scale.reshape(scale.shape + (1,) * (x.ndim - lane_dims))
        return (x.float() * s).to(x.dtype)

    return tree.map(clip, grads), gn


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def adamw(lr_fn: Callable, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          max_grad_norm: Optional[float] = 1.0,
          moment_dtype=torch.float32, lane_dims: int = 0) -> Optimizer:
    """AdamW with decoupled weight decay, bias correction, global-norm
    clipping and float32 master weights."""

    def init(params):
        return {
            "step": torch.zeros((), dtype=torch.int32),
            "master": tree.map(lambda p: p.detach().float().clone(), params),
            "m": tree.map(lambda p: torch.zeros(p.shape, dtype=moment_dtype,
                                                device=p.device), params),
            "v": tree.map(lambda p: torch.zeros(p.shape, dtype=moment_dtype,
                                                device=p.device), params),
        }

    def update(grads, state, params):
        step = state["step"] + 1
        stats = {}
        if max_grad_norm is not None:
            grads, gn = clip_by_global_norm(grads, max_grad_norm, lane_dims)
            stats["grad_norm"] = gn
        dev = tree.leaves(params)[0].device
        stepf = step.to(torch.float32)
        lr = lr_fn(stepf).to(dev)
        b1t = (1 - torch.pow(torch.tensor(b1, dtype=torch.float32),
                             stepf)).to(dev)
        b2t = (1 - torch.pow(torch.tensor(b2, dtype=torch.float32),
                             stepf)).to(dev)

        def upd(g, m, v, master):
            g = g.float()
            m_new = b1 * m.float() + (1 - b1) * g
            v_new = b2 * v.float() + (1 - b2) * g * g
            mh = m_new / b1t
            vh = v_new / b2t
            new_master = master - lr * (mh / (torch.sqrt(vh) + eps)
                                        + weight_decay * master)
            return (new_master, m_new.to(moment_dtype),
                    v_new.to(moment_dtype))

        out = tree.map(upd, grads, state["m"], state["v"], state["master"])
        outs = tree.leaves(out)      # tuples are flattened: (master, m, v)
        masters, ms, vs = outs[0::3], outs[1::3], outs[2::3]
        new_master = tree.unflatten(params, masters)
        new_params = tree.map(lambda mw, p: mw.to(p.dtype), new_master,
                              params)
        new_state = {"step": step, "master": new_master,
                     "m": tree.unflatten(params, ms),
                     "v": tree.unflatten(params, vs)}
        stats["lr"] = lr
        return new_params, new_state, stats

    return Optimizer(init=init, update=update)


def sgd(lr_fn: Callable, momentum: float = 0.9,
        max_grad_norm: Optional[float] = None,
        lane_dims: int = 0) -> Optimizer:
    def init(params):
        return {"step": torch.zeros((), dtype=torch.int32),
                "mom": tree.map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device), params)}

    def update(grads, state, params):
        step = state["step"] + 1
        stats = {}
        if max_grad_norm is not None:
            grads, gn = clip_by_global_norm(grads, max_grad_norm, lane_dims)
            stats["grad_norm"] = gn
        lr = lr_fn(step.to(torch.float32)).to(tree.leaves(params)[0].device)
        new_mom = tree.map(lambda g, mo: momentum * mo + g.float(), grads,
                           state["mom"])
        new_params = tree.map(
            lambda p, mo: (p.float() - lr * mo).to(p.dtype), params, new_mom)
        stats["lr"] = lr
        return new_params, {"step": step, "mom": new_mom}, stats

    return Optimizer(init=init, update=update)
