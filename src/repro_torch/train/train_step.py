"""Train-step construction: loss + grad (+ microbatch accumulation) +
optimizer update, on parameter trees.

``loss_fn(values, batch) -> (loss, metrics)``; with ``with_rng`` the
forward is stochastic (the channel in the loop) and the contract is
``loss_fn(values, batch, rng)``.  ``loss`` may carry lane axes (one loss
per p_miss lane): the step differentiates their sum, which gives every
lane its own gradient, and reports ``metrics["loss_mean"]`` per lane.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch import random as jr
from repro_torch import tree


def _fold_keys(rng, i: int):
    """Fold ``i`` into every key (integer tensor) of the ``rng`` container;
    everything else (a Protocol, float tensors) passes through."""
    if isinstance(rng, torch.Tensor):
        if rng.dtype.is_floating_point or rng.dtype == torch.bool:
            return rng
        return jr.fold_in(rng, i)
    if isinstance(rng, (list, tuple)):
        return type(rng)(_fold_keys(r, i) for r in rng)
    return rng


def make_train_step(loss_fn: Callable, optimizer, microbatches: int = 1,
                    with_rng: bool = False) -> Callable:
    """Returns ``train_step(values, opt_state, batch[, rng]) -> (values,
    opt_state, metrics)``.

    With ``microbatches > 1`` the leading axis of every batch leaf is split
    into that many microbatches whose gradients are averaged; each
    microbatch's ``rng`` has the microbatch index folded into its keys.
    """

    def grad_fn(values, batch, rng):
        leaves = [x.detach().requires_grad_(True)
                  for x in tree.leaves(values)]
        live = tree.unflatten(values, leaves)
        with torch.enable_grad():
            loss, metrics = (loss_fn(live, batch, rng) if with_rng
                             else loss_fn(live, batch))
            grads = torch.autograd.grad(loss.sum(), leaves,
                                        allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        # a carried state (the fault path's FaultState) passes through
        metrics = {k: v.detach() if isinstance(v, torch.Tensor)
                   else v.map(torch.Tensor.detach)
                   for k, v in metrics.items()}
        return loss.detach(), metrics, tree.unflatten(values, grads)

    def compute_grads(values, batch, rng):
        if microbatches == 1:
            loss, metrics, grads = grad_fn(values, batch, rng)
            return grads, loss, metrics

        def split(x):
            b = x.shape[0]
            if b % microbatches:
                raise ValueError(f"batch axis {b} does not split into "
                                 f"{microbatches} microbatches")
            return x.reshape((microbatches, b // microbatches) + x.shape[1:])

        micro = tree.map(split, batch)
        acc = tree.map(lambda v: torch.zeros(v.shape, dtype=torch.float32,
                                             device=v.device), values)
        loss_sum = None
        for i in range(microbatches):
            mb = tree.map(lambda x, i=i: x[i], micro)
            r = _fold_keys(rng, i) if with_rng else rng
            loss, metrics, grads = grad_fn(values, mb, r)
            acc = tree.map(torch.add, acc, grads)
            loss_sum = loss if loss_sum is None else loss_sum + loss
        grads = tree.map(lambda g: g / microbatches, acc)
        return grads, loss_sum / microbatches, metrics

    def train_step(values, opt_state, batch, rng=None):
        grads, loss, metrics = compute_grads(values, batch, rng)
        values, opt_state, stats = optimizer.update(grads, opt_state, values)
        metrics = dict(metrics)
        metrics.update(stats)
        metrics["loss_mean"] = loss
        return values, opt_state, metrics

    return train_step
