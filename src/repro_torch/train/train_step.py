"""Train-step construction: loss + grad (+ microbatch accumulation) +
optimizer update, on parameter trees.

``loss_fn(values, batch) -> (loss, metrics)``; with ``with_rng`` the
forward is stochastic (the channel in the loop) and the contract is
``loss_fn(values, batch, rng)``.  ``loss`` may carry lane axes (one loss
per p_miss lane): the step differentiates their sum, which gives every
lane its own gradient, and reports ``metrics["loss_mean"]`` per lane.

Under a mesh whose data axis splits the batch (the model's entry points
split it where the axis divides its rows), each rank differentiates its
rows' share of the loss and the gradients are summed over the data group,
as GSPMD reduces the JAX package's: one sum a dtype, each element's ranks
added in rank order (``comm.sum_ordered``), so that a leaf's sum is the
same bits whole or in FSDP's blocks.  An FSDP leaf (split over the fsdp
axis by the named leaf shardings) comes out of the backward as this
rank's block of its data-summed gradient (``comm.gather_block``); the
optimizer updates the blocks that ZeRO and FSDP give a rank
(``optim/optimizers.py``).
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from repro_torch import random as jr
from repro_torch import tree
from repro_torch.optim.compressed_allreduce import CompressedAllReduce
from repro_torch.parallel import comm
from repro_torch.parallel import sharding


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


def value_and_grad(loss_fn: Callable, values, batch, rng=None,
                   with_rng: bool = False):
    """``(loss, metrics, grads)`` of ``loss_fn(values, batch[, rng])``,
    the gradient of ``loss.sum()`` (a leaf it does not reach gets zeros),
    summed over the data group where the mesh's data axis splits the
    batch's rows."""
    leaves = [x.detach().requires_grad_(True) for x in tree.leaves(values)]
    live = tree.unflatten(values, leaves)
    with torch.enable_grad():
        loss, metrics = (loss_fn(live, batch, rng) if with_rng
                         else loss_fn(live, batch))
        grads = torch.autograd.grad(loss.sum(), leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    rows = (None if sharding.active_mesh() is None
            else sharding.batch_split(tree.leaves(batch)[0].shape[0]))
    if rows is not None:
        # an FSDP leaf's gradient comes summed (comm.gather_block)
        shd = sharding.leaf_shardings()
        at = [i for i in range(len(grads)) if shd is None
              or sharding.fsdp_dim(shd[i].spec) is None]
        for i, g in zip(at, sum_over([grads[i] for i in at], rows.group)):
            grads[i] = g
    # a carried state (the fault path's FaultState) passes through
    metrics = {k: v.detach() if isinstance(v, torch.Tensor)
               else v.map(torch.Tensor.detach)
               for k, v in metrics.items()}
    return loss.detach(), metrics, tree.unflatten(values, grads)


def sum_over(tensors, group) -> list:
    """Each tensor summed over ``group``: one rank-ordered sum
    (``comm.sum_ordered``) for each dtype, of the tensors of that dtype
    flattened into one buffer."""
    out = list(tensors)
    for dt in dict.fromkeys(t.dtype for t in tensors):
        at = [i for i, t in enumerate(tensors) if t.dtype == dt]
        flat = comm.sum_ordered(torch.cat([tensors[i].reshape(-1)
                                           for i in at]), group)
        for i, part in zip(at, flat.split([tensors[i].numel()
                                           for i in at])):
            out[i] = part.view(tensors[i].shape)
    return out


def make_train_step(loss_fn: Callable, optimizer, microbatches: int = 1,
                    compress_k: Optional[Union[float,
                                               CompressedAllReduce]] = None,
                    with_rng: bool = False) -> Callable:
    """Returns ``train_step(values, opt_state, batch[, rng]) -> (values,
    opt_state, metrics)``, or with ``compress_k`` ``train_step(values,
    opt_state, batch[, rng], err) -> (values, opt_state, err, metrics)``.

    With ``microbatches > 1`` the leading axis of every batch leaf is split
    into that many microbatches whose gradients are averaged; each
    microbatch's ``rng`` has the microbatch index folded into its keys.

    The carries are donated, as the JAX trainer donates them to its
    jitted step: the step writes the new parameters and optimizer state
    into the ``values`` and ``opt_state`` passed in
    (``optimizer.update_inplace``) and returns them, without a second copy
    of the state.  The caller rebinds them from the outputs and copies
    what must survive the call.
    """

    def grad_fn(values, batch, rng):
        return value_and_grad(loss_fn, values, batch, rng, with_rng)

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

    def apply_update(values, opt_state, grads, loss, metrics):
        values, opt_state, stats = optimizer.update_inplace(grads, opt_state,
                                                           values)
        metrics = dict(metrics)
        metrics.update(stats)
        metrics["loss_mean"] = loss
        return values, opt_state, metrics

    if compress_k is None:
        def train_step(values, opt_state, batch, rng=None):
            grads, loss, metrics = compute_grads(values, batch, rng)
            return apply_update(values, opt_state, grads, loss, metrics)
        return train_step

    compress = (compress_k if isinstance(compress_k, CompressedAllReduce)
                else CompressedAllReduce.topk(float(compress_k)))

    def compressed_step(values, opt_state, batch, rng, err):
        grads, loss, metrics = compute_grads(values, batch, rng)
        grads, err, acct = compress.reduce(grads, err)
        metrics = dict(metrics)
        metrics["dp_payload_bits"] = acct.payload_bits
        metrics["dp_kept_elems"] = acct.kept_elems
        values, opt_state, metrics = apply_update(values, opt_state, grads,
                                                  loss, metrics)
        return values, opt_state, err, metrics

    if with_rng:
        return compressed_step

    def train_step_err(values, opt_state, batch, err):
        return compressed_step(values, opt_state, batch, None, err)
    return train_step_err
