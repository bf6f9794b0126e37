"""Training loop with checkpoint/restart, straggler mitigation and logging
(the JAX package's ``train/trainer.py``).

Fault-tolerance model:
  * auto-resume: on start, the newest COMMITted checkpoint (if any) is
    restored, so a preempted job relaunches with the same command line and
    continues bit for bit as an uninterrupted run would have;
  * index-derived data: batches are pure functions of (seed, step), so a
    resume replays the exact stream with no data-loader state;
  * straggler mitigation: a per-step data deadline (a host that misses it
    substitutes the previous step's batch, logged in
    ``substituted_steps``), and a step-time watchdog on the injectable
    ``clock`` that flags slow steps and, with ``ckpt_on_stall``, saves the
    full carry at once.

Under a mesh (``repro_torch.parallel.sharding.use_mesh``) the values are
this rank's blocks and ``shardings`` names their placement, as the JAX
package's target shardings do: a tree of ``NamedSharding`` of the values'
structure, which the optimizer state's trees of that structure take too,
or a ``sharding.Placement`` (``sharding.placement``, the dry-run's
placements), whose state shardings split AdamW's master weights and
moments over the fsdp axis (ZeRO) and whose value shardings may split the
values over it too (FSDP).  Every other leaf of the carry stays whole.
The step runs under ``sharding.use_leaf_shardings(values, state=)``: the
global norm adds the split leaves' squares over the model group, and
AdamW updates this rank's ZeRO block of its state.  The checkpoints hold
whole leaves (every rank gathers, rank 0 writes; with a ``Placement`` the
index names each leaf's logical axes, the state's ZeRO axes under its
own key), so a resume keeps this rank's blocks of them, from any mesh to
any mesh, split state or not.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch import tree
from repro_torch.checkpoint import checkpointer
from repro_torch.optim import grad_compression, optimizers
from repro_torch.optim.compressed_allreduce import CompressedAllReduce
from repro_torch.parallel import sharding
from repro_torch.train.train_step import make_train_step


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    microbatches: int = 1
    # kept-fraction float (sugar for CompressedAllReduce.topk) or a full
    # CompressedAllReduce policy; compressed steps log dp_payload_bits
    compress_k: Optional[Union[float, CompressedAllReduce]] = None
    data_deadline_s: Optional[float] = None     # straggler: batch deadline
    watchdog_factor: float = 3.0                # step-time anomaly threshold
    resume: bool = True
    # stochastic forward (the channel in the loop): loss_fn takes a third
    # rng argument and step s gets fold_in(PRNGKey(seed), s), so a resume
    # replays the exact noise stream
    channel_rng_seed: Optional[int] = None
    # auxiliary carried state (a repro_torch.faults.FaultState, say): the
    # rng argument becomes ``(key, aux)`` and loss_fn's metrics return the
    # evolved carry under ``metrics["aux_state"]``; it is checkpointed with
    # the parameters.  Needs channel_rng_seed and microbatches == 1.
    aux_state: Optional[Any] = None
    # save the full carry as soon as the watchdog flags a stall
    ckpt_on_stall: bool = False
    # the watchdog's clock, injectable so a test drives it (the loop reads
    # the time through it only)
    clock: Callable[[], float] = time.monotonic


@dataclasses.dataclass
class TrainResult:
    values: Any
    opt_state: Any
    history: List[Dict[str, float]]
    substituted_steps: List[int]
    straggler_flags: List[int]
    final_step: int
    aux_state: Any = None        # evolved TrainerConfig.aux_state carry


def _copy(t):
    """A copy of every tensor of ``t`` (dicts, lists, tuples, dataclasses),
    so the run never aliases the caller's tensors."""
    if isinstance(t, dict):
        return {k: _copy(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_copy(x) for x in t)
    if dataclasses.is_dataclass(t) and not isinstance(t, type):
        return dataclasses.replace(t, **{
            f.name: _copy(getattr(t, f.name)) for f in dataclasses.fields(t)})
    return t.clone() if isinstance(t, torch.Tensor) else t


def _history_row(metrics: Dict[str, Any]) -> Dict[str, float]:
    """The 0-d metrics as floats, read from the device in one copy (as
    float64, which holds every int32 and float32 exactly)."""
    scalars = {k: v for k, v in metrics.items()
               if isinstance(v, torch.Tensor) and v.ndim == 0}
    row = {k: float(v) for k, v in metrics.items()
           if not isinstance(v, torch.Tensor) and np.ndim(v) == 0}
    if scalars:
        dev = next(iter(scalars.values())).device
        vals = torch.stack([v.detach().to(dev, torch.float64)
                            for v in scalars.values()]).cpu().tolist()
        row.update(zip(scalars, vals))
    return row


def _paths(t) -> list:
    return list(checkpointer._flatten_with_paths(t))


# the optimizer state's subtrees that ZeRO splits (AdamW's)
ZERO_STATE = ("master", "m", "v")


def _placement(shardings) -> sharding.Placement:
    """``train``'s ``shardings`` as a placement: a tree of the values'
    shardings places the optimizer state as the values (no ZeRO)."""
    if isinstance(shardings, sharding.Placement):
        return shardings
    return sharding.Placement(None, shardings, None, shardings)


def _carry_tree(carry, values, state, other):
    """A tree of the carry's structure: ``values`` for the values and for
    every subtree of the values' structure (the error-feedback memory,
    SGD's momentum), ``state`` for AdamW's master weights and moments,
    ``other(leaf)`` for every other leaf."""
    shape = _paths(carry["values"])

    def like(sub, key=None):
        if isinstance(sub, dict) and _paths(sub) == shape:
            return state if key in ZERO_STATE else values
        if isinstance(sub, dict):
            return {k: like(v, k) for k, v in sub.items()}
        if isinstance(sub, (list, tuple)):
            return type(sub)(like(x) for x in sub)
        return other(sub)
    return {k: like(v) if k != "values" else values
            for k, v in carry.items()}


def carry_shardings(shardings, carry):
    """The whole ``carry``'s shardings from ``train``'s ``shardings``: the
    values' for ``values`` and every other subtree of the values'
    structure, the state shardings (ZeRO's under a ``Placement``) for the
    optimizer's master weights and moments, every other leaf whole."""
    pl = _placement(shardings)
    mesh = sharding.flat_shardings(pl.shardings)[0].mesh
    return _carry_tree(carry, pl.shardings, pl.state_shardings,
                       lambda t: sharding.replicated(mesh, t.ndim)
                       if isinstance(t, torch.Tensor) else None)


def carry_axes(placement: sharding.Placement, carry):
    """The logical axes of the carry's leaves that a placement names (the
    values', the state's ZeRO axes), for the checkpoint's index."""
    return _carry_tree(carry, placement.axes, placement.state_axes,
                       lambda t: None)


def train(loss_fn: Callable, init_values, optimizer, data_fn: Callable,
          tcfg: TrainerConfig, shardings=None,
          delay_injector: Optional[Callable[[int], float]] = None
          ) -> TrainResult:
    """``data_fn(step)`` -> the batch; ``delay_injector(step)`` -> the
    simulated data latency of a slow host, in seconds; ``shardings`` the
    placement of the values under a mesh (module doc): a tree of their
    ``NamedSharding``, or a ``sharding.Placement`` with the state's."""
    if shardings is None:
        return _train(loss_fn, init_values, optimizer, data_fn, tcfg, None,
                      delay_injector)
    pl = _placement(shardings)
    with sharding.use_leaf_shardings(
            sharding.flat_shardings(pl.shardings),
            state=sharding.flat_shardings(pl.state_shardings)):
        return _train(loss_fn, init_values, optimizer, data_fn, tcfg,
                      shardings, delay_injector)


def _zero_init(optimizer, values):
    """The optimizer's state of ``values`` with AdamW's master weights and
    moments this rank's ZeRO blocks (``optimizers.zero_blocks``; the
    state itself where nothing is split)."""
    blocks = optimizers.zero_blocks(values)
    if blocks is values:
        return optimizer.init(values)
    state = optimizer.init(blocks)
    if not all(k in state for k in ZERO_STATE):
        raise NotImplementedError(
            "ZeRO splits AdamW's master weights and moments; this "
            "optimizer's state has none")
    return state


def _train(loss_fn, init_values, optimizer, data_fn, tcfg, shardings,
           delay_injector) -> TrainResult:
    values = _copy(init_values)
    opt_state = _zero_init(optimizer, values)
    # the error-feedback memory only where a compressed step carries it
    # (float32, twice a bf16 model's parameters)
    err = (grad_compression.init_error(values)
           if tcfg.compress_k is not None else None)
    aux = _copy(tcfg.aux_state) if tcfg.aux_state is not None else None
    if aux is not None:
        if tcfg.channel_rng_seed is None:
            raise ValueError("aux_state rides the per-step rng argument; "
                             "set channel_rng_seed")
        if tcfg.microbatches != 1:
            raise ValueError(
                "aux_state requires microbatches == 1: the microbatch "
                "rng-folding treats integer leaves as PRNG keys and would "
                "corrupt the carry's int32/bool leaves")
    start_step = 0

    def carry_state():
        """The full training carry: parameters, optimizer state, the
        error-feedback memory (compressed steps) and the auxiliary
        carry."""
        state = {"values": values, "opt": opt_state}
        if tcfg.compress_k is not None:
            state["err"] = err
        if aux is not None:
            state["aux"] = aux
        return state

    shd = (None if shardings is None
           else carry_shardings(shardings, carry_state()))
    axes = (carry_axes(shardings, carry_state())
            if isinstance(shardings, sharding.Placement) else None)

    saved = None            # the step of the newest checkpoint written

    def save(step):
        nonlocal saved
        checkpointer.save(tcfg.ckpt_dir, step, carry_state(), axes_tree=axes,
                          shardings=shd)
        saved = step

    if tcfg.ckpt_dir and tcfg.resume:
        step = checkpointer.latest_step(tcfg.ckpt_dir)
        if step is not None:
            restored, step, _ = checkpointer.restore(
                tcfg.ckpt_dir, step, template=carry_state(), shardings=shd)
            values, opt_state = restored["values"], restored["opt"]
            err = restored.get("err", err)
            aux = restored.get("aux", aux)
            start_step = step

    with_rng = tcfg.channel_rng_seed is not None
    # the step updates its carries in place: ``values`` is already a copy
    # of the caller's init
    step_fn = make_train_step(
        loss_fn, optimizer, microbatches=tcfg.microbatches,
        compress_k=tcfg.compress_k, with_rng=with_rng)
    base_rng = (jr.PRNGKey(tcfg.channel_rng_seed,
                           tree.leaves(values)[0].device)
                if with_rng else None)

    history: List[Dict[str, float]] = []
    substituted: List[int] = []
    flagged: List[int] = []
    durations: List[float] = []

    for step in range(start_step, tcfg.steps):
        t0 = tcfg.clock()
        if delay_injector is not None and tcfg.data_deadline_s is not None:
            delay = delay_injector(step)
            if delay > tcfg.data_deadline_s:
                # deadline missed: substitute the previous step's batch
                batch = data_fn(max(step - 1, 0))
                substituted.append(step)
            else:
                batch = data_fn(step)
        else:
            batch = data_fn(step)
        args = (values, opt_state, batch)
        if with_rng:
            key = jr.fold_in(base_rng, step)
            args += ((key, aux) if aux is not None else key,)
        if tcfg.compress_k is not None:
            values, opt_state, err, metrics = step_fn(*args, err)
        else:
            values, opt_state, metrics = step_fn(*args)
        if aux is not None:
            metrics = dict(metrics)
            aux = metrics.pop("aux_state")
        dt = tcfg.clock() - t0
        if durations and dt > tcfg.watchdog_factor * float(
                np.median(durations)):
            flagged.append(step)
            if tcfg.ckpt_on_stall and tcfg.ckpt_dir:
                # persist the full carry now, so a relaunch resumes from
                # right before the stall
                save(step + 1)
        durations.append(dt)
        if step % tcfg.log_every == 0 or step == tcfg.steps - 1:
            row = _history_row(metrics)
            row["step"] = step
            row["step_time_s"] = dt
            history.append(row)
        if (tcfg.ckpt_dir and tcfg.ckpt_every
                and (step + 1) % tcfg.ckpt_every == 0):
            save(step + 1)

    # the final carry, unless the last step's checkpoint already holds it
    if tcfg.ckpt_dir and saved != tcfg.steps:
        save(tcfg.steps)
    return TrainResult(values=values, opt_state=opt_state, history=history,
                       substituted_steps=substituted, straggler_flags=flagged,
                       final_step=tcfg.steps, aux_state=aux)
