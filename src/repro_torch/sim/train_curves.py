"""Channel-in-the-loop training curves: accuracy vs channel quality.

The paper's end-to-end experiment.  The vertical learner's forward pass
fuses the embeddings through the simulated OCS channel
(``Protocol.ocs``: quantized D-bit contention, per-sub-slot miss detection,
lowest-index capture), and short training runs sweep the ``p_miss x bits``
grid into accuracy-vs-p_miss and accuracy-vs-bits tables
(``repro_torch.sim.results``).

For each ``bits`` value the p_miss lanes train as one stack with a leading
lane axis, and the ideal reference run — ``Protocol.ideal_max(bits,
tie_break="first")`` pooling — rides along as one more lane of the same
stack: identical initial parameters, one batch stream, and the same
batched kernels for every lane, so a ``p_miss=0`` lane trains bit for bit
as the ideal run does.  Every stochastic input derives from the JAX
package's key formulas (``repro_torch.random`` is threefry bit for bit):
the batch of step ``s`` is ``randint(fold_in(k_data, s))`` and lane ``l``'s
sensing key is ``fold_in(lane_keys[l], s)`` (``s == steps`` for the
evaluation), so a run here draws the same batches and the same sensing
bits as ``repro.sim.train_curves.run_curves``.

``run_curves`` and ``run_curves_dp`` take ``n_devices``, a placement over
``torch.distributed`` ranks (``repro_torch.sim.shard``): each rank trains
its block of lanes (the ideal lane riding along in every block) and every
rank gets the whole result, bitwise the one-rank result.

No result is read back to the host inside the step loop: logged losses
collect in a device buffer that is read once per ``bits`` value.

Two variants run the same lane stack.  :func:`run_scheduled_curves`
picks each step's depth with a ``BitsSchedule`` from the previous step's
channel telemetry; the kernels take ``bits`` as a host ``int``, so the
chosen index is read back once per step (4 bytes).
:func:`run_fault_curves` trains one ``repro_torch.faults.FaultModel`` per
lane, the Markov chains and the stale caches carried across steps on the
device.  Both keep the ideal lane riding along in the stack (at the
step's depth) and drop it from the result, so that ``FixedBits(b)`` and a
grid of ``FaultModel.iid(p)`` lanes train the noisy lanes of
``run_curves(bits=(b,))`` bit for bit.

:func:`run_curves_dp` adds data-parallel ranks: the (lane, rank) pairs run
as one noisy stack, each rank's gradients are top-k sparsified with error
feedback and summed over the ranks by
``repro_torch.optim.compressed_allreduce.CompressedAllReduce``, and the DP
payload bits are measured from the kept counts every step.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import faults
from repro_torch import random as jr
from repro_torch import tree
from repro_torch.core import vertical
from repro_torch.core.vertical import VerticalConfig
from repro_torch.data.vertical_data import (PatchTaskConfig,
                                            patch_classification)
from repro_torch.optim import optimizers, schedules
from repro_torch.optim.compressed_allreduce import CompressedAllReduce
from repro_torch.parallel import comm
from repro_torch.protocol import BitsSchedule, Protocol
from repro_torch.protocol.protocol import mean_f32
from repro_torch.sim import shard
from repro_torch.train.train_step import make_train_step


@dataclasses.dataclass(frozen=True)
class CurveConfig:
    """One accuracy-vs-channel-quality experiment grid.

    ``p_miss`` lanes are scalars or length-``n_workers`` sequences
    (heterogeneous near/far users); lanes may mix both.  ``backend`` is the
    static ``Protocol.backend`` of every lane's protocol (``"scan"`` and
    ``"pallas"`` give the same bits; on the card both run the kernel).
    """

    bits: Sequence[int] = (8, 16)        # backoff/payload depth axis
    p_miss: Sequence = (0.0, 0.02, 0.05, 0.1)          # lane axis
    steps: int = 60
    batch: int = 64
    lr: float = 3e-3
    max_rounds: int = 3                  # noisy re-contention bound
    n_train: int = 2048
    n_val: int = 512
    n_classes: int = 4
    grid: int = 2                        # grid^2 workers (paper §IV-B)
    hw: int = 16                         # image side (patch_dim = (hw/grid)^2)
    sigma: float = 0.5
    encoder_dims: Sequence[int] = (32,)
    embed_dim: int = 16                  # K — transmitted feature width
    head_dims: Sequence[int] = (32,)
    seed: int = 0
    log_every: int = 10
    backend: str = "scan"                # noisy-contention engine name
    dp_shards: int = 1                   # data-parallel batch shards
    #   (run_curves_dp: each rank trains batch/dp_shards samples and the
    #   compressed gradients are summed over the ranks every step)

    def __post_init__(self):
        if self.dp_shards < 1:
            raise ValueError(f"dp_shards must be >= 1, got {self.dp_shards}")
        if self.batch % self.dp_shards:
            raise ValueError(
                f"batch={self.batch} must divide evenly into "
                f"dp_shards={self.dp_shards} ranks")
        for b in self.bits:
            if b not in (8, 16):
                raise ValueError(
                    f"bits={b}: the ideal reference run needs a "
                    "Protocol.ideal_max(bits) aggregation (8 or 16)")
        if not self.p_miss:
            raise ValueError("p_miss needs at least one lane")
        for p in self.p_miss:
            arr = np.asarray(p, np.float64)
            if arr.ndim not in (0, 1):
                raise ValueError(f"p_miss lane must be scalar or "
                                 f"per-worker, got shape {arr.shape}")
            if arr.ndim == 1 and arr.shape[0] != self.n_workers:
                raise ValueError(
                    f"per-worker p_miss lane needs {self.n_workers} "
                    f"entries, got {arr.shape[0]}")
            if not np.all((0.0 <= arr) & (arr < 1.0)):
                raise ValueError(
                    f"p_miss lanes must be in [0, 1): {self.p_miss}")

    @property
    def n_workers(self) -> int:
        return self.grid * self.grid

    def protocol(self, bits: int) -> Protocol:
        """The (p_miss-unbound) OCS protocol of one ``bits`` cell."""
        return Protocol.ocs(bits=bits, max_rounds=self.max_rounds,
                            backend=self.backend)

    def lane_p_miss(self, dtype=np.float32) -> np.ndarray:
        """Lane axis as an array: (L,) if all lanes are scalar, else the
        per-worker broadcast (L, n_workers)."""
        if all(np.ndim(p) == 0 for p in self.p_miss):
            return np.asarray(self.p_miss, dtype)
        return np.stack([
            np.broadcast_to(np.asarray(p, dtype), (self.n_workers,))
            for p in self.p_miss])

    def logged_steps(self) -> List[int]:
        """Steps whose train loss lands in ``CurveResult.loss_history``."""
        return sorted(set(range(0, self.steps, self.log_every))
                      | {self.steps - 1})


@dataclasses.dataclass
class CurveResult:
    """Stacked outcome of one curve grid (lane axis L == len(p_miss); bits
    axis in ``config.bits`` order; ``*_ideal`` from the ideal run).
    Parameters come back on the CPU, lane-stacked per bits value."""

    config: CurveConfig
    p_miss: np.ndarray                  # (L,) or (L, N) float32 lanes
    acc: np.ndarray                     # (n_bits, L) channel-in-the-loop
    nll: np.ndarray                     # (n_bits, L)
    acc_ideal: np.ndarray               # (n_bits,)
    nll_ideal: np.ndarray               # (n_bits,)
    loss_history: np.ndarray            # (n_bits, n_logged, L)
    ideal_loss_history: np.ndarray      # (n_bits, n_logged)
    logged_steps: np.ndarray            # (n_logged,)
    noisy_params: List                  # per-bits lane-stacked params
    ideal_params: List                  # per-bits params, lane axis of 1
    device: str = "cpu"                 # where the run ran


@dataclasses.dataclass
class ScheduledCurveResult:
    """Outcome of one ``BitsSchedule``-driven curve run.

    ``bits_per_step`` is the depth every step trained with
    (``bits_per_step[0]`` is ``schedule.candidates[schedule.init_index]``);
    ``collision_frac`` the noisy lanes' mean collision fraction at the
    logged steps, the telemetry the policy consumed.  The evaluation runs
    at the depth of the last step."""

    config: CurveConfig
    schedule: BitsSchedule
    p_miss: np.ndarray                  # (L,) or (L, N)
    acc: np.ndarray                     # (L,) channel-in-the-loop eval
    nll: np.ndarray                     # (L,)
    loss_history: np.ndarray            # (n_logged, L)
    collision_frac: np.ndarray          # (n_logged,)
    bits_per_step: np.ndarray           # (steps,) chosen depth per step
    logged_steps: np.ndarray            # (n_logged,)
    params: dict                        # lane-stacked trained params (CPU)
    device: str = "cpu"


@dataclasses.dataclass
class FaultCurveResult:
    """Outcome of one fault-injection curve grid (``run_fault_curves``).

    The lane axis L indexes ``fault_lanes``, one ``FaultModel`` per lane,
    all with one ``DegradePolicy``.  ``stale_age`` is the staleness (frames
    since the last resolved frame) at the logged steps; the
    ``*_frames``/``retry_slots`` arrays are whole-run totals."""

    config: CurveConfig
    fault_lanes: Sequence               # the FaultModel lanes, as given
    acc: np.ndarray                     # (n_bits, L) channel-in-the-loop
    nll: np.ndarray                     # (n_bits, L)
    loss_history: np.ndarray            # (n_bits, n_logged, L)
    stale_age: np.ndarray               # (n_bits, n_logged, L) int64
    dropped_frames: np.ndarray          # (n_bits, L) int64 run totals
    outage_frames: np.ndarray           # (n_bits, L) int64 run totals
    retry_slots: np.ndarray             # (n_bits, L) int64 run totals
    logged_steps: np.ndarray            # (n_logged,)
    params: List                        # per-bits lane-stacked params (CPU)
    device: str = "cpu"


@dataclasses.dataclass
class DPCurveResult:
    """Outcome of one (p_miss lanes x DP ranks) compressed-comms run
    (``run_curves_dp``).

    ``dp_payload_bits`` is measured every step from the kept-element
    counts of every rank's exact-k masks (``CompressedAllReduce.reduce``'s
    ``DPAccounting``, totalled over ranks); ``dp_payload_bits_step`` /
    ``dp_dense_bits_step`` are the analytic per-step totals over ranks
    that the measurement must equal."""

    config: CurveConfig
    compress: CompressedAllReduce
    p_miss: np.ndarray                  # (L,) or (L, N) per-worker lanes
    acc: np.ndarray                     # (n_bits, L) channel-in-the-loop
    nll: np.ndarray                     # (n_bits, L)
    loss_history: np.ndarray            # (n_bits, n_logged, L) rank mean
    dp_payload_bits: np.ndarray         # (n_bits, n_logged, L) measured
    dp_payload_bits_total: np.ndarray   # (n_bits, L) int64, whole run
    dp_payload_bits_step: int           # analytic bits a step, all ranks
    dp_dense_bits_step: int             # uncompressed bits a step, all ranks
    logged_steps: np.ndarray            # (n_logged,)
    params: List                        # per-bits lane-stacked params (CPU)
    device: str = "cpu"


# ---------------------------------------------------------------------------
# key and data streams (the JAX package's formulas)
# ---------------------------------------------------------------------------

def _stream_keys(ccfg: CurveConfig, bits: int, device=None):
    """Root keys of the batch stream and of the lanes' sensing streams."""
    return _fault_stream_keys(ccfg, bits, len(ccfg.p_miss), device)


def _fault_stream_keys(ccfg: CurveConfig, bits: int, lanes: int,
                       device=None):
    """:func:`_stream_keys` with the lane count given: with ``lanes ==
    len(ccfg.p_miss)`` the streams are the same, which is what makes a
    ``FaultModel.iid(p)`` lane train the ``run_curves`` lane of ``p``."""
    base = jr.PRNGKey(ccfg.seed + 7919 * bits, device=device)
    k_data, k_noise = jr.split(base)
    return k_data, jr.split(k_noise, lanes)


def _batch_indices(k_data, step: int, batch: int, n_train: int):
    """Minibatch draw: a pure function of (k_data, step)."""
    return jr.randint(jr.fold_in(k_data, step), (batch,), 0, n_train)


def _fold_lanes(lane_keys, step: int):
    """Per-lane sensing keys for one step: fold the step into every lane."""
    return jr.fold_in(lane_keys, step)


def _make_data(ccfg: CurveConfig, device):
    task = PatchTaskConfig(n_classes=ccfg.n_classes, grid=ccfg.grid,
                           hw=ccfg.hw, sigma=ccfg.sigma)
    views, labels = patch_classification(task, ccfg.n_train, seed=ccfg.seed)
    v_views, v_labels = patch_classification(task, ccfg.n_val,
                                             seed=ccfg.seed + 1)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (views, labels, v_views, v_labels))


def _vertical_config(ccfg: CurveConfig, bits: int) -> VerticalConfig:
    return VerticalConfig(
        n_workers=ccfg.n_workers, input_dim=(ccfg.hw // ccfg.grid) ** 2,
        encoder_dims=tuple(ccfg.encoder_dims), embed_dim=ccfg.embed_dim,
        head_dims=tuple(ccfg.head_dims), output_dim=ccfg.n_classes,
        task="classification", aggregation=ccfg.protocol(bits))


def _make_steps(ccfg: CurveConfig, bits: int):
    """The lane-stack loss, optimizer and train step of one ``bits`` cell.

    Lanes ``0..L-1`` pool through the noisy channel (channel state ``chan =
    (keys (L, 2), p_miss (L,) or (L, N))``); lane ``L`` pools through the
    ideal ``Protocol.ideal_max(bits, tie_break="first")`` — the OCS winner
    is the lowest-indexed max-code holder, so the ideal reference routes
    gradients the same way.  ``Protocol.aggregate_with_ideal`` pools both
    into one stack, with one winner-routed backward launch.
    """
    vcfg = _vertical_config(ccfg, bits)
    noisy = ccfg.protocol(bits)

    def stack_loss(values, batch, chan):
        views, labels = batch
        keys, p = chan
        h = vertical.embeddings(vcfg, values, views)          # (L+1, N, B, K)
        # the noisy lanes and the ideal lane in one pooled stack
        v, acct = noisy.with_p_miss(p).aggregate_with_ideal(h, keys)
        pred = vertical.head(vcfg, values, v)
        loss, metrics = vertical.task_loss(vcfg, pred, labels)
        metrics.update(vertical.channel_metrics(vcfg, noisy, acct,
                                                views.shape[1]))
        return loss, metrics

    opt = _optimizer(ccfg)
    return vcfg, stack_loss, opt, make_train_step(stack_loss, opt,
                                                  with_rng=True)


def _optimizer(ccfg: CurveConfig):
    warmup = max(1, ccfg.steps // 10)
    return optimizers.adamw(
        schedules.linear_warmup_cosine(ccfg.lr, warmup, ccfg.steps),
        weight_decay=0.01, lane_dims=1)


def _make_fault_steps(ccfg: CurveConfig, bits: int):
    """:func:`_make_steps` with the fault-aware pool: channel state ``chan
    = (keys (L, 2), lane-stacked FaultModel, lane-stacked FaultState)``;
    the evolved state comes back as ``metrics["fault_state"]``."""
    vcfg = _vertical_config(ccfg, bits)
    noisy = ccfg.protocol(bits)

    def fault_loss(values, batch, chan):
        views, labels = batch
        keys, fm, fs = chan
        h = vertical.embeddings(vcfg, values, views)          # (L+1, N, B, K)
        v, new_fs, acct = faults.aggregate_with_ideal(noisy, fm, fs, h, keys)
        pred = vertical.head(vcfg, values, v)
        loss, metrics = vertical.task_loss(vcfg, pred, labels)
        metrics.update(vertical.channel_metrics(vcfg, noisy, acct,
                                                views.shape[1]))
        metrics.update(vertical.fault_metrics(acct))
        metrics["fault_state"] = new_fs
        return loss, metrics

    opt = _optimizer(ccfg)
    return vcfg, fault_loss, opt, make_train_step(fault_loss, opt,
                                                  with_rng=True)


def _initial_params(ccfg: CurveConfig, vcfg, init_params, dev):
    """``init_params`` on ``dev``, or ``vertical.init`` from ``ccfg.seed``."""
    return (vertical.init(vcfg, ccfg.seed, dev) if init_params is None
            else tree.map(lambda x: x.to(dev), init_params))


def _init_stack(params0, opt, stack: int):
    """``stack`` lane-stacked copies of one initial point (the noisy lanes
    and, where the engine has one, the ideal lane) and their optimizer
    state."""
    vals = tree.map(lambda x: x[None].expand(
        (stack,) + x.shape).clone(), params0)
    return vals, opt.init(vals)


def _lane_rows(mesh: shard.Mesh, lanes: int):
    """This rank's lane indices on a lane mesh's first axis (the padded
    lane axis's block; row 0 repeats as padding), or ``None`` for a rank
    the mesh leaves out; and the block's size."""
    rows = shard.pad_lanes(np.arange(lanes), mesh.shape[0])
    size = rows.shape[0] // mesh.shape[0]
    here = mesh.coord()
    return (None if here is None
            else shard.block(rows, mesh.shape[0], here[0])), size


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks otherwise; no silent CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the curve and sweep engines run on the GPU and no CUDA device "
            "is available; pass device='cpu' to run the plain PyTorch path "
            "on the CPU")
    return dev


def run_curves(ccfg: Optional[CurveConfig] = None, *, device=None,
               init_params: Optional[dict] = None,
               n_devices: Optional[int] = None) -> CurveResult:
    """Train the p_miss lane axis through the simulated channel, per bits.

    ``ccfg=None`` runs the default :class:`CurveConfig` grid.  For every
    ``bits`` value the lanes and the ideal reference train as one stack
    from identical initial parameters on one batch stream; evaluation runs
    channel-in-the-loop as well (fresh sensing keys, same lanes).

    ``device`` defaults to ``cuda`` and raises when no GPU is present;
    pass ``device="cpu"`` for the plain path.  ``init_params`` (a
    ``vertical.init``-shaped dict, e.g. ``convert.params_from_jax`` of the
    JAX package's ``vertical.init``) sets the initial parameters; without
    it they come from ``vertical.init``'s own ``torch.Generator`` seeded
    with ``ccfg.seed``, which are not the JAX package's values.

    ``n_devices`` shards the noisy lanes over ``torch.distributed`` ranks
    (``repro_torch.sim.shard``: ``None`` is every rank of the default
    group, 1 without one).  Each rank trains its block of lanes with the
    ideal lane riding along, as the JAX package replicates its ideal run,
    and every rank returns the whole result, bitwise the one-rank result.
    """
    ccfg = ccfg if ccfg is not None else CurveConfig()
    dev = resolve_device(device)
    lanes = len(ccfg.p_miss)
    mesh = shard.mesh_1d(shard.lane_devices(shard.resolve_devices(n_devices),
                                            lanes))
    rows, blk = _lane_rows(mesh, lanes)
    p_lanes = ccfg.lane_p_miss()
    logged = ccfg.logged_steps()
    slot = {s: i for i, s in enumerate(logged)}
    if rows is not None:
        p_dev = torch.from_numpy(p_lanes[rows]).to(dev)
        views, labels, vviews, vlabels = _make_data(ccfg, dev)

    n_bits = len(ccfg.bits)
    acc = np.zeros((n_bits, lanes), np.float64)
    nll = np.zeros_like(acc)
    acc_ideal = np.zeros((n_bits,), np.float64)
    nll_ideal = np.zeros_like(acc_ideal)
    hist = np.zeros((n_bits, len(logged), lanes), np.float64)
    hist_ideal = np.zeros((n_bits, len(logged)), np.float64)
    noisy_params, ideal_params = [], []

    for bi, bits in enumerate(ccfg.bits):
        out = None
        if rows is not None:
            vcfg, stack_loss, opt, step_fn = _make_steps(ccfg, bits)
            k_data, lane_keys = _stream_keys(ccfg, bits, dev)
            lane_keys = lane_keys[torch.from_numpy(rows).to(dev)]
            vals, opts = _init_stack(
                _initial_params(ccfg, vcfg, init_params, dev), opt, blk + 1)
            buf = torch.zeros((blk + 1, len(logged)), dtype=torch.float32,
                              device=dev)
            for s in range(ccfg.steps):
                idx = _batch_indices(k_data, s, ccfg.batch,
                                     ccfg.n_train).long()
                batch = (views[:, idx], labels[idx])
                chan = (_fold_lanes(lane_keys, s), p_dev)
                vals, opts, met = step_fn(vals, opts, batch, chan)
                if s in slot:
                    buf[:, slot[s]] = met["loss_mean"]
            with torch.no_grad():
                _, met = stack_loss(
                    vals, (vviews, vlabels),
                    (_fold_lanes(lane_keys, ccfg.steps), p_dev))
            out = {"acc": met["acc"], "nll": met["nll"], "hist": buf,
                   "vals": vals}
        # every rank's block (its lanes, then the ideal row), in lane order
        blocks = shard.gather_blocks(out, mesh, dev)
        stacked = tree.map(lambda *bs: torch.cat(
            [b[:blk] for b in bs])[:lanes].cpu(), *blocks)
        ideal = tree.map(lambda b: b[blk:].cpu(), blocks[0])
        # the one host read of this bits value
        acc[bi], nll[bi] = stacked["acc"].numpy(), stacked["nll"].numpy()
        acc_ideal[bi] = ideal["acc"].numpy()[0]
        nll_ideal[bi] = ideal["nll"].numpy()[0]
        hist[bi] = stacked["hist"].numpy().T
        hist_ideal[bi] = ideal["hist"].numpy()[0]
        noisy_params.append(stacked["vals"])
        ideal_params.append(ideal["vals"])

    return CurveResult(
        config=ccfg, p_miss=p_lanes, acc=acc, nll=nll, acc_ideal=acc_ideal,
        nll_ideal=nll_ideal, loss_history=hist, ideal_loss_history=hist_ideal,
        logged_steps=np.asarray(logged), noisy_params=noisy_params,
        ideal_params=ideal_params, device=str(dev))


# ---------------------------------------------------------------------------
# the scheduled engine: a BitsSchedule picks each step's depth
# ---------------------------------------------------------------------------

def _make_sched_step(per_cand, schedule: BitsSchedule):
    """One scheduled step: ``sched_step(idx, vals, opts, batch, chan,
    state) -> (vals, opts, metrics, state, next index, telemetry)``, the
    train step of depth ``schedule.candidates[idx]`` (``per_cand``, one
    :func:`_make_steps` each) and the schedule's update from the noisy
    lanes' telemetry, all on the device; the caller reads the next index
    back."""

    def sched_step(idx, vals, opts, batch, chan, state):
        vals, opts, met = per_cand[idx][3](vals, opts, batch, chan)
        # the noisy lanes' means, as the JAX package's jnp.mean
        telemetry = {k: mean_f32(met["chan_" + k])
                     for k in ("collision_frac", "rounds", "correct_frac")}
        state, nxt = schedule.update(state, telemetry)
        return vals, opts, met, state, nxt, telemetry

    return sched_step


def run_scheduled_curves(ccfg: CurveConfig, schedule: BitsSchedule, *,
                         device=None, init_params: Optional[dict] = None
                         ) -> ScheduledCurveResult:
    """Train the ``p_miss`` lanes with a channel-aware ``BitsSchedule``.

    Every step runs at the depth ``schedule.candidates[idx]``; after it,
    ``schedule.update`` consumes the step's telemetry (the noisy lanes'
    mean collision fraction, rounds and correctness) on the device and
    emits the next index, which is read back to the host: the kernels take
    ``bits`` as an ``int``.  The ideal lane rides along in the stack at the
    step's depth and is dropped from the result.

    The streams derive from ``_stream_keys(ccfg, candidates[init_index])``
    and the model does not depend on the depth, so a schedule that never
    leaves its initial depth ``b`` (``FixedBits(b)``) trains bit for bit the
    noisy lanes of ``run_curves(bits=(b,))``.  ``device`` and
    ``init_params`` as in :func:`run_curves`; ``ccfg.bits`` is not used."""
    dev = resolve_device(device)
    lanes = len(ccfg.p_miss)
    p_lanes = ccfg.lane_p_miss()
    p_dev = torch.from_numpy(p_lanes).to(dev)
    views, labels, vviews, vlabels = _make_data(ccfg, dev)
    logged = ccfg.logged_steps()
    slot = {s: i for i, s in enumerate(logged)}

    per_cand = [_make_steps(ccfg, b) for b in schedule.candidates]
    sched_step = _make_sched_step(per_cand, schedule)
    k_data, lane_keys = _stream_keys(
        ccfg, schedule.candidates[schedule.init_index], dev)
    # the model is depth-independent: one train state serves every depth
    vals, opts = _init_stack(
        _initial_params(ccfg, per_cand[0][0], init_params, dev),
        per_cand[0][2], lanes + 1)
    buf = torch.zeros((lanes + 1, len(logged)), dtype=torch.float32,
                      device=dev)
    coll_buf = torch.zeros((len(logged),), dtype=torch.float32, device=dev)
    state = schedule.init_state(dev)
    idx, idx_seq = schedule.init_index, []
    for s in range(ccfg.steps):
        idx_seq.append(idx)
        b_idx = _batch_indices(k_data, s, ccfg.batch, ccfg.n_train).long()
        batch = (views[:, b_idx], labels[b_idx])
        chan = (_fold_lanes(lane_keys, s), p_dev)
        vals, opts, met, state, nxt, telemetry = sched_step(
            idx, vals, opts, batch, chan, state)
        if s in slot:
            buf[:, slot[s]] = met["loss_mean"]
            coll_buf[slot[s]] = telemetry["collision_frac"]
        if len(schedule.candidates) > 1 and s + 1 < ccfg.steps:
            # the one host read of a step: the next depth's index (4 bytes)
            idx = int(nxt)
    # evaluate at the depth the last step trained with
    stack_loss = per_cand[idx_seq[-1]][1]
    with torch.no_grad():
        _, met = stack_loss(vals, (vviews, vlabels),
                            (_fold_lanes(lane_keys, ccfg.steps), p_dev))
    a, n, b, c = (met["acc"].cpu().numpy(), met["nll"].cpu().numpy(),
                  buf.cpu().numpy(), coll_buf.cpu().numpy())
    return ScheduledCurveResult(
        config=ccfg, schedule=schedule, p_miss=p_lanes,
        acc=a[:lanes].astype(np.float64), nll=n[:lanes].astype(np.float64),
        loss_history=b[:lanes].T.astype(np.float64),
        collision_frac=c.astype(np.float64),
        bits_per_step=np.asarray(schedule.candidates, np.int64)[idx_seq],
        logged_steps=np.asarray(logged),
        params=tree.map(lambda x: x[:lanes].cpu(), vals), device=str(dev))


# ---------------------------------------------------------------------------
# the fault engine: one FaultModel per lane, chains carried across steps
# ---------------------------------------------------------------------------

def run_fault_curves(ccfg: CurveConfig, fault_lanes: Sequence, *,
                     device=None, init_params: Optional[dict] = None
                     ) -> FaultCurveResult:
    """Train a grid of channel-fault lanes, one ``FaultModel`` per lane.

    The lanes share one ``DegradePolicy`` (mixed policies are refused: run
    one grid per policy).  For every ``bits`` value the lanes train as one
    stack with the ideal lane riding along (dropped from the result); the
    Markov chains and the per-lane stale caches carry across steps on the
    device, the degradation telemetry accumulates there, and it is read
    back once per ``bits`` value.  The evaluation runs under the final
    chain state with a fresh evaluation-shaped cache.

    The streams are :func:`run_curves`'s: with ``len(fault_lanes) ==
    len(ccfg.p_miss)`` a ``FaultModel.iid(p)`` lane trains bit for bit the
    ``run_curves`` noisy lane of the same ``p``.  ``device`` and
    ``init_params`` as in :func:`run_curves`; ``ccfg.p_miss`` is not
    used."""
    lanes = len(fault_lanes)
    if lanes == 0:
        raise ValueError("fault_lanes needs at least one FaultModel")
    dev = resolve_device(device)
    # refuses lanes of mixed policies: run one grid per policy
    fm = faults.stack_models(fault_lanes, ccfg.n_workers, dev)
    views, labels, vviews, vlabels = _make_data(ccfg, dev)
    logged = ccfg.logged_steps()
    slot = {s: i for i, s in enumerate(logged)}

    n_bits = len(ccfg.bits)
    acc = np.zeros((n_bits, lanes), np.float64)
    nll = np.zeros_like(acc)
    hist = np.zeros((n_bits, len(logged), lanes), np.float64)
    stale = np.zeros((n_bits, len(logged), lanes), np.int64)
    dropped = np.zeros((n_bits, lanes), np.int64)
    outages = np.zeros_like(dropped)
    retries = np.zeros_like(dropped)
    params_out = []

    def lane_state(pooled_shape):
        return faults.init_state(ccfg.n_workers, pooled_shape,
                                 device=dev).map(
            lambda t: t[None].expand((lanes,) + t.shape).clone())

    for bi, bits in enumerate(ccfg.bits):
        vcfg, fault_loss, opt, step_fn = _make_fault_steps(ccfg, bits)
        k_data, lane_keys = _fault_stream_keys(ccfg, bits, lanes, dev)
        vals, opts = _init_stack(
            _initial_params(ccfg, vcfg, init_params, dev), opt, lanes + 1)
        fs = lane_state((ccfg.batch, ccfg.embed_dim))
        buf = torch.zeros((lanes + 1, len(logged)), dtype=torch.float32,
                          device=dev)
        stale_buf = torch.zeros((lanes, len(logged)), dtype=torch.int32,
                                device=dev)
        # whole-run totals: dropped frames, outages, retry slots
        totals = torch.zeros((3, lanes), dtype=torch.int32, device=dev)
        for s in range(ccfg.steps):
            idx = _batch_indices(k_data, s, ccfg.batch, ccfg.n_train).long()
            batch = (views[:, idx], labels[idx])
            chan = (_fold_lanes(lane_keys, s), fm, fs)
            vals, opts, met = step_fn(vals, opts, batch, chan)
            fs = met["fault_state"]
            totals += torch.stack([met["fault_dropped_frames"],
                                   met["fault_outage"],
                                   met["fault_retry_slots"]])
            if s in slot:
                buf[:, slot[s]] = met["loss_mean"]
                stale_buf[:, slot[s]] = met["fault_stale_age"]
        # the final chain state, a fresh evaluation-shaped cache
        ev = lane_state((ccfg.n_val, ccfg.embed_dim))
        eval_fs = faults.FaultState(bad=fs.bad, offline=fs.offline,
                                    stale=ev.stale, age=ev.age,
                                    consec=ev.consec)
        with torch.no_grad():
            _, met = fault_loss(vals, (vviews, vlabels),
                                (_fold_lanes(lane_keys, ccfg.steps), fm,
                                 eval_fs))
        # the one host read of this bits value
        a, n, b, st, tot = (t.cpu().numpy() for t in (
            met["acc"], met["nll"], buf, stale_buf, totals))
        acc[bi], nll[bi] = a[:lanes], n[:lanes]
        hist[bi], stale[bi] = b[:lanes].T, st.T
        dropped[bi], outages[bi], retries[bi] = tot
        params_out.append(tree.map(lambda x: x[:lanes].cpu(), vals))

    return FaultCurveResult(
        config=ccfg, fault_lanes=tuple(fault_lanes), acc=acc, nll=nll,
        loss_history=hist, stale_age=stale, dropped_frames=dropped,
        outage_frames=outages, retry_slots=retries,
        logged_steps=np.asarray(logged), params=params_out, device=str(dev))


# ---------------------------------------------------------------------------
# the compressed-comms engine: p_miss lanes x data-parallel ranks
# ---------------------------------------------------------------------------

def _make_dp_loss(ccfg: CurveConfig, bits: int):
    """The (lane, rank) stack's loss: ``values`` leaves ``(S, ...)``,
    ``views (S, N, b, d)``, ``labels (S, b)``, keys ``(S, 2)``, ``p``
    ``(S,)`` or ``(S, N)`` -> one loss per stack row, all pooled through
    the noisy channel in one call."""
    vcfg = _vertical_config(ccfg, bits)
    noisy = ccfg.protocol(bits)

    def dp_loss(values, views, labels, keys, p):
        h = vertical.embeddings(vcfg, values, views)          # (S, N, b, K)
        v, _ = noisy.with_p_miss(p).aggregate(h, keys, lanes=True)
        return vertical.task_loss(vcfg, vertical.head(vcfg, values, v),
                                  labels)

    return vcfg, noisy, dp_loss


def _make_dp_step(dp_loss, opt, compress: CompressedAllReduce, blk: int,
                  held: int, ranks: int, group=None):
    """One step of the (lane, rank) stack: ``dp_step(vals, opts, errs,
    views, labels, keys, p) -> (vals, opts, errs, loss, acct)``.  The
    lanes' parameters (``blk`` lanes) are repeated for each of the
    ``held`` DP ranks this device holds, every (lane, rank) row's
    gradient is sparsified with its own error memory ``errs (blk, held,
    ...)``, ``compress.reduce`` sums them over the ranks (over ``group``
    too where the DP axis lies on ranks) and AdamW applies the sum divided
    by ``ranks``."""
    stack = blk * held

    def per_rank(x):
        """A lane-stacked leaf repeated for each held rank: (blk * held,
        ...)."""
        return x[:, None].expand((blk, held) + x.shape[1:]).reshape(
            (stack,) + x.shape[1:])

    def dp_step(vals, opts, errs, views, labels, keys, p):
        leaves = [per_rank(x).detach().requires_grad_(True)
                  for x in tree.leaves(vals)]
        with torch.enable_grad():
            loss, _ = dp_loss(tree.unflatten(vals, leaves), views, labels,
                              keys, p)
            grads = torch.autograd.grad(loss.sum(), leaves)
        grads = tree.unflatten(vals, [
            g.reshape((blk, held) + g.shape[1:]) for g in grads])
        reduced, errs, acct = compress.reduce(grads, errs, rank_dim=1,
                                              group=group)
        reduced = tree.map(lambda g: g / ranks, reduced)
        vals, opts, _ = opt.update(reduced, opts, vals)
        return vals, opts, errs, loss, acct

    return dp_step


def run_curves_dp(ccfg: CurveConfig, compress: CompressedAllReduce, *,
                  device=None, init_params: Optional[dict] = None,
                  n_devices: Optional[int] = None) -> DPCurveResult:
    """Train the (p_miss lanes x ``ccfg.dp_shards`` DP ranks) grid with
    compressed data-parallel gradients.

    Each step, rank ``d`` of lane ``l`` trains on its slice
    ``idx[d*B/D : (d+1)*B/D]`` of the shared batch stream with sensing key
    ``fold_in(fold_in(lane_keys[l], step), d)``; the (lane, rank) pairs a
    device holds run as one noisy lane stack (one contention, one pooling
    epilogue and one winner-routed backward a step).  Every rank
    sparsifies its gradients (top-k with its own error-feedback memory),
    ``compress.reduce`` sums them over the ranks, and AdamW applies the
    sum divided by D: the parameters stay the same on every rank, so they
    are held once per lane, and only the error memory differs.  The logged
    loss is the rank mean; the measured payload bits stay on the device
    and are read back once per ``bits`` value.  Evaluation runs the lanes'
    parameters with keys ``fold_in(lane_keys, steps)``.

    ``n_devices`` places the grid on ``torch.distributed`` ranks as
    ``repro_torch.sim.shard.dp_mesh_shape`` splits them: the DP axis lies
    wholly on ranks (``n_d == dp_shards``: each device holds one DP rank,
    and ``compress.reduce`` gathers over its row of the mesh) or wholly in
    the tensor, and the lanes shard over the ranks that remain.  Every
    rank returns the whole result, bitwise the one-rank result.

    The streams are :func:`run_curves`'s.  ``device`` and ``init_params``
    as in :func:`run_curves`.  Feed the result to
    ``repro_torch.sim.results.summarize_dp_curves``.
    """
    dev = resolve_device(device)
    lanes, ranks = len(ccfg.p_miss), ccfg.dp_shards
    shard_b = ccfg.batch // ranks
    n_s, n_d = shard.dp_mesh_shape(shard.resolve_devices(n_devices), lanes,
                                   ranks)
    mesh = shard.mesh_2d(n_s, n_d) if n_d > 1 else shard.mesh_1d(n_s)
    rows, blk = _lane_rows(mesh, lanes)
    here = mesh.coord()
    # the DP ranks this device holds; the mesh row's group holds the others
    d_ids = [here[1]] if n_d > 1 and here is not None else list(range(ranks))
    group = mesh.groups.get("d")
    held = len(d_ids)
    stack = blk * held                      # row l * held + d
    p_lanes = ccfg.lane_p_miss()
    logged = ccfg.logged_steps()
    slot = {s: i for i, s in enumerate(logged)}
    if rows is not None:
        p_dev = torch.from_numpy(p_lanes[rows]).to(dev)
        p_stack = p_dev.repeat_interleave(held, dim=0)
        views, labels, vviews, vlabels = _make_data(ccfg, dev)
        rank_ids = torch.tensor(d_ids, device=dev)

    n_bits = len(ccfg.bits)
    acc = np.zeros((n_bits, lanes), np.float64)
    nll = np.zeros_like(acc)
    hist = np.zeros((n_bits, len(logged), lanes), np.float64)
    pay = np.zeros((n_bits, len(logged), lanes), np.int64)
    pay_total = np.zeros((n_bits, lanes), np.int64)
    params_out = []
    pay_step = dense_step = 0

    def train_block(bits, vcfg, noisy, dp_loss, params0) -> dict:
        """This device's lanes x DP ranks of one ``bits`` value, trained
        and evaluated."""
        opt = _optimizer(ccfg)
        dp_step = _make_dp_step(dp_loss, opt, compress, blk, held, ranks,
                                group)
        k_data, lane_keys = _stream_keys(ccfg, bits, dev)
        lane_keys = lane_keys[torch.from_numpy(rows).to(dev)]
        vals, opts = _init_stack(params0, opt, blk)
        # per-(lane, held rank) error-feedback memory
        errs = tree.map(lambda x: torch.zeros(
            (blk, held) + x.shape[1:], dtype=torch.float32, device=dev),
            vals)
        buf = torch.zeros((blk, len(logged)), dtype=torch.float32,
                          device=dev)
        pay_buf = torch.zeros((blk, len(logged)), dtype=torch.int64,
                              device=dev)
        pay_run = torch.zeros((blk,), dtype=torch.int64, device=dev)
        for s in range(ccfg.steps):
            idx = _batch_indices(k_data, s, ccfg.batch, ccfg.n_train).long()
            idx = idx.reshape(ranks, shard_b)[d_ids]     # rank d's slice
            bviews = views[:, idx].transpose(0, 1)       # (held, N, b, d)
            bviews = bviews[None].expand((blk,) + bviews.shape).reshape(
                (stack,) + bviews.shape[1:])
            blabels = labels[idx][None].expand(blk, held, shard_b
                                               ).reshape(stack, shard_b)
            keys = jr.fold_in(_fold_lanes(lane_keys, s)[:, None],
                              rank_ids).reshape(stack, 2)
            vals, opts, errs, loss, acct = dp_step(
                vals, opts, errs, bviews, blabels, keys, p_stack)
            pay_run += acct.payload_bits
            if s in slot:
                losses = loss.detach().reshape(blk, held)
                if group is not None:       # every DP rank's, in rank order
                    losses = torch.cat([p[0] for p in comm.all_gather(
                        [losses], group)], dim=1)
                buf[:, slot[s]] = mean_f32(losses)
                pay_buf[:, slot[s]] = acct.payload_bits
        with torch.no_grad():
            _, met = vertical.loss_fn(
                vcfg, vals, vviews, vlabels,
                rng=_fold_lanes(lane_keys, ccfg.steps),
                protocol=noisy.with_p_miss(p_dev), lanes=True)
        return {"acc": met["acc"], "nll": met["nll"], "hist": buf,
                "pay": pay_buf, "pay_run": pay_run, "vals": vals}

    for bi, bits in enumerate(ccfg.bits):
        vcfg, noisy, dp_loss = _make_dp_loss(ccfg, bits)
        # the analytic per-step bill every measured step must equal
        params0 = _initial_params(ccfg, vcfg, init_params, dev)
        pay_step = compress.payload_bits(params0) * ranks
        dense_step = compress.dense_bits(params0) * ranks
        out = (None if rows is None
               else train_block(bits, vcfg, noisy, dp_loss, params0))
        got = tree.map(lambda x: x.cpu(),
                       shard.gather_lanes(out, lanes, mesh, dev))
        # the one host read of this bits value
        acc[bi], nll[bi] = got["acc"].numpy(), got["nll"].numpy()
        hist[bi], pay[bi] = got["hist"].numpy().T, got["pay"].numpy().T
        pay_total[bi] = got["pay_run"].numpy()
        params_out.append(got["vals"])

    return DPCurveResult(
        config=ccfg, compress=compress, p_miss=p_lanes, acc=acc, nll=nll,
        loss_history=hist, dp_payload_bits=pay,
        dp_payload_bits_total=pay_total, dp_payload_bits_step=int(pay_step),
        dp_dense_bits_step=int(dense_step), logged_steps=np.asarray(logged),
        params=params_out, device=str(dev))
