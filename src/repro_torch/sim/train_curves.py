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

No result is read back to the host inside the step loop: logged losses
collect in a device buffer that is read once per ``bits`` value.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch import tree
from repro_torch.core import vertical
from repro_torch.core.vertical import VerticalConfig
from repro_torch.data.vertical_data import (PatchTaskConfig,
                                            patch_classification)
from repro_torch.optim import optimizers, schedules
from repro_torch.protocol import Protocol
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

    def __post_init__(self):
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


# ---------------------------------------------------------------------------
# key and data streams (the JAX package's formulas)
# ---------------------------------------------------------------------------

def _stream_keys(ccfg: CurveConfig, bits: int, device=None):
    """Root keys of the batch stream and of the lanes' sensing streams."""
    base = jr.PRNGKey(ccfg.seed + 7919 * bits, device=device)
    k_data, k_noise = jr.split(base)
    return k_data, jr.split(k_noise, len(ccfg.p_miss))


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

    warmup = max(1, ccfg.steps // 10)
    opt = optimizers.adamw(
        schedules.linear_warmup_cosine(ccfg.lr, warmup, ccfg.steps),
        weight_decay=0.01, lane_dims=1)
    step = make_train_step(stack_loss, opt, with_rng=True)
    return vcfg, stack_loss, opt, step


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks otherwise; no silent CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "run_curves runs on the GPU and no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def run_curves(ccfg: Optional[CurveConfig] = None, *, device=None,
               init_params: Optional[dict] = None) -> CurveResult:
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
    """
    ccfg = ccfg if ccfg is not None else CurveConfig()
    dev = resolve_device(device)
    lanes = len(ccfg.p_miss)
    p_lanes = ccfg.lane_p_miss()
    p_dev = torch.from_numpy(p_lanes).to(dev)
    views, labels, vviews, vlabels = _make_data(ccfg, dev)
    logged = ccfg.logged_steps()
    slot = {s: i for i, s in enumerate(logged)}

    n_bits = len(ccfg.bits)
    acc = np.zeros((n_bits, lanes), np.float64)
    nll = np.zeros_like(acc)
    acc_ideal = np.zeros((n_bits,), np.float64)
    nll_ideal = np.zeros_like(acc_ideal)
    hist = np.zeros((n_bits, len(logged), lanes), np.float64)
    hist_ideal = np.zeros((n_bits, len(logged)), np.float64)
    noisy_params, ideal_params = [], []

    for bi, bits in enumerate(ccfg.bits):
        vcfg, stack_loss, opt, step_fn = _make_steps(ccfg, bits)
        k_data, lane_keys = _stream_keys(ccfg, bits, dev)
        params0 = (vertical.init(vcfg, ccfg.seed, dev) if init_params is None
                   else tree.map(lambda x: x.to(dev), init_params))
        vals = tree.map(lambda x: x[None].expand(
            (lanes + 1,) + x.shape).clone(), params0)
        opts = opt.init(vals)
        buf = torch.zeros((lanes + 1, len(logged)), dtype=torch.float32,
                          device=dev)
        for s in range(ccfg.steps):
            idx = _batch_indices(k_data, s, ccfg.batch, ccfg.n_train).long()
            batch = (views[:, idx], labels[idx])
            chan = (_fold_lanes(lane_keys, s), p_dev)
            vals, opts, met = step_fn(vals, opts, batch, chan)
            if s in slot:
                buf[:, slot[s]] = met["loss_mean"]
        with torch.no_grad():
            _, met = stack_loss(vals, (vviews, vlabels),
                                (_fold_lanes(lane_keys, ccfg.steps), p_dev))
        # the one host read of this bits value
        a, n, b = (met["acc"].cpu().numpy(), met["nll"].cpu().numpy(),
                   buf.cpu().numpy())
        acc[bi], nll[bi] = a[:lanes], n[:lanes]
        acc_ideal[bi], nll_ideal[bi] = a[lanes], n[lanes]
        hist[bi], hist_ideal[bi] = b[:lanes].T, b[lanes]
        cpu = tree.map(lambda x: x.cpu(), vals)
        noisy_params.append(tree.map(lambda x: x[:lanes], cpu))
        ideal_params.append(tree.map(lambda x: x[lanes:], cpu))

    return CurveResult(
        config=ccfg, p_miss=p_lanes, acc=acc, nll=nll, acc_ideal=acc_ideal,
        nll_ideal=nll_ideal, loss_history=hist, ideal_loss_history=hist_ideal,
        logged_steps=np.asarray(logged), noisy_params=noisy_params,
        ideal_params=ideal_params, device=str(dev))
