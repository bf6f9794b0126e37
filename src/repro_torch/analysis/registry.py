"""The contract registry: every step or tick entry point of the port
declares its invariants here, under the JAX registry's names
(``src/repro/analysis/registry.py``), and ``python -m
repro_torch.analysis`` (or ``tests/test_torch_analysis.py``) holds it to
them.

A :class:`Contract` names the entry point, the leaves it must stay
stable over, its dispatch bound (documentation for the shared assertions
of :mod:`repro_torch.analysis.contracts`), which checks apply and which
kernels its stream must reach.  ``build()`` returns the port's own
callable that the engine runs (one step of the curve engines' lane stack,
``Protocol.aggregate``, the sweep's noisy core, ``make_train_step``'s
step, the serve tick's device part) with an argument factory: ``argsf(p)``
gives real CPU tensors at a tiny size with ``p`` in the rebindable
leaves, which the checks make fake (or, on the card, move there).

:data:`STEP_BODIES` names the step and tick bodies for the lint's
``host-sync-in-step`` rule.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.analysis import contracts as C
from repro_torch.analysis import stream_checks
from repro_torch.analysis.report import Finding


@dataclasses.dataclass
class Entry:
    """A built entry point: the callable and its argument factory.

    ``argsf(p)`` embeds the perturbation ``p`` into the contract's
    rebindable leaves; every other argument is the same across calls, and
    each call builds fresh tensors (a donated step writes into them)."""

    fn: Callable
    argsf: Callable[[float], Tuple]


@dataclasses.dataclass(frozen=True)
class Contract:
    """One entry point's declared invariants (see the module doc);
    ``kernels`` are the kernels (``kernels.KERNELS`` names) whose custom
    ops its stream holds and which a real run on the card launches."""

    name: str
    build: Callable[[], Entry]
    recompile_free_over: str = "protocol.p_miss"   # "" disables the check
    max_dispatches: str = ""                       # documented host bound
    forbid_f64: bool = True
    forbid_host_sync: bool = True
    host_sync_allowlist: Tuple[str, ...] = ()
    check_donation: bool = False
    forbid_collectives: bool = False
    kernels: Tuple[str, ...] = ()


# the custom op of each kernel, as the op stream names it
CUSTOM_OPS = {
    "ocs_quant.encode": "repro_torch.ocs_encode.default",
    "ocs_quant.decode": "repro_torch.ocs_decode.default",
    "maxpool.fwd": "repro_torch.maxpool_fwd.default",
    "maxpool.decode": "repro_torch.maxpool_decode.default",
    "maxpool.winner_bwd": "repro_torch.maxpool_winner_bwd.default",
    "maxpool.ties_bwd": "repro_torch.maxpool_ties_bwd.default",
    "ocs_contention.contend": "repro_torch.ocs_contend.default",
    "ocs_contention.noisy": "repro_torch.ocs_noisy.default",
    "flash_attention.fwd": "repro_torch.flash_fwd.default",
}

# the port's paths that run other ops on the card than on the CPU by
# design: a fake-CUDA stream may differ from the fake-CPU one there
DEVICE_BRANCHES = (
    # each lane's gradient norm a reduction of its own on the card, one
    # reduction over the lane axis on the CPU (in its helper)
    "repro_torch/optim/optimizers.py:global_norm",
    "repro_torch/optim/optimizers.py:_sum_from",
)

# file -> the qualnames of its step and tick bodies (host-sync-in-step)
STEP_BODIES: Dict[str, Tuple[str, ...]] = {
    "src/repro_torch/protocol/protocol.py": (
        "Protocol.aggregate", "Protocol.aggregate_with_ideal", "_ocs_pool"),
    "src/repro_torch/faults/model.py": (
        "aggregate", "aggregate_with_ideal", "_aggregate_lanes"),
    "src/repro_torch/sim/train_curves.py": (
        "_make_steps.stack_loss", "_make_fault_steps.fault_loss",
        "_make_dp_loss.dp_loss", "_make_dp_step.dp_step",
        "_make_sched_step.sched_step"),
    "src/repro_torch/sim/sweep.py": ("_noisy_core",),
    "src/repro_torch/serve/engine.py": (
        "ServeEngine._tick_device", "ServeEngine._degrade"),
    "src/repro_torch/train/train_step.py": (
        "value_and_grad", "make_train_step.grad_fn",
        "make_train_step.compute_grads", "make_train_step.apply_update",
        "make_train_step.train_step", "make_train_step.compressed_step",
        "make_train_step.train_step_err"),
}


# ---------------------------------------------------------------------------
# builders (lazy: subsystem imports stay inside)
# ---------------------------------------------------------------------------

_N_WORKERS = 4          # worker count shared by the tiny vertical builders


def _randn(shape, seed: int) -> torch.Tensor:
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _keys(n: int, seed: int = 0) -> torch.Tensor:
    from repro_torch import random as jr
    return jr.split(jr.PRNGKey(seed), n)


def _ocs(p: float, n: int = _N_WORKERS):
    from repro_torch.protocol import Protocol
    return Protocol.ocs(bits=8, max_rounds=2,
                        p_miss=torch.full((n,), p, dtype=torch.float32))


def _build_protocol_aggregate() -> Entry:
    from repro_torch import random as jr

    def agg(protocol, h, rng):
        return protocol.aggregate(h, rng)

    def argsf(p):
        return (_ocs(p), _randn((_N_WORKERS, 2, 8), 1), jr.PRNGKey(0))

    return Entry(fn=agg, argsf=argsf)


def _tiny_curve_config(**overrides):
    from repro_torch.sim.train_curves import CurveConfig
    return CurveConfig(**dict(
        dict(bits=(8,), p_miss=(0.0, 0.05), steps=4, batch=4, max_rounds=2,
             n_train=32, n_val=16, hw=8, encoder_dims=(8,), embed_dim=4,
             head_dims=(8,), log_every=2), **overrides))


def _curve_state(ccfg, vcfg, opt, stack: int):
    """A lane stack's values and optimizer state, and one batch."""
    from repro_torch.core import vertical
    from repro_torch.sim import train_curves as tc
    vals, opts = tc._init_stack(vertical.init(vcfg, 0, "cpu"), opt, stack)
    views, labels = tc._make_data(ccfg, "cpu")[:2]
    return vals, opts, (views[:, :ccfg.batch], labels[:ccfg.batch])


def _lanes(p: float) -> torch.Tensor:
    return torch.tensor([0.0, p], dtype=torch.float32)


def _build_curves_fused() -> Entry:
    from repro_torch.sim import train_curves as tc

    ccfg = _tiny_curve_config()
    vcfg, _, opt, step_fn = tc._make_steps(ccfg, 8)

    def argsf(p):
        vals, opts, batch = _curve_state(ccfg, vcfg, opt, 3)
        return (vals, opts, batch, (_keys(2), _lanes(p)))

    return Entry(fn=step_fn, argsf=argsf)


def _build_curves_fused_dp() -> Entry:
    from repro_torch import tree
    from repro_torch.core import vertical
    from repro_torch.optim.compressed_allreduce import CompressedAllReduce
    from repro_torch.sim import train_curves as tc

    ccfg = _tiny_curve_config(dp_shards=2)
    lanes, held = 2, 2
    vcfg, _, dp_loss = tc._make_dp_loss(ccfg, 8)
    opt = tc._optimizer(ccfg)
    dp_step = tc._make_dp_step(dp_loss, opt, CompressedAllReduce.topk(0.25),
                               lanes, held, held)
    b = ccfg.batch // held

    def argsf(p):
        # the perturbation lands in both rebindable leaves: the lanes'
        # p_miss and the error-feedback memory's values
        vals, opts = tc._init_stack(vertical.init(vcfg, 0, "cpu"), opt,
                                    lanes)
        errs = tree.map(lambda x: torch.full((lanes, held) + x.shape[1:], p),
                        vals)
        views, labels = tc._make_data(ccfg, "cpu")[:2]
        idx = torch.arange(held * b).reshape(held, b)
        bviews = views[:, idx].transpose(0, 1)
        bviews = bviews[None].expand((lanes,) + bviews.shape).reshape(
            (lanes * held,) + bviews.shape[1:])
        blabels = labels[idx][None].expand(lanes, held, b).reshape(
            lanes * held, b)
        p_stack = _lanes(p).repeat_interleave(held)
        return (vals, opts, errs, bviews, blabels, _keys(lanes * held),
                p_stack)

    return Entry(fn=dp_step, argsf=argsf)


def _build_curves_sched() -> Entry:
    from repro_torch.protocol import CollisionAdaptiveBits
    from repro_torch.sim import train_curves as tc

    ccfg = _tiny_curve_config()
    schedule = CollisionAdaptiveBits((8, 16))
    per_cand = [tc._make_steps(ccfg, b) for b in schedule.candidates]
    sched_step = tc._make_sched_step(per_cand, schedule)
    vcfg, opt = per_cand[0][0], per_cand[0][2]

    def step(vals, opts, batch, chan, state):
        return sched_step(schedule.init_index, vals, opts, batch, chan,
                          state)

    def argsf(p):
        vals, opts, batch = _curve_state(ccfg, vcfg, opt, 3)
        return (vals, opts, batch, (_keys(2), _lanes(p)),
                schedule.init_state("cpu"))

    return Entry(fn=step, argsf=argsf)


def _build_serve_tick() -> Entry:
    from repro_torch import faults
    from repro_torch.configs import get_reduced
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg = get_reduced("qwen1.5-0.5b", n_layers=1, d_model=8, n_heads=2,
                      n_kv_heads=2, d_ff=16, vocab_size=32, n_workers=2)
    m = M.build(cfg)
    values = m.init(torch.Generator().manual_seed(0))
    eng = ServeEngine(m, values, ServeConfig(batch_slots=2, max_seq=8),
                      device="cpu")
    keys = (eng._base_key, eng._sample_key)

    def tick(values, proto, fm, fstate, cur_token, positions, cache, keys):
        eng.values, eng.cache, eng.fstate = values, cache, fstate
        eng._recurrent = m.recurrent_leaves(cache)
        eng.cur_token, eng.positions = cur_token, positions
        eng._base_key, eng._sample_key = keys
        eng.device = cur_token.device
        return eng._tick_device(proto, 0, fm)

    def argsf(p):
        # the perturbation lands in every rebindable channel leaf at once:
        # protocol.p_miss, the Gilbert-Elliott transition and miss probs,
        # the dropout rates and the carried chain state
        fm = faults.FaultModel.gilbert_elliott(
            p_gb=p, p_bg=2 * p, p_miss_good=p, p_miss_bad=0.5,
            policy=faults.DegradePolicy.stale()).with_dropout(p, 1.0 - p)
        fstate = faults.FaultState(
            bad=torch.arange(2) % 2 == int(p > 0.05),
            offline=torch.zeros((2,), dtype=torch.bool), stale=_f32(p),
            age=torch.tensor(int(100 * p), dtype=torch.int32),
            consec=torch.tensor(0, dtype=torch.int32))
        return (values, _ocs(p, 2), fm, fstate,
                torch.zeros((2, 1), dtype=torch.int32),
                torch.tensor([3, 5], dtype=torch.int32),
                m.cache_init(2, 8, "cpu"), keys)

    return Entry(fn=tick, argsf=argsf)


def _fault_model(**leaves):
    from repro_torch import faults
    return faults.FaultModel(policy=faults.DegradePolicy.stale(), **{
        k: _f32(v) for k, v in leaves.items()})


def _build_faults_aggregate() -> Entry:
    from repro_torch import faults
    from repro_torch import random as jr

    def agg(protocol, model, state, h, rng):
        return faults.aggregate(protocol, model, state, h, rng)

    def argsf(p):
        fm = _fault_model(p_gb=p, p_bg=2 * p, p_miss_good=p / 2,
                          p_miss_bad=0.4 + p, p_drop=p, p_recover=1.0 - p)
        idx = torch.arange(_N_WORKERS)
        state = faults.FaultState(
            bad=idx % 2 == int(p > 0.05), offline=idx % 3 == int(p > 0.05),
            stale=torch.full((2, 8), p),
            age=torch.tensor(int(100 * p), dtype=torch.int32),
            consec=torch.tensor(int(10 * p), dtype=torch.int32))
        return (_ocs(p), fm, state, _randn((_N_WORKERS, 2, 8), 1),
                jr.PRNGKey(0))

    return Entry(fn=agg, argsf=argsf)


def _build_curves_fused_faults() -> Entry:
    from repro_torch import faults
    from repro_torch.sim import train_curves as tc

    ccfg = _tiny_curve_config()
    lanes, n = 2, ccfg.n_workers
    vcfg, _, opt, step_fn = tc._make_fault_steps(ccfg, 8)

    def argsf(p):
        # lane-stacked fault grid: both lanes' transition probs, dropout
        # rates and the carried chain state move with p
        fm = faults.FaultModel(
            policy=faults.DegradePolicy.stale(), **{
                k: torch.tensor([[a], [b]], dtype=torch.float32)
                for k, (a, b) in dict(
                    p_gb=(0.0, p), p_bg=(0.25, 2 * p), p_miss_good=(0.0, p),
                    p_miss_bad=(0.5, 0.4 + p), p_drop=(0.0, p),
                    p_recover=(1.0, 1.0 - p)).items()})
        fs = faults.FaultState(
            bad=torch.zeros((lanes, n), dtype=torch.bool),
            offline=(torch.arange(lanes * n).reshape(lanes, n) % 3
                     == int(p > 0.05)),
            stale=torch.full((lanes, ccfg.batch, ccfg.embed_dim), p),
            age=torch.zeros((lanes,), dtype=torch.int32),
            consec=torch.zeros((lanes,), dtype=torch.int32))
        vals, opts, batch = _curve_state(ccfg, vcfg, opt, lanes + 1)
        return (vals, opts, batch, (_keys(lanes), fm, fs))

    return Entry(fn=step_fn, argsf=argsf)


def _build_sweep_noisy() -> Entry:
    from repro_torch.sim import sweep as sweep_mod

    fn = functools.partial(sweep_mod._noisy_core, bits=8, max_id_bits=2,
                           max_rounds=2, backend="scan")
    lanes = 2                       # 2 scenarios x 1 round

    def argsf(p):
        return (_randn((lanes, _N_WORKERS, 8), 2),
                torch.ones((lanes, _N_WORKERS), dtype=torch.bool), 2,
                _keys(lanes), torch.full((lanes, _N_WORKERS), p),
                torch.ones((lanes,), dtype=torch.int32))

    return Entry(fn=fn, argsf=argsf)


def _build_train_step_donated() -> Entry:
    from repro_torch.core import vertical
    from repro_torch.core.vertical import VerticalConfig
    from repro_torch.optim import optimizers, schedules
    from repro_torch.protocol import Protocol
    from repro_torch.train.train_step import make_train_step

    vcfg = VerticalConfig(
        n_workers=_N_WORKERS, input_dim=16, encoder_dims=(8,), embed_dim=4,
        head_dims=(8,), output_dim=4, task="classification",
        aggregation=Protocol.ideal_max(8, tie_break="first"))

    def loss(values, batch):
        views, labels = batch
        return vertical.loss_fn(vcfg, values, views, labels)

    opt = optimizers.adamw(schedules.constant(1e-3), weight_decay=0.01)
    step = make_train_step(loss, opt)

    def argsf(p):
        values = vertical.init(vcfg, 0, "cpu")
        labels = torch.arange(8, dtype=torch.int32) % 4
        return (values, opt.init(values),
                (_randn((_N_WORKERS, 8, 16), 3), labels))

    return Entry(fn=step, argsf=argsf)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

_CHANNEL = ("ocs_contention.noisy", "maxpool.decode")
_CURVES = _CHANNEL + ("maxpool.winner_bwd",)

CONTRACTS: Tuple[Contract, ...] = (
    Contract(
        name="protocol.aggregate",
        build=_build_protocol_aggregate,
        max_dispatches="inline (no host loop)",
        forbid_collectives=True,
        kernels=_CHANNEL,
    ),
    Contract(
        name="curves.fused",
        build=_build_curves_fused,
        max_dispatches="1 host read per bits value",
        kernels=_CURVES,
    ),
    Contract(
        name="curves.fused_dp",
        build=_build_curves_fused_dp,
        recompile_free_over="protocol.p_miss + error-feedback memory",
        max_dispatches="1 host read per bits value",
        kernels=_CURVES,
    ),
    Contract(
        name="curves.sched",
        build=_build_curves_sched,
        max_dispatches="1 host read (the next depth's index) per step",
        kernels=_CURVES,
    ),
    Contract(
        name="serve.tick",
        build=_build_serve_tick,
        recompile_free_over="protocol.p_miss + fault-model leaves + "
                            "chain state",
        max_dispatches="1 per decode tick (1 host read)",
        forbid_collectives=True,
        kernels=_CHANNEL,
    ),
    Contract(
        name="faults.aggregate",
        build=_build_faults_aggregate,
        recompile_free_over="GE transition/miss probs + dropout rates + "
                            "chain state + protocol.p_miss",
        max_dispatches="inline (no host loop)",
        forbid_collectives=True,
        kernels=_CHANNEL,
    ),
    Contract(
        name="curves.fused_faults",
        build=_build_curves_fused_faults,
        recompile_free_over="fault-model leaves + FaultState carry "
                            "(incl. stale cache + dropout masks)",
        max_dispatches="1 host read per bits value",
        kernels=_CURVES,
    ),
    Contract(
        name="sweep.noisy",
        build=_build_sweep_noisy,
        max_dispatches="1 per (bits, id_bits) group",
        kernels=_CHANNEL,
    ),
    Contract(
        name="train.step_donated",
        build=_build_train_step_donated,
        recompile_free_over="",          # no channel leaf: ideal protocol
        max_dispatches="1 per step",
        check_donation=True,
        kernels=("maxpool.decode", "maxpool.winner_bwd"),
    ),
)


def contract_names() -> Tuple[str, ...]:
    return tuple(c.name for c in CONTRACTS)


def get_contract(name: str) -> Contract:
    for c in CONTRACTS:
        if c.name == name:
            return c
    raise KeyError(f"no contract named {name!r}; "
                   f"known: {contract_names()}")


def trace_entry(contract: Contract, device="cpu",
                entry: Optional[Entry] = None) -> C.Trace:
    """The entry's op stream at ``p = 0.05`` on fake tensors of
    ``device``."""
    entry = entry or contract.build()
    return C.trace(entry.fn, entry.argsf(0.05), device)


def check_contract(contract: Contract, *, device="cpu", real: bool = False,
                   info: Optional[dict] = None) -> List[Finding]:
    """Run every check the contract declares on fake tensors of
    ``device`` (and, with ``real``, once on real tensors there under the
    sync debug mode); returns its findings and, into ``info``, what the
    run read (stream length, custom ops, copies, launches, the traced
    stream itself, and whether the real run completed sync-free)."""
    from repro_torch import kernels
    entry = contract.build()
    findings: List[Finding] = []
    if contract.recompile_free_over:
        findings += C.check_trace_stable(contract.name, entry.fn,
                                         entry.argsf, device=device)
    tr = trace_entry(contract, device, entry)
    if contract.forbid_host_sync:
        findings += C.host_sync_findings(contract.name, tr,
                                         contract.host_sync_allowlist)
    if contract.forbid_f64:
        findings += C.check_no_f64(contract.name, entry.fn, entry.argsf,
                                   device=device)
    if contract.check_donation:
        findings += C.check_donation(contract.name, entry.fn,
                                     entry.argsf(0.05))
    findings += stream_checks.check_stream(contract, tr)
    launches = sync = None
    if real:
        before = kernels.launch_counts()
        sync = C.check_real_sync(contract.name, entry.fn, entry.argsf(0.05),
                                 device)
        findings += sync
        launches = {k: v - before[k] for k, v in
                    kernels.launch_counts().items() if v > before[k]}
    if info is not None:
        info[contract.name] = {
            "findings": len(findings), "stream_ops": len(tr.stream),
            "custom_ops": sorted({op.name for op in tr.stream
                                  if op.name.startswith("repro_torch.")}),
            "copies": stream_checks.count_copies(tr.stream),
            "launches": launches, "trace": tr,
            "sync_free": None if sync is None else not sync}
    return findings


def check_all(*, device="cpu", real: bool = False,
              info: Optional[dict] = None) -> List[Finding]:
    findings: List[Finding] = []
    for c in CONTRACTS:
        findings += check_contract(c, device=device, real=real, info=info)
    return findings
