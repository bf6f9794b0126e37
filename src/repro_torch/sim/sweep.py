"""OCS scenario-grid runner (the JAX package's ``sim/sweep.py``).

Evaluates a whole scenario grid — scenarios x rounds, the worker axis
padded to the grid's largest N and masked — with each scenario's rounds
and the scenarios of one ``bits`` value flattened into the cores' lane
axis, so a grid costs one call of each engine per ``bits`` value, not one
per cell:

  * the clean engine: one ``ocs_maxpool_core`` call per ``bits`` value
    (its one ``ocs_quant.encode`` launch, the tournament as torch ops),
    each lane with its own ``id_bits``;
  * the noisy engine: one ``ocs_maxpool_noisy_core`` call per distinct
    ``(bits, id_bits)`` pair — one ``ocs_contention.noisy`` and one
    ``maxpool.decode`` launch on the card, whose kernels take ``id_bits``
    as a host ``int``.  Lanes are independent, so grouping changes no bit.
    The scan runs ``bits + max_id_bits`` sub-slots with ``max_id_bits``
    the whole ``bits`` group's, as in the JAX package.

Two points keep the port bit for bit the JAX package's vmap path:

  * ``h`` is padded to the grid's *global* largest N: the noisy core
    draws each sub-slot's sensing bits as an ``(N, K)`` block, and
    threefry's counter layout depends on that shape;
  * the sensing keys are ``split(PRNGKey(rng_seed), S * R)``, one per
    (scenario, round), stable under regrouping.

Nothing here compiles: ``dispatch_counts()`` counts each engine's core
calls (the JAX package's ``trace_counts`` has no counterpart).

``n_devices`` shards each group's scenarios over ``torch.distributed``
ranks (``repro_torch.sim.shard``), as the JAX package shards each
``bits`` group's: the clean engine's ``bits`` groups and the noisy
engine's ``(bits, id_bits)`` sub-groups, each padded to a multiple of its
rank count, rank ``r`` running its block, the blocks gathered in rank
order.  Every rank returns the whole result, bitwise the one-rank result.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.core import ocs
from repro_torch.kernels.ocs_contention.ops import MAX_WORKERS
from repro_torch.kernels.ocs_quant.ref import to_int64
from repro_torch.sim import shard
from repro_torch.sim.scenarios import Scenario
from repro_torch.sim.train_curves import resolve_device

_DISPATCH_COUNTS: Dict[str, int] = {"clean": 0, "noisy": 0}


def reset_dispatch_counts() -> None:
    """Zero the per-engine core-call counters."""
    for k in _DISPATCH_COUNTS:
        _DISPATCH_COUNTS[k] = 0


def dispatch_counts() -> Dict[str, int]:
    """Core calls issued by each engine on this rank: one ``clean`` per
    ``bits`` value and one ``noisy`` per distinct ``(bits, id_bits)`` pair
    of a sweep whose placement gives this rank a block."""
    return dict(_DISPATCH_COUNTS)


@dataclasses.dataclass
class SweepResult:
    """Stacked outcome of one grid sweep.

    The fields of ``clean``/``noisy`` are numpy arrays with leading (S, R)
    axes: scenario (in the order passed to :func:`run_sweep`) then round.
    ``h``/``mask`` are the padded inputs, kept so per-cell results can be
    checked against unbatched oracles.
    """

    scenarios: List[Scenario]
    k_elems: int
    rounds: int
    n_max: int
    h: np.ndarray                                   # (S, R, N_max, K)
    mask: np.ndarray                                # (S, N_max)
    clean: Optional[ocs.OCSResult] = None           # fields (S, R, ...)
    clean_latency_slots: Optional[np.ndarray] = None    # (S, R)
    noisy: Optional[ocs.NoisyOCSResult] = None      # fields (S, R, ...)
    noisy_latency_slots: Optional[np.ndarray] = None    # (S, R)
    device: str = "cpu"                             # where it ran

    def scenario_h(self, i: int) -> np.ndarray:
        """Unpadded (R, n_workers, K) features of scenario ``i``."""
        return self.h[i, :, :self.scenarios[i].n_workers, :]

    def clean_cell(self, i: int, r: int = 0) -> ocs.OCSResult:
        return _cell(self.clean, i, r)

    def noisy_cell(self, i: int, r: int = 0) -> ocs.NoisyOCSResult:
        return _cell(self.noisy, i, r)


def _cell(res, i: int, r: int):
    return type(res)(**{f.name: getattr(res, f.name)[i, r]
                        for f in dataclasses.fields(res)})


def _default_features(scenarios: Sequence[Scenario], rounds: int,
                      k_elems: int, seed: int) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((rounds, s.n_workers, k_elems))
            .astype(np.float32) for s in scenarios]


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A result tensor on the host, unsigned codes as numpy's unsigned
    type of their width."""
    if t.dtype in (torch.uint16, torch.uint32):
        return to_int64(t).cpu().numpy().astype(
            np.uint16 if t.dtype == torch.uint16 else np.uint32)
    return t.cpu().numpy()


class _Stacked:
    """One engine's fields, group by group, reassembled into (S, R, ...)
    host arrays in the original scenario order.  Groups concatenate as the
    JAX package's do, so a grid of mixed ``bits`` reports its codes in the
    widest group's type."""

    def __init__(self, rounds: int):
        self.rounds = rounds
        self.groups = []

    def put(self, sel: np.ndarray, named: Dict[str, torch.Tensor]) -> None:
        """One group's fields and ``latency_slots``, (S * R, ...) each."""
        arrays = {}
        for k, t in named.items():
            a = _numpy(t)
            arrays[k] = a.reshape((len(sel), self.rounds) + a.shape[1:])
        self.groups.append((sel, arrays))

    def result(self, cls):
        inv = np.argsort(np.concatenate([sel for sel, _ in self.groups]),
                         kind="stable")
        fields = {k: np.concatenate([g[k] for _, g in self.groups])[inv]
                  for k in self.groups[0][1]}
        lat = fields.pop("latency_slots")
        return cls(**fields), lat


def _ceil_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a + b - 1) // b


def _noisy_core(h: torch.Tensor, mask: torch.Tensor, id_bits: int,
                keys: torch.Tensor, p_miss: torch.Tensor,
                n_channels: torch.Tensor, *, bits: int, max_id_bits: int,
                max_rounds: int, backend: str):
    """The noisy engine's core over one ``(bits, id_bits)`` group's lanes:
    ``h (L, N_max, K)``, ``mask``/``p_miss (L, N_max)``, ``keys (L, 2)``,
    ``n_channels (L,)`` -> (the core's ``NoisyOCSResult``, the OFDMA
    latency slots (L,)).  One ``ocs_contention.noisy`` and one
    ``maxpool.decode`` launch on the card."""
    res = ocs.ocs_maxpool_noisy_core(
        h, mask, id_bits, keys, p_miss, bits=bits, max_id_bits=max_id_bits,
        max_rounds=max_rounds, backend=backend)
    return res, _ceil_div(res.contention_slots, n_channels)


def _placed(core, sel: np.ndarray, n_devices: int, rounds: int, dev
            ) -> Dict[str, torch.Tensor]:
    """Run ``core`` on this rank's block of the scenarios ``sel`` and
    gather every block: the result's fields and ``latency_slots``,
    (len(sel) * rounds, ...) each, on every rank.  ``core(part)`` returns
    ``(result, latency)`` for the scenarios ``part``."""
    mesh = shard.mesh_1d(shard.lane_devices(n_devices, len(sel)))
    here = mesh.coord()
    out = None
    if here is not None:
        part = shard.block(shard.pad_lanes(sel, mesh.size), mesh.size,
                           here[0])
        res, latency = core(part)
        out = {f.name: getattr(res, f.name) for f in dataclasses.fields(res)}
        out["latency_slots"] = latency
    return shard.gather_lanes(out, len(sel) * rounds, mesh, dev)


def run_sweep(scenarios: Sequence[Scenario], *,
              k_elems: int = 64,
              rounds: int = 1,
              seed: int = 0,
              h_by_scenario: Optional[Sequence[np.ndarray]] = None,
              rng_seed: int = 0,
              max_rounds: int = 3,
              backend: str = "scan",
              include_clean: bool = True,
              include_noisy: bool = True,
              n_devices: Optional[int] = None,
              device=None) -> SweepResult:
    """Evaluate every scenario x round cell, one core call per ``bits``
    value (clean) or per ``(bits, id_bits)`` pair (noisy).

    Args:
      scenarios:     grid cells (see ``repro_torch.sim.scenarios``).
      k_elems:       K, feature elements per aggregation round.
      rounds:        R, independent aggregation rounds per scenario.
      seed:          feature-generation seed (ignored if ``h_by_scenario``).
      h_by_scenario: optional per-scenario features, each (R, n_workers, K).
      rng_seed:      sensing-noise key seed of the noisy engine.
      max_rounds:    re-contention bound of the noisy protocol.
      backend:       ``"scan"`` or ``"pallas"``, the JAX package's names;
                     both give the same bits and the device decides what
                     runs.
      include_clean / include_noisy: which engines to run.
      n_devices:     ranks to shard each group's scenarios over
                     (``repro_torch.sim.shard``): ``None`` is every rank of
                     the default process group (1 without one).  Results
                     are identical either way.
      device:        ``cuda`` by default, which raises without a GPU; pass
                     ``"cpu"`` for the plain versions.  The noisy engine's
                     contention kernel takes at most 64 workers, so on the
                     card a noisy sweep of a wider scenario raises.

    Returns:
      SweepResult with (S, R)-stacked numpy fields, in the scenario order
      given.
    """
    dev = resolve_device(device)
    n_dev = shard.resolve_devices(n_devices)
    scenarios = list(scenarios)
    if not scenarios:
        raise ValueError("run_sweep needs at least one scenario")
    if h_by_scenario is None:
        h_by_scenario = _default_features(scenarios, rounds, k_elems, seed)
    if len(h_by_scenario) != len(scenarios):
        raise ValueError("h_by_scenario must match scenarios 1:1")

    n_max = max(s.n_workers for s in scenarios)
    if include_noisy and dev.type == "cuda" and n_max > MAX_WORKERS:
        wide = [s.name for s in scenarios if s.n_workers > MAX_WORKERS]
        raise ValueError(
            f"the noisy sweep's contention kernel takes at most "
            f"{MAX_WORKERS} workers; scenarios {wide} have more (run them "
            "with include_noisy=False, or on the CPU)")
    s_total = len(scenarios)
    h_pad = np.zeros((s_total, rounds, n_max, k_elems), dtype=np.float32)
    mask = np.zeros((s_total, n_max), dtype=bool)
    id_bits = np.zeros((s_total,), dtype=np.int64)
    # per-worker miss probabilities (padded rows are masked out in the
    # cores, so their entries are inert)
    p_miss = np.zeros((s_total, n_max), dtype=np.float32)
    n_channels = np.zeros((s_total,), dtype=np.int32)
    for i, (s, h) in enumerate(zip(scenarios, h_by_scenario)):
        h = np.asarray(h, dtype=np.float32)
        if h.shape != (rounds, s.n_workers, k_elems):
            raise ValueError(
                f"scenario {s.name!r}: h shape {h.shape} != "
                f"{(rounds, s.n_workers, k_elems)}")
        h_pad[i, :, :s.n_workers, :] = h
        mask[i, :s.n_workers] = True
        id_bits[i] = ocs.host_id_bits(s.n_workers)
        p_miss[i, :s.n_workers] = s.p_miss_per_worker()
        n_channels[i] = s.n_channels

    def lanes(a: np.ndarray, sel: np.ndarray) -> torch.Tensor:
        """Per-scenario rows of ``sel``, one per (scenario, round) lane."""
        t = torch.from_numpy(np.ascontiguousarray(a[sel])).to(dev)
        return t.repeat_interleave(rounds, dim=0)

    h_dev = torch.from_numpy(h_pad).to(dev)
    # independent noise keys per (scenario, round), stable under regrouping
    keys = jr.split(jr.PRNGKey(rng_seed, device=dev),
                    s_total * rounds).reshape(s_total, rounds, 2)

    by_bits: Dict[int, List[int]] = {}
    for i, s in enumerate(scenarios):
        by_bits.setdefault(s.bits, []).append(i)

    clean, noisy = _Stacked(rounds), _Stacked(rounds)
    for bits, idx in sorted(by_bits.items()):
        sel = np.asarray(idx)
        # the scan-length bound is per bits group: a global max over all
        # scenarios would make a wide-bits cell overflow its 32-bit word on
        # the id_bits of an unrelated large-N narrow-bits cell
        max_id_bits = int(id_bits[sel].max())
        if include_clean:
            def clean_core(part):
                _DISPATCH_COUNTS["clean"] += 1
                res = ocs.ocs_maxpool_core(
                    h_dev[part].reshape(-1, n_max, k_elems),
                    lanes(mask, part), lanes(id_bits, part), bits=bits,
                    max_id_bits=max_id_bits)
                return res, _ceil_div(res.contention_slots,
                                      lanes(n_channels, part))
            clean.put(sel, _placed(clean_core, sel, n_dev, rounds, dev))
        if include_noisy:
            for ib in sorted(set(id_bits[sel].tolist())):
                sub = sel[id_bits[sel] == ib]

                def noisy_core(part):
                    _DISPATCH_COUNTS["noisy"] += 1
                    return _noisy_core(
                        h_dev[part].reshape(-1, n_max, k_elems),
                        lanes(mask, part), ib, keys[part].reshape(-1, 2),
                        lanes(p_miss, part), lanes(n_channels, part),
                        bits=bits, max_id_bits=max_id_bits,
                        max_rounds=max_rounds, backend=backend)
                noisy.put(sub, _placed(noisy_core, sub, n_dev, rounds, dev))

    out = SweepResult(scenarios=scenarios, k_elems=k_elems, rounds=rounds,
                      n_max=n_max, h=h_pad, mask=mask, device=str(dev))
    if include_clean:
        out.clean, out.clean_latency_slots = clean.result(ocs.OCSResult)
    if include_noisy:
        out.noisy, out.noisy_latency_slots = noisy.result(
            ocs.NoisyOCSResult)
    return out
