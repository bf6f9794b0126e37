"""Named wireless scenarios for the OCS sweep engine (the JAX package's
``sim/scenarios.py``: the same registry, names and validation).

A :class:`Scenario` pins the protocol-side knobs the paper argues over:
worker count N, backoff quantization depth D (``bits``), the imperfect
carrier-sensing miss probability, and the number of orthogonal OFDMA
channels (paper §III ref [16]).

The registry gives reproducible names to the operating points the
benchmarks report; :func:`scenario_grid` builds dense cartesian grids for
``repro_torch.sim.sweep.run_sweep``.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.ocs import host_id_bits
from repro_torch.protocol import Protocol

PMiss = Union[float, Tuple[float, ...]]


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Hashable fault-process parameters of one scenario (plain floats;
    :meth:`model` builds the ``repro_torch.faults.FaultModel``).

    ``burst_len``/``gap_len`` are the Gilbert–Elliott mean sojourns (frames
    spent in the bad/good sensing state), ``p_miss_bad``/``p_miss_good``
    the per-state miss probabilities, ``p_drop``/``p_recover`` the worker
    dropout/recovery rates, and ``policy``/``retry_budget`` the degrade
    policy applied when a frame resolves nothing.
    """

    burst_len: float = 4.0
    gap_len: float = 16.0
    p_miss_bad: float = 0.5
    p_miss_good: float = 0.0
    p_drop: float = 0.0
    p_recover: float = 0.25
    policy: str = "stale"
    retry_budget: int = 0

    def __post_init__(self):
        if self.burst_len < 1.0 or self.gap_len < 1.0:
            raise ValueError("burst_len/gap_len are mean sojourns >= 1")
        for p in (self.p_miss_bad, self.p_miss_good, self.p_drop,
                  self.p_recover):
            if not (0.0 <= p <= 1.0):
                raise ValueError(f"fault probabilities must be in [0, 1], "
                                 f"got {p}")

    def model(self):
        """The ``repro_torch.faults.FaultModel`` of this spec."""
        from repro_torch import faults    # faults -> core, not the reverse
        policy = (faults.DegradePolicy.retry(self.retry_budget)
                  if self.policy == "retry"
                  else faults.DegradePolicy(kind=self.policy))
        fm = faults.FaultModel.burst(
            burst_len=self.burst_len, gap_len=self.gap_len,
            p_miss_bad=self.p_miss_bad, p_miss_good=self.p_miss_good,
            policy=policy)
        if self.p_drop > 0.0:
            fm = fm.with_dropout(self.p_drop, self.p_recover)
        return fm


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One operating point of the wireless max-pooling channel.

    ``p_miss`` is one probability shared by every worker or a per-worker
    tuple of length ``n_workers`` (heterogeneous near/far users: a far
    worker overhears blocking signals with lower probability, so its entry
    is larger).
    """

    name: str
    n_workers: int
    bits: int = 16          # D, backoff quantization depth (paper Eq. 7)
    p_miss: PMiss = 0.0     # per-sub-slot carrier-sensing miss probability
    n_channels: int = 1     # orthogonal OFDMA channels (latency divider)
    fault: Optional[FaultSpec] = None   # bursty/dropout fault process
    #   (None = the plain i.i.d. p_miss channel; see repro_torch.faults)

    def __post_init__(self):
        if self.n_workers < 1:
            raise ValueError(f"{self.name}: n_workers must be >= 1")
        if not (1 <= self.bits <= 32):
            raise ValueError(f"{self.name}: bits must be in [1, 32]")
        if self.bits + host_id_bits(self.n_workers) > 32:
            raise ValueError(
                f"{self.name}: bits={self.bits} + "
                f"{host_id_bits(self.n_workers)} tie-break bits overflow the "
                f"32-bit contention word (reduce bits or n_workers)")
        if isinstance(self.p_miss, (list, tuple)):
            object.__setattr__(self, "p_miss", tuple(
                float(p) for p in self.p_miss))
            if len(self.p_miss) != self.n_workers:
                raise ValueError(
                    f"{self.name}: per-worker p_miss needs "
                    f"{self.n_workers} entries, got {len(self.p_miss)}")
        for p in self.p_miss_per_worker():
            if not (0.0 <= p < 1.0):
                raise ValueError(f"{self.name}: p_miss must be in [0, 1)")
        if self.n_channels < 1:
            raise ValueError(f"{self.name}: n_channels must be >= 1")

    def p_miss_per_worker(self) -> Tuple[float, ...]:
        """Broadcast ``p_miss`` to one probability per worker."""
        if isinstance(self.p_miss, tuple):
            return self.p_miss
        return (float(self.p_miss),) * self.n_workers

    def protocol(self, max_rounds: int = 3,
                 backend: str = "scan") -> Protocol:
        """This operating point as a ``Protocol``: ``p_miss`` bound (the
        scalar, or the per-worker vector), ``payload_bits`` pinned to 32 —
        sweep cells follow the paper's §IV accounting, where the D-bit
        codes drive contention only and the winner sends its full float
        (``OCSResult.value``), unlike the training curves' protocol, whose
        winner sends the D-bit code."""
        p = (np.asarray(self.p_miss, np.float32)
             if isinstance(self.p_miss, tuple)
             else np.float32(self.p_miss))
        return Protocol.ocs(bits=self.bits, p_miss=p,
                            max_rounds=max_rounds, backend=backend,
                            n_channels=self.n_channels, payload_bits=32)


_REGISTRY: Dict[str, Scenario] = {}


def register(scenario: Scenario, overwrite: bool = False) -> Scenario:
    """Add a scenario to the global registry (name must be unique)."""
    if not overwrite and scenario.name in _REGISTRY:
        raise ValueError(f"scenario {scenario.name!r} already registered")
    _REGISTRY[scenario.name] = scenario
    return scenario


def get(name: str) -> Scenario:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; known: {sorted(_REGISTRY)}") from None


def names() -> List[str]:
    return sorted(_REGISTRY)


def scenario_grid(n_workers: Sequence[int],
                  bits: Sequence[int] = (16,),
                  p_miss: Sequence[float] = (0.0,),
                  n_channels: Sequence[int] = (1,),
                  name_prefix: str = "grid") -> List[Scenario]:
    """Dense cartesian scenario grid: N x bits x p_miss x n_channels, with
    deterministic cell names (``grid/N16_b8_p0.02_c4``).  Not registered:
    pass it straight to ``run_sweep``."""
    return [Scenario(name=f"{name_prefix}/N{n}_b{b}_p{p:g}_c{c}",
                     n_workers=n, bits=b, p_miss=p, n_channels=c)
            for n, b, p, c in itertools.product(n_workers, bits, p_miss,
                                                n_channels)]


def near_far_p_miss(n_workers: int, p_near: float = 0.0,
                    p_far: float = 0.1) -> Tuple[float, ...]:
    """Two-tier per-worker miss profile: the first half of the workers are
    cell-center (near) users sensing at ``p_near``, the second half are
    cell-edge (far) users at ``p_far``."""
    far = n_workers // 2
    return (p_near,) * (n_workers - far) + (p_far,) * far


# ---------------------------------------------------------------------------
# default registry: the operating points the benchmarks report
# ---------------------------------------------------------------------------

for _s in (
    # clean-sensing points along the paper's O(K)-vs-O(N*K) axis
    Scenario("lab_bench",      n_workers=2),
    Scenario("small_cell",     n_workers=4),
    Scenario("campus_cell",    n_workers=16),
    Scenario("dense_cell",     n_workers=64),
    # coarser backoff codes: fewer contention slots, more ties
    Scenario("lowrate_sensor", n_workers=16, bits=8),
    Scenario("massive_iot",    n_workers=64, bits=8),
    # imperfect carrier sensing
    Scenario("noisy_urban",    n_workers=16, p_miss=0.02),
    Scenario("noisy_dense",    n_workers=64, p_miss=0.05),
    # heterogeneous near/far users: per-worker miss probabilities
    Scenario("near_far_cell",  n_workers=16,
             p_miss=near_far_p_miss(16, 0.01, 0.1)),
    Scenario("near_far_dense", n_workers=64, bits=8,
             p_miss=near_far_p_miss(64, 0.0, 0.05)),
    # OFDMA striping: same transmissions, latency / n_channels
    Scenario("ofdma_wideband", n_workers=16, n_channels=8),
    Scenario("ofdma_noisy",    n_workers=64, bits=8, p_miss=0.02, n_channels=4),
    # channel faults: bursty sensing fades and worker dropout spans with
    # explicit degradation policies
    Scenario("burst_cell",     n_workers=16,
             fault=FaultSpec(burst_len=8.0, gap_len=32.0, p_miss_bad=0.5,
                             p_miss_good=0.01, policy="stale")),
    Scenario("worker_outage_cell", n_workers=16,
             fault=FaultSpec(burst_len=4.0, gap_len=64.0, p_miss_bad=0.3,
                             p_miss_good=0.0, p_drop=0.05, p_recover=0.25,
                             policy="zero_fill")),
):
    register(_s)
