"""Channel-aware backoff-depth scheduling across training (``BitsSchedule``).

The quantization depth D (``Protocol.bits``) is fixed within one training
step.  A :class:`BitsSchedule` declares a small set of candidate depths
and a policy that picks the next step's depth from the telemetry the
contention already returns (collisions, rounds, winner-correctness);
``repro_torch.sim.train_curves.run_scheduled_curves`` runs each step at
the depth the policy chose.

Policy contract (torch tensors on the run's device):

  * ``init_state(device) -> state`` — tensors carried across the steps;
  * ``update(state, telemetry) -> (state, index)`` — consume one step's
    telemetry (a dict of float32 scalars: ``collision_frac``, the
    fraction of the step's ``K * max_rounds`` re-contention opportunities
    that collided, in [0, 1]; ``rounds``; ``correct_frac``) and emit the
    *next* step's candidate index (an int32 scalar into ``candidates``).

``FixedBits`` is the degenerate schedule (always the same depth: a
scheduled run with it trains bit for bit a plain ``run_curves`` lane).
``CollisionAdaptiveBits`` tracks an EMA of the collision fraction and
escalates to a deeper code when contention keeps colliding, de-escalating
when the channel is quiet.  Both keep the JAX package's arithmetic: the
EMA is float32, ``decay * ema + (1 - decay) * coll`` with Python-float
constants, and the thresholds compare in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

Telemetry = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class BitsSchedule:
    """Base policy: candidate depths + a per-step update rule."""

    candidates: Tuple[int, ...]
    init_index: int = 0

    def __post_init__(self):
        if not self.candidates:
            raise ValueError("BitsSchedule needs at least one candidate")
        for b in self.candidates:
            if not (1 <= b <= 32):
                raise ValueError(f"candidate bits={b} outside [1, 32]")
        if not (0 <= self.init_index < len(self.candidates)):
            raise ValueError(
                f"init_index {self.init_index} outside the "
                f"{len(self.candidates)} candidates")

    def init_state(self, device=None):
        return torch.tensor(self.init_index, dtype=torch.int32,
                            device=device)

    def update(self, state, telemetry: Telemetry):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class FixedBits(BitsSchedule):
    """Always the same depth: ``FixedBits(bits)``.

    ``run_scheduled_curves`` with ``FixedBits(b)`` trains the exact
    trajectory of ``run_curves`` at ``bits=(b,)``."""

    def __init__(self, bits: int):
        super().__init__(candidates=(bits,), init_index=0)

    def update(self, state, telemetry: Telemetry):
        return state, torch.zeros((), dtype=torch.int32, device=state.device)


@dataclasses.dataclass(frozen=True)
class CollisionAdaptiveBits(BitsSchedule):
    """Escalate the backoff depth while collisions persist, back off when
    the channel is quiet.

    Tracks ``ema <- decay * ema + (1 - decay) * collision_frac`` and moves
    one candidate step per update: up when the EMA exceeds ``escalate``,
    down below ``deescalate``.  Deeper codes shrink the tie sets that
    collide under sensing misses, at the price of more contention
    sub-slots: the paper's Eq. 7 depth/overhead trade, driven by the
    observed channel telemetry."""

    escalate: float = 0.03
    deescalate: float = 0.005
    decay: float = 0.8

    def __init__(self, candidates: Tuple[int, ...] = (8, 16),
                 init_index: int = 0, *, escalate: float = 0.03,
                 deescalate: float = 0.005, decay: float = 0.8):
        if not (0.0 <= deescalate <= escalate):
            raise ValueError(
                f"need 0 <= deescalate ({deescalate}) <= escalate "
                f"({escalate})")
        if not (0.0 <= decay < 1.0):
            raise ValueError(f"decay must be in [0, 1), got {decay}")
        object.__setattr__(self, "escalate", float(escalate))
        object.__setattr__(self, "deescalate", float(deescalate))
        object.__setattr__(self, "decay", float(decay))
        super().__init__(candidates=tuple(candidates), init_index=init_index)

    def init_state(self, device=None):
        return {"idx": torch.tensor(self.init_index, dtype=torch.int32,
                                    device=device),
                "ema": torch.zeros((), dtype=torch.float32, device=device)}

    def update(self, state, telemetry: Telemetry):
        coll = telemetry["collision_frac"].to(torch.float32)
        ema = self.decay * state["ema"] + (1.0 - self.decay) * coll
        top = len(self.candidates) - 1
        idx = state["idx"]
        idx = torch.where(ema > self.escalate, torch.clamp(idx + 1, max=top),
                          torch.where(ema < self.deescalate,
                                      torch.clamp(idx - 1, min=0), idx))
        return {"idx": idx, "ema": ema}, idx
