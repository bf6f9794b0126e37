"""Load generation for the serving engine: Poisson arrivals and near/far
channel mixes (the JAX package's ``serve/load.py``; the same arrays from
the same seed).

Request arrivals are a Poisson process over the engine's tick clock
(exponential inter-arrival gaps accumulated and floored to ticks); the
wireless side is the two-tier near/far cell — cell-center workers sense
cleanly, cell-edge workers miss blocking signals more often — bound as the
per-worker ``p_miss`` of one OCS :class:`~repro_torch.protocol.Protocol`.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.protocol import Protocol
from repro_torch.serve.engine import Request
from repro_torch.sim.scenarios import near_far_p_miss  # noqa: F401


def poisson_requests(n_requests: int, rate_per_tick: float,
                     vocab_size: int, prompt_len: int = 8,
                     max_new_tokens: int = 16, seed: int = 0,
                     ) -> List[Request]:
    """A Poisson request stream over the engine's tick clock: iid
    Exponential(1/lambda) gaps, accumulated and floored to integer
    ``arrival_tick``s; prompts of uniform random token ids.  Deterministic
    in ``seed``."""
    if n_requests < 1:
        raise ValueError("n_requests must be >= 1")
    if rate_per_tick <= 0:
        raise ValueError("rate_per_tick must be > 0")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_per_tick, n_requests)
    arrivals = np.floor(np.cumsum(gaps)).astype(np.int64)
    return [
        Request(rid=i,
                prompt=rng.integers(0, vocab_size,
                                    prompt_len).astype(np.int32),
                max_new_tokens=max_new_tokens,
                arrival_tick=int(arrivals[i]))
        for i in range(n_requests)
    ]


def near_far_protocol(n_workers: int, bits: int = 8,
                      p_near: float = 0.0, p_far: float = 0.1,
                      max_rounds: int = 3, backend: str = "scan",
                      n_channels: int = 1,
                      payload_bits: Optional[int] = None) -> Protocol:
    """An OCS protocol whose per-worker ``p_miss`` is the near/far
    profile."""
    p = np.asarray(near_far_p_miss(n_workers, p_near, p_far), np.float32)
    return Protocol.ocs(bits=bits, p_miss=p, max_rounds=max_rounds,
                        backend=backend, n_channels=n_channels,
                        payload_bits=payload_bits)
