"""Worker-axis fusion — the FedOCS aggregation law inside model blocks.

Every row-parallel projection of the stack produces a worker-leading
partial tensor ``partial: (N, B, S, K)``, and :func:`worker_reduce` fuses
it by the config's ``tp_fusion``:

  sum                -> the sum over workers (Megatron TP reference)
  max/max_q16/max_q8 -> the max over workers [on D-bit codes] (Eq. 4/7)
  concat             -> the concatenated partials through ``w_fuse``

:func:`worker_reduce_channel` instead pools the partials through an
explicit :class:`repro_torch.protocol.Protocol`, the simulated wireless
channel.  The JAX package's sharding constraints have no counterpart: the
port runs on one card.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import fedocs
from repro_torch.models import layers
from repro_torch.protocol import Protocol


def fusion_init(cfg, gen: torch.Generator, k_out: int) -> dict:
    """Extra parameters required by the fusion mode (concat only)."""
    if cfg.tp_fusion == "concat":
        return {"w_fuse": layers.param(gen, (cfg.n_workers * k_out, k_out),
                                       cfg.param_dtype)}
    return {}


def worker_reduce(cfg, p: dict, partial: torch.Tensor) -> torch.Tensor:
    """partial: (N, B, S, K) -> (B, S, K) fused output."""
    mode = cfg.tp_fusion
    if mode == "concat":
        gathered = fedocs.concat(partial)                  # (B, S, N*K)
        return torch.matmul(gathered, p["w_fuse"].to(partial.dtype))
    proto = Protocol.from_mode(mode, tie_break=cfg.tie_break)
    out, _acct = proto.aggregate(partial)
    return out


def worker_reduce_channel(cfg, p: dict, partial: torch.Tensor,
                          protocol: Protocol, rng: Optional[torch.Tensor]):
    """Fuse worker partials through the simulated wireless channel:
    ``(fused (B, S, K), ProtocolAccounting)``.  Concat protocols change
    the residual width and are refused."""
    if protocol.kind == "concat":
        raise ValueError(
            "worker_reduce_channel cannot use a concat protocol: the fused "
            "width N*K does not match the block's residual width K")
    return protocol.aggregate(partial, rng)


# -- per-tick channel-accounting accumulator: a dict of 0-d tensors --

def chan_zeros(device=None) -> dict:
    """Zeroed channel-accounting accumulator for one decode tick."""
    def z(dtype):
        return torch.zeros((), dtype=dtype, device=device)
    return {"rounds": z(torch.int32), "collisions": z(torch.int32),
            "contention_slots": z(torch.int32),
            "correct_frac_sum": z(torch.float32), "calls": z(torch.int32)}


def chan_from_acct(acct) -> dict:
    """One ``ProtocolAccounting`` as an accumulator entry (calls=1)."""
    return {"rounds": acct.rounds, "collisions": acct.collisions,
            "contention_slots": acct.contention_slots,
            "correct_frac_sum": acct.correct_frac,
            "calls": torch.ones((), dtype=torch.int32,
                                device=acct.rounds.device)}


def chan_merge(a: dict, b: dict) -> dict:
    """Elementwise sum of two accumulators (same keys, same dtypes)."""
    return {k: a[k] + b[k] for k in a}


def worker_partial(x_grouped: torch.Tensor, w: torch.Tensor,
                   spec: str = "nbsf,nfk->nbsk") -> torch.Tensor:
    """Per-worker private projection: an einsum batched over the worker
    axis."""
    return torch.einsum(spec, x_grouped, w)
