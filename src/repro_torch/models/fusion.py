"""Worker-axis fusion — the FedOCS aggregation law inside model blocks.

Every row-parallel projection of the stack produces a worker-leading
partial tensor ``partial: (N, B, S, K)``, and :func:`worker_reduce` fuses
it by the config's ``tp_fusion``:

  sum                -> the sum over workers (Megatron TP reference)
  max/max_q16/max_q8 -> the max over workers [on D-bit codes] (Eq. 4/7)
  concat             -> the concatenated partials through ``w_fuse``

:func:`worker_reduce_channel` instead pools the partials through an
explicit :class:`repro_torch.protocol.Protocol`, the simulated wireless
channel.

Under a mesh (``repro_torch.parallel.sharding.use_mesh``) whose model axis
splits the workers, ``partial`` holds this rank's ``N/R`` workers and the
fusion runs over the model group, as GSPMD lowers the JAX package's:
``max`` is ``maxpool.fwd`` over the local workers plus an all-reduce(max),
``max_q8``/``max_q16`` an all-reduce(max) of the local max codes, ``sum``
(and ``mean``) an all-reduce(sum), ``concat`` a rank-ordered all-gather.
Each rank sends one pooled tensor whatever the number of workers it
holds, but for ``concat``.  A channel site gathers the whole stack (and,
where the batch is split over the data axis, every row of it), so that
every rank runs the same contention on the same key and gets the same
winners and accounting.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import fedocs
from repro_torch.models import layers
from repro_torch.parallel import comm
from repro_torch.parallel import sharding
from repro_torch.protocol import Protocol


def fusion_init(cfg, gen: torch.Generator, k_out: int) -> dict:
    """Extra parameters required by the fusion mode (concat only)."""
    if cfg.tp_fusion == "concat":
        return {"w_fuse": layers.param(gen, (cfg.n_workers * k_out, k_out),
                                       cfg.param_dtype)}
    return {}


def fusion_axes(cfg) -> dict:
    """:func:`fusion_init`'s logical axes."""
    if cfg.tp_fusion == "concat":
        return {"w_fuse": (None, "embed")}
    return {}


def worker_axis(cfg, n_local: int):
    """The mesh axis that splits the workers of a site holding ``n_local``
    of ``cfg.n_workers``; ``None`` where the site holds them all."""
    return sharding.split_of("worker", n_local, cfg.n_workers)


def local_workers(cfg) -> int:
    """The workers a rank holds of a leaf split on ``"worker"`` under the
    active mesh: ``cfg.n_workers`` over the model axis where it divides
    them (:func:`sharding.sharding_for_shape`'s rule), else all of them."""
    axis = sharding.logical_axis("worker")
    if axis is None or cfg.n_workers % axis.size:
        return cfg.n_workers
    return cfg.n_workers // axis.size


def copy_in(axis, *tensors):
    """``tensors`` behind the model group's *f* copy where ``axis`` splits
    the workers (their gradients, each rank's share, add up over the
    group); as they are for no axis."""
    if axis is None:
        return tensors
    return tuple(comm.copy_to_group(t, axis.group) for t in tensors)


def _reduce_over(cfg, p: dict, partial: torch.Tensor, axis):
    mode = cfg.tp_fusion
    if mode == "concat":
        whole = comm.gather_from_group(partial, axis.group, 0)
        return torch.matmul(fedocs.concat(whole),
                            p["w_fuse"].to(partial.dtype))
    proto = Protocol.from_mode(mode, tie_break=cfg.tie_break)
    if proto.kind == "max":
        return fedocs.maxpool_over(partial, proto.tie_break, axis)
    if proto.kind == "ideal_max":
        return fedocs.maxpool_quantized_over(partial, proto.bits,
                                             proto.tie_break, axis)
    if proto.kind in ("sum", "mean"):
        total = comm.reduce_from_group(torch.sum(partial, dim=0), axis.group)
        return total if proto.kind == "sum" else total / cfg.n_workers
    raise NotImplementedError(f"tp_fusion {mode!r} over a model group")


def worker_reduce(cfg, p: dict, partial: torch.Tensor) -> torch.Tensor:
    """partial: (N, B, S, K) -> (B, S, K) fused output; under a mesh
    ``partial`` may hold this rank's block of the workers."""
    axis = worker_axis(cfg, partial.shape[0])
    if axis is not None:
        return _reduce_over(cfg, p, partial, axis)
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
    axis = worker_axis(cfg, partial.shape[0])
    if axis is not None:
        partial = comm.gather_from_group(partial, axis.group, 0)
    rows = sharding.batch_axis()
    if rows is None:
        return protocol.aggregate(partial, rng)
    b = partial.shape[1]
    whole = comm.gather_from_group(partial, rows.group, 1, sum_grads=True)
    out, acct = protocol.aggregate(whole, rng)
    return out.narrow(0, rows.index * b, b), acct


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
