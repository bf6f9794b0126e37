"""MLP (SwiGLU / GELU) block with worker-axis fusion.

Weights are stored worker-factored (paper §II notation), as in the JAX
package:
  w_gate/w_up : (worker, embed, ff_local)
  w_down      : (worker, ff_local, embed)

Each worker computes a private hidden slice and a full-width partial
output; the partials fuse through :mod:`repro_torch.models.fusion`.  Under
a mesh whose model axis splits the workers, a rank holds its workers'
weights and computes their partials from the input behind the model
group's *f* copy, so that the input's gradient adds up over the group.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import fusion, layers
from repro_torch.parallel import comm


def mlp_init(cfg, gen: torch.Generator, d_ff: int | None = None) -> dict:
    d_ff = d_ff or cfg.d_ff
    n = cfg.n_workers
    assert d_ff % n == 0, (cfg.name, d_ff, n)
    f_local = d_ff // n
    p = {
        "w_up": layers.param(gen, (n, cfg.d_model, f_local), cfg.param_dtype,
                             scale=cfg.d_model ** -0.5),
        "w_down": layers.param(gen, (n, f_local, cfg.d_model),
                               cfg.param_dtype, scale=d_ff ** -0.5),
    }
    if cfg.act == "silu":
        p["w_gate"] = layers.param(gen, (n, cfg.d_model, f_local),
                                   cfg.param_dtype,
                                   scale=cfg.d_model ** -0.5)
    p.update(fusion.fusion_init(cfg, gen, cfg.d_model))
    return p


def mlp_axes(cfg) -> dict:
    """:func:`mlp_init`'s logical axes."""
    p = {"w_up": ("worker", "embed", "ff_local"),
         "w_down": ("worker", "ff_local", "embed")}
    if cfg.act == "silu":
        p["w_gate"] = ("worker", "embed", "ff_local")
    p.update(fusion.fusion_axes(cfg))
    return p


def worker_partials(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) -> the per-worker partial outputs (N, B, S, d): one
    batched product per weight, the input broadcast over the workers."""
    d = cfg.dtype
    b, s, e = x.shape
    axis = fusion.worker_axis(cfg, p["w_up"].shape[0])
    if axis is not None:
        x = comm.copy_to_group(x, axis.group)
    xs = x.reshape(1, b * s, e)
    up = torch.matmul(xs, p["w_up"].to(d))                 # (N, BS, f)
    if "w_gate" in p:
        gate = torch.matmul(xs, p["w_gate"].to(d))
        hidden = F.silu(gate) * up
    else:
        hidden = layers.activation(cfg, up)
    partial = torch.matmul(hidden, p["w_down"].to(d))      # (N, BS, d)
    return partial.reshape(-1, b, s, partial.shape[-1])


def mlp_apply(cfg, p: dict, x: torch.Tensor, protocol=None, rng=None):
    """x: (B, S, d) -> (B, S, d).

    With ``protocol=None`` the worker partials fuse by the config's
    ``tp_fusion``.  With a :class:`repro_torch.protocol.Protocol` they pool
    through the simulated channel under the sensing key ``rng`` and the
    call returns ``(out, ProtocolAccounting)``.
    """
    partial = worker_partials(cfg, p, x)
    if protocol is None:
        return fusion.worker_reduce(cfg, p, partial)
    return fusion.worker_reduce_channel(cfg, p, partial, protocol, rng)
