"""The paper's hierarchical vertical learner (§II): N private encoders and a
shared fusion head, trained end to end through a pooled embedding.

Parameters are a dict ``{"encoders": [...], "head": [...]}`` of layers
``{"w", "b"}``, the JAX package's pytree: the encoder leaves carry a
leading worker axis ``(N, ...)``, so the N encoders run as one batched
``torch.matmul`` over it.  A stack of p_miss lanes adds one more leading
axis ``(L, ...)`` to every leaf; ``forward``/``loss_fn`` then take
``lanes=True`` and return one loss and one set of metrics per lane.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import channel
from repro_torch.protocol import Protocol


@dataclasses.dataclass(frozen=True)
class VerticalConfig:
    n_workers: int = 4
    input_dim: int = 784                 # per-worker view dimension (x_n)
    encoder_dims: Sequence[int] = (512, 256, 128)
    embed_dim: int = 64                  # K — the transmitted feature width
    head_dims: Sequence[int] = (128, 256, 512)
    output_dim: int = 784                # recon: global dim / cls: |C|
    task: str = "reconstruction"         # "reconstruction" | "classification"
    # the fusion protocol, or (legacy sugar) a fedocs.VALID_MODES string
    # resolved with the tie_break/noise_* fields by resolve_protocol()
    aggregation: Union[str, Protocol] = "max"
    tie_break: str = "all"
    noise_bits: int = 16                 # max_noisy: backoff/payload depth D
    noise_max_rounds: int = 3            # max_noisy: re-contention bound
    noise_backend: str = "scan"          # max_noisy: "scan" | "pallas"
    prediction_level: bool = False       # True => per-worker heads (baselines
                                         # "Avg. Workers Preds"/"Best Worker")
    dtype: torch.dtype = torch.float32

    def resolve_protocol(self) -> Protocol:
        """The configured fusion protocol as a :class:`Protocol`."""
        if isinstance(self.aggregation, Protocol):
            return self.aggregation
        return Protocol.from_mode(
            self.aggregation, tie_break=self.tie_break, bits=self.noise_bits,
            max_rounds=self.noise_max_rounds, backend=self.noise_backend)

    def head_input_dim(self) -> int:
        if self.prediction_level:
            return self.embed_dim
        return self.resolve_protocol().output_dim(self.n_workers,
                                                  self.embed_dim)


def _mlp_init(gen: torch.Generator, dims: Sequence[int], lead: tuple,
              dtype, device) -> list:
    layers = []
    for fan_in, fan_out in zip(dims[:-1], dims[1:]):
        w = torch.randn(lead + (fan_in, fan_out), generator=gen,
                        dtype=torch.float32) * math.sqrt(2.0 / fan_in)
        layers.append({"w": w.to(dtype=dtype, device=device),
                       "b": torch.zeros(lead + (fan_out,), dtype=dtype,
                                        device=device)})
    return layers


def init(cfg: VerticalConfig, seed: int = 0, device=None) -> dict:
    """He-normal weights and zero biases from a ``torch.Generator`` seeded
    with ``seed``.  These are not the JAX package's initial values (the
    port does not reproduce ``jax.random.normal``): to train from the same
    start, convert JAX's with ``repro_torch.convert.params_from_jax``."""
    gen = torch.Generator().manual_seed(seed)
    enc_dims = (cfg.input_dim, *cfg.encoder_dims, cfg.embed_dim)
    head_dims = (cfg.head_input_dim(), *cfg.head_dims, cfg.output_dim)
    head_lead = (cfg.n_workers,) if cfg.prediction_level else ()
    return {"encoders": _mlp_init(gen, enc_dims, (cfg.n_workers,),
                                  cfg.dtype, device),
            "head": _mlp_init(gen, head_dims, head_lead, cfg.dtype, device)}


def _mlp_apply(params: list, x: torch.Tensor,
               final_act: bool = False) -> torch.Tensor:
    """x @ w + b per layer, ReLU between; leading axes of the leaves
    (workers, lanes) batch the product."""
    for i, layer in enumerate(params):
        x = torch.matmul(x, layer["w"]) + layer["b"].unsqueeze(-2)
        if i < len(params) - 1 or final_act:
            x = torch.relu(x)
    return x


def embeddings(cfg: VerticalConfig, params: dict,
               views: torch.Tensor) -> torch.Tensor:
    """h_n = f_n(x_n; theta_n).  views (N, B, input_dim) -> (N, B, K), or
    (L, N, B, K) for lane-stacked parameters."""
    return _mlp_apply(params["encoders"], views)


def _fuse_forward(cfg, params, views, rng, protocol, lanes, fault=None,
                  fault_state=None):
    """(prediction, accounting-or-None, protocol-or-None,
    new-fault-state-or-None)."""
    h = embeddings(cfg, params, views)
    if cfg.prediction_level:
        preds = _mlp_apply(params["head"], h)              # (.., N, B, out)
        if cfg.task == "classification":
            preds = torch.softmax(preds, dim=-1)
        return preds.mean(dim=-3), None, None, None        # Avg. Workers Preds
    proto = protocol if protocol is not None else cfg.resolve_protocol()
    if fault is not None:
        from repro_torch import faults           # faults -> core.fedocs
        v, new_state, acct = faults.aggregate(proto, fault, fault_state, h,
                                              rng, lanes=lanes)
        return head(cfg, params, v), acct, proto, new_state
    v, acct = proto.aggregate(h, rng, lanes=lanes)
    return head(cfg, params, v), acct, proto, None


def forward(cfg: VerticalConfig, params: dict, views: torch.Tensor, *,
            rng: Optional[torch.Tensor] = None,
            protocol: Optional[Protocol] = None,
            lanes: bool = False) -> torch.Tensor:
    """views (N, B, d) -> prediction (B, output_dim), or (L, B, out) with
    ``lanes``.  The embeddings are fused by ``protocol`` (default: the
    config's); an OCS protocol also needs ``rng``."""
    pred, _, _, _ = _fuse_forward(cfg, params, views, rng, protocol, lanes)
    return pred


def per_worker_predictions(cfg: VerticalConfig, params: dict,
                           views: torch.Tensor) -> torch.Tensor:
    """(N, B, out): each worker's head on its own embedding, the "Best
    Worker Pred" baseline (``prediction_level`` configs only)."""
    if not cfg.prediction_level:
        raise ValueError("per_worker_predictions needs prediction_level")
    return _mlp_apply(params["head"], embeddings(cfg, params, views))


def head(cfg: VerticalConfig, params: dict, v: torch.Tensor) -> torch.Tensor:
    """The fusion head on the pooled embedding ``v``: (..., B, K) ->
    (..., B, output_dim)."""
    return _mlp_apply(params["head"], v)


def task_loss(cfg: VerticalConfig, pred: torch.Tensor,
              target: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """The task's loss and metrics of a prediction (one per lane when
    ``pred`` carries lane axes)."""
    if cfg.task == "reconstruction":
        # paper Eq. 2 squared error; NLL with the unit-variance /2 convention
        loss = ((pred - target) ** 2).mean(dim=(-2, -1))
        return loss, {"mse": loss, "nll": 0.5 * loss}
    if cfg.task == "classification":
        if cfg.prediction_level:
            logp = torch.log(torch.clamp(pred, min=1e-9))
        else:
            logp = torch.log_softmax(pred, dim=-1)
        tgt = target.long().expand(logp.shape[:-1])
        nll = -logp.gather(-1, tgt[..., None])[..., 0].mean(dim=-1)
        acc = (logp.argmax(dim=-1) == tgt).to(torch.float32).mean(dim=-1)
        return nll, {"nll": nll, "acc": acc}
    raise ValueError(cfg.task)


def channel_metrics(cfg: VerticalConfig, proto: Protocol, acct,
                    batch: int) -> dict:
    """The OCS channel telemetry of one aggregate call: ``chan_rounds``,
    ``chan_collision_frac`` (collided re-contention opportunities over the
    ``K * max_rounds`` available) and ``chan_correct_frac``."""
    k_total = batch * cfg.embed_dim                   # batch * K elements
    # times the reciprocal, as XLA computes the JAX package's division by
    # this constant
    return {
        "chan_rounds": acct.rounds.to(torch.float32),
        "chan_collision_frac": (acct.collisions.to(torch.float32)
                                * (1.0 / (k_total * proto.max_rounds))),
        "chan_correct_frac": acct.correct_frac,
    }


def fault_metrics(acct) -> dict:
    """The degradation telemetry of one fault-aware aggregate call."""
    return {"fault_dropped_frames": acct.dropped_frames,
            "fault_stale_age": acct.stale_age,
            "fault_offline": acct.offline_workers,
            "fault_retry_slots": acct.retry_slots,
            "fault_outage": acct.outage}


def loss_fn(cfg: VerticalConfig, params: dict, views: torch.Tensor,
            target: torch.Tensor, *, rng: Optional[torch.Tensor] = None,
            protocol: Optional[Protocol] = None, lanes: bool = False,
            fault=None, fault_state=None) -> Tuple[torch.Tensor, dict]:
    """Task loss + metrics (one per lane with ``lanes``); an OCS protocol
    adds the :func:`channel_metrics` of this step's aggregate call.

    ``fault``/``fault_state`` (a ``repro_torch.faults.FaultModel`` and the
    carried ``FaultState``, lane-stacked with ``lanes``) switch the
    aggregation to the fault-aware path: the metrics then also carry the
    evolved state under ``metrics["fault_state"]`` (not a tensor: pop it
    before logging) and the :func:`fault_metrics`."""
    pred, acct, proto, new_state = _fuse_forward(
        cfg, params, views, rng, protocol, lanes, fault, fault_state)
    loss, metrics = task_loss(cfg, pred, target)
    if acct is not None and proto.kind == "ocs":
        metrics.update(channel_metrics(cfg, proto, acct, views.shape[1]))
    if new_state is not None:
        metrics["fault_state"] = new_state
        metrics.update(fault_metrics(acct))
    return loss, metrics


def comm_load(cfg: VerticalConfig, bits: int = 16) -> channel.CommLoad:
    """Per-sample uplink/downlink accounting for the configured protocol.

    Delegates to ``Protocol.comm_load`` (D-bit code payloads for the
    quantized kinds, floats otherwise); ``bits`` only sets the contention
    depth of the plain-``max`` protocol, whose payload stays a full
    float."""
    if cfg.prediction_level:
        return channel.avg_pred_load(cfg.n_workers, cfg.output_dim)
    proto = cfg.resolve_protocol()
    if proto.kind == "max" and proto.bits != bits:
        proto = dataclasses.replace(proto, bits=bits)
    return proto.comm_load(cfg.n_workers, cfg.embed_dim)
