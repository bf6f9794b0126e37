"""Top-level model API: init / forward / prefill / decode_step.

Pure functions over a ``ModelConfig`` and the value tree (plain tensors,
the JAX package's tree leaf for leaf); ``build(cfg)`` binds them into a
``types.SimpleNamespace``, as the JAX package does (a namespace, not an
``nn.Module``: the parameters stay a plain tree that ``convert`` fills).

Batch conventions (token frontend)
----------------------------------
train    {"tokens": (B,S) int, "targets": (B,S) int} -> (loss, metrics)
prefill  {"tokens": (B,S) int} -> (last_logits (B,V), cache)
decode   (token (B,1) int, positions (B,) int, cache)

The decode functions update the cache in place (an attention layer's KV
rows, a recurrent layer's state) and return it.
``input_specs`` comes with the dry-run (ROADMAP queue 1, item 19).
"""

from __future__ import annotations

import functools
import types
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, check_ported
from repro_torch.models import layers, transformer

WHISPER_DECODER_LEN = 448   # whisper's real positional cap for train targets


def init(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters on ``gen``'s device, in the JAX package's tree."""
    check_ported(cfg)
    p: Dict[str, Any] = {
        "embed": layers.embed_init(cfg, gen),
        "blocks": transformer.stack_init(cfg, gen, cfg.layer_plan(),
                                         cfg.n_periods),
        "final_norm": layers.norm_init(cfg, gen),
    }
    p.update(layers.unembed_init(cfg, gen))
    return p


def _head(v: dict) -> dict:
    return {k: v[k] for k in ("head",) if k in v}


def _embed_inputs(cfg, v, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x (B,S,d), positions (B,S) int32)."""
    tokens = batch["tokens"]
    x = layers.embed_tokens(cfg, v["embed"], tokens)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    return x, positions


def forward(cfg, v, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward to final hidden states. Returns (x, aux_loss)."""
    x, positions = _embed_inputs(cfg, v, batch)
    x, aux = transformer.stack_full(cfg, v["blocks"], x, positions,
                                    cfg.layer_plan())
    return layers.norm_apply(cfg, v["final_norm"], x), aux


def logits_fn(cfg, v, batch) -> torch.Tensor:
    x, _ = forward(cfg, v, batch)
    return layers.unembed_apply(cfg, _head(v), v["embed"], x)


class _Gold(torch.autograd.Function):
    """``logits[..., targets]`` (targets ``(..., 1)``) whose backward
    writes each row's one cotangent with ``scatter_``: no accumulation, so
    it is deterministic by construction, where ``gather``'s own backward
    is a ``scatter_add_`` (atomics on CUDA)."""

    @staticmethod
    def forward(ctx, logits, targets):
        ctx.save_for_backward(targets)
        ctx.shape = logits.shape
        return logits.gather(-1, targets)

    @staticmethod
    def backward(ctx, g):
        (targets,) = ctx.saved_tensors
        grad = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        return grad.scatter_(-1, targets, g), None


def _xent(cfg, v, x: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Cross-entropy over the unembedding, chunked over the sequence.

    Chunks of ``cfg.loss_chunk`` positions (the whole sequence where that
    does not divide it) bound the live float32 logits to (B, chunk, V);
    each chunk adds ``sum(logsumexp - gold)`` in float32, in order, as the
    JAX package's scan does, and the total is divided by ``B * S``."""
    b, s, _ = x.shape
    chunk = cfg.loss_chunk
    if s % chunk != 0:
        chunk = s
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, s, chunk):
        logits = layers.unembed_apply(cfg, _head(v), v["embed"],
                                      x[:, lo:lo + chunk])
        logz = torch.logsumexp(logits, dim=-1)
        gold = _Gold.apply(logits, targets[:, lo:lo + chunk, None].long())
        total = total + torch.sum(logz - gold[..., 0])
    return total / (b * s)


def loss_fn(cfg, v, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training loss ``nll + router_aux_weight * aux`` and its metrics."""
    x, aux = forward(cfg, v, batch)
    nll = _xent(cfg, v, x, batch["targets"])
    loss = nll + cfg.router_aux_weight * aux
    return loss, {"nll": nll, "aux": aux, "loss": loss}


def prefill(cfg, v, batch, max_seq: Optional[int] = None
            ) -> Tuple[torch.Tensor, dict]:
    """Returns (last-position logits (B,V), decode cache)."""
    x, positions = _embed_inputs(cfg, v, batch)
    max_seq = max_seq or x.shape[1]
    x, cache, _ = transformer.stack_prefill(
        cfg, v["blocks"], x, positions, cfg.layer_plan(), max_seq)
    x = layers.norm_apply(cfg, v["final_norm"], x)
    logits = layers.unembed_apply(cfg, _head(v), v["embed"], x[:, -1:])
    return logits[:, 0], cache


def decode_step(cfg, v, token: torch.Tensor, positions: torch.Tensor,
                cache: dict) -> Tuple[torch.Tensor, dict]:
    """token: (B,1) int; positions: (B,) current write index."""
    x = layers.embed_tokens(cfg, v["embed"], token)
    x, cache, _ = transformer.stack_step(cfg, v["blocks"], x, positions,
                                         cache, cfg.layer_plan())
    x = layers.norm_apply(cfg, v["final_norm"], x)
    logits = layers.unembed_apply(cfg, _head(v), v["embed"], x)[:, 0]
    return logits, cache


def decode_step_channel(cfg, v, token: torch.Tensor, positions: torch.Tensor,
                        cache: dict, protocol, rng: torch.Tensor
                        ) -> Tuple[torch.Tensor, dict, dict]:
    """:func:`decode_step` with the wireless channel in the loop.

    Every mlp fusion of the stack aggregates the per-worker partials
    through ``protocol`` under the sensing key ``rng``; the mixers'
    fusions stay on the ideal ``tp_fusion``.  Returns ``(logits, cache,
    chan)``, ``chan`` the summed channel-accounting dict over the tick's
    :func:`channel_sites` aggregate calls."""
    x = layers.embed_tokens(cfg, v["embed"], token)
    x, cache, _, chan = transformer.stack_step(
        cfg, v["blocks"], x, positions, cache, cfg.layer_plan(),
        protocol=protocol, rng=rng)
    x = layers.norm_apply(cfg, v["final_norm"], x)
    logits = layers.unembed_apply(cfg, _head(v), v["embed"], x)[:, 0]
    return logits, cache, chan


def channel_sites(cfg) -> int:
    """Channel aggregate calls per decode tick: one per mlp-FFN layer."""
    return cfg.n_periods * sum(1 for _, ffn in cfg.layer_plan()
                               if ffn == "mlp")


def cache_init(cfg, batch: int, max_seq: int, device=None) -> dict:
    return transformer.stack_cache_init(
        cfg, cfg.layer_plan(), cfg.n_periods, batch, max_seq, cfg.dtype,
        device)


def min_prompt(cfg) -> int:
    """The fewest prompt tokens a prefill can build the cache from."""
    return transformer.min_prompt(cfg, cfg.layer_plan())


def recurrent_leaves(cfg, cache: dict) -> list:
    """The recurrent-state tensors of a ``cache_init`` cache, which a
    decode step overwrites whole."""
    return transformer.recurrent_leaves(cfg.layer_plan(), cache)


def build(cfg: ModelConfig) -> types.SimpleNamespace:
    check_ported(cfg)
    return types.SimpleNamespace(
        cfg=cfg,
        init=functools.partial(init, cfg),
        loss=functools.partial(loss_fn, cfg),
        logits=functools.partial(logits_fn, cfg),
        forward=functools.partial(forward, cfg),
        prefill=functools.partial(prefill, cfg),
        decode_step=functools.partial(decode_step, cfg),
        decode_step_channel=functools.partial(decode_step_channel, cfg),
        channel_sites=functools.partial(channel_sites, cfg),
        cache_init=functools.partial(cache_init, cfg),
        min_prompt=functools.partial(min_prompt, cfg),
        recurrent_leaves=functools.partial(recurrent_leaves, cfg),
    )
