"""Top-level model API: init / forward / prefill / decode_step.

Pure functions over a ``ModelConfig`` and the value tree (plain tensors,
the JAX package's tree leaf for leaf); ``build(cfg)`` binds them into a
``types.SimpleNamespace``, as the JAX package does (a namespace, not an
``nn.Module``: the parameters stay a plain tree that ``convert`` fills).

Batch conventions
-----------------
train (token frontend)   {"tokens": (B,S) int, "targets": (B,S) int}
                         -> (loss, metrics)
train (patch/audio)      {"feats": (B,S,Df) float, "targets": (B,S) int};
                         the encoder-decoder adds {"tokens": (B,S_dec)
                         int} and its targets align with the decoder
                         tokens
prefill                  the same minus targets -> (last_logits (B,V),
                         cache)
decode                   (token (B,1) int, positions (B,) int, cache)

The decode functions update the cache in place (an attention layer's KV
rows, a recurrent layer's state) and return it; an encoder-decoder's
cross cache holds the encoder's keys and values from the prefill.
``axes()`` is the parameters' logical axes, the tree of the JAX package's
``split_tree(init(...))[1]``; ``cache_axes`` is the same of a decode
cache, and ``input_specs`` gives every input of a dry-run cell as a meta
tensor (shape and type, nothing allocated) with its logical axes.

Under a mesh (``repro_torch.parallel.sharding.use_mesh``) the entry
points take this rank's blocks of the parameters and the whole batch,
whose rows they split over the data axis where it divides them.  The
loss is a vocabulary-parallel log-sum-exp over the model group, each
data rank's rows summed over the global token count and added over the
data group, so every rank returns the whole loss; ``prefill`` and the
decode steps gather the logits over both axes, so every rank samples the
same token from the same key.  A decode cache holds this rank's block,
as the JAX package's ``CACHE_AXES`` place it
(``sharding.cache_splits``): its rows where the batch axis splits them,
its block of the sequence where ``kv_seq`` does (the long-context
rules), its workers of a recurrent state; ``cache_init`` allocates that
block, ``prefill`` returns it and the decode steps take it, with the
whole batch's tokens and positions.  Every config runs so: the MoE
experts, the mLSTM and mamba workers (and their states), the heads of
self- and cross-attention, the workers and the vocabulary are split over
the model axis where it divides them; the router, the sLSTM and the
frontend's projection run whole on every rank.  A cache's rows lie along
each leaf's own batch axis (:func:`cache_rows`).
"""

from __future__ import annotations

import functools
import types
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import layers, transformer
from repro_torch.parallel import comm
from repro_torch.parallel import sharding

WHISPER_DECODER_LEN = 448   # whisper's real positional cap for train targets


def init(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters on ``gen``'s device, in the JAX package's tree."""
    p: Dict[str, Any] = {
        "embed": layers.embed_init(cfg, gen),
        "blocks": transformer.stack_init(cfg, gen, cfg.layer_plan(),
                                         cfg.n_periods,
                                         cross=cfg.encoder_decoder),
        "final_norm": layers.norm_init(cfg, gen),
    }
    p.update(layers.unembed_init(cfg, gen))
    if cfg.encoder_decoder:
        enc_plan = cfg.encoder_layer_plan()
        assert cfg.n_encoder_layers % len(enc_plan) == 0
        p["encoder"] = transformer.stack_init(
            cfg, gen, enc_plan, cfg.n_encoder_layers // len(enc_plan))
        p["encoder_norm"] = layers.norm_init(cfg, gen)
    return p


def axes(cfg: ModelConfig) -> dict:
    """The logical axes of every leaf of :func:`init`'s tree."""
    p: Dict[str, Any] = {
        "embed": layers.embed_axes(cfg),
        "blocks": transformer.stack_axes(cfg, cfg.layer_plan(),
                                         cross=cfg.encoder_decoder),
        "final_norm": layers.norm_axes(cfg),
    }
    p.update(layers.unembed_axes(cfg))
    if cfg.encoder_decoder:
        p["encoder"] = transformer.stack_axes(cfg,
                                              cfg.encoder_layer_plan())
        p["encoder_norm"] = layers.norm_axes(cfg)
    return p


def _whole_logits(cfg, logits: torch.Tensor, rows) -> torch.Tensor:
    """Logits (b, V_local) -> (B, V) on every rank: the vocabulary
    gathered over the model group, then the rows over the data group, in
    rank order."""
    vocab = layers.vocab_axis(cfg, logits.shape[-1])
    if vocab is not None:
        logits = comm.gather_from_group(logits, vocab.group, -1)
    if rows is not None:
        logits = comm.gather_from_group(logits, rows.group, 0,
                                        sum_grads=True)
    return logits


def _head(v: dict) -> dict:
    return {k: v[k] for k in ("head",) if k in v}


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, s = x.shape[:2]
    return torch.arange(s, dtype=torch.int32,
                        device=x.device)[None].expand(b, s)


def _add_abs_pos(cfg, x: torch.Tensor) -> torch.Tensor:
    """``x`` plus the sinusoidal positions cast to its type (with
    ``cfg.use_abs_pos``)."""
    if not cfg.use_abs_pos:
        return x
    pe = layers.sinusoidal_positions(x.shape[1], cfg.d_model, x.device)
    return x + pe.to(x.dtype)[None]


def _embed_inputs(cfg, v, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x (B,S,d), positions (B,S) int32): the decoder's tokens
    (token frontend, encoder-decoder) or the projected features."""
    if cfg.encoder_decoder or cfg.frontend == "token":
        x = layers.embed_tokens(cfg, v["embed"], batch["tokens"])
    else:
        x = layers.embed_frontend(cfg, v["embed"], batch["feats"])
    return _add_abs_pos(cfg, x), _positions(x)


def _encode(cfg, v, feats: torch.Tensor) -> torch.Tensor:
    """The encoder's output (B, S_enc, d) over the projected features."""
    x = _add_abs_pos(cfg, layers.embed_frontend(cfg, v["embed"], feats))
    x, _ = transformer.stack_full(cfg, v["encoder"], x, _positions(x),
                                  cfg.encoder_layer_plan())
    return layers.norm_apply(cfg, v["encoder_norm"], x)


def _enc_out(cfg, v, batch):
    return _encode(cfg, v, batch["feats"]) if cfg.encoder_decoder else None


def forward(cfg, v, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward to final hidden states. Returns (x, aux_loss)."""
    enc_out = _enc_out(cfg, v, batch)
    x, positions = _embed_inputs(cfg, v, batch)
    x, aux = transformer.stack_full(cfg, v["blocks"], x, positions,
                                    cfg.layer_plan(), enc_out=enc_out)
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


def _logz_gold(cfg, logits: torch.Tensor, targets: torch.Tensor):
    """(logsumexp, the target's logit) of logits (b, c, V) whole, or of
    this rank's vocabulary block: a local max and an all-reduce(max), a
    local sum of exps and an all-reduce(sum), and the target's logit from
    the rank that holds it (all-reduce(sum) of the masked gathers)."""
    axis = layers.vocab_axis(cfg, logits.shape[-1])
    if axis is None:
        return (torch.logsumexp(logits, dim=-1),
                _Gold.apply(logits, targets[..., None].long())[..., 0])
    rows = logits.shape[-1]
    top = comm.all_reduce(logits.detach().amax(-1), "max", axis.group)
    sumexp = torch.sum(torch.exp(logits - top[..., None]), dim=-1)
    logz = top + torch.log(comm.reduce_from_group(sumexp, axis.group))
    local = targets.long() - axis.index * rows
    mine = (local >= 0) & (local < rows)
    gold = _Gold.apply(logits, local.clamp(0, rows - 1)[..., None])[..., 0]
    gold = torch.where(mine, gold, torch.zeros((), dtype=gold.dtype,
                                               device=gold.device))
    return logz, comm.reduce_from_group(gold, axis.group)


def _xent(cfg, v, x: torch.Tensor, targets: torch.Tensor,
          ways: int = 1) -> torch.Tensor:
    """Cross-entropy over the unembedding, chunked over the sequence.

    Chunks of ``cfg.loss_chunk`` positions (the whole sequence where that
    does not divide it) bound the live float32 logits to (B, chunk, V);
    each chunk adds ``sum(logsumexp - gold)`` in float32, in order, as the
    JAX package's scan does, and the total is divided by ``B * S``, with
    ``B`` the rows of all ``ways`` data blocks."""
    b, s, _ = x.shape
    chunk = cfg.loss_chunk
    if s % chunk != 0:
        chunk = s
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, s, chunk):
        logits = layers.unembed_apply(cfg, _head(v), v["embed"],
                                      x[:, lo:lo + chunk])
        logz, gold = _logz_gold(cfg, logits, targets[:, lo:lo + chunk])
        total = total + torch.sum(logz - gold)
    return total / (b * ways * s)


def _batch_rows(batch) -> int:
    return tree.leaves(batch)[0].shape[0]


def _entry(fn):
    """A model entry point ``fn(cfg, v, batch_or_token, ...)`` under
    ``sharding.fsdp_scope(v)``: the parameters that the leaf shardings
    split over the fsdp axis are gathered where they are used, the stacked
    ones a period at a time (``transformer.stack_full``) and the others
    (embedding, norms, head) as the call starts, under the batch split of
    the call's rows (the leading axis of its first input)."""
    @functools.wraps(fn)
    def entry(cfg, v, *args, **kwargs):
        with sharding.fsdp_scope(v):
            with sharding.split_batch(_batch_rows(args[0])):
                v = {k: sub if k in ("blocks", "encoder")
                     else tree.map(sharding.fsdp_whole, sub)
                     for k, sub in v.items()}
            return fn(cfg, v, *args, **kwargs)
    return entry


@_entry
def loss_fn(cfg, v, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training loss ``nll + router_aux_weight * aux`` and its metrics."""
    with sharding.split_batch(_batch_rows(batch)) as rows:
        batch = tree.map(lambda t: sharding.split_dim(t, rows), batch)
        x, aux = forward(cfg, v, batch)
        if rows is None:
            nll = _xent(cfg, v, x, batch["targets"])
        else:
            nll = comm.reduce_from_group(
                _xent(cfg, v, x, batch["targets"], rows.size), rows.group)
    loss = nll + cfg.router_aux_weight * aux
    return loss, {"nll": nll, "aux": aux, "loss": loss}


@_entry
def prefill(cfg, v, batch, max_seq: Optional[int] = None
            ) -> Tuple[torch.Tensor, dict]:
    """Returns (last-position logits (B,V), decode cache); under a mesh
    the cache is this rank's block (its rows, its ``kv_seq`` block)."""
    with sharding.split_batch(_batch_rows(batch)) as rows:
        batch = tree.map(lambda t: sharding.split_dim(t, rows), batch)
        enc_out = _enc_out(cfg, v, batch)
        x, positions = _embed_inputs(cfg, v, batch)
        max_seq = max_seq or x.shape[1]
        x, cache, _ = transformer.stack_prefill(
            cfg, v["blocks"], x, positions, cfg.layer_plan(), max_seq,
            enc_out=enc_out)
        x = layers.norm_apply(cfg, v["final_norm"], x)
        logits = layers.unembed_apply(cfg, _head(v), v["embed"], x[:, -1:])
        return _whole_logits(cfg, logits[:, 0], rows), cache


def _embed_token(cfg, v, token: torch.Tensor, positions: torch.Tensor,
                 cache: dict) -> torch.Tensor:
    """A decode step's token embedding (B, 1, d), with ``cfg.use_abs_pos``
    plus each row's sinusoidal position from a table of
    :func:`_max_pos` rows, the index clamped to the table as JAX's
    gather clamps it."""
    x = layers.embed_tokens(cfg, v["embed"], token)
    if cfg.use_abs_pos:
        rows = _max_pos(cfg, cache)
        pe = layers.sinusoidal_positions(rows, cfg.d_model, x.device)
        at = positions.long().clamp(max=rows - 1)
        x = x + pe.to(x.dtype)[at][:, None]
    return x


@_entry
def decode_step(cfg, v, token: torch.Tensor, positions: torch.Tensor,
                cache: dict) -> Tuple[torch.Tensor, dict]:
    """token: (B,1) int; positions: (B,) current write index.  Under a
    data split each rank writes the cache rows of its block."""
    with sharding.split_batch(token.shape[0]) as rows:
        token, pos, part = _decode_rows(cfg, token, positions, cache, rows)
        x = _embed_token(cfg, v, token, pos, part)
        x, _, _ = transformer.stack_step(cfg, v["blocks"], x, pos,
                                         part, cfg.layer_plan())
        x = layers.norm_apply(cfg, v["final_norm"], x)
        logits = layers.unembed_apply(cfg, _head(v), v["embed"], x)[:, 0]
        return _whole_logits(cfg, logits, rows), cache


def _decode_rows(cfg, token, positions, cache, rows):
    """A decode step's token and positions of this rank's data block (all
    of them without a data split), and the cache, which holds that
    block's rows already (:func:`cache_init`)."""
    leaf = tree.leaves(cache)[0]
    held = leaf.shape[tree.leaves(cache_rows(cfg, cache))[0]]
    want = sharding.local_size(token.shape[0], rows)
    if held != want:
        raise ValueError(
            f"a decode step of {token.shape[0]} rows takes a cache of "
            f"this rank's {want} (cache_init under the mesh), not {held}")
    if rows is None:
        return token, positions, cache
    return (sharding.split_dim(token, rows),
            sharding.split_dim(positions, rows), cache)


@_entry
def decode_step_channel(cfg, v, token: torch.Tensor, positions: torch.Tensor,
                        cache: dict, protocol, rng: torch.Tensor
                        ) -> Tuple[torch.Tensor, dict, dict]:
    """:func:`decode_step` with the wireless channel in the loop.

    Every mlp fusion of the stack aggregates the per-worker partials
    through ``protocol`` under the sensing key ``rng``; the mixers'
    fusions stay on the ideal ``tp_fusion``.  Returns ``(logits, cache,
    chan)``, ``chan`` the summed channel-accounting dict over the tick's
    :func:`channel_sites` aggregate calls."""
    with sharding.split_batch(token.shape[0]) as rows:
        token, pos, part = _decode_rows(cfg, token, positions, cache, rows)
        x = _embed_token(cfg, v, token, pos, part)
        x, _, _, chan = transformer.stack_step(
            cfg, v["blocks"], x, pos, part, cfg.layer_plan(),
            protocol=protocol, rng=rng)
        x = layers.norm_apply(cfg, v["final_norm"], x)
        logits = layers.unembed_apply(cfg, _head(v), v["embed"], x)[:, 0]
        return _whole_logits(cfg, logits, rows), cache, chan


def channel_sites(cfg) -> int:
    """Channel aggregate calls per decode tick: one per mlp-FFN layer."""
    return cfg.n_periods * sum(1 for _, ffn in cfg.layer_plan()
                               if ffn == "mlp")


def _max_pos(cfg, cache) -> int:
    """The rows of the sinusoid table a decode step reads from: the
    sequence length of the first stacked attention cache (layers, B, S,
    kv_heads, head_dim) in the JAX package's leaf order, which sorts
    ``"cross"`` before ``"self"``; so for an encoder-decoder it is the
    encoder's length, as in the JAX package (ROADMAP queue 3).  Under a
    ``kv_seq`` split the leaf holds a block: the whole length is its
    length times the axis's ranks."""
    for leaf in tree.leaves(cache):
        if (leaf.ndim == 5 and leaf.shape[-2] == cfg.n_kv_heads
                and leaf.shape[-1] == cfg.head_dim_):
            seq = sharding.kv_seq_axis()
            return leaf.shape[2] * (1 if seq is None else seq.size)
    return 32768


def cache_init(cfg, batch: int, max_seq: int, device=None,
               cross_len: int = 0) -> dict:
    """The decode cache of ``batch`` rows and ``max_seq`` positions (an
    encoder-decoder's cross cache of ``cross_len``); under a mesh only
    this rank's block of it (:func:`sharding.cache_splits`)."""
    rows, seq = sharding.cache_splits(batch, max_seq)
    cross = sharding.cache_splits(batch, cross_len)[1] if cross_len else None
    return transformer.stack_cache_init(
        cfg, cfg.layer_plan(), cfg.n_periods,
        sharding.local_size(batch, rows), sharding.local_size(max_seq, seq),
        cfg.dtype, device, sharding.local_size(cross_len, cross))


def cache_axes(cfg) -> dict:
    """The logical axes of every leaf of :func:`cache_init`'s cache."""
    return transformer.stack_cache_axes(cfg, cfg.layer_plan(),
                                        cfg.encoder_decoder)


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(specs, logical axes) of every model input of a dry-run cell: the
    specs are meta tensors of the global shapes and types."""
    b, s = shape.global_batch, shape.seq_len

    def spec(dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")

    specs: Dict[str, Any] = {}
    axes: Dict[str, Any] = {}
    if shape.kind == "decode":
        specs["token"], axes["token"] = spec((b, 1)), ("batch", None)
        specs["positions"], axes["positions"] = spec((b,)), ("batch",)
        with sharding.use_mesh(None):       # the whole cache
            specs["cache"] = cache_init(
                cfg, b, s, device="meta",
                cross_len=s if cfg.encoder_decoder else 0)
        axes["cache"] = cache_axes(cfg)
        return specs, axes
    if shape.kind not in ("train", "prefill"):
        raise ValueError(shape.kind)
    seq = min(WHISPER_DECODER_LEN, s) if cfg.encoder_decoder else s
    if cfg.encoder_decoder or cfg.frontend != "token":
        specs["feats"] = spec((b, s, cfg.frontend_dim), torch.bfloat16)
        axes["feats"] = ("batch", "seq", None)
    if cfg.encoder_decoder or cfg.frontend == "token":
        specs["tokens"], axes["tokens"] = spec((b, seq)), ("batch", "seq")
    if shape.kind == "train":
        specs["targets"], axes["targets"] = spec((b, seq)), ("batch", "seq")
    return specs, axes


def cache_rows(cfg, cache: dict) -> dict:
    """The batch axis of each leaf of a stacked decode cache."""
    return transformer.cache_rows(cfg.layer_plan(), cache)


def min_prompt(cfg) -> int:
    """The fewest prompt tokens a prefill can build the cache from."""
    return transformer.min_prompt(cfg, cfg.layer_plan())


def recurrent_leaves(cfg, cache: dict) -> list:
    """The recurrent-state tensors of a ``cache_init`` cache, which a
    decode step overwrites whole."""
    return transformer.recurrent_leaves(cfg.layer_plan(), cache)


def build(cfg: ModelConfig) -> types.SimpleNamespace:
    return types.SimpleNamespace(
        cfg=cfg,
        init=functools.partial(init, cfg),
        axes=functools.partial(axes, cfg),
        loss=functools.partial(loss_fn, cfg),
        logits=functools.partial(logits_fn, cfg),
        forward=functools.partial(forward, cfg),
        prefill=functools.partial(prefill, cfg),
        decode_step=functools.partial(decode_step, cfg),
        decode_step_channel=functools.partial(decode_step_channel, cfg),
        channel_sites=functools.partial(channel_sites, cfg),
        cache_init=functools.partial(cache_init, cfg),
        cache_axes=functools.partial(cache_axes, cfg),
        cache_rows=functools.partial(cache_rows, cfg),
        input_specs=functools.partial(input_specs, cfg),
        min_prompt=functools.partial(min_prompt, cfg),
        recurrent_leaves=functools.partial(recurrent_leaves, cfg),
    )
