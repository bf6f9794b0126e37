"""Primitive layers: initializers, norms, embeddings (tokens and the
patch/audio frontend's projection), rotary and sinusoidal positions.

The JAX package's ``models/layers.py``: a parameter is a plain tensor,
drawn from a ``torch.Generator`` whose device is where it lives, and its
logical sharding axes come from the ``*_axes`` function beside its init
(the tree the JAX package's ``split_tree`` returns).  Apply functions take
the value tree with the structure the init produced (the JAX package's
value tree, leaf for leaf, so ``repro_torch.convert`` carries its
parameters across).

Under a mesh whose model axis splits the vocabulary, a rank holds its
rows of the token table (and columns of the head): the embedding is a
masked local lookup summed over the model group, and the unembedding
gives this rank's vocabulary logits (``models/model.py`` reduces or
gathers them).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.parallel import comm
from repro_torch.parallel import sharding


def param(gen: torch.Generator, shape: Sequence[int], dtype,
          scale: Optional[float] = None, mode: str = "normal"
          ) -> torch.Tensor:
    """A parameter on ``gen``'s device.  ``scale=None`` => fan-in
    ``1/sqrt(prod(shape[:-1]))`` normal, as in the JAX package."""
    shape = tuple(int(s) for s in shape)
    if mode == "zeros":
        return torch.zeros(shape, dtype=dtype, device=gen.device)
    if mode == "ones":
        return torch.ones(shape, dtype=dtype, device=gen.device)
    if scale is None:
        fan_in = shape[0] if len(shape) == 1 else math.prod(shape[:-1])
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    v = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device) * scale
    return v.to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_init(cfg, gen: torch.Generator) -> dict:
    p = {"scale": param(gen, (cfg.d_model,), cfg.param_dtype, mode="ones")}
    if cfg.norm == "layernorm":
        p["bias"] = param(gen, (cfg.d_model,), cfg.param_dtype, mode="zeros")
    return p


def norm_axes(cfg) -> dict:
    p = {"scale": ("embed",)}
    if cfg.norm == "layernorm":
        p["bias"] = ("embed",)
    return p


def norm_apply(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm or LayerNorm in float32, cast back to ``x``'s type."""
    xf = x.float()
    if cfg.norm == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + cfg.norm_eps) * p["scale"].float()
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        out = out * p["scale"].float() + p["bias"].float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

def embed_init(cfg, gen: torch.Generator) -> dict:
    """The token table, and for the patch/audio frontends the projection
    of the precomputed features, (frontend_dim, d_model)."""
    p = {"tokens": param(gen, (cfg.vocab_size, cfg.d_model),
                         cfg.param_dtype, scale=1.0)}
    if cfg.frontend in ("patch", "audio"):
        p["frontend_proj"] = param(
            gen, (cfg.frontend_dim or cfg.d_model, cfg.d_model),
            cfg.param_dtype)
    return p


def embed_axes(cfg) -> dict:
    p = {"tokens": ("vocab", "embed")}
    if cfg.frontend in ("patch", "audio"):
        p["frontend_proj"] = (None, "embed")
    return p


def vocab_axis(cfg, n_local: int):
    """The mesh axis that splits a vocabulary of which a leaf holds
    ``n_local`` rows; ``None`` where it holds them all."""
    return sharding.split_of("vocab", n_local, cfg.vocab_size)


def embed_tokens(cfg, p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Token ids (B, S) -> (B, S, d)."""
    table = p["tokens"].to(cfg.dtype)
    axis = vocab_axis(cfg, table.shape[0])
    if axis is None:
        return F.embedding(tokens.long(), table)
    rows = table.shape[0]
    local = tokens.long() - axis.index * rows
    mine = (local >= 0) & (local < rows)
    out = F.embedding(local.clamp(0, rows - 1), table)
    out = torch.where(mine[..., None], out, torch.zeros((), dtype=out.dtype,
                                                        device=out.device))
    return comm.reduce_from_group(out, axis.group)


def embed_frontend(cfg, p: dict, feats: torch.Tensor) -> torch.Tensor:
    """Precomputed patch/frame features (B, S, frontend_dim) -> (B, S, d),
    in ``cfg.dtype``.  The modality frontend itself (ViT patcher, audio
    conv stack) is a stub, as in the JAX package: the batch carries its
    features."""
    return torch.matmul(feats.to(cfg.dtype), p["frontend_proj"].to(cfg.dtype))


def unembed_init(cfg, gen: torch.Generator) -> dict:
    if cfg.tie_embeddings:
        return {}
    return {"head": param(gen, (cfg.d_model, cfg.vocab_size),
                          cfg.param_dtype)}


def unembed_axes(cfg) -> dict:
    if cfg.tie_embeddings:
        return {}
    return {"head": ("embed", "vocab")}


def unembed_apply(cfg, p: dict, embed_params: dict,
                  x: torch.Tensor) -> torch.Tensor:
    """(B, S, d) -> (B, S, V) logits in ``cfg.logit_dtype`` (the product in
    ``cfg.dtype``, as the JAX einsum); under a vocabulary split this
    rank's ``V/R`` of them, from the input behind the *f* copy."""
    if cfg.tie_embeddings:
        w = embed_params["tokens"].to(cfg.dtype).T
    else:
        w = p["head"].to(cfg.dtype)
    axis = vocab_axis(cfg, w.shape[1])
    if axis is not None:
        x = comm.copy_to_group(x, axis.group)
    return torch.matmul(x, w).to(cfg.logit_dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(cfg, head_dim: int, device=None) -> torch.Tensor:
    rot = int(head_dim * cfg.rotary_frac) // 2 * 2
    expo = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / torch.pow(cfg.rope_theta, expo)          # (rot/2,)


def apply_rope(cfg, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, Dh), positions: (B, S) int."""
    hd = x.shape[-1]
    rot = int(hd * cfg.rotary_frac) // 2 * 2
    inv = rope_freqs(cfg, hd, x.device)                    # (rot/2,)
    ang = positions[..., None].float() * inv               # (B, S, rot/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rotated = torch.stack([r1, r2], dim=-1).reshape(x_rot.shape)
    return torch.cat([rotated.to(x.dtype), x_pass], dim=-1)


def sinusoidal_positions(seq_len: int, d_model: int,
                         device=None) -> torch.Tensor:
    """(seq_len, d_model) float32 absolute positions in the JAX package's
    order of operations: angles ``pos / 10000 ** (2i / d)``, their sines
    in the even columns and cosines in the odd ones."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32,
                       device=device)[None, :]
    ang = pos / torch.pow(10000.0, dim / d_model)
    pe = torch.zeros((seq_len, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang[:, : (d_model // 2)])
    return pe


def activation(cfg, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "silu":
        return F.silu(x)
    if cfg.act == "gelu":
        return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default
    raise ValueError(cfg.act)
