"""GQA attention with RoPE, a KV cache, cross-attention, and worker fusion
on the output projection (the JAX package's ``models/attention.py``).

Layouts, as in the JAX package:
  q proj   : (embed, heads, head_dim)
  k/v proj : (embed, kv_heads, head_dim)
  o proj   : (worker, heads/N, head_dim, embed) when the heads divide the
             workers ("worker" layout, fusable), else (heads, head_dim,
             embed) ("plain")
  KV cache : (batch, kv_seq, kv_heads, head_dim)

``attn_full`` runs the flash-attention kernel when ``cfg.use_flash`` is
set, under the JAX package's condition (self-attention only: a cross call
takes the plain softmax, unmasked, and no rotary positions); decode
attention (``attn_step``) is plain PyTorch, as the JAX package computes it
outside any kernel.  ``attn_step`` writes the new key and value rows into
the cache in place (the JAX package returns an updated copy): the port
keeps one cache buffer for the whole run.  A cross step reads the encoder's
keys and values, which stay as the prefill left them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import fusion, layers

NEG_INF = -1e9


def n_heads_padded(cfg) -> int:
    """Physical head count: ``pad_heads_to`` rounds the head count up
    (padded heads are zero-masked)."""
    if cfg.pad_heads_to and cfg.pad_heads_to > cfg.n_heads:
        return cfg.pad_heads_to
    return cfg.n_heads


def attn_layout(cfg) -> str:
    """'worker' when the heads divide the worker count (fusable
    out-projection); 'plain' otherwise."""
    return "worker" if n_heads_padded(cfg) % cfg.n_workers == 0 else "plain"


def attn_init(cfg, gen: torch.Generator) -> dict:
    hd = cfg.head_dim_
    n = cfg.n_workers
    hp = n_heads_padded(cfg)
    pdt = cfg.param_dtype
    p = {
        "wq": layers.param(gen, (cfg.d_model, hp, hd), pdt),
        "wk": layers.param(gen, (cfg.d_model, cfg.n_kv_heads, hd), pdt),
        "wv": layers.param(gen, (cfg.d_model, cfg.n_kv_heads, hd), pdt),
    }
    scale = 1.0 / (cfg.n_heads * hd) ** 0.5
    if attn_layout(cfg) == "worker":
        p["wo"] = layers.param(gen, (n, hp // n, hd, cfg.d_model), pdt,
                               scale=scale)
    else:
        p["wo"] = layers.param(gen, (hp, hd, cfg.d_model), pdt, scale=scale)
    if cfg.qkv_bias:
        p["bq"] = layers.param(gen, (hp, hd), pdt, mode="zeros")
        p["bk"] = layers.param(gen, (cfg.n_kv_heads, hd), pdt, mode="zeros")
        p["bv"] = layers.param(gen, (cfg.n_kv_heads, hd), pdt, mode="zeros")
    p.update(fusion.fusion_init(cfg, gen, cfg.d_model))
    return p


def init_cache(cfg, batch: int, max_seq: int, dtype, device=None) -> dict:
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", x, w)."""
    b, s, d = x.shape
    return torch.matmul(x, w.reshape(d, -1)).reshape(b, s, *w.shape[1:])


def _qkv(cfg, p, x, kv_x):
    d = cfg.dtype
    q = _proj(x, p["wq"].to(d))
    k = _proj(kv_x, p["wk"].to(d))
    v = _proj(kv_x, p["wv"].to(d))
    if "bq" in p:
        q = q + p["bq"].to(d)
        k = k + p["bk"].to(d)
        v = v + p["bv"].to(d)
    return q, k, v


def _sdpa(cfg, q, k, v, mask) -> torch.Tensor:
    """q: (B,S,H,Dh), k/v: (B,T,Kv,Dh), mask: (B, S, T) bool or None.

    The scores are float32 products of the working-type q and k (JAX's
    ``preferred_element_type``), or bfloat16 with ``scores_dtype='bf16'``;
    the probabilities are cast to ``cfg.dtype`` before P.V."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    sdt = torch.bfloat16 if cfg.scores_dtype == "bf16" else torch.float32
    qg = q.reshape(b, s, kv, g, hd)
    if sdt == torch.float32:
        scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    else:
        scores = torch.einsum("bskgd,btkd->bkgst", qg, k).to(sdt)
    scores = scores * torch.tensor(hd ** -0.5, dtype=sdt, device=q.device)
    if mask is not None:
        fill = torch.tensor(NEG_INF, dtype=torch.float32).to(sdt)
        scores = torch.where(mask[:, None, None], scores,
                             fill.to(q.device))
    smax = torch.amax(scores, dim=-1, keepdim=True).detach()
    unnorm = torch.exp((scores - smax).to(sdt))
    denom = torch.sum(unnorm.float(), dim=-1, keepdim=True)
    probs = (unnorm / denom.to(sdt)).to(cfg.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, hd)


def _project_out(cfg, p, attn_out) -> torch.Tensor:
    """(B,S,H,Dh) -> fused (B,S,d) via the configured layout."""
    b, s, h, hd = attn_out.shape
    if h != cfg.n_heads:                       # zero-mask padded heads
        head_mask = (torch.arange(h, device=attn_out.device)
                     < cfg.n_heads).to(attn_out.dtype)
        attn_out = attn_out * head_mask[None, None, :, None]
    wo = p["wo"].to(cfg.dtype)
    if attn_layout(cfg) == "plain":
        return torch.matmul(attn_out.reshape(b, s, h * hd),
                            wo.reshape(h * hd, -1))
    n = cfg.n_workers
    grouped = attn_out.reshape(b * s, n, (h // n) * hd).transpose(0, 1)
    partial = torch.matmul(grouped, wo.reshape(n, (h // n) * hd, -1))
    return fusion.worker_reduce(cfg, p, partial.reshape(n, b, s, -1))


def attn_full(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
              causal: bool = True, kv_x: Optional[torch.Tensor] = None,
              return_kv: bool = False):
    """Full-sequence attention (train / prefill). x: (B, S, d); with
    ``kv_x`` (B, T, d) cross-attention over it (the encoder's output).
    With ``return_kv`` also the keys and values, unpadded."""
    cross = kv_x is not None
    q, k, v = _qkv(cfg, p, x, kv_x if cross else x)
    if cfg.use_rope and not cross:
        q = layers.apply_rope(cfg, q, positions)
        k = layers.apply_rope(cfg, k, positions)
    if cfg.use_flash and not cross:
        # the kernel's (B,H,S,D) layout; positions are arange here, so the
        # kernel's block-causal mask is exact
        out = flash_ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal).transpose(1, 2)
    else:
        mask = None
        if causal:
            mask = positions[:, None, :] <= positions[:, :, None]  # (B,S,S)
        out = _sdpa(cfg, q, k, v, mask)
    y = _project_out(cfg, p, out)
    if return_kv:
        return y, {"k": k, "v": v}
    return y


def attn_step(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
              cache: dict, cross: bool = False) -> Tuple[torch.Tensor, dict]:
    """Single decode step. x: (B, 1, d); positions: (B,) current index;
    cache: {"k","v"} (B, S_max, Kv, Dh), entries < positions valid.  The
    new rows are written into ``cache`` in place, at ``positions``
    clamped to the cache (JAX's ``dynamic_update_slice`` clamps the
    same way), and ``cache`` is returned.  With ``cross`` the cache holds
    the encoder's keys and values: every entry is valid, no row is
    written and no rotary position applied."""
    d = cfg.dtype
    q = _proj(x, p["wq"].to(d))
    if cross:
        if "bq" in p:
            q = q + p["bq"].to(d)
        k, v = cache["k"], cache["v"]
        valid = torch.ones((x.shape[0], 1, k.shape[1]), dtype=torch.bool,
                           device=x.device)
        return _project_out(cfg, p, _sdpa(cfg, q, k, v, valid)), cache
    knew = _proj(x, p["wk"].to(d))
    vnew = _proj(x, p["wv"].to(d))
    if "bq" in p:
        q = q + p["bq"].to(d)
        knew = knew + p["bk"].to(d)
        vnew = vnew + p["bv"].to(d)
    if cfg.use_rope:
        q = layers.apply_rope(cfg, q, positions[:, None])
        knew = layers.apply_rope(cfg, knew, positions[:, None])
    k, v = cache["k"], cache["v"]
    rows = torch.arange(x.shape[0], device=x.device)
    at = positions.clamp(max=k.shape[1] - 1).long()
    k[rows, at] = knew[:, 0].to(k.dtype)
    v[rows, at] = vnew[:, 0].to(v.dtype)
    t = torch.arange(k.shape[1], device=x.device)
    valid = (t[None, :] <= positions[:, None])[:, None, :]   # (B,1,S_max)
    out = _sdpa(cfg, q, k, v, valid)
    return _project_out(cfg, p, out), cache
