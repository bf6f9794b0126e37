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

Under a mesh whose model axis splits the heads (``wq`` holds ``H/R`` of
them), each rank projects q for its heads and k/v for every KV head (the
cache holds every KV head on every rank, as the JAX package's
``CACHE_AXES``), and attends with its heads against the KV heads they
read under GQA, at a prefill and at a decode step alike.  Where the rules
split the cache's sequence over ``kv_seq`` (``sharding.kv_seq_axis``, the
long-context cells), a rank's cache holds one block of the positions: a
decode step writes the new row on the rank whose block holds its
position, and the softmax over the split keys combines over the group
(the split-softmax decode: the row maxima by an all-reduce(max), the
float32 denominators and the float32 partial products P.V by
all-reduce(sum)).  The input and ``wk``/``wv``/``bk``/
``bv`` pass through the model group's *f* copy, so their gradients, each
rank's share, add up over the group.  The "worker" layout fuses the local
workers' partials over the group (``fusion.worker_reduce``); the "plain"
layout adds the local heads' products by an all-reduce(sum).  A site
whose heads the mesh does not divide runs whole on every rank, with no
collective.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import fusion, layers
from repro_torch.parallel import comm
from repro_torch.parallel import sharding

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


def attn_axes(cfg) -> dict:
    """:func:`attn_init`'s logical axes."""
    p = {"wq": ("embed", "heads", None), "wk": ("embed", None, None),
         "wv": ("embed", None, None),
         "wo": (("worker", None, None, "embed") if attn_layout(cfg)
                == "worker" else ("heads", None, "embed"))}
    if cfg.qkv_bias:
        p.update(bq=("heads", None), bk=(None, None), bv=(None, None))
    p.update(fusion.fusion_axes(cfg))
    return p


# the KV cache's logical axes: the rows over the data axis, the sequence
# over ``kv_seq`` (long-context decode), the KV heads whole
CACHE_AXES = {
    "k": ("batch", "kv_seq", None, None),
    "v": ("batch", "kv_seq", None, None),
}


def init_cache(cfg, batch: int, max_seq: int, dtype, device=None) -> dict:
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", x, w)."""
    b, s, d = x.shape
    return torch.matmul(x, w.reshape(d, -1)).reshape(b, s, *w.shape[1:])


class Heads:
    """The heads a site computes: ``count`` of them from global head
    ``first``, split over ``axis`` (``None`` for all of them), reading
    ``kv_count`` KV heads from ``kv_first``."""

    def __init__(self, cfg, p: dict):
        hp = n_heads_padded(cfg)
        self.count = p["wq"].shape[1]
        self.axis = sharding.split_of("heads", self.count, hp)
        self.first = 0
        self.kv_first, self.kv_count = 0, cfg.n_kv_heads
        if self.axis is None:
            return
        self.first = self.axis.index * self.count
        group = hp // cfg.n_kv_heads            # q heads per KV head
        if self.count % group == 0:
            self.kv_first, self.kv_count = (self.first // group,
                                            self.count // group)
        elif group % self.count == 0:
            self.kv_first, self.kv_count = self.first // group, 1
        else:
            raise NotImplementedError(
                f"{self.count} heads a rank with {group} q heads per KV "
                f"head")
        wo = p["wo"]
        local = (wo.shape[0] * (hp // cfg.n_workers)
                 if attn_layout(cfg) == "worker" else wo.shape[0])
        if local != self.count:
            raise NotImplementedError(
                "the mesh splits the heads and the workers of the "
                "out-projection apart")

    def copy(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` behind the model group's *f* copy, where split."""
        return t if self.axis is None else comm.copy_to_group(
            t, self.axis.group)

    def kv(self, t: torch.Tensor) -> torch.Tensor:
        """The KV heads (axis 2) this site's q heads read."""
        if self.axis is None:
            return t
        return t.narrow(2, self.kv_first, self.kv_count)


def _qkv(cfg, p, x, kv_x, heads: Heads):
    d = cfg.dtype
    x = heads.copy(x)
    kv_x = x if kv_x is None else heads.copy(kv_x)
    q = _proj(x, p["wq"].to(d))
    k = _proj(kv_x, heads.copy(p["wk"]).to(d))
    v = _proj(kv_x, heads.copy(p["wv"]).to(d))
    if "bq" in p:
        q = q + p["bq"].to(d)
        k = k + heads.copy(p["bk"]).to(d)
        v = v + heads.copy(p["bv"]).to(d)
    return q, k, v


def _seq_sum(x: torch.Tensor, seq: sharding.Axis) -> torch.Tensor:
    """The softmax denominators of every block of the sequence: the sum of
    each rank's over the ``kv_seq`` group.  A function of its own so that
    a control fault can replace it (a rank keeping its own block's
    denominators) and show that the split decode's limits catch that."""
    return comm.all_reduce(x, "sum", seq.group)


def _sdpa(cfg, q, k, v, mask, seq: Optional[sharding.Axis] = None
          ) -> torch.Tensor:
    """q: (B,S,H,Dh), k/v: (B,T,Kv,Dh), mask: (B, S, T) bool or None.

    The scores are float32 products of the working-type q and k (JAX's
    ``preferred_element_type``), or bfloat16 with ``scores_dtype='bf16'``;
    the probabilities are cast to ``cfg.dtype`` before P.V.  With ``seq``
    the keys are this rank's block of a sequence split over that axis:
    the scores are the block's, exactly so computed, against the row
    maxima over the group; the float32 denominators are summed over it,
    and so are the float32 products P.V, cast to ``cfg.dtype`` once.  A
    block without a valid key adds exact zeros."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    sdt = torch.bfloat16 if cfg.scores_dtype == "bf16" else torch.float32
    qg = q.reshape(b, s, kv, g, hd)
    if sdt == torch.float32:
        scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    else:
        scores = torch.einsum("bskgd,btkd->bkgst", qg, k).to(sdt)
    scores = scores * torch.full((), hd ** -0.5, dtype=sdt, device=q.device)
    if mask is not None:
        fill = torch.full((), NEG_INF, dtype=torch.float32,
                          device=q.device).to(sdt)
        scores = torch.where(mask[:, None, None], scores, fill)
    smax = torch.amax(scores, dim=-1, keepdim=True).detach()
    if seq is not None:
        smax = comm.all_reduce(smax, "max", seq.group)
    unnorm = torch.exp((scores - smax).to(sdt))
    denom = torch.sum(unnorm.float(), dim=-1, keepdim=True)
    if seq is not None:
        denom = _seq_sum(denom, seq)
    probs = (unnorm / denom.to(sdt)).to(cfg.dtype)
    if seq is None:
        out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    else:
        out = comm.all_reduce(torch.einsum("bkgst,btkd->bskgd",
                                           probs.float(), v.float()),
                              "sum", seq.group).to(cfg.dtype)
    return out.reshape(b, s, h, hd)


def _project_out(cfg, p, attn_out, heads: Heads) -> torch.Tensor:
    """(B,S,H,Dh) -> fused (B,S,d) via the configured layout."""
    b, s, h, hd = attn_out.shape
    if n_heads_padded(cfg) != cfg.n_heads:     # zero-mask padded heads
        head_mask = (torch.arange(heads.first, heads.first + h,
                                  device=attn_out.device)
                     < cfg.n_heads).to(attn_out.dtype)
        attn_out = attn_out * head_mask[None, None, :, None]
    wo = p["wo"].to(cfg.dtype)
    if attn_layout(cfg) == "plain":
        out = torch.matmul(attn_out.reshape(b, s, h * hd),
                           wo.reshape(h * hd, -1))
        if heads.axis is None:
            return out
        return comm.reduce_from_group(out, heads.axis.group)
    n = wo.shape[0]
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
    heads = Heads(cfg, p)
    q, k, v = _qkv(cfg, p, x, kv_x, heads)
    if cfg.use_rope and not cross:
        q = layers.apply_rope(cfg, q, positions)
        k = layers.apply_rope(cfg, k, positions)
    kh, vh = heads.kv(k), heads.kv(v)
    if cfg.use_flash and not cross:
        # the kernel's (B,H,S,D) layout; positions are arange here, so the
        # kernel's block-causal mask is exact
        out = flash_ops.flash_attention(
            q.transpose(1, 2), kh.transpose(1, 2), vh.transpose(1, 2),
            causal).transpose(1, 2)
    else:
        mask = None
        if causal:
            mask = positions[:, None, :] <= positions[:, :, None]  # (B,S,S)
        out = _sdpa(cfg, q, kh, vh, mask)
    y = _project_out(cfg, p, out, heads)
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
    written and no rotary position applied.  Under a ``kv_seq`` split the
    cache is this rank's block of the positions (module doc): the
    position is clamped to the whole cache, the rank whose block holds it
    writes the row, and the validity mask reads global positions."""
    d = cfg.dtype
    heads = Heads(cfg, p)
    seq, offset = sharding.kv_seq_block(cache["k"].shape[1])
    if cross:
        q = _proj(heads.copy(x), p["wq"].to(d))
        if "bq" in p:
            q = q + p["bq"].to(d)
        k, v = cache["k"], cache["v"]
        valid = torch.ones((x.shape[0], 1, k.shape[1]), dtype=torch.bool,
                           device=x.device)
        out = _sdpa(cfg, q, heads.kv(k), heads.kv(v), valid, seq)
        return _project_out(cfg, p, out, heads), cache
    q, knew, vnew = _qkv(cfg, p, x, None, heads)
    if cfg.use_rope:
        q = layers.apply_rope(cfg, q, positions[:, None])
        knew = layers.apply_rope(cfg, knew, positions[:, None])
    k, v = cache["k"], cache["v"]
    rows = torch.arange(x.shape[0], device=x.device)
    if seq is None:
        at = positions.clamp(max=k.shape[1] - 1).long()
        k[rows, at] = knew[:, 0].to(k.dtype)
        v[rows, at] = vnew[:, 0].to(v.dtype)
        t = torch.arange(k.shape[1], device=x.device)
    else:
        _write_block(k, v, knew, vnew, rows, positions, offset,
                     k.shape[1] * seq.size)
        t = torch.arange(offset, offset + k.shape[1], device=x.device)
    valid = (t[None, :] <= positions[:, None])[:, None, :]   # (B,1,S_max)
    out = _sdpa(cfg, q, heads.kv(k), heads.kv(v), valid, seq)
    return _project_out(cfg, p, out, heads), cache


def _write_block(k, v, knew, vnew, rows, positions, offset: int,
                 whole: int) -> None:
    """The new key and value rows into this rank's block ``k``/``v`` of a
    cache of ``whole`` positions from ``offset``, at ``positions`` clamped
    to the whole cache; a row whose position lies in another rank's block
    rewrites what it read (no host read decides)."""
    local = positions.clamp(max=whole - 1).long() - offset
    mine = ((local >= 0) & (local < k.shape[1]))[:, None, None]
    at = local.clamp(0, k.shape[1] - 1)
    k[rows, at] = torch.where(mine, knew[:, 0].to(k.dtype), k[rows, at])
    v[rows, at] = torch.where(mine, vnew[:, 0].to(v.dtype), v[rows, at])
