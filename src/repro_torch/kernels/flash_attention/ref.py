"""Plain PyTorch version of the flash-attention kernel: attention with the
whole score matrix, in float32 (the JAX package's ``ref.py``)."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, Hkv, Sk, D) -> (B, H, Sq, D); query head
    h reads KV head ``h // (H // Hkv)``."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, h // hkv, sq, d)
    s = torch.einsum("bkgqd,bktd->bkgqt", qg.float(), k.float()) * d ** -0.5
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = s.masked_fill(~mask, NEG_INF)  # no scalar copied to the card
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,bktd->bkgqd", p, v.float())
    return o.reshape(b, h, sq, d).to(q.dtype)
