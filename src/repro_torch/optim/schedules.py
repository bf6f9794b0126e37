"""Learning-rate schedules: pure functions step -> float32 lr tensor, in
the JAX package's float32 arithmetic."""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def constant(lr: float):
    return lambda step: torch.full_like(_f32(step), lr)


def linear_warmup_cosine(lr: float, warmup: int, total: int,
                         final_frac: float = 0.1):
    def f(step):
        step = _f32(step)
        warm = lr * torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, lr * cos)
    return f


def wsd(lr: float, warmup: int, stable: int, decay: int,
        final_frac: float = 0.01):
    """Warmup-Stable-Decay (MiniCPM, arXiv:2404.06395): linear warmup, a
    flat plateau, a cosine decay over the last ``decay`` steps."""
    def f(step):
        step = _f32(step)
        warm = lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup - stable) / max(decay, 1), 0, 1)
        dec = lr * (final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm,
                           torch.where(step < warmup + stable,
                                       torch.full_like(step, lr),
                                       dec))
    return f


def for_arch(arch_id: str, lr: float, total_steps: int):
    """The schedule an architecture trains with: WSD for minicpm-2b,
    warmup-cosine for the rest."""
    if arch_id == "minicpm-2b":
        warm = max(total_steps // 100, 10)
        decay = max(total_steps // 10, 10)
        return wsd(lr, warm, total_steps - warm - decay, decay)
    return linear_warmup_cosine(lr, max(total_steps // 100, 10), total_steps)
