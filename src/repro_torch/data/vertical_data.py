"""Synthetic stand-ins for the paper's MNIST / CIFAR experiments.

The container is offline, so we generate deterministic datasets with the same
tensor shapes and — crucially — the same *task structure* the paper relies on:

* :func:`multiview_denoising` (paper §IV-A): a clean 28x28 "digit-like"
  image (random smooth blob mixture); each of N sensors observes the SAME
  image corrupted by independent Gaussian noise of sigma=2 (the paper's
  setting).  Reconstruction must fuse all views to denoise.

* :func:`patch_classification` (paper §IV-B): a 32x32 "image" partitioned
  into a grid of N cells, one per worker.  The class is a function of the
  WHOLE image (prototype matching with per-class global templates plus
  per-patch distractors), so no single patch suffices — matching the paper's
  observation that individual workers do poorly while fused embeddings
  approach the centralized model.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


def _blob_image(rng: np.random.Generator, hw: int = 28, k: int = 3
                ) -> np.ndarray:
    """Smooth normalized blob mixture in [0, 1] — a 'digit-like' image."""
    yy, xx = np.mgrid[0:hw, 0:hw] / hw
    img = np.zeros((hw, hw))
    for _ in range(k):
        cx, cy = rng.random(2) * 0.8 + 0.1
        sx, sy = rng.random(2) * 0.12 + 0.04
        img += np.exp(-((xx - cx) ** 2 / (2 * sx ** 2)
                        + (yy - cy) ** 2 / (2 * sy ** 2)))
    img /= max(img.max(), 1e-6)
    return img


def multiview_denoising(n_samples: int, n_workers: int = 4, hw: int = 28,
                        sigma: float = 2.0, seed: int = 0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (views (N, M, hw*hw), clean (M, hw*hw)) — paper §IV-A."""
    rng = np.random.default_rng(seed)
    clean = np.stack([_blob_image(rng, hw) for _ in range(n_samples)])
    clean = clean.reshape(n_samples, hw * hw).astype(np.float32)
    noise = rng.normal(0.0, sigma, size=(n_workers,) + clean.shape)
    views = (clean[None] + noise).astype(np.float32)
    return views, clean


@dataclasses.dataclass(frozen=True)
class PatchTaskConfig:
    n_classes: int = 4
    grid: int = 2              # grid x grid workers (paper: 2x2 / 3x3)
    hw: int = 32               # full image side
    sigma: float = 0.5         # per-patch observation noise
    seed: int = 0


def pattern_bank(cfg: PatchTaskConfig) -> np.ndarray:
    """Fixed bank of n_classes patch patterns (shared across patches)."""
    ph = cfg.hw // cfg.grid
    rng_t = np.random.default_rng(cfg.seed)
    return rng_t.normal(0, 1, size=(cfg.n_classes, ph, ph))


def patch_classification(cfg: PatchTaskConfig, n_samples: int, seed: int = 0
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (views (N, M, patch_dim), labels (M,)).

    Relational task: patch i displays pattern k_i from a shared bank; the
    label is ``(sum_i k_i) mod n_classes``.  Every patch's marginal is
    uniform over the bank regardless of class, so a single worker — and any
    fusion of *per-worker posteriors* (the paper's 'Best Worker' and
    'Avg. Workers Preds' baselines) — is at chance by construction, while
    embedding-level fusion (concat / mean / FedOCS max) can decode every
    k_i and learn the relation.  This reproduces the paper's Table-I
    separation structurally rather than through noise levels.
    """
    bank = pattern_bank(cfg)
    ph = cfg.hw // cfg.grid
    n_workers = cfg.grid * cfg.grid
    rng = np.random.default_rng([cfg.seed + 1, seed])
    ks = rng.integers(0, cfg.n_classes, size=(n_workers, n_samples))
    labels = np.mod(ks.sum(axis=0), cfg.n_classes)
    views = []
    for i in range(n_workers):
        patch = bank[ks[i]] + rng.normal(
            0, cfg.sigma, size=(n_samples, ph, ph))
        views.append(patch.reshape(n_samples, ph * ph))
    return (np.stack(views).astype(np.float32),
            labels.astype(np.int32))
