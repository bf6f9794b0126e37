"""Deterministic, stateless synthetic data pipeline (the JAX package's
``data/pipeline.py``).

Every batch is *index-derived*: ``batch_for_step(cfg, step)`` regenerates
the same batch from (seed, step) with numpy's counter-seeded generator, so
there is no iterator state to checkpoint, a resumed run replays the exact
stream, and a straggling host can substitute any step's batch.  The draws
are numpy's, so the batches are bitwise the JAX package's; they come out
as torch tensors on the caller's ``device``.

The synthetic "language" has learnable structure (an affine next-token map
with noise), so a training run can show its loss falling.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    vocab_size: int
    batch: int                  # global batch
    seq_len: int
    seed: int = 0
    noise: float = 0.05         # fraction of random next tokens
    frontend: str = "token"     # token | patch | audio
    frontend_dim: int = 0
    decoder_len: int = 0        # enc-dec: decoder token length


def _rng(cfg: PipelineConfig, step: int) -> np.random.Generator:
    # the (seed, step) pair fully determines the batch
    return np.random.default_rng([cfg.seed, step])


def _token_batch(cfg: PipelineConfig, rng: np.random.Generator,
                 batch: int, seq: int) -> np.ndarray:
    v = cfg.vocab_size
    a = 31337 % v or 1
    b = 17
    x0 = rng.integers(0, v, size=(batch, 1))
    toks = [x0]
    for _ in range(seq):
        nxt = (a * toks[-1] + b) % v
        noise = rng.integers(0, v, size=(batch, 1))
        use_noise = rng.random((batch, 1)) < cfg.noise
        toks.append(np.where(use_noise, noise, nxt))
    return np.concatenate(toks, axis=1).astype(np.int32)   # (B, seq+1)


def batch_for_step(cfg: PipelineConfig, step: int, *,
                   device) -> Dict[str, torch.Tensor]:
    """The batch of ``step``: int32 ``tokens``/``targets`` (and float32
    ``feats`` for the patch/audio frontends) on ``device``."""
    rng = _rng(cfg, step)
    out: Dict[str, np.ndarray] = {}
    if cfg.frontend == "token":
        seq = _token_batch(cfg, rng, cfg.batch, cfg.seq_len)
        out["tokens"] = seq[:, :-1]
        out["targets"] = seq[:, 1:]
    elif cfg.decoder_len:                                   # enc-dec
        out["feats"] = rng.standard_normal(
            (cfg.batch, cfg.seq_len, cfg.frontend_dim)).astype(np.float32)
        seq = _token_batch(cfg, rng, cfg.batch, cfg.decoder_len)
        out["tokens"] = seq[:, :-1]
        out["targets"] = seq[:, 1:]
    else:                                                   # patch/audio LM
        out["feats"] = rng.standard_normal(
            (cfg.batch, cfg.seq_len, cfg.frontend_dim)).astype(np.float32)
        seq = _token_batch(cfg, rng, cfg.batch, cfg.seq_len)
        out["targets"] = seq[:, 1:]
    return {k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for k, a in out.items()}


def for_model(mcfg, batch: int, seq_len: int, seed: int = 0
              ) -> PipelineConfig:
    from repro_torch.models.model import WHISPER_DECODER_LEN
    return PipelineConfig(
        vocab_size=mcfg.vocab_size,
        batch=batch,
        seq_len=seq_len,
        seed=seed,
        frontend=mcfg.frontend,
        frontend_dim=mcfg.frontend_dim,
        decoder_len=(min(WHISPER_DECODER_LEN, seq_len)
                     if mcfg.encoder_decoder else 0),
    )
