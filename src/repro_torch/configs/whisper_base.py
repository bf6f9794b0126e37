"""whisper-base: encoder-decoder; the conv audio frontend is a stub (the
batch carries precomputed 80-d frame features, projected to 512).  The
real 448-token positional cap is lifted to the assigned decode shapes via
config. [arXiv:2212.04356; unverified]

8 heads do not divide the 16 workers -> plain attention layout.
"""

import torch

from repro_torch.configs.base import ModelConfig

ID = "whisper-base"


def config(**overrides) -> ModelConfig:
    return ModelConfig(
        name=ID,
        family="audio",
        n_layers=6,
        n_encoder_layers=6,
        encoder_decoder=True,
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        d_ff=2048,
        vocab_size=51865,
        frontend="audio",
        frontend_dim=80,
        use_rope=False,          # sinusoidal absolute positions
        use_abs_pos=True,
        act="gelu",
        norm="layernorm",
        tie_embeddings=True,
        n_workers=16,
    ).with_(**overrides)


def reduced(**overrides) -> ModelConfig:
    defaults = dict(
        n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256, frontend_dim=16, n_workers=2,
        dtype=torch.float32, param_dtype=torch.float32, remat=False)
    defaults.update(overrides)
    return config().with_(**defaults)
