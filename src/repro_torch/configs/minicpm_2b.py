"""minicpm-2b: llama-like dense; trains with the WSD schedule
(``optim/schedules.for_arch``). [arXiv:2404.06395]

36 heads do not divide the 16 workers -> plain attention layout.
"""

import torch

from repro_torch.configs.base import ModelConfig

ID = "minicpm-2b"


def config(**overrides) -> ModelConfig:
    return ModelConfig(
        name=ID,
        family="dense",
        n_layers=40,
        d_model=2304,
        n_heads=36,
        n_kv_heads=36,
        d_ff=5760,
        vocab_size=122753,
        rope_theta=10000.0,
        act="silu",
        norm="rmsnorm",
        tie_embeddings=True,
        n_workers=16,
    ).with_(**overrides)


def reduced(**overrides) -> ModelConfig:
    defaults = dict(
        n_layers=2, d_model=70, n_heads=5, n_kv_heads=5, d_ff=128,
        vocab_size=256, n_workers=2, dtype=torch.float32,
        param_dtype=torch.float32, remat=False)
    defaults.update(overrides)
    return config().with_(**defaults)
