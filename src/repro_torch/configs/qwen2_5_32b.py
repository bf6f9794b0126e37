"""qwen2.5-32b: dense, GQA kv=8, QKV bias. [hf:Qwen/Qwen2.5-32B]

40 heads do not divide the 16 workers -> plain attention layout; the
fusion law applies to the MLPs.
"""

import torch

from repro_torch.configs.base import ModelConfig

ID = "qwen2.5-32b"


def config(**overrides) -> ModelConfig:
    return ModelConfig(
        name=ID,
        family="dense",
        n_layers=64,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=27648,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        act="silu",
        norm="rmsnorm",
        n_workers=16,
    ).with_(**overrides)


def reduced(**overrides) -> ModelConfig:
    defaults = dict(
        n_layers=2, d_model=64, n_heads=5, n_kv_heads=1, d_ff=128,
        vocab_size=256, n_workers=2, dtype=torch.float32,
        param_dtype=torch.float32, remat=False)
    defaults.update(overrides)
    return config().with_(**defaults)
