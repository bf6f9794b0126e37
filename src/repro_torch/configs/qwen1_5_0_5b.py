"""qwen1.5-0.5b: dense, MHA-ish (kv=16), QKV bias. [hf:Qwen/Qwen1.5-0.5B]"""

import torch

from repro_torch.configs.base import ModelConfig

ID = "qwen1.5-0.5b"


def config(**overrides) -> ModelConfig:
    return ModelConfig(
        name=ID,
        family="dense",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=2816,
        vocab_size=151936,
        qkv_bias=True,
        rope_theta=10000.0,
        act="silu",
        norm="rmsnorm",
        tie_embeddings=True,
        n_workers=16,
    ).with_(**overrides)


def reduced(**overrides) -> ModelConfig:
    defaults = dict(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256, n_workers=2, dtype=torch.float32,
        param_dtype=torch.float32, remat=False)
    defaults.update(overrides)
    return config().with_(**defaults)
