"""glm4-9b: dense, RoPE (partial rotary), GQA kv=2. [hf:THUDM/glm-4-9b]"""

import torch

from repro_torch.configs.base import ModelConfig

ID = "glm4-9b"


def config(**overrides) -> ModelConfig:
    return ModelConfig(
        name=ID,
        family="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=2,
        d_ff=13696,
        vocab_size=151552,
        rope_theta=10000.0,
        rotary_frac=0.5,
        act="silu",
        norm="rmsnorm",
        n_workers=16,
    ).with_(**overrides)


def reduced(**overrides) -> ModelConfig:
    defaults = dict(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, n_workers=2, dtype=torch.float32,
        param_dtype=torch.float32, remat=False)
    defaults.update(overrides)
    return config().with_(**defaults)
