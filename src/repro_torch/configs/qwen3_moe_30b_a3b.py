"""qwen3-moe-30b-a3b: all-MoE, 128 experts top-8, GQA kv=4, head_dim=128.
[hf:Qwen/Qwen3-30B-A3B]"""

import torch

from repro_torch.configs.base import ModelConfig

ID = "qwen3-moe-30b-a3b"


def config(**overrides) -> ModelConfig:
    return ModelConfig(
        name=ID,
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=768,
        vocab_size=151936,
        ffn_pattern=("moe",),
        n_experts=128,
        experts_per_token=8,
        moe_d_ff=768,
        rope_theta=1_000_000.0,
        act="silu",
        norm="rmsnorm",
        n_workers=16,
    ).with_(**overrides)


def reduced(**overrides) -> ModelConfig:
    defaults = dict(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=32, moe_d_ff=32, vocab_size=256, n_experts=8,
        experts_per_token=2, n_workers=2, dtype=torch.float32,
        param_dtype=torch.float32, remat=False)
    defaults.update(overrides)
    return config().with_(**defaults)
