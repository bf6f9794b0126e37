"""llama4-scout-17b-a16e: MoE 16 experts top-1 + shared expert; the
multimodal early-fusion frontend is out of scope for the LM backbone.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

40 heads do not divide the 16 workers -> plain attention layout.
"""

import torch

from repro_torch.configs.base import ModelConfig

ID = "llama4-scout-17b-a16e"


def config(**overrides) -> ModelConfig:
    return ModelConfig(
        name=ID,
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=202048,
        ffn_pattern=("moe",),
        n_experts=16,
        experts_per_token=1,
        moe_d_ff=8192,
        moe_shared_expert=True,
        rope_theta=500_000.0,
        act="silu",
        norm="rmsnorm",
        n_workers=16,
    ).with_(**overrides)


def reduced(**overrides) -> ModelConfig:
    defaults = dict(
        n_layers=2, d_model=64, n_heads=5, n_kv_heads=1, d_ff=64,
        moe_d_ff=64, vocab_size=256, n_experts=4, experts_per_token=1,
        n_workers=2, dtype=torch.float32, param_dtype=torch.float32,
        remat=False)
    defaults.update(overrides)
    return config().with_(**defaults)
