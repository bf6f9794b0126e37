"""jamba-1.5-large-398b: hybrid Mamba+attention 1:7 interleave, MoE 16e
top-2 on alternating layers. [arXiv:2403.19887]

One 8-layer period holds four MoE layers of 9.66 B parameters: the whole
model does not fit one card at this width.
"""

import torch

from repro_torch.configs.base import ModelConfig

ID = "jamba-1.5-large-398b"

_PERIOD = ("mamba", "mamba", "mamba", "attn",
           "mamba", "mamba", "mamba", "mamba")


def config(**overrides) -> ModelConfig:
    return ModelConfig(
        name=ID,
        family="hybrid",
        n_layers=72,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=24576,
        vocab_size=65536,
        block_pattern=_PERIOD,
        ffn_pattern=("mlp", "moe"),
        n_experts=16,
        experts_per_token=2,
        moe_d_ff=24576,
        ssm_expand=2,
        ssm_state_dim=16,
        conv_width=4,
        use_rope=False,          # jamba uses no positional encoding
        act="silu",
        norm="rmsnorm",
        subquadratic=True,
        n_workers=16,
    ).with_(**overrides)


def reduced(**overrides) -> ModelConfig:
    defaults = dict(
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        moe_d_ff=64, vocab_size=256, n_experts=4, experts_per_token=2,
        n_workers=2, dtype=torch.float32, param_dtype=torch.float32,
        remat=False)
    defaults.update(overrides)
    return config().with_(**defaults)
