"""pixtral-12b: VLM, a pixtral-ViT frontend (a stub: the batch carries
precomputed 1024-d patch features) and a mistral-nemo-like decoder
backbone. [hf:mistralai/Pixtral-12B-2409; unverified]"""

import torch

from repro_torch.configs.base import ModelConfig

ID = "pixtral-12b"


def config(**overrides) -> ModelConfig:
    return ModelConfig(
        name=ID,
        family="vlm",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131072,
        frontend="patch",
        frontend_dim=1024,
        rope_theta=1_000_000.0,
        act="silu",
        norm="rmsnorm",
        n_workers=16,
    ).with_(**overrides)


def reduced(**overrides) -> ModelConfig:
    defaults = dict(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, frontend_dim=16, n_workers=2,
        dtype=torch.float32, param_dtype=torch.float32, remat=False)
    defaults.update(overrides)
    return config().with_(**defaults)
