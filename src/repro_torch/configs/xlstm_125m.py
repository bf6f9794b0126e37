"""xlstm-125m: sLSTM + mLSTM blocks (3 mLSTM : 1 sLSTM per period), no
separate FFN (d_ff=0 in the assignment; expansion lives inside the blocks).
The recurrent state is O(1) in the sequence. [arXiv:2405.04517]

use_rope=True here means "no absolute positional embedding is added" — the
recurrence provides order; there is no attention for RoPE to act on.
"""

import torch

from repro_torch.configs.base import ModelConfig

ID = "xlstm-125m"


def config(**overrides) -> ModelConfig:
    return ModelConfig(
        name=ID,
        family="ssm",
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
        ffn_pattern=("none",),
        ssm_expand=2,
        act="gelu",
        norm="layernorm",
        tie_embeddings=True,
        subquadratic=True,
        n_workers=16,
    ).with_(**overrides)


def reduced(**overrides) -> ModelConfig:
    defaults = dict(
        n_layers=4, d_model=64, n_heads=2, n_kv_heads=2, vocab_size=256,
        n_workers=2, dtype=torch.float32, param_dtype=torch.float32,
        remat=False)
    defaults.update(overrides)
    return config().with_(**defaults)
