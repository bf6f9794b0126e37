"""Model configuration: the JAX package's ``ModelConfig`` with torch types.

One :class:`ModelConfig` describes every architecture by a cyclic
``block_pattern`` (mixer per layer position) x ``ffn_pattern`` (FFN per
layer position); the FedOCS technique enters through ``tp_fusion``.  The
fields, their defaults and the checks of ``__post_init__`` are the JAX
package's, so a config built here equals its JAX counterpart field by
field (``dtype``, ``param_dtype`` and ``logit_dtype`` as torch types).

The port builds only plans of self-attention (``attn``,
``attn_nocausal``) and ``mlp`` blocks: :func:`check_ported` says which
ROADMAP item brings the rest.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

MIXERS = ("attn", "attn_nocausal", "mamba", "mlstm", "slstm")
FFNS = ("mlp", "moe", "none")
TP_FUSIONS = ("sum", "max", "max_q16", "max_q8", "concat")
PORTED_MIXERS = ("attn", "attn_nocausal")
PORTED_FFNS = ("mlp",)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|ssm|vlm|hybrid|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # layer plan: patterns are cycled over the layer index
    block_pattern: Tuple[str, ...] = ("attn",)
    ffn_pattern: Tuple[str, ...] = ("mlp",)
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    moe_shared_expert: bool = False
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # attention
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    rotary_frac: float = 1.0          # glm4 rotates half the head dim
    use_rope: bool = True             # rotary embeddings inside attention
    use_abs_pos: bool = False         # additive sinusoidal PE (whisper)
    # SSM (mamba / xlstm)
    ssm_state_dim: int = 16
    ssm_expand: int = 2
    conv_width: int = 4
    dt_rank: int = 0                  # 0 => ceil(d_model / 16)
    # encoder-decoder
    encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_block_pattern: Tuple[str, ...] = ("attn_nocausal",)
    # modality frontend
    frontend: str = "token"           # token|patch|audio
    frontend_dim: int = 0
    # numerics
    norm: str = "rmsnorm"             # rmsnorm|layernorm
    act: str = "silu"                 # silu|gelu
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # FedOCS integration (the paper's technique as a TP fusion law)
    tp_fusion: str = "sum"
    tie_break: str = "all"
    # execution
    n_workers: int = 1                # worker count of the fusion sites
    scan_layers: bool = True          # kept for field parity: the port
    remat: bool = True                #   loops over layers and keeps no
    #   activations beyond what autograd needs
    use_flash: bool = False           # the flash-attention kernel path
    mamba_assoc_scan: bool = False
    loss_chunk: int = 512
    scores_dtype: str = "f32"         # attention scores: f32 | bf16
    pad_heads_to: int = 0             # pad n_heads (padded heads masked)
    moe_impl: str = "sort_scatter"
    remat_policy: str = "full"
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.bfloat16
    logit_dtype: Any = torch.float32
    subquadratic: bool = False

    def __post_init__(self):
        assert self.tp_fusion in TP_FUSIONS, self.tp_fusion
        for m in self.block_pattern:
            assert m in MIXERS, m
        for f in self.ffn_pattern:
            assert f in FFNS, f
        period = self.period
        assert self.n_layers % period == 0, \
            f"{self.name}: n_layers {self.n_layers} % period {period} != 0"

    # ---- derived ----
    @property
    def period(self) -> int:
        a, b = len(self.block_pattern), len(self.ffn_pattern)
        return a * b // math.gcd(a, b)

    @property
    def n_periods(self) -> int:
        return self.n_layers // self.period

    def layer_plan(self) -> Tuple[Tuple[str, str], ...]:
        """(mixer, ffn) for each position within a period."""
        return tuple(
            (self.block_pattern[i % len(self.block_pattern)],
             self.ffn_pattern[i % len(self.ffn_pattern)])
            for i in range(self.period))

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not build yet:
    mixers other than self-attention, FFNs other than ``mlp``, the
    encoder-decoder and the patch/audio frontends (ROADMAP queue 1, item
    17: the model stack's MoE, SSM/mamba/xLSTM, cross-attention and
    frontend modules)."""
    todo = ("not ported yet (ROADMAP queue 1, item 17: MoE, SSM/mamba/"
            "xLSTM, cross-attention and the frontends)")
    for mixer, ffn in cfg.layer_plan():
        if mixer not in PORTED_MIXERS:
            raise NotImplementedError(f"{cfg.name}: mixer {mixer!r} is {todo}")
        if ffn not in PORTED_FFNS:
            raise NotImplementedError(f"{cfg.name}: ffn {ffn!r} is {todo}")
    if cfg.encoder_decoder:
        raise NotImplementedError(f"{cfg.name}: the encoder-decoder is {todo}")
    if cfg.frontend != "token" or cfg.use_abs_pos:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend!r} frontend and sinusoidal "
            f"positions are {todo}")
