"""Model configuration: the JAX package's ``ModelConfig`` with torch types.

One :class:`ModelConfig` describes every architecture by a cyclic
``block_pattern`` (mixer per layer position) x ``ffn_pattern`` (FFN per
layer position); the FedOCS technique enters through ``tp_fusion``.  The
fields, their defaults and the checks of ``__post_init__`` are the JAX
package's, so a config built here equals its JAX counterpart field by
field (``dtype``, ``param_dtype`` and ``logit_dtype`` as torch types).

The port builds every plan the JAX package builds: the ``attn``,
``attn_nocausal``, ``mamba``, ``mlstm`` and ``slstm`` mixers with an
``mlp``, ``moe`` or no (``none``) FFN, the encoder-decoder and the
patch/audio frontends.  ``param_count`` is the JAX package's arithmetic on
the fields.  :class:`ShapeConfig`, :data:`SHAPES` and
:func:`shape_applicable` are the JAX package's four input shapes of the
dry-run and their rule.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

MIXERS = ("attn", "attn_nocausal", "mamba", "mlstm", "slstm")
FFNS = ("mlp", "moe", "none")
TP_FUSIONS = ("sum", "max", "max_q16", "max_q8", "concat")


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
    #   loops over the periods in Python
    remat: bool = True                # recompute each period's forward in
    #   the backward (transformer.stack_full)
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
        return _lcm(len(self.block_pattern), len(self.ffn_pattern))

    @property
    def n_periods(self) -> int:
        return self.n_layers // self.period

    def layer_plan(self) -> Tuple[Tuple[str, str], ...]:
        """(mixer, ffn) for each position within a period."""
        return tuple(
            (self.block_pattern[i % len(self.block_pattern)],
             self.ffn_pattern[i % len(self.ffn_pattern)])
            for i in range(self.period))

    def encoder_layer_plan(self) -> Tuple[Tuple[str, str], ...]:
        return tuple(
            (self.encoder_block_pattern[i % len(self.encoder_block_pattern)],
             "mlp") for i in range(len(self.encoder_block_pattern)))

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or max(1, math.ceil(self.d_model / 16))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting ----
    def param_count(self, active_only: bool = False) -> int:
        """Parameters of the model; with ``active_only`` the experts a
        token runs through (``experts_per_token``) in place of all."""
        return _param_count(self, active_only)


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def _attn_params(c: ModelConfig) -> int:
    hd = c.head_dim_
    p = c.d_model * (c.n_heads * hd) + 2 * c.d_model * (c.n_kv_heads * hd) \
        + (c.n_heads * hd) * c.d_model
    if c.qkv_bias:
        p += (c.n_heads + 2 * c.n_kv_heads) * hd
    return p


def _mlp_params(c: ModelConfig, d_ff: int) -> int:
    gates = 2 if c.act == "silu" else 1          # SwiGLU has gate+up
    return c.d_model * d_ff * gates + d_ff * c.d_model


def _mamba_params(c: ModelConfig) -> int:
    di, st, dr = c.d_inner, c.ssm_state_dim, c.dt_rank_
    return (c.d_model * 2 * di          # in_proj (x, z)
            + di * c.conv_width         # depthwise conv
            + di * (dr + 2 * st)        # x -> (dt, B, C)
            + dr * di                   # dt up-proj
            + di * st                   # A (log) matrix
            + di                        # D skip
            + di * c.d_model)           # out_proj


def _xlstm_params(c: ModelConfig, kind: str) -> int:
    di = c.d_inner
    if kind == "mlstm":
        # up-proj (x,z), qkv over inner dim, igate/fgate/ogate, down-proj
        return (c.d_model * 2 * di + 3 * di * di + 3 * di + di * c.d_model)
    # slstm: 4 gates over d_model + small FFN folded in
    return 4 * c.d_model * c.d_model + 4 * c.d_model


def _layer_params(c: ModelConfig, mixer: str, ffn: str) -> Tuple[int, int]:
    """(dense_params, per_expert_extra) for one layer."""
    if mixer in ("attn", "attn_nocausal"):
        p = _attn_params(c)
    elif mixer == "mamba":
        p = _mamba_params(c)
    else:
        p = _xlstm_params(c, mixer)
    p += 2 * c.d_model                   # norms
    moe_extra = 0
    if ffn == "mlp":
        p += _mlp_params(c, c.d_ff)
    elif ffn == "moe":
        p += c.d_model * c.n_experts     # router
        moe_extra = _mlp_params(c, c.moe_d_ff or c.d_ff)
        if c.moe_shared_expert:
            p += _mlp_params(c, c.moe_d_ff or c.d_ff)
    return p, moe_extra


def _param_count(c: ModelConfig, active_only: bool) -> int:
    total = c.vocab_size * c.d_model     # embedding
    if not c.tie_embeddings:
        total += c.vocab_size * c.d_model
    if c.frontend != "token":
        total += (c.frontend_dim or c.d_model) * c.d_model
    plan = c.layer_plan()
    for i in range(c.n_layers):
        mixer, ffn = plan[i % c.period]
        dense, per_expert = _layer_params(c, mixer, ffn)
        total += dense
        if per_expert:
            n_e = c.experts_per_token if active_only else c.n_experts
            total += per_expert * n_e
    if c.encoder_decoder:
        for i in range(c.n_encoder_layers):
            dense, _ = _layer_params(c, "attn_nocausal", "mlp")
            total += dense
        # decoder cross-attention (one per decoder layer)
        total += c.n_layers * _attn_params(c)
    return total


# ---------------------------------------------------------------------------
# input shapes (four a config, the dry-run's cells)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """``long_500k`` only for the sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("full-attention arch: 500k decode needs sub-quadratic "
                       "attention (see DESIGN.md §5)")
    return True, ""
