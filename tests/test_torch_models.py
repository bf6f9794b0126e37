"""The port's model stack (``repro_torch.models``, ``repro_torch.configs``)
against the JAX package's, at ``get_reduced("qwen1.5-0.5b")`` in float32,
and with MoE plans at the reduced qwen3-moe-30b-a3b and
llama4-scout-17b-a16e configs (and a mixed mlp/moe plan).

Both packages start from the JAX package's parameters, carried across by
``repro_torch.convert.params_from_jax``, and see the same numpy inputs.

Tolerances.  Float results are compared with ``FLOAT_TOL`` (rtol 1e-5,
atol 1e-5): the two packages multiply and reduce in other orders (XLA's
CPU dot and reductions against PyTorch's), which moves float32 results by
a few ulp per operation; the logits here are O(1-10) and measured gaps are
~1e-5 at most.  The rotary angles go through two libraries' ``pow``,
``sin`` and ``cos``: ``ROPE_TOL`` (atol 1e-5) covers their ulp gaps at
positions up to 64.  What is selected rather than computed — D-bit codes,
winners, the channel accounting — is compared bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import mlp as JMLP
from repro.models import model as JM
from repro.models import transformer as JT
from repro.parallel.sharding import split_tree
from repro.protocol import Protocol as JP
from repro_torch import random as jr
from repro_torch import tree
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import mlp as TMLP
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.protocol import Protocol as TP

torch.set_num_threads(1)

FLOAT_TOL = dict(rtol=1e-5, atol=1e-5)
ROPE_TOL = dict(rtol=0, atol=1e-5)
ARCH = "qwen1.5-0.5b"


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _close(got, want, tol=FLOAT_TOL, what=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **tol)


def _to_torch(values):
    return params_from_jax(jax.tree.map(np.asarray, values))


def _values(init_fn, *args):
    values, _ = split_tree(init_fn(*args))
    return values


@pytest.fixture(scope="module")
def reduced():
    """(JAX cfg, port cfg, JAX model values, port model values)."""
    jcfg, tcfg = j_get_reduced(ARCH), get_reduced(ARCH)
    jv = _values(JM.init, jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jv, _to_torch(jv)


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


PORTED_ARCHS = ("glm4-9b", "qwen2.5-32b", "qwen1.5-0.5b", "minicpm-2b",
                 "qwen3-moe-30b-a3b", "llama4-scout-17b-a16e", "xlstm-125m",
                 "pixtral-12b", "jamba-1.5-large-398b", "whisper-base")


@pytest.mark.parametrize("arch", PORTED_ARCHS)
@pytest.mark.parametrize("which", ["config", "reduced"])
def test_config_matches_jax(which, arch):
    """Every registered config, field by field (torch types for the
    JAX types), and the registry: the JAX registry's ten ids in its
    order."""
    jc = (j_get_config if which == "config" else j_get_reduced)(arch)
    tc = (get_config if which == "config" else get_reduced)(arch)
    for f in dataclasses.fields(tc):
        want = getattr(jc, f.name)
        want = _DTYPES.get(want, want)
        assert getattr(tc, f.name) == want, f.name
    assert tc.layer_plan() == jc.layer_plan()
    assert (tc.period, tc.n_periods, tc.head_dim_) == \
        (jc.period, jc.n_periods, jc.head_dim_)
    assert ARCH_IDS == PORTED_ARCHS == J_ARCH_IDS
    assert TA.attn_layout(tc) == JA.attn_layout(jc)
    TM.build(tc)


def test_config_checks_and_unported_plans():
    """The checks of ``__post_init__``; the plans item 17c brought (the
    encoder-decoder with sinusoidal positions, the patch frontend) build
    and run (their parity: tests/test_torch_encdec.py); the recurrent
    mixers and the ``none`` FFN (item 17b) build and run (their parity:
    tests/test_torch_ssm.py), and so does an MoE plan (its parity: the
    ``moe`` tests below)."""
    with pytest.raises(AssertionError):
        get_reduced(ARCH, tp_fusion="median")
    with pytest.raises(AssertionError):
        get_reduced(ARCH, n_layers=3, block_pattern=("attn", "attn"))
    toks = torch.arange(16, dtype=torch.int32).view(2, 8)
    feats = torch.randn((2, 8, 16), generator=torch.Generator().manual_seed(0))
    for kw, batch in (
            (dict(encoder_decoder=True, n_encoder_layers=2, use_rope=False,
                  use_abs_pos=True, frontend="audio", frontend_dim=16),
             {"feats": feats, "tokens": toks}),
            (dict(frontend="patch", frontend_dim=16), {"feats": feats})):
        m = TM.build(get_reduced(ARCH, **kw))
        v = m.init(torch.Generator().manual_seed(0))
        loss, _ = m.loss(v, dict(batch, targets=toks + 1))
        assert torch.isfinite(loss), kw
        logits, cache = m.prefill(v, batch, max_seq=12)
        logits, cache = m.decode_step(v, toks[:, :1], torch.full(
            (2,), 8, dtype=torch.int32), cache)
        assert torch.isfinite(logits).all(), kw
        assert ("cross" in cache["pos0"]) == ("tokens" in batch)

    for kw in (dict(block_pattern=("mamba",)),
               dict(block_pattern=("mlstm",), ffn_pattern=("none",)),
               dict(block_pattern=("slstm",), ffn_pattern=("none",))):
        m = TM.build(get_reduced(ARCH, **kw))
        v = m.init(torch.Generator().manual_seed(0))
        loss, _ = m.loss(v, {"tokens": toks, "targets": toks + 1})
        assert torch.isfinite(loss), kw
        if kw["block_pattern"] != ("mamba",):
            assert "ffn" not in v["blocks"]["pos0"]
            assert m.channel_sites() == 0
    cfg = get_reduced(ARCH, ffn_pattern=("moe",), n_experts=4,
                      experts_per_token=2)
    m = TM.build(cfg)
    v = m.init(torch.Generator().manual_seed(0))
    toks = torch.arange(16, dtype=torch.int32).view(2, 8)
    loss, metrics = m.loss(v, {"tokens": toks, "targets": toks + 1})
    assert torch.isfinite(loss) and float(metrics["aux"]) > 0
    assert m.channel_sites() == 0


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norm_apply(norm):
    jcfg = j_get_reduced(ARCH, norm=norm)
    tcfg = get_reduced(ARCH, norm=norm)
    x = _x((2, 5, 64), scale=3.0)
    p = {"scale": _x((64,), 1) + 1.0}
    if norm == "layernorm":
        p["bias"] = _x((64,), 2)
    want = JL.norm_apply(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = TL.norm_apply(tcfg, params_from_jax(p), torch.from_numpy(x))
    _close(got, want)


@pytest.mark.parametrize("rotary_frac", [1.0, 0.5])
def test_apply_rope(rotary_frac):
    jcfg = j_get_reduced(ARCH, rotary_frac=rotary_frac)
    tcfg = get_reduced(ARCH, rotary_frac=rotary_frac)
    x = _x((2, 7, 4, 16))
    pos = np.stack([np.arange(7), np.arange(7) + 57]).astype(np.int32)
    _close(TL.rope_freqs(tcfg, 16), JL.rope_freqs(jcfg, 16), ROPE_TOL)
    want = JL.apply_rope(jcfg, jnp.asarray(x), jnp.asarray(pos))
    got = TL.apply_rope(tcfg, torch.from_numpy(x), torch.from_numpy(pos))
    _close(got, want, ROPE_TOL)


def test_embed_and_unembed(reduced):
    jcfg, tcfg, jv, tv = reduced
    toks = np.array([[1, 5, 255], [0, 7, 7]], np.int32)
    want = JL.embed_tokens(jcfg, jv["embed"], jnp.asarray(toks))
    got = TL.embed_tokens(tcfg, tv["embed"], torch.from_numpy(toks))
    assert np.array_equal(_np(got), np.asarray(want))     # a gather: exact
    x = _x((2, 3, 64))
    _close(TL.unembed_apply(tcfg, {}, tv["embed"], torch.from_numpy(x)),
           JL.unembed_apply(jcfg, {}, jv["embed"], jnp.asarray(x)))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_activation(act):
    x = _x((64,), scale=4.0)
    want = JL.activation(j_get_reduced(ARCH, act=act), jnp.asarray(x))
    _close(TL.activation(get_reduced(ARCH, act=act), torch.from_numpy(x)),
           want)


# ---------------------------------------------------------------------------
# mlp, for every tp_fusion, and through the channel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fusion", ["sum", "max", "max_q16", "max_q8",
                                    "concat"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_apply(fusion, act):
    jcfg = j_get_reduced(ARCH, tp_fusion=fusion, act=act)
    tcfg = get_reduced(ARCH, tp_fusion=fusion, act=act)
    jp = _values(JMLP.mlp_init, jcfg, jax.random.PRNGKey(3))
    x = _x((2, 3, 64), 4)
    want = JMLP.mlp_apply(jcfg, jp, jnp.asarray(x))
    got = TMLP.mlp_apply(tcfg, _to_torch(jp), torch.from_numpy(x))
    _close(got, want, what=fusion)


def test_mlp_apply_through_the_channel():
    jcfg, tcfg = j_get_reduced(ARCH), get_reduced(ARCH)
    jp = _values(JMLP.mlp_init, jcfg, jax.random.PRNGKey(3))
    x = _x((2, 3, 64), 4)
    p = np.array([0.05, 0.3], np.float32)
    want, acct_j = JMLP.mlp_apply(jcfg, jp, jnp.asarray(x),
                                  protocol=JP.ocs(bits=8, p_miss=p),
                                  rng=jax.random.PRNGKey(11))
    got, acct_t = TMLP.mlp_apply(tcfg, _to_torch(jp), torch.from_numpy(x),
                                 protocol=TP.ocs(bits=8, p_miss=p),
                                 rng=jr.PRNGKey(11))
    # the pooled values are D-bit bucket floors of near-equal partials
    _close(got, want)
    for f in ("rounds", "collisions", "contention_slots", "correct_frac"):
        assert np.array_equal(np.asarray(getattr(acct_j, f)),
                              _np(getattr(acct_t, f))), f


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n_kv_heads", [4, 2])
def test_attn_full(use_flash, causal, n_kv_heads):
    jcfg = j_get_reduced(ARCH, use_flash=use_flash, n_kv_heads=n_kv_heads)
    tcfg = get_reduced(ARCH, use_flash=use_flash, n_kv_heads=n_kv_heads)
    jp = _values(JA.attn_init, jcfg, jax.random.PRNGKey(4))
    jp["bq"] = jnp.asarray(_x(jp["bq"].shape, 8, 0.1))   # nonzero biases
    x = _x((2, 16, 64), 5)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    want, kv_j = JA.attn_full(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                              causal=causal, return_kv=True)
    got, kv_t = TA.attn_full(tcfg, _to_torch(jp), torch.from_numpy(x),
                             torch.from_numpy(pos.copy()), causal=causal,
                             return_kv=True)
    _close(got, want)
    for name in ("k", "v"):
        _close(kv_t[name], kv_j[name])


_LAYOUTS = {
    "worker": ({}, "worker"),
    # 3 heads over 2 workers take the plain out-projection
    "plain": (dict(n_heads=3, n_kv_heads=1, head_dim=16), "plain"),
    # 3 heads padded to 4: the worker layout with a zero-masked head
    "padded": (dict(n_heads=3, n_kv_heads=1, head_dim=16, pad_heads_to=4),
               "worker"),
}


def test_attn_full_bf16_scores():
    """``scores_dtype="bf16"``: the score matrix rounded to bfloat16 in
    both packages (JAX's ``preferred_element_type``, the port's cast of
    the float32 product) and the softmax in bfloat16; outputs agree to the
    bfloat16 resolution of the scores (2^-8 relative, atol 1e-2 here)."""
    jcfg = j_get_reduced(ARCH, scores_dtype="bf16")
    tcfg = get_reduced(ARCH, scores_dtype="bf16")
    jp = _values(JA.attn_init, jcfg, jax.random.PRNGKey(4))
    x = _x((2, 16, 64), 5)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    want = JA.attn_full(jcfg, jp, jnp.asarray(x), jnp.asarray(pos))
    got = TA.attn_full(tcfg, _to_torch(jp), torch.from_numpy(x),
                       torch.from_numpy(pos.copy()))
    _close(got, want, dict(rtol=0, atol=1e-2))


@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
def test_attn_step(layout):
    kw, want_layout = _LAYOUTS[layout]
    jcfg, tcfg = j_get_reduced(ARCH, **kw), get_reduced(ARCH, **kw)
    assert JA.attn_layout(jcfg) == TA.attn_layout(tcfg) == want_layout
    assert JA.n_heads_padded(jcfg) == TA.n_heads_padded(tcfg)
    jp = _values(JA.attn_init, jcfg, jax.random.PRNGKey(4))
    cache_np = {n: _x((3, 12, tcfg.n_kv_heads, 16), s)
                for n, s in (("k", 1), ("v", 2))}
    x = _x((3, 1, 64), 6)
    pos = np.array([0, 5, 11], np.int32)
    want, new_j = JA.attn_step(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                               jax.tree.map(jnp.asarray, cache_np))
    cache_t = params_from_jax(cache_np)
    got, new_t = TA.attn_step(tcfg, _to_torch(jp), torch.from_numpy(x),
                              torch.from_numpy(pos), cache_t)
    assert new_t is cache_t                       # updated in place
    _close(got, want)
    for name in ("k", "v"):
        _close(new_t[name], new_j[name])


def test_attn_step_clamps_past_the_cache():
    """A position at or past the cache end writes the last row, as JAX's
    ``dynamic_update_slice`` clamps (the engine's idle slots get there)."""
    jcfg, tcfg = j_get_reduced(ARCH), get_reduced(ARCH)
    jp = _values(JA.attn_init, jcfg, jax.random.PRNGKey(4))
    cache_np = {n: _x((2, 6, 4, 16), s) for n, s in (("k", 1), ("v", 2))}
    x = _x((2, 1, 64), 6)
    pos = np.array([6, 40], np.int32)
    want, new_j = JA.attn_step(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                               jax.tree.map(jnp.asarray, cache_np))
    got, new_t = TA.attn_step(tcfg, _to_torch(jp), torch.from_numpy(x),
                              torch.from_numpy(pos), params_from_jax(cache_np))
    _close(got, want)
    _close(new_t["k"], new_j["k"])


# ---------------------------------------------------------------------------
# the model: prefill, decode, decode through the channel
# ---------------------------------------------------------------------------

def _prompt(b=2, s=8, vocab=256, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("use_flash", [False, True])
def test_prefill_logits_and_cache(reduced, use_flash):
    jcfg, tcfg, jv, tv = reduced
    jm = JM.build(jcfg.with_(use_flash=use_flash))
    tm = TM.build(tcfg.with_(use_flash=use_flash))
    toks = _prompt()
    want, cache_j = jm.prefill(jv, {"tokens": jnp.asarray(toks)}, max_seq=16)
    got, cache_t = tm.prefill(tv, {"tokens": torch.from_numpy(toks)},
                              max_seq=16)
    _close(got, want)
    jl, tl = jax.tree.leaves(cache_j), tree.leaves(cache_t)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        assert a.shape == b.shape
        _close(a, b)
    _close(tm.logits(tv, {"tokens": torch.from_numpy(toks)}),
           jm.logits(jv, {"tokens": jnp.asarray(toks)}))


def _prefilled(jm, tm, jv, tv):
    toks = _prompt()
    _, cache_j = jm.prefill(jv, {"tokens": jnp.asarray(toks)}, max_seq=16)
    _, cache_t = tm.prefill(tv, {"tokens": torch.from_numpy(toks)},
                            max_seq=16)
    return cache_j, cache_t, np.array([[3], [5]], np.int32), \
        np.array([8, 8], np.int32)


def test_decode_step(reduced):
    jcfg, tcfg, jv, tv = reduced
    jm, tm = JM.build(jcfg), TM.build(tcfg)
    cache_j, cache_t, tok, pos = _prefilled(jm, tm, jv, tv)
    for _ in range(3):
        want, cache_j = jm.decode_step(jv, jnp.asarray(tok),
                                       jnp.asarray(pos), cache_j)
        got, cache_t = tm.decode_step(tv, torch.from_numpy(tok),
                                      torch.from_numpy(pos), cache_t)
        _close(got, want)
        tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)[:, None]
        pos = pos + 1
    for a, b in zip(tree.leaves(cache_t), jax.tree.leaves(cache_j)):
        _close(a, b)


@pytest.mark.parametrize("p_miss", [0.0, 0.05, 0.4])
def test_decode_step_channel(reduced, p_miss):
    """Logits within FLOAT_TOL; the channel accounting of the tick (24
    sites' summed rounds, collisions, slots, correct fractions) bitwise —
    the sensing keys are the JAX package's split/fold_in keys."""
    jcfg, tcfg, jv, tv = reduced
    jm, tm = JM.build(jcfg), TM.build(tcfg)
    cache_j, cache_t, tok, pos = _prefilled(jm, tm, jv, tv)
    p = np.full((2,), p_miss, np.float32)
    for tick in range(3):
        want, cache_j, chan_j = jm.decode_step_channel(
            jv, jnp.asarray(tok), jnp.asarray(pos), cache_j,
            JP.ocs(bits=8, p_miss=p),
            jax.random.fold_in(jax.random.PRNGKey(0), tick))
        got, cache_t, chan_t = tm.decode_step_channel(
            tv, torch.from_numpy(tok), torch.from_numpy(pos), cache_t,
            TP.ocs(bits=8, p_miss=p), jr.fold_in(jr.PRNGKey(0), tick))
        _close(got, want)
        assert set(chan_t) == set(chan_j)
        for k in chan_j:
            assert chan_t[k].dtype == {jnp.int32: torch.int32,
                                       jnp.float32: torch.float32}[
                chan_j[k].dtype.type]
            assert np.array_equal(_np(chan_t[k]), np.asarray(chan_j[k])), k
        assert int(chan_t["calls"]) == tm.channel_sites() == 2
        tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)[:, None]
        pos = pos + 1


# ---------------------------------------------------------------------------
# parameters across: bfloat16 trees
# ---------------------------------------------------------------------------

def test_params_from_jax_carries_bf16_tree_bitwise():
    """``torch.from_numpy`` refuses ``ml_dtypes.bfloat16``; the bf16
    parameter tree of the reduced qwen config comes across bit for bit,
    leaf for leaf, in the port's own init layout."""
    jcfg = j_get_reduced(ARCH, dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    jv = _values(JM.init, jcfg, jax.random.PRNGKey(0))
    tv = _to_torch(jv)
    jl = jax.tree.leaves(jv)
    tl = tree.leaves(tv)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert np.array_equal(a.view(torch.int16).numpy().view(np.uint16),
                              np.asarray(b).view(np.uint16))
    tcfg = get_reduced(ARCH, dtype=torch.bfloat16,
                       param_dtype=torch.bfloat16)
    own = TM.init(tcfg, torch.Generator().manual_seed(0))
    assert tree.map(lambda t: (tuple(t.shape), t.dtype), own) == \
        tree.map(lambda t: (tuple(t.shape), t.dtype), tv)


# ---------------------------------------------------------------------------
# MoE plans: blocks, prefill, decode and decode through the channel
# ---------------------------------------------------------------------------

_MOE_PLANS = {
    "qwen3-moe": ("qwen3-moe-30b-a3b", {}),
    "qwen3-moe gather": ("qwen3-moe-30b-a3b", dict(moe_impl="gather")),
    "llama4 shared max": ("llama4-scout-17b-a16e", dict(tp_fusion="max")),
    # attention + mlp, then attention + moe: one channel site a period
    "mixed": ("qwen3-moe-30b-a3b", dict(ffn_pattern=("mlp", "moe"))),
}


@pytest.fixture(scope="module", params=sorted(_MOE_PLANS))
def moe_plan(request):
    """(JAX cfg, port cfg, JAX values, port values) of an MoE plan."""
    arch, kw = _MOE_PLANS[request.param]
    jcfg, tcfg = j_get_reduced(arch, **kw), get_reduced(arch, **kw)
    jv = _values(JM.init, jcfg, jax.random.PRNGKey(1))
    return jcfg, tcfg, jv, _to_torch(jv)


def _vocab_prompt(cfg, b=2, s=8, seed=0):
    return _prompt(b, s, cfg.vocab_size, seed)


def test_moe_blocks_match_jax(moe_plan):
    """``block_full``, ``block_prefill`` and ``block_step`` (with and
    without a protocol) of every position of the period: outputs, aux
    and caches; an MoE block's channel dict is zeros, bitwise."""
    jcfg, tcfg, jv, tv = moe_plan
    x = _x((2, 8, jcfg.d_model), 7)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (2, 8)).copy()
    for i, (mixer, ffn) in enumerate(jcfg.layer_plan()):
        jp = jax.tree.map(lambda a: a[0], jv["blocks"][f"pos{i}"])
        tp = tree.map(lambda a: a[0], tv["blocks"][f"pos{i}"])
        want, aux_j = JT.block_full(jcfg, jp, jnp.asarray(x),
                                    jnp.asarray(pos), mixer, ffn)
        got, aux_t = TT.block_full(tcfg, tp, torch.from_numpy(x),
                                   torch.from_numpy(pos), mixer, ffn)
        _close(got, want, what=ffn)
        _close(aux_t, aux_j, what=ffn)
        want, cache_j, aux_j = JT.block_prefill(
            jcfg, jp, jnp.asarray(x), jnp.asarray(pos), mixer, ffn, 12)
        got, cache_t, aux_t = TT.block_prefill(
            tcfg, tp, torch.from_numpy(x), torch.from_numpy(pos), mixer,
            ffn, 12)
        _close(got, want)
        _close(aux_t, aux_j)
        for name in ("k", "v"):
            _close(cache_t["self"][name], cache_j["self"][name])
        x1 = _x((2, 1, jcfg.d_model), 8)
        p1 = np.array([8, 8], np.int32)
        p = np.full((jcfg.n_workers,), 0.05, np.float32)
        want, _, aux_j, chan_j = JT.block_step(
            jcfg, jp, jnp.asarray(x1), jnp.asarray(p1), cache_j, mixer, ffn,
            protocol=JP.ocs(bits=8, p_miss=p), rng=jax.random.PRNGKey(5))
        got, _, aux_t, chan_t = TT.block_step(
            tcfg, tp, torch.from_numpy(x1), torch.from_numpy(p1), cache_t,
            mixer, ffn, protocol=TP.ocs(bits=8, p_miss=p),
            rng=jr.PRNGKey(5))
        _close(got, want)
        _close(aux_t, aux_j)
        for k in chan_j:
            assert np.array_equal(_np(chan_t[k]), np.asarray(chan_j[k])), k
        if ffn == "moe":
            assert all(int(chan_t[k]) == 0 for k in chan_t)


@pytest.mark.parametrize("use_flash", [False, True])
def test_moe_prefill_logits_and_cache(moe_plan, use_flash):
    jcfg, tcfg, jv, tv = moe_plan
    jm = JM.build(jcfg.with_(use_flash=use_flash))
    tm = TM.build(tcfg.with_(use_flash=use_flash))
    toks = _vocab_prompt(jcfg)
    want, cache_j = jm.prefill(jv, {"tokens": jnp.asarray(toks)}, max_seq=16)
    got, cache_t = tm.prefill(tv, {"tokens": torch.from_numpy(toks)},
                              max_seq=16)
    _close(got, want)
    for a, b in zip(tree.leaves(cache_t), jax.tree.leaves(cache_j)):
        assert a.shape == b.shape
        _close(a, b)
    batch = {"tokens": toks, "targets": _vocab_prompt(jcfg, seed=1)}
    lj, mj = jm.loss(jv, jax.tree.map(jnp.asarray, batch))
    lt, mt = tm.loss(tv, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(lt, lj)
    _close(mt["aux"], mj["aux"])


@pytest.mark.parametrize("p_miss", [None, 0.05])
def test_moe_decode_steps(moe_plan, p_miss):
    """Three decode ticks after a prefill, channel-free and through OCS:
    logits within FLOAT_TOL, the tick's channel dict bitwise, its
    ``calls`` the model's channel sites (0 for an all-MoE plan)."""
    jcfg, tcfg, jv, tv = moe_plan
    jm, tm = JM.build(jcfg), TM.build(tcfg)
    toks = _vocab_prompt(jcfg)
    _, cache_j = jm.prefill(jv, {"tokens": jnp.asarray(toks)}, max_seq=16)
    _, cache_t = tm.prefill(tv, {"tokens": torch.from_numpy(toks)},
                            max_seq=16)
    tok, pos = np.array([[3], [5]], np.int32), np.array([8, 8], np.int32)
    sites = sum(1 for _, f in jcfg.layer_plan() if f == "mlp") * \
        jcfg.n_periods
    assert tm.channel_sites() == jm.channel_sites() == sites
    for tick in range(3):
        if p_miss is None:
            want, cache_j = jm.decode_step(jv, jnp.asarray(tok),
                                           jnp.asarray(pos), cache_j)
            got, cache_t = tm.decode_step(tv, torch.from_numpy(tok),
                                          torch.from_numpy(pos), cache_t)
        else:
            p = np.full((jcfg.n_workers,), p_miss, np.float32)
            want, cache_j, chan_j = jm.decode_step_channel(
                jv, jnp.asarray(tok), jnp.asarray(pos), cache_j,
                JP.ocs(bits=8, p_miss=p),
                jax.random.fold_in(jax.random.PRNGKey(0), tick))
            got, cache_t, chan_t = tm.decode_step_channel(
                tv, torch.from_numpy(tok), torch.from_numpy(pos), cache_t,
                TP.ocs(bits=8, p_miss=p), jr.fold_in(jr.PRNGKey(0), tick))
            assert set(chan_t) == set(chan_j)
            for k in chan_j:
                assert np.array_equal(_np(chan_t[k]),
                                      np.asarray(chan_j[k])), k
            assert int(chan_t["calls"]) == sites
        _close(got, want)
        tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)[:, None]
        pos = pos + 1
    for a, b in zip(tree.leaves(cache_t), jax.tree.leaves(cache_j)):
        _close(a, b)


# ---------------------------------------------------------------------------
# remat: transformer.stack_full under torch.utils.checkpoint
# ---------------------------------------------------------------------------

def _lm_batch(vocab, b=2, s=8, seed=3):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, vocab, (b, s)).astype(np.int32)
            for k in ("tokens", "targets")}


@pytest.mark.parametrize("arch,overrides", [
    (ARCH, dict(tp_fusion="max", n_workers=4)),
    ("qwen3-moe-30b-a3b", dict(tp_fusion="max")),
    ("xlstm-125m", {})], ids=["qwen1.5", "qwen3-moe", "xlstm"])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_is_bitwise_the_step_without_it(arch, overrides, policy):
    """Each period recomputed in the backward gives the loss and every
    gradient of the run that keeps its activations, bit for bit: the
    recompute runs the same ops on the same inputs."""
    from repro_torch.train.train_step import value_and_grad
    got = {}
    for remat in (False, True):
        cfg = get_reduced(arch, remat=remat, remat_policy=policy,
                          **overrides)
        tm = TM.build(cfg)
        tv = tm.init(torch.Generator().manual_seed(0))
        batch = {k: torch.from_numpy(v).long() for k, v in
                 _lm_batch(cfg.vocab_size).items()}
        got[remat] = value_and_grad(tm.loss, tv, batch)
    (l0, _, g0), (l1, _, g1) = got[False], got[True]
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b)
               for a, b in zip(tree.leaves(g0), tree.leaves(g1)))


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_matches_jax_value_and_grad(reduced, policy):
    """The port's remat step against ``jax.value_and_grad`` of the JAX
    config with ``remat=True`` (``jax.checkpoint`` around the scan body):
    the loss within ``FLOAT_TOL``, the gradients within ``FLOAT_TOL`` of
    their leaf's largest magnitude (the packages reduce in other
    orders)."""
    from repro_torch.train.train_step import value_and_grad
    jcfg, _, jv, tv = reduced
    jcfg = jcfg.with_(remat=True, remat_policy=policy)
    tcfg = get_reduced(ARCH, remat=True, remat_policy=policy)
    batch = _lm_batch(tcfg.vocab_size)
    want_loss, want = jax.value_and_grad(
        lambda v: JM.loss_fn(jcfg, v, {k: jnp.asarray(x) for k, x in
                                       batch.items()})[0])(jv)
    got_loss, _, got = value_and_grad(
        TM.build(tcfg).loss, tv,
        {k: torch.from_numpy(x) for k, x in batch.items()})
    _close(got_loss, want_loss, what="loss")
    want = _to_torch(want)
    for a, b in zip(tree.leaves(got), tree.leaves(want)):
        scale = float(b.abs().max()) or 1.0
        _close(a / scale, b / scale, what="gradient")


@pytest.mark.parametrize("fsdp", [False, True], ids=["zero", "fsdp"])
def test_remat_lowers_the_reduced_cells_fake_peak(fsdp, monkeypatch):
    """The reduced glm4 train cell on a fake (2 x 4) mesh, with ZeRO or
    with FSDP forced: with remat the backward holds a period's
    activations at a time, so the traced peak falls; under FSDP the
    recompute runs under the forward's mesh scope and gathers the
    period's parameters again, where without remat the backward gathers
    what autograd saved of them: as many all-gathers."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as tmesh
    if fsdp:
        monkeypatch.setattr(dryrun, "FSDP_PARAM_BYTES", 0)
    shape = ShapeConfig("t", "train", 16, 8)
    got = {}
    for remat in (False, True):
        cfg = get_reduced("glm4-9b", n_workers=4, tp_fusion="max",
                          n_layers=4, remat=remat)
        with dryrun.fake_world(8):
            mesh = tmesh.make_mesh(2, 4)
            rules = tmesh.rules_for(shape.name, shape.global_batch, mesh)
            got[remat] = dryrun.trace(dryrun.build_step, cfg, shape, mesh,
                                      rules, 1, "cpu")
    assert got[True]["info"]["fsdp"] == fsdp
    peaks = {k: g["peak"]["cpu"]["Total"] for k, g in got.items()}
    assert peaks[True] < peaks[False], peaks
    gathers = {k: g["coll"].counts.get("all-gather", 0)
               for k, g in got.items()}
    assert gathers[True] == gathers[False] > 0, gathers
