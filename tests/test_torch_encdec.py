"""The port's encoder-decoder, cross-attention, patch/audio frontends and
sinusoidal positions (``repro_torch.models``) against the JAX package, at
the reduced whisper-base and pixtral-12b configs in float32.

Both packages start from the JAX package's parameters, carried across by
``repro_torch.convert.params_from_jax``, and see the same seeded numpy
inputs.

Tolerances, each for one reason:
- ``SIN_TOL`` (atol 1e-6): the sinusoid table goes through two libraries'
  ``pow``, ``sin`` and ``cos``.  Measured on the CPU: ``pow`` differs by
  one ulp in one column at d_model 512, and the table by at most
  5.96e-08 (half an ulp at 1.0) at (8, 64), (448, 512) and (1500, 512),
  with angles up to ~1,500 rad.
- ``FLOAT_TOL`` (rtol 1e-5, atol 1e-5): products and sums run in another
  order in XLA's CPU dot than in PyTorch's, a few ulp an operation, as in
  ``test_torch_models.py``; the whisper logits here are O(10-100) (a tied
  table of unit scale) and the measured gaps ~1e-5.
- ``GRAD_TOL`` (rtol 1e-4, atol 1e-5): a gradient sums those gaps over
  the backward through both stacks.
- The trainer histories: ``LOSS_RTOL`` 1e-5 and ``PARAM_ATOL`` 1e-4, as
  in ``test_torch_trainer.py`` (float32 sums in another order over a few
  AdamW steps).
What is selected rather than computed (greedy tokens, the channel
accounting, the ``_max_pos`` table length and its clamped rows, a resumed
run against an uninterrupted one) is compared bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.data import pipeline as jpipe
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import transformer as JT
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.parallel.sharding import split_tree
from repro.protocol import Protocol as JP
from repro.train import trainer as jtrainer
from repro_torch import random as jr
from repro_torch import tree
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import params_from_jax
from repro_torch.data import pipeline as tpipe
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.protocol import Protocol as TP
from repro_torch.train import trainer
from repro_torch.train.trainer import TrainerConfig

torch.set_num_threads(1)

SIN_TOL = dict(rtol=0, atol=1e-6)
FLOAT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4
WHISPER, PIXTRAL = "whisper-base", "pixtral-12b"
S_ENC, S_DEC, MAX_SEQ = 8, 6, 32


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _close(got, want, tol=FLOAT_TOL, what=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **tol)


def _to_torch(values):
    return params_from_jax(jax.tree.map(np.asarray, values))


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.fixture(scope="module", params=[WHISPER, PIXTRAL])
def encdec(request):
    """(arch, JAX cfg, port cfg, JAX values, port values)."""
    arch = request.param
    jcfg, tcfg = j_get_reduced(arch), get_reduced(arch)
    jv, _ = split_tree(JM.init(jcfg, jax.random.PRNGKey(0)))
    return arch, jcfg, tcfg, jv, _to_torch(jv)


def _batch(cfg, b=2, seed=0, targets=True):
    """The numpy batch of the model's convention: whisper's frames and
    decoder tokens, pixtral's patch features."""
    out = {"feats": _x((b, S_ENC, cfg.frontend_dim), seed)}
    s = S_ENC
    if cfg.encoder_decoder:
        s = S_DEC
        out["tokens"] = _tokens(b, s, cfg.vocab_size, seed + 1)
    if targets:
        out["targets"] = _tokens(b, s, cfg.vocab_size, seed + 2)
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# configs, layers
# ---------------------------------------------------------------------------

def test_param_count_and_tree_match_jax():
    """``param_count`` of both full configs (the frontend projection, the
    encoder and the cross-attentions counted) equals the JAX package's,
    and the port's own init builds the JAX tree leaf for leaf at both
    reduced configs."""
    from repro.configs import get_config as j_get_config
    for arch, want in ((WHISPER, 70_648_320), (PIXTRAL, 12_253_020_160)):
        assert get_config(arch).param_count() == \
            j_get_config(arch).param_count() == want
    for arch in (WHISPER, PIXTRAL):
        jv, _ = split_tree(JM.init(j_get_reduced(arch),
                                   jax.random.PRNGKey(0)))
        own = TM.init(get_reduced(arch), torch.Generator().manual_seed(0))
        assert tree.map(lambda t: (tuple(t.shape), t.dtype), own) == \
            tree.map(lambda t: (tuple(t.shape), t.dtype), _to_torch(jv))
        assert "frontend_proj" in own["embed"]
        assert ("encoder" in own) == (arch == WHISPER)


@pytest.mark.parametrize("seq_len,d_model", [(8, 64), (448, 512),
                                             (1500, 512)])
def test_sinusoidal_positions(seq_len, d_model):
    got = TL.sinusoidal_positions(seq_len, d_model)
    want = JL.sinusoidal_positions(seq_len, d_model)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got, want, SIN_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_frontend(encdec, dtype):
    """The features cast to ``cfg.dtype`` before the projection: float32
    within FLOAT_TOL; in bfloat16 bitwise (measured: both packages sum
    the 16 products of a row in float32 and round once)."""
    arch, jcfg, tcfg, jv, tv = encdec
    if dtype == "bfloat16":
        jcfg = jcfg.with_(dtype=jnp.bfloat16)
        tcfg = tcfg.with_(dtype=torch.bfloat16)
    feats = _x((2, S_ENC, jcfg.frontend_dim), 3)
    got = TL.embed_frontend(tcfg, tv["embed"], torch.from_numpy(feats))
    want = JL.embed_frontend(jcfg, jv["embed"], jnp.asarray(feats))
    assert got.dtype == tcfg.dtype
    if dtype == "float32":
        _close(got, want)
    else:
        assert np.array_equal(got.float().numpy(),
                              np.asarray(want, np.float32))


# ---------------------------------------------------------------------------
# cross-attention
# ---------------------------------------------------------------------------

_LAYOUTS = {"worker sum": dict(), "worker max": dict(tp_fusion="max"),
            "plain": dict(n_workers=8)}


@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
def test_cross_attention(layout):
    """``attn_full`` over an encoder output (no rotary positions, no
    flash even with ``use_flash``, no mask; the keys and values returned
    unpadded) and ``attn_step(cross=True)`` over them (all valid, the
    cache left as it was), in the worker (sum and max) and plain
    layouts."""
    kw = _LAYOUTS[layout]
    jcfg = j_get_reduced(WHISPER, use_flash=True, **kw)
    tcfg = get_reduced(WHISPER, use_flash=True, **kw)
    assert TA.attn_layout(tcfg) == JA.attn_layout(jcfg) == layout.split()[0]
    jp, _ = split_tree(JA.attn_init(jcfg, jax.random.PRNGKey(4),
                                    cross=True))
    tp = _to_torch(jp)
    x, enc = _x((2, 5, 64), 5), _x((2, S_ENC, 64), 6)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5))
    want, kv_j = JA.attn_full(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                              causal=False, kv_x=jnp.asarray(enc),
                              return_kv=True)
    got, kv_t = TA.attn_full(tcfg, tp, torch.from_numpy(x),
                             torch.from_numpy(pos.copy()), causal=False,
                             kv_x=torch.from_numpy(enc), return_kv=True)
    _close(got, want)
    for name in ("k", "v"):
        assert tuple(kv_t[name].shape) == (2, S_ENC, 4, 16)
        _close(kv_t[name], kv_j[name])
    xs = _x((2, 1, 64), 7)
    step_pos = np.array([3, 40], np.int32)
    before = tree.map(torch.clone, kv_t)
    want, cj = JA.attn_step(jcfg, jp, jnp.asarray(xs), jnp.asarray(step_pos),
                            kv_j, cross=True)
    got, ct = TA.attn_step(tcfg, tp, torch.from_numpy(xs),
                           torch.from_numpy(step_pos), kv_t, cross=True)
    _close(got, want)
    assert ct is kv_t
    for name in ("k", "v"):
        assert torch.equal(ct[name], before[name])


# ---------------------------------------------------------------------------
# blocks and stacks with the encoder's output
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fusion", ["sum", "max"])
def test_cross_blocks_and_stacks(fusion):
    """A decoder block with its cross-attention: ``block_full``,
    ``block_prefill`` (its ``"cross"`` cache the encoder's keys and
    values) and ``block_step`` with and without a protocol (the channel
    dict bitwise); then ``stack_full`` and ``stack_prefill`` with
    ``enc_out`` and the stacked cache with ``cross_len``."""
    jcfg = j_get_reduced(WHISPER, tp_fusion=fusion)
    tcfg = get_reduced(WHISPER, tp_fusion=fusion)
    jp, _ = split_tree(JT.block_init(jcfg, jax.random.PRNGKey(8), "attn",
                                     "mlp", cross=True))
    tp = _to_torch(jp)
    own = TT.block_init(tcfg, torch.Generator().manual_seed(0), "attn", "mlp",
                        cross=True)
    assert sorted(own) == sorted(tp) == ["cross", "ffn", "mixer", "norm1",
                                         "norm2", "norm_cross"]
    x, enc = _x((2, S_DEC, 64), 9), _x((2, S_ENC, 64), 10)
    pos = np.broadcast_to(np.arange(S_DEC, dtype=np.int32), (2, S_DEC)).copy()
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
    je, te = jnp.asarray(enc), torch.from_numpy(enc)
    want, _ = JT.block_full(jcfg, jp, jx, jpos, "attn", "mlp", je)
    got, _ = TT.block_full(tcfg, tp, tx, tpos, "attn", "mlp", te)
    _close(got, want)
    want, cj, _ = JT.block_prefill(jcfg, jp, jx, jpos, "attn", "mlp", 16, je)
    got, ct, _ = TT.block_prefill(tcfg, tp, tx, tpos, "attn", "mlp", 16, te)
    _close(got, want)
    assert sorted(ct) == sorted(cj) == ["cross", "self"]
    assert tuple(ct["cross"]["k"].shape) == (2, S_ENC, 4, 16)
    for a, b in zip(tree.leaves(ct), jax.tree.leaves(cj)):
        _close(a, b)
    xs = _x((2, 1, 64), 11)
    sp = np.array([S_DEC, S_DEC], np.int32)
    want, cj, _ = JT.block_step(jcfg, jp, jnp.asarray(xs), jnp.asarray(sp),
                                cj, "attn", "mlp")
    got, ct, _ = TT.block_step(tcfg, tp, torch.from_numpy(xs),
                               torch.from_numpy(sp), ct, "attn", "mlp")
    _close(got, want)
    for a, b in zip(tree.leaves(ct), jax.tree.leaves(cj)):
        _close(a, b)
    p = np.full((2,), 0.05, np.float32)
    want, _, _, chan_j = JT.block_step(
        jcfg, jp, jnp.asarray(xs), jnp.asarray(sp + 1), cj, "attn", "mlp",
        protocol=JP.ocs(bits=8, p_miss=p), rng=jax.random.PRNGKey(3))
    got, _, _, chan_t = TT.block_step(
        tcfg, tp, torch.from_numpy(xs), torch.from_numpy(sp + 1), ct, "attn",
        "mlp", protocol=TP.ocs(bits=8, p_miss=p), rng=jr.PRNGKey(3))
    _close(got, want)
    for k in chan_j:
        assert np.array_equal(_np(chan_t[k]), np.asarray(chan_j[k])), k

    plan = jcfg.layer_plan()
    sj, _ = split_tree(JT.stack_init(jcfg, jax.random.PRNGKey(12), plan, 2,
                                     cross=True))
    st = _to_torch(sj)
    want, _ = JT.stack_full(jcfg, sj, jx, jpos, plan, enc_out=je)
    got, _ = TT.stack_full(tcfg, st, tx, tpos, plan, enc_out=te)
    _close(got, want)
    want, cj, _ = JT.stack_prefill(jcfg, sj, jx, jpos, plan, 16, enc_out=je)
    got, ct, _ = TT.stack_prefill(tcfg, st, tx, tpos, plan, 16, enc_out=te)
    _close(got, want)
    jl, tl = jax.tree.leaves(cj), tree.leaves(ct)
    assert len(jl) == len(tl) == 4
    for a, b in zip(tl, jl):
        assert tuple(a.shape) == b.shape
        _close(a, b)
    empty = TT.stack_cache_init(tcfg, plan, 2, 2, 16, torch.float32,
                                cross_len=S_ENC)
    assert tree.map(lambda t: tuple(t.shape), empty) == \
        tree.map(lambda t: tuple(t.shape), ct)


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", WHISPER])
def test_stack_init_equals_the_stacked_periods(arch, cross, n):
    """``stack_init`` fills one allocation per leaf period by period (one
    period is viewed with its axis, not copied); its values from a seed
    are bitwise those of drawing every period's tree from the same
    generator and ``torch.stack``-ing them, the earlier construction."""
    cfg = get_reduced(arch, dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    plan = cfg.layer_plan()
    got = TT.stack_init(cfg, torch.Generator().manual_seed(5), plan, n,
                        cross=cross)
    gen = torch.Generator().manual_seed(5)
    periods = [{f"pos{i}": TT.block_init(cfg, gen, mixer, ffn, cross=cross)
                for i, (mixer, ffn) in enumerate(plan)} for _ in range(n)]
    want = tree.map(lambda *xs: torch.stack(xs), *periods)
    assert tree.map(lambda t: (tuple(t.shape), t.dtype), got) == \
        tree.map(lambda t: (tuple(t.shape), t.dtype), want)
    for a, b in zip(tree.leaves(got), tree.leaves(want)):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


# ---------------------------------------------------------------------------
# the model: loss, gradients, prefill, decode, the channel
# ---------------------------------------------------------------------------

def test_loss_and_gradients(encdec):
    """``loss_fn`` (whisper: the encoder over the frames, the decoder over
    its tokens; pixtral: the projected patch features) and its gradient
    in every leaf against ``jax.grad``; pixtral's token table has none in
    either package (its training forward never reads it)."""
    arch, jcfg, tcfg, jv, tv = encdec
    batch = _batch(jcfg)
    (want, jmet), gj = jax.value_and_grad(
        lambda v: JM.loss_fn(jcfg, v, _j(batch)), has_aux=True)(jv)
    live = tree.map(lambda t: t.clone().requires_grad_(True), tv)
    got, tmet = TM.loss_fn(tcfg, live, _t(batch))
    _close(got, want)
    _close(tmet["nll"], jmet["nll"])
    got.backward()
    for (path, w), leaf in zip(jax.tree_util.tree_flatten_with_path(gj)[0],
                               tree.leaves(live)):
        name = jax.tree_util.keystr(path)
        if arch == PIXTRAL and name == "['embed']['tokens']":
            assert leaf.grad is None and not np.asarray(w).any()
            continue
        _close(leaf.grad, w, GRAD_TOL, name)
    _close(TM.logits_fn(tcfg, tv, _t(batch)), JM.logits_fn(jcfg, jv,
                                                           _j(batch)))


def _prefilled(jcfg, tcfg, jv, tv):
    batch = _batch(jcfg, targets=False)
    want, cj = JM.prefill(jcfg, jv, _j(batch), max_seq=MAX_SEQ)
    got, ct = TM.prefill(tcfg, tv, _t(batch), max_seq=MAX_SEQ)
    return want, cj, got, ct, (S_DEC if jcfg.encoder_decoder else S_ENC)


def test_prefill_and_decode_step(encdec):
    """``prefill`` (logits and every cache leaf, the cross cache unpadded)
    then 4 greedy ``decode_step`` ticks: logits within FLOAT_TOL and the
    greedy tokens equal."""
    arch, jcfg, tcfg, jv, tv = encdec
    want, cj, got, ct, s = _prefilled(jcfg, tcfg, jv, tv)
    _close(got, want)
    jl, tl = jax.tree.leaves(cj), tree.leaves(ct)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        assert tuple(a.shape) == b.shape
        _close(a, b)
    if arch == WHISPER:
        assert tuple(ct["pos0"]["cross"]["k"].shape) == (2, 2, S_ENC, 4, 16)
    tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)[:, None]
    pos = np.full((2,), s, np.int32)
    for _ in range(4):
        want, cj = JM.decode_step(jcfg, jv, jnp.asarray(tok),
                                  jnp.asarray(pos), cj)
        got, ct = TM.decode_step(tcfg, tv, torch.from_numpy(tok),
                                 torch.from_numpy(pos), ct)
        _close(got, want)
        nxt = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
        assert np.array_equal(torch.argmax(got, -1).numpy(), nxt)
        tok, pos = nxt[:, None], pos + 1


@pytest.mark.parametrize("p_miss", [0.0, 0.05, 0.4])
def test_decode_step_channel(encdec, p_miss):
    """3 ticks through the channel: logits within FLOAT_TOL, the greedy
    tokens and the channel accounting of the tick (2 mlp sites) bitwise."""
    arch, jcfg, tcfg, jv, tv = encdec
    want, cj, got, ct, s = _prefilled(jcfg, tcfg, jv, tv)
    tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)[:, None]
    pos = np.full((2,), s, np.int32)
    p = np.full((2,), p_miss, np.float32)
    for tick in range(3):
        want, cj, chan_j = JM.decode_step_channel(
            jcfg, jv, jnp.asarray(tok), jnp.asarray(pos), cj,
            JP.ocs(bits=8, p_miss=p),
            jax.random.fold_in(jax.random.PRNGKey(0), tick))
        got, ct, chan_t = TM.decode_step_channel(
            tcfg, tv, torch.from_numpy(tok), torch.from_numpy(pos), ct,
            TP.ocs(bits=8, p_miss=p), jr.fold_in(jr.PRNGKey(0), tick))
        _close(got, want)
        assert set(chan_t) == set(chan_j)
        for k in chan_j:
            assert np.array_equal(_np(chan_t[k]), np.asarray(chan_j[k])), k
        assert int(chan_t["calls"]) == TM.channel_sites(tcfg) == 2
        nxt = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
        assert np.array_equal(torch.argmax(got, -1).numpy(), nxt)
        tok, pos = nxt[:, None], pos + 1


def test_max_pos_clamps_past_the_encoder_length():
    """Both packages size a decode step's sinusoid table by the first
    stacked attention cache in sorted leaf order: whisper's cross cache,
    ``S_ENC`` rows, not the decoder's ``MAX_SEQ``; every position at or
    past ``S_ENC`` reads row ``S_ENC - 1`` (ROADMAP queue 3, open in the
    reference).  Then greedy decoding from position 6 to 14, across
    ``S_ENC``, in both packages: logits within FLOAT_TOL, tokens equal."""
    jcfg, tcfg = j_get_reduced(WHISPER), get_reduced(WHISPER)
    jv, _ = split_tree(JM.init(jcfg, jax.random.PRNGKey(0)))
    tv = _to_torch(jv)
    want, cj, got, ct, s = _prefilled(jcfg, tcfg, jv, tv)
    assert JM._max_pos(jcfg, cj) == TM._max_pos(tcfg, ct) == S_ENC
    pos = np.array([12, 31], np.int32)
    pe_j = JL.sinusoidal_positions(JM._max_pos(jcfg, cj), 64)[
        jnp.asarray(pos)]
    assert np.array_equal(np.asarray(pe_j[0]), np.asarray(pe_j[1]))
    row = JL.sinusoidal_positions(S_ENC, 64)[S_ENC - 1]
    assert np.array_equal(np.asarray(pe_j[0]), np.asarray(row))
    tok = torch.tensor([[3], [5]], dtype=torch.int32)
    got_x = TM._embed_token(tcfg, tv, tok, torch.from_numpy(pos), ct)
    last = TL.sinusoidal_positions(S_ENC, 64)[S_ENC - 1]
    assert torch.equal(got_x, TL.embed_tokens(tcfg, tv["embed"], tok)
                       + last[None, None])
    tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)[:, None]
    step = np.full((2,), s, np.int32)
    while step[0] < 15:
        want, cj = JM.decode_step(jcfg, jv, jnp.asarray(tok),
                                  jnp.asarray(step), cj)
        got, ct = TM.decode_step(tcfg, tv, torch.from_numpy(tok),
                                 torch.from_numpy(step), ct)
        _close(got, want, what=f"position {step[0]}")
        nxt = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
        assert np.array_equal(torch.argmax(got, -1).numpy(), nxt)
        tok, step = nxt[:, None], step + 1


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def _pipes(jcfg, tcfg):
    return (jpipe.for_model(jcfg, batch=4, seq_len=16, seed=1),
            tpipe.for_model(tcfg, batch=4, seq_len=16, seed=1))


def test_trainer_matches_jax(encdec):
    """5 AdamW trainer steps of each package from one init on the
    pipeline's frontend batches (whisper: 16 frames and 16 decoder
    tokens; pixtral: 16 patches): nll within the float-order tolerance,
    lr within an ulp, parameters within 1e-4.  Pixtral's token table
    gets a zero gradient in both, and weight decay still moves it."""
    arch, jcfg, tcfg, jv, tv = encdec
    jpc, tpc = _pipes(jcfg, tcfg)
    want = jtrainer.train(
        lambda v, b: JM.loss_fn(jcfg, v, b), jv,
        jopt.adamw(jsched.linear_warmup_cosine(3e-3, 3, 5)),
        lambda s: jpipe.batch_for_step(jpc, s),
        jtrainer.TrainerConfig(steps=5, log_every=1))
    got = trainer.train(
        lambda v, b: TM.loss_fn(tcfg, v, b), tv,
        topt.adamw(tsched.linear_warmup_cosine(3e-3, 3, 5)),
        lambda s: tpipe.batch_for_step(tpc, s, device="cpu"),
        TrainerConfig(steps=5, log_every=1))
    assert sorted(got.history[0]) == sorted(want.history[0])
    for a, b in zip(got.history, want.history):
        np.testing.assert_allclose(a["nll"], b["nll"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(a["lr"], b["lr"], rtol=2e-7)
    a, b = tree.leaves(got.values), jax.tree.leaves(want.values)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=PARAM_ATOL,
                                   rtol=0)
    table = got.values["embed"]["tokens"]
    assert not torch.equal(table, tv["embed"]["tokens"])
    if arch == PIXTRAL:
        # decay alone: tokens * prod(1 - lr_t * wd) over the steps
        np.testing.assert_allclose(
            table.numpy(), np.asarray(want.values["embed"]["tokens"]),
            rtol=1e-6, atol=0)


def test_resume_equals_uninterrupted_bitwise(tmp_path):
    """Whisper interrupted after its step-3 checkpoint and relaunched:
    values (the encoder, its norm and the cross-attentions among them),
    optimizer state and history from step 3 on equal an uninterrupted
    run's bit for bit."""
    tcfg = get_reduced(WHISPER)
    m = TM.build(tcfg)
    tv = m.init(torch.Generator().manual_seed(0))
    pc = tpipe.for_model(tcfg, batch=4, seq_len=16, seed=1)

    def run(steps, d=None):
        return trainer.train(
            m.loss, tv, topt.adamw(tsched.linear_warmup_cosine(3e-3, 3, 6)),
            lambda s: tpipe.batch_for_step(pc, s, device="cpu"),
            TrainerConfig(steps=steps, log_every=1, ckpt_dir=d,
                          ckpt_every=3))

    full = run(6)
    d = str(tmp_path)
    run(3, d)
    res = run(6, d)
    assert res.history[0]["step"] == 3
    assert "encoder" in res.values and "cross" in res.values["blocks"]["pos0"]
    for a, b in zip(tree.leaves((res.values, res.opt_state)),
                    tree.leaves((full.values, full.opt_state))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    rows = lambda h, first: [{k: v for k, v in r.items()
                              if k != "step_time_s"}
                             for r in h if r["step"] >= first]
    assert rows(res.history, 0) == rows(full.history, 3)
