"""The port's recurrent mixers (``repro_torch.models.{ssm, mamba}``), the
FFN-less blocks and the xlstm-125m and jamba-1.5-large-398b plans against
the JAX package, at ``get_reduced`` in float32.

Both packages start from the JAX package's parameters, carried across by
``repro_torch.convert.params_from_jax``, and see the same seeded numpy
inputs.

Tolerances, each for one reason:
- ``FLOAT_TOL`` (rtol 1e-5, atol 1e-5): one layer's products and sums run
  in another order in XLA's CPU dot than in PyTorch's, a few ulp an
  operation, as in ``test_torch_models.py``.
- ``SCAN_TOL`` (rtol 1e-5, atol 5e-5): the time scans carry those ulp
  through every step (the mLSTM memory, the sLSTM and mamba states), and
  ``log_sigmoid``/``exp`` are two libraries' functions; over 10-16 steps of
  O(1) values the measured gaps are ~1e-5 at most.
- ``ASSOC_TOL`` (rtol 1e-5, atol 1e-5): the associative scan pairs the
  same elements in the same order as ``jax.lax.associative_scan``, but XLA
  on the CPU may contract ``ar * bl + br`` into one fused multiply-add
  where PyTorch rounds the product first (ROADMAP queue 3 records the same
  for ``random.uniform``).  Against the port's own sequential branch the
  JAX test's 1e-3 (``tests/test_ssm.py``) holds.
- ``GRAD_TOL`` (rtol 1e-4, atol 1e-5): a gradient sums the float-order
  gaps of the forward over every step of the backward scan.
What is selected rather than computed (the max law's pooled value, its
tie mask and the tie-routed gradient at a fusion site, the channel
accounting) is compared bitwise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.data import pipeline as jpipe
from repro.models import fusion as JF
from repro.models import mamba as JMB
from repro.models import model as JM
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.parallel.sharding import split_tree
from repro.protocol import Protocol as JP
from repro.train import trainer as jtrainer
from repro_torch import random as jr
from repro_torch import tree
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_jax
from repro_torch.data import pipeline as tpipe
from repro_torch.models import fusion as TF
from repro_torch.models import mamba as TMB
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.protocol import Protocol as TP
from repro_torch.train import trainer
from repro_torch.train.trainer import TrainerConfig

torch.set_num_threads(1)

FLOAT_TOL = dict(rtol=1e-5, atol=1e-5)
SCAN_TOL = dict(rtol=1e-5, atol=5e-5)
ASSOC_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# trainer histories: float32 sums in another order (test_torch_trainer.py)
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4
XLSTM, JAMBA = "xlstm-125m", "jamba-1.5-large-398b"


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _close(got, want, tol=FLOAT_TOL, what=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **tol)


def _close_trees(got, want, tol, what=""):
    lg, lw = tree.leaves(got), jax.tree.leaves(want)
    assert len(lg) == len(lw), what
    for a, b in zip(lg, lw):
        assert tuple(a.shape) == b.shape, what
        _close(a, b, tol, what)


def _to_torch(values):
    return params_from_jax(jax.tree.map(np.asarray, values))


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _mixer(arch, init_fn, seed=0, **kw):
    """(JAX cfg, port cfg, JAX values, port values) of one mixer."""
    jcfg, tcfg = j_get_reduced(arch, **kw), get_reduced(arch, **kw)
    jv, _ = split_tree(init_fn(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, tcfg, jv, _to_torch(jv)


# the mixers: (arch, JAX init, full, step, state init; port full, step,
# state init)
_MIXERS = {
    "mlstm": (XLSTM, JS.mlstm_init, JS.mlstm_full, JS.mlstm_step,
              lambda c, b: JS.mlstm_state_init(c, b), TS.mlstm_full,
              TS.mlstm_step, lambda c, b: TS.mlstm_state_init(c, b)),
    "slstm": (XLSTM, JS.slstm_init, JS.slstm_full, JS.slstm_step,
              lambda c, b: JS.slstm_state_init(c, b), TS.slstm_full,
              TS.slstm_step, lambda c, b: TS.slstm_state_init(c, b)),
    "mamba": (JAMBA, JMB.mamba_init, JMB.mamba_full, JMB.mamba_step,
              lambda c, b: JMB.init_cache(c, b, jnp.float32),
              TMB.mamba_full, TMB.mamba_step,
              lambda c, b: TMB.init_cache(c, b, torch.float32)),
}


# ---------------------------------------------------------------------------
# the mixers: full, step, caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fusion", ["sum", "max"])
@pytest.mark.parametrize("mixer", sorted(_MIXERS))
def test_mixer_full_and_steps_match_jax(mixer, fusion):
    """``*_full`` with its cache, then 4 ``*_step`` tokens from the
    prefill's cache and 4 from the zero state: outputs and every cache
    leaf (mLSTM's (C, n, m), sLSTM's (h, c, n, m), mamba's conv window
    and state)."""
    arch, jinit, jfull, jstep, jstate, tfull, tstep, tstate = \
        _MIXERS[mixer]
    jcfg, tcfg, jv, tv = _mixer(arch, jinit, tp_fusion=fusion)
    x = _x((2, 10, jcfg.d_model), 1)
    want, cache_j = jfull(jcfg, jv, jnp.asarray(x), return_cache=True)
    got, cache_t = tfull(tcfg, tv, torch.from_numpy(x), return_cache=True)
    _close(got, want, SCAN_TOL, "full")
    _close_trees(cache_t, cache_j, SCAN_TOL, "full cache")
    _close(tfull(tcfg, tv, torch.from_numpy(x)), want, SCAN_TOL)
    x1 = _x((2, 4, jcfg.d_model), 2)
    for start_j, start_t in ((cache_j, cache_t),
                             (jstate(jcfg, 2), tstate(tcfg, 2))):
        cj, ct = start_j, tree.map(lambda t: t.clone(), start_t)
        for t in range(4):
            want, cj = jstep(jcfg, jv, jnp.asarray(x1[:, t:t + 1]), cj)
            got, ct = tstep(tcfg, tv, torch.from_numpy(x1[:, t:t + 1]), ct)
            _close(got, want, SCAN_TOL, f"step {t}")
            _close_trees(ct, cj, SCAN_TOL, f"step {t} cache")


def test_state_inits_match_jax():
    """The zero states bitwise: mLSTM's m and sLSTM's m at -1e9, sLSTM's
    n at 1, mamba's conv window in the given type."""
    for name in sorted(_MIXERS):
        arch, *_, jstate, _, _, tstate = _MIXERS[name]
        jc, tc = j_get_reduced(arch), get_reduced(arch)
        for a, b in zip(tree.leaves(tstate(tc, 3)),
                        jax.tree.leaves(jstate(jc, 3))):
            assert tuple(a.shape) == b.shape and a.dtype == torch.float32
            assert np.array_equal(_np(a), np.asarray(b)), name


def test_mamba_a_log_and_init_layout():
    """``A_log`` is the log of 1..St per channel in float32, whatever
    ``param_dtype`` is, within one ulp of the JAX ``Tagged_A`` (two
    libraries' ``log``: they part by an ulp at log 7); the port's own
    init has the JAX tree's leaves, shapes and types (bf16 config)."""
    jc = j_get_reduced(JAMBA, param_dtype=jnp.bfloat16)
    tc = get_reduced(JAMBA, param_dtype=torch.bfloat16)
    jv, _ = split_tree(JMB.mamba_init(jc, jax.random.PRNGKey(0)))
    own = TMB.mamba_init(tc, torch.Generator().manual_seed(0))
    assert own["A_log"].dtype == torch.float32
    np.testing.assert_array_max_ulp(_np(own["A_log"]),
                                    np.asarray(jv["A_log"]), maxulp=1)
    for init_j, init_t, arch in ((JMB.mamba_init, TMB.mamba_init, JAMBA),
                                 (JS.mlstm_init, TS.mlstm_init, XLSTM),
                                 (JS.slstm_init, TS.slstm_init, XLSTM)):
        jc = j_get_reduced(arch, param_dtype=jnp.bfloat16)
        tc = get_reduced(arch, param_dtype=torch.bfloat16)
        jv, _ = split_tree(init_j(jc, jax.random.PRNGKey(0)))
        tv = init_t(tc, torch.Generator().manual_seed(0))
        assert tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), tv) \
            == jax.tree.map(lambda a: (a.shape, str(a.dtype)), jv)


# ---------------------------------------------------------------------------
# mamba's two scans
# ---------------------------------------------------------------------------

def _scan_inputs(s, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, (2, 2, s, 3, 4)).astype(np.float32)
    bx = rng.standard_normal((2, 2, s, 3, 4)).astype(np.float32)
    c = rng.standard_normal((2, 2, s, 4)).astype(np.float32)
    return a, bx, c


@pytest.mark.parametrize("s", [1, 2, 7, 16])
@pytest.mark.parametrize("assoc", [False, True], ids=["sequential", "assoc"])
def test_ssm_scan_branches_match_jax(assoc, s):
    """``_ssm_scan`` at even, odd and one-element lengths: the sequential
    branch within the scan's float order, the associative branch within
    ``ASSOC_TOL`` of ``jax.lax.associative_scan`` (the same recursion)
    and within the JAX test's 1e-3 of the port's sequential branch."""
    jc = j_get_reduced(JAMBA, mamba_assoc_scan=assoc)
    tc = get_reduced(JAMBA, mamba_assoc_scan=assoc)
    a, bx, c = _scan_inputs(s, s)
    yj, hj = JMB._ssm_scan(jc, jnp.asarray(a), jnp.asarray(bx),
                           jnp.asarray(c), None)
    yt, ht = TMB._ssm_scan(tc, torch.from_numpy(a), torch.from_numpy(bx),
                           torch.from_numpy(c), None)
    tol = ASSOC_TOL if assoc else SCAN_TOL
    _close(yt, yj, tol)
    _close(ht, hj, tol)
    ys, hs = TMB._ssm_scan(get_reduced(JAMBA), torch.from_numpy(a),
                           torch.from_numpy(bx), torch.from_numpy(c), None)
    _close(yt, ys, dict(rtol=0, atol=1e-3))
    _close(ht, hs, dict(rtol=0, atol=1e-3))


def test_assoc_scan_pairs_like_jax():
    """With an exactly associative operator (integer-valued floats, no
    rounding) the two recursions give the same bits whatever they pair:
    this holds the odd/even bookkeeping (slices, the first element, the
    interleave) at lengths 1-9 and around 16 and 32 along axis 2."""
    for s in (*range(1, 10), 15, 16, 17, 31, 32, 33):
        rng = np.random.default_rng(s)
        a = rng.integers(-1, 2, (1, 2, s, 3)).astype(np.float32)
        b = rng.integers(-3, 4, (1, 2, s, 3)).astype(np.float32)
        wa, wb = jax.lax.associative_scan(
            lambda l, r: (l[0] * r[0], r[0] * l[1] + r[1]),
            (jnp.asarray(a), jnp.asarray(b)), axis=2)
        ga, gb = TMB._assoc_scan(torch.from_numpy(a), torch.from_numpy(b),
                                 axis=2)
        assert np.array_equal(_np(ga), np.asarray(wa)), s
        assert np.array_equal(_np(gb), np.asarray(wb)), s


def test_mamba_assoc_matches_sequential():
    """``mamba_full`` with ``mamba_assoc_scan`` against JAX's, and within
    the JAX test's 1e-3 of the port's sequential branch."""
    jcfg, tcfg, jv, tv = _mixer(JAMBA, JMB.mamba_init,
                                mamba_assoc_scan=True)
    x = _x((2, 16, jcfg.d_model), 3)
    want = JMB.mamba_full(jcfg, jv, jnp.asarray(x))
    got = TMB.mamba_full(tcfg, tv, torch.from_numpy(x))
    _close(got, want, ASSOC_TOL)
    seq = TMB.mamba_full(tcfg.with_(mamba_assoc_scan=False), tv,
                         torch.from_numpy(x))
    _close(got, seq, dict(rtol=0, atol=1e-3))


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["mlstm", "slstm", "mamba", "mamba assoc",
                                  "mlstm max"])
def test_mixer_grads_match_jax(case):
    """The gradient of ``sum(full(x) * g)`` with respect to every
    parameter and to ``x`` against ``jax.grad``; under ``tp_fusion="max"``
    through the tie-routed law."""
    name = case.split()[0]
    kw = {"mamba assoc": dict(mamba_assoc_scan=True),
          "mlstm max": dict(tp_fusion="max")}.get(case, {})
    arch, jinit, jfull, _, _, tfull, _, _ = _MIXERS[name]
    jcfg, tcfg, jv, tv = _mixer(arch, jinit, seed=3, **kw)
    x = _x((2, 8, jcfg.d_model), 4)
    g = _x((2, 8, jcfg.d_model), 5)

    def jloss(v, xx):
        return jnp.sum(jfull(jcfg, v, xx) * g)

    gv_j, gx_j = jax.grad(jloss, argnums=(0, 1))(jv, jnp.asarray(x))
    tv = tree.map(lambda t: t.clone().requires_grad_(True), tv)
    xt = torch.from_numpy(x).requires_grad_(True)
    torch.sum(tfull(tcfg, tv, xt) * torch.from_numpy(g)).backward()
    _close(xt.grad, gx_j, GRAD_TOL, "x")
    for (path, want), got in zip(
            jax.tree_util.tree_flatten_with_path(gv_j)[0],
            [v.grad for v in tree.leaves(tv)]):
        _close(got, want, GRAD_TOL, jax.tree_util.keystr(path))


def test_mlstm_max_site_pools_bitwise():
    """The mLSTM site's worker partials (N, B, S, d) from the port, pooled
    by both packages' ``worker_reduce`` under ``tp_fusion="max"``, on a
    coarse grid that forces ties: the pooled max bitwise, and the
    tie-routed gradient (``g * (h == max)``) bitwise."""
    _, tcfg, _, tv = _mixer(XLSTM, JS.mlstm_init, tp_fusion="max")
    jcfg = j_get_reduced(XLSTM, tp_fusion="max")
    x = torch.from_numpy(_x((2, 6, tcfg.d_model), 6))
    captured = {}

    def keep(cfg, p, partial):
        captured["h"] = partial
        return partial.sum(0)

    orig = TF.worker_reduce
    TF.worker_reduce = keep
    try:
        TS.mlstm_full(tcfg, tv, x)
    finally:
        TF.worker_reduce = orig
    h = np.round(_np(captured["h"]) * 8) / 8          # ties on the grid
    g = _x(h.shape[1:], 7)
    out_j, vjp = jax.vjp(lambda a: JF.worker_reduce(jcfg, {}, a),
                         jnp.asarray(h))
    ht = torch.from_numpy(h).requires_grad_(True)
    out_t = TF.worker_reduce(tcfg, {}, ht)
    (torch.from_numpy(g) * out_t).sum().backward()
    assert np.array_equal(_np(out_t), np.asarray(out_j))
    assert np.array_equal(_np(ht.grad), np.asarray(vjp(jnp.asarray(g))[0]))
    assert (h == h.max(0, keepdims=True)).sum(0).max() > 1   # ties met


# ---------------------------------------------------------------------------
# blocks and the stack
# ---------------------------------------------------------------------------

# xlstm under the max law (its 3 mLSTM sites a period), jamba under sum
# (both laws of both mixers: test_mixer_full_and_steps_match_jax)
_PLANS = {"xlstm max": (XLSTM, dict(tp_fusion="max")), "jamba": (JAMBA, {})}


@pytest.fixture(scope="module", params=sorted(_PLANS))
def plan(request):
    """(JAX cfg, port cfg, JAX model values, port model values)."""
    arch, kw = _PLANS[request.param]
    jcfg, tcfg = j_get_reduced(arch, **kw), get_reduced(arch, **kw)
    jv, _ = split_tree(JM.init(jcfg, jax.random.PRNGKey(1)))
    return jcfg, tcfg, jv, _to_torch(jv)


def test_blocks_match_jax(plan):
    """``block_full``, ``block_prefill`` (its cache) and ``block_step``
    with and without a protocol at the first position of each (mixer,
    ffn) pair of the period: the ``none`` FFN's blocks have no
    ``norm2``/``ffn`` and aux 0; a block without an mlp FFN bills a zero
    channel dict, bitwise."""
    jcfg, tcfg, jv, tv = plan
    x = _x((2, 8, jcfg.d_model), 7)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (2, 8)).copy()
    x1 = _x((2, 1, jcfg.d_model), 8)
    p1 = np.array([8, 8], np.int32)
    p = np.full((jcfg.n_workers,), 0.05, np.float32)
    plan_ = jcfg.layer_plan()
    for i, (mixer, ffn) in enumerate(plan_):
        if plan_.index((mixer, ffn)) != i:
            continue
        jp = jax.tree.map(lambda a: a[0], jv["blocks"][f"pos{i}"])
        tp = tree.map(lambda a: a[0], tv["blocks"][f"pos{i}"])
        assert ("ffn" in tp) == ("norm2" in tp) == (ffn != "none")
        kinds = dict(mixer=mixer, ffn=ffn)
        j_full = jax.jit(functools.partial(JT.block_full, jcfg, **kinds))
        j_prefill = jax.jit(functools.partial(JT.block_prefill, jcfg,
                                              max_seq=12, **kinds))
        j_step = jax.jit(functools.partial(JT.block_step, jcfg, **kinds))
        want, aux_j = j_full(jp, jnp.asarray(x), jnp.asarray(pos))
        got, aux_t = TT.block_full(tcfg, tp, torch.from_numpy(x),
                                   torch.from_numpy(pos), mixer, ffn)
        _close(got, want, SCAN_TOL, f"{mixer} {ffn}")
        _close(aux_t, aux_j)
        want, cache_j, aux_j = j_prefill(jp, jnp.asarray(x),
                                         jnp.asarray(pos))
        got, cache_t, aux_t = TT.block_prefill(
            tcfg, tp, torch.from_numpy(x), torch.from_numpy(pos), mixer,
            ffn, 12)
        _close(got, want, SCAN_TOL)
        _close(aux_t, aux_j)
        _close_trees(cache_t, cache_j, SCAN_TOL, f"{mixer} cache")
        want, step_j, aux_j = j_step(jp, jnp.asarray(x1), jnp.asarray(p1),
                                     cache_j)
        got, step_t, aux_t = TT.block_step(
            tcfg, tp, torch.from_numpy(x1), torch.from_numpy(p1),
            tree.map(lambda t: t.clone(), cache_t), mixer, ffn)
        _close(got, want, SCAN_TOL)
        _close_trees(step_t, step_j, SCAN_TOL, f"{mixer} step cache")
        want, _, aux_j, chan_j = j_step(
            jp, jnp.asarray(x1), jnp.asarray(p1), cache_j,
            protocol=JP.ocs(bits=8, p_miss=p), rng=jax.random.PRNGKey(5))
        got, _, aux_t, chan_t = TT.block_step(
            tcfg, tp, torch.from_numpy(x1), torch.from_numpy(p1), cache_t,
            mixer, ffn, protocol=TP.ocs(bits=8, p_miss=p),
            rng=jr.PRNGKey(5))
        _close(got, want, SCAN_TOL)
        _close(aux_t, aux_j)
        for k in chan_j:
            assert np.array_equal(_np(chan_t[k]), np.asarray(chan_j[k])), k
        assert int(chan_t["calls"]) == (ffn == "mlp")


@pytest.mark.parametrize("p_miss", [None, 0.05])
def test_decode_steps_match_jax(plan, p_miss):
    """A prefill, then three decode ticks, channel-free and through OCS:
    logits, the stacked cache (each recurrent state written into the
    stack's period views) and the tick's channel dict (bitwise; its
    ``calls`` the plan's channel sites: 0 for xlstm, 4 a jamba period)."""
    jcfg, tcfg, jv, tv = plan
    jm, tm = JM.build(jcfg), TM.build(tcfg)
    j_prefill = jax.jit(jm.prefill, static_argnames="max_seq")
    j_decode = jax.jit(jm.decode_step)
    j_decode_channel = jax.jit(jm.decode_step_channel)
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    want, cache_j = j_prefill(jv, {"tokens": jnp.asarray(toks)}, max_seq=16)
    got, cache_t = tm.prefill(tv, {"tokens": torch.from_numpy(toks)},
                              max_seq=16)
    _close(got, want, SCAN_TOL)
    _close_trees(cache_t, cache_j, SCAN_TOL, "prefill cache")
    sites = {XLSTM: 0, JAMBA: 4}[jcfg.name] * jcfg.n_periods
    assert tm.channel_sites() == jm.channel_sites() == sites
    tok, pos = np.array([[3], [5]], np.int32), np.array([8, 8], np.int32)
    for tick in range(3):
        if p_miss is None:
            want, cache_j = j_decode(jv, jnp.asarray(tok),
                                     jnp.asarray(pos), cache_j)
            got, cache_t = tm.decode_step(tv, torch.from_numpy(tok),
                                          torch.from_numpy(pos), cache_t)
        else:
            p = np.full((jcfg.n_workers,), p_miss, np.float32)
            want, cache_j, chan_j = j_decode_channel(
                jv, jnp.asarray(tok), jnp.asarray(pos), cache_j,
                JP.ocs(bits=8, p_miss=p),
                jax.random.fold_in(jax.random.PRNGKey(0), tick))
            got, cache_t, chan_t = tm.decode_step_channel(
                tv, torch.from_numpy(tok), torch.from_numpy(pos), cache_t,
                TP.ocs(bits=8, p_miss=p), jr.fold_in(jr.PRNGKey(0), tick))
            for k in chan_j:
                assert np.array_equal(_np(chan_t[k]),
                                      np.asarray(chan_j[k])), k
            assert int(chan_t["calls"]) == sites
        _close(got, want, SCAN_TOL)
        tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)[:, None]
        pos = pos + 1
    _close_trees(cache_t, cache_j, SCAN_TOL, "decoded cache")


def test_recurrent_leaves_are_the_states(plan):
    """``recurrent_leaves`` names every recurrent-state tensor of the
    stacked cache and no KV buffer."""
    _, tcfg, _, _ = plan
    plan_ = tcfg.layer_plan()
    cache = TM.cache_init(tcfg, 2, 16)
    leaves = TT.recurrent_leaves(plan_, cache)
    want = sum({"mlstm": 3, "slstm": 4, "mamba": 2}.get(m, 0)
               for m, _ in plan_)
    assert len(leaves) == want
    kv = [t for i, (m, _) in enumerate(plan_) if m == "attn"
          for t in tree.leaves(cache[f"pos{i}"])]
    assert not any(t is u for t in leaves for u in kv)


# ---------------------------------------------------------------------------
# loss and trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fusion", ["sum", "max"])
@pytest.mark.parametrize("arch", [XLSTM, JAMBA])
def test_loss_and_trainer_match_jax(arch, fusion):
    """``loss_fn`` (xlstm through its tied head), then 3 trainer steps of
    each package from one init: nll, aux and loss within the float-order
    tolerance, lr within an ulp, parameters within 1e-4.  The steps are
    SGD's: the mLSTM input gate's bias has a gradient of float noise
    (~1e-8; a uniform shift of the input gate is absorbed by the
    stabiliser m), which AdamW, dividing by its own RMS, turns into a
    step of +-lr in either package."""
    kw = dict(tp_fusion=fusion, vocab_size=128)
    jm = JM.build(j_get_reduced(arch, **kw))
    tm = TM.build(get_reduced(arch, **kw))
    assert tm.cfg.tie_embeddings == (arch == XLSTM)
    jv, _ = split_tree(jm.init(jax.random.PRNGKey(2)))
    tv = _to_torch(jv)
    assert ("head" in tv) == (arch != XLSTM)
    jpc = jpipe.for_model(jm.cfg, batch=4, seq_len=12, seed=1)
    tpc = tpipe.for_model(tm.cfg, batch=4, seq_len=12, seed=1)
    batch = jpipe.batch_for_step(jpc, 0)
    lj, mj = jm.loss(jv, batch)
    lt, mt = tm.loss(tv, tpipe.batch_for_step(tpc, 0, device="cpu"))
    _close(lt, lj)
    _close(mt["aux"], mj["aux"])
    want = jtrainer.train(
        jm.loss, jv, jopt.sgd(jsched.linear_warmup_cosine(3e-2, 2, 3)),
        lambda s: jpipe.batch_for_step(jpc, s),
        jtrainer.TrainerConfig(steps=3, log_every=1))
    got = trainer.train(
        tm.loss, tv, topt.sgd(tsched.linear_warmup_cosine(3e-2, 2, 3)),
        lambda s: tpipe.batch_for_step(tpc, s, device="cpu"),
        TrainerConfig(steps=3, log_every=1))
    assert sorted(got.history[0]) == sorted(want.history[0])
    for a, b in zip(got.history, want.history):
        for k in ("nll", "aux", "loss"):
            np.testing.assert_allclose(a[k], b[k], rtol=LOSS_RTOL,
                                       atol=1e-7)
        np.testing.assert_allclose(a["lr"], b["lr"], rtol=2e-7)
    _close_trees(got.values, want.values, dict(rtol=0, atol=PARAM_ATOL))


def test_layers_cut_to_the_period():
    """``launch/train --layers`` keeps whole periods: 4 for xlstm, 8 for
    jamba; another count is refused with the period named."""
    from repro_torch.launch import train as launch_train
    for arch, period in ((XLSTM, 4), (JAMBA, 8)):
        assert get_reduced(arch).period == period
        with pytest.raises(ValueError, match=f"period of {period}"):
            launch_train.setup(launch_train.parse_args(
                ["--arch", arch, "--smoke", "--device", "cpu", "--layers",
                 str(period + 2)]))
