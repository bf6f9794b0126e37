"""The port's MoE FFN (``repro_torch.models.moe``), ``ModelConfig
.param_count`` and ``fusion.worker_partial`` against the JAX package's,
and the contracts of ``tests/test_moe.py`` on the port.

Both packages see the same numpy inputs (a seed) and the JAX package's
parameters, carried across by ``convert.params_from_jax``, at the reduced
qwen3-moe-30b-a3b (8 experts, top 2) and llama4-scout-17b-a16e (4
experts, top 1, a shared expert) configs in float32.

Tolerances.  The routing is selection and integer arithmetic on the same
float32 probabilities: expert ids, positions, token ids, the dropped set
and the weights (a sum of k <= 2 values, then a division) are compared
bitwise.  Outputs: ``FLOAT_TOL`` (rtol 1e-5, atol 1e-5), the two packages
multiplying in other orders (XLA's CPU dot against PyTorch's), a few ulp
an operation on O(1-10) values.  The aux loss: rtol 1e-5 (a mean over
B*S probabilities summed in another order).  Gradients: atol 1e-6 x the
largest |gradient| of the tree — the expert and router gradients are
sums over every (token, expert) product, and at top 1 the router's
gradient through the normalised weight ``w / w`` is float noise on that
scale (exactly zero in real arithmetic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.models import fusion as JF
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.parallel.sharding import split_tree
from repro_torch import tree
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import fusion as TF
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE

torch.set_num_threads(1)

FLOAT_TOL = dict(rtol=1e-5, atol=1e-5)
QWEN3, LLAMA4 = "qwen3-moe-30b-a3b", "llama4-scout-17b-a16e"
MOE_ARCHS = (QWEN3, LLAMA4)


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _probs(b, s, e, seed, ties=False):
    """Softmax probabilities (B, S, E) in float32; with ``ties`` the
    logits are on a grid of 4 values, so most rows hold equal
    probabilities across the top-k boundary."""
    rng = np.random.default_rng(seed)
    if ties:
        logits = rng.integers(0, 4, (b, s, e)).astype(np.float32)
    else:
        logits = rng.standard_normal((b, s, e)).astype(np.float32)
    return np.array(jax.nn.softmax(jnp.asarray(logits), -1))


def _params(jcfg, seed):
    jp, _ = split_tree(JMOE.moe_init(jcfg, jax.random.PRNGKey(seed)))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

_ROUTE_CASES = {
    "randn": (QWEN3, {}, 32, False),
    "ties": (QWEN3, {}, 32, True),
    "drops (capacity 0.25)": (QWEN3, dict(capacity_factor=0.25), 32, False),
    "no drops (capacity 64)": (QWEN3, dict(capacity_factor=64.0), 32, False),
    "top 1 ties": (LLAMA4, {}, 24, True),
    "top 1 drops": (LLAMA4, dict(capacity_factor=0.25), 24, False),
    # the full config's routing: 128 experts, top 8
    "full width": (QWEN3, "full", 64, False),
}


@pytest.mark.parametrize("case", sorted(_ROUTE_CASES))
def test_route_matches_jax_bitwise(case):
    arch, kw, s, ties = _ROUTE_CASES[case]
    if kw == "full":
        jcfg, tcfg = j_get_config(arch), get_config(arch)
    else:
        jcfg, tcfg = j_get_reduced(arch, **kw), get_reduced(arch, **kw)
    probs = _probs(3, s, jcfg.n_experts, seed=len(case), ties=ties)
    cap = JMOE._capacity(jcfg, s)
    assert TMOE._capacity(tcfg, s) == cap
    got = TMOE._route_one_seq(tcfg, torch.from_numpy(probs), cap)
    dropped = 0
    for b in range(probs.shape[0]):
        want = JMOE._route_one_seq(jcfg, jnp.asarray(probs[b]), cap)
        for name, g, w in zip(("expert", "pos", "token", "weight"), got,
                              want):
            g = _np(g[b])
            if name != "weight":
                g = g.astype(np.int32)
            assert g.dtype == np.asarray(w).dtype, name
            assert np.array_equal(g, np.asarray(w)), (case, b, name)
        dropped += int(np.sum(np.asarray(want[1]) == cap))
    if "no drops" in case:
        assert dropped == 0
    elif "drops" in case:
        assert dropped > 0


def test_route_positions_within_capacity():
    cfg = get_reduced(QWEN3)
    probs = torch.from_numpy(_probs(1, 32, cfg.n_experts, 0))
    cap = TMOE._capacity(cfg, 32)
    e, pos, _, _ = TMOE._route_one_seq(cfg, probs, cap)
    assert int(pos.max()) <= cap and int(pos.min()) >= 0
    kept = pos[0] < cap
    pairs = list(zip(e[0][kept].tolist(), pos[0][kept].tolist()))
    assert len(pairs) == len(set(pairs))


def test_topk_weights_normalized():
    cfg = get_reduced(QWEN3)
    probs = torch.from_numpy(_probs(1, 16, cfg.n_experts, 1))
    _, _, tok, w = TMOE._route_one_seq(cfg, probs, TMOE._capacity(cfg, 16))
    for t in range(16):
        assert abs(float(w[0][tok[0] == t].sum()) - 1.0) < 1e-5


# ---------------------------------------------------------------------------
# moe_apply: both forms, the shared expert, gradients
# ---------------------------------------------------------------------------

_APPLY_CASES = [(arch, impl, cf) for arch in MOE_ARCHS
                for impl in ("sort_scatter", "gather")
                for cf in (1.25, 0.25)]


@pytest.mark.parametrize("arch,impl,cf", _APPLY_CASES)
def test_moe_apply_matches_jax(arch, impl, cf):
    jcfg = j_get_reduced(arch, moe_impl=impl, capacity_factor=cf)
    tcfg = get_reduced(arch, moe_impl=impl, capacity_factor=cf)
    jp, tp = _params(jcfg, 1)
    x = _x((2, 16, 64), 0)
    yj, aj = JMOE.moe_apply(jcfg, jp, jnp.asarray(x))
    yt, at = TMOE.moe_apply(tcfg, tp, torch.from_numpy(x))
    assert yt.shape == yj.shape and yt.dtype == torch.float32
    np.testing.assert_allclose(_np(yt), np.asarray(yj), **FLOAT_TOL)
    assert at.dtype == torch.float32 and at.shape == ()
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-5)


@pytest.mark.parametrize("arch,impl,cf", _APPLY_CASES)
def test_moe_gradients_match_jax(arch, impl, cf):
    """Gradients of ``sum(y**2) + 0.01 * aux`` with respect to the input
    and every parameter, against ``jax.grad``."""
    jcfg = j_get_reduced(arch, moe_impl=impl, capacity_factor=cf)
    tcfg = get_reduced(arch, moe_impl=impl, capacity_factor=cf)
    jp, tp = _params(jcfg, 2)
    x = _x((2, 16, 64), 3)

    def loss(p, x):
        y, aux = JMOE.moe_apply(jcfg, p, x)
        return jnp.sum(y ** 2) + 0.01 * aux

    gp, gx = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = tree.leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = TMOE.moe_apply(tcfg, tp, xt)
    got = torch.autograd.grad(torch.sum(y ** 2) + 0.01 * aux,
                              [xt] + leaves)
    want = [gx] + jax.tree.leaves(gp)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0,
                                   atol=1e-6 * scale)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forms_agree_bitwise(arch):
    """The gather form multiplies the weights in expert space, the
    sort-scatter form after the gather back: the same products, added in
    the same order."""
    cfg = get_reduced(arch, capacity_factor=0.5)
    _, tp = _params(j_get_reduced(arch), 3)
    x = torch.from_numpy(_x((3, 16, 64), 4))
    ya, aa = TMOE.moe_apply(cfg.with_(moe_impl="sort_scatter"), tp, x)
    yb, ab = TMOE.moe_apply(cfg.with_(moe_impl="gather"), tp, x)
    assert torch.equal(ya, yb) and torch.equal(aa, ab)


def _dense_oracle(cfg, p, x):
    """Every expert on every token, combined by the top-k weights (no
    capacity, no drops)."""
    probs = torch.softmax(x @ p["router"], -1)
    w, idx = torch.topk(probs, cfg.experts_per_token)
    w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    gate = torch.einsum("bsd,edf->besf", x, p["w_gate"])
    up = torch.einsum("bsd,edf->besf", x, p["w_up"])
    out_all = torch.einsum("besf,efd->besd", torch.nn.functional.silu(gate)
                           * up, p["w_down"])
    comb = torch.einsum("bske,bsk->bse", torch.nn.functional.one_hot(
        idx, cfg.n_experts).float(), w)
    return torch.einsum("besd,bse->bsd", out_all, comb)


@pytest.mark.parametrize("impl", ["sort_scatter", "gather"])
def test_dispatch_matches_dense_oracle_with_big_capacity(impl):
    cfg = get_reduced(QWEN3, capacity_factor=64.0, moe_impl=impl)
    _, tp = _params(j_get_reduced(QWEN3), 0)
    x = torch.from_numpy(_x((2, 8, cfg.d_model), 2))
    y, aux = TMOE.moe_apply(cfg, tp, x)
    err = float((y - _dense_oracle(cfg, tp, x)).abs().max())
    assert err < 1e-4, err
    assert float(aux) > 0


@pytest.mark.parametrize("impl", ["sort_scatter", "gather"])
def test_capacity_drops_deterministic(impl):
    """Two calls: outputs and every gradient bit for bit."""
    cfg = get_reduced(QWEN3, capacity_factor=0.25, moe_impl=impl)
    _, tp = _params(j_get_reduced(QWEN3), 1)
    x = torch.from_numpy(_x((2, 16, cfg.d_model), 3))
    runs = []
    for _ in range(2):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in tree.leaves(tp)]
        p = tree.unflatten(tp, leaves)
        xt = x.clone().requires_grad_(True)
        y, aux = TMOE.moe_apply(cfg, p, xt)
        grads = torch.autograd.grad(torch.sum(y ** 2) + 0.01 * aux,
                                    [xt] + leaves)
        assert all(torch.isfinite(g).all() for g in grads)
        runs.append((y.detach(), aux.detach()) + grads)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# parameter counts, the built trees, worker_partial
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("which", ["config", "reduced"])
def test_param_count_matches_jax(arch, which):
    """``param_count`` (all and active) equal to the JAX package's, and the
    built tree (reduced configs) of the same elements as the JAX
    package's: so ``param_count`` relates to the tree as it does there."""
    assert arch in J_ARCH_IDS
    jc = (j_get_config if which == "config" else j_get_reduced)(arch)
    tc = (get_config if which == "config" else get_reduced)(arch)
    for active in (False, True):
        assert tc.param_count(active_only=active) == \
            jc.param_count(active_only=active)
    assert tc.d_inner == jc.d_inner and tc.dt_rank_ == jc.dt_rank_
    assert tc.encoder_layer_plan() == jc.encoder_layer_plan()
    if which == "reduced":
        jv, _ = split_tree(JM.init(jc, jax.random.PRNGKey(0)))
        tv = TM.init(tc, torch.Generator().manual_seed(0))
        assert sum(t.numel() for t in tree.leaves(tv)) == \
            sum(int(np.prod(v.shape)) for v in jax.tree.leaves(jv))
        assert tree.map(lambda t: (tuple(t.shape), t.dtype), tv) == \
            tree.map(lambda t: (tuple(t.shape), t.dtype),
                     params_from_jax(jax.tree.map(np.asarray, jv)))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_tree_bf16_router_float32(arch):
    """In a bfloat16 config the router stays float32, in both packages."""
    jc = j_get_reduced(arch, dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    tc = get_reduced(arch, dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    jv, _ = split_tree(JM.init(jc, jax.random.PRNGKey(0)))
    tv = TM.init(tc, torch.Generator().manual_seed(0))
    conv = params_from_jax(jax.tree.map(np.asarray, jv))
    assert tree.map(lambda t: (tuple(t.shape), t.dtype), tv) == \
        tree.map(lambda t: (tuple(t.shape), t.dtype), conv)
    assert tv["blocks"]["pos0"]["ffn"]["router"].dtype == torch.float32
    assert tv["blocks"]["pos0"]["ffn"]["w_up"].dtype == torch.bfloat16


@pytest.mark.parametrize("spec,shapes", [
    ("nbsf,nfk->nbsk", ((2, 3, 5, 4), (2, 4, 6))),
    ("nbf,nfk->nbk", ((3, 7, 8), (3, 8, 2)))])
def test_worker_partial_matches_jax(spec, shapes):
    a, w = _x(shapes[0], 5), _x(shapes[1], 6)
    want = JF.worker_partial(jnp.asarray(a), jnp.asarray(w), spec)
    got = TF.worker_partial(torch.from_numpy(a), torch.from_numpy(w), spec)
    np.testing.assert_allclose(_np(got), np.asarray(want), **FLOAT_TOL)
