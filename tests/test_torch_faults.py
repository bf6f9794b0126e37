"""The port's fault injection (``repro_torch.faults``, the fault-aware
``vertical.loss_fn``, ``run_fault_curves`` and its records) against the
JAX package's, and the reference tests' behavioural checks on the port.

Held bit for bit: the chain states (side-stream draws of the JAX
package's threefry), the pooled value, the new state and every accounting
field of ``faults.aggregate``, its input gradients in their raw bits (the
signs of the zeros of ``g * (okf * onehot)`` included), and the engine's
integer telemetry (dropped frames, outages, retry slots, staleness).
Losses, accuracies and parameters of the engine are held within the
tolerances of ``tests/test_torch_curves.py``, for its reason: the
matmuls' float sums run in another order in XLA than in PyTorch.  Against
the port's own ``run_curves`` a grid of ``FaultModel.iid`` lanes is held
bit for bit (raw bit views).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proptest import random_floats
from repro import faults as jf
from repro.core import vertical as jvert
from repro.protocol import Protocol as JProtocol
from repro.sim import results as jresults
from repro.sim import train_curves as jtc
from repro_torch import faults as tf
from repro_torch import random as jr
from repro_torch import tree
from repro_torch.convert import params_from_jax
from repro_torch.core import ocs
from repro_torch.core import vertical as tvert
from repro_torch.faults import DegradePolicy, FaultModel
from repro_torch.protocol import Protocol
from repro_torch.sim import results as tresults
from repro_torch.sim import train_curves as ttc

torch.set_num_threads(1)

N = 4
H = random_floats(3, (N, 9, 3), specials=False)
KEY = 7

TINY = jtc.CurveConfig(bits=(8,), p_miss=(0.0, 0.05), steps=6, batch=16,
                       n_train=96, n_val=48, hw=8, encoder_dims=(8,),
                       embed_dim=8, head_dims=(8,), log_every=3)
# as tests/test_torch_curves.py: float32 sums in another order
LOSS_ATOL = 1e-4
ACC_SAMPLES = 2
PARAM_ATOL = 1e-4


def _models(m, policy):
    """One model of each kind, built by the package ``m``."""
    pol = getattr(m.DegradePolicy, policy[0])(*policy[1:])
    return {
        "iid": m.FaultModel.iid(0.3, policy=pol),
        "burst-dropout": m.FaultModel.burst(
            burst_len=2.0, gap_len=3.0, p_miss_bad=0.6, p_miss_good=0.05,
            policy=pol).with_dropout(0.5, 0.4),
        "per-worker": m.FaultModel.gilbert_elliott(
            p_gb=np.array([0.1, 0.5, 0.9, 0.3], np.float32), p_bg=0.4,
            p_miss_good=np.array([0.0, 0.1, 0.2, 0.3], np.float32),
            p_miss_bad=0.7, policy=pol).with_dropout(
                np.array([0.9, 0.8, 0.7, 0.95], np.float32), 0.2),
        "outage": m.FaultModel.iid(0.0, policy=pol).with_dropout(1.0, 0.0),
    }


POLICIES = [("zero_fill",), ("stale",), ("retry", 2)]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _raw(x):
    a = _np(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _jstate(bad=None, offline=None, stale=None, age=0, consec=0):
    s = jf.init_state(N, H.shape[1:])
    return dataclasses.replace(
        s, bad=s.bad if bad is None else jnp.asarray(bad),
        offline=s.offline if offline is None else jnp.asarray(offline),
        stale=s.stale if stale is None else jnp.asarray(stale),
        age=jnp.int32(age), consec=jnp.int32(consec))


def _tstate(bad=None, offline=None, stale=None, age=0, consec=0):
    s = tf.init_state(N, H.shape[1:])
    return tf.FaultState(
        bad=s.bad if bad is None else torch.from_numpy(bad),
        offline=s.offline if offline is None else torch.from_numpy(offline),
        stale=s.stale if stale is None else torch.from_numpy(stale).clone(),
        age=torch.tensor(age, dtype=torch.int32),
        consec=torch.tensor(consec, dtype=torch.int32))


_STATES = {
    "fresh": {},
    "mixed": dict(bad=np.array([True, False, True, False]),
                  offline=np.array([False, True, True, False]),
                  stale=random_floats(11, H.shape[1:], specials=False),
                  age=2, consec=1),
    "all offline": dict(bad=np.ones(N, bool), offline=np.ones(N, bool),
                        stale=random_floats(12, H.shape[1:], specials=False),
                        age=5, consec=3),
}


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("build", [
    lambda m: m.FaultModel.burst(burst_len=0.5, gap_len=8.0),
    lambda m: m.DegradePolicy(kind="retry"),
    lambda m: m.DegradePolicy(kind="zero_fill", retry_budget=2),
    lambda m: m.DegradePolicy(kind="panic"),
])
def test_validation_matches_jax(build):
    with pytest.raises(ValueError) as want:
        build(jf)
    with pytest.raises(ValueError) as got:
        build(tf)
    assert str(got.value) == str(want.value)


def test_constructors_match_jax():
    for policy in POLICIES:
        for name, jm in _models(jf, policy).items():
            tm = _models(tf, policy)[name]
            assert tm.policy == tf.DegradePolicy(*_np_policy(jm.policy))
            for f in tf.model._LEAVES:
                assert np.array_equal(np.asarray(getattr(jm, f)),
                                      _np(getattr(tm, f))), (name, f)
                assert getattr(tm, f).dtype == torch.float32
    fm = FaultModel.burst(burst_len=4.0, gap_len=8.0)
    assert float(fm.p_bg) == pytest.approx(0.25)
    assert float(fm.p_gb) == pytest.approx(0.125)


def _np_policy(p):
    return p.kind, p.retry_budget


def test_aggregate_needs_an_ocs_protocol():
    with pytest.raises(ValueError, match="needs an OCS protocol"):
        tf.aggregate(Protocol.mean(), FaultModel.iid(0.1), _tstate(),
                     torch.from_numpy(H), jr.PRNGKey(KEY))


# ---------------------------------------------------------------------------
# chains
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("state", list(_STATES))
@pytest.mark.parametrize("model", ["iid", "burst-dropout", "per-worker"])
def test_step_chains_match_jax_bitwise(model, state):
    jm, tm = _models(jf, ("zero_fill",))[model], _models(
        tf, ("zero_fill",))[model]
    for key in (0, 7, 12345):
        jb, jo = jf.step_chains(jm, _jstate(**_STATES[state]),
                                jax.random.PRNGKey(key))
        tb, to = tf.step_chains(tm, _tstate(**_STATES[state]),
                                jr.PRNGKey(key))
        assert np.array_equal(np.asarray(jb), _np(tb))
        assert np.array_equal(np.asarray(jo), _np(to))
        assert np.array_equal(np.asarray(jf.effective_p_miss(jm, jb)),
                              _np(tf.effective_p_miss(tm, tb)))


def test_lane_stacked_chains_match_each_lane():
    """A lane stack (stack_models, (L, 2) keys) steps every lane's chains
    as the JAX package's vmap over lanes does."""
    names = ["iid", "burst-dropout", "per-worker"]
    jms = [_models(jf, ("stale",))[n] for n in names]
    tms = [_models(tf, ("stale",))[n] for n in names]
    stacked = tf.stack_models(tms, N)
    assert stacked.p_gb.shape == (3, N) and stacked.p_bg.shape == (3, 1)
    jkeys = jax.random.split(jax.random.PRNGKey(3), 3)
    tkeys = jr.split(jr.PRNGKey(3), 3)
    st = _STATES["mixed"]
    lanes = _tstate(**st).map(lambda t: t[None].expand(
        (3,) + t.shape).clone())
    tb, to = tf.step_chains(stacked, lanes, tkeys)
    for li in range(3):
        jb, jo = jf.step_chains(jms[li], _jstate(**st), jkeys[li])
        assert np.array_equal(np.asarray(jb), _np(tb[li]))
        assert np.array_equal(np.asarray(jo), _np(to[li]))
    with pytest.raises(ValueError, match="one DegradePolicy"):
        tf.stack_models([tms[0], tms[1].with_policy(
            DegradePolicy.zero_fill())], N)


def test_chain_evolution_extremes():
    fm = FaultModel.gilbert_elliott(p_gb=1.0, p_bg=0.0).with_dropout(1.0,
                                                                     0.0)
    bad, off = tf.step_chains(fm, _tstate(), jr.PRNGKey(KEY))
    assert bool(bad.all()) and bool(off.all())
    st = dataclasses.replace(_tstate(), bad=bad, offline=off)
    bad2, off2 = tf.step_chains(fm, st, jr.fold_in(jr.PRNGKey(KEY), 1))
    assert bool(bad2.all()) and bool(off2.all())
    _, off3 = tf.step_chains(FaultModel.iid(0.0).with_dropout(0.0, 1.0), st,
                             jr.PRNGKey(KEY))
    assert not bool(off3.any())


def test_effective_p_miss_follows_chain_state():
    fm = FaultModel.gilbert_elliott(p_gb=0.1, p_bg=0.1, p_miss_good=0.05,
                                    p_miss_bad=0.7)
    p = tf.effective_p_miss(fm, torch.tensor([True, False, True, False]))
    assert np.allclose(p.numpy(), [0.7, 0.05, 0.7, 0.05])


# ---------------------------------------------------------------------------
# the fault-aware aggregation, forward and backward
# ---------------------------------------------------------------------------

def _cotangents():
    """Cotangents of the pooled value and of the new cache: random signs,
    and exact zeros of both signs, so the raw bits of the gradient show
    the signs of its zeros."""
    rng = np.random.default_rng(5)
    g1 = rng.standard_normal(H.shape[1:]).astype(np.float32)
    g1[0] = -0.0
    g1[1, :2] = 0.0
    g2 = rng.standard_normal(H.shape[1:]).astype(np.float32)
    g2[2] = -0.0
    return g1, g2


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: p[0])
@pytest.mark.parametrize("state", list(_STATES))
@pytest.mark.parametrize("model", ["iid", "burst-dropout", "per-worker",
                                   "outage"])
@pytest.mark.parametrize("stale_cot", [True, False],
                         ids=["both-cotangents", "pooled-only"])
def test_aggregate_matches_jax_bitwise(model, state, policy, stale_cot):
    """Pooled value, new state, accounting, and the gradients of h and of
    the stale cache (raw bits) against ``repro.faults.aggregate`` and its
    vjp."""
    jm, tm = _models(jf, policy)[model], _models(tf, policy)[model]
    proto_j = JProtocol.ocs(8, max_rounds=3)
    proto_t = Protocol.ocs(8, max_rounds=3)
    g1, g2 = _cotangents()
    if not stale_cot:
        g2 = np.zeros_like(g2)
    st = _STATES[state]
    key = jax.random.PRNGKey(KEY)

    def jfun(h, stale):
        pooled, ns, acct = jf.aggregate(proto_j, jm, _jstate(**dict(
            st, stale=stale)), h, key)
        return (pooled, ns.stale), (ns, acct)

    stale0 = st.get("stale", np.zeros(H.shape[1:], np.float32))
    (jp, js), vjp, (jns, jacct) = jax.vjp(jfun, jnp.asarray(H),
                                          jnp.asarray(stale0), has_aux=True)
    jgh, jgs = vjp((jnp.asarray(g1), jnp.asarray(g2)))

    h = torch.from_numpy(H.copy()).requires_grad_(True)
    tst = _tstate(**st)
    tst = dataclasses.replace(tst, stale=tst.stale.requires_grad_(True))
    tp, tns, tacct = tf.aggregate(proto_t, tm, tst, h, jr.PRNGKey(KEY))
    outs = [tp, tns.stale] if stale_cot else [tp]
    cots = [torch.from_numpy(g1), torch.from_numpy(g2)][:len(outs)]
    tgh, tgs = torch.autograd.grad(outs, [h, tst.stale], cots,
                                   allow_unused=True)
    tgs = torch.zeros_like(tst.stale) if tgs is None else tgs

    assert np.array_equal(_raw(jp), _raw(tp)), "pooled"
    for f in ("bad", "offline", "stale", "age", "consec"):
        assert np.array_equal(_raw(getattr(jns, f)),
                              _raw(getattr(tns, f))), f
        assert getattr(tns, f).dtype == {
            "bad": torch.bool, "offline": torch.bool,
            "stale": torch.float32}.get(f, torch.int32), f
    for f in dataclasses.fields(jf.FaultAccounting):
        a, b = getattr(jacct, f.name), getattr(tacct, f.name)
        assert np.array_equal(_raw(a), _raw(b)), f.name
        assert np.asarray(a).dtype == _np(b).dtype, f.name
    assert np.array_equal(_raw(jgh), _raw(tgh)), "d_h"
    assert np.array_equal(_raw(jgs), _raw(tgs)), "d_stale"


def test_iid_reduces_to_protocol_path_bitwise():
    """FaultModel.iid is the plain Protocol path: forward, gradient and
    the shared accounting fields; a resolved frame bills nothing and the
    cache holds it."""
    proto = Protocol.ocs(8, p_miss=torch.tensor(0.3))
    fm = FaultModel.iid(0.3)
    key = jr.PRNGKey(KEY)
    h = torch.from_numpy(H.copy()).requires_grad_(True)
    pf, ns, facct = tf.aggregate(proto, fm, _tstate(), h, key)
    (gf,) = torch.autograd.grad(pf.sum(), h)
    h2 = torch.from_numpy(H.copy()).requires_grad_(True)
    pp, acct = proto.aggregate(h2, key)
    (gp,) = torch.autograd.grad(pp.sum(), h2)
    assert torch.equal(pf, pp) and torch.equal(gf, gp)
    for f in ("rounds", "collisions", "contention_slots", "correct_frac"):
        assert torch.equal(getattr(facct, f), getattr(acct, f)), f
    assert int(facct.dropped_frames) == 0 and int(facct.outage) == 0
    assert int(facct.retry_slots) == 0 and int(facct.stale_age) == 0
    assert torch.equal(ns.stale, pp.detach())
    assert not bool(ns.bad.any()) and not bool(ns.offline.any())


def test_all_true_online_and_per_worker_p_give_the_plain_draws():
    """An all-True online mask and a per-worker p_miss of equal entries
    draw what online=None and a scalar p_miss draw, alone and as lanes."""
    h = torch.from_numpy(H)
    key = jr.PRNGKey(KEY)
    want, wa = Protocol.ocs(8, p_miss=0.3).aggregate(h, key)
    got, ga = Protocol.ocs(8, p_miss=torch.full((N,), 0.3)).with_online(
        torch.ones(N, dtype=torch.bool)).aggregate(h, key)
    assert torch.equal(want, got)
    for f in ("rounds", "collisions", "contention_slots", "correct_frac"):
        assert torch.equal(getattr(wa, f), getattr(ga, f)), f
    hl = torch.stack([h, h * 0.5, -h])
    keys = jr.split(key, 3)
    p = torch.tensor([0.0, 0.3, 0.6])
    want, wa = Protocol.ocs(8, p_miss=p).aggregate(hl, keys, lanes=True)
    got, ga = Protocol.ocs(8, p_miss=p[:, None].expand(3, N)).with_online(
        torch.ones((3, N), dtype=torch.bool)).aggregate(hl, keys, lanes=True)
    assert torch.equal(want, got)
    for f in ("rounds", "collisions", "contention_slots", "correct_frac"):
        assert torch.equal(getattr(wa, f), getattr(ga, f)), f


def _outage_model(policy):
    return FaultModel.iid(0.0, policy=policy).with_dropout(1.0, 0.0)


def test_zero_fill_emits_zeros_and_no_gradient():
    fm = _outage_model(DegradePolicy.zero_fill())
    proto = Protocol.ocs(8)
    h = torch.from_numpy(H.copy()).requires_grad_(True)
    pooled, ns, acct = tf.aggregate(proto, fm, _tstate(), h, jr.PRNGKey(KEY))
    assert torch.equal(pooled, torch.zeros(H.shape[1:]))
    assert int(acct.outage) == 1
    assert int(acct.dropped_frames) == int(np.prod(H.shape[1:]))
    assert float(acct.correct_frac) == 0.0
    assert int(acct.offline_workers) == N
    assert int(ns.age) == 1 and int(ns.consec) == 1
    (g,) = torch.autograd.grad(pooled.sum(), h)
    assert torch.equal(g, torch.zeros(H.shape))
    assert bool(torch.isfinite(g).all())


def test_stale_replays_cache_and_routes_gradient_to_it():
    cache = torch.from_numpy(random_floats(11, H.shape[1:], specials=False))
    fm = _outage_model(DegradePolicy.stale())
    proto = Protocol.ocs(8)
    h = torch.from_numpy(H.copy()).requires_grad_(True)
    st = dataclasses.replace(_tstate(), stale=cache.clone().requires_grad_(
        True))
    pooled, ns, acct = tf.aggregate(proto, fm, st, h, jr.PRNGKey(KEY))
    assert torch.equal(pooled, cache) and torch.equal(ns.stale, cache)
    assert int(acct.stale_age) == 1
    g_h, g_cache = torch.autograd.grad(pooled.sum(), [h, st.stale])
    assert torch.equal(g_cache, torch.ones(H.shape[1:]))
    assert torch.equal(g_h, torch.zeros(H.shape))


def test_dark_lane_is_selected_away_not_multiplied():
    """A column with no contender decodes to -inf (the lowest code); on an
    outage lane the pool must come out as the fill, never NaN, and its
    gradient zero and finite."""
    h = torch.from_numpy(H.copy())
    h[:, 0, 0] = -float("inf")             # code 0 in every worker
    h.requires_grad_(True)
    for pol in (DegradePolicy.zero_fill(), DegradePolicy.stale()):
        fm = _outage_model(pol)
        pooled, _, _ = tf.aggregate(Protocol.ocs(8), fm, _tstate(), h,
                                    jr.PRNGKey(KEY))
        assert bool(torch.isfinite(pooled).all()), pol
        (g,) = torch.autograd.grad(pooled.sum(), h)
        assert bool(torch.isfinite(g).all()) and not bool(g.any()), pol


def test_retry_bills_budget_with_backoff_on_persistent_outage():
    budget = 3
    fm = _outage_model(DegradePolicy.retry(budget))
    proto = Protocol.ocs(8)
    pooled, _, acct = tf.aggregate(proto, fm, _tstate(),
                                   torch.from_numpy(H), jr.PRNGKey(KEY))
    frame_slots = (proto.bits + ocs.host_id_bits(N)) * int(
        np.prod(H.shape[1:]))
    expect = budget * frame_slots + sum(2 ** a for a in range(budget))
    assert int(acct.retry_slots) == expect
    assert int(acct.contention_slots) >= expect
    assert int(acct.outage) == 1
    assert torch.equal(pooled, torch.zeros(H.shape[1:]))


def test_retry_recovers_and_resolves_the_frame():
    from repro_torch.core import fedocs
    fm = FaultModel.iid(0.0, policy=DegradePolicy.retry(2)).with_dropout(
        1.0, 1.0)
    proto = Protocol.ocs(8)
    pooled, ns, acct = tf.aggregate(proto, fm, _tstate(),
                                    torch.from_numpy(H), jr.PRNGKey(KEY))
    frame_slots = (proto.bits + ocs.host_id_bits(N)) * int(
        np.prod(H.shape[1:]))
    assert int(acct.retry_slots) == frame_slots + 1
    assert int(acct.outage) == 0 and int(ns.consec) == 0
    assert torch.equal(pooled, fedocs.maxpool_quantized(
        torch.from_numpy(H), proto.bits, "first"))


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: p[0])
def test_fault_loss_fn_matches_jax(policy):
    """vertical.loss_fn(fault=, fault_state=) on one channel: the fault
    metrics and the evolved state bit for bit, the loss within the
    matmul tolerance."""
    base = dict(n_workers=N, input_dim=6, encoder_dims=(8,), embed_dim=4,
                head_dims=(8,), output_dim=3, task="classification")
    jcfg = jvert.VerticalConfig(aggregation=JProtocol.ocs(8, max_rounds=2),
                                **base)
    tcfg = tvert.VerticalConfig(aggregation=Protocol.ocs(8, max_rounds=2),
                                **base)
    params = jvert.init(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(1)
    views = rng.standard_normal((N, 16, 6)).astype(np.float32)
    labels = rng.integers(0, 3, (16,)).astype(np.int32)
    jm, tm = _models(jf, policy)["burst-dropout"], _models(
        tf, policy)["burst-dropout"]
    js, ts = jf.init_state(N, (16, 4)), tf.init_state(N, (16, 4))
    for step in range(6):
        jl, jmet = jvert.loss_fn(jcfg, params, jnp.asarray(views),
                                 jnp.asarray(labels),
                                 rng=jax.random.PRNGKey(step), fault=jm,
                                 fault_state=js)
        tl, tmet = tvert.loss_fn(tcfg, tparams, torch.from_numpy(views),
                                 torch.from_numpy(labels),
                                 rng=jr.PRNGKey(step), fault=tm,
                                 fault_state=ts)
        np.testing.assert_allclose(float(jl), float(tl), rtol=0, atol=1e-5)
        for k in ("fault_dropped_frames", "fault_stale_age", "fault_offline",
                  "fault_retry_slots", "fault_outage", "chan_rounds"):
            assert np.array_equal(np.asarray(jmet[k]), _np(tmet[k])), k
        js, ts = jmet["fault_state"], tmet["fault_state"]
        for f in ("bad", "offline", "age", "consec"):
            assert np.array_equal(np.asarray(getattr(js, f)),
                                  _np(getattr(ts, f))), f


# ---------------------------------------------------------------------------
# the fault engine
# ---------------------------------------------------------------------------

def _grid(m, policy):
    pol = getattr(m.DegradePolicy, policy[0])(*policy[1:])
    return [m.FaultModel.iid(0.0, policy=pol)] + [
        m.FaultModel.burst(burst_len=b, gap_len=2 * b, p_miss_bad=0.5,
                           p_miss_good=0.01, policy=pol).with_dropout(0.6,
                                                                      0.3)
        for b in (2, 4)]


def _port_config(jcfg):
    return ttc.CurveConfig(**{f.name: getattr(jcfg, f.name)
                              for f in dataclasses.fields(ttc.CurveConfig)})


@pytest.fixture(scope="module")
def jax_init():
    params = jvert.init(jtc._vertical_config(TINY, 8, noisy=True),
                        jax.random.PRNGKey(TINY.seed))
    return params_from_jax(jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def iid_runs(jax_init):
    ref = jtc.run_fault_curves(TINY, [jf.FaultModel.iid(p)
                                      for p in TINY.p_miss])
    got = ttc.run_fault_curves(_port_config(TINY),
                               [FaultModel.iid(p) for p in TINY.p_miss],
                               device="cpu", init_params=jax_init)
    plain = ttc.run_curves(_port_config(TINY), device="cpu",
                           init_params=jax_init)
    return ref, got, plain


@pytest.fixture(scope="module")
def burst_runs(jax_init):
    out = {}
    for policy in POLICIES:
        ref = jtc.run_fault_curves(TINY, _grid(jf, policy))
        got = ttc.run_fault_curves(_port_config(TINY), _grid(tf, policy),
                                   device="cpu", init_params=jax_init)
        out[policy[0]] = (ref, got)
    return out


def _close(ref, got, n_val):
    for f in ("loss_history", "nll"):
        np.testing.assert_allclose(getattr(ref, f), getattr(got, f),
                                   rtol=0, atol=LOSS_ATOL, err_msg=f)
    diff = np.abs(ref.acc - got.acc) * n_val
    assert np.all(diff <= ACC_SAMPLES + 1e-9), diff
    for bi in range(len(ref.params)):
        for a, b in zip(jax.tree.leaves(ref.params[bi]),
                        tree.leaves(got.params[bi])):
            np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0,
                                       atol=PARAM_ATOL)


def test_iid_lanes_train_run_curves_lanes_bitwise(iid_runs):
    """The ideal lane rides along, so iid fault lanes train the noisy
    lanes of run_curves bit for bit (raw bits), and a healthy channel
    degrades nothing."""
    _, got, plain = iid_runs
    for f in ("acc", "nll", "loss_history"):
        assert np.array_equal(getattr(got, f), getattr(plain, f)), f
    for a, b in zip(tree.leaves(got.params[0]),
                    tree.leaves(plain.noisy_params[0])):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert (got.dropped_frames == 0).all() and (got.outage_frames == 0).all()
    assert (got.stale_age == 0).all() and (got.retry_slots == 0).all()


def test_iid_lanes_match_jax(iid_runs):
    ref, got, _ = iid_runs
    assert np.array_equal(ref.logged_steps, got.logged_steps)
    _close(ref, got, TINY.n_val)


@pytest.mark.parametrize("policy", [p[0] for p in POLICIES])
def test_burst_grid_matches_jax(burst_runs, policy):
    """Bursts and dropouts under each policy: the integer telemetry bit for
    bit, losses, accuracies and parameters within tolerance.  The grid
    does see outages (under ``retry`` it retries them)."""
    ref, got = burst_runs[policy]
    for f in ("stale_age", "dropped_frames", "outage_frames",
              "retry_slots"):
        assert np.array_equal(getattr(ref, f), getattr(got, f)), (
            f, getattr(ref, f), getattr(got, f))
        assert getattr(got, f).dtype == np.int64
    if policy == "retry":
        # every outage of this grid recovers within its budget, billed
        assert got.retry_slots.sum() > 0
    else:
        assert got.outage_frames.sum() > 0
    assert np.all(np.isfinite(got.loss_history))
    _close(ref, got, TINY.n_val)


def test_fault_records_and_rows_match_jax(burst_runs):
    ref, got = burst_runs["stale"]
    rec_j = jresults.summarize_fault_curves(ref)
    rec_t = tresults.summarize_fault_curves(got)
    assert len(rec_j) == len(rec_t) == 3
    for a, b in zip(rec_j, rec_t):
        assert set(a) == set(b)
        for k in a:
            if k not in ("acc", "nll"):
                assert a[k] == b[k], k
    assert jresults.fault_curve_rows(rec_t) == tresults.fault_curve_rows(
        rec_t)


def test_fault_engine_rejects_mixed_policies_and_empty_grids():
    cfg = _port_config(TINY)
    with pytest.raises(ValueError, match="one DegradePolicy"):
        ttc.run_fault_curves(cfg, [FaultModel.iid(0.0), FaultModel.iid(
            0.1, policy=DegradePolicy.stale())], device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        ttc.run_fault_curves(cfg, [], device="cpu")


def test_fault_default_device_is_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttc.run_fault_curves(_port_config(TINY), [FaultModel.iid(0.0)])
