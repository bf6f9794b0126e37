"""The port's ``BitsSchedule`` policies and ``run_scheduled_curves``
against the JAX package's, on the reference test's ``SCHED_TINY`` grid
(``tests/test_protocol.py``) from the JAX package's initial parameters.

The policies' arithmetic is held bit for bit (the float32 EMA and the
chosen indices), and so is the depth every step trained with.  Losses,
accuracies and parameters are held within the tolerances of
``tests/test_torch_curves.py``, for its reason: the matmuls' float sums run
in another order in XLA than in PyTorch.  Against the port's own
``run_curves`` a ``FixedBits`` run is held bit for bit (raw bit views).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import vertical as jvert
from repro.protocol import schedule as jsched
from repro.sim import train_curves as jtc
from repro_torch import tree
from repro_torch.convert import params_from_jax
from repro_torch.protocol import schedule as tsched
from repro_torch.protocol import (BitsSchedule, CollisionAdaptiveBits,
                                  FixedBits)
from repro_torch.sim import train_curves as ttc

torch.set_num_threads(1)

SCHED_TINY = jtc.CurveConfig(bits=(8,), p_miss=(0.0, 0.3), steps=8,
                             batch=16, n_train=128, n_val=64, hw=8,
                             encoder_dims=(8,), embed_dim=8, head_dims=(8,),
                             log_every=4)
ADAPTIVE_CFG = dataclasses.replace(SCHED_TINY, bits=(8, 16),
                                   p_miss=(0.1, (0.0, 0.1, 0.1, 0.3), 0.4))
# the reference test's hair-trigger policy, and one that also backs off
SCHEDULES = {
    "hair-trigger": dict(escalate=0.01, deescalate=0.0, decay=0.0),
    "ema": dict(escalate=0.02, deescalate=0.015, decay=0.5),
}
# as tests/test_torch_curves.py: float32 sums in another order
LOSS_ATOL = 1e-4
ACC_SAMPLES = 2
PARAM_ATOL = 1e-4


def _port_config(jcfg):
    return ttc.CurveConfig(**{f.name: getattr(jcfg, f.name)
                              for f in dataclasses.fields(ttc.CurveConfig)})


def _jax_init(jcfg, bits):
    params = jvert.init(jtc._vertical_config(jcfg, bits, noisy=True),
                        jax.random.PRNGKey(jcfg.seed))
    return params_from_jax(jax.tree.map(np.asarray, params))


def _raw(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


@pytest.fixture(scope="module")
def fixed_runs():
    """FixedBits(8) in both packages, and the port's run_curves."""
    ref = jtc.run_scheduled_curves(SCHED_TINY, jsched.FixedBits(8))
    init = _jax_init(SCHED_TINY, 8)
    got = ttc.run_scheduled_curves(_port_config(SCHED_TINY), FixedBits(8),
                                   device="cpu", init_params=init)
    plain = ttc.run_curves(_port_config(SCHED_TINY), device="cpu",
                           init_params=init)
    return ref, got, plain


@pytest.fixture(scope="module")
def adaptive_runs():
    """Each of SCHEDULES as CollisionAdaptiveBits((8, 16)) in both
    packages."""
    out = {}
    init = _jax_init(ADAPTIVE_CFG, 8)
    for name, kw in SCHEDULES.items():
        ref = jtc.run_scheduled_curves(
            ADAPTIVE_CFG, jsched.CollisionAdaptiveBits((8, 16), **kw))
        got = ttc.run_scheduled_curves(
            _port_config(ADAPTIVE_CFG), CollisionAdaptiveBits((8, 16), **kw),
            device="cpu", init_params=init)
        out[name] = (ref, got)
    return out


def _close(ref, got, n_val):
    for f in ("loss_history", "nll"):
        np.testing.assert_allclose(getattr(ref, f), getattr(got, f),
                                   rtol=0, atol=LOSS_ATOL, err_msg=f)
    diff = np.abs(ref.acc - got.acc) * n_val
    assert np.all(diff <= ACC_SAMPLES + 1e-9), diff
    for a, b in zip(jax.tree.leaves(ref.params), tree.leaves(got.params)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0,
                                   atol=PARAM_ATOL)


# ---------------------------------------------------------------------------
# the policies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("build", [
    lambda m: m.BitsSchedule(candidates=()),
    lambda m: m.BitsSchedule(candidates=(8, 33)),
    lambda m: m.BitsSchedule(candidates=(8, 16), init_index=2),
    lambda m: m.FixedBits(0),
    lambda m: m.CollisionAdaptiveBits((8, 16), escalate=0.01,
                                      deescalate=0.02),
    lambda m: m.CollisionAdaptiveBits((8, 16), decay=1.0),
    lambda m: m.CollisionAdaptiveBits((), decay=0.5),
])
def test_validation_matches_jax(build):
    with pytest.raises(ValueError) as want:
        build(jsched)
    with pytest.raises(ValueError) as got:
        build(tsched)
    assert str(got.value) == str(want.value)


def test_base_schedule_has_no_policy():
    with pytest.raises(NotImplementedError):
        BitsSchedule(candidates=(8,)).update(None, {})


@pytest.mark.parametrize("kw", [dict(), dict(escalate=0.02, deescalate=0.01,
                                             decay=0.5, init_index=1)],
                         ids=["default", "backs-off"])
def test_collision_adaptive_update_matches_jax_bitwise(kw):
    """A telemetry sequence that climbs and falls: every step's EMA (raw
    float32 bits) and index equal the JAX policy's."""
    cands = (8, 12, 16)
    j, t = (jsched.CollisionAdaptiveBits(cands, **kw),
            tsched.CollisionAdaptiveBits(cands, **kw))
    coll = np.random.default_rng(0).random(40).astype(np.float32) * 0.06
    coll[20:] *= 0.05
    js, ts = j.init_state(), t.init_state()
    for c in coll:
        js, ji = j.update(js, {"collision_frac": jnp.float32(c)})
        ts, ti = t.update(ts, {"collision_frac": torch.tensor(c)})
        assert int(ji) == int(ti)
        assert np.asarray(js["ema"]).view(np.int32) == int(
            ts["ema"].view(torch.int32))
        assert ts["idx"].dtype == torch.int32 and ts["ema"].dtype == \
            torch.float32


def test_fixed_bits_update_keeps_index_zero():
    st = FixedBits(16).init_state()
    st2, idx = FixedBits(16).update(st, {"collision_frac": torch.tensor(1.)})
    assert int(idx) == 0 and int(st2) == 0


# ---------------------------------------------------------------------------
# the scheduled engine
# ---------------------------------------------------------------------------

def test_fixed_schedule_trains_run_curves_lanes_bitwise(fixed_runs):
    """The ideal lane rides along at the step's depth, so FixedBits(8)
    trains the noisy lanes of run_curves(bits=(8,)) bit for bit."""
    _, got, plain = fixed_runs
    assert np.array_equal(got.acc, plain.acc[0])
    assert np.array_equal(got.nll, plain.nll[0])
    assert np.array_equal(got.loss_history, plain.loss_history[0])
    assert np.array_equal(got.bits_per_step, np.full(SCHED_TINY.steps, 8))
    for a, b in zip(tree.leaves(got.params),
                    tree.leaves(plain.noisy_params[0])):
        assert torch.equal(_raw(a), _raw(b))


def test_fixed_schedule_matches_jax(fixed_runs):
    ref, got, _ = fixed_runs
    assert np.array_equal(ref.bits_per_step, got.bits_per_step)
    assert np.array_equal(ref.logged_steps, got.logged_steps)
    assert np.array_equal(ref.p_miss, got.p_miss)
    _close(ref, got, SCHED_TINY.n_val)
    np.testing.assert_allclose(ref.collision_frac, got.collision_frac,
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_adaptive_schedule_matches_jax(adaptive_runs, name):
    """Mixed scalar and per-worker lanes: the depth of every step equals
    the JAX engine's, bit for bit, and so does the telemetry it read."""
    ref, got = adaptive_runs[name]
    assert np.array_equal(ref.bits_per_step, got.bits_per_step), (
        ref.bits_per_step, got.bits_per_step)
    assert np.array_equal(ref.collision_frac, got.collision_frac)
    assert got.bits_per_step[0] == 8 and (got.bits_per_step == 16).any()
    _close(ref, got, ADAPTIVE_CFG.n_val)
    assert got.acc.shape == (3,)
    assert got.loss_history.shape == (len(ADAPTIVE_CFG.logged_steps()), 3)


def test_ema_schedule_backs_off(adaptive_runs):
    """The EMA policy both escalates and de-escalates on this grid."""
    _, got = adaptive_runs["ema"]
    steps = got.bits_per_step
    assert (np.diff(steps) > 0).any() and (np.diff(steps) < 0).any(), steps


def test_scheduled_run_is_deterministic():
    s = CollisionAdaptiveBits((8, 16), escalate=0.05, decay=0.5)
    cfg = dataclasses.replace(_port_config(SCHED_TINY), steps=4,
                              log_every=2)
    a = ttc.run_scheduled_curves(cfg, s, device="cpu")
    b = ttc.run_scheduled_curves(cfg, s, device="cpu")
    assert np.array_equal(a.acc, b.acc)
    assert np.array_equal(a.bits_per_step, b.bits_per_step)
    assert np.all(np.isfinite(a.loss_history))


def test_scheduled_default_device_is_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttc.run_scheduled_curves(_port_config(SCHED_TINY), FixedBits(8))
