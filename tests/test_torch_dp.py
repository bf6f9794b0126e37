"""The port's compressed data-parallel comms (``repro_torch.optim
.{grad_compression, compressed_allreduce}``, ``run_curves_dp`` and its
records) against the JAX package's.

Held bit for bit: the top-k masks (ties to the lowest flat index), the
sparse values and the error memory (the bf16 cast residual included),
``CompressedAllReduce.reduce`` over a rank axis against the JAX package's
``vmap(axis_name="d")`` reduce, the analytic bills, and every measured
payload count of ``run_curves_dp``.  Its losses, accuracies and parameters
are held within the tolerances of ``tests/test_torch_curves.py``, for its
reason: the matmuls' float sums run in another order in XLA than in
PyTorch, and a last-bit difference can move an embedding across a D-bit
bucket edge or reorder two near-equal gradient magnitudes at the top-k
threshold.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import vertical as jvert
from repro.optim import compressed_allreduce as jca
from repro.optim import grad_compression as jgc
from repro.sim import results as jresults
from repro.sim import train_curves as jtc
from repro_torch import tree
from repro_torch.convert import params_from_jax
from repro_torch.optim import compressed_allreduce as tca
from repro_torch.optim import grad_compression as tgc
from repro_torch.sim import results as tresults
from repro_torch.sim import train_curves as ttc

torch.set_num_threads(1)

TINY_DP = jtc.CurveConfig(bits=(8,), p_miss=(0.0, 0.3), steps=6, batch=16,
                          n_train=128, n_val=64, hw=8, encoder_dims=(8,),
                          embed_dim=8, head_dims=(8,), log_every=3,
                          dp_shards=2)
# four ranks of 4 samples, a per-worker lane, the 16-bit code
WIDE_DP = dataclasses.replace(TINY_DP, bits=(16,), dp_shards=4,
                              p_miss=(0.1, (0.0, 0.1, 0.1, 0.3)))
K_FRAC = 1 / 8
# as tests/test_torch_curves.py: float32 sums in another order
LOSS_ATOL = 1e-4
ACC_SAMPLES = 2
PARAM_ATOL = 1e-4


def _port_config(jcfg):
    return ttc.CurveConfig(**{f.name: getattr(jcfg, f.name)
                              for f in dataclasses.fields(ttc.CurveConfig)})


def _jax_init(jcfg):
    params = jvert.init(jtc._vertical_config(jcfg, jcfg.bits[0], noisy=True),
                        jax.random.PRNGKey(jcfg.seed))
    return params_from_jax(jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module", params=["TINY_DP", "WIDE_DP"])
def dp_runs(request):
    jcfg = {"TINY_DP": TINY_DP, "WIDE_DP": WIDE_DP}[request.param]
    ref = jtc.run_curves_dp(jcfg, jca.CompressedAllReduce.topk(K_FRAC),
                            n_devices=1)
    got = ttc.run_curves_dp(_port_config(jcfg),
                            tca.CompressedAllReduce.topk(K_FRAC),
                            device="cpu", init_params=_jax_init(jcfg))
    return jcfg, ref, got


def _raw(a) -> np.ndarray:
    """Float values as their raw bits (bfloat16 as int16, float32 as
    int32), of either package."""
    if isinstance(a, torch.Tensor):
        a = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.float32 else a


# ---------------------------------------------------------------------------
# top-k with error feedback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x", [
    np.ones((256,)),                        # everything tied
    np.zeros((256,)),                       # all-zero gradient
    np.repeat([3.0, -3.0, 1.0, 0.0], 64),   # tied blocks at the threshold
    np.random.default_rng(3).integers(-2, 3, size=512),   # quantized
    np.random.default_rng(0).standard_normal(1024),
], ids=["all-tied", "zeros", "tied-blocks", "quantized", "normal"])
@pytest.mark.parametrize("k_frac", [1 / 16, 1 / 8, 1.0])
def test_topk_mask_matches_jax_bitwise(x, k_frac):
    want = np.asarray(jgc.topk_mask(jnp.asarray(x, jnp.float32), k_frac))
    got = tgc.topk_mask(torch.tensor(x, dtype=torch.float32), k_frac)
    assert np.array_equal(got.numpy(), want)
    assert int(got.sum()) == tgc.topk_count(x.size, k_frac)


def test_topk_mask_batched_equals_each_tensor():
    """Over leading (lane, rank) axes every tensor keeps its own exact k,
    as one call per tensor would."""
    rng = np.random.default_rng(5)
    x = rng.integers(-3, 4, size=(3, 2, 7, 9)).astype(np.float32)
    got = tgc.topk_mask(torch.from_numpy(x), 1 / 8, batch_dims=2)
    for i in range(3):
        for j in range(2):
            want = np.asarray(jgc.topk_mask(jnp.asarray(x[i, j]), 1 / 8))
            assert np.array_equal(got[i, j].numpy(), want), (i, j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_counted_matches_jax(dtype):
    """The residual is taken against the value sent in g's dtype, so for
    bf16 the cast error feeds back: sparse.float() + new_err ==
    g.float() + err exactly, and every output equals the JAX package's."""
    rng = np.random.default_rng(4)
    g32 = rng.standard_normal((256,)).astype(np.float32)
    err = (rng.standard_normal((256,)) * 0.1).astype(np.float32)
    jg = jnp.asarray(g32, jnp.bfloat16 if dtype == "bfloat16"
                     else jnp.float32)
    tg = torch.from_numpy(np.array(jg.astype(jnp.float32))).to(
        getattr(torch, dtype))
    ws, we, wk = jgc.compress_counted(jg, jnp.asarray(err), 1 / 8)
    gs, ge, gk = tgc.compress_counted(tg, torch.from_numpy(err), 1 / 8)
    assert gs.dtype == getattr(torch, dtype)
    assert np.array_equal(_raw(gs), _raw(ws))
    assert np.array_equal(_raw(ge), _raw(we))
    assert int(gk) == int(wk) == 32
    total = gs.float() + ge
    assert torch.equal(total, tg.float() + torch.from_numpy(err))


def test_compress_tree_and_payload_fraction_match_jax():
    rng = np.random.default_rng(6)
    params = {"w": rng.standard_normal((16, 8)).astype(np.float32),
              "b": [rng.standard_normal((8,)).astype(np.float32),
                    rng.standard_normal((3,)).astype(np.float32)]}
    jt = jax.tree.map(jnp.asarray, params)
    tt = params_from_jax(params)
    ws, we = jgc.compress_tree(jt, jgc.init_error(jt), 1 / 8)
    gs, ge = tgc.compress_tree(tt, tgc.init_error(tt), 1 / 8)
    for a, b in zip(jax.tree.leaves((ws, we)), tree.leaves((gs, ge))):
        assert np.array_equal(_raw(b), _raw(a))
    for k in (1 / 64, 1 / 8, 0.5):
        assert tgc.payload_fraction(tt, k) == jgc.payload_fraction(jt, k)
    with pytest.raises(ValueError, match="no leaves"):
        tgc.payload_fraction({}, 1 / 8)


# ---------------------------------------------------------------------------
# the compressed all-reduce
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ranks", [1, 2, 3])
@pytest.mark.parametrize("index_bits", [None, 32])
def test_reduce_over_rank_axis_matches_jax_vmap(ranks, index_bits):
    """The port's rank axis (with two lanes before it) against the JAX
    package's ``vmap(axis_name="d")`` reduce on the same gradients: the
    summed sparse tree, every rank's error memory and the accounting."""
    rng = np.random.default_rng(ranks)
    shapes = {"enc": (4, 5, 7), "bias": (3,), "zero": (10,)}
    grads = {k: rng.standard_normal((2, ranks) + s).astype(np.float32)
             for k, s in shapes.items()}
    grads["zero"][:] = 0.0                  # all tied: exact k still
    err = {k: (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
           for k, v in grads.items()}
    jc = jca.CompressedAllReduce.topk(K_FRAC, index_bits=index_bits)
    tc_ = tca.CompressedAllReduce.topk(K_FRAC, index_bits=index_bits)
    red, new_err, acct = tc_.reduce(params_from_jax(grads),
                                    params_from_jax(err), rank_dim=1)
    for lane in range(2):
        jr_, je, ja = jax.vmap(lambda g, e: jc.reduce(g, e, axis_name="d"),
                               axis_name="d")(
            {k: jnp.asarray(v[lane]) for k, v in grads.items()},
            {k: jnp.asarray(v[lane]) for k, v in err.items()})
        for k in shapes:
            assert np.array_equal(_raw(red[k][lane]),
                                  _raw(np.asarray(jr_[k])[0])), k
            assert np.array_equal(_raw(new_err[k][lane]),
                                  _raw(np.asarray(je[k]))), k
        for f in ("payload_bits", "kept_elems", "dense_bits"):
            assert int(getattr(acct, f)[lane]) == int(
                np.asarray(getattr(ja, f))[0]), f
    # the measured bill is the analytic one times the ranks
    one = {k: v[0, 0] for k, v in grads.items()}
    assert int(acct.payload_bits[0]) == jc.payload_bits(one) * ranks
    assert int(acct.dense_bits[0]) == jc.dense_bits(one) * ranks


def test_one_rank_reduce_and_analytic_bills_match_jax():
    rng = np.random.default_rng(9)
    grads = {"a": rng.standard_normal((33, 4)).astype(np.float32),
             "b": rng.standard_normal((5,)).astype(np.float32)}
    jc = jca.CompressedAllReduce.topk(1 / 16)
    tc_ = tca.CompressedAllReduce.topk(1 / 16)
    jt, tt = jax.tree.map(jnp.asarray, grads), params_from_jax(grads)
    wr, we, wa = jc.reduce(jt, jc.init_error(jt))
    gr, ge, ga = tc_.reduce(tt, tc_.init_error(tt))
    for a, b in zip(jax.tree.leaves((wr, we)), tree.leaves((gr, ge))):
        assert np.array_equal(_raw(b), _raw(a))
    for f in ("payload_bits", "kept_elems", "dense_bits"):
        assert int(getattr(ga, f)) == int(getattr(wa, f)), f
    for f in ("payload_bits", "dense_bits", "payload_fraction"):
        assert getattr(tc_, f)(tt) == getattr(jc, f)(jt), f


@pytest.mark.parametrize("kw", [dict(k_frac=0.0), dict(k_frac=1.5),
                                dict(k_frac=0.5, value_bits=0),
                                dict(k_frac=0.5, index_bits=0)])
def test_policy_validation_matches_jax(kw):
    with pytest.raises(ValueError) as want:
        jca.CompressedAllReduce.topk(**kw)
    with pytest.raises(ValueError) as got:
        tca.CompressedAllReduce.topk(**kw)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# run_curves_dp against the JAX package's vmap path
# ---------------------------------------------------------------------------

def test_dp_payload_matches_jax_exactly(dp_runs):
    jcfg, ref, got = dp_runs
    for f in ("dp_payload_bits_step", "dp_dense_bits_step"):
        assert getattr(got, f) == getattr(ref, f), f
    for f in ("dp_payload_bits", "dp_payload_bits_total"):
        assert getattr(got, f).dtype == np.int64
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f
    # the accounting acceptance: measured == the exact-k bill every step
    assert np.all(got.dp_payload_bits == got.dp_payload_bits_step)
    assert np.all(got.dp_payload_bits_total
                  == got.dp_payload_bits_step * jcfg.steps)
    assert 0 < got.dp_payload_bits_step < got.dp_dense_bits_step


def test_dp_losses_and_accuracy_match_jax(dp_runs):
    jcfg, ref, got = dp_runs
    assert np.array_equal(got.logged_steps, ref.logged_steps)
    assert np.array_equal(got.p_miss, ref.p_miss)
    for f in ("loss_history", "nll"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f), rtol=0,
                                   atol=LOSS_ATOL, err_msg=f)
    diff = np.abs(got.acc - ref.acc) * jcfg.n_val
    assert np.all(diff <= ACC_SAMPLES + 1e-9), diff
    for a, b in zip(jax.tree.leaves(ref.params[0]),
                    tree.leaves(got.params[0])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=PARAM_ATOL)


def test_dp_records_match_jax(dp_runs):
    _, ref, got = dp_runs
    rw, rg = jresults.summarize_dp_curves(ref), tresults.summarize_dp_curves(
        got)
    assert len(rw) == len(rg)
    for a, b in zip(rw, rg):
        assert list(a) == list(b)
        for key in a:
            if key in ("acc", "nll"):
                assert abs(a[key] - b[key]) <= (
                    LOSS_ATOL if key == "nll" else ACC_SAMPLES / 64), key
            else:
                assert a[key] == b[key], (key, a[key], b[key])
    assert [r.split(";acc=")[0] for r in tresults.dp_curve_rows(rg)] == \
        [r.split(";acc=")[0] for r in jresults.dp_curve_rows(rw)]


def test_one_rank_uncompressed_p0_lane_is_run_curves():
    """One rank keeping every entry is plain data parallelism of one: the
    ``p_miss=0`` lane (whose forward draws no sensing bit) trains bit for
    bit the ``run_curves`` lane.  (A noisy lane does not: its rank key is
    ``fold_in(lane_key, 0)``.)"""
    cfg = _port_config(dataclasses.replace(TINY_DP, dp_shards=1,
                                           bits=(8, 16)))
    dp = ttc.run_curves_dp(cfg, tca.CompressedAllReduce.topk(1.0),
                           device="cpu")
    plain = ttc.run_curves(cfg, device="cpu")
    for bi in range(2):
        assert np.array_equal(dp.loss_history[bi, :, 0],
                              plain.loss_history[bi, :, 0])
        assert dp.acc[bi, 0] == plain.acc[bi, 0]
        for x, y in zip(tree.leaves(dp.params[bi]),
                        tree.leaves(plain.noisy_params[bi])):
            assert torch.equal(x[0].view(torch.int32),
                               y[0].view(torch.int32))


def test_dp_run_is_deterministic_and_lanes_differ():
    cfg = _port_config(TINY_DP)
    car = tca.CompressedAllReduce.topk(K_FRAC)
    a = ttc.run_curves_dp(cfg, car, device="cpu")
    b = ttc.run_curves_dp(cfg, car, device="cpu")
    for f in ("acc", "nll", "loss_history", "dp_payload_bits_total"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert not np.array_equal(a.loss_history[0, :, 0],
                              a.loss_history[0, :, 1])
    two = ttc.run_curves_dp(dataclasses.replace(cfg, dp_shards=1), car,
                            device="cpu")
    assert a.dp_payload_bits_step == 2 * two.dp_payload_bits_step


@pytest.mark.parametrize("dp_shards", [0, 3])
def test_dp_config_validation_matches_jax(dp_shards):
    with pytest.raises(ValueError) as want:
        dataclasses.replace(TINY_DP, dp_shards=dp_shards)
    with pytest.raises(ValueError) as got:
        dataclasses.replace(_port_config(TINY_DP), dp_shards=dp_shards)
    assert str(got.value) == str(want.value)


def test_dp_placement_and_device():
    cfg = _port_config(TINY_DP)
    car = tca.CompressedAllReduce.topk(K_FRAC)
    with pytest.raises(ValueError, match="no process group"):
        ttc.run_curves_dp(cfg, car, n_devices=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttc.run_curves_dp(cfg, car)
