"""``repro_torch.random`` against ``jax.random``, bit for bit.

The port's keys are int64 ``(..., 2)`` tensors of uint32 words; every
comparison here is exact (``np.array_equal`` on the uint32 words, the
float32 uniforms and the int32 draws)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import random as jr

torch.set_num_threads(1)

SEEDS = [0, 1, 42, 7919 * 16, 2**31 - 1, 2**40 + 3]


def _words(key: torch.Tensor) -> np.ndarray:
    return key.numpy().astype(np.uint32)


def _jkey(seed):
    if seed >= 2**31:   # PRNGKey takes an int32 seed here: build the words
        return jnp.asarray([seed >> 32, seed & 0xFFFFFFFF], jnp.uint32)
    return jax.random.PRNGKey(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    assert np.array_equal(np.asarray(_jkey(seed)), _words(jr.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [1, 2, 5])
def test_split(seed, num):
    got = jr.split(jr.PRNGKey(seed), num)
    assert got.shape == (num, 2)
    assert np.array_equal(np.asarray(jax.random.split(_jkey(seed), num)),
                          _words(got))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_scalar_and_lanes(seed):
    kj, kt = _jkey(seed), jr.PRNGKey(seed)
    for d in (0, 1, 17, 60, 2**31 + 5):
        assert np.array_equal(np.asarray(jax.random.fold_in(kj, d)),
                              _words(jr.fold_in(kt, d)))
    lanes_j, lanes_t = jax.random.split(kj, 4), jr.split(kt, 4)
    # the curve engine's per-step lane keys: fold one step into every lane
    want = jax.vmap(jax.random.fold_in, in_axes=(0, None))(lanes_j, 9)
    assert np.array_equal(np.asarray(want), _words(jr.fold_in(lanes_t, 9)))
    # the contention draws' key grid: rounds x sub-slots per lane
    want = jax.vmap(lambda k: jax.vmap(lambda r: jax.vmap(
        lambda d: jax.random.fold_in(jax.random.fold_in(k, r), d))(
            jnp.arange(5)))(jnp.arange(3)))(lanes_j)
    got = jr.fold_in(jr.fold_in(lanes_t[:, None], torch.arange(3))[:, :, None],
                     torch.arange(5))
    assert np.array_equal(np.asarray(want), _words(got))


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("shape", [(7,), (4, 33), (2, 3, 5)])
def test_uniform_and_bernoulli_scalar_p(seed, shape):
    kj, kt = _jkey(seed), jr.PRNGKey(seed)
    assert np.array_equal(np.asarray(jax.random.uniform(kj, shape)),
                          jr.uniform(kt, shape).numpy())
    for p in (0.0, 0.3, 0.7, 0.98):
        want = jax.random.bernoulli(kj, jnp.float32(p), shape)
        got = jr.bernoulli(kt, torch.tensor(p, dtype=torch.float32), shape)
        assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_bernoulli_per_worker_p(seed):
    """An (N, 1) probability column: one miss rate per worker row."""
    p = np.array([0.1, 0.5, 0.9, 0.99], np.float32)[:, None]
    want = jax.random.bernoulli(_jkey(seed), jnp.asarray(p), (4, 50))
    got = jr.bernoulli(jr.PRNGKey(seed), torch.from_numpy(p), (4, 50))
    assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("lo,hi", [(0, 128), (0, 2048), (0, 100000),
                                   (-5, 77), (3, 3), (5, 2),
                                   (-2**31, 2**31 - 1)])
def test_randint(seed, lo, hi):
    want = jax.random.randint(_jkey(seed), (64,), lo, hi)
    got = jr.randint(jr.PRNGKey(seed), (64,), lo, hi)
    assert got.dtype == torch.int32
    assert np.array_equal(np.asarray(want), got.numpy())


# ---------------------------------------------------------------------------
# 16-bit draws: the OCS channel over bfloat16 / float16 activations
# ---------------------------------------------------------------------------

_HALF = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
         "float16": (jnp.float16, torch.float16)}


@pytest.mark.parametrize("dtype", sorted(_HALF))
@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("shape", [(7,), (4, 33), (2, 3, 5)])
def test_uniform_and_bernoulli_16_bit(dtype, seed, shape):
    """bfloat16 draws 8 random bits (7 mantissa bits), float16 16; the
    uniforms and the comparison ``u < p`` are in the 16-bit type."""
    jdt, tdt = _HALF[dtype]
    kj, kt = _jkey(seed), jr.PRNGKey(seed)
    want = np.asarray(jax.random.uniform(kj, shape, jdt))
    got = jr.uniform(kt, shape, tdt)
    assert got.dtype == tdt
    assert np.array_equal(want.view(np.uint16),
                          got.view(torch.int16).numpy().view(np.uint16))
    for p in (0.0, 0.05, 0.3, 0.98):
        pj = jnp.asarray(p, jnp.float32).astype(jdt)
        want = jax.random.bernoulli(kj, pj, shape)
        got = jr.bernoulli(kt, torch.tensor(p).to(tdt), shape)
        assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("dtype", sorted(_HALF))
def test_bernoulli_per_worker_p_16_bit(dtype):
    jdt, tdt = _HALF[dtype]
    p = np.array([0.05, 0.5, 0.9, 0.99], np.float32)[:, None]
    want = jax.random.bernoulli(_jkey(3), jnp.asarray(p).astype(jdt), (4, 50))
    got = jr.bernoulli(jr.PRNGKey(3), torch.from_numpy(p).to(tdt), (4, 50))
    assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_sensing_keep_prob_keeps_feature_dtype(dtype):
    """``1 - p_miss`` in the features' type, as the JAX core draws it."""
    from repro.core import ocs as jocs
    from repro_torch.core import ocs as tocs
    jdt, tdt = {"float32": (jnp.float32, torch.float32), **_HALF}[dtype]
    for p in (0.05, np.array([0.0, 0.05, 0.1, 0.3], np.float32)):
        want = np.asarray(jocs.sensing_keep_prob(p, jdt)).astype(np.float32)
        got = tocs.sensing_keep_prob(torch.as_tensor(p), tdt)
        assert got.dtype == tdt
        assert np.array_equal(want, got.float().numpy())
        lanes = tocs.sensing_keep_prob(torch.as_tensor(p)[None], tdt,
                                       lanes=True)
        assert lanes.dtype == tdt
        assert np.array_equal(want, lanes[0].reshape(want.shape).float()
                              .numpy())


@pytest.mark.parametrize("p_miss", [0.05, 0.3])
def test_ocs_aggregate_bf16_matches_jax(p_miss):
    """``Protocol.ocs(8, p).aggregate`` over bf16 (16 workers, 2 x 1 x 64)
    — the serving path's fusion site — bitwise: pooled values, winners (by
    the winner-routed gradient) and accounting."""
    from repro.protocol import Protocol as JP
    from repro_torch.protocol import Protocol as TP
    h_np = np.random.default_rng(5).standard_normal((16, 2, 1, 64)) * 2.0
    hj = jnp.asarray(h_np, jnp.float32).astype(jnp.bfloat16)
    ht = torch.from_numpy(np.array(hj.astype(jnp.float32))).to(
        torch.bfloat16).requires_grad_(True)
    p = np.full((16,), p_miss, np.float32)
    g_np = np.random.default_rng(6).standard_normal((2, 1, 64))
    gj = jnp.asarray(g_np, jnp.float32).astype(jnp.bfloat16)
    (want, acct_j), vjp = jax.vjp(
        lambda h: JP.ocs(bits=8, p_miss=p).aggregate(h, jax.random.PRNGKey(9)),
        hj)
    (gh_j,) = vjp((gj, jax.tree.map(jnp.zeros_like, acct_j)))
    got, acct_t = TP.ocs(bits=8, p_miss=p).aggregate(ht, jr.PRNGKey(9))
    (gh_t,) = torch.autograd.grad(
        got, ht, torch.from_numpy(np.array(gj.astype(jnp.float32))).to(
            torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(np.asarray(want).view(np.uint16),
                          got.detach().view(torch.int16).numpy()
                          .view(np.uint16))
    # the gradient lands on the winner alone: equal gradients, equal winners
    assert np.array_equal(np.asarray(gh_j).view(np.uint16),
                          gh_t.view(torch.int16).numpy().view(np.uint16))
    for f in ("rounds", "collisions", "contention_slots", "correct_frac"):
        assert np.array_equal(np.asarray(getattr(acct_j, f)),
                              getattr(acct_t, f).numpy()), f


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-2.0, 3.0), ("tiny", 1.0)])
def test_uniform_range_bitwise(seed, dtype, lo, hi):
    """JAX's scale and clamp, ``max(lo, u * (hi - lo) + lo)``, with XLA's
    rounding (bf16 per operation; float32 and float16 one fused
    multiply-add), bit for bit."""
    tdt = getattr(torch, dtype)
    if lo == "tiny":
        lo = float(torch.finfo(tdt).tiny)
    want = np.asarray(jax.random.uniform(_jkey(seed), (5, 33),
                                         getattr(jnp, dtype), lo, hi))
    got = jr.uniform(jr.PRNGKey(seed), (5, 33), tdt, minval=lo, maxval=hi)
    assert np.array_equal(got.float().numpy(), want.astype(np.float32))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_two_ulps_of_its_logs(seed):
    """The draw under the two logs is JAX's bit for bit; torch's and XLA's
    ``log`` round up to an ulp apart each, and the outer log of a draw
    near 1/e (inner value ~1) turns the inner one's ulp into an absolute
    error of ~eps: within ``2 * eps * max(1, |g|)`` (1.88 the most seen
    over 50 seeds)."""
    want = np.asarray(jax.random.gumbel(_jkey(seed), (64, 500)))
    got = jr.gumbel(jr.PRNGKey(seed), (64, 500)).numpy()
    eps = np.finfo(np.float32).eps
    assert np.all(np.abs(got - want) <= 2 * eps * np.maximum(1, np.abs(want)))


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_matches_jax(seed):
    """The Gumbel-max draw: on these seeds and logits no near-tie falls
    within the draws' rounding, so every sample is JAX's."""
    logits = np.random.default_rng(seed % 2**32).standard_normal(
        (16, 300)).astype(np.float32)
    want = np.asarray(jax.random.categorical(_jkey(seed), jnp.asarray(logits)))
    got = jr.categorical(jr.PRNGKey(seed), torch.from_numpy(logits))
    assert np.array_equal(got.numpy(), want)
