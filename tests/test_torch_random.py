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
