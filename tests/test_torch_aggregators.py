"""The port's Table I pieces against the JAX package's: the five methods'
configs (``core/aggregators``), ``vertical.per_worker_predictions`` (the
"Best Worker Pred" baseline), ``vertical.comm_load`` and the paper's
configs (``configs/fedocs_cifar``, ``configs/fedocs_mnist``), on the small
config of ``tests/test_vertical.py`` with the JAX package's parameters
carried across by ``convert.params_from_jax``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import fedocs_cifar as jcifar
from repro.configs import fedocs_mnist as jmnist
from repro.core import aggregators as jagg
from repro.core import vertical as jvert
from repro_torch.configs import fedocs_cifar as tcifar
from repro_torch.configs import fedocs_mnist as tmnist
from repro_torch.convert import params_from_jax
from repro_torch.core import aggregators as tagg
from repro_torch.core import vertical as tvert

torch.set_num_threads(1)

# float sums of the encoder and head matmuls run in another order in XLA
# than in PyTorch: a last-bit difference per op
ATOL = 1e-5

_BASE = dict(n_workers=4, input_dim=32, encoder_dims=(16,), embed_dim=8,
             head_dims=(16,), output_dim=10, task="classification")


def _pair(**kw):
    base = dict(_BASE, **kw)
    return jvert.VerticalConfig(**base), tvert.VerticalConfig(**base)


def _data(n, d, out, b=6, seed=0):
    rng = np.random.default_rng(seed)
    views = rng.standard_normal((n, b, d)).astype(np.float32)
    labels = rng.integers(0, out, (b,)).astype(np.int32)
    return views, labels


def _proto_fields(p):
    """A protocol's static fields, comparable across the packages."""
    return None if isinstance(p, str) else (
        p.kind, p.bits, p.tie_break, p.max_rounds, p.backend, p.n_channels,
        p.payload_bits)


@pytest.mark.parametrize("method", jagg.TABLE1_METHODS)
def test_table1_configs_match_jax(method):
    jbase, tbase = _pair()
    j, t = jagg.table1_config(method, jbase), tagg.table1_config(method,
                                                                tbase)
    assert _proto_fields(j.aggregation) == _proto_fields(t.aggregation)
    assert j.prediction_level == t.prediction_level
    assert j.head_input_dim() == t.head_input_dim()
    assert jagg.display_name(method) == tagg.display_name(method)


def test_table1_registry_complete():
    assert tagg.TABLE1_METHODS == jagg.TABLE1_METHODS
    cfgs = tagg.all_configs(_pair()[1])
    assert set(cfgs) == set(tagg.TABLE1_METHODS)
    assert cfgs["fedocs"].aggregation.kind == "max"
    assert cfgs["concat_workers_embed"].head_input_dim() == 4 * 8
    assert cfgs["avg_workers_preds"].prediction_level
    with pytest.raises(ValueError, match="unknown Table-I method"):
        tagg.table1_config("median", _pair()[1])


@pytest.mark.parametrize("method", jagg.TABLE1_METHODS)
def test_comm_load_per_method_matches_jax(method):
    jbase, tbase = _pair()
    for bits in (8, 16):
        a = jvert.comm_load(jagg.table1_config(method, jbase), bits)
        b = tvert.comm_load(tagg.table1_config(method, tbase), bits)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.uplink_bits == b.uplink_bits


@pytest.mark.parametrize("method", jagg.TABLE1_METHODS)
def test_method_forward_and_loss_match_jax(method):
    """Each method's training forward from the same parameters; the
    prediction-level methods also their per-worker predictions."""
    jbase, tbase = _pair()
    jc, tc = (jagg.table1_config(method, jbase),
              tagg.table1_config(method, tbase))
    params = jvert.init(jc, jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree.map(np.asarray, params))
    views, labels = _data(4, 32, 10)
    jl, jm = jvert.loss_fn(jc, params, jnp.asarray(views),
                           jnp.asarray(labels))
    tl, tm = tvert.loss_fn(tc, tparams, torch.from_numpy(views),
                           torch.from_numpy(labels))
    np.testing.assert_allclose(float(jl), float(tl), rtol=0, atol=ATOL)
    assert float(jm["acc"]) == float(tm["acc"])
    if jc.prediction_level:
        jp = jvert.per_worker_predictions(jc, params, jnp.asarray(views))
        tp = tvert.per_worker_predictions(tc, tparams,
                                          torch.from_numpy(views))
        assert tp.shape == (4, 6, 10)
        np.testing.assert_allclose(np.asarray(jp), tp.numpy(), rtol=0,
                                   atol=ATOL)
        # the baseline's pick: each worker's predicted classes
        assert np.array_equal(np.asarray(jp).argmax(-1),
                              tp.numpy().argmax(-1))
    else:
        with pytest.raises(ValueError, match="prediction_level"):
            tvert.per_worker_predictions(tc, tparams,
                                         torch.from_numpy(views))


@pytest.mark.parametrize("build", [
    "config", "cifar10_like", "cifar100_like", "reduced"])
def test_fedocs_cifar_configs_match_jax(build):
    j, t = getattr(jcifar, build)(), getattr(tcifar, build)()
    for f in dataclasses.fields(jvert.VerticalConfig):
        if f.name != "dtype":
            assert getattr(j, f.name) == getattr(t, f.name), f.name
    assert jcifar.ID == tcifar.ID


@pytest.mark.parametrize("build", ["config", "reduced"])
def test_fedocs_mnist_configs_match_jax(build):
    j, t = getattr(jmnist, build)(), getattr(tmnist, build)()
    for f in dataclasses.fields(jvert.VerticalConfig):
        if f.name != "dtype":
            assert getattr(j, f.name) == getattr(t, f.name), f.name
    assert (jmnist.ID, jmnist.N_WORKERS, jmnist.SIGMA, jmnist.IMAGE_HW) == (
        tmnist.ID, tmnist.N_WORKERS, tmnist.SIGMA, tmnist.IMAGE_HW)


def test_paper_configs_stay_out_of_the_model_registry():
    from repro_torch import configs
    assert "fedocs-cifar" not in configs.ARCH_IDS
    assert "fedocs-mnist" not in configs.ARCH_IDS
