"""The port's main path as a whole against the JAX package's.

``repro_torch.sim.train_curves.run_curves(device="cpu")`` from the JAX
package's initial parameters against ``repro.sim.train_curves.run_curves``
on the small ``TINY`` grid of ``tests/test_train_curves.py`` at bits 8 and
16.  The batch indices and the sensing keys match bit for bit.  The logged
losses and the accuracies match within the tolerances below, because the
float sums of the matmuls run in another order in XLA than in PyTorch
(a last-bit difference per op, compounding over the steps), and such a
difference may move an embedding across a D-bit bucket edge, which flips
that element's winner and moves the trajectory by more.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import vertical as jvert
from repro.data import vertical_data as jdata
from repro.sim import results as jresults
from repro.sim import train_curves as jtc
from repro_torch import tree
from repro_torch.convert import params_from_jax
from repro_torch.data import vertical_data as tdata
from repro_torch.sim import results as tresults
from repro_torch.sim import train_curves as ttc

torch.set_num_threads(1)

JTINY = jtc.CurveConfig(bits=(8, 16), p_miss=(0.0, 0.3), steps=8, batch=16,
                        n_train=128, n_val=64, hw=8, encoder_dims=(8,),
                        embed_dim=8, head_dims=(8,), log_every=4)
# measured difference on this grid: 5e-7 (float32 sums in another order)
LOSS_ATOL = 1e-4
# validation samples (of n_val = 64) whose prediction may differ
ACC_SAMPLES = 2


def _port_config(jcfg):
    return ttc.CurveConfig(**{f.name: getattr(jcfg, f.name)
                              for f in dataclasses.fields(ttc.CurveConfig)})


def _jax_init(jcfg):
    params = jvert.init(jtc._vertical_config(jcfg, jcfg.bits[0], noisy=True),
                        jax.random.PRNGKey(jcfg.seed))
    return params_from_jax(jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def tiny_runs():
    ref = jtc.run_curves(JTINY, n_devices=1)
    got = ttc.run_curves(_port_config(JTINY), device="cpu",
                         init_params=_jax_init(JTINY))
    return ref, got


def test_batch_and_sensing_streams_match_bitwise():
    tcfg = _port_config(JTINY)
    for bits in JTINY.bits:
        kd_j, lanes_j = jtc._stream_keys(JTINY, bits)
        kd_t, lanes_t = ttc._stream_keys(tcfg, bits)
        assert np.array_equal(np.asarray(kd_j), kd_t.numpy())
        assert np.array_equal(np.asarray(lanes_j), lanes_t.numpy())
        for step in range(JTINY.steps + 1):     # steps == the eval key
            idx_j = jtc._batch_indices(kd_j, step, JTINY.batch,
                                       JTINY.n_train)
            idx_t = ttc._batch_indices(kd_t, step, tcfg.batch, tcfg.n_train)
            assert np.array_equal(np.asarray(idx_j), idx_t.numpy())
            assert np.array_equal(np.asarray(jtc._fold_lanes(lanes_j, step)),
                                  ttc._fold_lanes(lanes_t, step).numpy())


def test_losses_and_accuracy_table_match_jax(tiny_runs):
    ref, got = tiny_runs
    assert np.array_equal(ref.logged_steps, got.logged_steps)
    assert np.array_equal(ref.p_miss, got.p_miss)
    for f in ("loss_history", "ideal_loss_history", "nll", "nll_ideal"):
        np.testing.assert_allclose(getattr(ref, f), getattr(got, f),
                                   rtol=0, atol=LOSS_ATOL, err_msg=f)
    for f in ("acc", "acc_ideal"):
        diff = np.abs(getattr(ref, f) - getattr(got, f)) * JTINY.n_val
        assert np.all(diff <= ACC_SAMPLES + 1e-9), (f, diff)


def test_trained_params_close_to_jax(tiny_runs):
    ref, got = tiny_runs
    for bi in range(len(JTINY.bits)):
        for a, b in zip(jax.tree.leaves(ref.noisy_params[bi]),
                        tree.leaves(got.noisy_params[bi])):
            np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-4)


def test_zero_miss_lane_trains_as_the_ideal_run(tiny_runs):
    """In the port the p_miss=0 lane and the ideal run share one lane
    stack, and the two pooling laws agree bit for bit at p_miss=0, so the
    trained parameters, losses and accuracies agree bit for bit."""
    _, got = tiny_runs
    assert got.p_miss[0] == 0.0
    for bi in range(len(JTINY.bits)):
        for a, b in zip(tree.leaves(got.noisy_params[bi]),
                        tree.leaves(got.ideal_params[bi])):
            assert torch.equal(a[0], b[0])
        assert got.acc[bi, 0] == got.acc_ideal[bi]
        assert np.array_equal(got.loss_history[bi, :, 0],
                              got.ideal_loss_history[bi])
    # and the noisy lane did see a different channel
    assert not np.array_equal(got.loss_history[0, :, 0],
                              got.loss_history[0, :, 1])


def test_curve_records_and_rows_match_jax(tiny_runs):
    ref, got = tiny_runs
    rec_j = jresults.summarize_curves(ref)
    rec_t = tresults.summarize_curves(got)
    assert len(rec_j) == len(rec_t)
    exact = ("curve", "bits", "p_miss", "n_workers", "k_elems", "steps",
             "uplink_bits_fedocs", "uplink_bits_concat", "uplink_ratio")
    for a, b in zip(rec_j, rec_t):
        assert set(a) == set(b)
        for k in exact:
            assert a[k] == b[k], k
    # rows from the same records are the same rows
    assert jresults.curve_rows(rec_t) == tresults.curve_rows(rec_t)


def _check_run_matches_jax(jcfg):
    ref = jtc.run_curves(jcfg, n_devices=1)
    got = ttc.run_curves(_port_config(jcfg), device="cpu",
                         init_params=_jax_init(jcfg))
    for f in ("loss_history", "ideal_loss_history", "nll", "nll_ideal"):
        np.testing.assert_allclose(getattr(ref, f), getattr(got, f),
                                   rtol=0, atol=LOSS_ATOL, err_msg=f)
    for f in ("acc", "acc_ideal"):
        diff = np.abs(getattr(ref, f) - getattr(got, f)) * jcfg.n_val
        assert np.all(diff <= ACC_SAMPLES + 1e-9), (f, diff)
    for bi in range(len(jcfg.bits)):
        for a, b in zip(jax.tree.leaves(ref.noisy_params[bi]),
                        tree.leaves(got.noisy_params[bi])):
            np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-4)


def test_heterogeneous_lanes_match_jax():
    """Scalar and per-worker (near/far) p_miss lanes mixed in one grid."""
    _check_run_matches_jax(dataclasses.replace(
        JTINY, bits=(8,), steps=4, log_every=2,
        p_miss=(0.0, (0.0, 0.1, 0.1, 0.3), 0.3)))


def test_deep_encoders_and_head_match_jax():
    """Two encoder layers and three head layers, as the main path has."""
    _check_run_matches_jax(dataclasses.replace(
        JTINY, bits=(8,), encoder_dims=(16, 8), head_dims=(16, 16, 16)))


def test_fedocs_cifar_width_matches_jax():
    """The main path's widths (configs/fedocs_cifar.cifar10_like: 2x2
    patches of 32x32, encoders (256, 128), K=64, head (512, 512, 512), 10
    classes) for a few steps of a small batch."""
    _check_run_matches_jax(jtc.CurveConfig(
        grid=2, hw=32, n_classes=10, encoder_dims=(256, 128), embed_dim=64,
        head_dims=(512, 512, 512), bits=(8,), p_miss=(0.0, 0.05), steps=4,
        batch=16, n_train=128, n_val=64, log_every=2))


def test_own_init_runs_and_is_deterministic():
    """Without init_params the port draws its own (torch.Generator) init;
    the whole run is a pure function of the config."""
    cfg = dataclasses.replace(_port_config(JTINY), bits=(16,), steps=3,
                              log_every=1)
    a = ttc.run_curves(cfg, device="cpu")
    b = ttc.run_curves(cfg, device="cpu")
    assert np.array_equal(a.loss_history, b.loss_history)
    assert np.array_equal(a.acc, b.acc)
    assert np.all(np.isfinite(a.loss_history))


def _raw_bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32 if x.element_size() == 4
                               else torch.int16)


@pytest.mark.parametrize("width", ["tiny", "deep"])
def test_stack_pool_trains_as_the_two_law_composition(monkeypatch, width):
    """A few CPU ``run_curves`` steps with the stack pool (noisy lanes and
    the ideal lane pooled as one stack, one winner-routed backward) train
    to parameters bit for bit equal (raw bit views) to a run through the
    composition it replaced, kept here as the reference: ``aggregate`` of
    the noisy lanes, ``ideal_max(bits, "first").aggregate`` of the last
    lane and ``torch.cat``.  The two gradients of h differ only in the
    sign of the zeros off the winners (the stack keeps the laws' ``g *
    onehot``, the composition's slice sum makes them +0.0), which moves no
    parameter."""
    from repro_torch.core import fedocs
    from repro_torch.protocol import Protocol

    cfg = dataclasses.replace(_port_config(JTINY), p_miss=(0.0, 0.05, 0.3),
                              steps=6, log_every=1)
    if width == "deep":
        cfg = dataclasses.replace(cfg, bits=(8,), encoder_dims=(16, 8),
                                  head_dims=(16, 16, 16))
    calls = []
    stack_pool = fedocs.stack_pool

    def counted(*args):
        calls.append(1)
        return stack_pool(*args)

    monkeypatch.setattr(fedocs, "stack_pool", counted)
    got = ttc.run_curves(cfg, device="cpu")
    # a training step and the evaluation per bits value
    assert len(calls) == (cfg.steps + 1) * len(cfg.bits)

    def two_laws(self, h, rng):
        lanes = h.shape[0] - 1
        v_n, acct = self.aggregate(h[:lanes], rng, lanes=True)
        v_i, _ = Protocol.ideal_max(self.bits, tie_break="first").aggregate(
            h[lanes:], lanes=True)
        return torch.cat([v_n, v_i]), acct

    monkeypatch.setattr(Protocol, "aggregate_with_ideal", two_laws)
    want = ttc.run_curves(cfg, device="cpu")
    assert len(calls) == (cfg.steps + 1) * len(cfg.bits)
    for bi in range(len(cfg.bits)):
        for params in ("noisy_params", "ideal_params"):
            for a, b in zip(tree.leaves(getattr(got, params)[bi]),
                            tree.leaves(getattr(want, params)[bi])):
                assert torch.equal(_raw_bits(a), _raw_bits(b)), params
    for f in ("loss_history", "ideal_loss_history", "acc", "nll",
              "acc_ideal", "nll_ideal"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


def test_default_device_is_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttc.run_curves(_port_config(JTINY))


def test_data_is_byte_identical():
    task = jdata.PatchTaskConfig(n_classes=10, grid=2, hw=32)
    ttask = tdata.PatchTaskConfig(n_classes=10, grid=2, hw=32)
    for a, b in zip(jdata.patch_classification(task, 64, seed=3),
                    tdata.patch_classification(ttask, 64, seed=3)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for a, b in zip(jdata.multiview_denoising(8, seed=1),
                    tdata.multiview_denoising(8, seed=1)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_port_imports_no_jax_and_nothing_of_repro():
    """Importing every module of repro_torch, and chip_smoke, leaves no
    jax* and no repro / repro.* module loaded."""
    root = pathlib.Path(__file__).resolve().parents[1]
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro') or n.startswith('jax'))\n"
        "print('LOADED', len([n for n in sys.modules "
        "if n.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, "-c", code, str(root)],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split("LOADED")[1]) >= 20


if __name__ == "__main__":
    # Both packages at the main path's full configuration (the CurveConfig
    # chip_smoke.py runs) from the JAX package's initial parameters, on
    # the CPU; prints both accuracy tables, the largest loss gap and the
    # first step whose loss differs by more than LOSS_ATOL.
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_curves.py
    full = jtc.CurveConfig(grid=2, hw=32, n_classes=10,
                           encoder_dims=(256, 128), embed_dim=64,
                           head_dims=(512, 512, 512), bits=(8, 16),
                           p_miss=(0.0, 0.02, 0.05, 0.1), log_every=1)
    ref = jtc.run_curves(full, n_devices=1)
    got = ttc.run_curves(_port_config(full), device="cpu",
                         init_params=_jax_init(full))
    for name, res, mod in (("jax", ref, jresults), ("port", got, tresults)):
        print(name)
        for row in mod.curve_rows(mod.summarize_curves(res)):
            print(row)
    print("max |loss gap|", float(np.max(np.abs(ref.loss_history
                                                - got.loss_history))))
    print("max |acc gap| in samples", float(np.max(np.abs(
        ref.acc - got.acc)) * full.n_val))
    gap = np.abs(ref.loss_history - got.loss_history)    # (bits, steps, L)
    for bi, bits in enumerate(full.bits):
        over = np.nonzero(gap[bi].max(-1) > LOSS_ATOL)[0]
        print(f"bits={bits}: largest gap before", over[:1],
              float(gap[bi, :over[0]].max() if len(over) else gap[bi].max()))
