"""The port's examples (``repro_torch.examples``) on the CPU.

``quickstart`` runs 3 steps from the JAX example's initial parameters
(``convert.params_from_jax``) against the JAX example's own step; the
other six run at a tiny size (``--steps``/``--rounds``/``--train-steps``
shortened, ``--device cpu``; ``train_curves``' fixed data and widths cut
to the analysis registry's tiny curve sizes) and print their JAX
counterparts' lines.
"""

import numpy as np
import pytest
import torch

from repro_torch.convert import params_from_jax


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_matches_the_jax_example(capsys):
    """Three steps of ``examples/quickstart.py``'s jitted step from its own
    initial parameters, against the port's example from the same values:
    each step's loss within 1e-5 relative (float32 matmuls reduce in other
    orders), and the printed step-0 line."""
    import jax
    import jax.numpy as jnp
    from repro.core import vertical as jvert
    from repro.core.vertical import VerticalConfig as JVC
    from repro.data.vertical_data import multiview_denoising
    from repro.optim import optimizers as jopt
    from repro.optim import schedules as jsched
    from repro.protocol import Protocol as JP
    from repro_torch.examples import quickstart

    steps = 3
    views, clean = multiview_denoising(512, n_workers=4, hw=16, sigma=2.0)
    cfg = JVC(n_workers=4, input_dim=256, encoder_dims=(128,), embed_dim=32,
              head_dims=(128,), output_dim=256, task="reconstruction",
              aggregation=JP.max())
    params = jvert.init(cfg, jax.random.PRNGKey(0))
    init = params_from_jax(jax.tree.map(np.asarray, params))
    opt = jopt.adamw(jsched.constant(2e-3))
    state = opt.init(params)
    views_j, clean_j = jnp.asarray(views), jnp.asarray(clean)

    @jax.jit
    def step(params, state, vb, cb):
        loss, g = jax.value_and_grad(
            lambda p: jvert.loss_fn(cfg, p, vb, cb)[0])(params)
        params, state, _ = opt.update(g, state, params)
        return params, state, loss

    rng = np.random.default_rng(0)
    want = []
    for _ in range(steps):
        idx = rng.integers(0, 512, 64)
        params, state, loss = step(params, state, views_j[:, idx],
                                   clean_j[idx])
        want.append(float(loss))

    got = quickstart.main(["--steps", str(steps), "--device", "cpu"],
                          init_params=init)
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("step    0  mse ")
    np.testing.assert_allclose(float(out[0].split()[-1]), want[0],
                               atol=1e-4)
    assert out[-2:] == ["uplink: 32 msgs/sample (concat would need 128)",
                        "done."]


_RUNS = {
    "patch_classification": (["--steps", "2", "--method", "all"],
                             "table1/fedocs/mean,0,acc="),
    "reconstruction": (["--steps", "2"], "fusion gain: NLL"),
    "train_curves": (["--steps", "2"], "# CollisionAdaptiveBits(8, 16): "),
    "scenario_sweep": (["--rounds", "1"], "# 32 cells, core calls: "
                                          "clean=2 noisy=7"),
    "lm_train": (["--steps", "2"], "final nll: "),
    "serve_demo": (["--train-steps", "2", "--requests", "2",
                    "--max-new", "3"],
                   "request 1 under p_miss=0.1: latency="),
}


# train_curves' CurveConfig at the tiny sizes of the analysis registry's
# curve entries: its bits and p_miss lanes stay, the data and widths shrink
_TINY_CURVES = dict(batch=4, max_rounds=2, n_train=32, n_val=16, hw=8,
                    encoder_dims=(8,), embed_dim=4, head_dims=(8,))


@pytest.mark.parametrize("name", sorted(_RUNS))
def test_example_runs_on_the_cpu(name, capsys, tmp_path, monkeypatch):
    import importlib
    from repro_torch.sim import train_curves as tc
    if name == "train_curves":
        full = tc.CurveConfig
        monkeypatch.setattr(tc, "CurveConfig",
                            lambda **kw: full(**dict(kw, **_TINY_CURVES)))
    argv, line = _RUNS[name]
    argv = argv + ["--device", "cpu"]
    if name == "lm_train":
        argv += ["--ckpt-dir", str(tmp_path / "ckpt")]
    if name in ("train_curves", "scenario_sweep"):
        argv = [str(tmp_path / "out.json")] + argv
    importlib.import_module(f"repro_torch.examples.{name}").main(argv)
    out = capsys.readouterr().out
    assert any(x.startswith(line) for x in out.splitlines()), out[-2000:]
    if name in ("train_curves", "scenario_sweep"):
        assert (tmp_path / "out.json").exists()
