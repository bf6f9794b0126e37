"""The port's placements over ``torch.distributed`` ranks
(``repro_torch.sim.shard``, ``n_devices`` of ``run_curves`` / ``run_sweep``
/ ``run_curves_dp``, ``CompressedAllReduce.reduce(group=)``,
``repro_torch.parallel.pipeline``) against the one-rank port and the JAX
package.

The rank runs are gloo process groups on the CPU: one world of 2 ranks
and one of 4, each started once (``repro_torch.parallel.comm.spawn``, a
``FileStore`` under ``tmp_path``, one intra-op thread a rank, a process
group timeout and a join deadline) and running every engine placement of
its size.  Each result is held bit for bit to the port's one-rank CPU run
in every field, on every rank (the ranks the placement leaves out
included), and to the JAX package's ``n_devices=1`` run to the standard of
the single-device tests (``tests/test_torch_curves.py``,
``test_torch_dp.py``, ``test_torch_sweep.py``): the JAX package's own
sharded paths do not run under its current JAX.  The pipeline runs 4 gloo
stages on ``tests/test_pipeline.py``'s data against JAX's
``sequential_reference`` and ``jax.grad`` of it, at those tests'
tolerances.

The JAX package is imported inside the fixtures and tests, so the rank
processes, which import this module to find their task, load no JAX.
"""

import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.convert import params_from_jax
from repro_torch.optim.compressed_allreduce import CompressedAllReduce
from repro_torch.parallel import comm
from repro_torch.parallel import pipeline as tpipe
from repro_torch.sim import scenarios as tscen
from repro_torch.sim import shard as tshard
from repro_torch.sim import sweep as tsweep
from repro_torch.sim import train_curves as ttc

torch.set_num_threads(1)

# tests/test_torch_curves.py's JTINY with 4 lanes, so 3 ranks pad
CURVES = dict(bits=(8, 16), p_miss=(0.0, 0.3, 0.05, (0.0, 0.1, 0.1, 0.3)),
              steps=8, batch=16, n_train=128, n_val=64, hw=8,
              encoder_dims=(8,), embed_dim=8, head_dims=(8,), log_every=4)
# tests/test_torch_dp.py's TINY_DP and WIDE_DP
TINY_DP = dict(bits=(8,), p_miss=(0.0, 0.3), steps=6, batch=16,
               n_train=128, n_val=64, hw=8, encoder_dims=(8,), embed_dim=8,
               head_dims=(8,), log_every=3, dp_shards=2)
WIDE_DP = dict(TINY_DP, bits=(16,), dp_shards=4,
               p_miss=(0.1, (0.0, 0.1, 0.1, 0.3)))
K_FRAC = 1 / 8
# tests/test_torch_sweep.py's SWEEP_KW
SWEEP_KW = dict(k_elems=24, rounds=3, seed=2, rng_seed=5)
# the single-device tests' standards
LOSS_ATOL = 1e-4
ACC_SAMPLES = 2
PARAM_ATOL = 1e-4
# rank processes: the process group's timeout; the join deadline is twice
RANK_TIMEOUT = 60.0

# (name, world, engine, config, n_devices); n_devices None is the world
CASES = [
    ("curves_2", 2, "curves", CURVES, 2),
    ("curves_3", 4, "curves", CURVES, 3),
    ("curves_all", 4, "curves", CURVES, None),
    ("sweep_2", 2, "sweep", None, 2),
    ("dp_2", 2, "dp", TINY_DP, 2),          # the DP axis on the ranks
    ("wide_2", 2, "dp", WIDE_DP, 2),        # DP in the tensor, lanes on 2
    ("dp_3", 4, "dp", TINY_DP, 3),          # a 1 x 2 mesh: ranks 2, 3 idle
    ("dp_4", 4, "dp", TINY_DP, 4),          # a 2 x 2 mesh
]
CASE_IDS = [c[0] for c in CASES]


def _mixed(m):
    """tests/test_torch_sweep.py's mixed grid, in the package ``m``'s
    types."""
    return [
        m.Scenario("mix/N2_b8", n_workers=2, bits=8),
        m.Scenario("mix/N4_b16_c4", n_workers=4, bits=16, p_miss=0.1,
                   n_channels=4),
        m.Scenario("mix/N16_b8_nf", n_workers=16, bits=8,
                   p_miss=m.near_far_p_miss(16, 0.0, 0.3)),
        m.Scenario("mix/N64_b16", n_workers=64, bits=16, p_miss=0.05),
        m.Scenario("mix/N16_b16_c4", n_workers=16, bits=16, p_miss=0.2,
                   n_channels=4),
        m.Scenario("mix/N64_b8_nf_c4", n_workers=64, bits=8,
                   p_miss=m.near_far_p_miss(64, 0.01, 0.1), n_channels=4),
        m.Scenario("mix/N4_b8", n_workers=4, bits=8, p_miss=0.3),
    ]


def _run(engine, cfg, n_devices, init):
    """One engine on the CPU at ``n_devices``; ``init`` the JAX package's
    initial parameters for the config."""
    if engine == "curves":
        return ttc.run_curves(ttc.CurveConfig(**cfg), device="cpu",
                              init_params=init, n_devices=n_devices)
    if engine == "dp":
        return ttc.run_curves_dp(
            ttc.CurveConfig(**cfg), CompressedAllReduce.topk(K_FRAC),
            device="cpu", init_params=init, n_devices=n_devices)
    return tsweep.run_sweep(_mixed(tscen), device="cpu", n_devices=n_devices,
                            **SWEEP_KW)


def _stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _stage_nob(p, x):
    return torch.tanh(x @ p["w"])


def _pipeline_data():
    """tests/test_pipeline.py's inputs, from its numpy seeds."""
    rng = np.random.default_rng(0)
    fwd = {"w": rng.standard_normal((4, 16, 16)) * 0.3,
           "b": rng.standard_normal((4, 16)) * 0.1}
    fwd_x = rng.standard_normal((6, 8, 16))
    rng = np.random.default_rng(1)
    grad = {"w": rng.standard_normal((4, 8, 8)) * 0.3}
    grad_x = rng.standard_normal((5, 4, 8))
    f32 = (lambda a: a.astype(np.float32))
    return (tree.map(f32, fwd), f32(fwd_x), tree.map(f32, grad), f32(grad_x))


def _pipeline_on_ranks() -> dict:
    """gpipe over the world's ranks: the forward, and the gradient of
    ``sum(y ** 2)`` (every rank's own stage slice)."""
    fwd, fwd_x, grad, grad_x = _pipeline_data()
    params = tree.map(torch.from_numpy, fwd)
    y = tpipe.gpipe(_stage)(params, torch.from_numpy(fwd_x))
    w = torch.from_numpy(grad["w"]).requires_grad_(True)
    out = tpipe.gpipe(_stage_nob)({"w": w}, torch.from_numpy(grad_x))
    (out ** 2).sum().backward()
    return {"y": y.detach().numpy(), "y_grad": out.detach().numpy(),
            "w_grad": w.grad.numpy()}


def _rank_task(world: int, inits: dict) -> dict:
    """Every case of this world size, then (4 ranks) the pipeline and an
    ``n_devices`` larger than the group."""
    out = {}
    for name, w, engine, cfg, n in CASES:
        if w == world:
            out[name] = _run(engine, cfg, n, inits.get(name))
    if world == 4:
        out["pipeline"] = _pipeline_on_ranks()
        try:
            ttc.run_curves(ttc.CurveConfig(**CURVES), device="cpu",
                           n_devices=5)
        except ValueError as e:
            out["too_many"] = str(e)
    return out


def _jax_init(cfg):
    import jax

    from repro.core import vertical as jvert
    from repro.sim import train_curves as jtc
    jcfg = jtc.CurveConfig(**cfg)
    params = jvert.init(jtc._vertical_config(jcfg, jcfg.bits[0], noisy=True),
                        jax.random.PRNGKey(jcfg.seed))
    return params_from_jax(jax.tree.map(np.asarray, params))


def _jax_run(engine, cfg):
    from repro.optim import compressed_allreduce as jca
    from repro.sim import scenarios as jscen
    from repro.sim import sweep as jsweep
    from repro.sim import train_curves as jtc
    if engine == "curves":
        return jtc.run_curves(jtc.CurveConfig(**cfg), n_devices=1)
    if engine == "dp":
        return jtc.run_curves_dp(jtc.CurveConfig(**cfg),
                                 jca.CompressedAllReduce.topk(K_FRAC),
                                 n_devices=1)
    return jsweep.run_sweep(_mixed(jscen), n_devices=1, **SWEEP_KW)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two rank worlds' results, the one-rank port runs and the JAX
    runs of every case.  The worlds run in their processes while this one
    runs the references."""
    by_cfg = {str(cfg): cfg for _, _, engine, cfg, _ in CASES
              if engine != "sweep"}
    made = {k: _jax_init(cfg) for k, cfg in by_cfg.items()}
    inits = {name: made[str(cfg)] for name, _, engine, cfg, _ in CASES
             if engine != "sweep"}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        worlds = {w: pool.submit(
            comm.spawn, _rank_task, w, (w, inits),
            workdir=tmp_path_factory.mktemp(f"world{w}"),
            timeout=RANK_TIMEOUT) for w in (2, 4)}
        one, ref, seen = {}, {}, {}
        for name, _, engine, cfg, _ in CASES:
            key = (engine, str(cfg))
            if key not in seen:
                seen[key] = (_run(engine, cfg, 1, inits.get(name)),
                             _jax_run(engine, cfg))
            one[name], ref[name] = seen[key]
        got = {w: f.result() for w, f in worlds.items()}
    return got, one, ref


def _case(name):
    return next(c for c in CASES if c[0] == name)


# ---------------------------------------------------------------------------
# the pure placement functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_devices,n_lanes,dp_shards", [
    (1, 4, 1), (2, 2, 2), (3, 2, 2), (4, 2, 2), (4, 2, 4), (2, 2, 4),
    (8, 3, 2), (8, 5, 1), (6, 1, 3), (5, 7, 2)])
def test_placement_functions_match_jax(n_devices, n_lanes, dp_shards):
    from repro.sim import shard as jshard
    assert tshard.lane_devices(n_devices, n_lanes) == \
        jshard.lane_devices(n_devices, n_lanes)
    assert tshard.dp_mesh_shape(n_devices, n_lanes, dp_shards) == \
        jshard.dp_mesh_shape(n_devices, n_lanes, dp_shards)
    x = np.arange(n_lanes * 6, dtype=np.float32).reshape(n_lanes, 2, 3)
    want = jshard.pad_lanes(x, n_devices)
    assert np.array_equal(tshard.pad_lanes(x, n_devices), want)
    assert np.array_equal(tshard.pad_lanes(torch.from_numpy(x),
                                           n_devices).numpy(), want)
    blocks = [tshard.block(want, n_devices, i) for i in range(n_devices)]
    assert np.array_equal(np.concatenate(blocks), want)


def test_n_devices_without_a_group():
    assert tshard.resolve_devices(None) == tshard.resolve_devices(1) == 1
    for bad in (2, 0):
        with pytest.raises(ValueError, match="no process group|>= 1"):
            tshard.resolve_devices(bad)
    cfg = ttc.CurveConfig(**CURVES)
    with pytest.raises(ValueError, match="no process group"):
        ttc.run_curves(cfg, device="cpu", n_devices=2)
    mesh = tshard.mesh_2d(1, 1)
    assert mesh.coord() == (0, 0) and mesh.owners() == [0]
    blk = {"a": torch.arange(6).reshape(3, 2)}
    assert torch.equal(tshard.gather_lanes(blk, 2, mesh, "cpu")["a"],
                       blk["a"][:2])


@pytest.mark.parametrize("lane_shape", [(5,), (2, 3)])
def test_global_norm_of_a_lane_is_its_own_run(lane_shape):
    """A lane's norm is bitwise the norm of that lane run alone, in a
    stack of any height: what keeps a rank's block of lanes training as
    the lanes of the whole stack do."""
    from repro_torch.optim.optimizers import global_norm
    gen = torch.Generator().manual_seed(0)
    grads = {"a": torch.randn(lane_shape + (64, 33), generator=gen),
             "b": [torch.randn(lane_shape + (7,), generator=gen)]}
    lanes = len(lane_shape)
    norms = global_norm(grads, lanes).reshape(-1)
    flat = tree.map(lambda x: x.reshape((-1,) + x.shape[lanes:]), grads)
    for i in range(norms.shape[0]):
        one = global_norm(tree.map(lambda x, i=i: x[i], flat))
        part = global_norm(tree.map(lambda x, i=i: x[i:i + 2], flat), 1)
        assert torch.equal(norms[i], one) and torch.equal(part[0], one)


# ---------------------------------------------------------------------------
# the engines over gloo ranks
# ---------------------------------------------------------------------------

def _raw(a):
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int32) if a.dtype == torch.float32 else a
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_bitwise(got, want, what) -> None:
    """Two results of one engine, every field bit for bit."""
    if dataclasses.is_dataclass(want) and not isinstance(want, type):
        assert type(got) is type(want), what
        for f in dataclasses.fields(want):
            _assert_bitwise(getattr(got, f.name), getattr(want, f.name),
                            f"{what}.{f.name}")
    elif isinstance(want, (dict, list, tuple)):
        if isinstance(want, dict):
            assert sorted(got) == sorted(want), what
            for k in want:
                _assert_bitwise(got[k], want[k], f"{what}[{k}]")
        else:
            assert len(got) == len(want), what
            for i, (a, b) in enumerate(zip(got, want)):
                _assert_bitwise(a, b, f"{what}[{i}]")
    elif isinstance(want, (torch.Tensor, np.ndarray)):
        g, w = _raw(got), _raw(want)
        assert g.dtype == w.dtype and g.shape == w.shape, what
        assert np.array_equal(g, w), what
    else:
        assert got == want, what


@pytest.mark.parametrize("name", CASE_IDS)
def test_ranks_equal_the_one_rank_run_bitwise(ranks, name):
    got, one, _ = ranks
    world = _case(name)[1]
    for r in range(world):
        _assert_bitwise(got[world][r][name], one[name], f"{name} rank {r}")


def _close_to_jax_curves(got, ref, cfg):
    for f in ("loss_history", "ideal_loss_history", "nll", "nll_ideal"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f), rtol=0,
                                   atol=LOSS_ATOL, err_msg=f)
    for f in ("acc", "acc_ideal"):
        diff = np.abs(getattr(ref, f) - getattr(got, f)) * cfg["n_val"]
        assert np.all(diff <= ACC_SAMPLES + 1e-9), (f, diff)
    import jax
    for bi in range(len(cfg["bits"])):
        for a, b in zip(jax.tree.leaves(ref.noisy_params[bi]),
                        tree.leaves(got.noisy_params[bi])):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=PARAM_ATOL)


def _close_to_jax_dp(got, ref, cfg):
    for f in ("dp_payload_bits_step", "dp_dense_bits_step"):
        assert getattr(got, f) == getattr(ref, f), f
    for f in ("dp_payload_bits", "dp_payload_bits_total"):
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f
    for f in ("loss_history", "nll"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f), rtol=0,
                                   atol=LOSS_ATOL, err_msg=f)
    diff = np.abs(got.acc - ref.acc) * cfg["n_val"]
    assert np.all(diff <= ACC_SAMPLES + 1e-9), diff
    import jax
    for a, b in zip(jax.tree.leaves(ref.params[0]),
                    tree.leaves(got.params[0])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=PARAM_ATOL)


def _same_as_jax_sweep(got, ref):
    for eng in ("clean", "noisy"):
        g, w = getattr(got, eng), getattr(ref, eng)
        for f in dataclasses.fields(g):
            a, b = np.asarray(getattr(g, f.name)), np.asarray(
                getattr(w, f.name))
            assert a.dtype == b.dtype and np.array_equal(
                _raw(a), _raw(b)), (eng, f.name)
        assert np.array_equal(getattr(got, eng + "_latency_slots"),
                              np.asarray(getattr(ref, eng + "_latency_slots")))


@pytest.mark.parametrize("name", CASE_IDS)
def test_ranks_match_jax_one_device(ranks, name):
    got, _, ref = ranks
    _, world, engine, cfg, _ = _case(name)
    res = got[world][0][name]
    if engine == "curves":
        _close_to_jax_curves(res, ref[name], cfg)
    elif engine == "dp":
        _close_to_jax_dp(res, ref[name], cfg)
    else:
        _same_as_jax_sweep(res, ref[name])


@pytest.mark.parametrize("name", [n for n in CASE_IDS if n.startswith(
    ("dp", "wide"))])
def test_dp_payload_on_ranks_is_the_bill(ranks, name):
    got, _, _ = ranks
    cfg, world = _case(name)[3], _case(name)[1]
    res = got[world][world - 1][name]
    assert np.all(res.dp_payload_bits == res.dp_payload_bits_step)
    assert np.all(res.dp_payload_bits_total
                  == res.dp_payload_bits_step * cfg["steps"])
    assert 0 < res.dp_payload_bits_step < res.dp_dense_bits_step


def test_too_many_devices_raises_on_ranks(ranks):
    got, _, _ = ranks
    for r in range(4):
        assert "the process group has 4 rank(s)" in got[4][r]["too_many"]


# ---------------------------------------------------------------------------
# the pipeline over 4 gloo stages
# ---------------------------------------------------------------------------

def _jax_pipeline_refs():
    import jax
    import jax.numpy as jnp

    from repro.parallel.pipeline import sequential_reference
    fwd, fwd_x, grad, grad_x = _pipeline_data()

    def stage(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])

    def stage_nob(p, x):
        return jnp.tanh(x @ p["w"])

    y = sequential_reference(stage, tree.map(jnp.asarray, fwd),
                             jnp.asarray(fwd_x))
    g = jax.grad(lambda p: jnp.sum(sequential_reference(
        stage_nob, p, jnp.asarray(grad_x)) ** 2))(tree.map(jnp.asarray,
                                                           grad))
    return np.asarray(y), np.asarray(g["w"])


def test_gpipe_matches_sequential_on_ranks(ranks):
    got, _, _ = ranks
    y_ref, _ = _jax_pipeline_refs()
    for r in range(4):
        err = np.max(np.abs(got[4][r]["pipeline"]["y"] - y_ref))
        assert err < 1e-5, (r, err)
    assert np.array_equal(got[4][0]["pipeline"]["y"],
                          got[4][3]["pipeline"]["y"])


def test_gpipe_gradients_match_jax_grad(ranks):
    got, _, _ = ranks
    _, g_ref = _jax_pipeline_refs()
    # each stage's rank holds the gradient of its own slice, zero elsewhere
    w_grad = sum(got[4][r]["pipeline"]["w_grad"] for r in range(4))
    for r in range(4):
        others = np.delete(got[4][r]["pipeline"]["w_grad"], r, axis=0)
        assert not others.any(), r
    err = np.max(np.abs(w_grad - g_ref))
    assert err < 1e-4, err


def test_sequential_reference_matches_jax():
    import jax.numpy as jnp

    from repro.parallel.pipeline import sequential_reference
    fwd, fwd_x, _, _ = _pipeline_data()
    want = sequential_reference(
        lambda p, x: jnp.tanh(x @ p["w"] + p["b"]),
        tree.map(jnp.asarray, fwd), jnp.asarray(fwd_x))
    got = tpipe.sequential_reference(_stage, tree.map(torch.from_numpy, fwd),
                                     torch.from_numpy(fwd_x))
    assert np.max(np.abs(got.numpy() - np.asarray(want))) < 1e-5
