"""Worker-axis tensor parallelism of the dense LM stack over
``torch.distributed`` ranks (``repro_torch.parallel.sharding``,
``repro_torch.launch.mesh``, ``m.axes()``, the fusions over the model
group, the vocabulary-parallel loss, elastic restore) against the JAX
package and the port's one-rank runs.

The pure functions are held to the JAX package's on the cases of
``tests/test_sharding.py`` and on (2, 4) and (1, 2) meshes (a duck-typed
mesh, since the JAX process has one device).  The rank runs are gloo
process groups on the CPU, one spawn a mesh shape ((2, 2), (2, 1) and
(1, 2); a ``FileStore`` under ``tmp_path``, one intra-op thread a rank,
a process-group timeout and a join deadline), each running every check of
its shape; the parent runs the one-rank and JAX references meanwhile.
The fusions over 2 ranks are held bitwise to the one-rank law on the
whole stack, forward and input gradient, across ties between ranks, a
+-0 tie and a NaN on one rank.  Reduced glm4-9b on the three meshes is
held to the JAX package's one-device loss within 1e-4 and its gradients
within 1e-3 (``tests/test_distributed.py``'s tolerances), and so are a
"plain"-layout config and a tied-embedding one.

The JAX package is imported inside the fixtures and tests, so the rank
processes, which import this module to find their task, load no JAX.
"""

import concurrent.futures
import json
import os
import shutil
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.checkpoint import checkpointer as ck
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.convert import params_from_jax
from repro_torch.launch import mesh as tmesh
from repro_torch.models import fusion
from repro_torch.models import model as M
from repro_torch.optim import optimizers
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as sh
from repro_torch.protocol import Protocol
from repro_torch.serve import engine as se
from repro_torch.serve.load import poisson_requests
from repro_torch.train import trainer
from repro_torch.train.train_step import value_and_grad

torch.set_num_threads(1)

RANK_TIMEOUT = 60.0
# tests/test_distributed.py's tolerances
LOSS_ATOL, GRAD_ATOL = 1e-4, 1e-3
BATCH, SEQ = 4, 16
# the fusion cases: (mode, tie_break), at N 4 and 8 workers over 2 ranks
FUSIONS = [("max", "all"), ("max", "first"), ("max_q8", "all"),
           ("max_q8", "first"), ("max_q16", "all"), ("max_q16", "first"),
           ("concat", "all"), ("sum", "all")]
SITE = (2, 3, 8)                 # (B, S, K) of a fusion site
# the LM cases: (name, arch, overrides)
LM_CASES = [("glm4", "glm4-9b", {}),
            ("plain", "qwen2.5-32b", {}),
            ("tied", "qwen1.5-0.5b", {})]
MESHES = [(2, 2), (1, 2), (2, 1)]
TRAIN_STEPS = 3


def _lm_cfg(arch, **kw):
    return get_reduced(arch, n_workers=4, tp_fusion="max", **kw)


def _batch_np():
    rng = np.random.default_rng(0)
    tok = rng.integers(0, 256, (BATCH, SEQ)).astype(np.int32)
    return {"tokens": tok, "targets": tok}


def _torch_batch():
    return {k: torch.from_numpy(v) for k, v in _batch_np().items()}


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's raw words, NaNs of any payload as one word."""
    t = t.detach()
    word = {2: torch.int16, 4: torch.int32}[t.element_size()]
    raw = t.contiguous().view(word).numpy().copy()
    raw[torch.isnan(t.float()).numpy()] = -1
    return raw


def _same_bits(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        _bits(a), _bits(b))


# ---------------------------------------------------------------------------
# the fusion inputs: partials with ties across ranks, a +-0 tie and a NaN
# ---------------------------------------------------------------------------

def _partials(n: int, dtype, seed: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    h = torch.randn((n,) + SITE, generator=gen)
    half = n // 2
    flat = h.view(n, -1)
    flat[half, 0:6] = flat[0, 0:6]                 # ties across the ranks
    flat[half + 1, 6:9] = flat[1, 6:9]
    flat[:, 9] = -1.0                              # +-0 across the ranks
    flat[0, 9], flat[half, 9] = -0.0, 0.0
    flat[:, 10] = -2.0
    flat[1, 10], flat[n - 1, 10] = 0.0, -0.0
    flat[n - 1, 11] = float("nan")                 # a NaN on rank 1
    flat[half, 12] = float("nan")
    flat[half + 1, 12] = float("nan")
    h = h.to(dtype)
    # coarse values tie within and across ranks after the cast too
    h.view(n, -1)[:, 13:17] = torch.round(h.view(n, -1)[:, 13:17])
    return h


def _cotangent(dtype, seed: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed + 100)
    return torch.randn(SITE, generator=gen).to(dtype)


def _fusion_case(mode, tie, n, dtype):
    cfg = get_reduced("glm4-9b", n_workers=n, tp_fusion=mode,
                      tie_break=tie)
    p = {}
    if mode == "concat":
        gen = torch.Generator().manual_seed(7)
        p = {"w_fuse": (torch.randn((n * SITE[2], SITE[2]), generator=gen)
                        * 0.1).to(dtype)}
    return cfg, p


def _fuse(mode, tie, n, dtype, h):
    """(pooled, the gradient of ``sum(pooled * g)`` w.r.t. ``h``)."""
    cfg, p = _fusion_case(mode, tie, n, dtype)
    h = h.detach().requires_grad_(True)
    out = fusion.worker_reduce(cfg, p, h)
    (grad,) = torch.autograd.grad(out, h, _cotangent(dtype, n))
    return out.detach(), grad


def _fusion_on_ranks(mesh) -> dict:
    axis = sh.mesh_axis(mesh, "model")
    out = {}
    for mode, tie in FUSIONS:
        for n in (4, 8):
            for dtype in (torch.float32, torch.bfloat16):
                h = _partials(n, dtype, n)
                mine = sh.split_dim(h, axis)
                with sh.use_mesh(mesh), comm.recording() as rec:
                    pooled, grad = _fuse(mode, tie, n, dtype, mine)
                out[(mode, tie, n, str(dtype))] = (pooled, grad, list(rec))
    return out


# ---------------------------------------------------------------------------
# the LM on a mesh
# ---------------------------------------------------------------------------

def _values(inits, name, arch, kw):
    cfg = _lm_cfg(arch, **kw)
    return cfg, M.build(cfg), tree.map(torch.from_numpy, inits[name])


def _lm_on_ranks(mesh, rules, inits) -> dict:
    """Each LM case's loss and gathered gradient on this mesh."""
    out = {}
    for name, arch, kw in LM_CASES:
        cfg, m, whole = _values(inits, name, arch, kw)
        axes = m.axes()
        mine = sh.shard_values(whole, axes, mesh, rules)
        shd = sh.tree_shardings_for_values(axes, whole, mesh, rules)
        with sh.use_mesh(mesh, rules):
            loss, _, grads = value_and_grad(m.loss, mine, _torch_batch())
            out[name] = (loss, sh.gather_values(grads, shd))
    return out


def _adamw():
    return optimizers.adamw(lambda s: torch.tensor(1e-2) + 0 * s,
                            max_grad_norm=0.5)


def _data(step):
    gen = torch.Generator().manual_seed(step)
    tok = torch.randint(0, 256, (BATCH, SEQ), generator=gen,
                        dtype=torch.int32)
    return {"tokens": tok, "targets": torch.roll(tok, -1, 1)}


def _train(m, values, shardings, ckpt_dir, steps=TRAIN_STEPS):
    tcfg = trainer.TrainerConfig(steps=steps, ckpt_dir=ckpt_dir,
                                 ckpt_every=2, log_every=1)
    return trainer.train(m.loss, values, _adamw(), _data, tcfg,
                         shardings=shardings)


def _train_on_ranks(mesh, rules, inits, ckpt_dir) -> dict:
    """3 trainer steps with a checkpoint at step 2, then the job preempted
    after that checkpoint and relaunched on the same mesh."""
    cfg, m, whole = _values(inits, "glm4", "glm4-9b", {})
    axes = m.axes()
    mine = sh.shard_values(whole, axes, mesh, rules)
    shd = sh.tree_shardings_for_values(axes, whole, mesh, rules)
    with sh.use_mesh(mesh, rules):
        full = _train(m, mine, shd, ckpt_dir)
        dist.barrier()
        if comm.rank() == 0:
            # the job preempted after its step-2 checkpoint
            shutil.rmtree(os.path.join(ckpt_dir, f"step_{3:010d}"))
            with open(os.path.join(ckpt_dir, "latest"), "w") as f:
                f.write("2")
        dist.barrier()
        resumed = _train(m, mine, shd, ckpt_dir)
        gathered = sh.gather_values(full.values, shd)
    if comm.rank() == 0:
        open(os.path.join(ckpt_dir, "DONE"), "w").close()
    return dict(full=full, resumed=resumed, gathered=gathered)


def _restore_on_ranks(mesh, rules, inits, ckpt_dir, jax_dir) -> dict:
    """The (2, 2) run's final checkpoint and a JAX checkpoint, restored on
    this mesh and gathered."""
    cfg, m, whole = _values(inits, "glm4", "glm4-9b", {})
    axes = m.axes()
    shd = sh.tree_shardings_for_values(axes, whole, mesh, rules)
    _wait_for(os.path.join(ckpt_dir, "DONE"))
    port = ck.restore(ckpt_dir, template={"values": whole, "opt": None},
                      shardings={"values": shd})[0]["values"]
    jax = ck.restore(jax_dir, template=whole, shardings=shd)[0]
    return {name: (tree.map(lambda t: tuple(t.shape), got),
                   sh.gather_values(got, shd))
            for name, got in (("port", port), ("jax", jax))}


def _serve(values, m, greedy, ocs):
    reqs = poisson_requests(6, 0.5, m.cfg.vocab_size, prompt_len=8,
                            max_new_tokens=6, seed=0)
    proto = Protocol.ocs(bits=8, p_miss=0.1) if ocs else None
    eng = se.ServeEngine(m, values, se.ServeConfig(
        batch_slots=4, max_seq=32, eos_id=-1, protocol=proto,
        greedy=greedy), device="cpu")
    return {k: (c.tokens, c.channel_slots, c.uplink_bits)
            for k, c in eng.run(reqs).items()}


SERVE_CASES = [(g, o) for g in (True, False) for o in (False, True)]


def _serve_model():
    cfg = _lm_cfg("qwen1.5-0.5b", tie_embeddings=False)
    m = M.build(cfg)
    return m, m.init(torch.Generator().manual_seed(0))


def _serve_on_ranks(mesh) -> dict:
    m, whole = _serve_model()
    mine = sh.shard_values(whole, m.axes(), mesh)
    with sh.use_mesh(mesh):
        return {c: _serve(mine, m, *c) for c in SERVE_CASES}


def _refusals(mesh) -> dict:
    """What a model axis still refuses: experts that it does not
    divide."""
    cfg = get_reduced("qwen3-moe-30b-a3b", n_experts=3)
    m = M.build(cfg)
    with sh.use_mesh(mesh):
        try:
            m.loss(m.init(torch.Generator().manual_seed(0)), _torch_batch())
        except ValueError as e:
            return {"experts": str(e)}
    return {"experts": None}


def _rank_task(shape, inits, ckpt_dir, jax_dir) -> dict:
    mesh = tmesh.make_mesh(*shape)
    rules = tmesh.rules_for("train_4k", BATCH, mesh)
    out = {"coord": mesh.coord(), "lm": _lm_on_ranks(mesh, rules, inits)}
    if shape == (2, 2):
        out["train"] = _train_on_ranks(mesh, rules, inits, ckpt_dir)
    if shape == (2, 1):
        out["serve"] = _serve_on_ranks(mesh)
    if shape == (1, 2):
        out["fusion"] = _fusion_on_ranks(mesh)
        out["restore"] = _restore_on_ranks(mesh, rules, inits, ckpt_dir,
                                           jax_dir)
        out["serve"] = _serve_on_ranks(mesh)
        out["refused"] = _refusals(mesh)
        try:
            tmesh.make_mesh(2, 2)
        except ValueError as e:
            out["bad_mesh"] = str(e)
    return out


# ---------------------------------------------------------------------------
# the references and the spawns
# ---------------------------------------------------------------------------

def _inits() -> dict:
    """Each LM case's parameters, from the port's seed-0 init, as numpy."""
    out = {}
    for name, arch, kw in LM_CASES:
        m = M.build(_lm_cfg(arch, **kw))
        out[name] = tree.map(lambda t: t.numpy(),
                             m.init(torch.Generator().manual_seed(0)))
    return out


def _jax_lm(arch, kw, values):
    """(the JAX package's loss, its gradients as a port tree) of a case at
    the numpy ``values`` (the JAX package's tree, leaf for leaf)."""
    import jax

    from repro.configs import get_reduced as jget
    from repro.models import model as JM
    jm = JM.build(jget(arch, n_workers=4, tp_fusion="max", **kw))
    batch = {k: jax.numpy.asarray(v) for k, v in _batch_np().items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda v: jm.loss(v, batch)[0]))(tree.map(jax.numpy.asarray, values))
    return float(loss), params_from_jax(jax.tree.map(np.asarray, grads))


def _wait_for(path: str) -> None:
    """Until ``path`` exists, within the ranks' timeout."""
    import time
    limit = time.monotonic() + RANK_TIMEOUT
    while not os.path.exists(path):
        if time.monotonic() > limit:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.2)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every mesh's rank results and the references they are held to.  The
    three meshes run at once while this process runs the references; the
    (1, 2) ranks restore the (2, 2) run's checkpoint once it is done."""
    from repro.checkpoint import checkpointer as jck
    inits = _inits()
    ckpt_dir = str(tmp_path_factory.mktemp("ckpt"))
    jax_dir = str(tmp_path_factory.mktemp("jax_ckpt"))
    # the JAX package's own checkpoint of glm4's values, with their axes
    jck.save(jax_dir, 1, inits["glm4"],
             axes_tree=M.build(_lm_cfg("glm4-9b")).axes())
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        spawned = {s: pool.submit(
            comm.spawn, _rank_task, s[0] * s[1],
            (s, inits, ckpt_dir, jax_dir),
            workdir=tmp_path_factory.mktemp(f"mesh{s[0]}x{s[1]}"),
            timeout=RANK_TIMEOUT) for s in MESHES}
        ref = {name: _jax_lm(arch, kw, inits[name])
               for name, arch, kw in LM_CASES}
        one = {}
        for name, arch, kw in LM_CASES:
            cfg, m, whole = _values(inits, name, arch, kw)
            loss, _, grads = value_and_grad(m.loss, whole, _torch_batch())
            one[name] = (loss, grads)
        m = M.build(_lm_cfg("glm4-9b"))
        one_train = _train(m, tree.map(torch.from_numpy, inits["glm4"]),
                           None, None)
        sm, sv = _serve_model()
        one_serve = {c: _serve(sv, sm, *c) for c in SERVE_CASES}
        got = {s: f.result() for s, f in spawned.items()}
    return dict(got=got, ref=ref, one=one, one_train=one_train,
                one_serve=one_serve, inits=inits, ckpt_dir=ckpt_dir)


# ---------------------------------------------------------------------------
# the pure functions against the JAX package's
# ---------------------------------------------------------------------------

def _duck(data, model):
    """A mesh of the JAX package's kind by its axis names and shape."""
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((data, model)))


@pytest.fixture
def jsh(monkeypatch):
    """The JAX package's sharding module, its ``NamedSharding`` standing
    for the spec alone (a real one needs the mesh's devices)."""
    from repro.parallel import sharding as jsh
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)
    return jsh


AXES_CASES = [(("batch", "seq", "embed"), (8, 16, 64)),
              (("vocab", "embed"), (122753, 64)),
              (("vocab", "embed"), (151936, 1024)),
              (("embed", "heads", None), (64, 5, 12)),
              (("worker", None, None, "embed"), (16, 1, 64, 1024)),
              (("layers", "experts", "embed", "ff_local"), (2, 6, 64, 32)),
              (("kv_seq", "heads"), (3, 8)),
              ((None,), (7,)), ((), ())]


@pytest.mark.parametrize("shape", [(1, 1), (2, 4), (1, 2), (4, 1)])
def test_resolve_and_divisibility_match_jax(jsh, shape):
    mesh = _duck(*shape)
    assert sh.mesh_axis_sizes(mesh) == jsh.mesh_axis_sizes(mesh)
    for rules_of in ("default", "train_4k", "long_500k"):
        rules = (sh.DEFAULT_RULES if rules_of == "default"
                 else tmesh.rules_for(rules_of, 8, mesh))
        for axes, dims in AXES_CASES:
            assert sh.resolve_axes(axes, mesh, rules) == tuple(
                jsh.resolve_axes(axes, mesh, rules)), (axes, rules_of)
            assert sh.sharding_for_shape(axes, dims, mesh, rules).spec == \
                tuple(jsh.sharding_for_shape(axes, dims, mesh, rules)), \
                (axes, dims, rules_of)


@pytest.mark.parametrize("shape", [(1, 1), (2, 4), (1, 2)])
@pytest.mark.parametrize("batch", [1, 4, 256])
def test_rules_for_matches_jax(shape, batch):
    from repro.launch import mesh as jmesh
    mesh = _duck(*shape)
    for name in ("train_4k", "long_500k", "decode_32k"):
        assert tmesh.rules_for(name, batch, mesh) == \
            jmesh.rules_for(name, batch, mesh)


def test_zero_axes_match_jax(jsh):
    cases = [(("worker", None, None), (16, 100, 64), 4),
             ((None, None), (7, 13), 4), (("embed",), (64,), 1),
             (("embed", "fsdp"), (64, 8), 4),
             (("vocab", "embed"), (256, 64), 2)]
    for axes, shape, fsdp in cases:
        for names in ((), ("data", "model")):
            assert sh.zero_axes(axes, shape, fsdp, names) == \
                jsh.zero_axes(axes, shape, fsdp, names)
    assert sh.zero_axes(("worker", None, None), (16, 100, 64), 4) == \
        ("worker", "fsdp", None)


def _jax_axes(arch, full):
    import jax

    from repro.configs import get_config as jgc
    from repro.configs import get_reduced as jgr
    from repro.models import model as JM
    from repro.parallel import sharding as jsh
    jm = JM.build((jgc if full else jgr)(arch))
    tagged = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    return jsh.split_tree(tagged)


@pytest.mark.parametrize("arch,full", [(a, False) for a in ARCH_IDS]
                         + [("qwen1.5-0.5b", True), ("qwen2.5-32b", True)])
def test_axes_match_jax(jsh, arch, full):
    values, axes = _jax_axes(arch, full)
    cfg = (get_config if full else get_reduced)(arch)
    got = M.build(cfg).axes()
    assert got == axes
    for shape in ((2, 4), (1, 2)):
        mesh = _duck(*shape)
        specs = sh.tree_shardings_for_values(got, values, mesh)
        want = jsh.tree_shardings_for_values(axes, values, mesh)
        assert sh.map_axes(lambda a, s, w: s.spec == tuple(w), got, specs,
                           want) == sh.map_axes(lambda a: True, got)
        assert sh.zero_axes_tree(got, values, mesh) == \
            jsh.zero_axes_tree(axes, values, mesh)


def test_meshes_and_blocks_without_a_group():
    mesh = tmesh.make_debug_mesh(1, 1)
    assert mesh.coord() == (0, 0) and mesh.shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="no process group"):
        tmesh.make_mesh(1, 2)
    x = torch.arange(24.0).reshape(4, 6)
    assert sh.block(x, ("model", None), mesh).data_ptr() == x.data_ptr()
    cfg = _lm_cfg("glm4-9b")
    m = M.build(cfg)
    v = m.init(torch.Generator().manual_seed(0))
    with sh.use_mesh(mesh):
        a = m.loss(v, _torch_batch())[0]
    assert torch.equal(a, m.loss(v, _torch_batch())[0])


# ---------------------------------------------------------------------------
# the fusions over 2 ranks, worker by worker
# ---------------------------------------------------------------------------

def _close_sum(got, want, h):
    """The sum over ranks against the one-rank sum: the same NaNs, and
    within 4 roundings of the summands' magnitudes in their type (the
    ranks' partial sums round once more before the reduction)."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    eps = torch.finfo(h.dtype).eps
    bound = 4 * eps * h.float().abs().nansum(0)
    err = (got.float() - want.float()).abs()
    assert bool((err[~nan] <= bound[~nan]).all()), float(err[~nan].max())


@pytest.mark.parametrize("mode,tie", FUSIONS)
def test_fusion_over_ranks_is_the_one_rank_law(ranks, mode, tie):
    got = ranks["got"][(1, 2)]
    for n in (4, 8):
        for dtype in (torch.float32, torch.bfloat16):
            h = _partials(n, dtype, n)
            want_out, want_grad = _fuse(mode, tie, n, dtype, h)
            key = (mode, tie, n, str(dtype))
            grads = torch.cat([got[r]["fusion"][key][1] for r in (0, 1)])
            for r in (0, 1):
                out = got[r]["fusion"][key][0]
                if mode == "sum":
                    _close_sum(out, want_out, h)
                else:
                    assert _same_bits(out, want_out), (key, r)
            if mode == "sum":
                torch.testing.assert_close(grads, want_grad, equal_nan=True)
            else:
                assert _same_bits(grads, want_grad), key


@pytest.mark.parametrize("tie", ["all", "first"])
def test_quantized_site_moves_its_codes(ranks, tie):
    """A max_q8 site's max-reduction moves B*S*K uint8 codes at N 4 and 8
    (and ``"first"`` as many uint8 owner indices); max moves one order key
    an element."""
    got = ranks["got"][(1, 2)][0]["fusion"]
    elems = int(np.prod(SITE))
    for n in (4, 8):
        rec = got[("max_q8", tie, n, "torch.float32")][2]
        ops = sorted((e["op"], e["dtype"], e["bytes"]) for e in rec)
        want = [("all_reduce.max", "uint8", elems)]
        if tie == "first":
            want.append(("all_reduce.min", "uint8", elems))
        assert ops == sorted(want), ops
        rec = got[("max", tie, n, "torch.bfloat16")][2]
        assert ("all_reduce.max", "int32", 4 * elems) in [
            (e["op"], e["dtype"], e["bytes"]) for e in rec]


# ---------------------------------------------------------------------------
# the LM on three meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", [c[0] for c in LM_CASES])
def test_lm_loss_and_grads_match_jax_and_one_rank(ranks, shape, case):
    jloss, jgrads = ranks["ref"][case]
    oloss, ograds = ranks["one"][case]
    assert abs(float(oloss) - jloss) < LOSS_ATOL
    for r, out in enumerate(ranks["got"][shape]):
        loss, grads = out["lm"][case]
        assert abs(float(loss) - jloss) < LOSS_ATOL, (shape, r)
        assert abs(float(loss) - float(oloss)) < LOSS_ATOL, (shape, r)
        for g, j, o in zip(tree.leaves(grads), tree.leaves(jgrads),
                           tree.leaves(ograds)):
            assert g.shape == o.shape
            assert float((g - j).abs().max()) < GRAD_ATOL, (shape, r)
            assert float((g - o).abs().max()) < GRAD_ATOL, (shape, r)
        # every rank holds the same whole loss and gradients
        first = ranks["got"][shape][0]["lm"][case]
        assert torch.equal(loss, first[0])
        assert all(torch.equal(a, b) for a, b in zip(
            tree.leaves(grads), tree.leaves(first[1])))


@pytest.mark.parametrize("shape", MESHES)
def test_ranks_sit_row_major(ranks, shape):
    coords = [out["coord"] for out in ranks["got"][shape]]
    assert coords == [(r // shape[1], r % shape[1])
                      for r in range(shape[0] * shape[1])]


# ---------------------------------------------------------------------------
# serving, the trainer, elastic restore, refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
@pytest.mark.parametrize("greedy,ocs", SERVE_CASES)
def test_serving_under_a_mesh_is_the_one_rank_engine(ranks, greedy, ocs,
                                                     shape):
    want = ranks["one_serve"][(greedy, ocs)]
    assert len({tuple(c[0]) for c in want.values()}) > 1
    for r, out in enumerate(ranks["got"][shape]):
        assert out["serve"][(greedy, ocs)] == want, r


def _same_tree(a, b) -> bool:
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def test_trainer_resume_on_a_mesh_is_bitwise(ranks):
    for r, out in enumerate(ranks["got"][(2, 2)]):
        full, resumed = out["train"]["full"], out["train"]["resumed"]
        assert _same_tree(full.values, resumed.values), r
        assert _same_tree(full.opt_state, resumed.opt_state), r
        rows = [{k: v for k, v in h.items() if k != "step_time_s"}
                for h in full.history if h["step"] >= 2]
        assert rows == [{k: v for k, v in h.items() if k != "step_time_s"}
                        for h in resumed.history], r
        assert resumed.history[0]["step"] == 2


def test_trainer_on_a_mesh_tracks_the_one_rank_trainer(ranks):
    one = ranks["one_train"]
    for out in ranks["got"][(2, 2)]:
        full = out["train"]["full"]
        for a, b in zip(full.history, one.history):
            assert abs(a["loss"] - b["loss"]) < LOSS_ATOL
            assert abs(a["grad_norm"] - b["grad_norm"]) < GRAD_ATOL
        for g, o in zip(tree.leaves(out["train"]["gathered"]),
                        tree.leaves(one.values)):
            assert float((g - o).abs().max()) < GRAD_ATOL


def test_checkpoint_restores_on_other_meshes(ranks):
    """The (2, 2) run's final checkpoint: restored on (1, 2), on one rank,
    and by the (2, 2) ranks themselves, bitwise the gathered values; a
    JAX checkpoint with axes restored on (1, 2)."""
    gathered = ranks["got"][(2, 2)][0]["train"]["gathered"]
    m = M.build(_lm_cfg("glm4-9b"))
    whole = tree.map(torch.from_numpy, ranks["inits"]["glm4"])
    one = ck.restore(ranks["ckpt_dir"], template={"values": whole,
                                                  "opt": None})[0]
    assert _same_tree(one["values"], gathered)
    mesh = _duck(1, 2)
    for r, out in enumerate(ranks["got"][(1, 2)]):
        shapes, values = out["restore"]["port"]
        assert _same_tree(values, gathered), r
        specs = sh.tree_shardings_for_values(m.axes(), whole, mesh)
        want = sh.map_axes(lambda a, s, v: tuple(
            d // 2 if "model" == e else d for d, e in zip(v.shape, s.spec)),
            m.axes(), specs, whole)
        assert shapes == want
        _, jvals = out["restore"]["jax"]
        assert _same_tree(jvals, whole), r


def test_checkpoint_index_holds_each_leafs_axes(tmp_path):
    """The index names each leaf's logical axes under the leaf's key (the
    JAX package's index spells every name out as a list of characters
    under ``<leaf>/#<dim>``: ROADMAP queue 3)."""
    m = M.build(_lm_cfg("glm4-9b"))
    v = m.init(torch.Generator().manual_seed(0))
    ck.save(str(tmp_path), 1, v, axes_tree=m.axes())
    with open(tmp_path / f"step_{1:010d}" / "index.json") as f:
        index = json.load(f)
    _, axes = _jax_axes("glm4-9b", False)
    flat = ck._flatten_with_paths(axes, is_leaf=sh.is_axes)
    assert sorted(index["axes"]) == index["keys"] == sorted(flat)
    assert all(index["axes"][k] == list(a) for k, a in flat.items())


def test_what_a_mesh_still_refuses(ranks):
    """Every arch runs under a model axis (``tests/test_torch_tp_models.py``);
    a mesh of the wrong size and experts that the model axis does not
    divide are refused."""
    for out in ranks["got"][(1, 2)]:
        assert "needs 4 ranks" in out["bad_mesh"]
        assert out["refused"]["experts"] == "3 experts over a 2-way model axis"


def test_global_norm_needs_the_leaf_shardings():
    mesh = types.SimpleNamespace(
        axis_names=("data", "model"), devices=np.empty((1, 2)),
        axis_index=lambda name: 0, group=lambda name: None)
    with sh.use_mesh(mesh), pytest.raises(ValueError, match="shardings"):
        optimizers.global_norm({"a": torch.ones(3)})
