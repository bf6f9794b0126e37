"""The dry-run (``repro_torch.launch.{dryrun, hlo_analysis, hillclimb}``),
the production meshes' ``pod`` axis and ZeRO/FSDP in the train step,
against the JAX package and the port's own unsplit runs.

The pure parts (the four shapes and their rule, ``cache_axes``,
``input_specs``, ``_model_flops``, ``_scaled_variants``, the ZeRO axes,
each rank's parameter bytes and the FSDP decision on both production
meshes, ``EXPERIMENTS``) are held to the JAX functions for all ten archs
(a duck-typed mesh, as in ``tests/test_torch_tp.py``).  The traces run on
fake CPU tensors over a fake process group (``dryrun.fake_world``).  Two
gloo worlds are spawned at once, a (pod 2, data 2, model 1) mesh and a
(1 x 2) one, while the parent traces the same cells on fake tensors:
the pod-combined batch split against one rank within the data-axis
tolerances of ``tests/test_torch_tp.py``, the ZeRO and FSDP steps bitwise
the unsplit step, and every world's collectives equal, op for op, to the
fake trace of its cell.

The JAX package is imported inside the fixtures and tests, so the rank
processes, which import this module to find their task, load no JAX.
"""

import concurrent.futures
import dataclasses
import math
import os
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.configs import (ARCH_IDS, SHAPES, get_config, get_reduced,
                                 shape_applicable)
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, hillclimb, hlo_analysis
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.optim import optimizers, schedules
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as sh
from repro_torch.train.train_step import make_train_step, value_and_grad

torch.set_num_threads(1)

RANK_TIMEOUT = 60.0
# tests/test_torch_tp.py's data-axis tolerances (tests/test_distributed.py's)
LOSS_ATOL, GRAD_ATOL = 1e-4, 1e-3
# the reduced cells: (train, prefill, decode) shapes
CELL_SHAPES = [ShapeConfig("t", "train", 16, 8),
               ShapeConfig("p", "prefill", 32, 4),
               ShapeConfig("d", "decode", 32, 8)]
TRAIN = CELL_SHAPES[0]
STEPS = 2


@pytest.fixture(autouse=True)
def no_group_left():
    """No default process group is left initialised by a test (the sweep
    and ``sim/shard.resolve_devices`` read the default group)."""
    yield
    assert not dist.is_initialized()


def _cfg(arch="glm4-9b", **kw):
    return get_reduced(arch, n_workers=4, tp_fusion="max", **kw)


def _jax_dryrun():
    """The JAX package's ``launch.dryrun`` and ``launch.hillclimb``,
    imported with ``XLA_FLAGS`` as it was (each module adds 512 host
    devices to it for the JAX process's first backend)."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdry
        from repro.launch import hillclimb as jhill
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return jdry, jhill


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


# ---------------------------------------------------------------------------
# shapes, specs and the pure functions against the JAX package's
# ---------------------------------------------------------------------------

def test_shapes_match_jax():
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget
    from repro.configs import shape_applicable as japplicable
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    for arch in ARCH_IDS:
        for name in SHAPES:
            assert shape_applicable(get_config(arch), SHAPES[name]) == \
                japplicable(jget(arch), JSHAPES[name]), (arch, name)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_axes_and_input_specs_match_jax(arch):
    import jax

    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget
    from repro.models import model as JM
    m, jm = M.build(get_config(arch)), JM.build(jget(arch))
    assert m.cache_axes() == jm.cache_axes()
    for name in SHAPES:
        specs, axes = m.input_specs(SHAPES[name])
        jspecs, jaxes = jm.input_specs(JSHAPES[name])
        assert axes == jaxes, (arch, name)
        got, want = tree.leaves(specs), jax.tree.leaves(jspecs)
        assert list(specs) == list(jspecs) and len(got) == len(want)
        for g, w in zip(got, want):
            assert g.device.type == "meta"
            assert tuple(g.shape) == tuple(w.shape), (arch, name)
            assert _dtype_name(g.dtype) == str(np.dtype(w.dtype))


def test_model_flops_and_scaled_variants_match_jax():
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget
    jdry, _ = _jax_dryrun()
    assert dryrun.TRAIN_MICROBATCHES == jdry.TRAIN_MICROBATCHES
    assert dryrun.FSDP_PARAM_BYTES == jdry.FSDP_PARAM_BYTES
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jget(arch)
        for name in SHAPES:
            assert dryrun._model_flops(cfg, SHAPES[name]) == \
                jdry._model_flops(jcfg, JSHAPES[name]), (arch, name)
            assert dryrun._prefill_len(cfg, SHAPES[name]) == \
                jdry._prefill_len(jcfg, JSHAPES[name])
        for mb in sorted({1, dryrun.TRAIN_MICROBATCHES.get(arch, 1), 4}):
            assert dryrun._scaled_variants(cfg, mb) == \
                jdry._scaled_variants(jcfg, mb), (arch, mb)


def test_experiments_match_jax():
    _, jhill = _jax_dryrun()
    assert hillclimb.EXPERIMENTS == jhill.EXPERIMENTS


def _duck(multi_pod: bool):
    """A production mesh of the JAX package's kind by its axis names and
    shape."""
    if multi_pod:
        return types.SimpleNamespace(axis_names=("pod", "data", "model"),
                                     devices=np.empty((2, 16, 16)))
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((16, 16)))


@pytest.fixture(scope="module")
def full_trees():
    """Every arch's full-size parameter shapes and axes from the JAX
    package (``jax.eval_shape``: nothing allocated)."""
    import jax

    from repro.configs import get_config as jget
    from repro.models import model as JM
    from repro.parallel import sharding as jsh
    out = {}
    for arch in ARCH_IDS:
        jm = JM.build(jget(arch))
        out[arch] = jsh.split_tree(jax.eval_shape(jm.init,
                                                  jax.random.PRNGKey(0)))
    return out


def _bytes_from_specs(values, specs, mesh) -> int:
    """A rank's bytes of ``values`` under the per-leaf JAX specs."""
    sizes = sh.mesh_axis_sizes(mesh)
    total = 0
    for v, spec in zip(values, specs):
        dims = [d // math.prod(sizes[n] for n in
                               ((e,) if isinstance(e, str) else e or ()))
                for d, e in zip(v.shape, spec)]
        total += math.prod(dims) * np.dtype(v.dtype).itemsize
    return total


@pytest.mark.parametrize("multi_pod", [False, True])
def test_zero_and_fsdp_placement_match_jax(full_trees, monkeypatch,
                                           multi_pod):
    import jax

    from repro.parallel import sharding as jsh
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)
    mesh = _duck(multi_pod)
    rules = tmesh.rules_for("train_4k", 256, mesh)
    split = set()
    for arch in ARCH_IDS:
        jvalues, jaxes = full_trees[arch]
        axes = M.build(get_config(arch)).axes()
        zaxes = sh.zero_axes_tree(axes, jvalues, mesh, rules)
        assert zaxes == jsh.zero_axes_tree(jaxes, jvalues, mesh, rules)
        leaves = jax.tree.leaves(jvalues)
        for ax_tree in (axes, zaxes):
            shd = sh.tree_shardings_for_values(ax_tree, jvalues, mesh, rules)
            want = tree.leaves(sh.map_axes(
                lambda a, w: types.SimpleNamespace(spec=tuple(w)), ax_tree,
                jsh.tree_shardings_for_values(ax_tree, jvalues, mesh,
                                              rules)))
            got = sh.flat_shardings(shd)
            assert [s.spec for s in got] == [w.spec for w in want]
            assert dryrun._block_bytes(jvalues, shd) == \
                _bytes_from_specs(leaves, [s.spec for s in got], mesh)
        tp = sh.tree_shardings_for_values(axes, jvalues, mesh, rules)
        if dryrun._block_bytes(jvalues, tp) > dryrun.FSDP_PARAM_BYTES:
            split.add(arch)
    # the JAX dry-run's FSDP cells (TP alone leaves more than 8 GiB a
    # rank; qwen2.5-32b's 40 heads stay whole over 16)
    assert split == {"jamba-1.5-large-398b", "llama4-scout-17b-a16e",
                     "qwen2.5-32b"}


def test_production_meshes_over_a_fake_world():
    for multi_pod, shape, names in (
            (False, (16, 16), ("data", "model")),
            (True, (2, 16, 16), ("pod", "data", "model"))):
        with dryrun.fake_world(math.prod(shape)):
            mesh = tmesh.make_production_mesh(multi_pod=multi_pod)
            assert mesh.devices.shape == shape and mesh.axis_names == names
            assert mesh.coord() == (0,) * len(shape)
            rules = tmesh.rules_for("train_4k", 256, mesh)
            with sh.use_mesh(mesh, rules):
                batch, fsdp = sh.logical_axis("batch"), sh.fsdp_axis()
            assert batch.size == fsdp.size == math.prod(shape[:-1])
            assert batch.name == (names[:-1] if multi_pod else "data")
    with dryrun.fake_world(512, rank=511):
        mesh = tmesh.make_production_mesh(multi_pod=True)
        assert mesh.coord() == (1, 15, 15)
        with sh.use_mesh(mesh):
            assert sh.logical_axis("batch").index == 31


def test_roofline_terms_and_collective_stats():
    t = hlo_analysis.roofline_terms(989e12, 3.35e12, 0.0)  # 1 s and 1 s
    assert t["t_compute_s"] == pytest.approx(1.0)
    assert t["t_memory_s"] == pytest.approx(1.0)
    assert t["t_collective_s"] == 0.0
    t2 = hlo_analysis.roofline_terms(1e12, 1e9, 450e9)
    assert t2["t_collective_s"] == pytest.approx(1.0)
    assert t2["bottleneck"] == "collective"
    recs = [{"op": "all_reduce.sum", "dtype": "bfloat16", "bytes": 1000,
             "group": 4},
            {"op": "all_reduce.max", "dtype": "int32", "bytes": 400,
             "group": 2},
            {"op": "all_gather", "dtype": "uint8", "bytes": 100,
             "group": 16},
            {"op": "all_to_all", "dtype": "float32", "bytes": 800,
             "group": 4}]
    st = hlo_analysis.collective_stats(recs)
    assert st.counts == {"all-reduce": 2, "all-gather": 1, "all-to-all": 1}
    # an all-gather's result is the group's inputs
    assert st.payload_bytes == {"all-reduce": 1400, "all-gather": 1600,
                                "all-to-all": 800}
    assert st.link_bytes == pytest.approx(
        2 * 1000 * 3 / 4 + 2 * 400 / 2 + 1600 * 15 / 16 + 800 * 3 / 4)
    with pytest.raises(ValueError, match="unknown collective"):
        hlo_analysis.collective_stats([{"op": "send", "bytes": 1,
                                        "group": 2}])


def test_the_moe_count_is_bincounts():
    """``moe._aux`` counts the experts with a scatter of ones: the counts
    and the aux loss are bitwise those of ``torch.bincount``."""
    cfg = _cfg("qwen3-moe-30b-a3b")
    gen = torch.Generator().manual_seed(3)
    for b, s in ((2, 8), (1, 33)):
        probs = torch.softmax(torch.randn(b, s, cfg.n_experts,
                                          generator=gen), -1)
        e_flat = torch.randint(0, cfg.n_experts,
                               (b, s, cfg.experts_per_token), generator=gen)
        counts = torch.bincount(e_flat.reshape(-1), minlength=cfg.n_experts)
        want = cfg.n_experts * torch.sum(
            counts.float() * (1.0 / e_flat.numel())
            * torch.mean(probs, dim=(0, 1)))
        assert torch.equal(moe._aux(cfg, probs, e_flat), want)
        got = torch.zeros(cfg.n_experts, dtype=torch.int64).scatter_add_(
            0, e_flat.reshape(-1), torch.ones_like(e_flat.reshape(-1)))
        assert torch.equal(got, counts)


# ---------------------------------------------------------------------------
# traces on fake tensors
# ---------------------------------------------------------------------------

def _trace(cfg, shape, data=2, model=4, pod=None, rank=0, microbatches=1):
    size = data * model * (pod or 1)
    with dryrun.fake_world(size, rank=rank):
        mesh = tmesh.make_mesh(data, model, pod=pod)
        rules = tmesh.rules_for(shape.name, shape.global_batch, mesh)
        return dryrun.trace(dryrun.build_step, cfg, shape, mesh, rules,
                            microbatches, "cpu")


@pytest.mark.parametrize("arch", ["glm4-9b", "qwen3-moe-30b-a3b",
                                  "xlstm-125m", "whisper-base"])
def test_reduced_cells_trace_every_step_kind(arch):
    """The port of ``test_reduced_cells_lower_and_compile_all_step_kinds``:
    every step kind of a reduced config on a fake (2 x 4) mesh traces,
    with its FLOPs, bytes, collectives and memory counted."""
    cfg = _cfg(arch, use_flash=arch != "xlstm-125m")
    for shape in CELL_SHAPES:
        if arch == "xlstm-125m":
            # its time loops are Python's: a quarter of the length
            shape = dataclasses.replace(shape, seq_len=shape.seq_len // 4)
        got = _trace(cfg, shape)
        assert got["flops"] > 0 and got["hbm_bytes"] > 0, shape.kind
        assert got["coll"].counts.get("all-reduce", 0) > 0, shape.kind
        assert got["coll"].link_bytes > 0
        peak = got["peak"]["cpu"]["Total"]
        assert peak >= got["argument_bytes"] > 0
        assert got["argument_bytes_by_device"]["cpu"] == \
            got["argument_bytes"]
        if shape.kind == "train":
            # the data-axis gradient sum: an all-to-all and an all-gather
            assert any(r["op"] == "all_to_all" and r["group"] == 2
                       for r in got["records"])


def test_byte_counter_counts_what_ops_move():
    """Every op's inputs and outputs once; nothing for views, metadata
    reads (a fake tensor's ``.device`` is an op) and allocations; an
    in-place scatter its indices, values and the rows it writes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        x = torch.zeros(1000, 64)
        idx = torch.zeros(4, dtype=torch.long)
        v = torch.zeros(4, 64)
        with dryrun.ByteCounter() as free:
            assert x.device.type == "cpu"
            x.t().unsqueeze(0)
            x.view(-1)
            torch.empty(10)
        with dryrun.ByteCounter() as add:
            x + x
        with dryrun.ByteCounter() as put:
            x.index_put_((idx,), v)
    assert free.bytes == 0
    assert add.bytes == 2 * 1000 * 64 * 4
    assert put.bytes == 4 * 8 + 2 * 4 * 64 * 4


def test_flash_counts_the_tiles_it_visits():
    from repro_torch.kernels.flash_attention import ops as fops
    assert fops.flops(1, 1, 64, 64, 16, True) == 4 * 16 * 64 * 64
    assert fops.flops(2, 3, 128, 128, 64, False) == 4 * 2 * 3 * 64 * 128 ** 2
    # causal: the second query tile visits both key tiles, the first one
    assert fops.flops(1, 1, 128, 128, 16, True) == 4 * 16 * 64 * (64 + 128)
    cfg = _cfg(use_flash=True)
    on, off = (_trace(cfg.with_(use_flash=f), CELL_SHAPES[1])["flops"]
               for f in (True, False))
    # the kernel skips the tiles above the diagonal that the plain
    # version multiplies: S 32 is one tile, so the two agree
    assert on == off


def test_two_point_extrapolation():
    """The two-point rule on the port's exact counts: exact for FLOPs at
    any microbatches, for link bytes at one (the port sums the gradients
    over the data group once a microbatch)."""
    cfg = _cfg(n_layers=3)
    b, c = (_trace(cfg.with_(n_layers=n), TRAIN) for n in (1, 2))
    for mb in (1, 2):
        full = _trace(cfg, TRAIN, microbatches=mb)
        assert b["flops"] + 2 * (c["flops"] - b["flops"]) == full["flops"]
        two_point = b["coll"].link_bytes + 2 * (c["coll"].link_bytes
                                                - b["coll"].link_bytes)
        if mb == 1:
            assert two_point == pytest.approx(full["coll"].link_bytes)
        else:
            assert full["coll"].link_bytes > two_point


def test_rank_zero_stands_for_the_last_rank():
    """An uneven head split (5 heads over 4) stays replicated: rank 0's
    trace and the last rank's count the same."""
    cfg = _cfg("qwen2.5-32b")
    assert cfg.n_heads % 4
    for shape in CELL_SHAPES:
        first, last = (_trace(cfg, shape, rank=r) for r in (0, 7))
        for key in ("flops", "hbm_bytes", "argument_bytes"):
            assert first[key] == last[key], (shape.kind, key)
        assert comm.summarize(first["records"]) == \
            comm.summarize(last["records"])


def _jax_cache_bytes(arch, shape_name, multi_pod) -> int:
    """A rank's bytes of a decode cell's cache by the JAX dry-run's
    placement: the JAX ``input_specs`` cache of the cell's config under
    ``sharding_for_shape`` of the JAX ``CACHE_AXES`` (and the recurrent
    states' axes) with the JAX ``rules_for``."""
    import jax

    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget
    from repro.launch import mesh as jmesh
    from repro.models import model as JM
    from repro.parallel import sharding as jsh
    mesh = _duck(multi_pod)
    shape = JSHAPES[shape_name]
    specs, axes = JM.build(jget(arch, n_workers=16, tp_fusion="max")) \
        .input_specs(shape)
    rules = jmesh.rules_for(shape_name, shape.global_batch, mesh)
    leaves = jax.tree.leaves(specs["cache"])
    jspecs = jax.tree.leaves(
        jax.tree.map(lambda a, v: tuple(jsh.sharding_for_shape(
            a, v.shape, mesh, rules).spec), axes["cache"], specs["cache"],
            is_leaf=sh.is_axes), is_leaf=lambda x: isinstance(x, tuple))
    return _bytes_from_specs(leaves, jspecs, mesh)


# (arch, shape, multi_pod, the ways that split the attention caches)
CACHE_CELLS = [("jamba-1.5-large-398b", "long_500k", False, 16),
               ("jamba-1.5-large-398b", "long_500k", True, 32),
               ("qwen1.5-0.5b", "decode_32k", False, 16)]


def test_long_context_cells_refuse_a_split_cache(monkeypatch):
    """Named for the refusal it held until the port's decode read a split
    cache.  Now both jamba ``long_500k`` cells give ``ok`` records, a
    rank's cache holding its ``kv_seq`` block (16 and 32 ways) and a
    ``decode_32k`` cell's its rows (16 ways): a rank's cache argument
    bytes equal the JAX placement's arithmetic on the JAX ``CACHE_AXES``,
    and each attention cache's are the whole one's over the ways.  glm4's
    ``long_500k`` stays skipped."""
    from repro.parallel import sharding as jsh
    monkeypatch.setattr(jsh, "NamedSharding",
                        lambda mesh, spec: types.SimpleNamespace(spec=spec))
    import multiprocessing
    with concurrent.futures.ProcessPoolExecutor(
            len(CACHE_CELLS),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        recs = list(pool.map(_cache_cell, CACHE_CELLS))
    for (arch, shape_name, multi_pod, ways), rec in zip(CACHE_CELLS, recs):
        assert rec["status"] == "ok", rec.get("error")
        assert rec["split_kv_seq"] == (shape_name == "long_500k")
        got = rec["memory"]["cache_bytes"]
        assert got == _jax_cache_bytes(arch, shape_name, multi_pod), arch
        cfg = get_config(arch, n_workers=16)
        shape = SHAPES[shape_name]
        whole = M.cache_init(cfg, shape.global_batch, shape.seq_len,
                             device="meta")
        attn = [t for t in tree.leaves(whole) if t.ndim == 5
                and t.shape[-2:] == (cfg.n_kv_heads, cfg.head_dim_)]
        rest = [t for t in tree.leaves(whole) if all(t is not a
                                                      for a in attn)]
        attn_bytes = sum(t.numel() * t.element_size() for t in attn)
        assert attn_bytes % ways == 0
        assert got >= attn_bytes // ways
        assert got - attn_bytes // ways <= sum(
            t.numel() * t.element_size() for t in rest)
    rec = dryrun.run_cell("glm4-9b", "long_500k", True, device="cpu")
    assert rec["status"] == "skipped" and "sub-quadratic" in rec["reason"]


def _cache_cell(cell) -> dict:
    arch, shape_name, multi_pod, _ = cell
    torch.set_num_threads(1)
    return dryrun.run_cell(arch, shape_name, multi_pod, device="cpu",
                           extrapolate=False)


def test_the_dry_run_refuses_a_live_group(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already initialised"):
            with dryrun.fake_world(2):
                pass
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# gloo worlds: the pod axis, ZeRO and FSDP, and the records
# ---------------------------------------------------------------------------

def _batch(cfg, rows, seq, seed=0):
    gen = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, cfg.vocab_size, (rows, seq + 1), generator=gen,
                        dtype=torch.int64).to(torch.int32)
    return {"tokens": tok[:, :-1].contiguous(),
            "targets": tok[:, 1:].contiguous()}


def _whole(cfg):
    return M.build(cfg).init(torch.Generator().manual_seed(0))


def _steps(cfg, mesh, rules, variant):
    """``STEPS`` AdamW steps of ``variant`` ("plain": every rank holds
    the whole state; "zero"; "fsdp") on this rank's placement: the step-1
    collectives and the gathered parameters, master, m and v after."""
    m = M.build(cfg)
    opt = optimizers.adamw(schedules.constant(1e-2))
    whole = _whole(cfg)
    if variant == "plain":
        axes = m.axes()
        shd = sh.tree_shardings_for_values(axes, whole, mesh, rules)
        placed = {"values": sh.shard_values(whole, axes, mesh, rules),
                  "leaf_shardings": sh.flat_shardings(shd),
                  "state": opt.init(sh.shard_values(whole, axes, mesh,
                                                    rules)),
                  "state_shardings": sh.flat_shardings(shd)}
    else:
        saved = dryrun.FSDP_PARAM_BYTES
        dryrun.FSDP_PARAM_BYTES = 0 if variant == "fsdp" else saved
        try:
            placed = dryrun.place(m, whole, mesh, rules, opt)
        finally:
            dryrun.FSDP_PARAM_BYTES = saved
        assert placed["fsdp"] == (variant == "fsdp")
    values, state = placed["values"], placed["state"]
    leaf_sh, state_sh = placed["leaf_shardings"], placed["state_shardings"]
    step = make_train_step(m.loss, opt)
    records = None
    with sh.use_mesh(mesh, rules), sh.use_leaf_shardings(leaf_sh,
                                                         state=state_sh):
        for i in range(STEPS):
            with comm.recording() as rec:
                values, state, _ = step(values, state,
                                        _batch(cfg, TRAIN.global_batch,
                                               TRAIN.seq_len, seed=i))
            records = records if records is not None else list(rec)
    specs = [s.spec for s in leaf_sh]
    zspecs = [s.spec for s in state_sh]
    out = {"records": records,
           "values": sh.gather_leaves(tree.leaves(values), specs, mesh)}
    for k in ("master", "m", "v"):
        out[k] = sh.gather_leaves(tree.leaves(state[k]), zspecs, mesh)
    return out


def _cell_records(cfg, mesh, rules) -> dict:
    """One train step's, one prefill's and one decode step's collectives
    on this rank's blocks of reduced glm4."""
    m = M.build(cfg)
    whole = _whole(cfg)
    opt = optimizers.adamw(schedules.constant(1e-4))
    placed = dryrun.place(m, whole, mesh, rules, opt)
    values = placed["values"]
    out = {}
    with sh.use_mesh(mesh, rules), sh.use_leaf_shardings(
            placed["leaf_shardings"], state=placed["state_shardings"]):
        with comm.recording() as rec:
            make_train_step(m.loss, opt)(values, placed["state"],
                                         _batch(cfg, TRAIN.global_batch,
                                                TRAIN.seq_len))
        out["train"] = list(rec)
        placed = dryrun.place(m, whole, mesh, rules)
        values = placed["values"]
        shape = CELL_SHAPES[1]
        with comm.recording() as rec:
            _, cache = m.prefill(values, {"tokens": _batch(
                cfg, shape.global_batch, shape.seq_len)["tokens"]},
                max_seq=shape.seq_len)
        out["prefill"] = list(rec)
        shape = CELL_SHAPES[2]
        cache = m.cache_init(shape.global_batch, shape.seq_len)
        token = torch.zeros((shape.global_batch, 1), dtype=torch.int32)
        with comm.recording() as rec:
            m.decode_step(values, token, torch.zeros(
                (shape.global_batch,), dtype=torch.int32), cache)
        out["decode"] = list(rec)
    return out


def _world_task(shape) -> dict:
    pod, data, model = shape
    mesh = tmesh.make_mesh(data, model, pod=pod if pod > 1 else None)
    cfg = _cfg()
    rules = tmesh.rules_for("train_4k", TRAIN.global_batch, mesh)
    out = {"coord": mesh.coord(), "cells": _cell_records(cfg, mesh, rules)}
    if pod > 1:
        with sh.use_mesh(mesh, rules):
            axis = sh.logical_axis("batch")
            loss, _, grads = value_and_grad(
                M.build(cfg).loss, _whole(cfg),
                _batch(cfg, TRAIN.global_batch, TRAIN.seq_len))
        out["batch_axis"] = (axis.name, axis.size, axis.index)
        out["lm"] = (loss, grads)
        out["steps"] = {v: _steps(cfg, mesh, rules, v)
                        for v in ("plain", "zero", "fsdp")}
    return out


WORLDS = [(2, 2, 1), (1, 1, 2)]


def _fake_records(shape) -> dict:
    """The fake traces' collectives of :func:`_world_task`'s cells, on
    rank 0 and on the last rank."""
    pod, data, model = shape
    cfg = _cfg()
    out = {}
    for rank in (0, pod * data * model - 1):
        for kind, cell in (("train", TRAIN), ("prefill", CELL_SHAPES[1]),
                           ("decode", CELL_SHAPES[2])):
            got = _trace(cfg, cell, data, model, pod if pod > 1 else None,
                         rank=rank)
            out[(rank, kind)] = got["records"]
        if pod > 1:
            for variant in ("zero", "fsdp"):
                saved = dryrun.FSDP_PARAM_BYTES
                dryrun.FSDP_PARAM_BYTES = 0 if variant == "fsdp" else saved
                try:
                    got = _trace(cfg, TRAIN, data, model, pod, rank=rank)
                finally:
                    dryrun.FSDP_PARAM_BYTES = saved
                out[(rank, variant)] = got["records"]
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' rank results, spawned at once while this process
    traces their cells on fake tensors and runs the one-rank loss."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        spawned = {s: pool.submit(
            comm.spawn, _world_task, math.prod(s), (s,),
            workdir=tmp_path_factory.mktemp("world" + "x".join(map(str, s))),
            timeout=RANK_TIMEOUT) for s in WORLDS}
        fake = {s: _fake_records(s) for s in WORLDS}
        cfg = _cfg()
        loss, _, grads = value_and_grad(
            M.build(cfg).loss, _whole(cfg),
            _batch(cfg, TRAIN.global_batch, TRAIN.seq_len))
        got = {s: f.result() for s, f in spawned.items()}
    return dict(got=got, fake=fake, one=(loss, grads))


def test_pod_combined_batch_split_trains_as_one_rank(worlds):
    oloss, ograds = worlds["one"]
    for r, out in enumerate(worlds["got"][(2, 2, 1)]):
        name, size, index = out["batch_axis"]
        assert (name, size) == (("pod", "data"), 4)
        assert index == out["coord"][0] * 2 + out["coord"][1] == r
        loss, grads = out["lm"]
        assert abs(float(loss) - float(oloss)) < LOSS_ATOL
        for g, o in zip(tree.leaves(grads), tree.leaves(ograds)):
            assert float((g - o).abs().max()) < GRAD_ATOL


def _same(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x.view(torch.uint8),
                                                  y.view(torch.uint8))
               for x, y in zip(a, b)) and len(a) == len(b)


@pytest.mark.parametrize("variant", ["zero", "fsdp"])
def test_zero_and_fsdp_steps_are_bitwise_the_unsplit_step(worlds, variant):
    for out in worlds["got"][(2, 2, 1)]:
        plain, split = out["steps"]["plain"], out["steps"][variant]
        for k in ("values", "master", "m", "v"):
            assert _same(split[k], plain[k]), (variant, k)
        # what travels: ZeRO gathers the new parameters; FSDP gathers them
        # where they are used and scatters their gradients
        ops = {r["op"] for r in split["records"]}
        assert "all_gather" in ops and "all_to_all" in ops


@pytest.mark.parametrize("world", WORLDS)
def test_collectives_equal_the_fake_trace(worlds, world):
    """Every rank's recorded collectives, op for op in order, equal the
    fake trace's of the same cell (rank 0's for the first rank, the last
    rank's for the last)."""
    ranks = worlds["got"][world]
    for r in (0, len(ranks) - 1):
        cells = dict(ranks[r]["cells"])
        if world[0] > 1:
            cells.update({v: ranks[r]["steps"][v]["records"]
                          for v in ("zero", "fsdp")})
        for kind, real in cells.items():
            fake = worlds["fake"][world][(r, kind)]
            assert real == fake, (world, r, kind)
            assert comm.summarize(real) == comm.summarize(fake)
