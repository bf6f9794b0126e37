"""ZeRO and FSDP state in the trainer and the checkpointer: ``trainer.train``
with a ``sharding.Placement`` (``sharding.placement``) over
``torch.distributed`` ranks, against the port's one-rank trainer.

Two gloo worlds are spawned at once with ``comm.spawn``, (2, 1) and
(1, 2), while the parent runs the one-rank references.  Reduced glm4-9b
trains under rules that give every rank the whole batch (``batch`` maps
to no mesh axis), so the data axis holds only the ZeRO blocks of AdamW's
master weights and moments (and, under FSDP, of the values): the split
run's arithmetic is the one-device run's, and it is held bitwise.  A
third run, "dp", is data-parallel ZeRO under the default rules, as the
dry-run's train cells place it: the batch split over the data axis and
the state over the same axis; its gradients are summed over the ranks,
so it is held to the one-rank run by the tensor-parallel limits.

- On (2, 1), ZeRO and FSDP: 4 steps with a checkpoint every 2 are bitwise
  the one-rank run (values, master, m, v, losses, gradient norms); a
  rank's master and moments are half the one-rank state; a relaunch from
  step 2 resumes bitwise; the index names each state leaf's ZeRO axes
  under its own key.
- On (2, 1), data-parallel ZeRO: 4 steps within ``tests/test_torch_tp.py``'s
  limits of the one-rank run, half the state a rank, a relaunch bitwise,
  and its step-4 checkpoint continued to step 6 on one rank within the
  same limits of the uninterrupted one-rank run.
- The ZeRO run's step-4 checkpoint continues to step 6 bitwise the
  uninterrupted one-rank run on one rank and on (2, 1) without ZeRO, and
  within ``tests/test_torch_tp.py``'s limits on (1, 2), where the model
  axis splits the heads, workers and vocabulary.
"""

import concurrent.futures
import json
import os
import shutil

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.configs import get_reduced
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as M
from repro_torch.optim import optimizers
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as sh
from repro_torch.train import trainer

torch.set_num_threads(1)

RANK_TIMEOUT = 60.0
# tests/test_torch_tp.py's limits for a run over the model axis
LOSS_ATOL, GRAD_ATOL = 1e-4, 1e-3
BATCH, SEQ, STEPS, MORE = 4, 16, 4, 2
# every rank takes the whole batch; fsdp (ZeRO) over data, as by default
RULES = dict(sh.DEFAULT_RULES, batch=None)
# the state's placement and the rules of each split run: "dp" takes the
# default rules, the batch split over the data axis
VARIANTS = ("zero", "fsdp")
SPLIT_RULES = {"zero": RULES, "fsdp": RULES, "dp": sh.DEFAULT_RULES}
ARCH = "glm4-9b"


def _model():
    m = M.build(get_reduced(ARCH, n_workers=4, tp_fusion="max"))
    return m, m.init(torch.Generator().manual_seed(0))


def _adamw():
    return optimizers.adamw(lambda s: torch.tensor(1e-2) + 0 * s,
                            max_grad_norm=0.5)


def _data(step):
    gen = torch.Generator().manual_seed(step)
    tok = torch.randint(0, 256, (BATCH, SEQ), generator=gen,
                        dtype=torch.int32)
    return {"tokens": tok, "targets": torch.roll(tok, -1, 1)}


def _train(m, values, shardings, ckpt_dir, steps):
    tcfg = trainer.TrainerConfig(steps=steps, ckpt_dir=ckpt_dir,
                                 ckpt_every=2, log_every=1)
    return trainer.train(m.loss, values, _adamw(), _data, tcfg,
                         shardings=shardings)


def _rows(history, first=0):
    return [{k: v for k, v in h.items() if k != "step_time_s"}
            for h in history if h["step"] >= first]


def _state(opt):
    return {k: opt[k] for k in ("master", "m", "v")}


def _copy_checkpoint(src, dst):
    """``src``'s checkpoints into ``dst`` (rank 0), every rank after."""
    if comm.rank() == 0:
        shutil.copytree(src, dst)
    if comm.initialized():
        dist.barrier()


def _preempt_after(ckpt_dir, step):
    """The job preempted after its step-``step`` checkpoint."""
    dist.barrier()
    if comm.rank() == 0:
        for name in os.listdir(ckpt_dir):
            if name.startswith("step_") and int(name[5:]) > step:
                shutil.rmtree(os.path.join(ckpt_dir, name))
        with open(os.path.join(ckpt_dir, "latest"), "w") as f:
            f.write(str(step))
    dist.barrier()


# ---------------------------------------------------------------------------
# the rank tasks
# ---------------------------------------------------------------------------

def _split_runs(mesh, ckpt) -> dict:
    """ZeRO and FSDP: the run, its relaunch from step 2, the gathered
    values and state, this rank's shapes, the placement's state axes."""
    m, whole = _model()
    out = {}
    for variant, rules in SPLIT_RULES.items():
        pl = sh.placement(m.axes(), whole, mesh, rules,
                          fsdp=variant == "fsdp")
        mine = sh.shard_values(whole, pl.axes, mesh, rules)
        d = os.path.join(ckpt, variant)
        with sh.use_mesh(mesh, rules):
            full = _train(m, mine, pl, d, STEPS)
            _preempt_after(d, 2)
            resumed = _train(m, mine, pl, d, STEPS)
            specs = [s.spec for s in sh.flat_shardings(pl.state_shardings)]
            out[variant] = dict(
                rows=_rows(full.history), resumed=_rows(resumed.history),
                same_resumed=all(torch.equal(a, b) for a, b in zip(
                    tree.leaves((full.values, full.opt_state)),
                    tree.leaves((resumed.values, resumed.opt_state)))),
                values=sh.gather_values(full.values, pl.shardings),
                state={k: tree.unflatten(whole, sh.gather_leaves(
                    tree.leaves(v), specs, mesh))
                    for k, v in _state(full.opt_state).items()},
                shapes={k: [tuple(t.shape) for t in tree.leaves(v)]
                        for k, v in _state(full.opt_state).items()},
                value_shapes=[tuple(t.shape) for t in tree.leaves(
                    full.values)],
                state_axes=pl.state_axes, axes=pl.axes)
    return out


def _continue_without_zero(mesh, ckpt) -> dict:
    """The ZeRO run's checkpoint continued to step 6 with the values'
    shardings alone (the state placed as the values)."""
    m, whole = _model()
    d = os.path.join(ckpt, f"plain{mesh.shape['data']}x{mesh.shape['model']}")
    _copy_checkpoint(os.path.join(ckpt, "zero"), d)
    shd = sh.tree_shardings_for_values(m.axes(), whole, mesh, RULES)
    with sh.use_mesh(mesh, RULES):
        res = _train(m, sh.shard_values(whole, m.axes(), mesh, RULES), shd,
                     d, STEPS + MORE)
        return dict(rows=_rows(res.history),
                    values=sh.gather_values(res.values, shd),
                    state={k: sh.gather_values(v, shd)
                           for k, v in _state(res.opt_state).items()})


def _wait_for(path: str) -> None:
    import time
    limit = time.monotonic() + RANK_TIMEOUT
    while not os.path.exists(path):
        if time.monotonic() > limit:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.2)


def _rank_task(shape, ckpt) -> dict:
    mesh = tmesh.make_mesh(*shape)
    done = os.path.join(ckpt, "DONE")
    if shape == (2, 1):
        out = {"split": _split_runs(mesh, ckpt)}
        if comm.rank() == 0:
            open(done, "w").close()
    else:
        _wait_for(done)
        out = {}
    out["continued"] = _continue_without_zero(mesh, ckpt)
    return out


# ---------------------------------------------------------------------------
# the references and the spawns
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        spawned = {s: pool.submit(
            comm.spawn, _rank_task, s[0] * s[1], (s, ckpt),
            workdir=tmp_path_factory.mktemp(f"mesh{s[0]}x{s[1]}"),
            timeout=RANK_TIMEOUT) for s in ((2, 1), (1, 2))}
        m, whole = _model()
        one = _train(m, whole, None, None, STEPS)
        longer = _train(m, whole, None, None, STEPS + MORE)
        got = {s: f.result() for s, f in spawned.items()}
    # the ZeRO runs' checkpoints continued on one rank, no mesh
    restored = {}
    for variant in ("zero", "dp"):
        d = os.path.join(ckpt, f"one_{variant}")
        shutil.copytree(os.path.join(ckpt, variant), d)
        restored[variant] = _train(m, whole, None, d, STEPS + MORE)
    return dict(got=got, one=one, longer=longer, restored=restored,
                ckpt=ckpt, whole=whole)


def _same(a, b) -> bool:
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("variant", VARIANTS)
def test_split_state_trainer_is_bitwise_the_unsplit_run(worlds, variant):
    one = worlds["one"]
    for r, out in enumerate(worlds["got"][(2, 1)]):
        got = out["split"][variant]
        assert got["rows"] == _rows(one.history), r
        assert _same(got["values"], one.values), r
        for k, v in got["state"].items():
            assert _same(v, one.opt_state[k]), (variant, k, r)


def _within_tp_limits(rows, want, values, want_values, r) -> None:
    assert [h["step"] for h in rows] == [h["step"] for h in want], r
    for a, b in zip(rows, want):
        assert abs(a["loss"] - b["loss"]) < LOSS_ATOL, r
        assert abs(a["grad_norm"] - b["grad_norm"]) < GRAD_ATOL, r
    for g, o in zip(tree.leaves(values), tree.leaves(want_values)):
        assert float((g - o).abs().max()) < GRAD_ATOL, r


def test_data_parallel_zero_tracks_the_unsplit_run(worlds):
    """Data-parallel ZeRO (the batch and the state split over the data
    axis): the losses, gradient norms and gathered values within the
    tensor-parallel limits of the one-rank run."""
    one = worlds["one"]
    for r, out in enumerate(worlds["got"][(2, 1)]):
        got = out["split"]["dp"]
        _within_tp_limits(got["rows"], _rows(one.history), got["values"],
                          one.values, r)


def test_data_parallel_zero_checkpoint_continues_on_one_rank(worlds):
    """The data-parallel ZeRO run's step-4 checkpoint, continued to step 6
    on one rank: within the tensor-parallel limits of the uninterrupted
    one-rank run."""
    longer, restored = worlds["longer"], worlds["restored"]["dp"]
    _within_tp_limits(_rows(restored.history), _rows(longer.history, STEPS),
                      restored.values, longer.values, 0)


@pytest.mark.parametrize("variant", tuple(SPLIT_RULES))
def test_split_state_relaunch_resumes_bitwise(worlds, variant):
    for r, out in enumerate(worlds["got"][(2, 1)]):
        got = out["split"][variant]
        assert got["same_resumed"], r
        assert got["resumed"] == got["rows"][2:], r


@pytest.mark.parametrize("variant", tuple(SPLIT_RULES))
def test_a_rank_holds_half_the_state(worlds, variant):
    """Every state leaf that ZeRO splits is halved along its fsdp dim, and
    so a rank's master and moments are half the one-rank state's bytes;
    under FSDP the values are halved too."""
    one = worlds["one"].opt_state
    whole = sum(t.numel() for t in tree.leaves(one["master"]))
    for out in worlds["got"][(2, 1)]:
        got = out["split"][variant]
        for k in ("master", "m", "v"):
            assert sum(int(np.prod(s)) for s in got["shapes"][k]) * 2 \
                == whole, k
        if variant == "fsdp":
            assert sum(int(np.prod(s)) for s in got["value_shapes"]) * 2 \
                == whole


def test_checkpoint_continues_on_one_rank_and_without_zero(worlds):
    """The ZeRO run's step-4 checkpoint, continued to step 6 on one rank
    and on (2, 1) with the state placed as the values: bitwise the
    uninterrupted one-rank run."""
    longer, restored = worlds["longer"], worlds["restored"]["zero"]
    assert _rows(restored.history) == _rows(longer.history, STEPS)
    assert _same(restored.values, longer.values)
    assert _same(restored.opt_state, longer.opt_state)
    for r, out in enumerate(worlds["got"][(2, 1)]):
        got = out["continued"]
        assert got["rows"] == _rows(longer.history, STEPS), r
        assert _same(got["values"], longer.values), r
        for k, v in got["state"].items():
            assert _same(v, longer.opt_state[k]), (k, r)


def test_checkpoint_continues_on_the_model_axis(worlds):
    """Restored on (1, 2), where the heads, workers and vocabulary split:
    the losses and gradient norms within the tensor-parallel limits."""
    want = _rows(worlds["longer"].history, STEPS)
    for r, out in enumerate(worlds["got"][(1, 2)]):
        got = out["continued"]
        _within_tp_limits(got["rows"], want, got["values"],
                          worlds["longer"].values, r)


@pytest.mark.parametrize("variant", tuple(SPLIT_RULES))
def test_index_names_the_split_state_under_each_leafs_key(worlds, variant):
    """The checkpoint's index holds every state leaf's ZeRO axes (and
    every value's axes) under the leaf's own key, as the placement names
    them; ZeRO adds ``fsdp`` to the state's axes."""
    from repro_torch.checkpoint import checkpointer as ck
    got = worlds["got"][(2, 1)][0]["split"][variant]
    step = os.path.join(worlds["ckpt"], variant, f"step_{STEPS:010d}")
    with open(os.path.join(step, "index.json")) as f:
        index = json.load(f)
    want = {}
    for k in ("master", "m", "v"):
        want.update({f"opt/{k}/{p}": list(a) for p, a in
                     ck._flatten_with_paths(got["state_axes"],
                                            is_leaf=sh.is_axes).items()})
    want.update({f"values/{p}": list(a) for p, a in ck._flatten_with_paths(
        got["axes"], is_leaf=sh.is_axes).items()})
    assert index["axes"] == want
    assert set(index["axes"]) <= set(index["keys"])
    assert any("fsdp" in a for k, a in want.items() if k.startswith("opt/"))
    assert any("fsdp" in a for k, a in want.items()
               if k.startswith("values/")) == (variant == "fsdp")
