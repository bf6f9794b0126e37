"""The MoE, recurrent and encoder-decoder models over ``torch.distributed``
ranks: expert parallelism (``models/moe.py``), the worker-split mLSTM and
mamba mixers with their states, the split self- and cross-attention, the
frontends, against the JAX package's one-device model and the port's
one-rank runs.

Two gloo worlds are spawned at once with ``comm.spawn``, a (1, 2) mesh
(the model axis splits the experts, workers, heads and vocabulary) and a
(2, 1) mesh (the data axis splits the batch), while the parent runs the
JAX and one-rank references.  Each case's loss and gathered gradients are
held to ``jax.value_and_grad`` of the JAX package's model at the same
numpy values within ``tests/test_torch_tp.py``'s tolerances; one control
fault per family (an input outside the model group's *f* copy) must miss
them.  The engine serves the MoE and recurrent plans under OCS and under
bursts with ``retry(2)`` on both meshes, equal to the one-rank engine
field by field; whisper and pixtral serve through ``prefill`` and
``decode_step_channel``.

The JAX package is imported inside the fixtures and tests, so the rank
processes, which import this module to find their task, load no JAX.
"""

import concurrent.futures
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch import random as jr
from repro_torch import tree
from repro_torch.checkpoint import checkpointer as ck
from repro_torch.configs import ARCH_IDS, get_reduced
from repro_torch.convert import params_from_jax
from repro_torch.faults import DegradePolicy, FaultModel
from repro_torch.launch import mesh as tmesh
from repro_torch.models import attention, fusion, mamba, moe, ssm
from repro_torch.models import model as M
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as sh
from repro_torch.protocol import Protocol
from repro_torch.serve import engine as se
from repro_torch.train.train_step import value_and_grad

torch.set_num_threads(1)

RANK_TIMEOUT = 60.0
# tests/test_torch_tp.py's tolerances (tests/test_distributed.py's)
LOSS_ATOL, GRAD_ATOL = 1e-4, 1e-3
# the loss over ranks against the one-rank loss: the heads', workers' and
# vocabulary's partial sums and the gradient's all-reduce add in another
# order, a few float32 roundings of values of order 1-10
ONE_RANK_ATOL = 1e-5
# the aux loss over the data group: the expert means are a sum over the
# ranks' rows divided once, where one rank takes torch.mean; float32
# roundings of a value of order 1
AUX_ATOL = 1e-6
BATCH, SEQ, S_DEC = 4, 16, 8
MESHES = [(1, 2), (2, 1)]
# (name, arch, overrides): whisper at 8 workers keeps its full config's
# "plain" attention layout (its 4 reduced heads do not divide them)
CASES = [("qwen3moe", "qwen3-moe-30b-a3b", {}),
         ("llama4", "llama4-scout-17b-a16e", {"moe_impl": "gather"}),
         ("xlstm", "xlstm-125m", {}),
         ("jamba", "jamba-1.5-large-398b", {}),
         ("whisper", "whisper-base", {"n_workers": 8}),
         ("pixtral", "pixtral-12b", {})]
NAMES = [c[0] for c in CASES]
# the engine: the MoE and recurrent plans, OCS p 0.05 alone and under
# bursts and outages with retry(2)
SERVED = ("qwen3moe", "xlstm", "jamba")
SERVE_KW = dict(batch_slots=2, max_seq=24, eos_id=-1, seed=5)
FREE_TICKS = 4


def _kw(kw):
    return dict(dict(n_workers=4, tp_fusion="max"), **kw)


def _cfg(name):
    _, arch, kw = next(c for c in CASES if c[0] == name)
    return get_reduced(arch, **_kw(kw))


def _batch_np(cfg, rows=BATCH, targets=True, seed=0):
    """The numpy batch of the model's convention: tokens, patch features,
    or whisper's frames and decoder tokens."""
    rng = np.random.default_rng(seed)
    out, s = {}, SEQ
    if cfg.frontend != "token":
        out["feats"] = rng.standard_normal(
            (rows, SEQ, cfg.frontend_dim)).astype(np.float32)
    if cfg.frontend == "token" or cfg.encoder_decoder:
        s = S_DEC if cfg.encoder_decoder else SEQ
        out["tokens"] = rng.integers(0, cfg.vocab_size, (rows, s)).astype(
            np.int32)
    if targets:
        out["targets"] = rng.integers(0, cfg.vocab_size, (rows, s)).astype(
            np.int32)
    return out


def _torch_batch(cfg, **kw):
    return {k: torch.from_numpy(v) for k, v in _batch_np(cfg, **kw).items()}


def _values(inits, name):
    cfg = _cfg(name)
    return cfg, M.build(cfg), tree.map(torch.from_numpy, inits[name])


# ---------------------------------------------------------------------------
# the control faults: one input of each family outside the f copy
# ---------------------------------------------------------------------------

class _FusionWithout:
    """``models.fusion`` whose ``copy_in`` leaves its first ``skip``
    tensors outside the *f* copy (``None``: all of them)."""

    def __init__(self, skip):
        self.skip = skip

    def __getattr__(self, name):
        return getattr(fusion, name)

    def copy_in(self, axis, *tensors):
        k = len(tensors) if self.skip is None else self.skip
        return tensors[:k] + fusion.copy_in(axis, *tensors[k:])


def _qkv_kv_x_outside(cfg, p, x, kv_x, heads):
    """``attention._qkv`` with the encoder output ``kv_x`` outside the *f*
    copy."""
    d = cfg.dtype
    cross = kv_x is not None
    x = heads.copy(x)
    kv_x = kv_x if cross else x
    q = attention._proj(x, p["wq"].to(d))
    k = attention._proj(kv_x, heads.copy(p["wk"]).to(d))
    v = attention._proj(kv_x, heads.copy(p["wv"]).to(d))
    if "bq" in p:
        q = q + p["bq"].to(d)
        k = k + heads.copy(p["bk"]).to(d)
        v = v + heads.copy(p["bv"]).to(d)
    return q, k, v


# the fault of each family: (case, module, attribute, replacement)
CONTROLS = {
    "moe": ("qwen3moe", moe._Slots, "copy", lambda self, x: x),
    "mlstm": ("xlstm", ssm, "fusion", _FusionWithout(2)),
    "mamba": ("jamba", mamba, "fusion", _FusionWithout(None)),
    "cross": ("whisper", attention, "_qkv", _qkv_kv_x_outside),
}


# ---------------------------------------------------------------------------
# the rank task
# ---------------------------------------------------------------------------

def _lm_on_ranks(mesh, inits) -> dict:
    """Each case's loss, metrics and gathered gradients on this mesh."""
    out = {}
    for name in NAMES:
        cfg, m, whole = _values(inits, name)
        axes = m.axes()
        mine = sh.shard_values(whole, axes, mesh)
        shd = sh.tree_shardings_for_values(axes, whole, mesh)
        with sh.use_mesh(mesh):
            loss, metrics, grads = value_and_grad(m.loss, mine,
                                                  _torch_batch(cfg))
        out[name] = (loss, metrics, sh.gather_values(grads, shd),
                     tree.map(lambda t: tuple(t.shape), mine))
    return out


def _controls_on_ranks(mesh, inits) -> dict:
    out = {}
    for family, (name, owner, attr, fault) in CONTROLS.items():
        cfg, m, whole = _values(inits, name)
        axes = m.axes()
        mine = sh.shard_values(whole, axes, mesh)
        shd = sh.tree_shardings_for_values(axes, whole, mesh)
        sound = getattr(owner, attr)
        setattr(owner, attr, fault)
        try:
            with sh.use_mesh(mesh):
                loss, _, grads = value_and_grad(m.loss, mine,
                                                _torch_batch(cfg))
        finally:
            setattr(owner, attr, sound)
        out[family] = (loss, sh.gather_values(grads, shd))
    return out


def _moe_layer(cfg, p, x):
    """(y, aux, the gradients of ``sum(y * g) + aux`` w.r.t. x and p)."""
    leaves = [t.detach().requires_grad_(True) for t in tree.leaves(p)]
    live = tree.unflatten(p, leaves)
    x = x.detach().requires_grad_(True)
    y, aux = moe.moe_apply(cfg, live, x)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(3))
    grads = torch.autograd.grad(torch.sum(y * g) + aux, [x] + leaves)
    return y.detach(), aux.detach(), grads[0], tree.unflatten(p, grads[1:])


def _moe_layer_input(cfg):
    gen = torch.Generator().manual_seed(2)
    return torch.randn((BATCH, SEQ, cfg.d_model), generator=gen)


def _moe_layers_on_ranks(mesh, inits) -> dict:
    """Each MoE form's layer on this rank's experts, its gradients
    gathered."""
    out = {}
    for name in ("qwen3moe", "llama4"):
        cfg, m, whole = _values(inits, name)
        p = tree.map(lambda t: t[0], whole["blocks"]["pos0"]["ffn"])
        axes = sh.map_axes(lambda a: a[1:],
                           m.axes()["blocks"]["pos0"]["ffn"])
        mine = sh.shard_values(p, axes, mesh)
        shd = sh.tree_shardings_for_values(axes, p, mesh)
        with sh.use_mesh(mesh):
            y, aux, gx, gp = _moe_layer(cfg, mine, _moe_layer_input(cfg))
        out[name] = (y, aux, gx, sh.gather_values(gp, shd),
                     tuple(mine["w_up"].shape))
    return out


def _fault(policy):
    pol = getattr(DegradePolicy, policy[0])(*policy[1:])
    return FaultModel.burst(burst_len=4, gap_len=16, p_miss_bad=0.5,
                            p_miss_good=0.01, policy=pol).with_dropout(
                                0.5, 0.3)


def _requests(vocab):
    """More requests than slots, prompts of 3 and 5 tokens (a mamba layer
    caches the last conv_width - 1 = 3 rows), a late arrival."""
    rng = np.random.default_rng(6)
    return [se.Request(rid=i, prompt=rng.integers(0, vocab, 3 + 2 * (i % 2))
                       .astype(np.int32), max_new_tokens=4 + (i % 3),
                       arrival_tick=(0, 0, 1, 4, 12)[i]) for i in range(5)]


SERVE_CASES = {"ocs": None, "retry": ("retry", 2)}


def _serve(m, values) -> dict:
    """{case: {rid: every field of the completion}} under OCS p 0.05 and
    under bursts and outages with ``retry(2)``."""
    out = {}
    eng = se.ServeEngine(m, values, se.ServeConfig(**SERVE_KW), device="cpu")
    proto = Protocol.ocs(bits=8, p_miss=0.05)
    for case, policy in SERVE_CASES.items():
        got = eng.run(_requests(m.cfg.vocab_size), protocol=proto,
                      fault=None if policy is None else _fault(policy))
        out[case] = {rid: dataclasses.astuple(c) for rid, c in got.items()}
    return out


def _serve_model_api(m, values) -> dict:
    """Greedy tokens, channel slots and the last logits of a prefill and
    ``FREE_TICKS`` ``decode_step_channel`` ticks under OCS p 0.05."""
    batch = _torch_batch(m.cfg, rows=2, targets=False, seed=4)
    if m.cfg.encoder_decoder:
        batch["tokens"] = batch["tokens"][:, :4]
    start = (batch["tokens"] if "tokens" in batch else batch["feats"]).shape[1]
    logits, cache = m.prefill(values, batch, max_seq=start + FREE_TICKS)
    proto = Protocol.ocs(bits=8, p_miss=0.05)
    pos = torch.full((2,), start, dtype=torch.int32)
    toks, slots = [], []
    for t in range(FREE_TICKS):
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        logits, cache, chan = m.decode_step_channel(
            values, tok, pos + t, cache, proto, jr.PRNGKey(t))
        toks.append(tok)
        slots.append(int(chan["contention_slots"]))
    return dict(tokens=torch.cat(toks, 1), slots=slots, logits=logits)


def _serve_on_ranks(mesh, inits) -> dict:
    out = {}
    for name in SERVED + ("whisper", "pixtral"):
        cfg, m, whole = _values(inits, name)
        mine = sh.shard_values(whole, m.axes(), mesh)
        with sh.use_mesh(mesh):
            out[name] = (_serve(m, mine) if name in SERVED
                         else _serve_model_api(m, mine))
    return out


def _checkpoint_on_ranks(mesh, inits, ckpt_dir) -> dict:
    """qwen3-moe's values: saved from this rank's expert blocks on the
    (1, 2) mesh, restored on the (2, 1) mesh and gathered."""
    cfg, m, whole = _values(inits, "qwen3moe")
    axes = m.axes()
    shd = sh.tree_shardings_for_values(axes, whole, mesh)
    done = os.path.join(ckpt_dir, "DONE")
    if mesh.shape["model"] > 1:
        ck.save(ckpt_dir, 1, sh.shard_values(whole, axes, mesh),
                axes_tree=axes, shardings=shd)
        if comm.rank() == 0:
            open(done, "w").close()
        return {}
    _wait_for(done)
    got = ck.restore(ckpt_dir, template=whole, shardings=shd)[0]
    return {"restored": sh.gather_values(got, shd)}


def _entry_points(arch, values=None) -> dict:
    """Every entry point of a reduced arch at 4 workers: the loss, a
    prefill's logits, a ``decode_step``'s and a ``decode_step_channel``'s
    (OCS p 0.05) logits and channel slots."""
    cfg = get_reduced(arch, n_workers=4, tp_fusion="max")
    m = M.build(cfg)
    if values is None:
        values = m.init(torch.Generator().manual_seed(0))
    batch = _torch_batch(cfg)
    prompt = {k: v for k, v in batch.items() if k != "targets"}
    start = (prompt["tokens"] if "tokens" in prompt
             else prompt["feats"]).shape[1]
    loss = m.loss(values, batch)[0]
    logits, cache = m.prefill(values, prompt, max_seq=start + 2)
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    pos = torch.full((BATCH,), start, dtype=torch.int32)
    step, cache = m.decode_step(values, tok, pos, cache)
    tok = step.argmax(-1)[:, None].to(torch.int32)
    chan_logits, _, chan = m.decode_step_channel(
        values, tok, pos + 1, cache, Protocol.ocs(bits=8, p_miss=0.05),
        jr.PRNGKey(1))
    return dict(loss=loss, prefill=logits, step=step, channel=chan_logits,
                slots=int(chan["contention_slots"]))


def _archs_on_ranks(mesh) -> dict:
    out = {}
    for arch in ARCH_IDS:
        m = M.build(get_reduced(arch, n_workers=4, tp_fusion="max"))
        whole = m.init(torch.Generator().manual_seed(0))
        with sh.use_mesh(mesh):
            out[arch] = _entry_points(
                arch, sh.shard_values(whole, m.axes(), mesh))
    return out


def _rank_task(shape, inits, ckpt_dir) -> dict:
    mesh = tmesh.make_mesh(*shape)
    out = {"lm": _lm_on_ranks(mesh, inits),
           "serve": _serve_on_ranks(mesh, inits),
           "ckpt": _checkpoint_on_ranks(mesh, inits, ckpt_dir),
           "archs": _archs_on_ranks(mesh)}
    if shape == (1, 2):
        out["controls"] = _controls_on_ranks(mesh, inits)
        out["moe"] = _moe_layers_on_ranks(mesh, inits)
    return out


# ---------------------------------------------------------------------------
# the references and the spawns
# ---------------------------------------------------------------------------

def _inits() -> dict:
    """Each case's parameters, from the port's seed-0 init, as numpy."""
    out = {}
    for name in NAMES:
        m = M.build(_cfg(name))
        out[name] = tree.map(lambda t: t.numpy(),
                             m.init(torch.Generator().manual_seed(0)))
    return out


def _jax_lm(name, values):
    """(the JAX package's loss, its aux, its gradients as a port tree) of
    a case at the numpy ``values``."""
    import jax

    from repro.configs import get_reduced as jget
    from repro.models import model as JM
    _, arch, kw = next(c for c in CASES if c[0] == name)
    jm = JM.build(jget(arch, **_kw(kw)))
    batch = {k: jax.numpy.asarray(v)
             for k, v in _batch_np(_cfg(name)).items()}
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda v: (lambda r: (r[0], r[1]["aux"]))(jm.loss(v, batch)),
        has_aux=True))(tree.map(jax.numpy.asarray, values))
    return float(loss), float(aux), params_from_jax(
        jax.tree.map(np.asarray, grads))


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
    """Both meshes' rank results and the references they are held to."""
    inits = _inits()
    ckpt_dir = str(tmp_path_factory.mktemp("ckpt"))
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        spawned = {s: pool.submit(
            comm.spawn, _rank_task, s[0] * s[1], (s, inits, ckpt_dir),
            workdir=tmp_path_factory.mktemp(f"mesh{s[0]}x{s[1]}"),
            timeout=RANK_TIMEOUT) for s in MESHES}
        ref = {name: _jax_lm(name, inits[name]) for name in NAMES}
        one, serve, moe_one = {}, {}, {}
        for name in NAMES:
            cfg, m, whole = _values(inits, name)
            one[name] = value_and_grad(m.loss, whole, _torch_batch(cfg))
            serve[name] = (_serve(m, whole) if name in SERVED
                           else _serve_model_api(m, whole)
                           if name in ("whisper", "pixtral") else None)
            if name in ("qwen3moe", "llama4"):
                p = tree.map(lambda t: t[0], whole["blocks"]["pos0"]["ffn"])
                moe_one[name] = _moe_layer(cfg, p, _moe_layer_input(cfg))
        archs = {arch: _entry_points(arch) for arch in ARCH_IDS}
        got = {s: f.result() for s, f in spawned.items()}
    return dict(got=got, ref=ref, one=one, serve=serve, moe=moe_one,
                archs=archs, inits=inits)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

def _grad_gaps(grads, want) -> float:
    return max(float((g - w).abs().max())
               for g, w in zip(tree.leaves(grads), tree.leaves(want)))


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", NAMES)
def test_loss_and_grads_match_jax_and_one_rank(ranks, shape, name):
    jloss, jaux, jgrads = ranks["ref"][name]
    oloss, ometrics, ograds = ranks["one"][name]
    assert abs(float(oloss) - jloss) < LOSS_ATOL
    for r, out in enumerate(ranks["got"][shape]):
        loss, metrics, grads, _ = out["lm"][name]
        assert abs(float(loss) - jloss) < LOSS_ATOL, (shape, r)
        assert abs(float(loss) - float(oloss)) < ONE_RANK_ATOL, (shape, r)
        for g, o in zip(tree.leaves(grads), tree.leaves(ograds)):
            assert g.shape == o.shape
        assert _grad_gaps(grads, jgrads) < GRAD_ATOL, (shape, r)
        assert _grad_gaps(grads, ograds) < GRAD_ATOL, (shape, r)
        # every rank holds the same whole loss and gradients
        first = ranks["got"][shape][0]["lm"][name]
        assert torch.equal(loss, first[0])
        assert all(torch.equal(a, b) for a, b in zip(
            tree.leaves(grads), tree.leaves(first[2])))


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_runs_every_entry_point_on_a_mesh(ranks, shape, arch):
    """The ten reduced archs: the loss, the prefill's and both decode
    steps' logits within float32 roundings of the one-rank run's, and the
    channel tick's slots equal."""
    want = ranks["archs"][arch]
    for r, out in enumerate(ranks["got"][shape]):
        got = out["archs"][arch]
        assert abs(float(got["loss"]) - float(want["loss"])) < ONE_RANK_ATOL
        for k in ("prefill", "step", "channel"):
            assert got[k].shape == want[k].shape, (k, r)
            torch.testing.assert_close(got[k], want[k], rtol=1e-5,
                                       atol=1e-5)
        assert got["slots"] == want["slots"], (shape, r)


@pytest.mark.parametrize("name", ["qwen3moe", "llama4", "jamba"])
def test_aux_loss_over_the_data_axis_is_the_whole_batchs(ranks, name):
    """On (2, 1) each rank routes half the rows; the load-balancing loss
    is still the whole batch's, JAX's and the one-rank run's, not a mean
    of the halves' products."""
    _, jaux, _ = ranks["ref"][name]
    _, ometrics, _ = ranks["one"][name]
    cfg, m, whole = _values(ranks["inits"], name)
    halves = []
    for half in (slice(0, BATCH // 2), slice(BATCH // 2, BATCH)):
        batch = {k: v[half] for k, v in _torch_batch(cfg).items()}
        halves.append(float(m.loss(whole, batch)[1]["aux"]))
    for r, out in enumerate(ranks["got"][(2, 1)]):
        aux = float(out["lm"][name][1]["aux"])
        assert abs(aux - float(ometrics["aux"])) < AUX_ATOL, r
        assert abs(aux - jaux) < AUX_ATOL, r
        assert abs(aux - sum(halves) / 2) > 100 * AUX_ATOL, (aux, halves)


def test_each_rank_holds_its_blocks(ranks):
    """On (1, 2) a rank holds half the experts, mLSTM and mamba workers
    and attention heads; sLSTM, the router and the frontend stay whole."""
    got = ranks["got"][(1, 2)][0]["lm"]
    whole = {name: tree.map(lambda a: a.shape, ranks["inits"][name])
             for name in NAMES}

    def halved(name, *path):
        mine, all_ = got[name][3], whole[name]
        for k in path:
            mine, all_ = mine[k], all_[k]
        return mine[1] * 2 == all_[1] and mine[2:] == all_[2:]

    assert halved("qwen3moe", "blocks", "pos0", "ffn", "w_up")
    assert halved("llama4", "blocks", "pos0", "ffn", "w_down")
    assert halved("llama4", "blocks", "pos0", "ffn", "shared", "w_up")
    assert halved("xlstm", "blocks", "pos0", "mixer", "w_v")
    assert halved("xlstm", "blocks", "pos0", "mixer", "w_down")
    assert halved("jamba", "blocks", "pos0", "mixer", "A_log")
    assert halved("jamba", "blocks", "pos0", "mixer", "D")
    assert halved("whisper", "blocks", "pos0", "cross", "wo")
    assert got["xlstm"][3]["blocks"]["pos3"]["mixer"]["r"] == \
        whole["xlstm"]["blocks"]["pos3"]["mixer"]["r"]
    assert got["qwen3moe"][3]["blocks"]["pos0"]["ffn"]["router"] == \
        whole["qwen3moe"]["blocks"]["pos0"]["ffn"]["router"]
    assert got["pixtral"][3]["embed"]["frontend_proj"] == \
        whole["pixtral"]["embed"]["frontend_proj"]


@pytest.mark.parametrize("family", sorted(CONTROLS))
def test_control_fault_misses_the_limits(ranks, family):
    """Each family's input outside the *f* copy keeps a rank's share of
    some replicated leaf's gradient: the gathered gradients leave JAX's
    limit, while the sound run (above) keeps it."""
    name = CONTROLS[family][0]
    jloss, _, jgrads = ranks["ref"][name]
    for r, out in enumerate(ranks["got"][(1, 2)]):
        loss, grads = out["controls"][family]
        assert abs(float(loss) - jloss) < LOSS_ATOL, r   # forward is sound
        assert _grad_gaps(grads, jgrads) > GRAD_ATOL, (family, r)


@pytest.mark.parametrize("name", ["qwen3moe", "llama4"])
def test_moe_layer_over_experts_is_bitwise_the_one_rank_layer(ranks, name):
    """Each rank runs its 4 (2) of 8 (4) experts; the gathered slot
    outputs go through the one-device combine, so the output and the aux
    loss are bitwise the one-rank layer's and so are the experts'
    gradients (no sum over ranks reaches them).  The input's and the
    shared expert's gradients add the ranks' shares over the group, in
    another order, within float32 roundings."""
    y1, aux1, gx1, gp1 = ranks["moe"][name]
    cfg = _cfg(name)
    for r, out in enumerate(ranks["got"][(1, 2)]):
        y, aux, gx, gp, local = out["moe"][name]
        assert local[0] * 2 == cfg.n_experts
        assert torch.equal(y, y1) and torch.equal(aux, aux1), r
        for k in ("w_up", "w_gate", "w_down", "router"):
            assert torch.equal(gp[k], gp1[k]), (k, r)
        torch.testing.assert_close(gx, gx1, rtol=1e-5, atol=1e-6)
        assert _grad_gaps(gp, gp1) < 1e-5


# ---------------------------------------------------------------------------
# serving and restore
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", SERVED)
def test_engine_on_a_mesh_is_the_one_rank_engine(ranks, shape, name):
    """Tokens, latency ticks, slots, bits, degraded tokens and retry
    ticks of every request equal the one-rank engine's, under OCS and
    under bursts and outages with retry(2) (the copy-on-hold of the
    recurrent states on the rank's blocks)."""
    want = ranks["serve"][name]
    assert any(c[-1] > 0 for c in want["retry"].values())
    for r, out in enumerate(ranks["got"][shape]):
        assert out["serve"][name] == want, (shape, r)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", ["whisper", "pixtral"])
def test_model_api_serving_on_a_mesh(ranks, shape, name):
    """A prefill and greedy ``decode_step_channel`` ticks: the tokens and
    the channel slots equal the one-rank run's, the last logits within
    float32 roundings."""
    want = ranks["serve"][name]
    assert sum(want["slots"]) > 0
    for r, out in enumerate(ranks["got"][shape]):
        got = out["serve"][name]
        assert torch.equal(got["tokens"], want["tokens"]), (shape, r)
        assert got["slots"] == want["slots"], (shape, r)
        torch.testing.assert_close(got["logits"], want["logits"],
                                   rtol=1e-5, atol=1e-5)


def test_expert_split_checkpoint_restores_on_the_other_mesh(ranks):
    whole = tree.map(torch.from_numpy, ranks["inits"]["qwen3moe"])
    for r, out in enumerate(ranks["got"][(2, 1)]):
        got = out["ckpt"]["restored"]
        assert all(torch.equal(a, b) for a, b in zip(
            tree.leaves(got), tree.leaves(whole))), r

