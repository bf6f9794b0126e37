"""Split placements of a decode cache over ``torch.distributed`` ranks: a
rank holds its rows of the cache (a data split of the batch) or its block
of every row's positions (the ``kv_seq`` split of the long-context
rules), as the JAX package's ``CACHE_AXES`` place it, against the port's
one-rank runs and the JAX package's one-device ``decode_step``.

Three gloo worlds are spawned at once with ``comm.spawn``, while the
parent runs the one-rank and JAX references:

- (2, 1) under ``launch.mesh.rules_for("long_500k")``: reduced qwen1.5,
  jamba, xlstm and whisper prefill a 6-token prompt into a 16-position
  cache (8 positions a rank) and decode 12 greedy ticks, so that the
  writes cross into rank 1's block and the last ones clamp to the cache's
  end.  The tokens equal the one-rank run's and JAX's; the float32
  logits lie within ``SPLIT_RTOL`` of their largest magnitude of the
  one-rank run's (the softmax's sums add in another order) and within
  ``FLOAT_TOL`` of JAX's.  A control fault (rank 1's denominators left
  unreduced) must miss ``SPLIT_RTOL``.
- (2, 1) and (2, 2) under the default rules, a data split of the rows:
  each rank's cache leaves hold exactly its rows; on (2, 1) a rank's
  decode is bitwise the one-device decode of its rows alone; on (2, 2),
  where the heads split too, within ``tests/test_torch_tp_models.py``'s
  limits; the engine under OCS and under bursts with ``retry(2)`` equals
  the one-rank engine field by field.

The JAX package is imported inside the fixtures and tests, so the rank
processes, which import this module to find their task, load no JAX.
"""

import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import random as jr
from repro_torch import tree
from repro_torch.configs import get_reduced
from repro_torch.faults import DegradePolicy, FaultModel
from repro_torch.launch import mesh as tmesh
from repro_torch.models import attention
from repro_torch.models import model as M
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as sh
from repro_torch.protocol import Protocol
from repro_torch.serve import engine as se

torch.set_num_threads(1)

RANK_TIMEOUT = 60.0
# tests/test_torch_models.py's decode parity with JAX: the two packages
# multiply and reduce in other orders, a few float32 ulp an operation
FLOAT_TOL = dict(rtol=1e-5, atol=1e-5)
# and tests/test_torch_ssm.py's for the recurrent models: the time scans
# carry those ulp gaps from step to step
SCAN_TOL = dict(rtol=1e-5, atol=5e-5)
# the split-softmax decode against the one-rank decode: the largest
# logit difference over the largest logit magnitude.  The maxima are
# exact; the denominators and the products P.V add the two blocks' sums
# in another order (a few float32 roundings, ~1e-7 of the logits); a
# block's denominator left unreduced moves them by ~1e-1
SPLIT_RTOL = 1e-5
# tests/test_torch_tp_models.py's limits for a mesh that splits the heads
ONE_RANK_TOL = dict(rtol=1e-5, atol=1e-5)
CACHE, PROMPT, TICKS, ROWS = 16, 6, 12, 2
LONG = ("qwen1.5-0.5b", "jamba-1.5-large-398b", "xlstm-125m", "whisper-base")
JAX_TOL = {"qwen1.5-0.5b": FLOAT_TOL, "jamba-1.5-large-398b": SCAN_TOL,
           "xlstm-125m": SCAN_TOL, "whisper-base": FLOAT_TOL}
# the rows split: 4 rows over the data axis
ROW_ARCHS = ("qwen1.5-0.5b", "jamba-1.5-large-398b")
ROW_BATCH = 4
SERVE_KW = dict(batch_slots=4, max_seq=24, eos_id=-1, seed=5)
MESHES = [("long", (2, 1)), ("rows", (2, 1)), ("rows", (2, 2))]


def _cfg(arch):
    return get_reduced(arch, n_workers=4, tp_fusion="max")


def _whole(arch):
    m = M.build(_cfg(arch))
    return m, m.init(torch.Generator().manual_seed(0))


def _batch(cfg, rows, seed=0):
    """The prompt (and whisper's 16 frames) as numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (rows, PROMPT))
           .astype(np.int32)}
    if cfg.encoder_decoder:
        out["feats"] = rng.standard_normal(
            (rows, CACHE, cfg.frontend_dim)).astype(np.float32)
    return out


def _decode(m, values, batch, channel=False):
    """Greedy tokens, every step's logits (the prefill's first) and the
    cache after a prefill and ``TICKS`` decode steps (with ``channel``
    ``decode_step_channel`` under OCS p 0.05, and its slots)."""
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    rows = batch["tokens"].shape[0]
    logits, cache = m.prefill(values, batch, max_seq=CACHE)
    pos = torch.full((rows,), PROMPT, dtype=torch.int32)
    toks, seq, slots = [], [logits], []
    proto = Protocol.ocs(bits=8, p_miss=0.05)
    for t in range(TICKS):
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        if channel:
            logits, cache, chan = m.decode_step_channel(
                values, tok, pos + t, cache, proto, jr.PRNGKey(t))
            slots.append(int(chan["contention_slots"]))
        else:
            logits, cache = m.decode_step(values, tok, pos + t, cache)
        toks.append(tok)
        seq.append(logits)
    return dict(tokens=torch.cat(toks, 1), logits=torch.stack(seq),
                cache=cache, slots=slots)


def _rel_err(got, want) -> float:
    """The largest |got - want| over the largest |want|; infinite where
    ``got`` is not finite."""
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float((got - want).abs().max() / want.abs().max())


# ---------------------------------------------------------------------------
# the rank tasks
# ---------------------------------------------------------------------------

def _split_denominators(x, seq):
    """The control fault: rank 1 keeps its own block's denominators (the
    collective still runs, so the ranks stay in step)."""
    total = comm.all_reduce(x, "sum", seq.group)
    return x if seq.index == 1 else total


def _long_on_ranks(mesh) -> dict:
    rules = tmesh.rules_for("long_500k", ROWS, mesh)
    out = {}
    with sh.use_mesh(mesh, rules):
        out["seq_axis"] = (sh.kv_seq_axis().size, sh.kv_seq_axis().index)
        for arch in LONG:
            m, whole = _whole(arch)
            mine = sh.shard_values(whole, m.axes(), mesh, rules)
            with comm.recording() as rec:
                got = _decode(m, mine, _batch(m.cfg, ROWS))
            got["collectives"] = comm.summarize(rec)
            out[arch] = got
        m, whole = _whole(LONG[0])
        out["channel"] = _decode(m, sh.shard_values(whole, m.axes(), mesh,
                                                    rules),
                                 _batch(m.cfg, ROWS), channel=True)
        sound = attention._seq_sum
        attention._seq_sum = _split_denominators
        try:
            m, whole = _whole(LONG[0])
            out["control"] = _decode(m, sh.shard_values(
                whole, m.axes(), mesh, rules), _batch(m.cfg, ROWS))["logits"]
        finally:
            attention._seq_sum = sound
    return out


def _fault():
    return FaultModel.burst(burst_len=4, gap_len=16, p_miss_bad=0.5,
                            p_miss_good=0.01,
                            policy=DegradePolicy.retry(2)).with_dropout(
                                0.5, 0.3)


def _requests(vocab):
    rng = np.random.default_rng(6)
    return [se.Request(rid=i, prompt=rng.integers(0, vocab, 3 + 2 * (i % 2))
                       .astype(np.int32), max_new_tokens=4 + (i % 3),
                       arrival_tick=(0, 0, 1, 4, 12, 12)[i])
            for i in range(6)]


def _serve(m, values) -> dict:
    """{case: {rid: every field}} under OCS p 0.05, plain and under bursts
    and outages with retry(2)."""
    eng = se.ServeEngine(m, values, se.ServeConfig(**SERVE_KW), device="cpu")
    proto = Protocol.ocs(bits=8, p_miss=0.05)
    out = {}
    for case, fault in (("ocs", None), ("retry", _fault())):
        got = eng.run(_requests(m.cfg.vocab_size), protocol=proto,
                      fault=fault)
        out[case] = {rid: dataclasses.astuple(c) for rid, c in got.items()}
    out["cache_shapes"] = [tuple(t.shape) for t in tree.leaves(eng.cache)]
    return out


def _rows_on_ranks(mesh) -> dict:
    out = {}
    rows = sh.mesh_axis(mesh, "data")
    with sh.use_mesh(mesh):
        for arch in ROW_ARCHS:
            m, whole = _whole(arch)
            mine = sh.shard_values(whole, m.axes(), mesh)
            batch = _batch(m.cfg, ROW_BATCH, seed=1)
            got = _decode(m, mine, batch)
            got["serve"] = _serve(m, mine)
            out[arch] = got
    if mesh.shape["model"] == 1:
        # the one-device decode of this rank's rows alone, no mesh
        for arch in ROW_ARCHS:
            m, whole = _whole(arch)
            mine = {k: sh.split_dim(torch.from_numpy(v), rows).numpy()
                    for k, v in _batch(m.cfg, ROW_BATCH, seed=1).items()}
            out[arch]["alone"] = _decode(m, whole, mine)
    return out


def _rank_task(kind, shape) -> dict:
    mesh = tmesh.make_mesh(*shape)
    out = {"coord": mesh.coord()}
    if kind == "long":
        out.update(_long_on_ranks(mesh))
    else:
        out.update(_rows_on_ranks(mesh))
    return out


# ---------------------------------------------------------------------------
# the references and the spawns
# ---------------------------------------------------------------------------

def _jax_decode(arch, values, batch) -> dict:
    """The JAX package's one-device prefill and ``TICKS`` greedy
    ``decode_step``s at the numpy ``values`` and ``batch``."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced as jget
    from repro.models import model as JM
    jm = JM.build(jget(arch, n_workers=4, tp_fusion="max"))
    v = tree.map(jnp.asarray, values)
    logits, cache = jm.prefill(v, {k: jnp.asarray(x) for k, x in
                                   batch.items()}, max_seq=CACHE)
    step = jax.jit(jm.decode_step)
    pos = jnp.full((batch["tokens"].shape[0],), PROMPT, jnp.int32)
    toks, seq = [], [logits]
    for t in range(TICKS):
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        logits, cache = step(v, tok, pos + t, cache)
        toks.append(np.asarray(tok))
        seq.append(logits)
    return dict(tokens=np.concatenate(toks, 1),
                logits=np.stack([np.asarray(x) for x in seq]))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    with concurrent.futures.ThreadPoolExecutor(len(MESHES)) as pool:
        spawned = {(kind, s): pool.submit(
            comm.spawn, _rank_task, s[0] * s[1], (kind, s),
            workdir=tmp_path_factory.mktemp(f"{kind}{s[0]}x{s[1]}"),
            timeout=RANK_TIMEOUT) for kind, s in MESHES}
        one, jax_ref = {}, {}
        for arch in LONG:
            m, whole = _whole(arch)
            batch = _batch(m.cfg, ROWS)
            one[arch] = _decode(m, whole, batch)
            jax_ref[arch] = _jax_decode(
                arch, tree.map(lambda t: t.numpy(), whole), batch)
        m, whole = _whole(LONG[0])
        one["channel"] = _decode(m, whole, _batch(m.cfg, ROWS), channel=True)
        rows = {}
        for arch in ROW_ARCHS:
            m, whole = _whole(arch)
            rows[arch] = _decode(m, whole, _batch(m.cfg, ROW_BATCH, seed=1))
            rows[arch]["serve"] = _serve(m, whole)
        got = {k: f.result() for k, f in spawned.items()}
    return dict(got=got, one=one, jax=jax_ref, rows=rows)


# ---------------------------------------------------------------------------
# the kv_seq split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LONG)
def test_kv_seq_split_decode_matches_one_rank_and_jax(worlds, arch):
    """Prefill and 12 ticks over a cache whose 16 positions lie 8 a rank:
    the tokens equal the one-rank run's and JAX's, the float32 logits
    within ``SPLIT_RTOL`` of the one-rank run's and the decode parity
    tolerance (``JAX_TOL``) of JAX's, on every rank."""
    one, ref = worlds["one"][arch], worlds["jax"][arch]
    np.testing.assert_array_equal(one["tokens"].numpy(), ref["tokens"])
    np.testing.assert_allclose(one["logits"].numpy(), ref["logits"],
                               **JAX_TOL[arch])
    for r, out in enumerate(worlds["got"][("long", (2, 1))]):
        assert out["seq_axis"] == (2, r)
        got = out[arch]
        assert torch.equal(got["tokens"], one["tokens"]), r
        assert _rel_err(got["logits"], one["logits"]) <= SPLIT_RTOL, r
        np.testing.assert_allclose(got["logits"].numpy(), ref["logits"],
                                   **JAX_TOL[arch])


def test_kv_seq_split_channel_ticks_match_one_rank(worlds):
    """``decode_step_channel`` under OCS p 0.05 over the split cache: the
    tokens and every tick's channel slots equal the one-rank run's, the
    logits within ``SPLIT_RTOL``."""
    one = worlds["one"]["channel"]
    assert sum(one["slots"]) > 0
    for r, out in enumerate(worlds["got"][("long", (2, 1))]):
        got = out["channel"]
        assert torch.equal(got["tokens"], one["tokens"]), r
        assert got["slots"] == one["slots"], r
        assert _rel_err(got["logits"], one["logits"]) <= SPLIT_RTOL, r


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "jamba-1.5-large-398b",
                                  "whisper-base"])
def test_kv_seq_split_cache_holds_a_rank_block(worlds, arch):
    """Every attention cache leaf (whisper's cross cache too) holds 8 of
    its 16 positions, and the block is the one-rank cache's positions of
    this rank, after writes that crossed the boundary and clamped at the
    end; recurrent states stay whole; each rank reduces over the group."""
    one = worlds["one"][arch]
    cfg = _cfg(arch)
    for r, out in enumerate(worlds["got"][("long", (2, 1))]):
        got = out[arch]
        for g, w in zip(tree.leaves(got["cache"]), tree.leaves(one["cache"])):
            if g.shape == w.shape:
                torch.testing.assert_close(g, w, **FLOAT_TOL)
                continue
            assert g.ndim == 5 and g.shape[-2:] == (cfg.n_kv_heads,
                                                     cfg.head_dim_)
            assert g.shape[2] * 2 == w.shape[2]
            block = w.narrow(2, r * g.shape[2], g.shape[2])
            torch.testing.assert_close(g, block, **FLOAT_TOL)
        assert {"all_reduce.max float32", "all_reduce.sum float32"} <= \
            set(got["collectives"])


def test_kv_seq_split_control_fault_misses_the_limit(worlds):
    """Rank 1's denominators of its own block only: its softmax is not
    normalized over the sequence (0/0 while its block holds no valid
    key), and every rank's combined P.V takes its partial."""
    one = worlds["one"][LONG[0]]
    errs = [_rel_err(out["control"], one["logits"])
            for out in worlds["got"][("long", (2, 1))]]
    assert max(errs) > SPLIT_RTOL, errs


# ---------------------------------------------------------------------------
# the rows split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
@pytest.mark.parametrize("arch", ROW_ARCHS)
def test_each_rank_cache_holds_its_rows(worlds, shape, arch):
    """The prefill's and the engine's cache leaves hold the rank's 2 of 4
    rows (the engine's 2 of its 4 slots) along each leaf's batch axis."""
    cfg = _cfg(arch)
    one = worlds["rows"][arch]["cache"]
    rows = M.cache_rows(cfg, one)
    for r, out in enumerate(worlds["got"][("rows", shape)]):
        got = out[arch]
        serve_shapes = got["serve"]["cache_shapes"]
        for g, w, axis, eng in zip(tree.leaves(got["cache"]),
                                   tree.leaves(one), tree.leaves(rows),
                                   serve_shapes):
            assert g.shape[axis] * 2 == w.shape[axis] == ROW_BATCH, (arch, r)
            assert eng[axis] == SERVE_KW["batch_slots"] // 2


@pytest.mark.parametrize("arch", ROW_ARCHS)
def test_rows_split_decode_is_the_one_device_decode_of_its_rows(worlds,
                                                                arch):
    """On (2, 1) a rank's cache, and its rows of the gathered logits, are
    bitwise the one-device decode of those rows alone; the tokens are the
    whole run's."""
    one = worlds["rows"][arch]
    for r, out in enumerate(worlds["got"][("rows", (2, 1))]):
        got, alone = out[arch], out[arch]["alone"]
        mine = slice(r * 2, r * 2 + 2)
        assert torch.equal(got["tokens"], one["tokens"])
        assert torch.equal(got["logits"][:, mine], alone["logits"]), r
        assert all(torch.equal(a, b) for a, b in zip(
            tree.leaves(got["cache"]), tree.leaves(alone["cache"]))), r


@pytest.mark.parametrize("arch", ROW_ARCHS)
def test_rows_and_heads_split_decode_holds_the_one_rank_limits(worlds,
                                                               arch):
    """On (2, 2) the heads and workers split as well: tokens equal, the
    logits within the one-rank limits, each rank's cache the block of the
    one-rank cache (``sharding.shard_values``' cut of it, the block
    ``model.cache_init`` allocates) within them."""
    one = worlds["rows"][arch]
    cfg = _cfg(arch)
    for r, out in enumerate(worlds["got"][("rows", (2, 2))]):
        got = out[arch]
        assert torch.equal(got["tokens"], one["tokens"]), r
        torch.testing.assert_close(got["logits"], one["logits"],
                                   **ONE_RANK_TOL)
        mesh = _coord_mesh(out["coord"], (2, 2))
        block = sh.shard_values(one["cache"], M.cache_axes(cfg), mesh,
                                sh.DEFAULT_RULES)
        for g, w in zip(tree.leaves(got["cache"]), tree.leaves(block)):
            assert g.shape == w.shape
            torch.testing.assert_close(g, w, **ONE_RANK_TOL)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
@pytest.mark.parametrize("arch", ROW_ARCHS)
def test_engine_on_rank_rows_is_the_one_rank_engine(worlds, shape, arch):
    """Every field of every request, under OCS and under bursts and
    outages with retry(2), equals the one-rank engine's on every rank."""
    want = worlds["rows"][arch]["serve"]
    assert any(c[-1] > 0 for c in want["retry"].values())
    for r, out in enumerate(worlds["got"][("rows", shape)]):
        got = out[arch]["serve"]
        assert got["ocs"] == want["ocs"], (shape, r)
        assert got["retry"] == want["retry"], (shape, r)


def _coord_mesh(coord, shape):
    """A duck-typed mesh at ``coord`` of ``shape``, for the pure block
    functions in this process."""
    import types
    names = ("data", "model")
    return types.SimpleNamespace(
        axis_names=names, devices=np.empty(shape),
        axis_index=lambda name: coord[names.index(name)],
        group=lambda name: None)
