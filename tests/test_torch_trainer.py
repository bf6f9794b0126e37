"""The port's LM data side, loss, schedules, compressed train step, trainer
and training launcher against the JAX package, and the contracts of
``tests/test_trainer.py`` and the trainer tests of ``tests/test_faults.py``
and ``tests/test_train_curves.py`` on the port.

Both packages start from the same parameters (the JAX package's, carried
across by ``convert``) at ``tests/test_trainer.py``'s reduced qwen fixture
(2 layers, d_model 32, vocab 128, batch 8 x seq 16).  Held bit for bit:
the pipeline's batches (both are numpy's draws), the per-step channel
keys, the compressed step's payload bits and kept counts, the fault
carry's chains, and a resumed run against an uninterrupted one.  Losses,
gradients' effects and parameters are held within tolerances, for one
reason: the matmuls' float32 sums run in another order in XLA than in
PyTorch (~1e-7 relative a sum).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import faults as jf
from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.core import vertical as jvert
from repro.data import pipeline as jpipe
from repro.models import model as JM
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.parallel.sharding import split_tree
from repro.protocol import Protocol as JP
from repro.train import trainer as jtrainer
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch import faults as tf
from repro_torch import random as jr
from repro_torch import tree
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import params_from_jax
from repro_torch.core import vertical as tvert
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import model as TM
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.protocol import Protocol as TP
from repro_torch.train import trainer
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import TrainerConfig

torch.set_num_threads(1)

ARCH = "qwen1.5-0.5b"
FIXTURE = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
               vocab_size=128, n_workers=2)
# float32 sums in another order: a loss of ~25 within 1e-5 relative, a
# parameter within 1e-4 after a few AdamW steps of lr <= 1e-2
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4


@pytest.fixture(scope="module")
def lm():
    """(JAX model, JAX values, port model, port values, JAX pipeline
    config, port pipeline config) at the fixture."""
    jm = JM.build(j_get_reduced(ARCH, **FIXTURE))
    jv, _ = split_tree(jm.init(jax.random.PRNGKey(0)))
    tm = TM.build(get_reduced(ARCH, **FIXTURE))
    tv = params_from_jax(jax.tree.map(np.asarray, jv))
    return (jm, jv, tm, tv, jpipe.for_model(jm.cfg, batch=8, seq_len=16,
                                            seed=1),
            tpipe.for_model(tm.cfg, batch=8, seq_len=16, seed=1))


def _tdata(pcfg):
    return lambda s: tpipe.batch_for_step(pcfg, s, device="cpu")


def _topt(steps):
    return topt.adamw(tsched.linear_warmup_cosine(3e-3, 3, steps))


def _jopt(steps):
    return jopt.adamw(jsched.linear_warmup_cosine(3e-3, 3, steps))


def _assert_close(port_tree, jax_tree, atol):
    a, b = tree.leaves(port_tree), jax.tree.leaves(jax_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.float().numpy(),
                                   np.asarray(y, np.float32), atol=atol,
                                   rtol=0)


def _assert_bitwise(a, b):
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _assert_bitwise(getattr(a, f.name), getattr(b, f.name))
        return
    la, lb = tree.leaves(a), tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _rows(history, first_step=0):
    return [{k: v for k, v in r.items() if k != "step_time_s"}
            for r in history if r["step"] >= first_step]


# -- data/pipeline ----------------------------------------------------------

@pytest.mark.parametrize("frontend,decoder_len", [
    ("token", 0), ("patch", 0), ("audio", 6)])
def test_pipeline_batches_match_jax_bitwise(frontend, decoder_len):
    kw = dict(vocab_size=97, batch=3, seq_len=11, seed=5, frontend=frontend,
              frontend_dim=0 if frontend == "token" else 4,
              decoder_len=decoder_len)
    jc, tc_ = jpipe.PipelineConfig(**kw), tpipe.PipelineConfig(**kw)
    for step in (0, 1, 17):
        want = jpipe.batch_for_step(jc, step)
        got = tpipe.batch_for_step(tc_, step, device="cpu")
        assert sorted(got) == sorted(want)
        for k in want:
            w = np.asarray(want[k])
            assert got[k].numpy().dtype == w.dtype
            assert np.array_equal(got[k].numpy(), w), (step, k)


def test_for_model_matches_jax():
    for batch, seq in ((8, 256), (2, 16)):
        want = jpipe.for_model(j_get_config(ARCH), batch, seq, seed=3)
        got = tpipe.for_model(get_config(ARCH), batch, seq, seed=3)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert TM.WHISPER_DECODER_LEN == JM.WHISPER_DECODER_LEN


# -- optim/schedules.for_arch -------------------------------------------------

@pytest.mark.parametrize("arch", [ARCH, "minicpm-2b"])
@pytest.mark.parametrize("total", [6, 50, 2000])
def test_for_arch_lr_matches_jax(arch, total):
    """The same schedule (WSD for minicpm, warmup-cosine otherwise) in
    float32: within one ulp of the lr plus one ulp of the cosine carried
    through ``lr * (1 - final_frac) / 2 * (1 + cos)``: torch's and XLA's
    ``cos`` round an ulp apart, and near the end of the decay ``1 + cos``
    cancels, which makes that ulp up to ~4 ulps of the lr (2 seen)."""
    lr, final_frac = 3e-3, (0.01 if arch == "minicpm-2b" else 0.1)
    jf_, tf_ = jsched.for_arch(arch, lr, total), tsched.for_arch(
        arch, lr, total)
    steps = np.arange(total + 2, dtype=np.float32)
    want = np.asarray(jax.vmap(jf_)(jnp.asarray(steps)))
    got = np.asarray([float(tf_(torch.tensor(s))) for s in steps],
                     np.float32)
    eps = np.finfo(np.float32).eps
    bound = np.spacing(want) + lr * (1 - final_frac) / 2 * eps
    assert np.all(np.abs(got - want) <= bound), np.abs(got - want) / bound
    warm = max(total // 100, 10)
    assert np.array_equal(got[:warm + 1], want[:warm + 1])  # the warmup


# -- models/model.loss_fn -------------------------------------------------------

@pytest.mark.parametrize("fusion", ["sum", "max"])
@pytest.mark.parametrize("use_flash", [False, True])
def test_loss_fn_matches_jax(lm, fusion, use_flash):
    jm, jv, _, tv, jpc, tpc = lm
    jcfg = jm.cfg.with_(tp_fusion=fusion, use_flash=use_flash)
    tm = TM.build(get_reduced(ARCH, tp_fusion=fusion, use_flash=use_flash,
                              **FIXTURE))
    for step in (0, 3):
        jb = jpipe.batch_for_step(jpc, step)
        want_loss, want = jax.jit(lambda v, b: JM.loss_fn(jcfg, v, b))(jv,
                                                                       jb)
        got_loss, got = tm.loss(tv, tpipe.batch_for_step(tpc, step,
                                                         device="cpu"))
        assert sorted(got) == sorted(want) == ["aux", "loss", "nll"]
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=LOSS_RTOL, atol=1e-6)
        assert float(got_loss) == float(got["loss"])


def test_xent_chunks_add_up_in_order():
    """A loss_chunk that divides the sequence gives the single chunk's
    loss within float32 rounding; one that does not is the whole
    sequence (the JAX package's rule)."""
    cfg = get_reduced(ARCH, **FIXTURE)
    v = TM.init(cfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 12, 32), generator=gen)
    t = torch.randint(0, 128, (2, 12), generator=gen)
    whole = TM._xent(cfg.with_(loss_chunk=12), v, x, t)
    assert float(TM._xent(cfg.with_(loss_chunk=5), v, x, t)) == float(whole)
    np.testing.assert_allclose(float(TM._xent(cfg.with_(loss_chunk=4), v, x,
                                              t)), float(whole), rtol=1e-6)
    # the gold gather's scatter backward is the gather's gradient
    logits = torch.randn((3, 4, 9), generator=gen, requires_grad=True)
    idx = torch.randint(0, 9, (3, 4, 1), generator=gen)
    g = torch.randn((3, 4, 1), generator=gen)
    (TM._Gold.apply(logits, idx) * g).sum().backward()
    want = torch.zeros_like(logits).scatter_add_(-1, idx, g)
    assert torch.equal(logits.grad, want)


# -- the per-step keys and the compressed train step ------------------------

def test_step_keys_bitwise():
    for seed in (0, 7, 11):
        want = np.asarray(jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
            jax.random.PRNGKey(seed), jnp.arange(40)))
        base = jr.PRNGKey(seed)
        got = np.stack([jr.fold_in(base, s).numpy() for s in range(40)])
        assert np.array_equal(got.astype(np.uint32), want)


_VCFG = dict(n_workers=3, input_dim=6, encoder_dims=(8,), embed_dim=4,
             head_dims=(8,), output_dim=3, task="classification")


@pytest.mark.parametrize("compress_k", [None, 0.25])
@pytest.mark.parametrize("with_rng", [False, True])
def test_make_train_step_variants_match_jax(compress_k, with_rng):
    """All four contracts: with or without the rng, with or without the
    compressed reduce (the error memory carried two steps); payload bits
    and kept counts bitwise, the rest within the float-order tolerance."""
    if with_rng:
        jcfg = jvert.VerticalConfig(**_VCFG, aggregation=JP.ocs(
            8, p_miss=jnp.float32(0.1)))
        tcfg = tvert.VerticalConfig(**_VCFG, aggregation=TP.ocs(
            8, p_miss=torch.tensor(0.1)))
    else:
        jcfg = jvert.VerticalConfig(**_VCFG, aggregation="max")
        tcfg = tvert.VerticalConfig(**_VCFG, aggregation="max")
    jparams = jvert.init(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(0)
    views = rng.standard_normal((3, 8, 6)).astype(np.float32)
    labels = rng.integers(0, 3, (8,)).astype(np.int32)
    jbatch = (jnp.asarray(views), jnp.asarray(labels))
    tbatch = (torch.from_numpy(views), torch.from_numpy(labels))

    def jloss(p, b, *key):
        return jvert.loss_fn(jcfg, p, *b, rng=key[0] if key else None)

    def tloss(p, b, *key):
        return tvert.loss_fn(tcfg, p, *b, rng=key[0] if key else None)

    jo, to = _jopt(4), _topt(4)
    jstep = jax.jit(j_make_train_step(jloss, jo, compress_k=compress_k,
                                      with_rng=with_rng))
    tstep = make_train_step(tloss, to, compress_k=compress_k,
                            with_rng=with_rng)
    jstate = (jparams, jo.init(jparams))
    tstate = (tparams, to.init(tparams))
    jerr = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jparams)
    terr = tree.map(lambda p: torch.zeros(p.shape), tparams)
    for s in range(2):
        jargs, targs = jstate + (jbatch,), tstate + (tbatch,)
        if with_rng:
            jargs += (jax.random.fold_in(jax.random.PRNGKey(3), s),)
            targs += (jr.fold_in(jr.PRNGKey(3), s),)
        if compress_k is None:
            *jstate, jm = jstep(*jargs)
            *tstate, tm = tstep(*targs)
        else:
            *jstate, jerr, jm = jstep(*jargs, jerr)
            *tstate, terr, tm = tstep(*targs, terr)
            for k in ("dp_payload_bits", "dp_kept_elems"):
                assert int(tm[k]) == int(jm[k]), k
            _assert_close(terr, jerr, PARAM_ATOL)
        jstate, tstate = tuple(jstate), tuple(tstate)
        assert sorted(tm) == sorted(jm)
        for k in ("loss_mean", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, atol=1e-6)
        _assert_close(tstate[0], jstate[0], PARAM_ATOL)


_OPTS = {
    "adamw": lambda: topt.adamw(tsched.linear_warmup_cosine(3e-3, 2, 6)),
    "adamw bf16 moments, no clip": lambda: topt.adamw(
        tsched.linear_warmup_cosine(3e-3, 2, 6), max_grad_norm=None,
        moment_dtype=torch.bfloat16),
    "adamw clipped hard": lambda: topt.adamw(lambda s: 1e-2 + 0 * s,
                                             max_grad_norm=1e-3),
    "sgd": lambda: topt.sgd(lambda s: 1e-2 + 0 * s, max_grad_norm=0.5),
}


def _moving_state(state):
    """The optimizer state's leaves a step rewrites (the CPU step counter
    is rebound, not written)."""
    return tree.leaves({k: v for k, v in state.items() if k != "step"})


@pytest.mark.parametrize("opt", sorted(_OPTS))
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_step_writes_into_its_carries(lm, opt, param_dtype):
    """``make_train_step`` donates its carries, as the JAX trainer does:
    each of 4 steps writes the new parameters and optimizer state into the
    tensors it was given and returns those tensors, with the values
    ``opt.update`` gives on copies, bit for bit."""
    _, _, tm, tv, _, tpc = lm
    o = _OPTS[opt]()
    step = make_train_step(tm.loss, o)
    dt = getattr(torch, param_dtype)
    values = tree.map(lambda t: t.to(dt, copy=True), tv)
    state = o.init(values)
    for s in range(4):
        batch = _tdata(tpc)(s)
        leaves = [x.detach().requires_grad_(True)
                  for x in tree.leaves(values)]
        loss, _ = tm.loss(tree.unflatten(values, leaves), batch)
        grads = tree.unflatten(values, list(torch.autograd.grad(loss,
                                                                leaves)))
        want_v, want_s, _ = o.update(grads, state, values)
        new_v, new_s, metrics = step(values, state, batch)
        assert all(a is b for a, b in zip(tree.leaves(new_v),
                                          tree.leaves(values)))
        assert all(a is b for a, b in zip(_moving_state(new_s),
                                          _moving_state(state)))
        assert int(new_s["step"]) == s + 1
        _assert_bitwise(new_v, want_v)
        _assert_bitwise(new_s, want_s)
        values, state = new_v, new_s


@pytest.mark.parametrize("opt", sorted(_OPTS))
def test_update_leaves_its_inputs_intact(lm, opt):
    """``opt.update`` (the functional form of ``update_inplace``) writes
    nothing it is given, over 3 updates, and returns new tensors."""
    _, _, _, tv, _, _ = lm
    o = _OPTS[opt]()
    gen = torch.Generator().manual_seed(0)
    values = tree.map(torch.clone, tv)
    state = o.init(values)
    for _ in range(3):
        grads = tree.map(lambda t: torch.randn(t.shape, generator=gen),
                         values)
        before = tree.map(torch.clone, (grads, state, values))
        new_v, new_s, _ = o.update(grads, state, values)
        _assert_bitwise((grads, state, values), before)
        assert not any(a is b for a, b in zip(tree.leaves(new_v),
                                              tree.leaves(values)))
        assert not any(a is b for a, b in zip(_moving_state(new_s),
                                              _moving_state(state)))
        values, state = new_v, new_s


def test_unflatten_keeps_no_leaf_alive():
    """``tree.unflatten`` (every step unflattens its gradients) drops its
    hold on the new leaves when it returns, without the cyclic garbage
    collector: a step's gradients, a parameter-sized tree, must not live
    on into the next step."""
    import gc
    import weakref

    structure = {"a": torch.zeros(3), "b": [torch.zeros(2), torch.zeros(1)]}
    new = [torch.ones(3), torch.ones(2), torch.ones(1)]
    refs = [weakref.ref(t) for t in new]
    gc.disable()
    try:
        out = tree.unflatten(structure, new)
        assert out["b"][1] is new[2]
        del new, out
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


# -- train/trainer ---------------------------------------------------------------

def test_trainer_matches_jax(lm):
    """5 compressed trainer steps of each package from one init: the
    history's nll within the float-order tolerance, lr within an ulp,
    payload bits and kept counts equal, parameters within 1e-4."""
    jm, jv, tm, tv, jpc, tpc = lm
    want = jtrainer.train(jm.loss, jv, _jopt(5),
                          lambda s: jpipe.batch_for_step(jpc, s),
                          jtrainer.TrainerConfig(steps=5, log_every=1,
                                                 compress_k=0.25))
    got = trainer.train(tm.loss, tv, _topt(5), _tdata(tpc),
                        TrainerConfig(steps=5, log_every=1, compress_k=0.25))
    assert [r["step"] for r in got.history] == list(range(5))
    assert sorted(got.history[0]) == sorted(want.history[0])
    for a, b in zip(got.history, want.history):
        np.testing.assert_allclose(a["nll"], b["nll"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(a["lr"], b["lr"], rtol=2e-7)
        assert a["dp_payload_bits"] == b["dp_payload_bits"]
        assert a["dp_kept_elems"] == b["dp_kept_elems"]
    _assert_close(got.values, want.values, PARAM_ATOL)
    assert got.final_step == want.final_step == 5


@pytest.mark.parametrize("impl", ["sort_scatter", "gather"])
def test_moe_trainer_matches_jax(impl):
    """5 trainer steps of the reduced qwen3-moe-30b-a3b (8 experts, top 2,
    capacity drops at 16 tokens a sequence) in each package from one
    init: nll, aux and loss within the float-order tolerance, lr within an
    ulp, parameters within 1e-4."""
    kw = dict(vocab_size=128, moe_impl=impl)
    jm = JM.build(j_get_reduced("qwen3-moe-30b-a3b", **kw))
    tm = TM.build(get_reduced("qwen3-moe-30b-a3b", **kw))
    jv, _ = split_tree(jm.init(jax.random.PRNGKey(0)))
    tv = params_from_jax(jax.tree.map(np.asarray, jv))
    jpc = jpipe.for_model(jm.cfg, batch=8, seq_len=16, seed=1)
    tpc = tpipe.for_model(tm.cfg, batch=8, seq_len=16, seed=1)
    want = jtrainer.train(jm.loss, jv, _jopt(5),
                          lambda s: jpipe.batch_for_step(jpc, s),
                          jtrainer.TrainerConfig(steps=5, log_every=1))
    got = trainer.train(tm.loss, tv, _topt(5), _tdata(tpc),
                        TrainerConfig(steps=5, log_every=1))
    assert sorted(got.history[0]) == sorted(want.history[0])
    for a, b in zip(got.history, want.history):
        for k in ("nll", "aux", "loss"):
            np.testing.assert_allclose(a[k], b[k], rtol=LOSS_RTOL)
        np.testing.assert_allclose(a["lr"], b["lr"], rtol=2e-7)
    assert got.history[0]["aux"] > 0
    _assert_close(got.values, want.values, PARAM_ATOL)


def test_loss_decreases(lm):
    _, _, tm, tv, _, tpc = lm
    res = trainer.train(tm.loss, tv, _topt(30), _tdata(tpc),
                        TrainerConfig(steps=30, log_every=5))
    assert res.history[-1]["nll"] < res.history[0]["nll"]


def test_resume_equals_uninterrupted_bitwise(lm, tmp_path):
    """Interrupted at step 3 and relaunched: values, optimizer state and
    history from step 3 on equal an uninterrupted run's bit for bit (the
    compressed step's error memory rides in the checkpoint)."""
    _, _, tm, tv, _, tpc = lm
    kw = dict(log_every=1, compress_k=0.25)
    full = trainer.train(tm.loss, tv, _topt(6), _tdata(tpc),
                         TrainerConfig(steps=6, **kw))
    d = str(tmp_path)
    trainer.train(tm.loss, tv, _topt(6), _tdata(tpc),
                  TrainerConfig(steps=3, ckpt_dir=d, ckpt_every=3, **kw))
    res = trainer.train(tm.loss, tv, _topt(6), _tdata(tpc),
                        TrainerConfig(steps=6, ckpt_dir=d, ckpt_every=3,
                                      **kw))
    assert res.history[0]["step"] == 3
    _assert_bitwise(res.values, full.values)
    _assert_bitwise(res.opt_state, full.opt_state)
    assert _rows(res.history) == _rows(full.history, 3)
    assert (tmp_path / "step_0000000006" / "COMMIT").exists()


def test_final_checkpoint_is_written_once(lm, tmp_path, monkeypatch):
    """A run whose last step falls on ``ckpt_every`` writes that step's
    checkpoint once, not again as the final carry; a run whose last step
    does not still ends with its final carry."""
    _, _, tm, tv, _, tpc = lm
    written = []
    save = trainer.checkpointer.save
    monkeypatch.setattr(trainer.checkpointer, "save",
                        lambda d, step, *a, **k: (written.append(step),
                                                  save(d, step, *a, **k))[1])
    trainer.train(tm.loss, tv, _topt(6), _tdata(tpc),
                  TrainerConfig(steps=6, ckpt_dir=str(tmp_path / "a"),
                                ckpt_every=3, log_every=1))
    assert written == [3, 6]
    written.clear()
    trainer.train(tm.loss, tv, _topt(5), _tdata(tpc),
                  TrainerConfig(steps=5, ckpt_dir=str(tmp_path / "b"),
                                ckpt_every=3, log_every=1))
    assert written == [3, 5]
    assert (tmp_path / "b" / "step_0000000005" / "COMMIT").exists()


# the full training carry of tests/test_faults.py: burst chains, dropout
# mask, stale cache, compressed steps
_FVCFG = dict(n_workers=3, input_dim=6, encoder_dims=(8,), embed_dim=4,
              head_dims=(8,), output_dim=3, task="classification")
_FBATCH = 16


def _fault_setup():
    """(port loss, port params, JAX loss, JAX params, data pair)."""
    jcfg = jvert.VerticalConfig(**_FVCFG, aggregation=JP.ocs(
        8, p_miss=0.0, max_rounds=2))
    tcfg = tvert.VerticalConfig(**_FVCFG, aggregation=TP.ocs(
        8, p_miss=0.0, max_rounds=2))
    kw = dict(burst_len=3.0, gap_len=3.0, p_miss_bad=0.6, p_miss_good=0.0)
    jfm = jf.FaultModel.burst(**kw, policy=jf.DegradePolicy.stale()
                              ).with_dropout(0.3, 0.5)
    tfm = tf.FaultModel.burst(**kw, policy=tf.DegradePolicy.stale()
                              ).with_dropout(0.3, 0.5)

    def jloss(values, batch, rng_aux):
        key, fs = rng_aux
        loss, metrics = jvert.loss_fn(jcfg, values, *batch, rng=key,
                                      fault=jfm, fault_state=fs)
        metrics = dict(metrics)
        metrics["aux_state"] = metrics.pop("fault_state")
        return loss, metrics

    def tloss(values, batch, rng_aux):
        key, fs = rng_aux
        loss, metrics = tvert.loss_fn(tcfg, values, *batch, rng=key,
                                      fault=tfm, fault_state=fs)
        metrics = dict(metrics)
        metrics["aux_state"] = metrics.pop("fault_state")
        return loss, metrics

    jparams = jvert.init(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))

    def batch(step):
        rng = np.random.default_rng([1000, step])
        return (rng.standard_normal((3, _FBATCH, 6)).astype(np.float32),
                rng.integers(0, 3, (_FBATCH,)).astype(np.int32))

    def jdata(step):
        v, y = batch(step)
        return jnp.asarray(v), jnp.asarray(y)

    def tdata(step):
        v, y = batch(step)
        return torch.from_numpy(v), torch.from_numpy(y)

    return tloss, tparams, tdata, jloss, jparams, jdata


def _ftcfg(**kw):
    kw.setdefault("log_every", 1)
    kw.setdefault("channel_rng_seed", 7)
    kw.setdefault("aux_state", tf.init_state(3, (_FBATCH, 4)))
    kw.setdefault("compress_k", 0.5)
    return TrainerConfig(**kw)


def test_fault_carry_resume_bitwise_and_chains_match_jax(tmp_path):
    """tests/test_faults.py's full-carry resume on the port, bitwise
    (values, optimizer state, the FaultState); the uninterrupted run's
    chains (bad, offline, age, consec) bitwise the JAX package's, which
    draws them from the same per-step keys, and its losses within the
    float-order tolerance."""
    tloss, tparams, tdata, jloss, jparams, jdata = _fault_setup()
    steps = 8
    full = trainer.train(tloss, tparams, _topt(steps), tdata,
                         _ftcfg(steps=steps))
    d = str(tmp_path)
    trainer.train(tloss, tparams, _topt(steps), tdata,
                  _ftcfg(steps=4, ckpt_dir=d, ckpt_every=4))
    resumed = trainer.train(tloss, tparams, _topt(steps), tdata,
                            _ftcfg(steps=steps, ckpt_dir=d, ckpt_every=8))
    assert resumed.history[0]["step"] == 4
    _assert_bitwise(resumed.values, full.values)
    _assert_bitwise(resumed.opt_state, full.opt_state)
    _assert_bitwise(resumed.aux_state, full.aux_state)
    assert _rows(resumed.history) == _rows(full.history, 4)
    assert isinstance(full.aux_state, tf.FaultState)

    want = jtrainer.train(jloss, jparams, _jopt(steps), jdata,
                          jtrainer.TrainerConfig(
                              steps=steps, log_every=1, channel_rng_seed=7,
                              aux_state=jf.init_state(3, (_FBATCH, 4)),
                              compress_k=0.5))
    for f in ("bad", "offline", "age", "consec"):
        assert np.array_equal(getattr(full.aux_state, f).numpy(),
                              np.asarray(getattr(want.aux_state, f))), f
    for a, b in zip(full.history, want.history):
        np.testing.assert_allclose(a["loss_mean"], b["loss_mean"],
                                   rtol=1e-4, atol=1e-5)
        assert a["dp_payload_bits"] == b["dp_payload_bits"]


def test_aux_state_validation():
    tloss, tparams, tdata, *_ = _fault_setup()
    with pytest.raises(ValueError, match="channel_rng_seed"):
        trainer.train(tloss, tparams, _topt(2), tdata,
                      TrainerConfig(steps=2,
                                    aux_state=tf.init_state(3, (_FBATCH, 4))))
    with pytest.raises(ValueError, match="microbatches == 1"):
        trainer.train(tloss, tparams, _topt(2), tdata,
                      _ftcfg(steps=2, microbatches=2))


def test_ckpt_on_stall_persists_the_carry_immediately(tmp_path):
    """The watchdog's stall flag, driven by the injected clock, saves the
    full carry at once (tests/test_faults.py's clock)."""
    tloss, tparams, tdata, *_ = _fault_setup()
    durations = [1.0, 1.0, 1.0, 1.0, 9.0, 1.0]     # step 4 stalls: 9 > 3x1
    times, t = [], 0.0
    for dt in durations:
        times.append(t)
        t += dt
        times.append(t)
    clock = iter(times).__next__
    res = trainer.train(tloss, tparams, _topt(6), tdata,
                        _ftcfg(steps=6, ckpt_dir=str(tmp_path), ckpt_every=0,
                               ckpt_on_stall=True, clock=clock, resume=False))
    assert res.straggler_flags == [4]
    assert (tmp_path / "step_0000000005" / "COMMIT").exists()
    assert [r["step_time_s"] for r in res.history] == durations


def test_straggler_substitution(lm):
    _, _, tm, tv, _, tpc = lm
    seen = []

    def data(step):
        seen.append(step)
        return tpipe.batch_for_step(tpc, step, device="cpu")

    res = trainer.train(tm.loss, tv, _topt(6), data,
                        TrainerConfig(steps=6, data_deadline_s=0.1,
                                      log_every=2),
                        delay_injector=lambda s: 0.5 if s in (2, 4) else 0.0)
    assert res.substituted_steps == [2, 4]
    assert seen == [0, 1, 1, 3, 3, 5]


def test_callers_init_left_intact(lm):
    """train(loss, init, ...) copies the caller's tensors: two runs from
    one init agree and the init is unchanged."""
    _, _, tm, tv, _, tpc = lm
    before = tree.map(torch.clone, tv)
    runs = [trainer.train(tm.loss, tv, _topt(3), _tdata(tpc),
                          TrainerConfig(steps=3, log_every=1))
            for _ in range(2)]
    _assert_bitwise(tv, before)
    _assert_bitwise(runs[0].values, runs[1].values)
    assert _rows(runs[0].history) == _rows(runs[1].history)


def test_trainer_channel_rng_hook_matches_jax():
    """tests/test_train_curves.py's channel hook: an OCS (p 0.1) loss
    driven through channel_rng_seed, reproducible step for step on the
    port, and within the float-order tolerance of the JAX package's."""
    kw = dict(n_workers=2, input_dim=4, encoder_dims=(4,), embed_dim=4,
              head_dims=(4,), output_dim=2, task="classification")
    jcfg = jvert.VerticalConfig(**kw, aggregation=JP.ocs(
        bits=8, p_miss=jnp.float32(0.1)))
    tcfg = tvert.VerticalConfig(**kw, aggregation=TP.ocs(
        bits=8, p_miss=torch.tensor(0.1)))
    jinit = jvert.init(jcfg, jax.random.PRNGKey(0))
    tinit = params_from_jax(jax.tree.map(np.asarray, jinit))
    rng = np.random.default_rng(0)
    views = rng.standard_normal((2, 8, 4)).astype(np.float32)
    labels = rng.integers(0, 2, (8,)).astype(np.int32)

    def jloss(values, batch, key):
        return jvert.loss_fn(jcfg, values, *batch, rng=key)

    def tloss(values, batch, key):
        return tvert.loss_fn(tcfg, values, *batch, rng=key)

    want = jtrainer.train(
        jloss, jinit, jopt.adamw(jsched.linear_warmup_cosine(1e-3, 1, 4)),
        lambda s: (jnp.asarray(views), jnp.asarray(labels)),
        jtrainer.TrainerConfig(steps=4, log_every=2, channel_rng_seed=11))
    runs = [trainer.train(
        tloss, tinit, topt.adamw(tsched.linear_warmup_cosine(1e-3, 1, 4)),
        lambda s: (torch.from_numpy(views), torch.from_numpy(labels)),
        TrainerConfig(steps=4, log_every=2, channel_rng_seed=11))
        for _ in range(2)]
    assert runs[0].final_step == 4
    assert all(math.isfinite(r["loss_mean"]) for r in runs[0].history)
    _assert_bitwise(runs[0].values, runs[1].values)
    assert [r["step"] for r in runs[0].history] == [0, 2, 3]
    for a, b in zip(runs[0].history, want.history):
        np.testing.assert_allclose(a["loss_mean"], b["loss_mean"],
                                   rtol=1e-5, atol=1e-6)
        assert a["chan_rounds"] == b["chan_rounds"]
    _assert_close(runs[0].values, want.values, PARAM_ATOL)


# -- launch/train and launch/serve --ckpt-dir ----------------------------------

def test_launch_train_then_serve_from_its_checkpoint(tmp_path, capsys):
    """The reduced config on the CPU: launch/train checkpoints, and
    launch/serve --ckpt-dir restores the final step's values (bitwise the
    trainer's) and samples."""
    d = str(tmp_path)
    res = launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--steps", "4", "--batch", "2", "--seq", "16",
                             "--ckpt-dir", d])
    assert res.final_step == 4 and len(res.history) == 2
    assert sorted(p.name for p in tmp_path.iterdir()
                  if p.name.startswith("step_")) == [
        "step_0000000001", "step_0000000002", "step_0000000003",
        "step_0000000004"]
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--ckpt-dir", d,
            "--sample", "--requests", "2", "--max-new", "3",
            "--prompt-len", "4"]
    run = launch_serve.setup(launch_serve.parse_args(argv))
    assert run.step == 4 and run.engine.config.greedy is False
    _assert_bitwise(run.engine.values, res.values)
    outs = launch_serve.main(argv)
    assert all(len(c.tokens) == 3 for c in outs.values())
    assert "restored checkpoint step 4" in capsys.readouterr().out


def test_launch_train_defaults_to_cuda():
    args = launch_train.parse_args(["--arch", ARCH, "--smoke"])
    assert args.device == "cuda" and args.use_flash and args.fusion == "max"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cuda"):
        launch_train.setup(args)
