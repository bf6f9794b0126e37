"""The port's serving engine (``repro_torch.serve``) against the JAX
package's, and the contracts of ``tests/test_serve.py`` on the port.

Both engines serve the same requests from the same parameters (the JAX
package's, carried across by ``convert``) at ``tests/test_serve.py``'s
fixture size, on the CPU.  Tokens, ``latency_ticks``, ``channel_slots`` and
``uplink_bits`` are integers and must be equal: the logits differ by float
order only (~1e-6, see ``test_torch_models.py``), the greedy argmax over
them is the same, and the channel's draws and D-bit codes are the JAX
package's bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import faults as jf
from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.models import model as JM
from repro.parallel.sharding import split_tree
from repro.protocol import Protocol as JP
from repro.serve import engine as jse
from repro.serve import load as jload
from repro_torch.configs import get_config, get_reduced
from repro_torch.tree import leaves as tree_leaves
from repro_torch.convert import params_from_jax
from repro_torch import faults as tfaults
from repro_torch.faults import FaultModel
from repro_torch.models import model as TM
from repro_torch.protocol import Protocol as TP
from repro_torch.serve import engine as se
from repro_torch.serve.engine import (ChannelClock, Completion, Request,
                                      ServeConfig, ServeEngine)
from repro_torch.serve.load import near_far_protocol, poisson_requests

torch.set_num_threads(1)

N_WORKERS = 2
VOCAB = 64
FIXTURE = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
               vocab_size=VOCAB, n_workers=N_WORKERS)


@pytest.fixture(scope="module")
def models():
    """(JAX model, JAX values, port model, port values) at the fixture."""
    jm = JM.build(j_get_reduced("qwen1.5-0.5b", **FIXTURE))
    jv, _ = split_tree(jm.init(jax.random.PRNGKey(0)))
    tm = TM.build(get_reduced("qwen1.5-0.5b", **FIXTURE))
    return jm, jv, tm, params_from_jax(jax.tree.map(np.asarray, jv))


def _engine(models, **kw):
    _, _, tm, tv = models
    return ServeEngine(tm, tv, ServeConfig(**kw), device="cpu")


def _ocs(p, protocol=TP):
    return protocol.ocs(bits=8, p_miss=np.full((N_WORKERS,), p, np.float32))


def _fields(c):
    return (c.tokens, c.latency_ticks, c.channel_slots, c.uplink_bits)


def _manual_decode(m, values, prompt, max_new, max_seq, eos=-1):
    logits, cache = m.prefill(values, {"tokens": torch.as_tensor(prompt)[None]},
                              max_seq=max_seq)
    tok = int(torch.argmax(logits, -1)[0])
    toks = [tok]
    pos = len(prompt)
    budget = max_new - 1
    while tok != eos and budget > 0 and pos < max_seq - 1:
        logits, cache = m.decode_step(values, torch.tensor([[tok]]),
                                      torch.tensor([pos]), cache)
        tok = int(torch.argmax(logits, -1)[0])
        toks.append(tok)
        pos += 1
        budget -= 1
    return toks


# -- the engine against the JAX engine --------------------------------------

def _mixed_requests():
    """More requests than slots, prompts of several lengths, a late
    arrival, budgets that retire at different ticks."""
    rng = np.random.default_rng(1)
    return [Request(rid=i, prompt=rng.integers(0, VOCAB, 3 + i).astype(
        np.int32), max_new_tokens=3 + (i % 3), arrival_tick=(0, 0, 1, 4, 12)[i])
            for i in range(5)]


@pytest.mark.parametrize("channel", ["free", "ocs0.05", "ocs0.3",
                                     "near_far"])
def test_engine_matches_jax_engine(models, channel):
    jm, jv, tm, tv = models
    protos = {"free": (None, None),
              "ocs0.05": (_ocs(0.05, JP), _ocs(0.05)),
              "ocs0.3": (_ocs(0.3, JP), _ocs(0.3)),
              "near_far": (jload.near_far_protocol(N_WORKERS, p_far=0.4),
                           near_far_protocol(N_WORKERS, p_far=0.4))}
    pj, pt = protos[channel]
    kw = dict(batch_slots=2, max_seq=16, eos_id=-1, seed=3)
    reqs = _mixed_requests()
    want = jse.ServeEngine(jm, jv, jse.ServeConfig(protocol=pj, **kw)).run(
        [jse.Request(**dataclasses.asdict(r)) for r in reqs])
    got = ServeEngine(tm, tv, ServeConfig(protocol=pt, **kw),
                      device="cpu").run(reqs)
    assert sorted(got) == sorted(want)
    for rid in want:
        assert _fields(got[rid]) == _fields(want[rid]), rid
    if pj is not None:
        assert all(c.channel_slots > 0 for c in got.values())


@pytest.mark.parametrize("channel", ["free", "ocs0.05"])
def test_sampling_engine_matches_jax_engine(models, channel):
    """``greedy=False``: both engines draw each tick's tokens with
    ``categorical`` under ``fold_in(fold_in(PRNGKey(seed), 0x5A), tick)``.
    The Gumbel draws agree within two float32 ulps of their logs
    (tests/test_torch_random.py) and the logits within float order, so
    on these seeds every sampled token is the JAX engine's.  The tied
    embedding is scaled down so that the logits are flat enough for the
    draw to leave the argmax."""
    jm, jv, tm, _ = models
    jv = dict(jv, embed={"tokens": jv["embed"]["tokens"] * 0.02})
    tv = params_from_jax(jax.tree.map(np.asarray, jv))
    pj, pt = {"free": (None, None),
              "ocs0.05": (_ocs(0.05, JP), _ocs(0.05))}[channel]
    kw = dict(batch_slots=2, max_seq=16, eos_id=-1, seed=3, greedy=False)
    reqs = _mixed_requests()
    want = jse.ServeEngine(jm, jv, jse.ServeConfig(protocol=pj, **kw)).run(
        [jse.Request(**dataclasses.asdict(r)) for r in reqs])
    got = ServeEngine(tm, tv, ServeConfig(protocol=pt, **kw),
                      device="cpu").run(reqs)
    assert sorted(got) == sorted(want)
    for rid in want:
        assert _fields(got[rid]) == _fields(want[rid]), rid
    greedy = ServeEngine(tm, tv, ServeConfig(
        protocol=pt, **dict(kw, greedy=True)), device="cpu").run(reqs)
    assert any(got[r].tokens != greedy[r].tokens for r in got)


def _fault(m, policy, p_drop=0.5):
    """Bursty sensing and worker dropouts strong enough that the fixture's
    two workers go dark together on some ticks."""
    pol = getattr(m.DegradePolicy, policy[0])(*policy[1:])
    return m.FaultModel.burst(burst_len=4, gap_len=16, p_miss_bad=0.5,
                              p_miss_good=0.01, policy=pol).with_dropout(
                                  p_drop, 0.3)


def _fault_fields(c):
    return _fields(c) + (c.degraded_tokens, c.retry_ticks)


@pytest.mark.parametrize("policy", [("stale",), ("zero_fill",), ("retry", 2)],
                         ids=lambda p: p[0])
def test_faulty_engine_matches_jax_engine(models, policy):
    """Under bursts and outages both engines serve the same tokens and
    bill the same ticks, slots, degraded tokens and retry ticks.  The JAX
    engine undoes a retry tick's cache writes; the port leaves them, and
    the next tick rewrites those rows before any attention reads them:
    equal tokens under ``retry`` show that no copy is needed."""
    jm, jv, tm, tv = models
    kw = dict(batch_slots=2, max_seq=24, eos_id=-1, seed=5)
    reqs = _mixed_requests()
    want = jse.ServeEngine(jm, jv, jse.ServeConfig(
        protocol=_ocs(0.05, JP), fault=_fault(jf, policy), **kw)).run(
        [jse.Request(**dataclasses.asdict(r)) for r in reqs])
    got = ServeEngine(tm, tv, ServeConfig(
        protocol=_ocs(0.05), fault=_fault(
            tfaults, policy), **kw),
        device="cpu").run(reqs)
    assert sorted(got) == sorted(want)
    for rid in want:
        assert _fault_fields(got[rid]) == _fault_fields(want[rid]), rid
    if policy[0] == "retry":
        assert sum(c.retry_ticks for c in got.values()) > 0
    else:
        assert sum(c.degraded_tokens for c in got.values()) > 0
    if policy[0] == "zero_fill":
        assert any(0 in c.tokens[1:] for c in got.values())


def test_fault_run_override_and_validation(models):
    """``run(fault=...)`` overrides the config's model (None serves the
    plain channel) and refuses to run without a channel protocol."""
    eng = _engine(models, batch_slots=2, max_seq=24, eos_id=-1,
                  protocol=_ocs(0.05),
                  fault=_fault(__import__("repro_torch.faults",
                                          fromlist=["x"]), ("stale",)))
    reqs = _mixed_requests()
    faulty = eng.run(reqs)
    plain = eng.run(reqs, fault=None)
    again = eng.run(reqs)
    assert sum(c.degraded_tokens for c in faulty.values()) > 0
    assert all(c.degraded_tokens == 0 for c in plain.values())
    for rid in faulty:
        assert _fault_fields(faulty[rid]) == _fault_fields(again[rid])
    with pytest.raises(ValueError, match="channel protocol"):
        eng.run(reqs, protocol=None)
    # an iid model without dropout serves the plain channel's tokens
    iid = eng.run(reqs, fault=FaultModel.iid(0.05))
    for rid in plain:
        assert _fields(iid[rid]) == _fields(plain[rid])


def test_full_layer_width_matches_jax():
    """One qwen1.5-0.5b layer at its full widths (d_model 1024, 16 heads of
    64, d_ff 2816 over 16 workers; vocabulary cut to 1024) in float32,
    prefill through the flash path, OCS at p 0.05: 2 slots serve two
    128-token prompts for 3 tokens each, token for token and slot for
    slot as the JAX engine."""
    kw = dict(n_layers=1, vocab_size=1024, use_flash=True)
    jcfg = j_get_config("qwen1.5-0.5b", dtype=jnp.float32,
                        param_dtype=jnp.float32, **kw)
    tcfg = get_config("qwen1.5-0.5b", dtype=torch.float32,
                      param_dtype=torch.float32, **kw)
    jm, tm = JM.build(jcfg), TM.build(tcfg)
    jv, _ = split_tree(jm.init(jax.random.PRNGKey(0)))
    tv = params_from_jax(jax.tree.map(np.asarray, jv))
    p = np.full((16,), 0.05, np.float32)
    reqs = poisson_requests(2, 1.0, 1024, prompt_len=128, max_new_tokens=3,
                            seed=0)
    cfg = dict(batch_slots=2, max_seq=160, eos_id=-1)
    want = jse.ServeEngine(jm, jv, jse.ServeConfig(
        protocol=JP.ocs(bits=8, p_miss=p), **cfg)).run(
        [jse.Request(**dataclasses.asdict(r)) for r in reqs])
    got = ServeEngine(tm, tv, ServeConfig(protocol=TP.ocs(bits=8, p_miss=p),
                                          **cfg), device="cpu").run(reqs)
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
        assert got[rid].channel_slots == want[rid].channel_slots, rid
        assert got[rid].uplink_bits == want[rid].uplink_bits, rid


_MOE = {"qwen3-moe": ("qwen3-moe-30b-a3b", {}),
        "llama4 shared max": ("llama4-scout-17b-a16e", dict(tp_fusion="max"))}


@pytest.mark.parametrize("channel", ["free", "ocs0.05"])
@pytest.mark.parametrize("plan", sorted(_MOE))
def test_moe_engine_matches_jax_engine(plan, channel):
    """The reduced MoE configs (all-MoE plans: no mlp fusion site, so no
    channel site) serve the mixed requests as the JAX engine: tokens and
    latency ticks equal, and under OCS 0 channel slots and 0 uplink bits
    billed, as the JAX engine bills."""
    arch, kw = _MOE[plan]
    jm = JM.build(j_get_reduced(arch, **kw))
    tm = TM.build(get_reduced(arch, **kw))
    jv, _ = split_tree(jm.init(jax.random.PRNGKey(2)))
    tv = params_from_jax(jax.tree.map(np.asarray, jv))
    assert tm.channel_sites() == jm.channel_sites() == 0
    n = tm.cfg.n_workers
    pj, pt = (None, None) if channel == "free" else (
        JP.ocs(bits=8, p_miss=np.full((n,), 0.05, np.float32)),
        TP.ocs(bits=8, p_miss=np.full((n,), 0.05, np.float32)))
    cfg = dict(batch_slots=2, max_seq=16, eos_id=-1, seed=3)
    rng = np.random.default_rng(4)
    reqs = [Request(rid=i, prompt=rng.integers(
        0, tm.cfg.vocab_size, 3 + i).astype(np.int32),
        max_new_tokens=3 + (i % 3), arrival_tick=(0, 0, 1, 4, 12)[i])
        for i in range(5)]
    want = jse.ServeEngine(jm, jv, jse.ServeConfig(protocol=pj, **cfg)).run(
        [jse.Request(**dataclasses.asdict(r)) for r in reqs])
    got = ServeEngine(tm, tv, ServeConfig(protocol=pt, **cfg),
                      device="cpu").run(reqs)
    assert sorted(got) == sorted(want)
    for rid in want:
        assert _fields(got[rid]) == _fields(want[rid]), rid
        assert got[rid].channel_slots == got[rid].uplink_bits == 0, rid


@pytest.fixture(scope="module", params=sorted(_MOE))
def moe_engines(request):
    """(port model, port values, JAX engines by greedy) of a reduced MoE
    plan; each JAX engine serves every case of the module (its jitted
    tick and prefills are reused)."""
    arch, kw = _MOE[request.param]
    jm = JM.build(j_get_reduced(arch, **kw))
    tm = TM.build(get_reduced(arch, **kw))
    jv, _ = split_tree(jm.init(jax.random.PRNGKey(2)))
    tv = params_from_jax(jax.tree.map(np.asarray, jv))
    engines = {g: jse.ServeEngine(jm, jv, jse.ServeConfig(
        greedy=g, **_FAULT_SERVE)) for g in (True, False)}
    return tm, tv, engines


_FAULT_SERVE = dict(batch_slots=2, max_seq=24, eos_id=-1, seed=5)


_CASES = {
    "free": (None, None), "ocs": ("ocs", None),
    "stale": ("ocs", ("stale",)), "zero_fill": ("ocs", ("zero_fill",)),
    "retry": ("ocs", ("retry", 2))}


def _case(case, n):
    """(JAX protocol, port protocol, JAX fault, port fault) of a case: OCS
    at p 0.05 and the bursts and outages of ``_fault`` with its policy."""
    proto, policy = _CASES[case]
    p = np.full((n,), 0.05, np.float32)
    return (None if proto is None else JP.ocs(bits=8, p_miss=p),
            None if proto is None else TP.ocs(bits=8, p_miss=p),
            None if policy is None else _fault(jf, policy),
            None if policy is None else _fault(tfaults, policy))


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_moe_faulty_engine_matches_jax_engine(moe_engines, case, greedy):
    """The MoE plans channel-free, under OCS and under bursts and outages
    (each policy), greedy and sampled: every field of ``_fault_fields``
    equal to the JAX engine's, 0 slots billed (no channel site), and
    under ``retry`` some retry ticks."""
    tm, tv, engines = moe_engines
    pj, pt, fj, ft = _case(case, tm.cfg.n_workers)
    reqs = _mixed_requests()
    want = engines[greedy].run(
        [jse.Request(**dataclasses.asdict(r)) for r in reqs],
        protocol=pj, fault=fj)
    got = ServeEngine(tm, tv, ServeConfig(greedy=greedy, **_FAULT_SERVE),
                      device="cpu").run(reqs, protocol=pt, fault=ft)
    assert sorted(got) == sorted(want)
    for rid in want:
        assert _fault_fields(got[rid]) == _fault_fields(want[rid]), rid
        assert got[rid].channel_slots == 0
    if case == "retry":
        assert sum(c.retry_ticks for c in got.values()) > 0
    elif ft is not None:
        assert sum(c.degraded_tokens for c in got.values()) > 0


# -- recurrent plans: xlstm-125m and jamba-1.5-large-398b ---------------------

_RECURRENT = {"xlstm max": ("xlstm-125m", dict(tp_fusion="max")),
              "jamba": ("jamba-1.5-large-398b", {})}


@pytest.fixture(scope="module", params=sorted(_RECURRENT))
def recurrent(request):
    """(JAX model, JAX values, port model, port values, JAX engines by
    greedy) of a reduced recurrent plan; each JAX engine is built once
    and serves every case of the module (its jitted tick and prefills
    are reused)."""
    arch, kw = _RECURRENT[request.param]
    jm = JM.build(j_get_reduced(arch, vocab_size=VOCAB, **kw))
    tm = TM.build(get_reduced(arch, vocab_size=VOCAB, **kw))
    jv, _ = split_tree(jm.init(jax.random.PRNGKey(0)))
    if jm.cfg.tie_embeddings:
        # flat enough logits that greedy tokens are not the prompt's last
        # and a draw leaves the argmax (test_sampling_engine_matches_...)
        jv = dict(jv, embed={"tokens": jv["embed"]["tokens"] * 0.02})
    tv = params_from_jax(jax.tree.map(np.asarray, jv))
    engines = {g: jse.ServeEngine(jm, jv, jse.ServeConfig(
        greedy=g, **_FAULT_SERVE)) for g in (True, False)}
    return jm, jv, tm, tv, engines


def _recurrent_requests():
    """More requests than slots, prompts of 3 and 5 tokens (a mamba layer
    caches the last conv_width - 1 = 3 rows), a late arrival."""
    rng = np.random.default_rng(6)
    return [Request(rid=i, prompt=rng.integers(0, VOCAB, 3 + 2 * (i % 2))
                    .astype(np.int32), max_new_tokens=4 + (i % 3),
                    arrival_tick=(0, 0, 1, 4, 12)[i]) for i in range(5)]


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_recurrent_engine_matches_jax_engine(recurrent, case, greedy):
    """The reduced xlstm (tp_fusion max: the mLSTM sites pool by the max
    law) and jamba plans through both engines, channel-free, under OCS p
    0.05 and under bursts and outages with each policy, greedy and
    sampled: tokens, latency ticks, slots, bits, degraded tokens and
    retry ticks equal.  Under ``retry`` the held ticks must leave the
    recurrent states as they were (the copy-on-hold); xlstm has no
    channel site, so it bills 0 slots and 0 bits."""
    jm, jv, tm, tv, engines = recurrent
    pj, pt, fj, ft = _case(case, N_WORKERS)
    reqs = _recurrent_requests()
    want = engines[greedy].run(
        [jse.Request(**dataclasses.asdict(r)) for r in reqs],
        protocol=pj, fault=fj)
    got = ServeEngine(tm, tv, ServeConfig(greedy=greedy, **_FAULT_SERVE),
                      device="cpu").run(reqs, protocol=pt, fault=ft)
    assert sorted(got) == sorted(want)
    for rid in want:
        assert _fault_fields(got[rid]) == _fault_fields(want[rid]), rid
    if tm.channel_sites() == 0:
        assert all(c.channel_slots == c.uplink_bits == 0
                   for c in got.values())
    elif pt is not None:
        assert all(c.channel_slots > 0 for c in got.values())
    if case == "retry":
        assert sum(c.retry_ticks for c in got.values()) > 0
    elif ft is not None:
        assert sum(c.degraded_tokens for c in got.values()) > 0
    if case == "free":
        # greedy tokens are not a repeat of the prompt, and a draw differs
        other = engines[not greedy].run(
            [jse.Request(**dataclasses.asdict(r)) for r in reqs],
            protocol=None, fault=None)
        assert any(other[r].tokens != got[r].tokens for r in got)
        assert any(len(set(c.tokens)) > 1 for c in got.values())


def test_mamba_prompts_need_conv_width_rows():
    """A mamba layer's prefill caches the prompt's last conv_width - 1
    rows: a shorter prompt is refused with the length named; a plan
    without mamba serves one-token prompts."""
    cfg = get_reduced("jamba-1.5-large-398b")
    m = TM.build(cfg)
    eng = ServeEngine(m, m.init(torch.Generator().manual_seed(0)),
                      ServeConfig(batch_slots=1, max_seq=16), device="cpu")
    with pytest.raises(ValueError, match="at least 3"):
        eng.run([Request(rid=0, prompt=np.arange(2, dtype=np.int32),
                         max_new_tokens=2)])
    out = eng.run([Request(rid=0, prompt=np.arange(3, dtype=np.int32),
                           max_new_tokens=2)])
    assert len(out[0].tokens) == 2
    m = TM.build(get_reduced("xlstm-125m"))
    out = ServeEngine(m, m.init(torch.Generator().manual_seed(0)),
                      ServeConfig(batch_slots=1, max_seq=16),
                      device="cpu").run([Request(
                          rid=0, prompt=np.arange(1, dtype=np.int32),
                          max_new_tokens=2)])
    assert len(out[0].tokens) == 2


def test_batch_axis_of_every_cache_leaf():
    """``cache_rows``, where the engine copies a prefill into its slot,
    names the slot axis of each stacked cache leaf: axis 1 of the KV
    buffers, the mLSTM (n, m) and the sLSTM state; axis 2 of the mLSTM
    memory and the mamba conv window and state, whose axis 1 is the
    workers (here as many as the slots); the one-request cache has 1 row
    there and the batch cache ``b``."""
    for arch in ("xlstm-125m", "jamba-1.5-large-398b"):
        cfg = get_reduced(arch)
        b = cfg.n_workers
        batch = TM.cache_init(cfg, b, 16)
        one = TM.cache_init(cfg, 1, 16)
        rows = TM.cache_rows(cfg, batch)
        for i, (mixer, _) in enumerate(cfg.layer_plan()):
            want = {"attn": (1, 1), "mlstm": (2, 1, 1),
                    "slstm": (1, 1, 1, 1), "mamba": (2, 2)}[mixer]
            got = tuple(tree_leaves(rows[f"pos{i}"]))
            assert got == want, (arch, mixer, got)
            for x, y, axis in zip(tree_leaves(batch[f"pos{i}"]),
                                  tree_leaves(one[f"pos{i}"]), got):
                assert (x.shape[axis], y.shape[axis]) == (b, 1)


# -- refill / retire semantics ---------------------------------------------

def test_all_requests_complete(models):
    eng = _engine(models, batch_slots=2, max_seq=40, eos_id=-1)
    reqs = [Request(rid=i, prompt=np.arange(3 + i, dtype=np.int32) % VOCAB,
                    max_new_tokens=6) for i in range(5)]
    outs = eng.run(reqs)
    assert set(outs) == set(range(5))
    assert all(len(c.tokens) == 6 for c in outs.values())


def test_eos_retires_early_and_slot_is_reused(models):
    _, _, tm, tv = models
    prompt = np.arange(5, dtype=np.int32)
    ref = _manual_decode(tm, tv, prompt, 8, 40)
    eos = ref[2]
    stop_at = next(i for i in range(1, len(ref)) if ref[i] == eos) + 1
    assert stop_at < 8
    eng = _engine(models, batch_slots=1, max_seq=40, eos_id=eos)
    outs = eng.run([Request(rid=i, prompt=prompt, max_new_tokens=8)
                    for i in range(3)])
    assert set(outs) == {0, 1, 2}
    for c in outs.values():
        assert c.tokens[-1] == eos and len(c.tokens) == stop_at


def test_length_cap_retires_at_max_seq(models):
    eng = _engine(models, batch_slots=1, max_seq=8, eos_id=-1)
    out = eng.run([Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                           max_new_tokens=100)])[0]
    assert len(out.tokens) == 8 - 5


@pytest.mark.parametrize("n_requests", [3, 4])
def test_one_slot_queue_drains_fifo(models, n_requests):
    """With one slot, requests finish strictly in arrival order (and more
    requests than slots reuse the slot)."""
    eng = _engine(models, batch_slots=1, max_seq=40, eos_id=-1)
    reqs = [Request(rid=i, prompt=np.arange(4, dtype=np.int32),
                    max_new_tokens=4) for i in range(n_requests)]
    outs = eng.run(reqs)
    finish = [outs[i].latency_ticks for i in range(n_requests)]
    assert finish == sorted(finish) and len(set(finish)) == n_requests


def test_late_arrivals_wait_for_their_tick(models):
    _, _, tm, tv = models
    eng = _engine(models, batch_slots=2, max_seq=32, eos_id=-1)
    reqs = [Request(rid=0, prompt=np.arange(4, dtype=np.int32),
                    max_new_tokens=3, arrival_tick=0),
            Request(rid=1, prompt=np.arange(4, dtype=np.int32),
                    max_new_tokens=3, arrival_tick=10)]
    outs = eng.run(reqs)
    assert outs[1].latency_ticks >= 2
    assert outs[1].tokens == _manual_decode(tm, tv, reqs[1].prompt, 3, 32)


# -- channel-free parity and the channel's billing --------------------------

def test_greedy_serving_matches_manual_decode(models):
    _, _, tm, tv = models
    eng = _engine(models, batch_slots=2, max_seq=32, eos_id=-1)
    prompts = [np.arange(5, dtype=np.int32),
               (np.arange(7, dtype=np.int32) * 3) % VOCAB,
               np.arange(4, dtype=np.int32) + 9]
    outs = eng.run([Request(rid=i, prompt=p, max_new_tokens=4)
                    for i, p in enumerate(prompts)])
    for i, p in enumerate(prompts):
        assert outs[i].tokens == _manual_decode(tm, tv, p, 4, 32)


def test_channel_free_completion_has_zero_channel_fields(models):
    eng = _engine(models, batch_slots=2, max_seq=32, eos_id=-1)
    c = eng.run([Request(rid=0, prompt=np.arange(4, dtype=np.int32),
                         max_new_tokens=4)])[0]
    assert c.latency_ticks > 0
    assert c.channel_slots == 0 and c.uplink_bits == 0
    assert c.latency_us(ChannelClock(tick_us=50.0)) == c.latency_ticks * 50.0


def test_channel_serving_bills_airtime_and_uplink(models):
    _, _, tm, _ = models
    eng = _engine(models, batch_slots=2, max_seq=32, eos_id=-1,
                  protocol=_ocs(0.05))
    outs = eng.run([Request(rid=i, prompt=np.arange(4, dtype=np.int32),
                            max_new_tokens=4) for i in range(2)])
    per_tok = _ocs(0.05).comm_load(N_WORKERS, 32).uplink_bits * \
        tm.channel_sites()
    for c in outs.values():
        assert c.channel_slots > 0
        assert c.uplink_bits == (len(c.tokens) - 1) * per_tok


def test_error_free_channel_matches_ideal_max(models):
    """OCS at p_miss=0 serves the same tokens as Protocol.ideal_max."""
    eng = _engine(models, batch_slots=2, max_seq=32, eos_id=-1)
    reqs = [Request(rid=i, prompt=np.arange(4 + i, dtype=np.int32),
                    max_new_tokens=4) for i in range(2)]
    under_ocs = eng.run(reqs, protocol=_ocs(0.0))
    ideal = eng.run(reqs, protocol=TP.ideal_max(8, tie_break="first"))
    for i in under_ocs:
        assert under_ocs[i].tokens == ideal[i].tokens


@pytest.mark.parametrize("protocol", ["ocs0.2", "near_far"])
def test_channel_serving_deterministic(models, protocol):
    proto = (_ocs(0.2) if protocol == "ocs0.2"
             else near_far_protocol(N_WORKERS, p_far=0.4))
    eng = _engine(models, batch_slots=2, max_seq=32, eos_id=-1,
                  protocol=proto)
    reqs = [Request(rid=i, prompt=np.arange(5, dtype=np.int32),
                    max_new_tokens=5) for i in range(2)]
    a, b = eng.run(reqs), eng.run(reqs)
    for i in a:
        assert _fields(a[i]) == _fields(b[i])


def test_one_dispatch_per_decode_tick(models):
    eng = _engine(models, batch_slots=2, max_seq=32, eos_id=-1)
    reqs = [Request(rid=i, prompt=np.arange(4, dtype=np.int32),
                    max_new_tokens=5) for i in range(3)]
    se.reset_dispatch_counts()
    outs = eng.run(reqs)
    ticks = se.dispatch_counts()["tick"]
    decode_tokens = sum(len(c.tokens) - 1 for c in outs.values())
    assert -(-decode_tokens // 2) <= ticks <= decode_tokens


# -- load generation --------------------------------------------------------

@pytest.mark.parametrize("seed,rate,prompt_len", [(3, 0.5, 6), (0, 2.0, 256)])
def test_poisson_requests_match_jax(seed, rate, prompt_len):
    want = jload.poisson_requests(16, rate, 151936, prompt_len=prompt_len,
                                  max_new_tokens=4, seed=seed)
    got = poisson_requests(16, rate, 151936, prompt_len=prompt_len,
                           max_new_tokens=4, seed=seed)
    for a, b in zip(got, want):
        assert (a.rid, a.arrival_tick, a.max_new_tokens) == \
            (b.rid, b.arrival_tick, b.max_new_tokens)
        assert a.prompt.dtype == b.prompt.dtype == np.int32
        assert np.array_equal(a.prompt, b.prompt)


def test_poisson_requests_validation():
    with pytest.raises(ValueError):
        poisson_requests(0, 1.0, VOCAB)
    with pytest.raises(ValueError):
        poisson_requests(4, 0.0, VOCAB)


@pytest.mark.parametrize("n", [2, 4, 5, 16])
def test_near_far_protocol_p_miss_profile(n):
    want = jload.near_far_protocol(n, p_near=0.01, p_far=0.25)
    got = near_far_protocol(n, p_near=0.01, p_far=0.25)
    pm = np.asarray(got.p_miss)
    assert pm.dtype == np.float32
    assert np.array_equal(pm, np.asarray(want.p_miss))
    assert (got.kind, got.bits, got.max_rounds) == \
        (want.kind, want.bits, want.max_rounds)


# -- config surfaces --------------------------------------------------------

def test_serve_config_validation():
    with pytest.raises(ValueError):
        ServeConfig(batch_slots=0)
    with pytest.raises(ValueError):
        ServeConfig(max_seq=1)
    with pytest.raises(ValueError):
        ServeConfig(protocol=TP.concat())
    with pytest.raises(ValueError):
        ChannelClock(tick_us=0.0)
    with pytest.raises(ValueError):
        ChannelClock(slot_us=-1.0)
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg = ServeConfig()
        cfg.batch_slots = 8
    # a fault model needs a channel to fault; with one it serves
    # (test_faulty_engine_matches_jax_engine)
    with pytest.raises(ValueError, match="channel protocol"):
        ServeConfig(fault=FaultModel.iid(0.1))
    assert ServeConfig(protocol=_ocs(0.1),
                       fault=FaultModel.iid(0.1)).fault is not None
    # sampling serves (test_sampling_engine_matches_jax_engine)
    assert ServeConfig(greedy=False).greedy is False


def test_engine_device_defaults_to_cuda(models):
    _, _, tm, tv = models
    if torch.cuda.is_available():
        assert ServeEngine(tm, tv, ServeConfig()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(tm, tv, ServeConfig())


def test_completion_latency_decomposition():
    c = Completion(rid=0, tokens=[1, 2], prompt_len=3,
                   latency_ticks=7, channel_slots=120, uplink_bits=640)
    assert c.latency_us(ChannelClock(tick_us=10.0, slot_us=0.5)) == \
        7 * 10.0 + 120 * 0.5


def test_serve_launcher_on_the_cpu(capsys):
    """``python -m repro_torch.launch.serve`` at the reduced config."""
    from repro_torch.launch import serve as launcher
    launcher.main(["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu",
                   "--p-miss", "0.05", "--requests", "3", "--max-new", "3",
                   "--prompt-len", "16"])
    out = capsys.readouterr().out
    assert out.count("req ") == 3 and "3 requests, 9 tokens" in out
    launcher.main(["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu",
                   "--near-far", "--no-use-flash", "--requests", "2",
                   "--max-new", "2"])
    assert "2 requests, 4 tokens" in capsys.readouterr().out
