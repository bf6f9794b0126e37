"""The port's protocol layer against the JAX package.

Bit for bit: the Eq. 7 codes, the noisy OCS core (every ``NoisyOCSResult``
field, against both JAX backends), the pooling laws' forward values and
input gradients, and the protocol accounting.  Within a stated float
tolerance: the vertical learner's loss and gradients, and one optimizer
step — float sums (matmuls, reductions) run in another order in XLA than
in PyTorch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proptest import grid, random_floats
from repro.core import fedocs as jfed
from repro.core import ocs as jocs
from repro.core import quantize as jq
from repro.core import vertical as jvert
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.protocol import Protocol as JProtocol
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch import random as jr
from repro_torch import tree
from repro_torch.convert import params_from_jax
from repro_torch.core import fedocs as tfed
from repro_torch.core import ocs as tocs
from repro_torch.core import quantize as tq
from repro_torch.core import vertical as tvert
from repro_torch.kernels.maxpool import ops as maxpool_ops
from repro_torch.kernels.ocs_contention import ops as contention_ops
from repro_torch.kernels.ocs_contention import ref as contention_ref
from repro_torch.kernels.ocs_quant.ref import to_int64
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.protocol import Protocol
from repro_torch.train.train_step import make_train_step

torch.set_num_threads(1)

_DT = {"float32": (jnp.float32, torch.float32, np.uint32, torch.int32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16, np.uint16, torch.int16),
       "float16": (jnp.float16, torch.float16, np.uint16, torch.int16)}


def _pair(x_np, dtype="float32"):
    jdt, tdt = _DT[dtype][:2]
    xj = jnp.asarray(x_np).astype(jdt)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)


def _float_bits_equal(a_j, b_t, dtype="float32"):
    _, _, npu, tint = _DT[dtype]
    return np.array_equal(np.asarray(a_j).view(npu),
                          b_t.detach().contiguous().view(tint).numpy()
                          .view(npu))


# ---------------------------------------------------------------------------
# Eq. 7 codes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_family_bitwise(dtype, seed):
    xj, xt = _pair(random_floats(seed, (16, 33), scale=10.0), dtype)
    jdt, tdt = _DT[dtype][:2]
    width = 32 if dtype == "float32" else 16
    for bits in sorted({1, 4, 8, 11, 16, width}):
        cj, ct = jq.quantize(xj, bits), tq.quantize(xt, bits)
        assert np.asarray(cj).dtype == ct.numpy().dtype
        assert np.array_equal(np.asarray(cj), ct.numpy()), bits
        assert _float_bits_equal(jq.dequantize(cj, bits, jdt),
                                 tq.dequantize(ct, bits, tdt), dtype), bits
        assert np.array_equal(np.asarray(jq.backoff_code(xj, bits)),
                              tq.backoff_code(xt, bits).numpy()), bits
    mj, mt = jq.monotone_code(xj), tq.monotone_code(xt)
    assert np.array_equal(np.asarray(mj), mt.numpy())
    assert _float_bits_equal(jq.monotone_decode(mj, jdt),
                             tq.monotone_decode(mt, tdt), dtype)


# ---------------------------------------------------------------------------
# the noisy OCS core
# ---------------------------------------------------------------------------

_CORE = (list(grid(n=[4], n_real=[None], extra_id=[0], bits=[8, 16],
                   p_miss=[0.0, 0.3, "per_worker"], seed=[0]))
         + list(grid(n=[9], n_real=[3, None], extra_id=[2], bits=[8, 16],
                     p_miss=[0.3], seed=[1])))


def _p_miss(case, n):
    if case["p_miss"] == "per_worker":
        return np.linspace(0.0, 0.4, n).astype(np.float32)
    return case["p_miss"]


@pytest.mark.parametrize("case", _CORE, ids=str)
def test_noisy_core_matches_both_jax_backends(case):
    """Padded workers (mask), padded scan bound (max_id_bits > id_bits),
    scalar and per-worker p_miss: every field, bit for bit."""
    n, bits = case["n"], case["bits"]
    n_real = case["n_real"] or n
    h = random_floats(case["seed"], (n, 48), specials=False)
    mask = np.arange(n) < n_real
    id_bits = jocs.host_id_bits(n_real)
    max_id = id_bits + case["extra_id"]
    p = _p_miss(case, n)
    kw = dict(bits=bits, max_id_bits=max_id, max_rounds=3)
    got = tocs.ocs_maxpool_noisy_core(
        torch.from_numpy(h)[None], torch.from_numpy(mask), id_bits,
        jr.PRNGKey(case["seed"])[None], torch.as_tensor(p)[None], **kw)
    for backend in ("scan", "pallas"):
        want = jocs.ocs_maxpool_noisy_core(
            jnp.asarray(h), jnp.asarray(mask), id_bits,
            jax.random.PRNGKey(case["seed"]), jnp.asarray(p), backend=backend,
            **kw)
        for f in dataclasses.fields(want):
            a, b = np.asarray(getattr(want, f.name)), getattr(got,
                                                               f.name)[0]
            assert a.dtype == b.numpy().dtype, f.name
            assert np.array_equal(a, b.numpy()), (backend, f.name)


@pytest.mark.parametrize("p_miss", [0.0, 0.25])
def test_packed_kernel_path_equals_plain_scan(p_miss):
    """The card's path — the fused contention over the float features,
    here through the wrapper's plain version (the words, the packed
    sensing planes, the tournament and the accounting) — gives the scan's
    winners and counts, and is that composition step by step."""
    rng = np.random.default_rng(2)
    lanes, n, k, bits = 3, 4, 40, 8
    h = torch.from_numpy(rng.standard_normal((lanes, n, k)).astype(
        np.float32))
    keys = jr.split(jr.PRNGKey(9), lanes)
    p = torch.full((lanes,), p_miss)
    mask = torch.ones(n, dtype=torch.bool)
    res = tocs.ocs_maxpool_noisy_core(h, mask, 2, keys, p, bits=bits,
                                      max_id_bits=2)
    p_keep = tocs.sensing_keep_prob(p, lanes=True)
    kw = dict(n_slots=bits + 2, max_rounds=3)
    got = contention_ops.noisy_contention(h, mask, bits, 2, keys, p_keep,
                                          **kw)
    assert torch.equal(got.winner, res.winner)
    assert torch.equal(got.collisions, res.collisions)
    assert torch.equal(got.rounds, res.rounds)
    assert torch.equal(got.contention_slots, res.contention_slots)
    codes = tq.quantize(h, bits).to(torch.int64)
    word = (codes << 2) | contention_ref.id_codes(n, 2)[:, None]
    heard = contention_ref.draw_heard_packed(keys, p_keep, n, k, **kw)
    winner, cont, coll = contention_ops.contend(word.to(torch.int32), heard,
                                                mask, bits + 2, **kw)
    assert torch.equal(winner, res.winner)
    assert torch.equal(coll.sum(-1).to(torch.int32), res.collisions)
    assert torch.equal(((bits + 2) * cont.sum(-1)).to(torch.int32),
                       res.contention_slots)


# ---------------------------------------------------------------------------
# the pooling laws: forward and input gradient, bit for bit
# ---------------------------------------------------------------------------

def _grad_pair(jfun, tfun, h_np, g_np, dtype="float32"):
    hj, ht = _pair(h_np, dtype)
    gj, gt = _pair(g_np, dtype)
    out_j, vjp = jax.vjp(jfun, hj)
    (dj,) = vjp(gj)
    ht = ht.clone().requires_grad_(True)
    out_t = tfun(ht)
    (dt,) = torch.autograd.grad(out_t, ht, gt)
    return (out_j, out_t), (dj, dt)


def _law_inputs(seed, n=4, shape=(6, 16), ties=False):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n,) + shape).astype(np.float32)
    if ties:
        h = np.round(h * 2) / 2       # many exact ties between workers
    return h, rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("tie_break", ["all", "first"])
@pytest.mark.parametrize("ties", [False, True])
def test_maxpool_law(tie_break, ties):
    h, g = _law_inputs(1, ties=ties)
    (oj, ot), (dj, dt) = _grad_pair(lambda x: jfed.maxpool(x, tie_break),
                                    lambda x: tfed.maxpool(x, tie_break),
                                    h, g)
    assert _float_bits_equal(oj, ot)
    assert _float_bits_equal(dj, dt)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("tie_break", ["all", "first"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_maxpool_quantized_law(bits, tie_break, dtype):
    h, g = _law_inputs(2)
    (oj, ot), (dj, dt) = _grad_pair(
        lambda x: jfed.maxpool_quantized(x, bits, tie_break),
        lambda x: tfed.maxpool_quantized(x, bits, tie_break), h, g, dtype)
    assert _float_bits_equal(oj, ot, dtype)
    assert _float_bits_equal(dj, dt, dtype)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("p_miss", [0.0, 0.3, "per_worker"])
def test_maxpool_noisy_law(bits, p_miss):
    h, g = _law_inputs(3)
    p = (np.array([0.0, 0.1, 0.3, 0.5], np.float32)
         if p_miss == "per_worker" else p_miss)
    (oj, ot), (dj, dt) = _grad_pair(
        lambda x: jfed.maxpool_noisy(x, jax.random.PRNGKey(4),
                                     jnp.asarray(p), bits),
        lambda x: tfed.maxpool_noisy(x, jr.PRNGKey(4), p, bits), h, g)
    assert _float_bits_equal(oj, ot)
    assert _float_bits_equal(dj, dt)


@pytest.mark.parametrize("bits", [8, 16])
def test_noisy_law_at_zero_miss_is_quantized_first(bits):
    h, g = _law_inputs(5, ties=True)
    ht = torch.from_numpy(h)
    outs = []
    for fn in (lambda x: tfed.maxpool_noisy(x, jr.PRNGKey(1), 0.0, bits),
               lambda x: tfed.maxpool_quantized(x, bits, "first")):
        x = ht.clone().requires_grad_(True)
        out = fn(x)
        (d,) = torch.autograd.grad(out, x, torch.from_numpy(g))
        outs.append((out.detach(), d))
    assert torch.equal(outs[0][0].view(torch.int32),
                       outs[1][0].view(torch.int32))
    assert torch.equal(outs[0][1].view(torch.int32),
                       outs[1][1].view(torch.int32))


# the curves' lane stack: noisy lanes and, last, the ideal "first" lane
_STACK = list(grid(bits=[8, 16], dtype=["float32", "bfloat16"],
                   p_miss=["lanes", "per_worker"]))


def _stack_inputs(case, lanes=3, n=4, shape=(6, 16)):
    rng = np.random.default_rng(case["bits"] + len(case["dtype"]))
    h = rng.standard_normal((lanes + 1, n) + shape).astype(np.float32)
    h[:, :, 0] = np.round(h[:, :, 0])      # exact ties between workers
    g = rng.standard_normal((lanes + 1,) + shape).astype(np.float32)
    p = np.array([0.0, 0.1, 0.4], np.float32)
    if case["p_miss"] == "per_worker":
        p = p[:, None] + np.linspace(0.0, 0.3, n, dtype=np.float32)[None]
    return h, g, p


@pytest.mark.parametrize("case", _STACK, ids=str)
def test_stack_pool_matches_the_two_laws(case):
    """``Protocol.aggregate_with_ideal`` (one pooled stack, one backward
    launch) against the two-law composition it replaces in the curves'
    step — ``aggregate`` of the noisy lanes, ``ideal_max(bits, "first")``
    of the last lane, ``torch.cat`` — and against the JAX laws lane by
    lane: the pooled values and the accounting bitwise; the gradient
    bitwise ``g * onehot`` per lane (each law's own vjp, the JAX laws'
    too), and the composition's gradient but for the sign of zeros.  The
    composition's backward sums the two slices' zero-filled gradients, so
    its zeros off the winner are all +0.0, where ``g * onehot`` keeps
    g's sign (-0.0 for a negative g)."""
    bits, dtype = case["bits"], case["dtype"]
    h_np, g_np, p_np = _stack_inputs(case)
    lanes = h_np.shape[0] - 1
    _, h0 = _pair(h_np, dtype)
    _, g = _pair(g_np, dtype)
    keys = jr.split(jr.PRNGKey(5), lanes)
    noisy = Protocol.ocs(bits).with_p_miss(p_np)
    ideal = Protocol.ideal_max(bits, tie_break="first")

    h = h0.clone().requires_grad_(True)
    pooled, acct = noisy.aggregate_with_ideal(h, keys)
    (grad,) = torch.autograd.grad(pooled, h, g)
    h = h0.clone().requires_grad_(True)
    v_n, acct_n = noisy.aggregate(h[:lanes], keys, lanes=True)
    v_i, _ = ideal.aggregate(h[lanes:], lanes=True)
    want = torch.cat([v_n, v_i])
    (grad_want,) = torch.autograd.grad(want, h, g)

    tint = _DT[dtype][3]
    assert torch.equal(pooled.view(tint), want.view(tint))
    for f in dataclasses.fields(acct):
        assert torch.equal(getattr(acct, f.name), getattr(acct_n, f.name))
    # g * onehot per lane: g at each winner, g * 0 elsewhere
    onehot = grad_want != 0
    assert torch.equal(onehot.sum(1), torch.ones_like(g, dtype=torch.int64))
    gx = g.unsqueeze(1).expand_as(grad)
    assert torch.equal(grad.view(tint),
                       torch.where(onehot, gx, gx * 0).view(tint))
    assert bool((torch.signbit(grad) & (grad == 0)).any())
    assert torch.equal(grad, grad_want)            # equal as numbers
    assert not bool((torch.signbit(grad_want) & (grad_want == 0)).any())
    # each lane's gradient is its JAX law's, bitwise
    jdt = _DT[dtype][0]
    jkeys = jax.random.split(jax.random.PRNGKey(5), lanes)
    for lane in range(lanes + 1):
        if lane < lanes:
            def law(x, lane=lane):
                return jfed.maxpool_noisy(x, jkeys[lane],
                                          jnp.asarray(p_np[lane]), bits)
        else:
            def law(x):
                return jfed.maxpool_quantized(x, bits, "first")
        out_j, vjp = jax.vjp(law, jnp.asarray(h_np[lane]).astype(jdt))
        (d_j,) = vjp(jnp.asarray(g_np[lane]).astype(jdt))
        assert _float_bits_equal(out_j, pooled[lane], dtype), lane
        assert _float_bits_equal(d_j, grad[lane], dtype), lane


def test_stack_pool_under_no_grad_and_bad_calls():
    """The evaluation's call (no autograd) pools the same stack; the stack
    takes an OCS protocol with a bound p_miss."""
    h_np, _, p_np = _stack_inputs(dict(bits=8, dtype="float32",
                                       p_miss="lanes"))
    h = torch.from_numpy(h_np)
    keys = jr.split(jr.PRNGKey(5), 3)
    proto = Protocol.ocs(8).with_p_miss(p_np)
    with torch.no_grad():
        pooled, acct = proto.aggregate_with_ideal(h, keys)
    v_n, acct_n = proto.aggregate(h[:3], keys, lanes=True)
    v_i, _ = Protocol.ideal_max(8, tie_break="first").aggregate(
        h[3:], lanes=True)
    assert torch.equal(pooled, torch.cat([v_n, v_i]).detach())
    assert torch.equal(acct.correct_frac, acct_n.correct_frac)
    with pytest.raises(ValueError, match="p_miss"):
        Protocol.ocs(8).aggregate_with_ideal(h, keys)
    with pytest.raises(ValueError, match="OCS"):
        Protocol.ideal_max(8).aggregate_with_ideal(h, keys)


def test_baseline_laws():
    h, _ = _law_inputs(6)
    hj, ht = _pair(h)
    assert np.array_equal(np.asarray(jfed.concat(hj)),
                          tfed.concat(ht).numpy())
    assert np.array_equal(np.asarray(jfed.concat(hj[:, 0])),
                          tfed.concat(ht[:, 0]).numpy())
    np.testing.assert_allclose(np.asarray(jfed.meanpool(hj)),
                               tfed.meanpool(ht).numpy(), rtol=1e-6)


def test_winner_mask_modes():
    """The routing masks of the max law's backwards against the JAX
    package's ``_winner_mask``: ``"all"`` is the tie mask ``maxpool.fwd``
    writes, ``"first"`` the one-hot of its first argmax."""
    h, _ = _law_inputs(7, ties=True)
    hj, ht = _pair(h)
    pooled_j = jnp.max(hj, 0)
    fwd = maxpool_ops.maxpool_fwd(ht, 0, winner=True, ties=True)
    k = torch.arange(ht.shape[0]).reshape(-1, 1, 1)
    got = {"all": ((to_int64(fwd.ties) >> k) & 1) == 1,
           "first": k == fwd.winner}
    for mode in ("all", "first"):
        assert np.array_equal(np.asarray(jfed._winner_mask(hj, pooled_j,
                                                           mode)),
                              got[mode].to(torch.float32).numpy())


# ---------------------------------------------------------------------------
# the Protocol object
# ---------------------------------------------------------------------------

def _load(comm_load):
    """A CommLoad's fields (the two packages' classes differ)."""
    return dataclasses.astuple(comm_load)


_KINDS = [("sum", {}), ("max", {"bits": 16}), ("ideal_max", {"bits": 8}),
          ("mean", {}), ("concat", {})]


@pytest.mark.parametrize("kind,kw", _KINDS)
def test_protocol_ideal_kinds(kind, kw):
    h, g = _law_inputs(8)
    jp, tp = getattr(JProtocol, kind)(**kw), getattr(Protocol, kind)(**kw)
    hj, ht = _pair(h)
    out_j, acct_j = jp.aggregate(hj)
    out_t, acct_t = tp.aggregate(ht)
    if kind == "mean":      # a float sum: order may differ
        np.testing.assert_allclose(np.asarray(out_j), out_t.numpy(),
                                   rtol=1e-6)
    else:
        assert _float_bits_equal(out_j, out_t)
    for f in dataclasses.fields(acct_j):
        assert np.array_equal(np.asarray(getattr(acct_j, f.name)),
                              getattr(acct_t, f.name).numpy())
    assert jp.output_dim(4, 16) == tp.output_dim(4, 16)
    assert _load(jp.comm_load(4, 16)) == _load(tp.comm_load(4, 16))


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("p_miss", [0.0, 0.2])
@pytest.mark.parametrize("backend", ["scan", "pallas"])
def test_protocol_ocs_aggregate_and_accounting(bits, p_miss, backend):
    h, g = _law_inputs(9)
    jp = JProtocol.ocs(bits, p_miss=p_miss, backend=backend)
    tp = Protocol.ocs(bits, p_miss=p_miss, backend=backend)
    (oj, ot), (dj, dt) = _grad_pair(
        lambda x: jp.aggregate(x, jax.random.PRNGKey(2))[0],
        lambda x: tp.aggregate(x, jr.PRNGKey(2))[0], h, g)
    assert _float_bits_equal(oj, ot)
    assert _float_bits_equal(dj, dt)
    _, acct_j = jp.aggregate(jnp.asarray(h), jax.random.PRNGKey(2))
    _, acct_t = tp.aggregate(torch.from_numpy(h), jr.PRNGKey(2))
    for f in dataclasses.fields(acct_j):
        a, b = np.asarray(getattr(acct_j, f.name)), getattr(acct_t, f.name)
        assert a.dtype == b.numpy().dtype, f.name
        assert np.array_equal(a, b.numpy()), f.name
    assert _load(jp.comm_load(4, 16)) == _load(tp.comm_load(4, 16))
    for mode in ("max_q8", "max_q16", "max_noisy", "concat"):
        assert (_load(JProtocol.from_mode(mode).comm_load(4, 8))
                == _load(Protocol.from_mode(mode).comm_load(4, 8)))


def test_protocol_lanes_equal_single_calls():
    """A lane stack pools every lane as its own single call would."""
    rng = np.random.default_rng(10)
    h = torch.from_numpy(rng.standard_normal((3, 4, 5, 8)).astype(
        np.float32))
    keys = jr.split(jr.PRNGKey(3), 3)
    p = torch.tensor([0.0, 0.2, 0.5])
    proto = Protocol.ocs(8)
    pooled, acct = proto.with_p_miss(p).aggregate(h, keys, lanes=True)
    for lane in range(3):
        one, acct1 = proto.with_p_miss(float(p[lane])).aggregate(
            h[lane], keys[lane])
        assert torch.equal(pooled[lane], one)
        assert acct.collisions[lane] == acct1.collisions
    ideal, _ = Protocol.ideal_max(8, tie_break="first").aggregate(
        h, lanes=True)
    assert torch.equal(ideal[0], pooled[0])          # p_miss = 0 lane


def test_protocol_rejects_bad_configs():
    with pytest.raises(ValueError):
        Protocol(kind="nope")
    with pytest.raises(ValueError):
        Protocol.ocs(bits=8, backend="triton")
    with pytest.raises(ValueError, match="p_miss"):
        Protocol.ocs(8).aggregate(torch.zeros(4, 8), jr.PRNGKey(0))
    with pytest.raises(ValueError, match="rng"):
        Protocol.ocs(8, p_miss=0.1).aggregate(torch.zeros(4, 8))


# ---------------------------------------------------------------------------
# the vertical learner, the optimizer, the train step (float tolerance)
# ---------------------------------------------------------------------------

# Matmuls and reductions sum in another order in XLA than in PyTorch: each
# float32 op may differ in its last bit, so the loss and gradients of the
# small model below agree to ~1e-6 relative; these bounds leave a margin.
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-6


_SHALLOW = dict(input_dim=16, encoder_dims=(8,), embed_dim=8, head_dims=(8,),
                output_dim=4)
# configs/fedocs_cifar.cifar10_like: 2x2 patches of 32x32 -> 256 inputs
_FEDOCS_CIFAR = dict(input_dim=256, encoder_dims=(256, 128), embed_dim=64,
                     head_dims=(512, 512, 512), output_dim=10)


def _vertical_pair(aggregation, dims=_SHALLOW, batch=16):
    jcfg = jvert.VerticalConfig(n_workers=4, task="classification",
                                aggregation=aggregation[0], **dims)
    tcfg = tvert.VerticalConfig(n_workers=4, task="classification",
                                aggregation=aggregation[1], **dims)
    params = jvert.init(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    views = rng.standard_normal((4, batch, dims["input_dim"])).astype(
        np.float32)
    labels = rng.integers(0, dims["output_dim"], batch).astype(np.int32)
    return jcfg, tcfg, params, views, labels


def _aggs(proto):
    if proto == "ideal_max":
        return (JProtocol.ideal_max(8, tie_break="first"),
                Protocol.ideal_max(8, tie_break="first"))
    return JProtocol.ocs(8, p_miss=0.2), Protocol.ocs(8, p_miss=0.2)


@pytest.mark.parametrize("proto", ["ideal_max", "ocs"])
def test_vertical_loss_and_grads(proto):
    _check_vertical_loss_and_grads(*_vertical_pair(_aggs(proto)))


@pytest.mark.parametrize("proto", ["ideal_max", "ocs"])
def test_vertical_loss_and_grads_at_fedocs_cifar_width(proto):
    """The main path's widths: two encoder layers, three head layers, and
    params_from_jax over all of them; a batch of 8."""
    _check_vertical_loss_and_grads(*_vertical_pair(
        _aggs(proto), dims=_FEDOCS_CIFAR, batch=8))


def _check_vertical_loss_and_grads(jcfg, tcfg, params, views, labels):
    (lj, mj), gj = jax.value_and_grad(
        lambda p: jvert.loss_fn(jcfg, p, jnp.asarray(views),
                                jnp.asarray(labels),
                                rng=jax.random.PRNGKey(5)), has_aux=True)(
        params)
    tp = params_from_jax(jax.tree.map(np.asarray, params))
    leaves = [x.requires_grad_(True) for x in tree.leaves(tp)]
    lt, mt = tvert.loss_fn(tcfg, tree.unflatten(tp, leaves),
                           torch.from_numpy(views), torch.from_numpy(labels),
                           rng=jr.PRNGKey(5))
    gt = torch.autograd.grad(lt, leaves)
    np.testing.assert_allclose(float(lj), float(lt.detach()),
                               rtol=LOSS_RTOL)
    for a, b in zip(jax.tree.leaves(gj), gt):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
    assert set(mj) == set(mt)
    for k in mj:
        np.testing.assert_allclose(np.asarray(mj[k]), mt[k].detach().numpy(),
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("step", [1, 3, 10])
def test_schedules(step):
    for jf, tf in ((jsched.linear_warmup_cosine(3e-3, 5, 60),
                    tsched.linear_warmup_cosine(3e-3, 5, 60)),
                   (jsched.wsd(1e-2, 3, 4, 5), tsched.wsd(1e-2, 3, 4, 5)),
                   (jsched.constant(0.5), tsched.constant(0.5))):
        # cos in float32 may round differently by one ulp
        np.testing.assert_allclose(float(jf(step)), float(tf(step)),
                                   rtol=1e-6)


def _grads_like(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (rng.standard_normal(np.shape(x)) * 3).astype(np.float32),
        params)


@pytest.mark.parametrize("max_grad_norm", [1.0, None])
def test_adamw_step(max_grad_norm):
    """Two AdamW steps from identical grads: the update is elementwise
    float32 arithmetic plus the global norm (a float sum) and the
    schedule's cosine, each of which may round one ulp apart."""
    _, _, params, _, _ = _vertical_pair(("max", "max"))
    jo = jopt.adamw(jsched.linear_warmup_cosine(3e-3, 2, 10),
                    weight_decay=0.01, max_grad_norm=max_grad_norm)
    to = topt.adamw(tsched.linear_warmup_cosine(3e-3, 2, 10),
                    weight_decay=0.01, max_grad_norm=max_grad_norm)
    tp = params_from_jax(jax.tree.map(np.asarray, params))
    js, ts = jo.init(params), to.init(tp)
    for seed in (1, 2):
        g = _grads_like(params, seed)
        params, js, jstats = jo.update(jax.tree.map(jnp.asarray, g), js,
                                       params)
        tp, ts, tstats = to.update(params_from_jax(g), ts, tp)
    for a, b in zip(jax.tree.leaves(params), tree.leaves(tp)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-6,
                                   atol=1e-7)
    if max_grad_norm is not None:
        np.testing.assert_allclose(float(jstats["grad_norm"]),
                                   float(tstats["grad_norm"]), rtol=1e-6)


def test_sgd_step_and_lane_clipping():
    _, _, params, _, _ = _vertical_pair(("max", "max"))
    g = _grads_like(params, 3)
    jo = jopt.sgd(jsched.constant(0.1), max_grad_norm=1.0)
    to = topt.sgd(tsched.constant(0.1), max_grad_norm=1.0)
    jp, _, _ = jo.update(jax.tree.map(jnp.asarray, g), jo.init(params),
                         params)
    tp0 = params_from_jax(jax.tree.map(np.asarray, params))
    tp, _, _ = to.update(params_from_jax(g), to.init(tp0), tp0)
    for a, b in zip(jax.tree.leaves(jp), tree.leaves(tp)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-6,
                                   atol=1e-7)
    # lanes: a stack of 2 identical lanes clips each lane as one run
    lane_g = tree.map(lambda x: torch.stack([x, 2 * x]), params_from_jax(g))
    clipped, gn = topt.clip_by_global_norm(lane_g, 1.0, lane_dims=1)
    one, gn1 = topt.clip_by_global_norm(params_from_jax(g), 1.0)
    assert torch.equal(gn[0], gn1)
    for a, b in zip(tree.leaves(clipped), tree.leaves(one)):
        assert torch.equal(a[0], b)


def test_train_step_microbatches_fold_rng():
    """Microbatches get the index folded into their keys, as in JAX."""
    rng = np.random.default_rng(4)
    w0 = rng.standard_normal((6, 3)).astype(np.float32)
    x = rng.standard_normal((8, 6)).astype(np.float32)
    y = rng.standard_normal((8, 3)).astype(np.float32)

    def jloss(values, batch, key):
        bx, by = batch
        noise = jax.random.uniform(key, values["w"].shape)
        loss = jnp.mean((bx @ values["w"] - by) ** 2) \
            + jnp.sum(noise * values["w"])
        return loss, {"l": loss}

    def tloss(values, batch, key):
        bx, by = batch
        noise = jr.uniform(key, values["w"].shape)
        loss = torch.mean((bx @ values["w"] - by) ** 2) \
            + torch.sum(noise * values["w"])
        return loss, {"l": loss}

    jo = jopt.sgd(jsched.constant(0.05))
    to = topt.sgd(tsched.constant(0.05))
    jstep = j_make_train_step(jloss, jo, microbatches=2, with_rng=True)
    tstep = make_train_step(tloss, to, microbatches=2, with_rng=True)
    jv, tv = {"w": jnp.asarray(w0)}, {"w": torch.from_numpy(w0.copy())}
    jv, _, jm = jstep(jv, jo.init(jv), (jnp.asarray(x), jnp.asarray(y)),
                      jax.random.PRNGKey(3))
    tv, _, tm = tstep(tv, to.init(tv), (torch.from_numpy(x),
                                        torch.from_numpy(y)),
                      jr.PRNGKey(3))
    np.testing.assert_allclose(float(jm["loss_mean"]), float(tm["loss_mean"]),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(jv["w"]), tv["w"].numpy(),
                               rtol=1e-6, atol=1e-7)

