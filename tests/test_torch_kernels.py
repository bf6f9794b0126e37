"""Plain versions of the port's kernels against the JAX package's Pallas
kernels (run in interpret mode on the CPU, as the JAX tests run them) and
their ``ref.py`` oracles — bit for bit, over dtype x bits x shape grids.

The wrappers (``ops.py``) take the plain version for CPU tensors, so on
this host they are what the port runs; on a tensor that is not on the
CPU they launch the CUDA kernel or raise, which the last tests check.
``tests/test_torch_cuda.py`` holds each CUDA kernel to its plain version
on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proptest import grid, random_floats
from repro.core import ocs as jocs
from repro.kernels.maxpool import maxpool as JMP
from repro.kernels.maxpool import ref as JMPR
from repro.kernels.ocs_contention import ops as JCO
from repro.kernels.ocs_contention import ref as JCR
from repro.kernels.ocs_quant import ocs_quant as JQ
from repro.kernels.ocs_quant import ref as JQR
from repro_torch import kernels
from repro_torch import random as jr
from repro_torch.core import ocs as tocs
from repro_torch.kernels.maxpool import ops as MPO
from repro_torch.kernels.maxpool import ref as MPR
from repro_torch.kernels.ocs_contention import ops as CO
from repro_torch.kernels.ocs_contention import ref as CR
from repro_torch.kernels.ocs_quant import ops as QO
from repro_torch.kernels.ocs_quant import ref as QR

torch.set_num_threads(1)

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16),
       "float16": (jnp.float16, torch.float16)}


def _pair(x_np, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jdt, tdt = _DT[dtype]
    xj = jnp.asarray(x_np).astype(jdt)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)


def _bits_of(a) -> np.ndarray:
    """Raw bits of a JAX array or torch tensor, for exact comparison."""
    if isinstance(a, torch.Tensor):
        if a.dtype in (torch.bfloat16, torch.float16, torch.uint16):
            return a.view(torch.int16).numpy().view(np.uint16)
        if a.dtype in (torch.float32, torch.uint32):
            return a.view(torch.int32).numpy().view(np.uint32)
        return a.numpy()
    a = np.asarray(a)
    if a.dtype.itemsize == 2 and a.dtype.kind in "fV" or a.dtype == jnp.bfloat16:
        return a.view(np.uint16)
    if a.dtype == np.float32:
        return a.view(np.uint32)
    return a


def _same(a, b, what=""):
    x, y = _bits_of(a), _bits_of(b)
    assert x.shape == y.shape, (what, x.shape, y.shape)
    assert x.dtype == y.dtype, (what, x.dtype, y.dtype)
    assert np.array_equal(x, y), what


# ---------------------------------------------------------------------------
# ocs_quant: encode / decode
# ---------------------------------------------------------------------------

_QUANT = list(grid(shape=[(64, 128), (3, 5, 7)], scale=[0.1, 100.0],
                   seed=[0, 1], bits=[1, 8, 11, 16],
                   dtype=["float32", "bfloat16", "float16"]))


@pytest.mark.parametrize("case", _QUANT, ids=str)
def test_encode_decode_match_jax(case):
    x_np = random_floats(case["seed"], case["shape"], scale=case["scale"])
    xj, xt = _pair(x_np, case["dtype"])
    bits = case["bits"]
    codes_t = QO.encode(xt, bits)
    _same(JQR.encode(xj, bits), codes_t, "encode vs ref")
    if len(case["shape"]) == 2:           # the Pallas kernel takes (M, K)
        _same(JQ.encode(xj, bits), codes_t, "encode vs kernel")
    codes_j = JQR.encode(xj, bits)
    dec_t = QO.decode(codes_t, bits, _DT[case["dtype"]][1])
    _same(JQR.decode(codes_j, bits, _DT[case["dtype"]][0]), dec_t,
          "decode vs ref")
    if len(case["shape"]) == 2:
        _same(JQ.decode(codes_j, bits, _DT[case["dtype"]][0]), dec_t,
              "decode vs kernel")


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("dtype", sorted(_DT))
def test_quantize_st_matches_jax(dtype, bits):
    """``quantize_st`` forward bitwise the JAX op's (``decode(encode(x))``
    through the Pallas kernels in interpret mode), signed zeros and the
    extremes of ``random_floats`` included, and its straight-through
    gradient bitwise ``jax.grad``'s."""
    from repro.kernels.ocs_quant import ops as JQO
    x_np = random_floats(3, (64, 128), scale=10.0)
    xj, xt = _pair(x_np, dtype)
    g_np = random_floats(4, (64, 128), specials=False)
    gj, gt = _pair(g_np, dtype)
    xt.requires_grad_(True)
    out = QO.quantize_st(xt, bits)
    _same(JQO.quantize_st(xj, bits), out.detach(), "forward")
    assert out.dtype == xt.dtype
    (out * gt).sum().backward()
    want = jax.grad(lambda v: jnp.sum(
        (JQO.quantize_st(v, bits) * gj).astype(jnp.float32)))(xj)
    _same(want, xt.grad, "gradient")


@pytest.mark.parametrize("bits", [1, 8, 16])
def test_decode_every_code(bits):
    """Every reachable 16-bit code (and the NaN buckets) decodes as JAX's."""
    codes = np.arange(1 << bits, dtype=np.uint16 if bits > 8 else np.uint8)
    for dtype in ("float32", "bfloat16", "float16"):
        jdt, tdt = _DT[dtype]
        want = JQR.decode(jnp.asarray(codes), bits, jdt)
        _same(want, QO.decode(torch.from_numpy(codes), bits, tdt), dtype)


# ---------------------------------------------------------------------------
# maxpool: fused max + first argmax, and the winner-routed backward
# ---------------------------------------------------------------------------

_POOL = list(grid(n=[1, 4, 9], m=[8, 64], k=[128], seed=[0, 1],
                  dtype=["float32", "bfloat16", "float16", "u8", "u16"]))


def _pool_input(case):
    shape = (case["n"], case["m"], case["k"])
    rng = np.random.default_rng(case["seed"])
    if case["dtype"] in ("u8", "u16"):
        hi = 256 if case["dtype"] == "u8" else 1 << 16
        npdt = np.uint8 if case["dtype"] == "u8" else np.uint16
        # few distinct values: ties exercise the first-argmax rule
        x = (rng.integers(0, 6, shape) * (hi // 6)).astype(npdt)
        return jnp.asarray(x), torch.from_numpy(x)
    x = rng.integers(-3, 4, shape).astype(np.float32) * 0.5
    return _pair(x, case["dtype"])


@pytest.mark.parametrize("case", _POOL, ids=str)
def test_maxpool_fused_matches_jax(case):
    hj, ht = _pool_input(case)
    vj, wj = JMP.maxpool_fused(hj)
    vt, wt = MPO.maxpool_fused(ht, 0)
    _same(vj, vt, "pooled")
    _same(wj, wt, "winner")
    rvj, rwj = JMPR.maxpool_fused(hj)
    _same(rvj, vt, "pooled vs ref")
    _same(rwj, wt, "winner vs ref")


def test_maxpool_fused_lane_batch_and_nan():
    """A leading lane axis pools each lane on its own; NaN wins, first."""
    x = np.random.default_rng(3).standard_normal((3, 4, 50)).astype(
        np.float32)
    x[1, 2, 7] = np.nan
    x[1, 3, 7] = np.nan
    v, w = MPO.maxpool_fused(torch.from_numpy(x), 1)
    for lane in range(3):
        vj, wj = JMP.maxpool_fused(jnp.asarray(x[lane])[:, None, :])
        assert np.array_equal(np.asarray(wj)[0], w[lane].numpy())
        assert np.array_equal(np.asarray(vj)[0], v[lane].numpy(),
                              equal_nan=True)
    assert w[1, 7] == 2


def test_maxpool_fused_uint32_codes_exact():
    """Codes wider than float32's 24-bit mantissa (D > 24, which the port
    pools on the CPU) keep their order: neighbours near 2^31 are told
    apart, as by the JAX reference."""
    x = (np.uint32(1 << 31) + np.random.default_rng(4).integers(
        0, 3, (5, 2, 64))).astype(np.uint32)
    vj, wj = JMPR.maxpool_fused(jnp.asarray(x))
    vt, wt = MPO.maxpool_fused(torch.from_numpy(x), 0)
    _same(vj, vt, "pooled")
    _same(wj, wt, "winner")


@pytest.mark.parametrize("n", [1, 4, 9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_winner_bwd_matches_jax(n, dtype):
    rng = np.random.default_rng(n)
    w = rng.integers(0, n, (16, 128)).astype(np.int32)
    gj, gt = _pair(rng.standard_normal((16, 128)).astype(np.float32), dtype)
    got = MPO.maxpool_winner_bwd(torch.from_numpy(w), gt, n)
    # bitwise against the pooling laws' form: g * onehot, a zero with g's
    # sign off the winner
    onehot = (jnp.arange(n)[:, None, None] == jnp.asarray(w)[None]
              ).astype(gj.dtype)
    _same(gj[None] * onehot, got, "product form")
    # the TPU kernel and its reference write +0.0 off the winner: equal up
    # to the sign of those zeros
    got_f = got.float().numpy()
    for want in (JMP.maxpool_winner_bwd(jnp.asarray(w), gj, n),
                 JMPR.maxpool_winner_bwd(jnp.asarray(w), gj, n)):
        assert np.array_equal(np.asarray(want, np.float32), got_f)


# ---------------------------------------------------------------------------
# maxpool.decode: the fused pooling epilogue of a channel site
# ---------------------------------------------------------------------------

_OUTPUTS = {False: [(m, a, False) for m in (False, True)
                    for a in (False, True)],
            True: [(m, a, c) for m in (False, True) for a in (False, True)
                   for c in (False, True)]}
_DECODE = [dict(src=src, bits=bits, dtype=dtype, winner=w, mask=mask,
                max_code=m, argmax=a, correct=c)
           for src in ("codes", "floats") for bits in (8, 16)
           for dtype in ("float32", "bfloat16", "float16")
           for w in (False, True) for mask in ("none", "lanes")
           for m, a, c in _OUTPUTS[w]]


def _decode_operands(case, lanes=3, n=5, e=40):
    """Codes with many ties and the lowest code (which decodes to -inf);
    with ``mask="lanes"`` a (lanes, n) mask with dark workers and lane 0
    all dark, so each of its columns pools to code 0."""
    rng = np.random.default_rng(case["bits"] + len(case["dtype"]))
    top = 1 << case["bits"]
    codes = (rng.integers(0, 6, (lanes, n, e)) * (top // 6)).astype(
        np.uint8 if case["bits"] <= 8 else np.uint16)
    codes[:, :, :3] = 0
    mask = rng.random((lanes, n)) < 0.6
    mask[0] = False
    mask[1:, 0] = True
    if case["mask"] == "none":
        mask = np.ones((lanes, n), bool)
    winner = rng.integers(0, n, (lanes, e)).astype(np.int32)
    return codes, mask, winner


@pytest.mark.parametrize("case", _DECODE, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
def test_maxpool_decode_matches_jax(case):
    """``maxpool_decode`` (its plain version, what the port runs on the
    CPU) against the JAX package's own composition at the channel site,
    bit for bit: ``jnp.max``/``jnp.argmax`` of ``jnp.where(mask, codes,
    0)`` (``core/ocs.py``), the winner's code by ``take_along_axis`` and
    ``repro.core.quantize.dequantize`` (``core/fedocs.py``)."""
    from repro.core import quantize as jq

    codes, mask, winner = _decode_operands(case)
    bits = case["bits"]
    jdt, tdt = _DT[case["dtype"]]
    src = torch.from_numpy(codes)
    if case["src"] == "floats":
        # the float features in: floats at the bottom of the codes' buckets
        # (their ties and the lowest code's -inf kept) and, from column 20
        # on, random floats; the JAX composition quantizes them first
        hj = jq.dequantize(jnp.asarray(codes), bits, jdt)
        hj = hj.at[:, :, 20:].set(jnp.asarray(random_floats(
            bits, codes[:, :, 20:].shape, scale=3.0)).astype(jdt))
        codes = np.asarray(jq.quantize(hj, bits))
        src = _pair(np.asarray(hj.astype(jnp.float32)), case["dtype"])[1]
    masked = jnp.where(jnp.asarray(mask)[:, :, None], jnp.asarray(codes), 0)
    want_max = jnp.max(masked, axis=1)
    want = dict(max_code=want_max,
                argmax=jnp.argmax(masked, axis=1).astype(jnp.int32))
    picked = want_max
    if case["winner"]:
        picked = jnp.take_along_axis(jnp.asarray(codes),
                                     jnp.asarray(winner)[:, None], 1)[:, 0]
        want["correct"] = picked == want_max
    want["pooled"] = jq.dequantize(picked, bits, jdt)
    got = MPO.maxpool_decode(
        src, bits, tdt,
        mask=None if case["mask"] == "none" else torch.from_numpy(mask),
        winner=torch.from_numpy(winner) if case["winner"] else None,
        max_code=case["max_code"], argmax=case["argmax"],
        correct=case["correct"])
    assert got.pooled.dtype == tdt
    _same(want["pooled"], got.pooled, "pooled")
    for name in ("max_code", "argmax", "correct"):
        if case[name]:
            _same(want[name], getattr(got, name), name)
        else:
            assert getattr(got, name) is None, name
    if case["mask"] == "lanes" and not case["winner"]:
        # lane 0 is all dark: its max is code 0, which decodes to -inf
        assert bool(torch.isneginf(got.pooled[0]).all())


def test_maxpool_decode_takes_plain_version_on_cpu():
    """On CPU tensors the wrapper is the plain version and launches
    nothing; on any other device it takes the kernel path (here refused),
    never the plain version.  ``correct`` needs a winner."""
    codes = torch.randint(0, 256, (2, 4, 24), dtype=torch.int32).to(
        torch.uint8)
    mask = torch.tensor([True, False, True, True])
    winner = torch.randint(0, 4, (2, 24), dtype=torch.int32)
    before = kernels.launch_counts()["maxpool.decode"]
    kw = dict(mask=mask, winner=winner, max_code=True, argmax=True,
              correct=True)
    got = MPO.maxpool_decode(codes, 8, torch.bfloat16, **kw)
    want = MPR.maxpool_decode(codes, 8, torch.bfloat16, **kw)
    for a, b in zip(got, want):
        _same(a, b)
    assert kernels.launch_counts()["maxpool.decode"] == before
    for fn in (MPO.maxpool_decode, MPR.maxpool_decode):
        with pytest.raises(ValueError, match="winner"):
            fn(codes, 8, torch.float32, correct=True)
    with pytest.raises(ValueError, match="CUDA"):
        MPO.maxpool_decode(codes.to("meta"), 8, torch.float32,
                           winner=winner.to("meta"), correct=True)


# ---------------------------------------------------------------------------
# ocs_contention: packed sensing draws and the tournament
# ---------------------------------------------------------------------------

_CONTEND = list(grid(n=[4], n_real=[4, 3], k=[96], n_slots=[10, 14],
                     total_bits=[10], max_rounds=[1, 3],
                     p_miss=[0.0, 0.2, 0.9], seed=[0, 1])) + \
    list(grid(n=[8], n_real=[5], k=[64], n_slots=[16], total_bits=[14],
              max_rounds=[2], p_miss=[0.15], seed=[3]))


def _contend_operands(case):
    n, k, n_slots = case["n"], case["k"], case["n_slots"]
    rng = np.random.default_rng(case["seed"])
    word = rng.integers(0, 1 << case["total_bits"], (n, k), dtype=np.uint32)
    mask = np.arange(n) < case["n_real"]
    p_keep_j = jocs.sensing_keep_prob(case["p_miss"], jnp.float32)
    heard_j = JCO.draw_heard_packed(
        jax.random.PRNGKey(case["seed"]), p_keep_j, n, k, n_slots=n_slots,
        max_rounds=case["max_rounds"])
    return word, mask, heard_j


@pytest.mark.parametrize("case", _CONTEND, ids=str)
def test_draw_heard_packed_matches_jax(case):
    word, mask, heard_j = _contend_operands(case)
    p_keep = tocs.sensing_keep_prob(torch.tensor([case["p_miss"]]),
                                    lanes=True)
    heard_t = CR.draw_heard_packed(
        jr.PRNGKey(case["seed"])[None], p_keep, case["n"], case["k"],
        n_slots=case["n_slots"], max_rounds=case["max_rounds"])
    _same(np.asarray(heard_j), heard_t[0], "packed planes")


@pytest.mark.parametrize("case", _CONTEND, ids=str)
def test_contend_matches_jax(case):
    word, mask, heard_j = _contend_operands(case)
    kw = dict(n_slots=case["n_slots"], max_rounds=case["max_rounds"])
    tb = case["total_bits"]
    want_k = JCO.contend(jnp.asarray(word), heard_j, jnp.asarray(mask),
                         jnp.int32(tb), **kw)
    want_r = JCR.contend(jnp.asarray(word), heard_j, jnp.asarray(mask),
                         jnp.int32(tb), **kw)
    got = CO.contend(torch.from_numpy(word)[None],
                     torch.from_numpy(np.array(heard_j))[None],
                     torch.from_numpy(mask), tb, **kw)
    for a, b, c, what in zip(want_k, want_r, got,
                             ("winner", "contending", "collided")):
        _same(a, c[0], what + " vs kernel")
        _same(b, c[0], what + " vs ref")


def test_contend_lanes_and_per_lane_mask():
    """Lanes are independent tournaments; a (L, N) mask masks per lane."""
    rng = np.random.default_rng(5)
    lanes, n, k, r, s = 3, 6, 40, 2, 12
    word = rng.integers(0, 1 << 12, (lanes, n, k), dtype=np.uint32)
    heard = rng.integers(0, 1 << 32, (lanes, r, n, k), dtype=np.uint32)
    mask = rng.random((lanes, n)) < 0.7
    mask[:, 0] = True
    got = CO.contend(torch.from_numpy(word), torch.from_numpy(heard),
                     torch.from_numpy(mask), 12, n_slots=s, max_rounds=r)
    for lane in range(lanes):
        want = JCR.contend(jnp.asarray(word[lane]), jnp.asarray(heard[lane]),
                           jnp.asarray(mask[lane]), jnp.int32(12),
                           n_slots=s, max_rounds=r)
        for a, b in zip(want, got):
            _same(a, b[lane])


# the fused tournament's contract: the words of the float features (the
# Eq. 7 code above the id code), the sensing stream of the lane keys drawn
# in the features' type, p_miss scalar or per worker, padded id sub-slots,
# padded workers or a per-lane mask of dark workers, bits 8 and 16
_NOISY = list(grid(dtype=["float32", "bfloat16", "float16"],
                   per_worker=[False, True], id_pad=[0, 2], seed=[0],
                   bits=[8, 16], mask=["padded", "lanes"]))


def _noisy_operands(case, lanes=2, n=6, n_real=5, k=40):
    """Float features (with zeros, huge values and exact code ties),
    mask, p_miss, JAX keys, live sub-slots and the tournament's keywords
    of one case."""
    rng = np.random.default_rng(case["seed"] + case["bits"])
    id_bits = tocs.host_id_bits(n_real)
    h = random_floats(case["seed"], (lanes, n, k), scale=3.0)
    h[:, :, -8:] = h[:, :1, -8:]         # every worker ties on 8 columns
    mask = np.arange(n) < n_real
    if case["mask"] == "lanes":
        mask = rng.random((lanes, n)) < 0.7
        mask[0, :2] = True
    shape = (lanes, n) if case["per_worker"] else (lanes,)
    p_miss = rng.uniform(0.05, 0.6, shape).astype(np.float32)
    keys = np.stack([np.asarray(jax.random.PRNGKey(case["seed"] * 10 + i))
                     for i in range(lanes)]).astype(np.uint32)
    kw = dict(n_slots=case["bits"] + id_bits + case["id_pad"], max_rounds=3)
    return h, mask, p_miss, keys, id_bits, kw


@pytest.mark.parametrize("case", _NOISY, ids=str)
def test_noisy_contention_matches_jax(case):
    """``ops.noisy_contention`` on the CPU (float features in) against the
    JAX package's composition at the channel site, bit for bit: the words
    of ``core/ocs.py`` (``quantize``, the shift, the id codes), its
    ``noisy_contention`` (the Pallas kernel in interpret mode, one lane at
    a time) and the core's accounting (slots, rounds, collisions)."""
    from repro.core import quantize as jq

    h, mask, p_miss, keys, id_bits, kw = _noisy_operands(case)
    bits = case["bits"]
    jdt, tdt = _DT[case["dtype"]]
    hj, ht = _pair(h, case["dtype"])
    p_keep = tocs.sensing_keep_prob(torch.from_numpy(p_miss), tdt,
                                    lanes=True)
    got = CO.noisy_contention(ht, torch.from_numpy(mask), bits, id_bits,
                              torch.from_numpy(keys.astype(np.int64)),
                              p_keep, **kw)
    total = bits + id_bits
    lane_masks = np.broadcast_to(mask, (h.shape[0], h.shape[1]))
    for lane in range(h.shape[0]):
        codes = jq.quantize(hj[lane], bits).astype(jnp.uint32)
        word = (codes << id_bits) | jocs._id_codes(h.shape[1],
                                                   id_bits)[:, None]
        p_keep_j = jocs.sensing_keep_prob(jnp.asarray(p_miss[lane]), jdt)
        _same(p_keep_j, p_keep[lane].reshape(p_keep_j.shape), "p_keep")
        winner, contending, collided = JCO.noisy_contention(
            word, jnp.asarray(lane_masks[lane]), jnp.int32(total),
            jnp.asarray(keys[lane]), p_keep_j, interpret=True, **kw)
        want = dict(
            winner=winner, contending=contending, collided=collided,
            rounds=jnp.sum(contending > 0, dtype=jnp.int32),
            collisions=jnp.sum(collided, dtype=jnp.int32),
            contention_slots=jnp.int32(total) * jnp.sum(contending,
                                                        dtype=jnp.int32))
        for what, a in want.items():
            _same(a, getattr(got, what)[lane], what)


def test_noisy_contention_writes_the_winner_into_out():
    """``out=``: the winner lands in the given (lanes, K) slice of a larger
    buffer, the rest of which stays as it was."""
    h, mask, p_miss, keys, id_bits, kw = _noisy_operands(
        dict(seed=3, bits=8, id_pad=0, per_worker=False, mask="padded"))
    ht = torch.from_numpy(h)
    args = (ht, torch.from_numpy(mask), 8, id_bits,
            torch.from_numpy(keys.astype(np.int64)),
            tocs.sensing_keep_prob(torch.from_numpy(p_miss), lanes=True))
    buf = torch.full((3, h.shape[2]), -7, dtype=torch.int32)
    got = CO.noisy_contention(*args, out=buf[:2], **kw)
    want = CO.noisy_contention(*args, **kw)
    assert got.winner.data_ptr() == buf.data_ptr()
    assert torch.equal(buf[:2], want.winner)
    assert bool((buf[2] == -7).all())
    with pytest.raises(ValueError, match="out"):
        CO.noisy_contention(*args, out=buf, **kw)


# the uniform of one 32-bit draw in p_keep's type, as the kernel computes
# it: (bits taken, mantissa shift, scale of one mantissa step)
_UNIFORM = {torch.float32: (0xFFFFFFFF, 9, 2.0 ** -23),
            torch.bfloat16: (0xFF, 1, 2.0 ** -7),
            torch.float16: (0xFFFF, 6, 2.0 ** -10)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("per_worker", [False, True])
def test_noisy_kernel_index_formula(dtype, per_worker):
    """The scalar derivation ``ocs_contention.noisy`` computes per sensing
    bit gives ``draw_heard_packed``'s bit at sampled (l, r, d, n, k): key
    ``fold_in(fold_in(rng_l, r), d)``, one threefry2x32 hash at counter
    ``c = n * K + k`` split ``(c >> 32, c & 0xffffffff)``, ``bits1 ^
    bits2``, the uniform in p_keep's type, heard = uniform < p_keep."""
    tdt = _DT[dtype][1]
    lanes, n, k, n_slots, rounds = 3, 5, 300, 12, 3
    rng = np.random.default_rng(7)
    keys = jr.split(jr.PRNGKey(11), lanes)
    shape = (lanes, n) if per_worker else (lanes,)
    p_keep = tocs.sensing_keep_prob(
        torch.from_numpy(rng.uniform(0.05, 0.9, shape).astype(np.float32)),
        tdt, lanes=True)
    packed = CR.draw_heard_packed(keys, p_keep, n, k, n_slots=n_slots,
                                  max_rounds=rounds)
    planes = QR.to_int64(packed)
    take, shift, step = _UNIFORM[tdt]
    for l_, r, d, w, col in zip(*(rng.integers(0, hi, 200) for hi in (
            lanes, rounds, n_slots, n, k))):
        key_rd = jr.fold_in(jr.fold_in(keys[l_], int(r)), int(d))
        c = torch.tensor(int(w) * k + int(col), dtype=torch.int64)
        b1, b2 = jr.threefry2x32(key_rd[0], key_rd[1], c >> 32,
                                 c & 0xFFFFFFFF)
        u = ((int(b1 ^ b2) & take) >> shift) * step
        p = float(p_keep[l_, w if per_worker else 0, 0])
        bit = (int(planes[l_, r, w, col]) >> (n_slots - 1 - int(d))) & 1
        assert bit == int(u < p), (l_, r, d, w, col)


# ---------------------------------------------------------------------------
# dispatch: CPU tensors take the plain version, others the kernel or raise
# ---------------------------------------------------------------------------

def test_wrappers_take_plain_version_on_cpu():
    x = torch.randn(4, 4, 32)
    assert torch.equal(QO.encode(x, 8), QR.encode(x, 8))
    codes = QO.encode(x, 16)
    assert torch.equal(QO.decode(codes[0], 16, torch.float32),
                       QR.decode(codes[0], 16, torch.float32))
    v, w = MPO.maxpool_fused(codes, 1)
    rv, rw = MPR.maxpool_fused(codes, 1)
    assert torch.equal(v.to(torch.int32), rv.to(torch.int32))
    assert torch.equal(w, rw)
    g = torch.randn(4, 32)
    assert torch.equal(MPO.maxpool_winner_bwd(w, g, 4, 1),
                       MPR.maxpool_winner_bwd(w, g, 4, 1))
    word = torch.randint(0, 1 << 10, (4, 4, 32), dtype=torch.int32)
    heard = torch.randint(0, 1 << 10, (4, 3, 4, 32), dtype=torch.int32)
    mask = torch.ones(4, dtype=torch.bool)
    a = CO.contend(word, heard, mask, 10, n_slots=10, max_rounds=3)
    b = CR.contend(word, heard, mask, 10, n_slots=10, max_rounds=3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    keys = jr.split(jr.PRNGKey(3), 4)
    p_keep = tocs.sensing_keep_prob(torch.full((4,), 0.2), lanes=True)
    a = CO.noisy_contention(x, mask, 8, 2, keys, p_keep, n_slots=10,
                            max_rounds=3)
    b = CR.noisy_contention(x, mask, 8, 2, keys, p_keep, n_slots=10,
                            max_rounds=3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    # the plain fused forms are their compositions
    assert torch.equal(CR.contention_words(x, 8, 2)[0].view(torch.int32),
                       ((QR.encode(x, 8).to(torch.int32) << 2)
                        | (3 - torch.arange(4, dtype=torch.int32))[:, None])
                       [0])
    for f_kw in (dict(argmax=True), dict(mask=mask[None].expand(4, 4),
                                         winner=w, correct=True)):
        assert all(y is None or torch.equal(x_, y) for x_, y in zip(
            MPO.maxpool_decode(x, 8, torch.float32, **f_kw),
            MPR.maxpool_decode(QR.encode(x, 8), 8, torch.float32, **f_kw)))


def test_wrappers_never_run_the_plain_version_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel path, which here
    refuses it (a CUDA tensor would launch): no quiet plain fallback."""
    x = torch.empty((4, 4, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        QO.encode(x, 8)
    with pytest.raises(ValueError, match="CUDA"):
        QO.decode(torch.empty((4, 32), dtype=torch.uint8, device="meta"), 8,
                  torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        MPO.maxpool_fused(x, 1)
    with pytest.raises(ValueError, match="CUDA"):
        MPO.maxpool_winner_bwd(
            torch.empty((4, 32), dtype=torch.int32, device="meta"),
            torch.empty((4, 32), device="meta"), 4, 1)
    with pytest.raises(ValueError, match="CUDA"):
        CO.contend(torch.empty((1, 4, 32), dtype=torch.int32, device="meta"),
                   torch.empty((1, 3, 4, 32), dtype=torch.int32,
                               device="meta"),
                   torch.ones(4, dtype=torch.bool), 10, n_slots=10,
                   max_rounds=3)
    with pytest.raises(ValueError, match="CUDA"):
        CO.noisy_contention(
            torch.empty((1, 4, 32), device="meta"),
            torch.ones(4, dtype=torch.bool, device="meta"), 8, 2,
            torch.empty((1, 2), dtype=torch.int64, device="meta"),
            torch.empty((1, 1, 1), device="meta"), n_slots=10, max_rounds=3)
    with pytest.raises(ValueError, match="CUDA"):
        MPO.maxpool_decode(x, 8, torch.float32, argmax=True)


def test_wide_codes_refused_on_the_card_path():
    x = torch.empty((4, 32), device="meta")
    with pytest.raises(ValueError, match="at most 16 bits"):
        QO.encode(x, 24)
    # the pooling epilogue forms codes of at most 16 bits from floats too
    with pytest.raises(ValueError, match="1 to 16 bits"):
        MPO.maxpool_decode(x[None], 24, torch.float32, argmax=True)


# ---------------------------------------------------------------------------
# flash attention: the plain version (what the port runs on the CPU) against
# the JAX Pallas kernel in interpret mode, at tests/test_kernels_flash.py's
# cases and tolerances (the streaming kernel sums in another order than the
# whole-matrix softmax: atol 3e-5 in float32, 0.05 in bfloat16)
# ---------------------------------------------------------------------------

from repro.kernels.flash_attention import flash_attention as JFK  # noqa: E402
from repro.kernels.flash_attention import ops as JFO  # noqa: E402
from repro.kernels.flash_attention import ref as JFR  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FO  # noqa: E402
from repro_torch.kernels.flash_attention import ref as FR  # noqa: E402

_FLASH = (list(grid(h=[4], hkv=[1, 2, 4], s=[128, 192], d=[64], seed=[0, 1],
                    causal=[True, False], dtype=["float32"], atol=[3e-5]))
          + list(grid(h=[2], hkv=[2], s=[128], d=[64], seed=[0],
                      causal=[True], dtype=["bfloat16"], atol=[0.05])))


def _flash_qkv(case):
    rng = np.random.default_rng(case["seed"])
    b, h, hkv, s, d = 1, case["h"], case["hkv"], case["s"], case["d"]
    return [_pair(rng.standard_normal(shape), case["dtype"])
            for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d))]


@pytest.mark.parametrize("case", _FLASH, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items() if k not in ("d", "atol")))
def test_flash_forward_matches_jax_kernel(case):
    (qj, qt), (kj, kt), (vj, vt) = _flash_qkv(case)
    want = JFK.flash_attention(qj, kj, vj, causal=case["causal"],
                               block_q=64, block_k=64)
    got = FO.flash_attention(qt, kt, vt, case["causal"], 64, 64)
    assert got.dtype == _DT[case["dtype"]][1] and got.shape == qt.shape
    err = np.max(np.abs(np.asarray(want.astype(jnp.float32))
                        - got.float().numpy()))
    assert err <= case["atol"], err
    # and the two plain versions agree with each other as tightly
    ref = JFR.flash_attention(qj, kj, vj, causal=case["causal"])
    err = np.max(np.abs(np.asarray(ref.astype(jnp.float32))
                        - FR.flash_attention(qt, kt, vt,
                                             case["causal"]).float().numpy()))
    assert err <= case["atol"], err


def test_flash_gradient_matches_jax():
    """The recompute backward against ``jax.vjp`` of the JAX ``ops``
    wrapper (the test_kernels_flash.py case: cotangent ``2 * out``, the
    gradient of ``sum(out ** 2)``; grad atol 1e-4)."""
    case = dict(h=2, hkv=1, s=64, d=32, seed=1, dtype="float32")
    (qj, qt), (kj, kt), (vj, vt) = _flash_qkv(case)
    out_j, vjp = jax.vjp(lambda q, k, v: JFO.flash_attention(q, k, v, True),
                         qj, kj, vj)
    grads_j = vjp(2.0 * out_j)
    prim = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
    out_t = FO.flash_attention(*prim, causal=True)
    grads_t = torch.autograd.grad(out_t, prim, 2.0 * out_t.detach())
    assert np.max(np.abs(np.asarray(out_j) - out_t.detach().numpy())) <= 3e-5
    for gj, gt in zip(grads_j, grads_t):
        assert np.max(np.abs(np.asarray(gj) - gt.numpy())) <= 1e-4


def test_flash_wrapper_contract():
    """The JAX wrapper's shape asserts, as ValueErrors; a tensor off the
    CPU goes to the kernel path (here refused: no CUDA), never the plain
    version."""
    q = torch.randn(1, 4, 192, 64)
    kv = torch.randn(1, 2, 192, 64)
    with pytest.raises(ValueError, match="multiples"):
        FO.flash_attention(q, kv, kv)                 # 192 % 128
    FO.flash_attention(q, kv, kv, block_q=64, block_k=64)
    FO.flash_attention(q[:, :, :5], kv[:, :, :5], kv[:, :, :5])  # S < block
    with pytest.raises(ValueError, match="pair"):
        FO.flash_attention(q, torch.randn(1, 3, 192, 64),
                           torch.randn(1, 3, 192, 64), block_q=64,
                           block_k=64)
    m = torch.empty((1, 4, 128, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        FO.flash_attention(m, m, m)
    m = torch.empty((1, 4, 128, 48), device="meta")
    with pytest.raises(ValueError, match="head_dim"):
        FO.flash_attention(m, m, m)


# -- the custom ops a fake tensor takes -------------------------------------

def _fake_cases():
    """(name, wrapper call on (h, operands)) of each kernel whose wrapper
    takes a fake tensor through its custom op."""
    def contend(h, o):
        word = CR.contention_words(h, 8, 2)
        heard = CR.draw_heard_packed(o["rng"], o["p"], 4, 16, n_slots=10,
                                     max_rounds=3)
        return CO.contend(word, heard, o["mask"], 10, n_slots=10,
                          max_rounds=3)

    return {
        "ocs_encode": lambda h, o: QO.encode(h, 8),
        "ocs_decode": lambda h, o: QO.decode(QO.encode(h, 12), 12,
                                             torch.bfloat16),
        "maxpool_decode": lambda h, o: MPO.maxpool_decode(
            h, 8, torch.float32, mask=o["mask"], winner=o["win"],
            max_code=True, argmax=True, correct=True),
        "maxpool_decode_codes": lambda h, o: MPO.maxpool_decode(
            QO.encode(h, 8), 8, torch.float16, dim=1, max_code=True),
        "maxpool_decode_out": lambda h, o: MPO.maxpool_decode(
            h, 8, torch.float32, argmax=True, out=MPR.PoolDecode(
                torch.empty((3, 16)), None,
                torch.empty((3, 16), dtype=torch.int32), None)),
        "maxpool_winner_bwd": lambda h, o: MPO.maxpool_winner_bwd(
            o["win"], h[:, 0], 4, 1),
        "ocs_noisy": lambda h, o: CO.noisy_contention(
            h, o["mask"], 8, 2, o["rng"], o["p"], n_slots=10, max_rounds=3),
        "ocs_noisy_out": lambda h, o: CO.noisy_contention(
            h, o["mask"], 8, 2, o["rng"], o["p"], n_slots=10, max_rounds=3,
            out=torch.empty((3, 16), dtype=torch.int32)),
        "ocs_contend": contend,
    }


@pytest.mark.parametrize("case", sorted(_fake_cases()))
def test_custom_op_fake_outputs_match_the_plain_version(case):
    """On fake tensors each wrapper runs its ``repro_torch::`` custom op,
    whose fake impl gives the plain version's outputs: shapes, dtypes and
    strides.  A real CPU tensor takes the plain version directly."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.analysis.contracts import OpRecorder
    fn = _fake_cases()[case]
    h = torch.randn((3, 4, 16), generator=torch.Generator().manual_seed(0))
    ops = {"mask": torch.tensor([True, True, False, True]),
           "rng": jr.split(jr.PRNGKey(0), 3),
           "p": torch.full((3, 1, 1), 0.9),
           "win": torch.randint(0, 4, (3, 16), dtype=torch.int32,
                                generator=torch.Generator().manual_seed(1))}

    def meta(x):
        if isinstance(x, torch.Tensor):
            return (tuple(x.shape), x.dtype, x.stride())
        return None if x is None else [meta(t) for t in x]

    want = fn(h, ops)
    mode = FakeTensorMode()
    with mode:
        fh = mode.from_tensor(h)
        fo = {k: mode.from_tensor(v) for k, v in ops.items()}
        with OpRecorder() as rec:
            got = fn(fh, fo)
    assert meta(got) == meta(want)
    op = "repro_torch." + case.replace("_codes", "").replace("_out", "")
    assert any(o.name.startswith(op + ".") for o in rec.stream)
    # a real CPU tensor takes the plain version, not the custom op
    with OpRecorder() as rec:
        fn(h, ops)
    assert not any(o.name.startswith("repro_torch.") for o in rec.stream)
