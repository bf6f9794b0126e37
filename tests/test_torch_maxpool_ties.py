"""The ``tie_break="all"`` max law against the JAX package, bit for bit:
its forward (the pooled max and the tie mask that ``maxpool.fwd`` writes)
and its tie-routed backward (``maxpool.ties_bwd``), through the plain
versions that the port runs on the CPU, and through
``fedocs.maxpool(h, "all")`` against ``jax.vjp`` of the JAX law.  A NaN
compares as a NaN: its payload is the device's.  The law keeps only the
tie mask for its backward, and an LM step keeps none of the partials it
pools.

``tests/test_torch_cuda.py`` holds the CUDA kernels to these plain
versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proptest import grid
from repro.core import fedocs as jfed
from repro.kernels.maxpool import maxpool as JMP
from repro_torch import kernels, tree
from repro_torch.configs import get_reduced
from repro_torch.core import fedocs as tfed
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels.maxpool import ops as MPO
from repro_torch.kernels.maxpool import ref as MPR
from repro_torch.models import model as TM

torch.set_num_threads(1)

_DT = {"float32": (jnp.float32, torch.float32, np.uint32, torch.int32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16, np.uint16, torch.int16)}


def _pair(x_np, dtype):
    jdt, tdt = _DT[dtype][:2]
    xj = jnp.asarray(x_np).astype(jdt)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)


def _same_nan_as_nan(a_j, b_t, dtype, what=""):
    """Raw bits equal where not NaN; NaN at the same places."""
    npu, tint = _DT[dtype][2:]
    a = np.asarray(a_j)
    b = b_t.detach().contiguous()
    nan_a = np.isnan(a.astype(np.float32))
    nan_b = torch.isnan(b).numpy()
    assert a.shape == tuple(b.shape), (what, a.shape, b.shape)
    assert np.array_equal(nan_a, nan_b), what
    bits_a = a.view(npu)[~nan_a]
    bits_b = b.view(tint).numpy().view(npu)[~nan_b]
    assert np.array_equal(bits_a, bits_b), what


def _inputs(kind, n, seed, shape=(6, 40)):
    """(h, g) as float32 numpy: ``grid`` values on a coarse grid (many
    workers tie at the max); ``zeros`` -0.0 and +0.0 tied at a zero max
    in most columns; ``nan`` NaNs in h, among them a whole row, a column
    whose first NaN follows a number and a negative NaN.  g holds +-0, +-inf and a
    NaN."""
    rng = np.random.default_rng(seed)
    h = (rng.integers(-3, 3, (n,) + shape) / 2).astype(np.float32)
    if kind == "zeros":
        h = np.minimum(h, 0.0)
        h[rng.random(h.shape) < 0.5] = -0.0
    elif kind == "nan":
        h[min(1, n - 1)] = np.nan
        h[n - 1, 0, :5] = np.nan
        h[:, 2, 3] = -np.inf
        h[:, 3, 9:] = 0.5
        h.view(np.uint32)[n - 1, 3, 9] = 0xFFC00001       # a negative NaN
    g = rng.standard_normal(shape).astype(np.float32)
    flat = g.reshape(-1)
    flat[:5] = [0.0, -0.0, np.inf, -np.inf, np.nan]
    return h, g


def _unpack(mask: torch.Tensor, n: int) -> np.ndarray:
    """The tie mask's words (axis 0) as n bools per column."""
    words = mask.view(torch.int16).to(torch.int64).numpy() & 0xFFFF
    k = np.arange(n)
    shift = (k % MPR.TIE_BITS).reshape((n,) + (1,) * (words.ndim - 1))
    return ((words[k // MPR.TIE_BITS] >> shift) & 1) == 1


_CASES = list(grid(kind=["grid", "zeros", "nan"], n=[1, 4, 16, 17, 33],
                   dtype=["float32", "bfloat16"]))


@pytest.mark.parametrize("case", _CASES, ids=str)
def test_maxpool_ties_matches_jax(case):
    """The pooled max is ``jnp.max``; bit k of the mask is JAX's ``h ==
    max`` for worker k (-0.0 ties +0.0, a NaN max ties no worker), in
    ``ceil(n / 16)`` uint16 words."""
    n, dtype = case["n"], case["dtype"]
    h, _ = _inputs(case["kind"], n, seed=n)
    hj, ht = _pair(h, dtype)
    pooled, mask = MPO.maxpool_ties(ht, 0)
    want = jnp.max(hj, axis=0)
    _same_nan_as_nan(want, pooled, dtype, "pooled")
    assert mask.dtype == torch.uint16
    assert mask.shape == (MPR.tie_words(n),) + ht.shape[1:]
    assert np.array_equal(_unpack(mask, n), np.asarray(hj == want[None]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_maxpool_ties_pooled_matches_pallas_kernel(dtype):
    """The pooled max is also the TPU kernel's (interpret mode)."""
    h, _ = _inputs("grid", 4, seed=7, shape=(8, 128))
    hj, ht = _pair(h, dtype)
    _same_nan_as_nan(JMP.maxpool_fused(hj)[0], MPO.maxpool_ties(ht, 0)[0],
                     dtype)


@pytest.mark.parametrize("case", _CASES, ids=str)
def test_ties_bwd_matches_jax(case):
    """From the mask, the gradient is the JAX law's ``g * (h == max)``:
    g in the tied rows, g * 0 (a signed zero, NaN for +-inf) in the
    others."""
    n, dtype = case["n"], case["dtype"]
    h, g = _inputs(case["kind"], n, seed=100 + n)
    hj, ht = _pair(h, dtype)
    gj, gt = _pair(g, dtype)
    pooled = jnp.max(hj, axis=0)
    want = gj[None] * (hj == pooled[None]).astype(hj.dtype)
    mask = MPO.maxpool_ties(ht, 0)[1]
    _same_nan_as_nan(want, MPO.maxpool_ties_bwd(mask, gt, n, 0), dtype)


@pytest.mark.parametrize("case", _CASES, ids=str)
def test_all_law_matches_jax_vjp(case):
    """``fedocs.maxpool(h, "all")``: forward and input gradient bitwise
    ``jax.vjp`` of ``repro.core.fedocs.maxpool(h, "all")``."""
    n, dtype = case["n"], case["dtype"]
    h, g = _inputs(case["kind"], n, seed=200 + n)
    hj, ht = _pair(h, dtype)
    gj, gt = _pair(g, dtype)
    out_j, vjp = jax.vjp(lambda x: jfed.maxpool(x, "all"), hj)
    (dj,) = vjp(gj)
    ht = ht.clone().requires_grad_(True)
    out_t = tfed.maxpool(ht, "all")
    (dt,) = torch.autograd.grad(out_t, ht, gt)
    _same_nan_as_nan(out_j, out_t, dtype, "forward")
    _same_nan_as_nan(dj, dt, dtype, "gradient")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_all_law_lane_axis_matches_jax_per_lane(dtype):
    """Pooled over axis 1 of a lane-leading stack, each lane is the JAX
    law on that lane."""
    h = np.stack([_inputs(k, 5, seed=300 + i)[0]
                  for i, k in enumerate(["grid", "zeros", "nan"])])
    g = _inputs("grid", 5, seed=310, shape=(3, 6, 40))[1]
    hj, ht = _pair(h, dtype)
    gj, gt = _pair(g, dtype)
    ht = ht.clone().requires_grad_(True)
    out_t = tfed.maxpool(ht, "all", dim=1)
    (dt,) = torch.autograd.grad(out_t, ht, gt)
    for lane in range(3):
        out_j, vjp = jax.vjp(lambda x: jfed.maxpool(x, "all"), hj[lane])
        _same_nan_as_nan(out_j, out_t[lane], dtype, f"forward {lane}")
        _same_nan_as_nan(vjp(gj[lane])[0], dt[lane], dtype, f"grad {lane}")


def _saved(fn):
    """The tensors autograd saves while ``fn`` runs, and its result."""
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return saved, out


@pytest.mark.parametrize("tie_break", ["all", "first"])
def test_max_law_saves_one_small_tensor(tie_break):
    """``"all"`` keeps only the uint16 tie mask (one word per column at
    16 workers), ``"first"`` only the int32 winner: neither keeps h, whose
    size is 16 x a column's."""
    h = torch.randn((16, 8, 32)).requires_grad_(True)
    saved, out = _saved(lambda: tfed.maxpool(h, tie_break))
    assert len(saved) == 1, [(t.dtype, t.shape) for t in saved]
    want = ((torch.uint16, (1, 8, 32)) if tie_break == "all"
            else (torch.int32, (8, 32)))
    assert (saved[0].dtype, tuple(saved[0].shape)) == want
    assert saved[0].numel() < h.numel()
    assert out.shape == (8, 32)


def test_lm_step_keeps_no_partials(monkeypatch):
    """In an LM forward with ``tp_fusion="max"`` (the reduced qwen
    config), no tensor that autograd saves shares storage with a max
    site's worker partials: the matmuls that make them save their inputs,
    and the law saves its mask.  So the partials are freed after each
    site's forward."""
    partials = []
    law = tfed.maxpool

    def recording(h, tie_break="all", dim=0):
        partials.append(h)          # held: no later tensor reuses its memory
        return law(h, tie_break, dim)

    monkeypatch.setattr(tfed, "maxpool", recording)
    cfg = get_reduced("qwen1.5-0.5b", n_layers=2, d_model=32, n_heads=2,
                      n_kv_heads=2, d_ff=64, vocab_size=128, n_workers=2,
                      tp_fusion="max")
    assert cfg.tie_break == "all"
    m = TM.build(cfg)
    values = m.init(torch.Generator().manual_seed(0))
    leaves = [t.requires_grad_(True) for t in tree.leaves(values)]
    pcfg = tpipe.for_model(cfg, batch=2, seq_len=8, seed=1)
    saved, (loss, _) = _saved(lambda: m.loss(values, tpipe.batch_for_step(
        pcfg, 0, device="cpu")))
    assert len(partials) == 2 * cfg.n_layers
    part = {p.untyped_storage().data_ptr() for p in partials}
    assert not part & {t.untyped_storage().data_ptr() for t in saved}
    masks = [t for t in saved if t.dtype == torch.uint16]
    assert len(masks) == len(partials)
    assert all(t.shape == (1,) + p.shape[1:] for t, p in zip(masks, partials))
    torch.autograd.grad(loss, leaves)


def test_tie_wrappers_take_plain_version_on_cpu():
    h = torch.randn(4, 3, 32)
    before = kernels.launch_counts()
    got = MPO.maxpool_fwd(h, 1, winner=True, ties=True)
    want = MPR.maxpool_fwd(h, 1, winner=True, ties=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    pooled, mask = MPO.maxpool_ties(h, 1)
    assert torch.equal(pooled, want.pooled)
    assert torch.equal(mask, want.ties)
    assert MPO.maxpool_fwd(h, 1, winner=False).winner is None
    g = torch.randn(4, 32)
    assert torch.equal(MPO.maxpool_ties_bwd(mask, g, 3, 1),
                       MPR.ties_bwd(mask, g, 3, 1))
    assert kernels.launch_counts() == before


def test_tie_wrappers_never_run_the_plain_version_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel path, which here
    refuses it (a CUDA tensor would launch): no quiet plain fallback."""
    x = torch.empty((4, 3, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        MPO.maxpool_ties(x, 1)
    with pytest.raises(ValueError, match="CUDA"):
        MPO.maxpool_fwd(x, 1, winner=False)
    with pytest.raises(ValueError, match="CUDA"):
        MPO.maxpool_ties_bwd(
            torch.empty((4, 1, 32), dtype=torch.uint16, device="meta"),
            torch.empty((4, 32), device="meta"), 3, 1)
    with pytest.raises(ValueError, match="uint16 of shape"):
        MPO.maxpool_ties_bwd(
            torch.empty((4, 2, 32), dtype=torch.uint16, device="meta"),
            torch.empty((4, 32), device="meta"), 3, 1)
