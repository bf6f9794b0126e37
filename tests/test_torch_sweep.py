"""The port's scenario sweep (``repro_torch.sim.{scenarios, sweep,
results}``) and its clean Alg. 1 core (``repro_torch.core.ocs``) against
the JAX package's.

Everything here is integer accounting, selected values and codes, so it
is held bit for bit: every field of ``OCSResult`` / ``NoisyOCSResult``,
both latencies, in the JAX package's dtypes (float values in their raw
bits), the sweep records key for key and value for value, and the rows
string for string.  The JAX sweep runs on its single-device vmap path
(``n_devices=1``) with the ``"scan"`` backend.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proptest import random_floats
from repro.core import ocs as jocs
from repro.sim import results as jresults
from repro.sim import scenarios as jscen
from repro.sim import sweep as jsweep
from repro_torch import random as jr
from repro_torch.core import ocs as tocs
from repro_torch.serve import load as tload
from repro_torch.sim import results as tresults
from repro_torch.sim import scenarios as tscen
from repro_torch.sim import sweep as tsweep

torch.set_num_threads(1)

CLEAN_FIELDS = tuple(f.name for f in dataclasses.fields(tocs.OCSResult))
NOISY_FIELDS = tuple(f.name for f in dataclasses.fields(tocs.NoisyOCSResult))


def _np(x) -> np.ndarray:
    """A result field on the host, unsigned codes as numpy's unsigned
    type, float values as their raw bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype in (torch.uint16, torch.uint32):
            a = tocs.to_int64(x).numpy()
            x = a.astype(np.uint16 if x.dtype == torch.uint16 else np.uint32)
        else:
            x = x.numpy()
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same(got, want, what) -> None:
    g, w = _np(got), _np(want)
    assert g.dtype == w.dtype, (what, g.dtype, w.dtype)
    assert np.array_equal(g, w), (what, g, w)


def _mixed(m):
    """A mixed grid of the package ``m``: N 2/4/16/64, bits 8/16, scalar
    and near/far p_miss, 1 and 4 channels."""
    return [
        m.Scenario("mix/N2_b8", n_workers=2, bits=8),
        m.Scenario("mix/N4_b16_c4", n_workers=4, bits=16, p_miss=0.1,
                   n_channels=4),
        m.Scenario("mix/N16_b8_nf", n_workers=16, bits=8,
                   p_miss=m.near_far_p_miss(16, 0.0, 0.3)),
        m.Scenario("mix/N64_b16", n_workers=64, bits=16, p_miss=0.05),
        m.Scenario("mix/N16_b16_c4", n_workers=16, bits=16, p_miss=0.2,
                   n_channels=4),
        m.Scenario("mix/N64_b8_nf_c4", n_workers=64, bits=8,
                   p_miss=m.near_far_p_miss(64, 0.01, 0.1), n_channels=4),
        m.Scenario("mix/N4_b8", n_workers=4, bits=8, p_miss=0.3),
    ]


SWEEP_KW = dict(k_elems=24, rounds=3, seed=2, rng_seed=5)


@pytest.fixture(scope="module")
def mixed_sweeps():
    want = jsweep.run_sweep(_mixed(jscen), n_devices=1, **SWEEP_KW)
    tsweep.reset_dispatch_counts()
    got = tsweep.run_sweep(_mixed(tscen), device="cpu", **SWEEP_KW)
    return want, got, tsweep.dispatch_counts()


# ---------------------------------------------------------------------------
# the clean Alg. 1 core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 16, 33, 64])
def test_clean_core_matches_jax_bitwise(n, bits):
    h = random_floats(n * 100 + bits, (n, 37))
    h[:, :6] = h[:1, :6]                    # every worker ties there
    want = jocs.ocs_maxpool(jnp.asarray(h), bits)
    got = tocs.ocs_maxpool(torch.from_numpy(h), bits)
    for f in CLEAN_FIELDS:
        _assert_same(getattr(got, f), getattr(want, f), f)
    w, v, c = jocs.reference_maxpool(jnp.asarray(h), bits)
    tw, tv, tc_ = tocs.reference_maxpool(torch.from_numpy(h), bits)
    for g, x, name in ((tw, w, "winner"), (tv, v, "value"),
                       (tc_, c, "pooled_code")):
        _assert_same(g, x, name)
    # the protocol outcome is the argmax oracle's
    _assert_same(got.winner, w, "winner vs oracle")
    _assert_same(got.pooled_code, c, "code vs oracle")


@pytest.mark.parametrize("bits", [8, 16])
def test_padded_lane_core_matches_jax_per_lane(bits):
    """Lanes of different real worker counts (and so id_bits) in one
    padded call equal the JAX core per lane, accounting included."""
    n_max, k = 20, 29
    reals = [1, 2, 7, 20]
    h = random_floats(bits, (len(reals), n_max, k), specials=False)
    h[:, :, :4] = h[:, :1, :4]
    mask = np.arange(n_max)[None] < np.asarray(reals)[:, None]
    idb = [tocs.host_id_bits(n) for n in reals]
    got = tocs.ocs_maxpool_core(torch.from_numpy(h), torch.from_numpy(mask),
                                torch.tensor(idb), bits=bits,
                                max_id_bits=tocs.host_id_bits(n_max))
    for li in range(len(reals)):
        want = jocs.ocs_maxpool_core(
            jnp.asarray(h[li]), jnp.asarray(mask[li]), idb[li], bits=bits,
            max_id_bits=tocs.host_id_bits(n_max))
        for f in CLEAN_FIELDS:
            _assert_same(getattr(got, f)[li], getattr(want, f), (li, f))


def test_multichannel_matches_jax():
    h = random_floats(4, (6, 40))
    want = jocs.ocs_maxpool_multichannel(jnp.asarray(h), bits=8,
                                         n_channels=3)
    got = tocs.ocs_maxpool_multichannel(torch.from_numpy(h), bits=8,
                                        n_channels=3)
    _assert_same(got.latency_slots, want.latency_slots, "latency")
    for f in CLEAN_FIELDS:
        _assert_same(getattr(got.result, f), getattr(want.result, f), f)


def test_clean_core_validation():
    with pytest.raises(ValueError, match="overflows uint32"):
        tocs.ocs_maxpool(torch.zeros((4, 8)), bits=32)
    with pytest.raises(ValueError, match=r"h must be \(N, K\)"):
        tocs.ocs_maxpool(torch.zeros((2, 4, 8)))


# ---------------------------------------------------------------------------
# run_sweep against the JAX package's vmap path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine,field", [
    *(("clean", f) for f in CLEAN_FIELDS + ("latency_slots",)),
    *(("noisy", f) for f in NOISY_FIELDS + ("latency_slots",))])
def test_sweep_matches_jax_bitwise(mixed_sweeps, engine, field):
    want, got, _ = mixed_sweeps
    if field == "latency_slots":
        g = getattr(got, f"{engine}_latency_slots")
        w = getattr(want, f"{engine}_latency_slots")
    else:
        g, w = getattr(getattr(got, engine), field), \
            getattr(getattr(want, engine), field)
    _assert_same(g, w, (engine, field))


def test_sweep_inputs_and_one_call_per_group(mixed_sweeps):
    want, got, counts = mixed_sweeps
    assert got.n_max == want.n_max == 64
    assert np.array_equal(got.h, want.h) and np.array_equal(got.mask,
                                                           want.mask)
    # one clean core call per bits value; one noisy per (bits, id_bits):
    # bits 8 -> id_bits {1, 2, 4, 6}, bits 16 -> {2, 4, 6}
    assert counts == {"clean": 2, "noisy": 7}, counts
    # the lanes really saw noise
    assert 0 < got.noisy.correct.mean() < 1
    assert got.noisy.collisions.sum() > 0


def test_records_and_rows_match_jax(mixed_sweeps, tmp_path):
    want, got, _ = mixed_sweeps
    rw, rg = jresults.summarize(want), tresults.summarize(got)
    assert len(rw) == len(rg)
    for a, b in zip(rw, rg):
        assert list(a) == list(b)
        for key in a:
            assert type(a[key]) is type(b[key]), key
            assert a[key] == b[key], (key, a[key], b[key])
    assert tresults.to_json(rg) == jresults.to_json(rw)
    assert tresults.to_rows(rg) == jresults.to_rows(rw)
    out = tmp_path / "sweep.json"
    tresults.write_json(rg, str(out))
    assert json.loads(out.read_text()) == json.loads(jresults.to_json(rw))


def test_noisy_padding_is_inert():
    """Within one padded shape, the scan-length bound and the padded rows'
    contents do not perturb the noisy core (the JAX test's property)."""
    for seed in range(3):
        h = random_floats(seed, (6, 24), specials=False)
        key = jr.PRNGKey(seed)[None]
        mask = torch.arange(16) < 6
        h_pad = torch.zeros((1, 16, 24))
        h_pad[0, :6] = torch.from_numpy(h)
        h_bad = h_pad.clone()
        h_bad[0, 6:] = 1e9                  # would win any contention
        id_bits = tocs.host_id_bits(6)
        p = torch.tensor([0.07])
        a = tocs.ocs_maxpool_noisy_core(h_pad, mask, id_bits, key, p,
                                        bits=12, max_id_bits=id_bits)
        for hh in (h_pad, h_bad):
            b = tocs.ocs_maxpool_noisy_core(
                hh, mask, id_bits, key, p, bits=12,
                max_id_bits=tocs.host_id_bits(16))
            for f in NOISY_FIELDS:
                _assert_same(getattr(b, f), getattr(a, f), f)
        assert bool((a.winner < 6).all())


def test_zero_miss_noisy_sweep_reduces_to_clean():
    cells = tscen.scenario_grid(n_workers=(3, 8), bits=(8, 16),
                                p_miss=(0.0,))
    sw = tsweep.run_sweep(cells, k_elems=21, rounds=2, seed=5,
                          device="cpu")
    assert np.array_equal(sw.noisy.winner, sw.clean.winner)
    assert sw.noisy.correct.all()
    assert not sw.noisy.collisions.any()
    assert np.array_equal(sw.noisy.rounds, np.ones_like(sw.noisy.rounds))


def test_mixed_bits_grid_uses_per_group_id_bits():
    """A wide-bits cell beside a large-N narrow-bits cell must not
    overflow: the scan bound is per bits group (bits 24 + id_bits 2 next
    to N 512's id_bits 9)."""
    cells = [tscen.Scenario("mix/wide", n_workers=4, bits=24),
             tscen.Scenario("mix/huge", n_workers=512, bits=8)]
    want = jsweep.run_sweep(
        [jscen.Scenario(s.name, n_workers=s.n_workers, bits=s.bits)
         for s in cells], k_elems=8, rounds=1, n_devices=1)
    got = tsweep.run_sweep(cells, k_elems=8, rounds=1, device="cpu")
    for engine, fields in (("clean", CLEAN_FIELDS), ("noisy", NOISY_FIELDS)):
        for f in fields:
            _assert_same(getattr(getattr(got, engine), f),
                         getattr(getattr(want, engine), f), (engine, f))
    for i, s in enumerate(cells):
        ref = tocs.ocs_maxpool(torch.from_numpy(got.scenario_h(i)[0]),
                               bits=s.bits)
        cell = got.clean_cell(i, 0)
        assert np.array_equal(cell.winner, ref.winner.numpy())
        assert int(cell.contention_slots) == int(ref.contention_slots)


def test_near_far_scenario_matches_unbatched_vector_p():
    """A per-worker p_miss scenario equals the unbatched noisy protocol
    with the same (N,) vector at the sweep's key, and a tuple of equal
    entries equals the scalar scenario."""
    nf = tscen.near_far_p_miss(8, 0.0, 0.3)
    cells = [tscen.Scenario("t/nf", n_workers=8, bits=12, p_miss=nf),
             tscen.Scenario("t/flat_vec", n_workers=8, bits=12,
                            p_miss=(0.05,) * 8),
             tscen.Scenario("t/flat", n_workers=8, bits=12, p_miss=0.05)]
    sw = tsweep.run_sweep(cells, k_elems=24, rounds=2, rng_seed=9,
                          include_clean=False, device="cpu")
    keys = jr.split(jr.PRNGKey(9), 3 * 2).reshape(3, 2, 2)
    for i, p in ((0, torch.tensor(nf, dtype=torch.float32)), (1, 0.05)):
        for r in range(2):
            ref = tocs.ocs_maxpool_noisy(
                torch.from_numpy(sw.scenario_h(i)[r]), keys[i, r], bits=12,
                p_miss=p)
            cell = sw.noisy_cell(i, r)
            for f in NOISY_FIELDS:
                _assert_same(getattr(cell, f), getattr(ref, f), (i, r, f))
    one = [tsweep.run_sweep([c], k_elems=24, rounds=1, rng_seed=3,
                            include_clean=False, device="cpu")
           for c in cells[1:]]
    for f in NOISY_FIELDS:
        _assert_same(getattr(one[0].noisy, f), getattr(one[1].noisy, f), f)


def test_sweep_placement_and_device():
    cells = [tscen.Scenario("t/a", n_workers=2)]
    with pytest.raises(ValueError, match="no process group"):
        tsweep.run_sweep(cells, n_devices=2, device="cpu")
    sw = tsweep.run_sweep(cells, k_elems=4, n_devices=1, device="cpu")
    assert sw.device == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsweep.run_sweep(cells)
    with pytest.raises(ValueError, match="at least one scenario"):
        tsweep.run_sweep([], device="cpu")
    with pytest.raises(ValueError, match="h shape"):
        tsweep.run_sweep(cells, k_elems=4, device="cpu",
                         h_by_scenario=[np.zeros((1, 3, 4), np.float32)])


# ---------------------------------------------------------------------------
# scenarios: registry, grid, validation
# ---------------------------------------------------------------------------

def test_registry_matches_jax():
    assert tscen.names() == jscen.names()
    for name in jscen.names():
        a, b = jscen.get(name), tscen.get(name)
        assert dataclasses.asdict(a) == dataclasses.asdict(b), name
        pa, pb = a.protocol(), b.protocol()
        assert np.array_equal(np.asarray(pa.p_miss), np.asarray(pb.p_miss))
        for f in ("kind", "bits", "n_channels", "payload_bits",
                  "max_rounds"):
            assert getattr(pa, f) == getattr(pb, f), (name, f)
        assert dataclasses.asdict(pa.comm_load(a.n_workers, 64)) == \
            dataclasses.asdict(pb.comm_load(b.n_workers, 64))
    with pytest.raises(KeyError, match="unknown scenario"):
        tscen.get("no_such_scenario")
    with pytest.raises(ValueError, match="already registered"):
        tscen.register(tscen.Scenario("dense_cell", n_workers=2))


@pytest.mark.parametrize("name", ["burst_cell", "worker_outage_cell"])
def test_fault_spec_model_matches_jax(name):
    a, b = jscen.get(name).fault.model(), tscen.get(name).fault.model()
    assert (a.policy.kind, a.policy.retry_budget) == (b.policy.kind,
                                                      b.policy.retry_budget)
    for f in ("p_gb", "p_bg", "p_miss_good", "p_miss_bad", "p_drop",
              "p_recover"):
        assert np.array_equal(np.asarray(getattr(a, f)),
                              getattr(b, f).numpy()), f


def test_grid_and_near_far_match_jax():
    kw = dict(n_workers=(2, 4), bits=(8, 16), p_miss=(0.0, 0.1, 0.02),
              n_channels=(1, 2))
    a, b = jscen.scenario_grid(**kw), tscen.scenario_grid(**kw)
    assert [dataclasses.asdict(s) for s in a] == \
        [dataclasses.asdict(s) for s in b]
    assert b[0].name == "grid/N2_b8_p0_c1"
    for n in (1, 2, 5, 16):
        assert tscen.near_far_p_miss(n, 0.01, 0.2) == \
            jscen.near_far_p_miss(n, 0.01, 0.2)
    # the serving load generator keeps the name
    assert tload.near_far_p_miss is tscen.near_far_p_miss


@pytest.mark.parametrize("build", [
    lambda m: m.Scenario("bad", n_workers=0),
    lambda m: m.Scenario("bad", n_workers=2, p_miss=1.0),
    lambda m: m.Scenario("bad", n_workers=4, p_miss=(0.0, 0.1)),
    lambda m: m.Scenario("bad", n_workers=2, p_miss=(0.0, 1.0)),
    lambda m: m.Scenario("bad", n_workers=4, bits=32),
    lambda m: m.Scenario("bad", n_workers=4, bits=0),
    lambda m: m.Scenario("bad", n_workers=4, n_channels=0),
    lambda m: m.FaultSpec(burst_len=0.5),
    lambda m: m.FaultSpec(p_drop=1.5),
])
def test_validation_matches_jax(build):
    with pytest.raises(ValueError) as want:
        build(jscen)
    with pytest.raises(ValueError) as got:
        build(tscen)
    assert str(got.value) == str(want.value)
