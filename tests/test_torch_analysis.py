"""The port's static analysis (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``) and on seeded violations.

* parity: the nine contract names, the report's JSON key for key, the
  shared lint rules on the JAX package's fixtures, the dispatch-bound
  helpers;
* every seeded violation is flagged by exactly its rule;
* the registry is clean on fake CPU tensors, each stream holding the
  custom ops of its kernels, and ``python -m repro_torch.analysis --device
  cpu`` exits 0 against the committed ``analysis_baseline_torch.json``.

No gloo world: the collective case runs over torch's fake process group.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.analysis import contracts, lint, registry, stream_checks
from repro_torch.analysis import report as R

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = pathlib.Path(__file__).parent / "analysis_fixtures"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _only_rule(findings, rule):
    """A seeded case is flagged by exactly the intended rule."""
    assert findings, f"seeded {rule} violation produced no findings"
    assert {f.rule for f in findings} == {rule}, \
        f"expected only {rule}, got {[f.key for f in findings]}"
    return findings


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

def test_contract_names_are_the_jax_registrys():
    from repro.analysis import registry as jreg
    assert registry.contract_names() == jreg.contract_names()


def test_rule_ids_keep_the_jax_slots():
    from repro.analysis import report as JR
    assert len(R.ALL_RULES) == len(JR.ALL_RULES)
    moved = [(a, b) for a, b in zip(R.ALL_RULES, JR.ALL_RULES) if a != b]
    assert moved == [(R.KERNEL_FALLBACK, JR.INTERPRET_HARDCODE),
                     (R.HOST_SYNC_IN_STEP, JR.HOST_SYNC_IN_JIT)]


def test_report_json_is_the_jax_packages(tmp_path):
    from repro.analysis import report as JR
    spec = [(R.HOST_SYNC, "contract:x", "read:op", "m", 12),
            (R.NONDETERMINISM, "a.py", "time.time", "m", None),
            (R.MISSING_KERNEL_REF, "k", "ref.py", "m", 3)]
    waivers = ["host-sync::contract:x::read:op", "stale::rule::key"]
    mine = R.Report(waivers=waivers)
    mine.extend([R.Finding(*s) for s in spec])
    theirs = JR.Report(waivers=waivers)
    theirs.extend([JR.Finding(*s) for s in spec])
    assert mine.to_dict() == theirs.to_dict()
    assert [f.render() for f in mine.findings] == \
        [f.render() for f in theirs.findings]
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    mine.write_json(str(a))
    theirs.write_json(str(b))
    assert a.read_text() == b.read_text()


@pytest.mark.parametrize("name", ["bad_nondet.py", "bad_except.py"])
def test_shared_lint_rules_give_the_jax_findings(name):
    from repro.analysis import lint as jlint
    rel = f"tests/analysis_fixtures/{name}"
    for engine in (True, False):
        mine = lint.lint_file(FIXTURES / name, rel, engine=engine)
        theirs = jlint.lint_file(FIXTURES / name, rel, engine=engine)
        assert [(f.rule, f.detail, f.line) for f in mine] == \
            [(f.rule, f.detail, f.line) for f in theirs]
    assert mine == [] and \
        lint.lint_file(FIXTURES / name, rel, engine=True)


def test_dispatch_helpers_are_the_jax_packages():
    from repro.analysis import contracts as JC
    for steps in (1, 7, 24, 60, 600):
        for every in (1, 2, 8, 10):
            assert contracts.fused_dispatch_bound(steps, every) == \
                JC.fused_dispatch_bound(steps, every)

    def outcome(fn, *args):
        try:
            fn(*args)
        except RuntimeError as e:
            return str(e)
        return None

    cases = [("assert_trace_count", (2, 2, "e")),
             ("assert_trace_count", (3, 2, "e")),
             ("assert_fused_dispatches", (5, 24, 8)),
             ("assert_fused_dispatches", (6, 24, 8)),
             ("assert_single_dispatch", ({"s": 1}, "s", "run")),
             ("assert_single_dispatch", ({"s": 2}, "s", "run")),
             ("assert_tick_dispatch_bracket", ("run", 10, 5, 4)),
             ("assert_tick_dispatch_bracket", ("run", 10, 2, 4)),
             ("assert_tick_dispatch_bracket", ("run", 10, 11, 4))]
    got = [outcome(getattr(contracts, f), *a) for f, a in cases]
    assert got == [outcome(getattr(JC, f), *a) for f, a in cases]
    assert got.count(None) == 4


# ---------------------------------------------------------------------------
# seeded op-stream violations
# ---------------------------------------------------------------------------

def test_seeded_recompile_hazard_baked_scalar():
    state = {}

    def argsf(p):
        state["p"] = float(p)          # a host copy of the channel quality
        return (torch.zeros((4,)),)

    def fn(x):
        return x * state["p"]          # baked into the stream as a scalar

    fs = _only_rule(contracts.check_trace_stable("seed", fn, argsf),
                    R.RECOMPILE_HAZARD)
    assert {f.detail for f in fs} == {"stream-hash"}


def test_seeded_recompile_hazard_baked_constant():
    def fn(x, p):
        # the leaf read back to the host and rebuilt as a constant
        return x * torch.tensor([float(p)])

    fs = _only_rule(contracts.check_trace_stable(
        "seed", fn, lambda p: (torch.zeros((4,)), np.float32(p))),
        R.RECOMPILE_HAZARD)
    assert {f.detail for f in fs} == {"stream-hash"}


def test_seeded_recompile_hazard_static_leaf():
    def argsf(p):
        # the leaf value lands in the structure (a dict key is static)
        return ({f"p{p:g}": torch.zeros((3,))},)

    fs = _only_rule(contracts.check_trace_stable(
        "seed", lambda d: sum(d.values()), argsf), R.RECOMPILE_HAZARD)
    assert {f.detail for f in fs} == {"treedef"}


def test_seeded_recompile_hazard_shape_unstable():
    fs = _only_rule(contracts.check_trace_stable(
        "seed", lambda x: x * 2.0,
        lambda p: (torch.zeros((int(p * 100),)),)), R.RECOMPILE_HAZARD)
    assert {f.detail for f in fs} == {"aval"}


def test_seeded_recompile_hazard_branch():
    def fn(x):
        if x[0] > 0:                   # a Python branch on the leaf
            return x
        return -x

    fs = _only_rule(contracts.check_trace_stable(
        "seed", fn, lambda p: (torch.full((2,), p),)), R.RECOMPILE_HAZARD)
    assert {f.detail for f in fs} == {"trace-error"}


def test_trace_stable_clean():
    assert contracts.check_trace_stable(
        "seed", lambda x: torch.tanh(x) * x,
        lambda p: (torch.full((4,), p),)) == []


def test_seeded_host_sync_item_in_a_step():
    def step(x):
        return x * x.sum().item()      # a host read inside the step

    fs = _only_rule(contracts.check_no_host_sync(
        "seed", step, (torch.zeros((4,)),)), R.HOST_SYNC)
    assert fs[0].detail.startswith("read:aten._local_scalar_dense")

    def const(x):
        return x + torch.tensor([1.0, 2.0, 3.0, 4.0])   # host data

    fs = _only_rule(contracts.check_no_host_sync(
        "seed", const, (torch.zeros((4,)),)), R.HOST_SYNC)
    assert fs[0].detail.startswith("const:")
    assert contracts.check_no_host_sync(
        "seed", lambda x: x + torch.full((4,), 2.0),
        (torch.zeros((4,)),)) == []


def test_seeded_f64_promotion():
    def argsf(p):
        return (torch.zeros((4,), dtype=torch.float32),)

    fs = _only_rule(contracts.check_no_f64(
        "seed", lambda x: x + torch.zeros((4,)), argsf), R.F64_PROMOTION)
    assert all("float64" in f.detail for f in fs)
    assert contracts.check_no_f64(
        "seed", lambda x: x + torch.zeros((4,), dtype=torch.float32),
        argsf) == []


def test_seeded_donation_not_in_place():
    def args():
        return ({"w": torch.ones(3)}, {"m": torch.zeros(3)})

    def rebinding(values, state):
        return {"w": values["w"] - 0.1}, {"m": state["m"] + 1}

    fs = _only_rule(contracts.check_donation("seed", rebinding, args()),
                    R.DONATION_ALIAS)
    assert {f.detail for f in fs} == {"storage:values.w",
                                      "storage:opt_state.m"}

    def inplace(values, state):
        values["w"].sub_(0.1)
        state["m"].add_(1)
        return values, state

    assert contracts.check_donation("seed", inplace, args()) == []


def test_seeded_collective_in_a_single_cell_entry():
    from repro_torch.launch import dryrun
    from repro_torch.parallel import comm

    single = registry.Contract(name="seed", build=None,
                               forbid_collectives=True)
    with dryrun.fake_world(2):
        tr = contracts.trace(lambda x: comm.all_reduce(x, "sum"),
                             (torch.zeros((4,)),))
    assert tr.error is None
    fs = _only_rule(stream_checks.check_stream(single, tr),
                    R.UNEXPECTED_COLLECTIVE)
    assert fs[0].detail == "collectives"
    clean = contracts.trace(lambda x: x * 2, (torch.zeros((4,)),))
    assert stream_checks.check_stream(single, clean) == []


def test_stream_differences_allow_custom_ops_and_device_branches():
    def op(name, dev="cpu", where="a.py:f"):
        return contracts.Op(name, (("T", (2,), "float32", dev),), (),
                            where)

    cpu = [op("aten.mul.Tensor"), op("aten.add.Tensor"),
           op("aten.sum.default", where="b.py:branch"),
           op("aten.neg.default")]
    # the CPU path's plain op in place of a custom op, and a device branch
    cuda = [op("aten.mul.Tensor", "cuda"),
            op("repro_torch.ocs_noisy.default", "cuda"),
            op("aten.stack.default", "cuda", "b.py:branch"),
            op("aten.neg.default", "cuda")]
    assert contracts.stream_differences(cpu, cuda, ("b.py:branch",)) == []
    got = contracts.stream_differences(cpu, cuda)
    assert [d[0] for d in got] == ["replace"]
    assert ("aten.stack.default", "b.py:branch") in got[0][2]


def test_excess_copies_reported():
    tr = contracts.Trace(
        stream=[contracts.Op("aten.clone.default", (), ())] * (
            stream_checks.DEFAULT_MAX_COPIES + 1),
        transfers=[], collectives=[])
    fs = _only_rule(stream_checks.check_stream(
        registry.get_contract("curves.fused"), tr), R.EXCESS_COPIES)
    assert fs[0].detail == "copies"


# ---------------------------------------------------------------------------
# seeded lint violations
# ---------------------------------------------------------------------------

_STEP = '''
import torch


def make_step(opt):
    def step(values, batch):
        loss = (values * batch).sum()
        print(float(loss), loss.item(), batch.tolist())
        torch.cuda.synchronize()
        return values, loss.cpu().numpy()
    return step


def setup(x):
    return float(x)          # not a step body: legal
'''


def test_seeded_host_sync_in_a_step_body(tmp_path):
    path = tmp_path / "step.py"
    path.write_text(_STEP)
    fs = _only_rule(lint.lint_file(path, "step.py", engine=False,
                                   step_bodies=("make_step.step",)),
                    R.HOST_SYNC_IN_STEP)
    assert {f.detail for f in fs} == {
        "step:float()", "step:.item()", "step:.tolist()",
        "step:torch.cuda.synchronize()", "step:.cpu()", "step:.numpy()"}
    assert lint.lint_file(path, "step.py", engine=False) == []


_DRAWS = '''
import time

import torch


def noisy(g, clock=time.monotonic):
    torch.manual_seed(0)
    a = torch.randn(3)
    b = torch.bernoulli(a)
    c = torch.randn(3, generator=g)      # seeded: legal
    return a, b, c, clock
'''


def test_seeded_torch_global_rng(tmp_path):
    path = tmp_path / "draws.py"
    path.write_text(_DRAWS)
    fs = _only_rule(lint.lint_file(path, "draws.py", engine=True),
                    R.NONDETERMINISM)
    assert {f.detail for f in fs} == {"torch.manual_seed", "torch.randn",
                                      "torch.bernoulli"}
    assert lint.lint_file(path, "draws.py", engine=False) == []


def _kernel_tree(root: pathlib.Path, ops_text: str = "def op():\n    pass\n"):
    pkg = root / "src/repro_torch/kernels/fake_op"
    pkg.mkdir(parents=True)
    (pkg / "ops.py").write_text(ops_text)
    return pkg


def test_seeded_missing_kernel_ref(tmp_path):
    pkg = _kernel_tree(tmp_path)
    fs = _only_rule(lint.check_kernel_refs(tmp_path), R.MISSING_KERNEL_REF)
    assert {f.detail for f in fs} == {"ref.py", "csrc", "parity-test",
                                      "chip-smoke"}
    (pkg / "ref.py").write_text("def op():\n    pass\n")
    (pkg.parent / "csrc").mkdir()
    (pkg.parent / "csrc/fake_op.cu").write_text("// kernel\n")
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests/test_torch_fake.py").write_text(
        "from repro_torch.kernels.fake_op import ops, ref\n")
    (tmp_path / "chip_smoke.py").write_text('SOURCES = {"fake_op.op": 1}\n')
    assert lint.check_kernel_refs(tmp_path) == []


_FALLBACK = '''
from repro_torch import kernels
from repro_torch.kernels.fake_op import ref


def op(x):
    try:
        kernels.launch("fake_op.op", "fake_op", x.device, x.data_ptr())
    except RuntimeError:
        return ref.op(x)
    return x


def checked(x):
    try:
        kernels.launch("fake_op.op", "fake_op", x.device, x.data_ptr())
    except RuntimeError as e:
        raise ValueError("no kernel") from e
    return x
'''


def test_seeded_kernel_fallback(tmp_path):
    rel = "src/repro_torch/kernels/fake_op/ops.py"
    path = _kernel_tree(tmp_path, _FALLBACK) / "ops.py"
    fs = _only_rule(lint.lint_file(path, rel, engine=False),
                    R.KERNEL_FALLBACK)
    assert [f.detail for f in fs] == ["except:RuntimeError"]
    assert lint.lint_file(path, "elsewhere.py", engine=False) == []


def test_repo_lint_clean():
    findings = lint.lint_repo(REPO)
    assert findings == [], [f.render() for f in findings]


# ---------------------------------------------------------------------------
# the registry is clean on the port (fake CPU tensors)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """``python -m repro_torch.analysis --device cpu`` once, in process:
    its exit code, its JSON report and each contract's readings."""
    from repro_torch.analysis.__main__ import main
    out = tmp_path_factory.mktemp("analysis") / "report.json"
    info = {}
    rc = main(["--root", str(REPO), "--device", "cpu", "--json", str(out)],
              info=info)
    return rc, json.loads(out.read_text()), info


def test_cli_exits_clean(cli):
    rc, data, info = cli
    assert rc == 0, data["findings"]
    assert data["ok"] is True and data["stale_waivers"] == []
    assert sorted(info) == sorted(registry.contract_names())


@pytest.mark.parametrize("name", registry.contract_names())
def test_contract_clean(cli, name):
    """Every contract's checks pass on fake CPU tensors, and its stream
    holds the custom op of each kernel it declares."""
    _, data, info = cli
    mine = [f for f in data["findings"] if f["where"] == f"contract:{name}"]
    assert mine == []
    want = {registry.CUSTOM_OPS[k]
            for k in registry.get_contract(name).kernels}
    assert want <= set(info[name]["custom_ops"]), info[name]
    assert info[name]["stream_ops"] > 0


def test_serve_tick_device_part_is_the_tick():
    # the tick's host part reads back exactly what the device part returns
    entry = registry.get_contract("serve.tick").build()
    out = entry.fn(*entry.argsf(0.05))
    assert out.dtype == torch.int32 and out.shape == (2 * 2 + 1 + 2,)


def test_committed_baseline_is_roadmaps():
    # every waiver of the committed baseline stands in ROADMAP queue 3
    # with its reason; the baseline starts empty
    waivers = R.load_baseline(str(REPO / "analysis_baseline_torch.json"))
    roadmap = (REPO / "ROADMAP.md").read_text()
    queue3 = roadmap[roadmap.index("### Queue 3"):]
    assert waivers == sorted(set(waivers))
    assert all(w in queue3 for w in waivers)
    assert waivers == []
