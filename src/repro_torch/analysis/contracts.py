"""Op-stream contract checks: the JAX package's jaxpr-level contracts
(``analysis/contracts.py``) as what the same invariants mean for eager
PyTorch on the card, plus the shared dispatch-count assertions.

The port has no jaxpr.  Each check runs the entry point once on fake
tensors (``FakeTensorMode``: nothing is allocated and no kernel runs)
under :class:`OpRecorder`, a ``TorchDispatchMode`` that records the op
stream: each op's name, each tensor argument's shape, dtype and device,
and every non-tensor argument.  A tensor built from host data inside the
entry (``torch.tensor``, ``torch.as_tensor`` of a list or an array: an
``aten.lift_fresh`` of a constant) is recorded with a digest of its
bytes.  The kernels' wrappers take a fake tensor through their
``torch.library`` custom ops, so a kernel is one op of the stream.

Rules implemented here (see ``repro_torch.analysis.registry`` for what
each entry point declares):

``recompile-hazard``
    Rebinding the contract's leaves (``p_miss``, the fault model's
    probabilities, the carried chain state) must change neither the
    arguments' structure (a leaf held as a Python value is static: every
    rebind is another program), nor their shapes and dtypes, nor the hash
    of the op stream.  A differing hash means a leaf's value reached the
    stream as a Python scalar, a constant or a branch, which a CUDA graph
    would bake in.  A trace that stops on a host read of a leaf is the
    same hazard, reported with the error.

``host-sync``
    A host read (``.item()``, ``.tolist()``, ``.numpy()``, ``bool(t)``, an
    op whose output shape depends on the data such as ``nonzero``) cannot
    complete on fake tensors: the op at which the trace stopped is the
    finding.  So is a copy between the host and the card inside the entry
    (an ``aten._to_copy``/``copy_`` across devices) and a tensor built
    from host data inside it (a lifted constant): on the card each is a
    blocking copy that waits for the stream.  On the card the entries
    also run on real tensors under ``torch.cuda.set_sync_debug_mode
    ("error")`` (:func:`check_real_sync`), where the first synchronizing
    call raises.

``f64-promotion``
    The counterpart of ``enable_x64``: the entry is traced under
    ``torch.set_default_dtype(torch.float64)`` and any op touching a
    float64 tensor of one or more dimensions is flagged: an untyped
    ``torch.zeros(n)`` or ``torch.tensor([0.5])`` shows up there as an
    untyped ``jnp.zeros`` does under x64.

``donation-alias``
    The port's donation is the in-place train step: across one real step
    (on the CPU, at a tiny size) every value leaf and optimizer-state
    leaf keeps its storage (``untyped_storage().data_ptr()``) and its
    ``_version`` advances (``Optimizer.update_inplace``).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import difflib
import hashlib
import math
import os
import sys
import traceback
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis import report as R
from repro_torch.analysis.report import Finding

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.dirname(_PKG_DIR)
_ANALYSIS_DIR = os.path.join(_PKG_DIR, "analysis")
_COPIES = ("aten._to_copy", "aten.copy_", "aten.copy")
_CONSTANT_BYTES = 1 << 16      # larger constants are recorded by shape


# ---------------------------------------------------------------------------
# the op stream
# ---------------------------------------------------------------------------

_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__))


def _where(path: str, name: str) -> Optional[str]:
    path = os.path.abspath(path)
    if path.startswith(_PKG_DIR) and not path.startswith(_ANALYSIS_DIR):
        return f"{os.path.relpath(path, _SRC_DIR)}:{name}"
    return None


def _location(frames: Optional[Iterable] = None) -> str:
    """``repro_torch/<file>:<function>`` of the innermost frame in the
    port's package (outside this analysis); where none is on the stack,
    the innermost frame outside torch and the standard library, as
    ``<file>:<function>``; else ``?``.  ``frames`` (a traceback's
    summary, outermost first) in place of the caller's stack."""
    if frames is None:
        pairs = []
        f = sys._getframe(1)
        while f is not None:
            pairs.append((f.f_code.co_filename, f.f_code.co_name))
            f = f.f_back
    else:
        pairs = [(fr.filename, fr.name) for fr in reversed(list(frames))]
    for path, name in pairs:
        got = _where(path, name)
        if got is not None:
            return got
    for path, name in pairs:
        path = os.path.abspath(path)
        if not (path.startswith(_TORCH_DIR) or path.startswith(
                os.path.dirname(os.__file__)) or path == __file__):
            return f"{os.path.basename(path)}:{name}"
    return "?"


def _is_fake(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(t)


def _digest(t: torch.Tensor) -> str:
    if t.numel() * t.element_size() > _CONSTANT_BYTES:
        return "big"
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        raw = t.detach().cpu().contiguous().reshape(-1)
        return hashlib.sha256(raw.view(torch.uint8).numpy().tobytes()
                              ).hexdigest()[:16]


def _norm_leaf(x):
    if isinstance(x, torch.Tensor):
        meta = (tuple(x.shape), str(x.dtype).replace("torch.", ""),
                x.device.type)
        return ("T",) + meta if _is_fake(x) else ("C",) + meta + (
            _digest(x),)
    if isinstance(x, torch.device):
        return ("D", x.type)
    if isinstance(x, (bool, int, float, str, type(None))):
        return (type(x).__name__, repr(x))
    if isinstance(x, (torch.dtype, torch.layout, torch.memory_format)):
        return ("meta", str(x))
    return ("obj", type(x).__name__)


def _norm(tree) -> tuple:
    return tuple(_norm_leaf(x) for x in tree_flatten(tree)[0])


@dataclasses.dataclass(frozen=True)
class Op:
    """One op of the stream: its name (``aten.add.Tensor``,
    ``repro_torch.ocs_noisy.default``), its inputs and its outputs."""

    name: str
    inputs: tuple
    outputs: tuple
    where: str = dataclasses.field(default="", compare=False)

    def without_device(self) -> tuple:
        """The op with every device field dropped (a fake-CPU stream
        against a fake-CUDA one)."""
        def strip(leaves):
            return tuple(x[:3] + x[4:] if x[0] in ("T", "C") else
                         ("D",) if x[0] == "D" else x for x in leaves)
        return (self.name, strip(self.inputs), strip(self.outputs))


class OpRecorder(TorchDispatchMode):
    """Records the op stream under it (push it above a ``FakeTensorMode``)
    and the host transfers in it: ``(kind, op, location)`` with ``kind``
    ``h2d``/``d2h`` for a copy across devices and ``const`` for a tensor
    built from host data."""

    def __init__(self):
        super().__init__()
        self.stream: List[Op] = []
        self.transfers: List[Tuple[str, str, str]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func)
        inputs = _norm((args, kwargs))
        if name.startswith("aten.lift_fresh"):
            self.transfers.append(("const", name, _location()))
        out = func(*args, **kwargs)
        if name.startswith(_COPIES):
            devs = {x.device.type for x in tree_flatten((args, kwargs, out))[0]
                    if isinstance(x, torch.Tensor)}
            if len(devs) > 1:
                src = args[-1] if name.startswith("aten.copy") else args[0]
                kind = "d2h" if src.device.type != "cpu" else "h2d"
                self.transfers.append((kind, name, _location()))
        self.stream.append(Op(name, inputs, _norm(out), _location()))
        return out


def stream_differences(cpu: Sequence[Op], cuda: Sequence[Op],
                       branches: Sequence[str] = ()) -> list:
    """Where a fake-CPU and a fake-CUDA op stream disagree, with the
    device fields dropped: each differing block, but a block where the
    CPU path runs plain ops in place of a custom op of the CUDA stream,
    or whose ops all lie in one of the port's device ``branches``
    (``file:function``).  Empty where they agree."""
    a = [op.without_device() for op in cpu]
    b = [op.without_device() for op in cuda]
    bad = []
    for tag, i1, i2, j1, j2 in difflib.SequenceMatcher(
            None, a, b, autojunk=False).get_opcodes():
        if tag == "equal":
            continue
        mine = [op for op in cpu[i1:i2] if op.where not in branches]
        theirs = [op for op in cuda[j1:j2] if op.where not in branches]
        if not mine and not theirs or theirs and all(
                op.name.startswith("repro_torch.") for op in theirs):
            continue
        bad.append((tag, [(op.name, op.where) for op in cpu[i1:i2]][:4],
                    [(op.name, op.where) for op in cuda[j1:j2]][:4]))
    return bad


def stream_hash(stream: Sequence[Op]) -> str:
    h = hashlib.sha256()
    for op in stream:
        h.update(repr((op.name, op.inputs, op.outputs)).encode())
    return h.hexdigest()


def map_tensors(fn: Callable, obj):
    """``obj`` with ``fn`` applied to every tensor in it (dicts, sequences,
    NamedTuples and dataclasses rebuilt; other values as they are)."""
    def conv(x):
        if isinstance(x, torch.Tensor):
            return fn(x)
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*map(conv, x))
        if isinstance(x, (list, tuple)):
            return type(x)(map(conv, x))
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            new = copy.copy(x)
            for f in dataclasses.fields(x):
                object.__setattr__(new, f.name, conv(getattr(x, f.name)))
            return new
        return x

    return conv(obj)


def to_fake(obj, mode, device="cpu"):
    """``obj`` with every tensor made a fake tensor of ``mode`` on
    ``device``.  Call inside ``mode``."""
    device = torch.device(device)

    def fake(x):
        f = mode.from_tensor(x)
        return f if f.device.type == device.type else f.to(device)

    return map_tensors(fake, obj)


@dataclasses.dataclass
class Trace:
    """One fake run of an entry: its stream, its host transfers, the
    collectives ``comm.recording`` saw, and the error that stopped it."""

    stream: List[Op]
    transfers: List[Tuple[str, str, str]]
    collectives: list
    error: Optional[BaseException] = None


@contextlib.contextmanager
def _default_dtype(dtype):
    old = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


def trace(fn: Callable, args: Tuple, device="cpu",
          dtype: Optional[torch.dtype] = None) -> Trace:
    """``fn(*args)`` once on fake tensors of ``device`` under an
    :class:`OpRecorder` (``args`` real tensors and values, made fake
    first; ``dtype`` the default dtype of the run)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.parallel import comm
    mode = FakeTensorMode()
    rec = OpRecorder()
    err = None
    with mode:
        fargs = to_fake(args, mode, device)
        with comm.recording() as coll, rec, \
                _default_dtype(dtype or torch.get_default_dtype()):
            try:
                fn(*fargs)
            except Exception as e:   # the trace's stop is the reading
                err = e
    return Trace(rec.stream, rec.transfers, list(coll), err)


def _stop(err: BaseException) -> Tuple[bool, str]:
    """Whether ``err`` is a host read on a fake tensor, and the op and
    location at which the trace stopped."""
    from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                               DynamicOutputShapeException)
    msg = str(err)
    host = isinstance(err, (DataDependentOutputException,
                            DynamicOutputShapeException)) or (
        isinstance(err, RuntimeError)
        and ("data_ptr" in msg or "numpy" in msg.lower()))
    func = getattr(err, "func", None)
    op = str(func) if func is not None else type(err).__name__
    return host, f"{op}@{_location(traceback.extract_tb(err.__traceback__))}"


# ---------------------------------------------------------------------------
# argument structure (the port's treedef)
# ---------------------------------------------------------------------------

def flatten_args(obj) -> Tuple[str, List]:
    """``(structure, leaves)`` of an argument tree: tensors, arrays and
    numpy scalars are leaves; dicts, sequences, NamedTuples and
    dataclasses are nodes; every other value is static and part of the
    structure (a Python float there is a value every rebind retraces)."""
    leaves: List = []

    def walk(x) -> str:
        if isinstance(x, (torch.Tensor, np.ndarray, np.generic)):
            leaves.append(x)
            return "*"
        if isinstance(x, dict):
            return "{" + ",".join(f"{k!r}:{walk(x[k])}"
                                  for k in sorted(x, key=repr)) + "}"
        if isinstance(x, (list, tuple)):
            return (type(x).__name__ + "("
                    + ",".join(walk(v) for v in x) + ")")
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return (type(x).__name__ + "("
                    + ",".join(f"{f.name}={walk(getattr(x, f.name))}"
                               for f in dataclasses.fields(x)) + ")")
        if isinstance(x, (bool, int, float, str, type(None), torch.dtype)):
            return repr(x)
        return type(x).__name__

    return walk(obj), leaves


def _leaf_aval(x):
    return (tuple(x.shape), str(x.dtype))


# ---------------------------------------------------------------------------
# the individual checks
# ---------------------------------------------------------------------------

def check_trace_stable(name: str, fn: Callable,
                       argsf: Callable[[float], Tuple],
                       perturb: Sequence[float] = (0.03, 0.11),
                       device="cpu") -> List[Finding]:
    """``fn(*argsf(p))`` must give the same op stream for every
    perturbation ``p`` of the rebindable leaves."""
    where = f"contract:{name}"
    base, rest = perturb[0], perturb[1:]
    args0 = argsf(base)
    tree0, leaves0 = flatten_args(args0)
    t0 = trace(fn, args0, device)
    if t0.error is not None:
        return [Finding(
            R.RECOMPILE_HAZARD, where, "trace-error",
            f"tracing with perturbed leaf={base} raised "
            f"{type(t0.error).__name__}: {t0.error}")]
    h0 = stream_hash(t0.stream)
    findings: List[Finding] = []
    for p in rest:
        args1 = argsf(p)
        tree1, leaves1 = flatten_args(args1)
        if tree1 != tree0:
            findings.append(Finding(
                R.RECOMPILE_HAZARD, where, "treedef",
                f"rebinding the leaf to {p} changes the arguments' "
                f"structure — the leaf is a static value, every rebind is "
                f"another program"))
            continue
        mismatch = [i for i, (a, b) in enumerate(zip(leaves0, leaves1))
                    if _leaf_aval(a) != _leaf_aval(b)]
        if mismatch:
            findings.append(Finding(
                R.RECOMPILE_HAZARD, where, "aval",
                f"rebinding the leaf to {p} changes argument shapes or "
                f"dtypes at flat positions {mismatch}"))
            continue
        t1 = trace(fn, args1, device)
        if t1.error is not None:
            findings.append(Finding(
                R.RECOMPILE_HAZARD, where, "trace-error",
                f"tracing with perturbed leaf={p} raised "
                f"{type(t1.error).__name__}: {t1.error}"))
            continue
        if stream_hash(t1.stream) != h0:
            at = next((i for i, (a, b) in enumerate(zip(t0.stream,
                                                        t1.stream))
                       if a != b), min(len(t0.stream), len(t1.stream)))
            op = t1.stream[at].name if at < len(t1.stream) else "end"
            findings.append(Finding(
                R.RECOMPILE_HAZARD, where, "stream-hash",
                f"the op stream changes when the leaf rebinds {base} -> "
                f"{p} (first at op {at}, {op}): a leaf's value is baked "
                f"into the stream (a Python scalar, a constant or a "
                f"branch)"))
    return findings


def host_sync_findings(name: str, tr: Trace,
                       allowlist: Sequence[str] = ()) -> List[Finding]:
    """The ``host-sync`` findings of one trace (see the module doc)."""
    where = f"contract:{name}"
    findings: List[Finding] = []
    if tr.error is not None:
        host, at = _stop(tr.error)
        if not host:
            return [Finding(
                R.CHECK_ERROR, where, "host-sync",
                f"host-sync check could not trace the entry point: "
                f"{type(tr.error).__name__}: {tr.error}")]
        if f"read:{at}" not in allowlist:
            findings.append(Finding(
                R.HOST_SYNC, where, f"read:{at}",
                f"the trace stopped on a host read at {at}: the card "
                f"waits for it, and a CUDA graph cannot capture it"))
    seen = set()
    for kind, op, loc in tr.transfers:
        detail = f"{kind}:{loc}"
        if detail in seen or detail in allowlist:
            continue
        seen.add(detail)
        what = ("a tensor built from host data" if kind == "const" else
                f"a {'host-to-device' if kind == 'h2d' else 'device-to-host'}"
                f" copy ({op})")
        findings.append(Finding(
            R.HOST_SYNC, where, detail,
            f"{what} inside the entry at {loc}: on the card a blocking "
            f"copy that waits for the stream"))
    return findings


def check_no_host_sync(name: str, fn: Callable, args: Tuple,
                       allowlist: Sequence[str] = (),
                       device="cpu") -> List[Finding]:
    """No host read and no host transfer in the entry's op stream."""
    return host_sync_findings(name, trace(fn, args, device), allowlist)


def check_no_f64(name: str, fn: Callable, argsf: Callable[[float], Tuple],
                 device="cpu") -> List[Finding]:
    """Trace under a float64 default dtype and walk for float64 tensors
    of one or more dimensions."""
    where = f"contract:{name}"
    tr = trace(fn, argsf(0.05), device, dtype=torch.float64)
    if tr.error is not None:
        return [Finding(
            R.F64_PROMOTION, where, "f64-trace",
            f"entry point fails to trace under a float64 default dtype "
            f"({type(tr.error).__name__}: {tr.error}) — an unpinned dtype "
            f"promotes and collides; pin dtypes explicitly")]
    findings: List[Finding] = []
    seen = set()
    for op in tr.stream:
        for leaf in op.inputs + op.outputs:
            if leaf[0] in ("T", "C") and leaf[2] == "float64" and leaf[1]:
                detail = f"{op.name}:float64"
                if detail not in seen:
                    seen.add(detail)
                    findings.append(Finding(
                        R.F64_PROMOTION, where, detail,
                        f"`{op.name}` touches a float64{list(leaf[1])} "
                        f"tensor under a float64 default dtype — an "
                        f"untyped construction silently promotes (pin the "
                        f"dtype explicitly)"))
                break
    return findings


def _paths(tree, prefix: str) -> List[Tuple[str, torch.Tensor]]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k],
                                                        f"{prefix}.{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in _paths(t, f"{prefix}.{i}")]
    return [(prefix, tree)] if isinstance(tree, torch.Tensor) else []


def check_donation(name: str, step: Callable, args: Tuple) -> List[Finding]:
    """One real step ``step(values, opt_state, ...) -> (values,
    opt_state, ...)``: every leaf of both comes back in its own storage,
    written (its ``_version`` advanced)."""
    where = f"contract:{name}"
    before = _paths(args[0], "values") + _paths(args[1], "opt_state")
    ptrs = [t.untyped_storage().data_ptr() for _, t in before]
    versions = [t._version for _, t in before]
    try:
        out = step(*args)
    except Exception as e:
        return [_trace_error(name, "donation", e)]
    after = _paths(out[0], "values") + _paths(out[1], "opt_state")
    if [p for p, _ in after] != [p for p, _ in before]:
        return [Finding(
            R.DONATION_ALIAS, where, "structure",
            "the step returns a train state of another structure than "
            "the one it was given")]
    findings = []
    for (path, t_in), (_, t_out), ptr, ver in zip(before, after, ptrs,
                                                  versions):
        if t_out.untyped_storage().data_ptr() != ptr:
            findings.append(Finding(
                R.DONATION_ALIAS, where, f"storage:{path}",
                f"`{path}` comes back in a new buffer: the step keeps a "
                f"second copy of the train state"))
        elif t_in._version == ver:
            findings.append(Finding(
                R.DONATION_ALIAS, where, f"version:{path}",
                f"`{path}` keeps its buffer but the step never writes it"))
    return findings


def _trace_error(name: str, what: str, e: Exception) -> Finding:
    return Finding(
        R.CHECK_ERROR, f"contract:{name}", what,
        f"{what} check could not run the entry point: "
        f"{type(e).__name__}: {e}")


def check_real_sync(name: str, fn: Callable, args: Tuple,
                    device="cuda") -> List[Finding]:
    """Run ``fn(*args)`` once on real tensors of ``device`` under
    ``torch.cuda.set_sync_debug_mode("error")``: the first synchronizing
    call raises, and is a ``host-sync`` finding at its location in the
    port.  No finding means the run completed sync-free."""
    real = map_tensors(lambda t: t.to(device), args)
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn(*real)
    except RuntimeError as e:
        if "called a synchronizing CUDA operation" not in str(e):
            return [_trace_error(name, "sync", e)]
        stack = traceback.extract_tb(e.__traceback__)
        loc = _location(stack)
        path = " <- ".join(f"{os.path.basename(fr.filename)}:{fr.name}"
                           for fr in reversed(stack[-8:]))
        return [Finding(R.HOST_SYNC, f"contract:{name}", f"sync:{loc}",
                        f"a synchronizing CUDA call at {loc} in a real run "
                        f"({path})")]
    except Exception as e:
        return [_trace_error(name, "sync", e)]
    finally:
        torch.cuda.set_sync_debug_mode(old)
    torch.cuda.synchronize()
    return []


# ---------------------------------------------------------------------------
# shared dispatch-count assertions.  The port compiles nothing, so a
# "trace" is a core call of an engine (``sim/sweep.dispatch_counts``), a
# "dispatch" is one call that issues a step's or a tick's launches
# (``serve/engine.dispatch_counts()["tick"]``; a kernel's own launches are
# ``kernels.launch_counts()``), and a result fetch is one copy to the host
# ---------------------------------------------------------------------------

def fused_dispatch_bound(steps: int, log_every: int) -> int:
    """Host reads one curve run may cost per ``bits`` value in the JAX
    package's fused engine: the single dispatch plus the logged-buffer
    fetches.  The port's curve engines read the host once per ``bits``
    value (the logged losses collect in a device buffer), which this bound
    holds."""
    return math.ceil(steps / log_every) + 2


def assert_trace_count(observed: int, expected: int, what: str) -> None:
    """Exactly-N core calls (``sweep.dispatch_counts``: one clean call per
    ``bits`` value, one noisy call per ``(bits, id_bits)`` pair)."""
    if observed != expected:
        raise RuntimeError(
            f"{what} recompiled: {observed} traces, expected {expected} — "
            "a traced leaf regressed to static (zero-recompile contract)")


def assert_fused_dispatches(dispatches_per_bits: float, steps: int,
                            log_every: int) -> None:
    """A curve engine's host reads per ``bits`` value within
    :func:`fused_dispatch_bound`."""
    bound = fused_dispatch_bound(steps, log_every)
    if dispatches_per_bits > bound:
        raise RuntimeError(
            f"fused engine dispatched {dispatches_per_bits}/bits — exceeds "
            f"the ceil(steps/log_every)+2 = {bound} fusion bound")


def assert_single_dispatch(counts: Dict[str, int], key: str,
                           what: str) -> None:
    """Exactly one call under ``key`` in ``counts`` (a dispatch or launch
    count dict)."""
    if counts.get(key) != 1:
        raise RuntimeError(
            f"{what} cost {counts} dispatches — must fuse to ONE")


def assert_tick_dispatch_bracket(name: str, decode_tokens: int, ticks: int,
                                 batch_slots: int) -> None:
    """One tick per serve decode step (``serve/engine.dispatch_counts()
    ["tick"]``): every tick decodes >= 1 active slot and <= batch_slots
    tokens, so the ticks bracket the decoded-token count."""
    lo = -(-decode_tokens // batch_slots)            # ceil division
    if not lo <= ticks <= decode_tokens:
        raise RuntimeError(
            f"{name}: {ticks} decode dispatches for {decode_tokens} decoded "
            f"tokens over {batch_slots} slots — not one fused dispatch per "
            f"tick (expected in [{lo}, {decode_tokens}])")
