"""The port's AST lint: the rules the op-stream contracts cannot see.

Five rules, all syntactic: nothing of the scanned code is imported, so a
broken module parses and lints like any other.  The scan covers
``src/repro_torch`` (its examples included) and ``chip_smoke.py``.

``nondeterminism``
    Engine code (sim/serve/protocol/core/train/optim/models/faults) must
    not call wall clocks (``time.*``, ``datetime.now``), global-state RNGs
    (stdlib ``random.*``, legacy ``np.random.*``), torch's global seed
    (``torch.manual_seed``, ``torch.seed``) or a draw from torch's global
    generator (``torch.rand*``/``randn*``/``randint*``/``randperm``/
    ``bernoulli``/``multinomial`` without ``generator=``).  Seeded
    ``np.random.default_rng``, a ``torch.Generator`` and the threefry keys
    of ``repro_torch.random`` stay legal; so does a clock passed as a
    default value (``clock=time.monotonic``), which is not a call.

``silent-except``
    Engine code must not swallow exceptions: no bare ``except:`` and no
    handler whose whole body is ``pass``/``...``.

``host-sync-in-step``
    Inside the functions that the registry names as step or tick bodies
    (:data:`repro_torch.analysis.registry.STEP_BODIES`) and every ``def``
    nested in one: no ``.item()``, ``.tolist()``, ``.cpu()`` or
    ``.numpy()``, no ``float(x)``/``int(x)`` on a non-literal and no
    ``torch.cuda.synchronize``: each waits for the card, and a step that
    reads the host cannot be captured into a CUDA graph.

``missing-kernel-ref``
    Every ``src/repro_torch/kernels/<pkg>/`` with an ``ops.py`` ships a
    ``ref.py``, its CUDA source ``kernels/csrc/<pkg>.cu``, a
    ``tests/test_torch_*.py`` that imports the package's ``ref`` beside
    it, and an entry in ``chip_smoke.py``'s kernel checks (a kernel name
    ``"<pkg>.…"``).

``kernel-fallback``
    In ``kernels/*/ops.py``, no ``try:`` whose body reaches the kernel
    library (``kernels.launch``, ``library()``) and whose handler calls
    into ``ref``: a wrapper that falls back to its plain version on a
    failed build or launch hides a missing kernel.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis import report as R
from repro_torch.analysis.report import Finding

PACKAGE = "src/repro_torch"

# `nondeterminism` and `silent-except` apply only to these engine subtrees
ENGINE_DIRS = tuple(f"{PACKAGE}/{d}" for d in (
    "sim", "serve", "protocol", "core", "train", "optim", "models",
    "faults"))

_NP_RANDOM_OK = {"default_rng", "Generator", "SeedSequence", "PCG64",
                 "Philox", "bit_generator"}
_TORCH_SEEDS = {"manual_seed", "seed"}
_TORCH_DRAWS = ("rand", "randn", "randint", "randperm", "bernoulli",
                "multinomial")
_HOST_READS = {"item", "tolist", "cpu", "numpy"}


def _module_imports(tree: ast.Module) -> Set[str]:
    """Top-level module names bound by plain ``import`` statements."""
    mods: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                mods.add(alias.asname or alias.name.split(".")[0])
    return mods


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` of a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    return ".".join([node.id] + parts[::-1])


def _torch_draw(call: ast.Call) -> Optional[str]:
    """``torch.<draw>`` without ``generator=``, or a global seed call."""
    name = _dotted(call.func)
    if name is None or not name.startswith("torch.") or name.count(".") != 1:
        return None
    attr = name.split(".", 1)[1]
    if attr in _TORCH_SEEDS:
        return name
    if attr.startswith(_TORCH_DRAWS) and not any(
            kw.arg == "generator" for kw in call.keywords):
        return name
    return None


# ---------------------------------------------------------------------------
# per-file rules
# ---------------------------------------------------------------------------

def _check_nondeterminism(tree: ast.Module, rel: str) -> List[Finding]:
    imports = _module_imports(tree)
    findings = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        f = node.func
        sym = None
        if isinstance(f.value, ast.Name):
            base = f.value.id
            if base == "time" and "time" in imports:
                sym = f"time.{f.attr}"
            elif base == "random" and "random" in imports:
                sym = f"random.{f.attr}"
            elif base == "datetime" and f.attr in ("now", "utcnow", "today"):
                sym = f"datetime.{f.attr}"
            elif base == "torch" and "torch" in imports:
                sym = _torch_draw(node)
        elif (isinstance(f.value, ast.Attribute)
              and f.value.attr == "random"
              and isinstance(f.value.value, ast.Name)
              and f.value.value.id in ("np", "numpy")
              and f.attr not in _NP_RANDOM_OK):
            sym = f"np.random.{f.attr}"
        if sym is not None:
            findings.append(Finding(
                R.NONDETERMINISM, rel, sym,
                f"`{sym}()` in engine code — engines must be "
                f"seed-deterministic (thread a threefry key, a seeded "
                f"default_rng or a torch.Generator)", line=node.lineno))
    return findings


def _check_silent_except(tree: ast.Module, rel: str) -> List[Finding]:
    findings = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if node.type is None:
            findings.append(Finding(
                R.SILENT_EXCEPT, rel, "bare",
                "bare `except:` in engine code catches everything "
                "(including KeyboardInterrupt) — name the exception",
                line=node.lineno))
            continue
        swallow = all(
            isinstance(stmt, ast.Pass)
            or (isinstance(stmt, ast.Expr)
                and isinstance(stmt.value, ast.Constant)
                and stmt.value.value is Ellipsis)
            for stmt in node.body)
        if swallow:
            name = ast.unparse(node.type)
            findings.append(Finding(
                R.SILENT_EXCEPT, rel, f"swallow:{name}",
                f"`except {name}: pass` in engine code swallows the error "
                f"— a faulted run would report clean numbers; handle it "
                f"or let it propagate", line=node.lineno))
    return findings


def _step_scopes(tree: ast.Module, names: Iterable[str]) -> List[ast.AST]:
    """The defs whose dotted qualname (``Class.method``,
    ``factory.inner``) is one of ``names``."""
    wanted = set(names)
    scopes: List[ast.AST] = []

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                qual = f"{prefix}{child.name}"
                if qual in wanted and not isinstance(child, ast.ClassDef):
                    scopes.append(child)
                visit(child, qual + ".")
            else:
                visit(child, prefix)

    visit(tree, "")
    return scopes


def _host_read(call: ast.Call) -> Optional[str]:
    """Short printable symbol of a host-reading call, or None."""
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr in _HOST_READS:
        return f".{f.attr}()"
    if (isinstance(f, ast.Name) and f.id in ("float", "int")
            and len(call.args) == 1
            and not isinstance(call.args[0], ast.Constant)):
        return f"{f.id}()"
    if _dotted(f) == "torch.cuda.synchronize":
        return "torch.cuda.synchronize()"
    return None


def _check_step_scopes(tree: ast.Module, rel: str,
                       names: Iterable[str]) -> List[Finding]:
    findings = []
    for scope in _step_scopes(tree, names):
        for node in ast.walk(scope):
            sym = _host_read(node) if isinstance(node, ast.Call) else None
            if sym is not None:
                findings.append(Finding(
                    R.HOST_SYNC_IN_STEP, rel, f"{scope.name}:{sym}",
                    f"`{sym}` inside the step body `{scope.name}` reads a "
                    f"device value on the host (the card waits; a CUDA "
                    f"graph cannot capture it)", line=node.lineno))
    return findings


def _reaches_kernel(body: List[ast.stmt]) -> bool:
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call):
                name = _dotted(node.func) or ""
                if name.split(".")[-1] in ("launch", "library"):
                    return True
    return False


def _calls_ref(body: List[ast.stmt]) -> bool:
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call):
                name = _dotted(node.func) or ""
                if name.startswith("ref.") or ".ref." in name:
                    return True
    return False


def _check_kernel_fallback(tree: ast.Module, rel: str) -> List[Finding]:
    findings = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try) or not _reaches_kernel(node.body):
            continue
        for handler in node.handlers:
            if _calls_ref(handler.body):
                findings.append(Finding(
                    R.KERNEL_FALLBACK, rel,
                    f"except:{ast.unparse(handler.type or ast.Name('*'))}",
                    "a failed kernel build or launch falls back to the "
                    "plain version — the kernel's absence is hidden; let "
                    "the error propagate", line=handler.lineno))
    return findings


def lint_file(path: Path, rel: str, *, engine: bool,
              step_bodies: Iterable[str] = ()) -> List[Finding]:
    """All per-file rules on one source file (``rel`` is the repo-relative
    path used in findings; ``engine`` enables the nondeterminism and
    silent-except rules; ``step_bodies`` are the qualnames of the step
    bodies in this file)."""
    try:
        tree = ast.parse(path.read_text(), filename=str(path))
    except SyntaxError as e:
        return [Finding(R.CHECK_ERROR, rel, "syntax",
                        f"could not parse: {e}", line=e.lineno)]
    findings: List[Finding] = []
    findings += _check_step_scopes(tree, rel, step_bodies)
    if rel.startswith(f"{PACKAGE}/kernels/") and rel.endswith("/ops.py"):
        findings += _check_kernel_fallback(tree, rel)
    if engine:
        findings += _check_nondeterminism(tree, rel)
        findings += _check_silent_except(tree, rel)
    return findings


# ---------------------------------------------------------------------------
# repo-level rules + the scan driver
# ---------------------------------------------------------------------------

def check_kernel_refs(root: Path) -> List[Finding]:
    """Every kernels/<pkg>/ with an ops.py ships ref.py, csrc/<pkg>.cu, a
    test against its ref and a chip_smoke.py entry."""
    kdir = root / PACKAGE / "kernels"
    if not kdir.is_dir():
        return []
    tests = root / "tests"
    texts = ([t.read_text() for t in sorted(tests.glob("test_torch_*.py"))]
             if tests.is_dir() else [])
    smoke = root / "chip_smoke.py"
    smoke_text = smoke.read_text() if smoke.exists() else ""
    findings = []
    for pkg in sorted(p for p in kdir.iterdir()
                      if p.is_dir() and (p / "ops.py").exists()):
        rel = f"{PACKAGE}/kernels/{pkg.name}"
        mod = f"repro_torch.kernels.{pkg.name}"
        missing = []
        if not (pkg / "ref.py").exists():
            missing.append(("ref.py", "no ref.py plain version — nothing "
                            "to hold the kernel to"))
        if not (kdir / "csrc" / f"{pkg.name}.cu").exists():
            missing.append(("csrc", f"no CUDA source csrc/{pkg.name}.cu"))
        if not any(mod in text and "ref" in text for text in texts):
            missing.append(("parity-test", "no tests/test_torch_*.py "
                            "compares it with its ref"))
        if f'"{pkg.name}.' not in smoke_text:
            missing.append(("chip-smoke", "no entry in chip_smoke.py's "
                            "kernel checks"))
        for detail, why in missing:
            findings.append(Finding(
                R.MISSING_KERNEL_REF, rel, detail,
                f"kernel package `{pkg.name}`: {why}"))
    return findings


def _iter_files(root: Path) -> Iterable[Tuple[Path, str, bool]]:
    """(path, relpath, engine?) of every scannable source file."""
    paths = []
    base = root / PACKAGE
    if base.is_dir():
        paths += sorted(base.rglob("*.py"))
    if (root / "chip_smoke.py").exists():
        paths.append(root / "chip_smoke.py")
    for path in paths:
        rel = path.relative_to(root).as_posix()
        engine = any(rel.startswith(d + "/") for d in ENGINE_DIRS)
        yield path, rel, engine


def lint_repo(root, step_bodies: Optional[Dict[str, Tuple[str, ...]]]
              = None) -> List[Finding]:
    """All AST-lint findings of the repo at ``root``; ``step_bodies``
    (file -> qualnames) defaults to the registry's."""
    if step_bodies is None:
        from repro_torch.analysis.registry import STEP_BODIES
        step_bodies = STEP_BODIES
    root = Path(root)
    findings: List[Finding] = []
    for path, rel, engine in _iter_files(root):
        findings += lint_file(path, rel, engine=engine,
                              step_bodies=step_bodies.get(rel, ()))
    findings += check_kernel_refs(root)
    return findings
