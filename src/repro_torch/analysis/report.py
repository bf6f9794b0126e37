"""Findings, reports and waiver baselines for the port's static-analysis
pass (the JAX package's ``analysis/report.py``, the same JSON layout and
the same keys).

Every check in ``repro_torch.analysis`` — the op-stream contracts, the
stream checks and the AST lint — reports violations as :class:`Finding`
values.  A finding's
:attr:`~Finding.key` is stable across unrelated edits (it names the rule,
the file/contract and a detail token, but never a line number), so a
committed waiver baseline keeps CI green across line drift while still
failing on any *new* violation.

The baseline file is JSON::

    {"waivers": ["rule::where::detail", ...]}

and lives at the repo root as ``analysis_baseline_torch.json`` (committed
empty; a waiver needs its reason beside it in the ROADMAP's list of open
faults).

The rule ids are the JAX package's, with two changes of meaning:

* ``kernel-fallback`` takes the slot of ``interpret-hardcode``, which has
  no counterpart (there is no interpret mode): a kernel wrapper that
  catches a failed build or launch and runs its plain version instead.
* ``host-sync-in-step`` is ``host-sync-in-jit`` for eager steps: a host
  read inside a function that the registry names as a step or tick body.
* ``eager-loop-in-jit`` stays reserved: the port compiles nothing (no
  ``torch.compile``, no CUDA graph), so a Python loop in a step is the
  program itself and there is nothing to check until a slice brings one.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

# rule identifiers (one per invariant; tests assert fixtures are flagged by
# exactly the intended rule)
RECOMPILE_HAZARD = "recompile-hazard"
F64_PROMOTION = "f64-promotion"
HOST_SYNC = "host-sync"
DONATION_ALIAS = "donation-alias"
UNEXPECTED_COLLECTIVE = "unexpected-collective"
EXCESS_COPIES = "excess-copies"
KERNEL_FALLBACK = "kernel-fallback"
HOST_SYNC_IN_STEP = "host-sync-in-step"
EAGER_LOOP_IN_JIT = "eager-loop-in-jit"
MISSING_KERNEL_REF = "missing-kernel-ref"
NONDETERMINISM = "nondeterminism"
SILENT_EXCEPT = "silent-except"
UNKNOWN_DTYPE = "unknown-dtype"
CHECK_ERROR = "check-error"

ALL_RULES = (
    RECOMPILE_HAZARD, F64_PROMOTION, HOST_SYNC, DONATION_ALIAS,
    UNEXPECTED_COLLECTIVE, EXCESS_COPIES, KERNEL_FALLBACK,
    HOST_SYNC_IN_STEP, EAGER_LOOP_IN_JIT, MISSING_KERNEL_REF, NONDETERMINISM,
    SILENT_EXCEPT, UNKNOWN_DTYPE, CHECK_ERROR,
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation.

    ``where`` names the contract (``contract:protocol.aggregate``) or the
    file (repo-relative path); ``detail`` is a short stable token (symbol,
    op, dtype) distinguishing findings within one ``where``;
    ``line`` is display-only and excluded from the waiver key.
    """

    rule: str
    where: str
    detail: str
    message: str
    line: Optional[int] = None

    @property
    def key(self) -> str:
        return f"{self.rule}::{self.where}::{self.detail}"

    def render(self) -> str:
        loc = f"{self.where}:{self.line}" if self.line else self.where
        return f"[{self.rule}] {loc}: {self.message}"

    def to_dict(self) -> Dict:
        return {"rule": self.rule, "where": self.where,
                "detail": self.detail, "message": self.message,
                "line": self.line, "key": self.key}


@dataclasses.dataclass
class Report:
    """All findings of one analysis run, plus the applied baseline."""

    findings: List[Finding] = dataclasses.field(default_factory=list)
    waivers: Sequence[str] = ()

    def extend(self, findings: Sequence[Finding]) -> None:
        self.findings.extend(findings)

    def unwaived(self) -> List[Finding]:
        waived = set(self.waivers)
        return [f for f in self.findings if f.key not in waived]

    def stale_waivers(self) -> List[str]:
        live = {f.key for f in self.findings}
        return [w for w in self.waivers if w not in live]

    def to_dict(self) -> Dict:
        return {
            "findings": [f.to_dict() for f in self.findings],
            "waived": sorted({f.key for f in self.findings}
                             & set(self.waivers)),
            "stale_waivers": self.stale_waivers(),
            "ok": not self.unwaived(),
        }

    def write_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")


def load_baseline(path: Optional[str]) -> List[str]:
    """Waiver keys from a baseline file (``None``/missing -> strict)."""
    if path is None:
        return []
    with open(path) as f:
        data = json.load(f)
    waivers = data.get("waivers", [])
    if not isinstance(waivers, list) or any(
            not isinstance(w, str) for w in waivers):
        raise ValueError(f"{path}: 'waivers' must be a list of finding keys")
    return waivers
