"""Stream-level checks: the JAX package's HLO-level invariants
(``analysis/hlo_checks.py``) held on the op stream that a contract's
trace recorded (:class:`repro_torch.analysis.contracts.Trace`).  Nothing
is compiled in the port, so the stream is the program.

``unexpected-collective``
    Contracts flagged ``forbid_collectives`` (single-cell entry points:
    the protocol aggregation law, the serve tick) must run no collective:
    no ``c10d``/``_c10d_functional`` op in the stream and no record of
    ``parallel/comm.recording``.  One would mean a mesh leaked into a
    single-device program.

``excess-copies``
    Reported (never a hard failure on its own) when an entry's stream
    carries many copy ops (``aten.copy_``, ``clone``, ``_to_copy``); the
    count rides in the JSON report so that copy regressions show.
"""

from __future__ import annotations

from typing import List

from repro_torch.analysis import report as R
from repro_torch.analysis.report import Finding

# a tiny entry point has no business exceeding this many copy ops; the
# bound sits well above the tiny entries' counts (the serve tick's cache
# copies are the most), so only a double-buffering regression trips it
DEFAULT_MAX_COPIES = 512

_COPY_OPS = ("aten.copy_", "aten.clone", "aten._to_copy")
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")


def count_copies(stream) -> int:
    return sum(1 for op in stream if op.name.startswith(_COPY_OPS))


def collectives(stream) -> List[str]:
    return [op.name for op in stream
            if op.name.split(".", 1)[0] in _COLLECTIVE_NAMESPACES]


def check_stream(contract, tr) -> List[Finding]:
    """The contract's declared stream inspections on one trace."""
    where = f"contract:{contract.name}"
    findings: List[Finding] = []
    if contract.forbid_collectives:
        ops = collectives(tr.stream)
        if ops or tr.collectives:
            findings.append(Finding(
                R.UNEXPECTED_COLLECTIVE, where, "collectives",
                f"single-cell entry point runs collectives "
                f"{sorted(set(ops)) or [r['op'] for r in tr.collectives]} "
                f"— a mesh leaked into a single-device program"))
    n_copies = count_copies(tr.stream)
    if n_copies > DEFAULT_MAX_COPIES:
        findings.append(Finding(
            R.EXCESS_COPIES, where, "copies",
            f"the op stream carries {n_copies} copy ops "
            f"(> {DEFAULT_MAX_COPIES}) — something is double-buffering"))
    return findings
