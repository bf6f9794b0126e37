"""``python -m repro_torch.analysis``: run the port's whole analysis pass.

Layers (each can be skipped):

* the op-stream contracts (``repro_torch.analysis.registry``): a stable
  stream over the rebindable leaves, no float64, no host read or host
  transfer, an in-place train step, and the stream checks (collectives,
  copies);
* the AST lint over ``src/repro_torch`` (its examples included) and
  ``chip_smoke.py``.

``--device`` (``cuda`` by default) is where the entries' fake tensors
lie; on ``cuda`` each entry also runs once on real tensors under the sync
debug mode.  Exit status is 0 iff every finding is waived by the baseline
(``analysis_baseline_torch.json`` at the root by default).  ``--json``
writes the full machine-readable report.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional

import torch

from repro_torch.analysis import lint, registry
from repro_torch.analysis.report import Report, load_baseline

BASELINE = "analysis_baseline_torch.json"


def main(argv=None, info: Optional[dict] = None) -> int:
    """The CLI; ``info`` (a dict) receives each contract's readings."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="op-stream contract checker + the port's AST lint")
    ap.add_argument("--root", default=".",
                    help="repo root to scan (default: cwd)")
    ap.add_argument("--baseline", default=None,
                    help=f"waiver baseline JSON (default: <root>/{BASELINE} "
                         f"if present)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the machine-readable report here")
    ap.add_argument("--skip-contracts", action="store_true",
                    help="skip the op-stream contract checks")
    ap.add_argument("--skip-lint", action="store_true",
                    help="skip the AST lint")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="the device of the traced fake tensors (cuda also "
                         "runs each entry once on real tensors)")
    args = ap.parse_args(argv)
    if (args.device == "cuda" and not args.skip_contracts
            and not torch.cuda.is_available()):
        print("no CUDA device: pass --device cpu", file=sys.stderr)
        return 2

    root = Path(args.root).resolve()
    baseline = args.baseline
    if baseline is None:
        cand = root / BASELINE
        baseline = str(cand) if cand.exists() else None

    report = Report(waivers=load_baseline(baseline))
    if not args.skip_lint:
        report.extend(lint.lint_repo(root))
    if not args.skip_contracts:
        report.extend(registry.check_all(device=args.device,
                                         real=args.device == "cuda",
                                         info=info))

    if args.json:
        report.write_json(args.json)

    unwaived = report.unwaived()
    n_waived = len(report.findings) - len(unwaived)
    for f in sorted(unwaived, key=lambda f: f.key):
        print(f.render())
    if n_waived:
        print(f"({n_waived} finding(s) waived by {baseline})")
    for w in report.stale_waivers():
        print(f"note: stale waiver (no matching finding): {w}")
    if unwaived:
        print(f"FAIL: {len(unwaived)} unwaived finding(s)")
        return 1
    print(f"OK: {len(report.findings)} finding(s), all waived"
          if report.findings else
          "OK: no findings")
    return 0


if __name__ == "__main__":
    sys.exit(main())
