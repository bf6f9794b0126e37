"""The port's static analysis: machine-checked contracts on the op stream
of every registered step and tick, and a repo lint (the JAX package's
``analysis/``).

Three layers (see ``python -m repro_torch.analysis --help`` for the CLI):

* :mod:`repro_torch.analysis.contracts` — checks on a fake-tensor run of
  each registered entry point's op stream (stable over ``p_miss``
  rebinds, no float64 under a float64 default dtype, no host read or
  host transfer, an in-place train step), plus the shared dispatch-count
  assertions;
* :mod:`repro_torch.analysis.stream_checks` — the stream's collectives
  and copies (the JAX package's HLO-level checks);
* :mod:`repro_torch.analysis.lint` — AST rules (engine determinism,
  silent excepts, host reads in step bodies, kernel parity coverage, no
  kernel fallback to the plain version).

The registry (:data:`repro_torch.analysis.registry.CONTRACTS`) is the
single declaration point, under the JAX registry's nine names; the CLI
runs against the committed ``analysis_baseline_torch.json``.
"""

from repro_torch.analysis.contracts import (  # noqa: F401
    assert_fused_dispatches, assert_single_dispatch,
    assert_tick_dispatch_bracket, assert_trace_count, fused_dispatch_bound,
)
from repro_torch.analysis.registry import (  # noqa: F401
    CONTRACTS, check_all, check_contract, contract_names, get_contract,
)
from repro_torch.analysis.report import (  # noqa: F401
    Finding, Report, load_baseline,
)

__all__ = [
    "CONTRACTS", "Finding", "Report", "assert_fused_dispatches",
    "assert_single_dispatch", "assert_tick_dispatch_bracket",
    "assert_trace_count", "check_all", "check_contract", "contract_names",
    "fused_dispatch_bound", "get_contract", "load_baseline",
]
