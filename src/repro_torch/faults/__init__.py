"""Channel fault injection: bursty sensing, worker dropout, degradation."""

from repro_torch.faults.model import (
    POLICIES,
    DegradePolicy,
    FaultAccounting,
    FaultModel,
    FaultState,
    aggregate,
    aggregate_with_ideal,
    effective_p_miss,
    init_state,
    stack_models,
    step_chains,
)

__all__ = [
    "POLICIES",
    "DegradePolicy",
    "FaultAccounting",
    "FaultModel",
    "FaultState",
    "aggregate",
    "aggregate_with_ideal",
    "effective_p_miss",
    "init_state",
    "stack_models",
    "step_chains",
]
