"""Failure-domain resilience (DESIGN.md §11).

Public API:
  faults:      ``--faults`` spec grammar + the standard bench fault mix
  supervisor:  phi-accrual suspicion, conviction, eviction/re-admission

The injection layer itself (:class:`FaultEvent`, :class:`FaultSchedule`,
:class:`FaultyClusterSim`, :func:`mask_workers`) lives in
``repro_torch.core.simulator`` — it perturbs the clock model, so it sits with
the clocks — and is re-exported here for convenience.
"""

from repro_torch.core.simulator import (
    FaultEvent,
    FaultSchedule,
    FaultyClusterSim,
    mask_workers,
)
from repro_torch.resilience.faults import parse_fault_spec, standard_fault_mix
from repro_torch.resilience.supervisor import FaultSupervisor, WorkerHealth

__all__ = [
    "FaultEvent",
    "FaultSchedule",
    "FaultyClusterSim",
    "FaultSupervisor",
    "WorkerHealth",
    "mask_workers",
    "parse_fault_spec",
    "standard_fault_mix",
]
