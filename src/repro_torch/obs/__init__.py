"""Observability of the port: the flight-recorder :class:`Tracer` with its
zero-cost :data:`NULL_TRACER`, the shared percentile helpers, and the
straggler forensics ledger (:class:`StragglerForensics`) assembled live or
from a JSONL log."""

from repro_torch.obs.stats import Summary, pct
from repro_torch.obs.straggler import StragglerForensics, WorkerLedger
from repro_torch.obs.trace import NULL_TRACER, NullTracer, Tracer, get_tracer, set_tracer

__all__ = [
    "NULL_TRACER",
    "NullTracer",
    "StragglerForensics",
    "Summary",
    "Tracer",
    "WorkerLedger",
    "get_tracer",
    "pct",
    "set_tracer",
]
