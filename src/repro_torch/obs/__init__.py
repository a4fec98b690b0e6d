"""Observability of the port: the flight-recorder :class:`Tracer` with its
zero-cost :data:`NULL_TRACER`, and the shared percentile helpers."""

from repro_torch.obs.stats import Summary, pct
from repro_torch.obs.trace import NULL_TRACER, NullTracer, Tracer, get_tracer, set_tracer

__all__ = ["NULL_TRACER", "NullTracer", "Summary", "Tracer", "get_tracer", "pct", "set_tracer"]
