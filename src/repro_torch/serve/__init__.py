"""Coded serving: continuous-batching, straggler-tolerant inference
(DESIGN.md §9); the port of ``src/repro/serve/``.

The training stack answers "step from the first decodable *worker* subset";
this package applies the same move to inference tail latency: prefill is
(simulated-)replicated across a heterogeneous replica pool, and a
:class:`~repro_torch.approx.deadline.SLOPolicy` answers each request from the
first decodable *replica* subset instead of waiting for the stragglers.

Layers:
  - :mod:`repro_torch.serve.replicas` — coded prefill over a
    :class:`~repro_torch.core.simulator.ClusterSim`-modelled replica pool;
  - :mod:`repro_torch.serve.batching` — slot-allocated KV/SSM cache batch with
    mid-flight insert/evict;
  - :mod:`repro_torch.serve.engine`   — request queue + admission control + the
    continuous decode loop;
  - :mod:`repro_torch.serve.metrics`  — per-request TTFT / latency / tokens-per-s
    with p50/p99 summaries, surfaced the way trainer metrics are.
"""

from repro_torch.serve.batching import SlotBatch
from repro_torch.serve.engine import Completion, Request, ServingEngine
from repro_torch.serve.metrics import RequestRecord, ServingMetrics
from repro_torch.serve.replicas import PrefillOutcome, ReplicaPool

__all__ = [
    "Completion",
    "PrefillOutcome",
    "ReplicaPool",
    "Request",
    "RequestRecord",
    "ServingEngine",
    "ServingMetrics",
    "SlotBatch",
]
