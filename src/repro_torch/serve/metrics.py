"""Per-request serving metrics (DESIGN.md §9); the port of
``src/repro/serve/metrics.py``, numpy only, copied with its imports
rewritten.

The trainer surfaces per-step scalars (loss, sim_iter_time, exact_fraction);
serving surfaces the per-request analogs: time-to-first-token, end-to-end
latency, queue wait, and decode throughput — aggregated to p50/p99 the same
way the simulator's :class:`~repro_torch.core.simulator.RunResult` reports
iteration times.  All clocks are the engine's virtual clock (seconds).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.obs.stats import pct

__all__ = ["RequestRecord", "ServingMetrics"]


@dataclasses.dataclass
class RequestRecord:
    """One request's lifecycle timestamps + prefill provenance.

    Attributes:
      rid: request id.
      arrival_t: when the request entered the system.
      admit_t: when admission control granted it a slot.
      prefill_done_t: when its coded prefill became answerable (the SLO
        policy's first-decodable instant).
      prefill_all_done_t: when wait-for-all replication would have made the
        same prefill answerable — the recorded counterfactual the p99-TTFT
        claims are measured against.
      first_token_t: when its first output token was emitted.
      done_t: when its last token was emitted.
      n_tokens: output tokens produced.
      prefill_exact: the coded prefill decoded exactly (vs best-effort at
        the SLO deadline).
      replicas_used: replicas whose shares entered the prefill decode.
    """

    rid: int
    arrival_t: float
    admit_t: float
    prefill_done_t: float
    first_token_t: float
    done_t: float
    n_tokens: int
    prefill_exact: bool = True
    replicas_used: int = 0
    prefill_all_done_t: float = float("nan")

    @property
    def ttft(self) -> float:
        return self.first_token_t - self.arrival_t

    @property
    def latency(self) -> float:
        return self.done_t - self.arrival_t

    @property
    def queue_wait(self) -> float:
        return self.admit_t - self.arrival_t


# the one shared percentile helper (DESIGN.md §10) — same NaN-on-empty
# semantics this module always had, kept under its local name for callers
_pct = pct


class ServingMetrics:
    """Accumulates :class:`RequestRecord`s; ``summary()`` is the serving
    counterpart of the trainer's metrics dict."""

    def __init__(self) -> None:
        self.records: list[RequestRecord] = []
        self.rejected: int = 0

    def observe(self, rec: RequestRecord) -> None:
        self.records.append(rec)

    def reject(self, n: int = 1) -> None:
        self.rejected += n

    def summary(self) -> dict[str, float]:
        recs = self.records
        ttft = [r.ttft for r in recs]
        lat = [r.latency for r in recs]
        wait = [r.queue_wait for r in recs]
        total_tokens = sum(r.n_tokens for r in recs)
        if recs:
            makespan = max(r.done_t for r in recs) - min(r.arrival_t for r in recs)
        else:
            makespan = 0.0
        return {
            "n_requests": float(len(recs)),
            "n_rejected": float(self.rejected),
            "total_tokens": float(total_tokens),
            "tokens_per_s": total_tokens / makespan if makespan > 0 else float("nan"),
            "ttft_p50_s": _pct(ttft, 50),
            "ttft_p99_s": _pct(ttft, 99),
            "latency_p50_s": _pct(lat, 50),
            "latency_p99_s": _pct(lat, 99),
            "queue_wait_mean_s": float(np.mean(wait)) if wait else float("nan"),
            "prefill_exact_fraction": (
                float(np.mean([r.prefill_exact for r in recs])) if recs else float("nan")
            ),
            "replicas_used_mean": (
                float(np.mean([r.replicas_used for r in recs])) if recs else float("nan")
            ),
        }
