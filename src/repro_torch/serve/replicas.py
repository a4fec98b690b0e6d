"""Coded prefill across heterogeneous simulated replicas (DESIGN.md §9);
the port of ``src/repro/serve/replicas.py``, numpy only, copied with its
imports rewritten.

The paper's training-time move — answer from the first decodable subset of
heterogeneous workers instead of the slowest — applied to inference: each
request's prefill is split into ``k`` coded shares held by ``m`` replicas
under a registered :class:`~repro_torch.core.registry.GradientCode`, replica
latencies come from a :class:`~repro_torch.core.simulator.ClusterSim` (the same
heterogeneity + straggler models the trainer is benchmarked under), and an
:class:`~repro_torch.approx.deadline.SLOPolicy` picks the instant the request
becomes *answerable*: the earliest decodable replica subset, capped by the
TTFT deadline.

The model compute itself runs once on the local :class:`LMServer` (replica 0
stands in for the decoded result: one device serves); the pool
contributes the *clock*: when that result would have been available on a
real heterogeneous fleet, under both the coded/SLO policy (``t_first``) and
naive wait-for-all replication (``t_all``).  That split mirrors the training
stack, where the simulator owns timing claims and the aggregator owns the
gradient math.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.approx.deadline import SLOPolicy
from repro_torch.core.registry import get_scheme
from repro_torch.core.simulator import ClusterSim, mask_workers
from repro_torch.core.straggler import NoStragglers, StragglerModel

__all__ = ["PrefillOutcome", "ReplicaPool"]


@dataclasses.dataclass(frozen=True)
class PrefillOutcome:
    """One request's simulated coded-prefill timing.

    Attributes:
      t_first: seconds until the SLO policy answers — the first decodable
        replica subset (or the SLO deadline, best-effort).
      t_all: seconds until wait-for-all replication would answer (the
        slowest replica holding work; inf if a replica died).
      n_used: replicas whose shares entered the decode.
      exact: the decode was exact (not a best-effort deadline answer).
      residual: RMS decode residual (0 when exact).
    """

    t_first: float
    t_all: float
    n_used: int
    exact: bool
    residual: float


class ReplicaPool:
    """``m`` simulated prefill replicas with true throughputs ``speeds``.

    Args:
      speeds: (m,) replica throughputs in shares/second.
      scheme: registered gradient-code family coding the prefill shares.
      s: straggler tolerance (exact decode from any m−s replicas).
      k: shares per request (default: scheme's preference for m).
      comm_time: per-replica response transit seconds.
      straggler_model: per-request straggler realization (default none).
      policy: SLO policy; default :meth:`SLOPolicy.for_slo` (first
        decodable subset, adaptive TTFT deadline).
      work_ref_tokens: prompt length the speed unit is calibrated to —
        simulated times scale linearly with ``n_tokens / work_ref_tokens``.
      seed: RNG stream for code construction and straggler sampling.
    """

    def __init__(
        self,
        speeds,
        *,
        scheme: str = "heter_aware",
        s: int = 1,
        k: int | None = None,
        comm_time: float = 0.0,
        straggler_model: StragglerModel | None = None,
        policy: SLOPolicy | None = None,
        work_ref_tokens: int = 128,
        seed: int = 0,
    ):
        self.speeds = np.asarray(speeds, dtype=np.float64)
        self.code = get_scheme(scheme, m=len(self.speeds), k=k, s=s, c=self.speeds, rng=seed)
        self.sim = ClusterSim(self.code, self.speeds, comm_time=comm_time)
        self.policy = policy if policy is not None else SLOPolicy.for_slo()
        self.straggler_model = straggler_model or NoStragglers()
        self.work_ref_tokens = int(work_ref_tokens)
        self.rng = np.random.default_rng(seed)
        self._dead: set[int] = set()

    @property
    def m(self) -> int:
        return int(self.code.m)

    # -- replica death (DESIGN.md §11) --------------------------------------

    @property
    def dead(self) -> frozenset[int]:
        """Replica indices currently marked dead."""
        return frozenset(self._dead)

    def mark_dead(self, ids) -> None:
        """Mark replicas dead: their shares never arrive, so every
        subsequent prefill answers from the surviving decodable subset
        (erasure — with ≤ s dead the decode stays exact; beyond that the
        SLO policy's best-effort deadline path takes over).  Wait-for-all
        replication (``t_all``) goes to inf when a dead replica holds
        shares — the counterfactual a replicated deployment would suffer."""
        ids = {int(i) for i in ids}
        if any(not 0 <= i < self.m for i in ids):
            raise ValueError(f"replica ids out of range [0, {self.m}): {sorted(ids)}")
        self._dead |= ids

    def revive(self, ids=None) -> None:
        """Bring replicas back (None = all) — the recovery half of a
        simulated replica-death drill."""
        if ids is None:
            self._dead.clear()
        else:
            self._dead -= {int(i) for i in ids}

    def prefill(self, n_tokens: int, rng: np.random.Generator | None = None) -> PrefillOutcome:
        """Sample one request's replica clocks and resolve them under the
        SLO policy.  Returns both the policied and the wait-for-all instant
        so callers can report the counterfactual without resampling."""
        rng = rng if rng is not None else self.rng
        ptimes = self.sim.sample_partition_times(self.straggler_model, rng)
        if self._dead:
            ptimes = mask_workers(ptimes, sorted(self._dead))
        deadline = self.policy.deadline_for(self.code, self.speeds, self.sim.comm_time)
        t, outcome, used = self.policy.resolve(self.code, ptimes, deadline)
        scale = n_tokens / self.work_ref_tokens
        # wait-for-all: every replica holding shares must report
        loaded = self.code.worker_load() > 0
        t_all = float(np.max(ptimes.finish[loaded])) if loaded.any() else 0.0
        return PrefillOutcome(
            t_first=float(t) * scale,
            t_all=t_all * scale,
            n_used=len(used) if used is not None else outcome.n_used,
            exact=bool(outcome.exact),
            residual=float(outcome.residual),
        )
