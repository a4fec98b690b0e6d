"""FaultSupervisor: suspicion-driven failure detection + graceful
degradation (DESIGN.md §11).

The paper tolerates a *predetermined* number of stragglers that are merely
slow; this layer closes the loop on workers that are actually broken.  The
supervisor consumes what the arrival-driven control plane already produces
— per-worker arrival clocks from the ``ArrivalStream`` (via each
:class:`~repro_torch.approx.deadline.StepTick`), deadline misses, and the
engine's non-finite payload detections — and maintains a per-worker health
state machine keyed by ORIGINAL worker id:

    healthy ──(missed arrivals / corrupt payloads)──► suspect
    suspect ──(suspicion ≥ threshold)──────────────► convicted (masked)
    convicted ──(elastic remove_workers)───────────► evicted
    evicted ──(hang window over, re-admit)─────────► healthy

**Suspicion** is phi-accrual-style: a no-show at the step's resolution
instant τ accrues ``min(τ / E_w, miss_cap)`` where ``E_w = load_w/ĉ_w +
comm`` is the expected finish from the ThroughputEstimator's EWMA — so a
slow-but-alive worker that simply wasn't given enough time accrues little,
while a dead worker whose peers finished long after its expected time
accrues a full miss.  Arrivals decay suspicion multiplicatively (flaky
workers whose retried uploads land never convict); ``miss_convict``
consecutive total no-shows convict regardless of phi (covers the exact-mode
case where τ is set by fast peers and phi stays < 1).

**Corruption** is attributed by co-occurrence + repair: every worker whose
decode coefficient was live in a non-finite step is suspected
(``corrupt_seen``); a finite step clears the co-occurrence counter for its
participants; a successful repair — the step re-decoded finite after
excluding exactly this worker — is near-certain evidence
(``corrupt_confirmed``).  Either counter crossing its threshold convicts.

**Degradation ladder** on conviction (exact → inexact → erasure → evict):
the worker is immediately masked out of the decodable set (erasure via
:func:`~repro_torch.core.simulator.mask_workers` — the existing partial-decode
machinery treats it as never arriving), then the trainer drains the
eviction through ``ElasticController.remove_workers`` (bumping
``Codec.version`` through the membership remap path).  If eviction is infeasible
(m would drop to s, a structural scheme's remap rejects the new m, or the
spmd backend's fixed mesh) the worker simply STAYS masked — training
degrades gracefully instead of crashing.  A hang-evicted worker whose
window ends is re-admitted under its original identity with its
pre-eviction EWMA estimate as the calibration prior.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.simulator import FaultyClusterSim, PartitionTimes, mask_workers
from repro_torch.obs.trace import NULL_TRACER

__all__ = ["FaultSupervisor", "WorkerHealth"]

_TOL = 1e-9
_USED_TOL = 1e-12


@dataclasses.dataclass
class WorkerHealth:
    """One worker's accumulated health evidence (keyed by ORIGINAL id)."""

    orig: int
    suspicion: float = 0.0  # phi-accrual accumulator
    consecutive_misses: int = 0  # total no-shows in a row
    misses: int = 0  # lifetime no-shows
    retries: int = 0  # lifetime retried (lost-then-recovered) uploads
    corrupt_seen: int = 0  # co-occurrence in non-finite decodes (reset on clean)
    corrupt_confirmed: int = 0  # repair-confirmed corruptions (never reset)
    quarantines: int = 0  # times excluded from a repair decode
    status: str = "healthy"  # healthy | convicted | evicted
    reason: str | None = None
    convicted_step: int | None = None
    evicted_step: int | None = None
    # pre-eviction snapshot for re-admission
    speed: float | None = None
    c_est: float | None = None
    # infeasible-eviction backoff: next step the eviction may be retried
    # and the current retry spacing (doubles per deferral, capped)
    evict_retry_step: int | None = None
    evict_backoff: int = 1

    def state_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_state(cls, state: dict) -> "WorkerHealth":
        return cls(**state)


class FaultSupervisor:
    """Per-worker failure detector + degradation driver (module docstring).

    Args:
      suspicion_threshold: accumulated phi that convicts.
      miss_cap: per-step cap on the phi increment (one very long iteration
        must not convict on its own).
      decay: multiplicative suspicion decay on an on-time arrival.
      late_penalty: additive suspicion for a late-but-finite arrival.
      miss_convict: consecutive total no-shows that convict regardless of
        accumulated phi.
      corrupt_convict: co-occurrence count in non-finite steps that
        convicts (cleared whenever the worker participates in a clean step).
      confirm_convict: repair-confirmed corruptions that convict.
      max_repairs: decode-exclusion retries the trainer attempts per
        non-finite step before skipping it.
      readmit: re-admit hang-evicted workers once their window ends.
    """

    def __init__(
        self,
        *,
        suspicion_threshold: float = 3.0,
        miss_cap: float = 1.5,
        decay: float = 0.5,
        late_penalty: float = 0.25,
        miss_convict: int = 5,
        corrupt_convict: int = 4,
        confirm_convict: int = 2,
        max_repairs: int = 2,
        readmit: bool = True,
    ):
        if suspicion_threshold <= 0 or miss_cap <= 0:
            raise ValueError("suspicion_threshold and miss_cap must be positive")
        if not 0.0 <= decay < 1.0:
            raise ValueError("decay must be in [0, 1)")
        self.suspicion_threshold = float(suspicion_threshold)
        self.miss_cap = float(miss_cap)
        self.decay = float(decay)
        self.late_penalty = float(late_penalty)
        self.miss_convict = int(miss_convict)
        self.corrupt_convict = int(corrupt_convict)
        self.confirm_convict = int(confirm_convict)
        self.max_repairs = int(max_repairs)
        self.readmit = bool(readmit)

        self.health: dict[int, WorkerHealth] = {}
        self.convictions: list[dict] = []  # {step, worker(orig), reason, suspicion}
        self.evictions: list[dict] = []
        self.readmissions: list[dict] = []
        self.nonfinite_steps = 0
        self.repaired_steps = 0

        self._elastic = None  # ElasticController, installed by bind()
        self._sim: FaultyClusterSim | None = None
        self.tracer = NULL_TRACER
        self.forensics = None  # optional StragglerForensics fault ledger

    # -- wiring --------------------------------------------------------------

    def bind(self, elastic, *, tracer=None, forensics=None) -> None:
        """Attach to a controller whose sim is a :class:`FaultyClusterSim`;
        installs the erasure filter on the controller's tick path."""
        sim = elastic.sim
        if not isinstance(sim, FaultyClusterSim):
            raise TypeError(
                "FaultSupervisor needs a FaultyClusterSim (construct the "
                "trainer/controller with a FaultSchedule — an empty one is fine)"
            )
        self._elastic = elastic
        self._sim = sim
        if tracer is not None:
            self.tracer = tracer
        self.forensics = forensics
        elastic.fault_filter = self.filter_ptimes

    def _health(self, orig: int) -> WorkerHealth:
        h = self.health.get(int(orig))
        if h is None:
            h = self.health[int(orig)] = WorkerHealth(orig=int(orig))
        return h

    def orig_of(self, cur: int) -> int:
        return int(self._sim.orig_of_cur[int(cur)])

    # -- erasure masking (the tick filter) ----------------------------------

    def masked_origs(self) -> set[int]:
        """Original ids currently masked out of the decodable set: convicted
        but not yet (or not evictably) removed."""
        return {o for o, h in self.health.items() if h.status == "convicted"}

    def filter_ptimes(self, ptimes: PartitionTimes) -> PartitionTimes:
        """Erase convicted workers' arrivals from one iteration's clocks —
        the decode machinery then treats them as full erasures."""
        masked = self.masked_origs()
        if not masked:
            return ptimes
        cur = [
            w for w, o in enumerate(self._sim.orig_of_cur)
            if o in masked and w < ptimes.m
        ]
        return mask_workers(ptimes, cur)

    # -- timing suspicion (ArrivalStream + deadline misses) ------------------

    def observe_timing(self, step: int, tick, loads: np.ndarray) -> None:
        """Fold one step's arrival outcomes into per-worker suspicion.

        ``tick.ptimes`` is the post-filter clock view; masked workers are
        skipped (their evidence is already a conviction).  The reference
        instant is τ when the step resolved, else the deadline, else the
        latest finite arrival — if nothing is finite there is no clock to
        measure against and the step carries no timing evidence.
        """
        finish = tick.ptimes.finish
        ref = float(tick.T)
        if not np.isfinite(ref):
            ref = float(tick.deadline)
        if not np.isfinite(ref):
            finite = finish[np.isfinite(finish)]
            if finite.size == 0:
                return
            ref = float(finite.max())
        c_est = np.maximum(self._elastic.estimator.c, 1e-9)
        comm = float(self._sim.comm_time)
        tr = self.tracer
        for w in range(len(finish)):
            if loads[w] <= 0:
                continue
            h = self._health(self.orig_of(w))
            if h.status != "healthy":
                continue
            f = float(finish[w])
            if np.isfinite(f) and f <= ref + _TOL:
                # on-time arrival: decay suspicion; count retried uploads
                n_retry = self._sim.last_retries.get(w, 0)
                if n_retry:
                    h.retries += n_retry
                    if tr.enabled:
                        tr.instant("fault.retry", step=int(step), worker=h.orig,
                                   retries=int(n_retry))
                    if self.forensics is not None:
                        self.forensics.on_retry(step, h.orig, n_retry)
                h.suspicion *= self.decay
                h.consecutive_misses = 0
                continue
            expected = float(loads[w]) / float(c_est[w]) + comm
            if np.isfinite(f):
                # late but alive: decayed mild penalty — bounded at
                # late_penalty/(1−decay) < threshold, so chronic lateness
                # alone never convicts (that is the rebalancer's problem,
                # not a failure); it does keep a flapping worker warm
                h.suspicion = h.suspicion * self.decay + self.late_penalty
                h.consecutive_misses = 0
            else:
                # no-show: phi-accrual — how much longer than this worker's
                # expected finish did we provably wait?
                h.suspicion += min(ref / max(expected, 1e-9), self.miss_cap)
                h.consecutive_misses += 1
                h.misses += 1
            if tr.enabled and h.suspicion > 0:
                tr.instant("fault.suspicion", step=int(step), worker=h.orig,
                           suspicion=float(h.suspicion),
                           misses=int(h.consecutive_misses))
            if self.forensics is not None and h.suspicion > 0:
                self.forensics.on_suspicion(step, h.orig, float(h.suspicion))
            if (h.suspicion >= self.suspicion_threshold
                    or h.consecutive_misses >= self.miss_convict):
                self.convict(step, h.orig, "timeout")

    # -- payload suspicion (non-finite coded sums) ---------------------------

    def on_nonfinite(self, step: int, used_cur) -> None:
        """A decode with these CURRENT participants produced a non-finite
        gradient: every live coefficient is a corruption suspect."""
        self.nonfinite_steps += 1
        for w in used_cur:
            h = self._health(self.orig_of(w))
            if h.status != "healthy":
                continue
            h.corrupt_seen += 1
            if h.corrupt_seen >= self.corrupt_convict:
                self.convict(step, h.orig, "corrupt")

    def on_clean(self, used_cur) -> None:
        """A finite decode clears co-occurrence suspicion for its
        participants (their payloads were provably fine this step)."""
        for w in used_cur:
            h = self.health.get(self.orig_of(w))
            if h is not None:
                h.corrupt_seen = 0

    def on_repair_success(self, step: int, excluded_cur: int) -> None:
        """Excluding this worker made the decode finite — near-certain
        corruption evidence."""
        h = self._health(self.orig_of(excluded_cur))
        self.repaired_steps += 1
        h.corrupt_confirmed += 1
        if h.status == "healthy" and h.corrupt_confirmed >= self.confirm_convict:
            self.convict(step, h.orig, "corrupt")

    def on_quarantine(self, step: int, cur: int) -> None:
        h = self._health(self.orig_of(cur))
        h.quarantines += 1
        if self.tracer.enabled:
            tr = self.tracer
            tr.instant("guard.quarantine", step=int(step), worker=h.orig)
        if self.forensics is not None:
            self.forensics.on_quarantine(step, h.orig)

    def repair_candidates(self, used_cur, exclude_cur=()) -> list[int]:
        """CURRENT indices to try excluding, most-suspect first: confirmed
        corruption, then co-occurrence count, then timing suspicion."""
        out = []
        seen = {int(w) for w in exclude_cur}
        for w in used_cur:
            w = int(w)
            if w in seen:
                continue
            h = self._health(self.orig_of(w))
            if h.status != "healthy":
                continue
            out.append((-h.corrupt_confirmed, -h.corrupt_seen, -h.suspicion, h.orig, w))
        out.sort()
        return [w for *_, w in out]

    # -- conviction / eviction / re-admission --------------------------------

    def convict(self, step: int, orig: int, reason: str) -> None:
        h = self._health(orig)
        if h.status != "healthy":
            return
        h.status = "convicted"
        h.reason = reason
        h.convicted_step = int(step)
        row = {"step": int(step), "worker": int(orig), "reason": reason,
               "suspicion": float(h.suspicion)}
        self.convictions.append(row)
        if self.tracer.enabled:
            self.tracer.instant("fault.convict", **row)
        if self.forensics is not None:
            self.forensics.on_conviction(step, orig, reason, float(h.suspicion))

    def eviction_queue(self, step: int | None = None) -> list[int]:
        """Convicted original ids still present in the live worker set whose
        eviction is DUE.  An infeasible eviction (m would reach s, remap
        rejected, device budget) is recorded via
        :meth:`note_eviction_deferred`, which pushes the retry out with
        exponential backoff — without the ``step`` filter the same
        conviction re-surfaces every step (log spam + an O(steps) retry
        bill).  ``step=None`` keeps the unfiltered view for reporting."""
        return [
            o for o, h in sorted(self.health.items())
            if h.status == "convicted" and self._sim.cur_index(o) is not None
            and (step is None or h.evict_retry_step is None
                 or int(step) >= h.evict_retry_step)
        ]

    def note_eviction_deferred(self, step: int, orig: int) -> None:
        """The trainer could not apply this eviction: keep the worker masked
        (erasure) and back off the retry — 1, 2, 4, ... steps, capped."""
        h = self._health(orig)
        h.evict_retry_step = int(step) + h.evict_backoff
        h.evict_backoff = min(h.evict_backoff * 2, 64)

    def note_evicted(self, step: int, orig: int, speed: float, c_est: float) -> None:
        h = self._health(orig)
        h.status = "evicted"
        h.evicted_step = int(step)
        h.speed = float(speed)
        h.c_est = float(c_est)
        h.evict_retry_step = None
        h.evict_backoff = 1
        self.evictions.append({"step": int(step), "worker": int(orig),
                               "reason": h.reason})

    def readmit_queue(self, step: int) -> list[tuple[int, float, float]]:
        """(orig, true_speed, c_init) for evicted workers whose hang window
        has provably ended — the simulated "node is back" signal."""
        if not self.readmit:
            return []
        out = []
        for o, h in sorted(self.health.items()):
            if h.status != "evicted" or h.speed is None:
                continue
            if self._sim.schedule.hang_recovered(o, int(step)):
                out.append((o, float(h.speed), float(h.c_est)))
        return out

    def note_readmitted(self, step: int, orig: int) -> None:
        h = self._health(orig)
        h.status = "healthy"
        h.suspicion = 0.0
        h.consecutive_misses = 0
        h.corrupt_seen = 0
        h.reason = None
        h.evict_retry_step = None
        h.evict_backoff = 1
        self.readmissions.append({"step": int(step), "worker": int(orig)})

    # -- reporting / checkpoint ----------------------------------------------

    def summary(self) -> dict:
        return {
            "workers_tracked": len(self.health),
            "convictions": len(self.convictions),
            "evictions": len(self.evictions),
            "readmissions": len(self.readmissions),
            "nonfinite_steps": self.nonfinite_steps,
            "repaired_steps": self.repaired_steps,
            "masked": sorted(self.masked_origs()),
        }

    def state_dict(self) -> dict:
        return {
            "health": {str(o): h.state_dict() for o, h in self.health.items()},
            "convictions": list(self.convictions),
            "evictions": list(self.evictions),
            "readmissions": list(self.readmissions),
            "nonfinite_steps": int(self.nonfinite_steps),
            "repaired_steps": int(self.repaired_steps),
        }

    def load_state_dict(self, state: dict) -> None:
        self.health = {
            int(o): WorkerHealth.from_state(h) for o, h in state["health"].items()
        }
        self.convictions = list(state["convictions"])
        self.evictions = list(state["evictions"])
        self.readmissions = list(state["readmissions"])
        self.nonfinite_steps = int(state["nonfinite_steps"])
        self.repaired_steps = int(state["repaired_steps"])
