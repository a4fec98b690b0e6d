"""Deadline-driven stepping policies (DESIGN.md §5/§7).

A :class:`DeadlinePolicy` decides *when* a BSP iteration steps and *what*
decode it steps with, given the per-partition arrival clocks of one
iteration (:class:`~repro_torch.core.simulator.PartitionTimes`):

- ``exact_first``     — wait for the earliest exact decodable moment (the
  paper's Eq. 3 semantics); only if none arrives by the deadline, step
  best-effort with whatever did.
- ``bounded_residual`` — step at the first instant the best-effort decode's
  RMS residual drops to ``target_residual`` (exact counts as 0); cap at the
  deadline.  This is the noisy-estimate workhorse: it banks most of the
  exactness while refusing to wait for the long tail.
- ``fixed_deadline``  — always step at the deadline with whatever arrived.

The paper's exact semantics are the degenerate member of the same family:
:meth:`DeadlinePolicy.exact` is ``exact_first`` with an infinite deadline
and ``step_inexact=False`` (an iteration that cannot decode exactly is
skipped, never stepped best-effort).  The trainer therefore has ONE step
path — there is no separate exact loop.

The deadline itself *adapts*: unless pinned via ``deadline_s``, it is
``slack ×`` the iteration time the EWMA throughput estimates predict for an
exact decode — so as the estimator converges on the true speeds, the
deadline tightens around the genuinely achievable iteration time.

The policy is not gradient-specific: ``resolve`` consumes any
(:class:`GradientCode`, :class:`PartitionTimes`) pair, so the same machinery
prices *serving* — coded prefill shares across heterogeneous replicas — as a
tail-latency SLO policy (DESIGN.md §9).  :meth:`DeadlinePolicy.for_slo`
builds the serving-facing instance (answer from the first decodable replica
subset, capped by a TTFT deadline) and :data:`SLOPolicy` is the
serving-facing name of the class.

Resolution is arrival-driven (DESIGN.md §7): all-or-nothing schemes stream
whole-worker completion events through an incremental
:class:`~repro_torch.core.decoding.DecodableSetTracker` — O(rank·k) per event, a
full solve only at the chosen instant — so every event is examined even at
large m.  Schemes declaring ``reports_partial_work`` are decoded from
completed partition *prefixes* (``decode_partial`` over ``support_at``);
their effective-B rows grow per event, outside the tracker's rank-update
model, so they keep the bounded event scan (``max_events``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.decoding import DecodableSetTracker, DecodeError, DecodeOutcome
from repro_torch.core.registry import GradientCode
from repro_torch.core.simulator import PartitionTimes

__all__ = ["DEADLINE_MODES", "DeadlinePolicy", "SLOPolicy", "StepTick", "DeadlineTick"]

DEADLINE_MODES = ("exact_first", "bounded_residual", "fixed_deadline")


@dataclasses.dataclass(frozen=True)
class StepTick:
    """One control-plane iteration: chosen step time + decode outcome +
    the observation the throughput estimator should fold in.

    Attributes:
      T: wall-clock instant the policy stepped at (inf: exact mode failed
        to decode — the iteration is skipped and the clock is unbounded).
      deadline: the deadline in force (inf in exact mode).
      outcome: the decode taken — exact or best-effort.
      ptimes: the iteration's per-partition clocks (for metrics/debugging).
      n_used: workers entering the decode — the step metric (exact mode
        counts the earliest-decodable used set, deadline mode the decode
        vector's support).
      work_done: (m,) work observed by T — completed partitions, or for
        ``censored`` workers the upper BOUND they provably failed to beat.
      censored: (m,) True where ``work_done`` is a right-censored bound
        (deadline-missers with no progress signal), not a real sample; the
        estimator must only let it LOWER an estimate, never raise it.
      observe_full: exact-mode observation semantics — fold the full
        finish-time vector (every worker's true completion is known once
        the iteration ends), and only when the iteration stepped.
    """

    T: float
    deadline: float
    outcome: DecodeOutcome
    ptimes: PartitionTimes
    n_used: int
    work_done: np.ndarray
    censored: np.ndarray
    observe_full: bool


# back-compat alias (pre-§7 name, deadline-mode only)
DeadlineTick = StepTick


@dataclasses.dataclass
class DeadlinePolicy:
    """When to step an iteration — the single stepping policy, exact
    semantics included.

    Args:
      mode: one of :data:`DEADLINE_MODES`.
      target_residual: RMS residual at which ``bounded_residual`` steps
        (0 = wait for exact, i.e. ``exact_first`` with a cap).
      slack: adaptive deadline = slack × EWMA-predicted exact iteration time.
      deadline_s: fixed deadline override (seconds); None = adapt, inf =
        never time out (exact mode).
      step_inexact: False = the paper's exact semantics — an iteration whose
        outcome is inexact is skipped by the trainer instead of stepped
        best-effort.  :meth:`exact` is the canonical False instance.
      max_events: cap on candidate step instants evaluated per iteration
        for partial-work schemes (each costs one lstsq on the masked B);
        events are subsampled evenly beyond it.  All-or-nothing schemes
        stream through the incremental tracker and need no cap.
    """

    mode: str = "bounded_residual"
    target_residual: float = 0.2
    slack: float = 1.5
    deadline_s: float | None = None
    step_inexact: bool = True
    max_events: int = 64
    # observability seam (DESIGN.md §10): the trainer/engine installs its
    # Tracer here; None keeps resolution emission-free.  Excluded from
    # repr/eq — two policies with different tracers are the same policy.
    tracer: object | None = dataclasses.field(default=None, repr=False, compare=False)

    def __post_init__(self) -> None:
        if self.mode not in DEADLINE_MODES:
            raise ValueError(f"unknown deadline mode {self.mode!r}; choose from {DEADLINE_MODES}")
        if self.target_residual < 0:
            raise ValueError("target_residual must be >= 0")

    @classmethod
    def exact(cls) -> "DeadlinePolicy":
        """The paper's exact stepping semantics as a policy: wait for the
        earliest exact-decodable moment, never time out, never step an
        inexact outcome."""
        return cls(mode="exact_first", deadline_s=np.inf, step_inexact=False)

    @classmethod
    def for_slo(
        cls,
        mode: str = "exact_first",
        *,
        ttft_slo_s: float | None = None,
        target_residual: float = 0.0,
        slack: float = 1.5,
    ) -> "DeadlinePolicy":
        """Tail-latency SLO policy for coded serving (DESIGN.md §9): answer
        a request from the first decodable replica subset; if none decodes
        by the TTFT deadline, answer best-effort from whatever arrived.

        ``ttft_slo_s`` pins the deadline to an absolute time-to-first-token
        budget; None adapts it (``slack ×`` the predicted exact-decode
        instant), tightening the tail as replica-speed estimates converge —
        identical semantics to the training deadline, with "step the
        iteration" reread as "answer the request"."""
        return cls(
            mode=mode,
            target_residual=target_residual,
            slack=slack,
            deadline_s=ttft_slo_s,
            step_inexact=True,
        )

    # -- deadline adaptation -----------------------------------------------

    def deadline_for(
        self, code: GradientCode, c_est: np.ndarray, comm_time: float = 0.0
    ) -> float:
        """Deadline from the EWMA estimates: predicted per-worker finish
        times under the current allocation, then the earliest exact-decode
        instant those times imply, stretched by ``slack``."""
        if self.deadline_s is not None:
            return float(self.deadline_s)
        loads = code.worker_load().astype(np.float64)
        pred = loads / np.maximum(np.asarray(c_est, np.float64), 1e-12) + comm_time
        try:
            t, _ = code.earliest_decodable(pred)
        except DecodeError:
            t = float(np.max(pred))
        return float(self.slack * t)

    # -- per-iteration resolution ------------------------------------------

    def _outcome_at(
        self, code: GradientCode, ptimes: PartitionTimes, t: float, partial: bool = True
    ) -> DecodeOutcome:
        """Best decode achievable at instant t: completed prefixes for
        partial-work schemes, finished workers (LRU-cached) otherwise.
        ``partial=False`` forces the whole-worker view — exact-mode callers
        never step a prefix decode, so they resolve the set semantics the
        exact contract defines."""
        if partial and code.reports_partial_work:
            return code.decode_partial(ptimes.support_at(t))
        finished = [
            w
            for w in range(ptimes.m)
            if len(ptimes.partitions[w])
            and np.isfinite(ptimes.finish[w])
            and ptimes.finish[w] <= t
        ]
        return code.decode_outcome(finished)

    def _resolve_bounded_streaming(
        self, code: GradientCode, ptimes: PartitionTimes, deadline: float
    ) -> tuple[float, DecodeOutcome]:
        """bounded_residual for all-or-nothing schemes, arrival-driven: the
        finished-worker set only changes at whole-worker completions, and
        the tracker prices each one at O(rank·k) — every event is examined,
        no subsampling, a real solve only at trigger instants."""
        tracker = DecodableSetTracker(code.B)
        finished: list[int] = []
        # the tracker's residual equals the solver's to ~fp noise; widen the
        # threshold by a generous margin and let the scheme's real solver
        # confirm before committing to a step instant (a false trigger only
        # costs one cached solve, a missed one would delay the step)
        trigger = self.target_residual + 1e-4
        last_t: float | None = None
        for t, w in ptimes.worker_stream(deadline):
            finished.append(int(w))
            tracker.add(int(w))
            last_t = float(t)
            if tracker.maybe_decodable or tracker.residual <= trigger:
                outcome = code.decode_outcome(finished)
                if outcome.exact or outcome.residual <= self.target_residual:
                    return float(t), outcome
        # nothing qualified: the information set at the deadline is the set
        # of workers that finished by it
        return deadline, self._outcome_at(code, ptimes, last_t if last_t is not None else deadline)

    def resolve(
        self, code: GradientCode, ptimes: PartitionTimes, deadline: float
    ) -> tuple[float, DecodeOutcome, tuple[int, ...] | None]:
        """Pick (step time τ, decode outcome, used set) for one iteration's
        clocks.  ``used`` is the earliest-decodable worker set when the
        exact Eq. 3 search chose the instant, None otherwise.

        With a :attr:`tracer` installed, each resolution lands as one
        ``deadline.resolve`` instant (mode, deadline, τ, exactness,
        residual, n_used, capped) — the per-decision audit trail the
        straggler forensics and obs_report consume."""
        tau, outcome, used = self._resolve(code, ptimes, deadline)
        tr = self.tracer
        if tr is not None and tr.enabled:
            tr.instant(
                "deadline.resolve",
                mode=self.mode, deadline=float(deadline), tau=float(tau),
                exact=bool(outcome.exact), residual=float(outcome.residual),
                n_used=int(outcome.n_used),
                capped=bool(np.isfinite(deadline) and tau >= deadline),
            )
        return tau, outcome, used

    def _resolve(
        self, code: GradientCode, ptimes: PartitionTimes, deadline: float
    ) -> tuple[float, DecodeOutcome, tuple[int, ...] | None]:
        if self.mode == "fixed_deadline":
            return deadline, self._outcome_at(code, ptimes, deadline), None

        if self.mode == "exact_first":
            try:
                t, used = code.earliest_decodable(ptimes.finish)
                if t <= deadline:
                    return float(t), code.decode_outcome(used), used
            except DecodeError:
                pass
            return (
                deadline,
                self._outcome_at(code, ptimes, deadline, partial=self.step_inexact),
                None,
            )

        # bounded_residual
        if not code.reports_partial_work:
            t, outcome = self._resolve_bounded_streaming(code, ptimes, deadline)
            return t, outcome, None

        # Partial-work schemes: the effective-B rows GROW per event, outside
        # the tracker's append-only rank-update model, so scan arrival
        # events with masked solves.  The residual is NOT monotone in t (a
        # completing partition can RAISE the lstsq misfit — heter-aware B
        # has negative entries), so finding the earliest qualifying instant
        # genuinely requires a forward scan; a bisection would skip
        # qualifying events whenever a later event regresses past the
        # target.  The scan exits at the first hit — cheap in the common
        # early-step case — and events are evenly subsampled to max_events
        # (endpoints kept) to bound the worst-case solve count.
        events = ptimes.event_times(deadline)
        if events.size > self.max_events:
            idx = np.unique(np.linspace(0, events.size - 1, self.max_events).round().astype(int))
            events = events[idx]
        last: DecodeOutcome | None = None
        for t in events:
            last = self._outcome_at(code, ptimes, float(t))
            if last.exact or last.residual <= self.target_residual:
                return float(t), last, None
        if last is not None:
            # nothing qualified: nothing arrives in (events[-1], deadline],
            # so the last event's (already solved) outcome IS the deadline's
            return deadline, last, None
        return deadline, self._outcome_at(code, ptimes, deadline), None


# serving-facing alias (DESIGN.md §9): a tail-latency SLO policy over coded
# replica arrivals is the same object as a deadline policy over coded worker
# arrivals — construct via DeadlinePolicy.for_slo().
SLOPolicy = DeadlinePolicy
