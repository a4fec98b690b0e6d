"""ElasticController: throughput estimation + simulated cluster clock +
the elastic re-encode policy (DESIGN.md §4), driving the ONE arrival-driven
stepping loop (DESIGN.md §7) for exact and inexact semantics alike.

Owns the pieces of the control loop that are about the CLUSTER rather than
the model: the ClusterSim that turns straggler profiles into per-partition
arrival clocks (the paper's measured quantity), the EWMA
ThroughputEstimator fed by those observations, and the hysteresis policy
deciding when the codec should re-encode.  The trainer calls three methods
per step: ``tick`` (clock + policy resolution → :class:`StepTick`),
``observe`` (estimation), ``maybe_rebalance`` (policy).

There is no separate exact path: with no explicit policy the controller
runs :meth:`DeadlinePolicy.exact` — ``exact_first`` at an infinite
deadline — and the exact semantics (skip on undecodable, full finish-time
observations) fall out of the same tick/observe pair.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.approx.deadline import DeadlinePolicy, StepTick
from repro_torch.core.codec import Codec
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.core.registry import MembershipStats
from repro_torch.core.simulator import (
    ChurnSchedule,
    ClusterSim,
    FaultSchedule,
    FaultyClusterSim,
)
from repro_torch.core.straggler import StragglerProfile
from repro_torch.core.throughput import ThroughputEstimator

__all__ = ["ElasticController"]


class ElasticController:
    """Rebalance policy + timing clock around one codec.

    Args:
      codec: the codec whose code is re-encoded on drift.  The ClusterSim
        holds the same GradientCode, so a rebalance is picked up in place
        (shared decode cache included) — no sim rebuild.
      true_speeds: (m,) ground-truth worker throughputs driving the clock.
        The estimator only ever sees *observations*, so estimation error
        (the paper's §V motivation) is reproducible.
      comm_time: per-worker result upload seconds (simulated).
      c_init: optional calibration prior for the estimator.
      policy: stepping policy; None = :meth:`DeadlinePolicy.exact` (the
        paper's exact semantics — same loop, infinite deadline).
      faults: optional :class:`FaultSchedule` — the sim becomes a
        :class:`FaultyClusterSim` perturbing clocks/payloads (DESIGN.md
        §11); ``fault_seed`` keys its deterministic per-step sampling.
    """

    def __init__(
        self,
        codec: Codec,
        *,
        true_speeds: np.ndarray | None = None,
        comm_time: float = 0.0,
        c_init: np.ndarray | None = None,
        policy: DeadlinePolicy | None = None,
        churn: ChurnSchedule | None = None,
        faults: FaultSchedule | None = None,
        fault_seed: int = 0,
    ):
        m = codec.m
        self.codec = codec
        self.policy = policy if policy is not None else DeadlinePolicy.exact()
        self.true_speeds = (
            np.asarray(true_speeds, np.float64) if true_speeds is not None else np.ones(m)
        )
        self.estimator = ThroughputEstimator(
            m, init=np.asarray(c_init, np.float64) if c_init is not None else np.ones(m)
        )
        if faults is not None:
            self.sim: ClusterSim = FaultyClusterSim(
                codec.code, self.true_speeds, comm_time=comm_time,
                wait_for_all=codec.code.wait_for_all, churn=churn,
                schedule=faults, seed=fault_seed,
            )
        else:
            self.sim = ClusterSim(
                codec.code, self.true_speeds, comm_time=comm_time,
                wait_for_all=codec.code.wait_for_all, churn=churn,
            )
        # erasure seam (DESIGN.md §11): a FaultSupervisor installs a
        # PartitionTimes -> PartitionTimes filter here; convicted workers'
        # arrivals are erased BEFORE the policy resolves, so the decode,
        # the observation plan, and the forensics all see the masked view
        self.fault_filter = None
        # engine rebuild seam (DESIGN.md §13), installed by whoever owns a
        # StepEngine: pre_transition(m_new) vetoes an infeasible transition
        # BEFORE any state mutates (spmd device budget); on_transition(
        # old_of_new) reports each APPLIED transition's row identity map so
        # per-worker wire state can be carried across the rebuild
        self.pre_transition = None
        self.on_transition = None
        # highest step whose churn events have been drained: a skipped
        # iteration leaves state.step unchanged, so the trainer asks about
        # the same step again and must NOT get the events twice
        self._churn_drained = -1
        # observability seam (DESIGN.md §10): the trainer installs its
        # tracer; standalone controllers keep the zero-cost NULL singleton
        self.tracer = NULL_TRACER

    @property
    def m(self) -> int:
        return self.codec.m

    @property
    def membership_epoch(self) -> int:
        """Transitions applied so far — the code's counter IS the truth
        (direct ``Codec.remap_members`` callers bump it too)."""
        return self.codec.code.membership_epoch

    def tick(self, profile: StragglerProfile) -> StepTick:
        """One control-plane iteration: per-partition arrival clocks → the
        policy's (τ, outcome) choice → the observation plan.  Exact mode is
        the same resolution at an infinite deadline."""
        code = self.codec.code
        policy = self.policy
        ptimes = self.sim.partition_times(profile)
        if self.fault_filter is not None:
            ptimes = self.fault_filter(ptimes)
        deadline = policy.deadline_for(code, self.estimator.c, self.sim.comm_time)
        tau, outcome, used = policy.resolve(code, ptimes, deadline)
        loads = code.worker_load().astype(np.float64)
        m = code.m

        if not policy.step_inexact:
            # exact semantics: every worker's true finish time is known once
            # the iteration completes, so the observation is the full finish
            # vector (folded only when the iteration actually steps)
            return StepTick(
                T=float(tau), deadline=float(deadline), outcome=outcome,
                ptimes=ptimes,
                n_used=len(used) if used is not None else outcome.n_used,
                work_done=loads, censored=np.zeros(m, dtype=bool),
                observe_full=True,
            )

        finished = np.isfinite(ptimes.finish) & (ptimes.finish <= tau)
        if code.reports_partial_work:
            work = ptimes.work_done_at(float(tau))
            # zero progress by τ is a right-censored sample, not "no signal":
            # the worker provably could not sustain even 1/τ — without that
            # bound a frozen overestimate would repeat the over-allocation
            # (and the too-tight deadline) forever
            censored = (loads > 0) & (work == 0)
            work = np.where(censored, 1.0, work)
        else:
            # all-or-nothing reporting: mid-iteration progress is telemetry
            # the scheme's contract says does not exist.  A finished worker
            # reports its full load; a deadline-misser only the censored
            # bound load/τ it provably failed to beat.
            work = loads
            censored = (loads > 0) & ~finished
        return StepTick(
            T=float(tau), deadline=float(deadline), outcome=outcome,
            ptimes=ptimes, n_used=outcome.n_used,
            work_done=work, censored=censored, observe_full=False,
        )

    def observe(self, tick: StepTick) -> None:
        """Fold one tick's observation into the EWMA estimate.

        Exact mode (``observe_full``): the full finish-time vector against
        the whole-worker loads — but only when the iteration stepped (an
        undecodable exact iteration is skipped wholesale, clock included).
        Deadline mode: worker i did ``work_done[i]`` partitions in
        ``min(T, finish_i)`` seconds (finishing early must not read as
        slowness).  Censored entries are upper BOUNDS (c_i ≤ work/τ):
        informative only when they undercut the current estimate, so they
        are capped at it — an overestimated worker is pulled down toward
        the bound, a correctly-estimated one is left alone."""
        if tick.observe_full:
            if tick.outcome.exact:
                self.estimator.update(tick.ptimes.finish, self.codec.code.worker_load())
            return
        finish = tick.ptimes.finish
        elapsed = np.where(np.isfinite(finish) & (finish <= tick.T), finish, tick.T)
        work = np.where(
            tick.censored,
            np.minimum(tick.work_done, self.estimator.c * elapsed),
            tick.work_done,
        )
        self.estimator.update(elapsed, work)

    def maybe_rebalance(self, step: int, every: int) -> bool:
        """Elastic re-encode when due, supported, and drifted past the
        hysteresis band.  Returns True when the codec was re-encoded."""
        if every <= 0 or step % every != 0:
            return False
        if not self.codec.code.supports_rebalance:
            return False
        if not self.estimator.should_rebalance():
            return False
        self.codec.rebalance(self.estimator.normalized())
        self.estimator.mark_applied()
        tr = self.tracer
        if tr.enabled:
            tr.instant(
                "elastic.rebalance", step=int(step),
                c_est=[float(x) for x in self.estimator.normalized()],
            )
        return True

    # -- elastic membership (DESIGN.md §8) -----------------------------------

    def add_workers(
        self, speeds: Sequence[float], c_init: Sequence[float] | None = None
    ) -> MembershipStats:
        """Grow the worker set in place: the joiners (true throughputs
        ``speeds``, appended at indices ``m..m+j−1``) enter the allocation,
        B, slot plan, estimator, and simulated clock in one transition.
        ``c_init`` seeds the estimator for the joiners (calibration pass);
        without it they start at the mean retained estimate — the estimator
        never sees the true speeds."""
        speeds = np.asarray(speeds, dtype=np.float64)
        if speeds.ndim != 1 or speeds.size == 0:
            raise ValueError("add_workers needs a non-empty 1-D speed vector")
        if np.any(speeds <= 0):
            raise ValueError("true speeds must be positive")
        old_of_new = list(range(self.m)) + [None] * int(speeds.size)
        return self._transition(
            np.concatenate([self.true_speeds, speeds]), old_of_new, c_init
        )

    def remove_workers(self, ids: Sequence[int]) -> MembershipStats:
        """Shrink the worker set in place: drop ``ids`` (current indices),
        compact the survivors (relative order kept), remap the slot plan.
        Departed load lands on survivors/joiners per the movement bound."""
        drop = {int(i) for i in ids}
        if not drop:
            raise ValueError("remove_workers needs at least one worker id")
        if any(not 0 <= i < self.m for i in drop):
            raise ValueError(f"worker ids out of range [0, {self.m}): {sorted(drop)}")
        old_of_new: list[int | None] = [i for i in range(self.m) if i not in drop]
        if len(old_of_new) <= self.codec.s:
            raise ValueError(
                f"removing {len(drop)} workers leaves m={len(old_of_new)} <= s={self.codec.s}"
            )
        return self._transition(self.true_speeds[old_of_new], old_of_new, None)

    def _transition(
        self,
        true_speeds_new: np.ndarray,
        old_of_new: list[int | None],
        c_init_new: Sequence[float] | None,
    ) -> MembershipStats:
        # the transition is atomic: any feasibility veto — the engine's
        # device budget here, or a remap error (e.g. a user skew cap that
        # cannot fit the shrunk worker set) below — must not leave the
        # estimator resized against an unchanged codec
        if self.pre_transition is not None:
            self.pre_transition(len(old_of_new))
        est_snapshot = self.estimator.state_dict()
        self.estimator.resize(old_of_new, c_init_new)
        try:
            stats = self.codec.remap_members(self.estimator.normalized(), old_of_new)
        except Exception:
            self.estimator.load_state_dict(est_snapshot)
            raise
        self.true_speeds = np.asarray(true_speeds_new, dtype=np.float64)
        self.sim.set_speeds(self.true_speeds)
        # keep the fault layer's current->original identity map live (fault
        # schedules follow physical nodes across membership transitions)
        on_mem = getattr(self.sim, "on_membership", None)
        if on_mem is not None:
            on_mem(old_of_new)
        # the transition re-ran allocation against the current estimate:
        # that IS an applied rebalance for hysteresis purposes
        self.estimator.mark_applied()
        if self.on_transition is not None:
            self.on_transition(old_of_new)
        tr = self.tracer
        if tr.enabled:
            tr.instant("elastic.membership", **dataclasses.asdict(stats))
        return stats

    def apply_churn(self, step: int) -> MembershipStats | None:
        """Auto path: drain the ClusterSim's simulated join/leave events for
        ``step`` and apply them in order.  Returns the LAST transition's
        stats (None when the step had no events).  Idempotent per step — a
        skipped iteration re-asks about the same ``step`` and gets None.

        The whole step's event list is validated BEFORE anything mutates:
        an invalid schedule (e.g. a leave that would drop m below s+1) must
        raise with the cluster untouched, not half-transitioned — and must
        not be swallowed as already-drained on a retry."""
        if step <= self._churn_drained:
            return None
        events = self.sim.membership_events(step)
        m_sim = self.m
        for ev in events:
            if ev.leave:
                drop = {int(i) for i in ev.leave}
                if len(drop) != len(ev.leave) or any(not 0 <= i < m_sim for i in drop):
                    raise ValueError(f"step {step}: invalid leave ids {ev.leave} at m={m_sim}")
                m_sim -= len(drop)
                if m_sim <= self.codec.s:
                    raise ValueError(
                        f"step {step}: leave {ev.leave} would drop m to {m_sim} <= s={self.codec.s}"
                    )
            if ev.join_speeds:
                if any(s <= 0 for s in ev.join_speeds):
                    raise ValueError(f"step {step}: join speeds must be positive: {ev.join_speeds}")
                if ev.join_c_init is not None and len(ev.join_c_init) != len(ev.join_speeds):
                    raise ValueError(
                        f"step {step}: join_c_init has {len(ev.join_c_init)} entries "
                        f"for {len(ev.join_speeds)} joining workers"
                    )
            m_sim += len(ev.join_speeds)
            # device feasibility joins the pre-validation: a schedule the
            # engine cannot host must raise with the cluster untouched
            if self.pre_transition is not None:
                if ev.leave:
                    self.pre_transition(m_sim - len(ev.join_speeds))
                if ev.join_speeds:
                    self.pre_transition(m_sim)
        self._churn_drained = step
        stats: MembershipStats | None = None
        for ev in events:
            if ev.leave:
                stats = self.remove_workers(ev.leave)
            if ev.join_speeds:
                stats = self.add_workers(ev.join_speeds, ev.join_c_init)
        return stats

    # -- checkpoint state ---------------------------------------------------

    def state_dict(self) -> dict:
        # membership_epoch lives in the code's state (restored via the
        # codec) — one source of truth, nothing to duplicate here
        return {
            "estimator": self.estimator.state_dict(),
            "true_speeds": [float(x) for x in self.true_speeds],
            "churn_drained": int(self._churn_drained),
        }

    def load_state_dict(self, state: dict) -> None:
        self.estimator.load_state_dict(state["estimator"])
        if "true_speeds" in state:
            self.true_speeds = np.asarray(state["true_speeds"], dtype=np.float64)
            self.sim.set_speeds(self.true_speeds)
        self._churn_drained = int(state.get("churn_drained", -1))
