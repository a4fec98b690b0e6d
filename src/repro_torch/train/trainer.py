"""BSP trainer with heterogeneity-aware coded gradient aggregation (the port
of ``src/repro/train/trainer.py``).

``CodedTrainer`` composes the three runtime seams:

  - :class:`~repro_torch.core.codec.Codec` — gradient code + shape-stable
    slot plan + decode;
  - :class:`~repro_torch.train.engine.StepEngine` — the step behind one of
    the ``reference`` / ``fused`` / ``spmd`` backends;
  - :class:`~repro_torch.train.elastic.ElasticController` — simulated
    cluster clock, EWMA throughput estimation, elastic re-encode policy.

Every step is arrival-driven: the controller's tick resolves the
iteration's per-partition arrival clocks through the stepping policy into
(τ, DecodeOutcome, observation), the engine steps with whatever decoded,
and the observation feeds the estimator.  With no explicit
``deadline_policy`` the controller runs ``DeadlinePolicy.exact()`` — the
paper's exact semantics.  ``metrics["sim_iter_time"]`` is the paper's
"avg time per iteration" from the simulated clock.

Resilience: a fault schedule (``faults=``) makes the controller's sim a
``FaultyClusterSim`` and a :class:`~repro_torch.resilience.FaultSupervisor`
closes the detect / quarantine-and-repair / evict / re-admit loop.
Observability: one tracer (``trace=``) threads through the trainer, the
engine, the controller, its policy and the prefetcher, and feeds a
:class:`~repro_torch.obs.straggler.StragglerForensics` ledger; off (the
default) it is the NULL singleton and the numerics are bit-equal either
way.  ``state_extras`` carries the control-plane state beyond (params,
opt) for a bit-exact resume.

Across processes (``group=``, a :class:`~repro_torch.launch.mesh.CodedGroup`),
one ``torch.distributed`` rank a coded worker: every rank of the world
builds the same trainer and runs the whole control plane in lockstep
(clocks, decode, supervisor, elastic transitions); the engine agrees each
step's decode vector and support mask from rank 0, the members encode and
decode, and rank 0's metrics reach every rank, so every rank takes the same
decisions.  A rank outside the current group skips the gradient and the
update and rejoins through the engine's re-place of rank 0's state.

The engine updates params and optimizer moments in place where the JAX
engine donates buffers.  A non-finite decoded gradient never reaches them
(``StepEngine._adamw`` skips the update), so a repair attempt starts from
the same params and moments as the poisoned attempt did.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.approx.deadline import DeadlinePolicy
from repro_torch.configs.base import CodingConfig, TrainConfig
from repro_torch.core.codec import Codec
from repro_torch.core.decoding import DecodeOutcome
from repro_torch.core.registry import MembershipStats
from repro_torch.core.simulator import ChurnSchedule, FaultSchedule
from repro_torch.core.straggler import NoStragglers, StragglerModel, StragglerProfile
from repro_torch.launch.mesh import CodedGroup
from repro_torch.obs.straggler import StragglerForensics
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.resilience.supervisor import FaultSupervisor
from repro_torch.train.elastic import ElasticController
from repro_torch.train.engine import StepEngine, TrainerState
from repro_torch.train.prefetch import DevicePrefetcher

__all__ = ["CodedTrainer", "TrainerState"]

_SKIP_METRICS = {"loss": float("nan"), "grad_norm": float("nan"), "lr": float("nan")}


class CodedTrainer:
    """Coded data-parallel trainer over ``m`` logical workers on one device,
    or one rank a worker across the processes of ``group``.

    ``true_speeds`` drive the timing simulation; the throughput *estimator*
    only sees observations.
    """

    def __init__(
        self,
        model,
        coding: CodingConfig,
        train: TrainConfig,
        *,
        m: int,
        part_mb: int,
        straggler_model: StragglerModel | None = None,
        true_speeds: np.ndarray | None = None,
        comm_time: float = 0.0,
        c_init: np.ndarray | None = None,
        rng: int = 0,
        backend: str = "fused",
        deadline_policy: DeadlinePolicy | None = None,
        churn: ChurnSchedule | None = None,
        trace: Tracer | None = None,
        faults: FaultSchedule | None = None,
        fault_seed: int = 0,
        supervisor: FaultSupervisor | None = None,
        device: torch.device | str = "cuda",
        group: CodedGroup | None = None,
    ):
        self.model = model
        self.coding = coding
        self.m = m
        self.part_mb = part_mb
        self.straggler_model = straggler_model or NoStragglers()
        self._rng = np.random.default_rng(rng)
        self._steps_taken = 0
        self._exact_steps = 0
        self._last_membership: MembershipStats | None = None

        self.codec = Codec.from_config(coding, m=m, c_init=c_init, rng=rng + 1)
        self.engine = StepEngine(
            model, train, self.codec, backend=backend, device=device,
            compress=coding.compress, wire_kernel=coding.wire_kernel, group=group,
        )
        # resilience: a fault schedule makes the controller's sim a
        # FaultyClusterSim; a supervisor closes the detect/evict loop.  Either
        # implies the other: a bare supervisor gets an empty schedule (payload
        # faults still convict), a bare schedule a default supervisor.
        if supervisor is not None and faults is None:
            faults = FaultSchedule(())
        if faults is not None and supervisor is None:
            supervisor = FaultSupervisor()
        self.supervisor = supervisor
        self.elastic = ElasticController(
            self.codec, true_speeds=true_speeds, comm_time=comm_time, c_init=c_init,
            policy=deadline_policy, churn=churn, faults=faults, fault_seed=fault_seed,
        )
        # every membership path (manual add/remove, scheduled churn, fault
        # eviction/readmission) funnels through the controller's transition,
        # so one pair of hooks keeps the engine's error-feedback rows
        self.elastic.pre_transition = self.engine.check_membership
        self.elastic.on_transition = self.engine.note_membership
        # observability: one tracer threaded through the whole stack
        self.tracer = trace if trace is not None else NULL_TRACER
        self.engine.tracer = self.tracer
        if hasattr(model, "tracer"):  # the model's device regions (models/lm.py)
            model.tracer = self.tracer
        self.elastic.tracer = self.tracer
        self.elastic.policy.tracer = self.tracer
        self._sim_now = 0.0  # accumulated simulated seconds (the sim clock)
        self.forensics = (
            StragglerForensics(m, self.elastic.true_speeds)
            if self.tracer.enabled else None
        )
        if self.supervisor is not None:
            self.supervisor.bind(
                self.elastic, tracer=self.tracer, forensics=self.forensics
            )

    # convenience views
    k = property(lambda self: self.codec.k)
    scheme = property(lambda self: self.codec.scheme)
    plan = property(lambda self: self.codec.plan)
    n_slots = property(lambda self: self.codec.n_slots)

    def init_state(self, seed: int) -> TrainerState:
        """Random weights from a generator on the engine's device."""
        gen = torch.Generator(device=self.engine.device).manual_seed(int(seed))
        return self.engine.init_state(gen)

    def run(
        self,
        state: TrainerState,
        data,
        steps: int,
        *,
        start: int = 0,
        on_step: Callable[[int, TrainerState, dict], None] | None = None,
    ) -> tuple[TrainerState, dict[str, float]]:
        """Training loop with double-buffered prefetch: batch t+1 is built
        and copied to the device on a worker thread while step t computes.
        ``data`` is any ``batch(step) -> partition-major dict`` source;
        ``on_step`` runs after every step (logging, checkpointing)."""
        metrics: dict[str, float] = {}
        for step, batch in DevicePrefetcher(data, start, steps, device=self.engine.device,
                                            trace=self.tracer):
            state, metrics = self.step(state, batch)
            if on_step is not None:
                on_step(step, state, metrics)
        return state, metrics

    def rebuild_scheme(self, c: np.ndarray) -> None:
        """Manual elastic re-encode (host-side, shape-stable)."""
        self.codec.rebalance(c)
        self.elastic.estimator.mark_applied()

    def _exact_fraction(self) -> float:
        return self._exact_steps / max(self._steps_taken, 1)

    def apply_membership(self, stats: MembershipStats) -> MembershipStats:
        """Record an in-place membership transition that the controller just
        applied: sync the trainer's worker count."""
        self.m = self.elastic.m
        self._last_membership = stats
        return stats

    def add_workers(self, speeds, c_init=None) -> MembershipStats:
        """Manual in-place grow: the controller transition + trainer sync."""
        return self.apply_membership(self.elastic.add_workers(speeds, c_init))

    def remove_workers(self, ids) -> MembershipStats:
        """Manual in-place shrink: the controller transition + trainer sync.
        The spmd engine carries the survivors' error-feedback rows."""
        return self.apply_membership(self.elastic.remove_workers(ids))

    # -- resilience: eviction drain + non-finite payload guard ---------------

    def _drain_fault_actions(self, step: int) -> None:
        """Apply the supervisor's pending membership repairs BEFORE the
        step: evict convicted workers through the elastic path (one
        ``Codec.version`` bump each), re-admit recovered hang victims under
        their original identity.  An infeasible eviction (m would reach s,
        a structural scheme rejects the shrunk m) leaves the worker masked
        and is retried with exponential backoff."""
        sup = self.supervisor
        sim = self.elastic.sim
        tr = self.tracer
        for orig in sup.eviction_queue(step):
            cur = sim.cur_index(orig)
            if cur is None:
                continue
            if self.m - 1 <= self.codec.s:
                sup.note_eviction_deferred(step, orig)
                continue  # stays masked; retry after backoff
            speed = float(self.elastic.true_speeds[cur])
            c_est = float(self.elastic.estimator.c[cur])
            try:
                self.remove_workers([cur])
            except ValueError:
                sup.note_eviction_deferred(step, orig)
                continue  # remap infeasible at m-1: stay masked
            sup.note_evicted(step, orig, speed, c_est)
            if tr.enabled:
                tr.instant("fault.evict", step=int(step), worker=int(orig),
                           m_after=int(self.m))
            if self.forensics is not None:
                self.forensics.on_eviction(step, orig)
                self.forensics.on_membership(
                    step, self.m, {"fault_evict": int(orig)},
                    self.elastic.true_speeds,
                )
        for orig, speed, c_est in sup.readmit_queue(step):
            sim.queue_join_orig(orig)
            try:
                self.add_workers([speed], c_init=[c_est])
            except ValueError:
                sim.cancel_queued_join(orig)  # leave it evicted
                continue
            sup.note_readmitted(step, orig)
            if tr.enabled:
                tr.instant("fault.readmit", step=int(step), worker=int(orig),
                           m_after=int(self.m))
            if self.forensics is not None:
                self.forensics.on_readmit(step, orig)
                self.forensics.on_membership(
                    step, self.m, {"fault_readmit": int(orig)},
                    self.elastic.true_speeds,
                )

    @staticmethod
    def _used_workers(dec: DecodeOutcome) -> list[int]:
        """CURRENT indices with a live decode coefficient (NaN counts: a
        poisoned coefficient IS a participating corrupt payload)."""
        a = np.asarray(dec.a, np.float64)
        return [w for w in range(a.shape[0]) if not abs(a[w]) <= 1e-12]

    @staticmethod
    def _poison_outcome(
        dec: DecodeOutcome, corrupt_cur: tuple[int, ...]
    ) -> DecodeOutcome:
        """Model corrupted coded payloads entering the decode: NaN the
        corrupt workers' decode coefficients, so every backend's decoded
        gradient goes non-finite exactly when a corrupt payload is actually
        *used* (a zero-coefficient worker never entered the sum).  On the
        spmd backend the NaN rides the decode vector into the decode kernel
        (``coded_reduce``, or the int8 decode's a·scale)."""
        a = np.asarray(dec.a, np.float64)
        hit = [w for w in corrupt_cur if w < a.shape[0] and abs(a[w]) > 1e-12]
        if not hit:
            return dec
        a = a.copy()
        a[hit] = np.nan
        return dataclasses.replace(dec, a=a)

    def _degraded_outcome(
        self, tick, quarantined: set[int]
    ) -> DecodeOutcome | None:
        """Re-decode the step excluding the quarantined workers (the repair
        rung of the degradation ladder).  None when nothing decodable
        remains under the current policy."""
        oc = tick.outcome
        if oc.support is not None:
            sup_mask = np.array(oc.support, dtype=oc.support.dtype, copy=True)
            sup_mask[sorted(quarantined), :] = 0
            deg = self.codec.decode_partial(sup_mask)
        else:
            finish = tick.ptimes.finish
            tau = float(tick.T)
            avail = [
                w for w in range(finish.shape[0])
                if w not in quarantined
                and np.isfinite(finish[w]) and finish[w] <= tau + 1e-12
            ]
            if not avail:
                return None
            deg = self.codec.decode_outcome(avail)
        if deg.n_used == 0:
            return None
        if not deg.exact and not self.elastic.policy.step_inexact:
            return None
        return deg

    def _guarded_step(
        self,
        state: TrainerState,
        partition_batch: dict,
        tick,
        outcome: DecodeOutcome,
        corrupt_cur: tuple[int, ...],
    ) -> tuple[TrainerState, dict[str, float]]:
        """``engine.step`` behind the non-finite payload guard.

        The engine already left params/opt untouched when the decoded
        gradient went non-finite; every roll-back below keeps the step
        counter un-bumped.  With a supervisor, up to ``max_repairs``
        re-decodes excluding the most suspect participant are attempted
        (quarantine → repair); otherwise (or when repair fails) the step is
        skipped and reported via ``skipped_nonfinite``."""
        tr = self.tracer
        sup = self.supervisor
        dec = self._poison_outcome(outcome, corrupt_cur)
        new_state, metrics = self.engine.step(state, partition_batch, dec)
        if np.isfinite(metrics["grad_norm"]):
            if sup is not None:
                sup.on_clean(self._used_workers(dec))
            return new_state, {**metrics, "skipped_nonfinite": 0.0}
        # --- non-finite decode: quarantine-and-repair, else skip ---
        step = state.step
        self.engine.reset_error_feedback()  # a corrupt sum pollutes residuals
        if tr.enabled:
            tr.instant("guard.nonfinite", step=int(step))
        if self.forensics is not None:
            self.forensics.on_nonfinite(step)
        used = self._used_workers(dec)
        if sup is not None:
            sup.on_nonfinite(step, used)
            quarantined: set[int] = set()
            for _ in range(sup.max_repairs):
                cands = sup.repair_candidates(used, exclude_cur=quarantined)
                if not cands:
                    break
                quarantined.add(cands[0])
                sup.on_quarantine(step, cands[0])
                deg = self._degraded_outcome(tick, quarantined)
                if deg is None:
                    break
                deg = self._poison_outcome(
                    deg, tuple(w for w in corrupt_cur if w not in quarantined)
                )
                rolled = TrainerState(new_state.params, new_state.opt, step)
                new_state, metrics = self.engine.step(rolled, partition_batch, deg)
                if np.isfinite(metrics["grad_norm"]):
                    sup.on_repair_success(step, cands[0])
                    sup.on_clean(self._used_workers(deg))
                    return new_state, {
                        **metrics, "skipped_nonfinite": 0.0, "repaired": 1.0,
                    }
                self.engine.reset_error_feedback()
        return (
            TrainerState(new_state.params, new_state.opt, step),
            {**_SKIP_METRICS, "skipped_nonfinite": 1.0},
        )

    def step(
        self, state: TrainerState, partition_batch: dict,
        profile: StragglerProfile | None = None,
    ) -> tuple[TrainerState, dict[str, float]]:
        """One arrival-driven BSP step.  Pending fault repairs and scheduled
        join/leave events for this step are applied FIRST, so the new worker
        set's clocks, decode, and gradients all see the transition."""
        tr = self.tracer
        traced = tr.enabled  # ONE attribute check when tracing is off
        t_step0 = tr.clock() if traced else 0.0
        sup = self.supervisor
        if sup is not None:
            # the fault layer perturbs clocks per training step; pending
            # convictions are repaired (evict/re-admit) before the step
            self.elastic.sim.begin_step(state.step)
            self._drain_fault_actions(state.step)
        churn_stats = None
        if self.elastic.sim.membership_events(state.step):
            churn_stats = self.elastic.apply_churn(state.step)
            if churn_stats is not None:
                self.apply_membership(churn_stats)
                if traced:
                    payload = dataclasses.asdict(churn_stats)
                    tr.instant("churn", t=self._sim_now, clock="sim",
                               step=int(state.step), **payload)
                    if self.forensics is not None:
                        self.forensics.on_membership(
                            state.step, self.m, payload, self.elastic.true_speeds
                        )
        # the batch must match the LIVE partition count: structural schemes
        # (k = m) change k on churn
        batch_k = int(next(iter(partition_batch.values())).shape[0])
        if batch_k != self.k:
            raise ValueError(
                f"partition batch has {batch_k} partitions but the codec "
                f"expects k={self.k} (a membership change on a structural "
                "scheme resizes k — rebuild batches after churn)"
            )
        if profile is None:
            profile = self.straggler_model.sample(self.m, self._rng)
        elif profile.slowdown.shape[0] != self.m:
            raise ValueError(
                f"straggler profile sized for {profile.slowdown.shape[0]} workers, "
                f"but the worker set is m={self.m} (churn applies before the "
                "profile — resample explicit profiles after membership changes)"
            )

        # --- timing model + decode resolution (what the paper measures) ---
        t0 = tr.clock() if traced else 0.0
        tick = self.elastic.tick(profile)
        if traced:
            tr.span_at("step.resolve", t0, tr.clock(), clock="wall",
                       step=int(state.step))
            loads_now = self.elastic.codec.code.worker_load().astype(np.float64)
        outcome = tick.outcome
        corrupt_cur: tuple[int, ...] = ()
        if sup is not None:
            sim = self.elastic.sim
            if traced:
                for f in sim.last_faults:
                    tr.instant("fault.inject", step=int(state.step), **f)
            if self.forensics is not None:
                for f in sim.last_faults:
                    self.forensics.on_fault(state.step, int(f["orig"]), f["kind"])
            sup.observe_timing(
                state.step, tick,
                self.elastic.codec.code.worker_load().astype(np.float64),
            )
            corrupt_cur = tuple(sorted(sim.corrupted_now()))
        self._steps_taken += 1
        self._exact_steps += int(outcome.exact)

        base = {
            "sim_iter_time": tick.T,
            "n_stragglers": float(len(profile.straggler_set())),
            "decode_residual": outcome.residual,
            "exact": float(outcome.exact),
            "membership_epoch": float(self.elastic.membership_epoch),
        }
        if np.isfinite(tick.deadline):
            base["deadline"] = tick.deadline
        if churn_stats is not None:
            base["m"] = float(self.m)
            base["moved_partitions"] = float(churn_stats.moved)

        step_it = outcome.n_used > 0 and (
            outcome.exact or self.elastic.policy.step_inexact
        )
        if not step_it:
            # nothing decodable to step on: skip the update; the clock is
            # paid and whatever observations the mode allows still count
            self.elastic.observe(tick)
            out = {
                **_SKIP_METRICS, "skipped": 1.0, **base, "n_used": 0.0,
                "skipped_nonfinite": 0.0,
                "exact_fraction": self._exact_fraction(),
            }
            if traced:
                self._record_step(state.step, tick, loads_now, out, t_step0)
            return state, out

        new_state, metrics = self._guarded_step(
            state, partition_batch, tick, outcome, corrupt_cur
        )

        # --- throughput estimation + elastic re-encode ---
        t0 = tr.clock() if traced else 0.0
        self.elastic.observe(tick)
        if traced:
            tr.span_at("step.observe", t0, tr.clock(), clock="wall",
                       step=int(state.step))
        out = {
            **metrics, **base,
            "n_used": float(tick.n_used),
            "skipped": float(metrics.get("skipped_nonfinite", 0.0) > 0),
            "exact_fraction": self._exact_fraction(),
        }
        if self.elastic.maybe_rebalance(new_state.step, every=self.coding.rebalance_every):
            out["rebalanced"] = 1.0
        if traced:
            self._record_step(state.step, tick, loads_now, out, t_step0)
        return new_state, out

    def _record_step(
        self, step: int, tick, loads: np.ndarray, out: dict[str, float],
        t_wall0: float,
    ) -> None:
        """Tracing-only per-step emission: the sim-clock iteration window +
        per-worker arrival instants, the forensics ledger update, and one
        ``train.step`` event-log record with stable keys.  Never called
        when tracing is off."""
        tr = self.tracer
        T = tick.T
        base_t = self._sim_now
        skipped = bool(out["skipped"])
        if np.isfinite(T):
            tr.span_at(
                "sim.iteration", base_t, base_t + T, clock="sim", step=int(step),
                exact=bool(tick.outcome.exact), skipped=skipped,
                residual=float(tick.outcome.residual), n_used=int(tick.n_used),
            )
            if np.isfinite(tick.deadline):
                tr.instant("sim.deadline", t=base_t + tick.deadline, clock="sim",
                           step=int(step), deadline=float(tick.deadline))
            finish = tick.ptimes.finish
            for w in range(finish.shape[0]):
                f = float(finish[w])
                if loads[w] > 0 and np.isfinite(f):
                    late = f > T + 1e-12
                    # late arrivals are clipped to the step's end: the work
                    # landed after τ and was discarded (worker track = tid w+1)
                    tr.instant(
                        "arrive.late" if late else "arrive",
                        t=base_t + min(f, T), clock="sim", tid=w + 1,
                        worker=w, finish=f, step=int(step),
                    )
            if not tick.outcome.exact:
                tr.instant("decode.inexact", t=base_t + T, clock="sim",
                           step=int(step), residual=float(tick.outcome.residual),
                           n_used=int(tick.n_used))
            if out.get("rebalanced"):
                tr.instant("rebalance", t=base_t + T, clock="sim", step=int(step))
            self._sim_now += T
        else:
            tr.instant("sim.skip", t=base_t, clock="sim", step=int(step))

        if self.forensics is not None:
            self.forensics.observe_step(
                step, tau=float(T), deadline=float(tick.deadline),
                exact=bool(tick.outcome.exact), skipped=skipped,
                finish=tick.ptimes.finish, load=loads,
                c_est=self.elastic.estimator.c, c_true=self.elastic.true_speeds,
            )
            if out.get("rebalanced"):
                self.forensics.on_rebalance(step, self.elastic.estimator.normalized())

        tr.event(
            "train.step",
            step=int(step), tau=float(T), deadline=float(tick.deadline),
            exact=bool(tick.outcome.exact), skipped=skipped,
            residual=float(tick.outcome.residual), n_used=float(out["n_used"]),
            loss=float(out["loss"]), grad_norm=float(out["grad_norm"]),
            lr=float(out["lr"]), sim_iter_time=float(out["sim_iter_time"]),
            n_stragglers=float(out["n_stragglers"]),
            exact_fraction=float(out["exact_fraction"]),
            rebalanced=float(out.get("rebalanced", 0.0)), m=float(self.m),
            skipped_nonfinite=float(out.get("skipped_nonfinite", 0.0)),
            repaired=float(out.get("repaired", 0.0)),
            finish=np.asarray(tick.ptimes.finish, np.float64).tolist(),
            load=loads.tolist(),
            c_est=np.asarray(self.elastic.estimator.c, np.float64).tolist(),
            c_true=np.asarray(self.elastic.true_speeds, np.float64).tolist(),
        )
        tr.span_at("step", t_wall0, tr.clock(), clock="wall", step=int(step),
                   skipped=skipped)

    # -- checkpoint extras ---------------------------------------------------

    def state_extras(self) -> dict:
        """JSON-able control-plane state beyond (params, opt): straggler
        RNG, step counters, throughput-estimator state, the codec's
        construction state, the engine's wire state and the resilience
        state.  Restoring it makes train-N-straight and
        train-k/save/load/train-(N−k) bit-identical."""
        return {
            "steps_taken": self._steps_taken,
            "exact_steps": self._exact_steps,
            "trainer_rng_state": copy.deepcopy(self._rng.bit_generator.state),
            "elastic": self.elastic.state_dict(),
            "codec": self.codec.state_dict(),
            # wire-path state (spmd int8 error feedback; {} elsewhere)
            "engine": self.engine.state_dict(),
            # the sim clock is observability-only (trace timeline offsets)
            "sim_now": float(self._sim_now),
            **(
                {
                    "resilience": {
                        "supervisor": self.supervisor.state_dict(),
                        "sim": self.elastic.sim.state_dict(),
                    }
                }
                if self.supervisor is not None else {}
            ),
        }

    def load_state_extras(self, extras: dict) -> None:
        self._steps_taken = int(extras["steps_taken"])
        self._exact_steps = int(extras["exact_steps"])
        self._rng.bit_generator.state = extras["trainer_rng_state"]
        # codec FIRST: the elastic state (true speeds, estimator width) must
        # land on the already-resized worker set
        self.codec.load_state_dict(extras["codec"])
        self.elastic.load_state_dict(extras["elastic"])
        self.m = self.codec.m
        # engine AFTER codec: the error-feedback rows belong to the
        # restored worker set and codec version
        self.engine.load_state_dict(extras.get("engine") or {})
        self._sim_now = float(extras.get("sim_now", 0.0))
        # resilience AFTER elastic: the fault sim's identity map must land
        # on the already-resized worker set
        res = extras.get("resilience")
        if res is not None and self.supervisor is not None:
            self.supervisor.load_state_dict(res["supervisor"])
            self.elastic.sim.load_state_dict(res["sim"])
