"""Discrete-event timing model of a heterogeneous BSP cluster (paper §VI).

The container has one CPU and the target is a TPU pod, so the *timing* claims
of the paper (Figs. 2/3/5, the 3x speedup, Thm. 5 optimality) are validated
with an event simulator that models exactly what the paper measures:

  per-iteration worker finish time  f_i = n_i / (c_i / slowdown_i) + delay_i + comm
  iteration time                    T   = earliest decodable moment (Eq. 3)
  resource usage (Fig. 5)           Σ useful compute / Σ wall-clock occupancy

The gradient *math* (that decoding recovers the exact gradient) is validated
separately on real JAX arrays in core/aggregator.py — the simulator only
concerns itself with clocks.
"""

from __future__ import annotations

import dataclasses
import heapq
from functools import cached_property
from typing import Iterator, Protocol, Sequence

import numpy as np

from repro_torch.core.coding import CodingScheme
from repro_torch.core.decoding import DecodeError, Decoder
from repro_torch.core.straggler import StragglerModel, StragglerProfile
from repro_torch.obs.stats import pct

__all__ = [
    "ArrivalEvent",
    "ArrivalStream",
    "ChurnSchedule",
    "FaultEvent",
    "FaultSchedule",
    "FaultyClusterSim",
    "IterationResult",
    "MembershipEvent",
    "PartitionTimes",
    "RunResult",
    "ClusterSim",
    "mask_workers",
    "theoretical_optimal_time",
]

FAULT_KINDS = ("crash", "hang", "flaky", "corrupt")


@dataclasses.dataclass(frozen=True)
class ArrivalEvent:
    """One completion event in an iteration's arrival stream (DESIGN.md §7).

    Attributes:
      t: arrival instant (seconds into the iteration).
      worker: reporting worker.
      partition: the partition whose coded contribution just arrived, or
        ``None`` for a whole-worker completion marker (emitted after the
        worker's last partition — the event all-or-nothing decode consumes).
    """

    t: float
    worker: int
    partition: int | None


class ArrivalStream(Protocol):
    """Ordered iterator of completion events — what the arrival-driven
    control plane consumes instead of a dense finish vector.  Events are
    emitted in nondecreasing ``t``; consumers may stop early (the earliest
    decodable moment usually arrives long before the stream ends)."""

    def __iter__(self) -> Iterator[ArrivalEvent]: ...


@dataclasses.dataclass(frozen=True)
class MembershipEvent:
    """One simulated cluster-membership change (DESIGN.md §8).

    Attributes:
      step: training step the event fires at (applied before the step's
        arrival clocks are sampled, so the new worker set participates
        immediately).
      join_speeds: true throughputs of workers joining (appended at indices
        ``m..m+j−1``).
      leave: CURRENT worker indices departing (indices as of this event,
        after all earlier events' compactions).
      join_c_init: optional calibration estimates for the joiners (the
        estimator must not see the true speeds).
    """

    step: int
    join_speeds: tuple[float, ...] = ()
    leave: tuple[int, ...] = ()
    join_c_init: tuple[float, ...] | None = None


class ChurnSchedule:
    """Ordered join/leave events, indexed by training step — the simulated
    counterpart of a cluster manager's membership feed.  The controller
    drains ``at(step)`` each iteration; steps without events are free."""

    def __init__(self, events: Sequence[MembershipEvent] = ()):
        self._by_step: dict[int, list[MembershipEvent]] = {}
        for ev in sorted(events, key=lambda e: e.step):
            self._by_step.setdefault(ev.step, []).append(ev)

    def at(self, step: int) -> tuple[MembershipEvent, ...]:
        return tuple(self._by_step.get(step, ()))

    def __len__(self) -> int:
        return sum(len(v) for v in self._by_step.values())


def theoretical_optimal_time(k: int, s: int, c: np.ndarray) -> float:
    """Thm. 5 lower bound: T(B*) = (s+1)k / Σc_i (accurate estimates)."""
    return (s + 1) * k / float(np.sum(c))


@dataclasses.dataclass(frozen=True)
class IterationResult:
    T: float  # iteration wall-clock (inf if undecodable)
    finish: np.ndarray  # (m,) per-worker result-arrival times
    used: tuple[int, ...]  # workers whose coded gradients entered the decode
    useful_compute: float  # Σ compute seconds that contributed to the decode
    busy_compute: float  # Σ compute seconds spent (incl. wasted straggler work)


@dataclasses.dataclass(frozen=True)
class PartitionTimes:
    """Per-partition result-arrival clocks for one iteration.

    Workers compute their allocated partitions *sequentially* (allocation
    order) and upload each result as it completes, so partial work observed
    at a deadline τ has an honest clock: worker w's t-th partition arrives at
    ``extra_delay + (t+1)/rate + comm`` — the last one at exactly the
    whole-worker ``finish`` time the exact path uses (consistency is tested).

    Attributes:
      times: per worker, (n_w,) arrival time of each slot (empty if no load).
      partitions: per worker, the partition ids in completion order.
      finish: (m,) whole-worker finish times — identical to
        :meth:`ClusterSim.iteration`'s ``finish``.
      m, k: sizes.
    """

    times: tuple[np.ndarray, ...]
    partitions: tuple[tuple[int, ...], ...]
    finish: np.ndarray
    m: int
    k: int

    @cached_property
    def _flat(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(workers, pids, times) of every per-partition arrival, one flat
        vectorized view — support/work queries become single scatters."""
        counts = np.array([t.size for t in self.times], dtype=np.int64)
        workers = np.repeat(np.arange(self.m, dtype=np.int64), counts)
        if counts.sum():
            pids = np.concatenate(
                [np.asarray(p, dtype=np.int64) for p, n in zip(self.partitions, counts) if n]
            )
            times = np.concatenate([t for t in self.times if t.size])
        else:
            pids = np.empty(0, dtype=np.int64)
            times = np.empty(0, dtype=np.float64)
        return workers, pids, times

    def support_at(self, tau: float) -> np.ndarray:
        """(m, k) effective-B completion mask: 1 where worker w's partition j
        result has arrived by τ.  Feeds ``decode_partial``."""
        workers, pids, times = self._flat
        sup = np.zeros((self.m, self.k), dtype=np.float64)
        # isfinite guard: a dead worker's arrivals are inf and must not count
        # as done even at tau=inf (the exact-mode "no deadline" resolve)
        done = np.isfinite(times) & (times <= tau)
        sup[workers[done], pids[done]] = 1.0
        return sup

    def work_done_at(self, tau: float) -> np.ndarray:
        """(m,) partitions completed by τ per worker — the fractional-work
        observation the throughput estimator folds in mid-iteration."""
        workers, _, times = self._flat
        done = np.isfinite(times) & (times <= tau)
        return np.bincount(workers, weights=done.astype(np.float64), minlength=self.m)

    def event_times(self, deadline: float) -> np.ndarray:
        """Sorted unique arrival times ≤ deadline — the only instants where
        the decodable information set changes."""
        all_t = self._flat[2]
        finite = all_t[np.isfinite(all_t)]
        return np.unique(finite[finite <= deadline])

    def stream(self, deadline: float = np.inf) -> Iterator[ArrivalEvent]:
        """ArrivalStream view: per-partition completions in nondecreasing t
        (heap-merge of the per-worker sorted clocks — O(N log m), lazy), a
        ``partition=None`` whole-worker marker right after each worker's
        last arrival.  Events past ``deadline`` are never emitted."""
        heads = []
        for w, t in enumerate(self.times):
            if t.size and np.isfinite(t[0]) and t[0] <= deadline:
                heads.append((float(t[0]), w, 0))
        heapq.heapify(heads)
        while heads:
            t, w, i = heapq.heappop(heads)
            yield ArrivalEvent(t=t, worker=w, partition=int(self.partitions[w][i]))
            nxt = i + 1
            if nxt < self.times[w].size:
                tn = float(self.times[w][nxt])
                if np.isfinite(tn) and tn <= deadline:
                    heapq.heappush(heads, (tn, w, nxt))
                # a non-finite/late next arrival ends the worker's stream
                # without a completion marker — it never fully finished
            else:
                yield ArrivalEvent(t=t, worker=w, partition=None)

    def worker_stream(self, deadline: float = np.inf) -> Iterator[tuple[float, int]]:
        """(t, worker) whole-worker completion events in arrival order —
        the stream all-or-nothing decode paths consume."""
        for ev in self.stream(deadline):
            if ev.partition is None:
                yield ev.t, ev.worker


def mask_workers(ptimes: PartitionTimes, workers) -> PartitionTimes:
    """Erasure view of an iteration's clocks: treat ``workers``' uploads as
    never arriving (all clocks → ∞).  This is how a convicted worker is
    masked out of the decodable set (DESIGN.md §11) and how a dead serving
    replica is dropped from the answerable subset — every downstream
    consumer (support/work queries, streams, decode resolution) already
    guards on finiteness, so the erased worker simply stops existing as an
    information source."""
    drop = {int(w) for w in workers}
    if not drop:
        return ptimes
    if any(not 0 <= w < ptimes.m for w in drop):
        raise ValueError(f"mask ids out of range [0, {ptimes.m}): {sorted(drop)}")
    times = tuple(
        np.full_like(t, np.inf) if w in drop else t
        for w, t in enumerate(ptimes.times)
    )
    finish = ptimes.finish.copy()
    finish[sorted(drop)] = np.inf
    return dataclasses.replace(ptimes, times=times, finish=finish)


@dataclasses.dataclass(frozen=True)
class RunResult:
    mean_T: float
    p50_T: float
    p99_T: float
    resource_usage: float  # Fig. 5 metric: useful compute / total occupancy
    busy_usage: float
    failures: int  # iterations that could not decode
    iters: tuple[IterationResult, ...]


class ClusterSim:
    """Simulates BSP iterations of one coding scheme on one cluster.

    Args:
      scheme: the coding strategy — either a bare :class:`CodingScheme`
        (B + allocation + groups; a private ``Decoder`` is built) or a
        :class:`~repro_torch.core.registry.GradientCode` (its own decode fast
        path and LRU cache are shared, and an elastic ``rebalance()`` on
        the code is picked up in place — no sim rebuild needed).
      c: (m,) true worker throughputs in partitions/second.  The scheme may
        have been built from *estimated* throughputs — passing different
        true values is how estimation error (§V motivation) is modelled.
      comm_time: per-worker result upload time (seconds), added to compute.
      wait_for_all: naive BSP semantics — the iteration ends only when every
        worker reports (used by the `naive` baseline).
    """

    def __init__(
        self,
        scheme,
        c: np.ndarray,
        comm_time: float = 0.0,
        wait_for_all: bool = False,
        churn: "ChurnSchedule | None" = None,
    ):
        from repro_torch.core.registry import GradientCode

        if isinstance(scheme, GradientCode):
            self.code: GradientCode | None = scheme
            self.decoder = scheme  # same decode surface as Decoder
        else:
            self.code = None
            self._scheme = scheme
            self.decoder = Decoder(scheme)
        self.c = np.asarray(c, dtype=np.float64)
        if self.c.shape[0] != self.scheme.m:
            raise ValueError("throughput vector size != m")
        self.comm_time = comm_time
        self.wait_for_all = wait_for_all
        self.churn = churn

    def membership_events(self, step: int) -> tuple[MembershipEvent, ...]:
        """Simulated join/leave events firing at ``step`` (empty without a
        churn schedule) — the auto-path input the ElasticController drains
        each iteration (DESIGN.md §8)."""
        return self.churn.at(step) if self.churn is not None else ()

    def set_speeds(self, c: np.ndarray) -> None:
        """Replace the true-throughput vector after a membership change."""
        c = np.asarray(c, dtype=np.float64)
        if c.shape[0] != self.scheme.m:
            raise ValueError(f"speed vector size {c.shape[0]} != m={self.scheme.m}")
        self.c = c

    @property
    def scheme(self) -> CodingScheme:
        return self.code.scheme if self.code is not None else self._scheme

    @property
    def loads(self) -> np.ndarray:
        # recomputed per access: elastic rebalance moves load between workers
        return self.scheme.worker_load().astype(np.float64)

    def partition_times(self, profile: StragglerProfile) -> PartitionTimes:
        """Per-partition arrival clocks for one iteration — the honest-clock
        view deadline policies consume (whole-worker ``iteration()`` times
        are the last entries of each per-worker array)."""
        scheme = self.scheme
        loads = self.loads
        rate = self.c / profile.slowdown  # inf slowdown -> rate 0
        times: list[np.ndarray] = []
        finish = np.empty(scheme.m, dtype=np.float64)
        for w in range(scheme.m):
            n_w = int(loads[w])
            if n_w == 0:
                times.append(np.empty(0, dtype=np.float64))
                finish[w] = profile.extra_delay[w] + self.comm_time
                continue
            if rate[w] > 0:
                t = profile.extra_delay[w] + np.arange(1, n_w + 1) / rate[w] + self.comm_time
            else:
                t = np.full(n_w, np.inf)
            times.append(t)
            finish[w] = t[-1]
        return PartitionTimes(
            times=tuple(times),
            partitions=tuple(scheme.allocation.partitions),
            finish=finish,
            m=scheme.m,
            k=scheme.k,
        )

    def sample_partition_times(
        self, model: StragglerModel, rng: np.random.Generator | int = 0
    ) -> PartitionTimes:
        """One iteration's (or, in coded serving, one *request's*) arrival
        clocks under a freshly sampled straggler realization — the
        per-request replica-latency stream the serving engine consumes
        (DESIGN.md §9)."""
        rng = np.random.default_rng(rng) if not isinstance(rng, np.random.Generator) else rng
        return self.partition_times(model.sample(self.scheme.m, rng))

    def arrival_stream(
        self, profile: StragglerProfile, deadline: float = np.inf
    ) -> Iterator[ArrivalEvent]:
        """One iteration as an ordered completion-event stream (DESIGN.md
        §7): per-partition arrivals + whole-worker markers, lazily merged —
        the arrival-driven control plane's input, no dense finish vector."""
        return self.partition_times(profile).stream(deadline)

    def iteration(self, profile: StragglerProfile) -> IterationResult:
        loads = self.loads  # one worker_load() scan per iteration
        rate = self.c / profile.slowdown  # inf slowdown -> rate 0
        with np.errstate(divide="ignore", invalid="ignore"):
            compute = np.where(rate > 0, loads / np.maximum(rate, 1e-300), np.inf)
        compute = np.where(loads == 0, 0.0, compute)
        finish = compute + profile.extra_delay + self.comm_time
        return self._resolve_iteration(compute, finish)

    def _resolve_iteration(self, compute: np.ndarray, finish: np.ndarray) -> IterationResult:
        """Decode + usage accounting for one iteration's (compute, finish)
        row — the only per-iteration work the batched ``run`` keeps."""
        if self.wait_for_all:
            T = float(np.max(finish))
            used = tuple(range(self.scheme.m))
        else:
            try:
                T, used = self.decoder.earliest_decodable(finish)
            except DecodeError:
                T, used = np.inf, ()

        if np.isfinite(T):
            useful = float(sum(compute[list(used)])) if used else 0.0
            busy = float(np.sum(np.minimum(compute, T)[np.isfinite(compute)]))
        else:
            useful, busy = 0.0, float(np.sum(compute[np.isfinite(compute)]))
        return IterationResult(T=T, finish=finish, used=used, useful_compute=useful, busy_compute=busy)

    def finish_matrix(
        self, profiles: Sequence[StragglerProfile]
    ) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized per-worker clocks for a batch of straggler profiles:
        (n, m) compute seconds and finish times in ONE numpy pass — the
        whole-run statistics path no longer rebuilds them per iteration in
        Python.  Elementwise formulas are identical to :meth:`iteration`,
        so the batched run is bit-equal to the loop (pinned in
        tests/test_simulator.py)."""
        loads = self.loads
        if not len(profiles):
            empty = np.zeros((0, self.scheme.m), dtype=np.float64)
            return empty, empty
        slow = np.stack([p.slowdown for p in profiles])
        delay = np.stack([p.extra_delay for p in profiles])
        rate = self.c[None, :] / slow  # inf slowdown -> rate 0
        with np.errstate(divide="ignore", invalid="ignore"):
            compute = np.where(rate > 0, loads[None, :] / np.maximum(rate, 1e-300), np.inf)
        compute = np.where(loads[None, :] == 0, 0.0, compute)
        finish = compute + delay + self.comm_time
        return compute, finish

    def run(self, model: StragglerModel, n_iters: int, rng: np.random.Generator | int = 0) -> RunResult:
        rng = np.random.default_rng(rng) if not isinstance(rng, np.random.Generator) else rng
        m = self.scheme.m
        profiles = [model.sample(m, rng) for _ in range(n_iters)]
        compute, finish = self.finish_matrix(profiles)
        iters = [
            self._resolve_iteration(compute[i], finish[i]) for i in range(n_iters)
        ]
        Ts = np.array([it.T for it in iters])
        ok = np.isfinite(Ts)
        failures = int((~ok).sum())
        occupancy = float(self.scheme.m * Ts[ok].sum()) if ok.any() else 1.0
        useful = float(sum(it.useful_compute for it in iters if np.isfinite(it.T)))
        busy = float(sum(it.busy_compute for it in iters if np.isfinite(it.T)))
        if ok.any():
            mean_T, p50, p99 = float(Ts[ok].mean()), pct(Ts[ok], 50), pct(Ts[ok], 99)
        else:
            mean_T = p50 = p99 = np.inf
        return RunResult(
            mean_T=mean_T,
            p50_T=p50,
            p99_T=p99,
            resource_usage=useful / max(occupancy, 1e-12),
            busy_usage=busy / max(occupancy, 1e-12),
            failures=failures,
            iters=tuple(iters),
        )


# ---------------------------------------------------------------------------
# fault injection (DESIGN.md §11)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One injected failure on one worker (DESIGN.md §11 taxonomy).

    Attributes:
      kind: ``crash`` (finish → ∞ from ``step`` onward, permanent),
        ``hang`` (∞ for ``duration`` steps, then recovers), ``flaky``
        (each step in the window the upload is lost with prob ``prob``;
        retried up to ``retries`` times with exponential backoff — a step
        whose whole retry budget is lost arrives never), or ``corrupt``
        (clocks untouched; the coded payload is non-finite with prob
        ``prob`` per step in the window).
      worker: ORIGINAL worker id — the index at schedule-creation time.
        Membership transitions compact current indices, but a fault follows
        the physical node, so the schedule is keyed by original identity
        (:class:`FaultyClusterSim` maintains the mapping).
      step: onset training step.
      duration: window length in steps (hang/flaky/corrupt); ``None`` means
        open-ended (and is invalid for hang, which must end to recover).
      prob: per-upload loss probability (flaky) / per-step corruption
        probability (corrupt).
      retries: flaky only — bounded retry budget per step.
      backoff: flaky only — base retry delay in (simulated) seconds; the
        r-th retry waits ``backoff·2^(r−1)``, so a step that succeeded after
        f lost attempts lands ``backoff·(2^f − 1)`` late.
    """

    kind: str
    worker: int
    step: int
    duration: int | None = None
    prob: float = 1.0
    retries: int = 2
    backoff: float = 0.05

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; choose from {FAULT_KINDS}")
        if self.worker < 0 or self.step < 0:
            raise ValueError(f"fault worker/step must be >= 0: {self}")
        if self.kind == "hang" and (self.duration is None or self.duration <= 0):
            raise ValueError(f"hang needs a positive duration (it must end to recover): {self}")
        if self.duration is not None and self.duration <= 0:
            raise ValueError(f"fault duration must be positive: {self}")
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"fault prob must be in [0, 1]: {self}")
        if self.retries < 0 or self.backoff < 0:
            raise ValueError(f"fault retries/backoff must be >= 0: {self}")

    def active(self, step: int) -> bool:
        """Is the fault live at ``step``?  Crash never ends."""
        if step < self.step:
            return False
        if self.kind == "crash":
            return True
        return self.duration is None or step < self.step + self.duration


class FaultSchedule:
    """Ordered fault events keyed by ORIGINAL worker id — the injected
    counterpart of a fleet's failure log.  :class:`FaultyClusterSim` drains
    it per step; an empty schedule costs nothing."""

    def __init__(self, events: Sequence[FaultEvent] = ()):
        self.events = tuple(sorted(events, key=lambda e: (e.step, e.worker)))
        self._by_worker: dict[int, list[FaultEvent]] = {}
        for ev in self.events:
            self._by_worker.setdefault(ev.worker, []).append(ev)

    def __len__(self) -> int:
        return len(self.events)

    def for_worker(self, orig: int) -> tuple[FaultEvent, ...]:
        return tuple(self._by_worker.get(int(orig), ()))

    def crashed(self, orig: int, step: int) -> bool:
        return any(
            ev.kind == "crash" and step >= ev.step for ev in self.for_worker(orig)
        )

    def hang_recovered(self, orig: int, step: int) -> bool:
        """The worker hung, every hang window has ended by ``step``, and it
        is not (also) crashed — the external "node is back" signal a real
        cluster manager would deliver, which drives re-admission."""
        hangs = [ev for ev in self.for_worker(orig) if ev.kind == "hang"]
        if not hangs or self.crashed(orig, step):
            return False
        return all(step >= ev.step + ev.duration for ev in hangs)


class FaultyClusterSim(ClusterSim):
    """A :class:`ClusterSim` whose per-iteration clocks and payloads are
    perturbed by a :class:`FaultSchedule` (DESIGN.md §11).

    Timing faults (crash/hang/flaky) perturb :meth:`partition_times` — and
    therefore everything the arrival-driven control plane sees.  Corruption
    is a *payload* fault: clocks are untouched and the step's corrupted
    CURRENT worker indices are published via :meth:`corrupted_now` for the
    trainer to poison the decode with (the clock/math split mirrors the
    rest of the stack).  ``iteration()``/``run()`` keep the base-class
    fault-free clocks — the trainer path goes through ``partition_times``
    exclusively.

    Fault sampling is derived per ``(seed, step, original-worker)`` — not
    from a mutable stream — so a resumed run replays the identical fault
    realization (bit-exact recovery is property-tested).

    The schedule is keyed by original worker id; membership transitions
    call :meth:`on_membership` (the ElasticController does this in
    ``_transition``) to keep the current→original mapping live.  A
    re-admitted worker re-enters under its original id via
    :meth:`queue_join_orig`, so any remaining fault windows follow it.
    """

    def __init__(
        self,
        scheme,
        c: np.ndarray,
        comm_time: float = 0.0,
        wait_for_all: bool = False,
        churn: "ChurnSchedule | None" = None,
        schedule: FaultSchedule | None = None,
        seed: int = 0,
    ):
        super().__init__(scheme, c, comm_time=comm_time, wait_for_all=wait_for_all, churn=churn)
        self.schedule = schedule if schedule is not None else FaultSchedule(())
        self._seed = int(seed)
        self._step = 0
        self.orig_of_cur: list[int] = list(range(self.scheme.m))
        self._next_orig = self.scheme.m
        self._queued_origs: list[int] = []
        # per-step manifests, rebuilt by each partition_times call
        self.last_faults: list[dict] = []
        self.last_retries: dict[int, int] = {}  # cur idx -> lost uploads retried
        self._corrupt_now: frozenset[int] = frozenset()

    # -- identity plumbing ---------------------------------------------------

    def begin_step(self, step: int) -> None:
        """Install the training step the next ``partition_times`` perturbs
        for (the trainer calls this at the top of every step)."""
        self._step = int(step)

    def cur_index(self, orig: int) -> int | None:
        """Current index of an original worker id (None if evicted)."""
        try:
            return self.orig_of_cur.index(int(orig))
        except ValueError:
            return None

    def queue_join_orig(self, orig: int) -> None:
        """The next joining worker re-enters under this original id (the
        re-admission path) instead of being allocated a fresh identity."""
        self._queued_origs.append(int(orig))

    def cancel_queued_join(self, orig: int) -> bool:
        """Withdraw a queued re-admission identity (the join never happened
        — e.g. ``add_workers`` failed after ``queue_join_orig``).  Returns
        False when the id is no longer queued, which is NOT an error: a
        partially-applied transition may already have drained it."""
        try:
            self._queued_origs.remove(int(orig))
            return True
        except ValueError:
            return False

    def on_membership(self, old_of_new: Sequence[int | None]) -> None:
        """Track a membership transition: survivors keep their original id,
        joiners take a queued re-admission id or a fresh one."""
        new: list[int] = []
        for o in old_of_new:
            if o is not None:
                new.append(self.orig_of_cur[o])
            elif self._queued_origs:
                new.append(self._queued_origs.pop(0))
            else:
                new.append(self._next_orig)
                self._next_orig += 1
        self.orig_of_cur = new

    # -- perturbed clocks ----------------------------------------------------

    def _fault_rng(self, step: int, orig: int, salt: int) -> np.random.Generator:
        # keyed by (seed, step, worker, fault-kind): deterministic under
        # resume AND independent of membership/enumeration order
        return np.random.default_rng([self._seed, int(step), int(orig), salt])

    def corrupted_now(self) -> frozenset[int]:
        """CURRENT worker indices whose payload is corrupt this step (as of
        the last ``partition_times`` call)."""
        return self._corrupt_now

    def partition_times(self, profile: StragglerProfile) -> PartitionTimes:
        pt = super().partition_times(profile)
        self.last_faults = []
        self.last_retries = {}
        corrupt: set[int] = set()
        if not len(self.schedule):
            self._corrupt_now = frozenset()
            return pt
        step = self._step
        times = list(pt.times)
        finish = pt.finish.copy()
        touched = False
        for w, orig in enumerate(self.orig_of_cur):
            dead_kind: str | None = None
            delay = 0.0
            for ev in self.schedule.for_worker(orig):
                if not ev.active(step):
                    continue
                if ev.kind in ("crash", "hang"):
                    dead_kind = ev.kind if dead_kind != "crash" else dead_kind
                elif ev.kind == "flaky":
                    rng = self._fault_rng(step, orig, 2)
                    lost = 0
                    while lost <= ev.retries and rng.random() < ev.prob:
                        lost += 1
                    if lost > ev.retries:
                        dead_kind = dead_kind or "flaky"
                        self.last_retries[w] = ev.retries
                        self.last_faults.append(
                            {"worker": w, "orig": orig, "kind": "flaky",
                             "lost": lost, "recovered": False}
                        )
                    elif lost:
                        delay += ev.backoff * (2.0 ** lost - 1.0)
                        self.last_retries[w] = lost
                        self.last_faults.append(
                            {"worker": w, "orig": orig, "kind": "flaky",
                             "lost": lost, "recovered": True}
                        )
                elif ev.kind == "corrupt":
                    rng = self._fault_rng(step, orig, 3)
                    if rng.random() < ev.prob:
                        corrupt.add(w)
                        self.last_faults.append(
                            {"worker": w, "orig": orig, "kind": "corrupt"}
                        )
            if dead_kind in ("crash", "hang"):
                self.last_faults.append({"worker": w, "orig": orig, "kind": dead_kind})
            if dead_kind is not None:
                times[w] = np.full_like(times[w], np.inf)
                finish[w] = np.inf
                touched = True
            elif delay > 0.0:
                times[w] = times[w] + delay
                finish[w] = finish[w] + delay
                touched = True
        self._corrupt_now = frozenset(corrupt)
        if not touched:
            return pt
        return dataclasses.replace(pt, times=tuple(times), finish=finish)

    # -- checkpoint state ----------------------------------------------------

    def state_dict(self) -> dict:
        return {
            "step": int(self._step),
            "orig_of_cur": [int(o) for o in self.orig_of_cur],
            "next_orig": int(self._next_orig),
            "queued_origs": [int(o) for o in self._queued_origs],
        }

    def load_state_dict(self, state: dict) -> None:
        self._step = int(state.get("step", 0))
        self.orig_of_cur = [int(o) for o in state["orig_of_cur"]]
        self._next_orig = int(state["next_orig"])
        self._queued_origs = [int(o) for o in state.get("queued_origs", [])]
        if len(self.orig_of_cur) != self.scheme.m:
            raise ValueError(
                f"restored orig_of_cur has {len(self.orig_of_cur)} entries "
                f"for m={self.scheme.m} workers"
            )
