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

Not ported yet: the fault supervisor and fault schedules, straggler
forensics, tracing, and checkpoint state (ROADMAP Queue 1).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.approx.deadline import DeadlinePolicy
from repro_torch.configs.base import CodingConfig, TrainConfig
from repro_torch.core.codec import Codec
from repro_torch.core.decoding import DecodeOutcome
from repro_torch.core.simulator import ChurnSchedule
from repro_torch.core.straggler import NoStragglers, StragglerModel, StragglerProfile
from repro_torch.train.elastic import ElasticController
from repro_torch.train.engine import StepEngine, TrainerState
from repro_torch.train.prefetch import DevicePrefetcher

__all__ = ["CodedTrainer", "TrainerState"]

_SKIP_METRICS = {"loss": float("nan"), "grad_norm": float("nan"), "lr": float("nan")}


class CodedTrainer:
    """Coded data-parallel trainer over ``m`` logical workers on one device.

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
        device: torch.device | str = "cuda",
    ):
        self.model = model
        self.coding = coding
        self.m = m
        self.part_mb = part_mb
        self.straggler_model = straggler_model or NoStragglers()
        self._rng = np.random.default_rng(rng)
        self._steps_taken = 0
        self._exact_steps = 0

        self.codec = Codec.from_config(coding, m=m, c_init=c_init, rng=rng + 1)
        self.engine = StepEngine(
            model, train, self.codec, backend=backend, device=device,
            compress=coding.compress, wire_kernel=coding.wire_kernel,
        )
        self.elastic = ElasticController(
            self.codec, true_speeds=true_speeds, comm_time=comm_time, c_init=c_init,
            policy=deadline_policy, churn=churn,
        )
        self.elastic.pre_transition = self.engine.check_membership
        self.elastic.on_transition = self.engine.note_membership

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
        ``data`` is any ``batch(step) -> partition-major dict`` source."""
        metrics: dict[str, float] = {}
        for step, batch in DevicePrefetcher(data, start, steps, device=self.engine.device):
            state, metrics = self.step(state, batch)
            if on_step is not None:
                on_step(step, state, metrics)
        return state, metrics

    def _exact_fraction(self) -> float:
        return self._exact_steps / max(self._steps_taken, 1)

    def _guarded_step(
        self, state: TrainerState, partition_batch: dict, outcome: DecodeOutcome
    ) -> tuple[TrainerState, dict[str, float]]:
        """``engine.step`` behind the non-finite payload guard: the engine
        already left params/opt untouched when the decoded gradient went
        non-finite; here the step counter stays put and the step is
        reported as ``skipped_nonfinite``."""
        new_state, metrics = self.engine.step(state, partition_batch, outcome)
        if np.isfinite(metrics["grad_norm"]):
            return new_state, {**metrics, "skipped_nonfinite": 0.0}
        self.engine.reset_error_feedback()
        return (
            TrainerState(new_state.params, new_state.opt, state.step),
            {**_SKIP_METRICS, "skipped_nonfinite": 1.0},
        )

    def step(
        self, state: TrainerState, partition_batch: dict,
        profile: StragglerProfile | None = None,
    ) -> tuple[TrainerState, dict[str, float]]:
        """One arrival-driven BSP step.  Scheduled join/leave events for this
        step are applied first."""
        churn_stats = None
        if self.elastic.sim.membership_events(state.step):
            churn_stats = self.elastic.apply_churn(state.step)
            if churn_stats is not None:
                self.m = self.elastic.m
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
                f"but the worker set is m={self.m}"
            )

        # --- timing model + decode resolution (what the paper measures) ---
        tick = self.elastic.tick(profile)
        outcome = tick.outcome
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
            return state, {
                **_SKIP_METRICS, "skipped": 1.0, **base, "n_used": 0.0,
                "skipped_nonfinite": 0.0,
                "exact_fraction": self._exact_fraction(),
            }

        new_state, metrics = self._guarded_step(state, partition_batch, outcome)

        # --- throughput estimation + elastic re-encode ---
        self.elastic.observe(tick)
        out = {
            **metrics, **base,
            "n_used": float(tick.n_used),
            "skipped": float(metrics.get("skipped_nonfinite", 0.0) > 0),
            "exact_fraction": self._exact_fraction(),
        }
        if self.elastic.maybe_rebalance(new_state.step, every=self.coding.rebalance_every):
            out["rebalanced"] = 1.0
        return new_state, out
