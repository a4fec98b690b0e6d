"""Worker-throughput estimation (paper §III-C: "c_i ... estimated by sampling").

Production behaviour at 1000+ nodes: chip SKUs are homogeneous but *observed*
per-worker step times drift (preemption, host jitter, failing links,
co-tenancy).  We keep an EWMA of partitions/second per worker and expose a
hysteresis test so the trainer only re-runs allocation + Alg. 1 (a
millisecond-scale host-side rebuild) when the estimate moved enough to
matter.  This is the elastic-re-encode hook.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ThroughputEstimator"]


@dataclasses.dataclass
class ThroughputEstimator:
    """EWMA estimate of per-worker throughput c_i (partitions/sec).

    Args:
      m: number of workers.
      alpha: EWMA smoothing factor (weight of the newest sample).
      rebalance_threshold: relative change in normalized c that triggers
        ``should_rebalance()``.
      init: optional prior throughputs (e.g. from a calibration pass).
    """

    m: int
    alpha: float = 0.2
    rebalance_threshold: float = 0.15
    init: np.ndarray | None = None

    def __post_init__(self) -> None:
        self.c = (
            np.asarray(self.init, dtype=np.float64).copy()
            if self.init is not None
            else np.ones(self.m, dtype=np.float64)
        )
        if self.c.shape != (self.m,):
            raise ValueError(f"init shape {self.c.shape} != ({self.m},)")
        self._last_applied = self.normalized()

    def update(self, step_times: np.ndarray, loads: np.ndarray) -> None:
        """Fold one iteration's observations in.

        Accepts both observation styles:

        - **full finish times** — ``step_times[i]`` seconds worker i took to
          report, ``loads[i]`` the (integer) partitions it computed;
        - **fractional completion, observed mid-iteration** — the deadline
          path steps before slow workers finish, so ``step_times`` may be a
          scalar (the deadline every worker was observed at) and ``loads``
          the *fractional* work completed by then (e.g. 2.0 of 5 partitions).

        Either way the sample is work/time in partitions/sec.  Workers with
        no signal — non-finite or non-positive time (full stragglers, inf
        faults) or zero completed work — keep their previous estimate.
        """
        step_times = np.broadcast_to(
            np.asarray(step_times, dtype=np.float64), (self.m,)
        )
        loads = np.asarray(loads, dtype=np.float64)
        valid = np.isfinite(step_times) & (step_times > 0) & np.isfinite(loads) & (loads > 0)
        sample = np.where(valid, loads / np.maximum(step_times, 1e-12), self.c)
        self.c = (1 - self.alpha) * self.c + self.alpha * sample

    def normalized(self) -> np.ndarray:
        """c scaled so the slowest worker has throughput ~1."""
        return self.c / max(self.c.min(), 1e-12)

    def should_rebalance(self) -> bool:
        """True when normalized estimates drifted past the hysteresis band."""
        cur = self.normalized()
        ref = self._last_applied
        rel = np.abs(cur - ref) / np.maximum(ref, 1e-12)
        return bool(rel.max() > self.rebalance_threshold)

    def mark_applied(self) -> None:
        """Call after re-running allocation with the current estimate."""
        self._last_applied = self.normalized()

    def resize(self, old_of_new, init_new=None) -> None:
        """Membership change: keep retained workers' EWMA state, seed the
        joiners.  ``old_of_new[i]`` is new worker i's old index (None =
        joined); ``init_new`` is an optional per-joiner calibration prior —
        without one a joiner starts at the mean retained estimate (the
        least-surprising guess; its first observations correct it fast at
        this EWMA alpha)."""
        m_new = len(old_of_new)
        retained = [o for o in old_of_new if o is not None]
        n_join = sum(1 for o in old_of_new if o is None)
        default = float(np.mean(self.c[retained])) if retained else 1.0
        if init_new is not None:
            init_new = np.asarray(init_new, dtype=np.float64)
            if init_new.shape != (n_join,):
                raise ValueError(
                    f"init_new has {init_new.shape} entries for {n_join} joining workers"
                )
        fresh = iter(init_new if init_new is not None else np.full(n_join, default))
        c = np.empty(m_new, dtype=np.float64)
        last = np.empty(m_new, dtype=np.float64)
        for i, o in enumerate(old_of_new):
            if o is not None:
                c[i] = self.c[o]
                last[i] = self._last_applied[o]
            else:
                c[i] = next(fresh)
                last[i] = c[i]
        self.m = m_new
        self.c = c
        self._last_applied = last

    # -- checkpoint state ---------------------------------------------------

    def state_dict(self) -> dict:
        """JSON-able estimator state: the EWMA plus the hysteresis
        reference, so resumed runs keep the same rebalance decisions."""
        return {
            "c": [float(x) for x in self.c],
            "last_applied": [float(x) for x in self._last_applied],
        }

    def load_state_dict(self, state: dict) -> None:
        self.c = np.asarray(state["c"], dtype=np.float64)
        self._last_applied = np.asarray(state["last_applied"], dtype=np.float64)
        # the saved run may have crossed a membership transition: m follows c
        self.m = int(self.c.shape[0])
