"""One shared streaming-summary type for every percentile in the repo
(DESIGN.md §10).

Before this module, p50/p99 aggregation was written three times —
``serve/metrics.py``'s ``_pct``, ``core/simulator.py``'s RunResult
summaries, and inline ``np.percentile`` calls in ``benchmarks/serving.py``.
All of them now route through :func:`pct` (identical NaN-on-empty
semantics, bit-equal outputs) and new consumers get :class:`Summary`, a
streaming accumulator with an optional bounded-memory reservoir.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Summary", "pct"]


def pct(xs, q: float) -> float:
    """``float(np.percentile(xs, q))`` with NaN on an empty input — the one
    percentile helper the repo's summaries share (dtype handling is exactly
    ``np.asarray``'s, so existing call sites stay bit-equal)."""
    arr = np.asarray(xs)
    if arr.size == 0:
        return float("nan")
    return float(np.percentile(arr, q))


class Summary:
    """Streaming scalar summary: count/sum/min/max exactly, percentiles
    from the retained samples.

    By default every sample is retained, so ``percentile(q)`` is exact and
    bit-equal to ``np.percentile`` over the full stream.  Pass ``reservoir``
    to cap memory: beyond that many samples the retained set becomes a
    uniform reservoir (Vitter's algorithm R, seeded — deterministic) and
    percentiles are estimates over it; count/mean/min/max stay exact.
    """

    def __init__(self, reservoir: int | None = None, seed: int = 0):
        if reservoir is not None and reservoir <= 0:
            raise ValueError("reservoir must be positive (or None for exact)")
        self._cap = reservoir
        self._rng = np.random.default_rng(seed)
        self._xs: list[float] = []
        self.n = 0
        self.total = 0.0
        self._min = float("inf")
        self._max = float("-inf")

    def add(self, x: float) -> None:
        x = float(x)
        self.n += 1
        self.total += x
        self._min = min(self._min, x)
        self._max = max(self._max, x)
        if self._cap is None or len(self._xs) < self._cap:
            self._xs.append(x)
        else:
            j = int(self._rng.integers(0, self.n))
            if j < self._cap:
                self._xs[j] = x

    def extend(self, xs) -> None:
        for x in np.asarray(xs, dtype=np.float64).ravel():
            self.add(x)

    @property
    def exact(self) -> bool:
        """True while percentiles are computed over every sample seen."""
        return self._cap is None or self.n <= self._cap

    def mean(self) -> float:
        return self.total / self.n if self.n else float("nan")

    def min(self) -> float:
        return self._min if self.n else float("nan")

    def max(self) -> float:
        return self._max if self.n else float("nan")

    def percentile(self, q: float) -> float:
        return pct(self._xs, q)

    def summary(self) -> dict[str, float]:
        """The repo's standard summary row: n/mean/p50/p99/min/max."""
        return {
            "n": float(self.n),
            "mean": self.mean(),
            "p50": self.percentile(50),
            "p99": self.percentile(99),
            "min": self.min(),
            "max": self.max(),
        }
