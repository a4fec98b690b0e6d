"""The two approximate code families, registered as :class:`GradientCode`s.

`bernoulli` — stochastic approximate coding (Johri et al.; Song & Choi):
worker i holds each partition independently with probability
``p_i = (s+1)·c_i/Σc`` (heterogeneity-aware: expected copies per partition
= s+1, faster workers hold more).  Encoding coefficients are ``1/h_j``
(h_j = realized holders of partition j), so the *full* worker set always
decodes exactly with the all-ones vector, while straggler patterns decode
best-effort with a residual that shrinks as coverage grows.  ``exact=False``:
the runtime must not rely on ``a·B = 1`` existing for every ≤s pattern.

`partial_work` — the paper's heter-aware code (Alg. 1) under a streaming
report contract: workers upload each partition's coded contribution as it
completes instead of all-or-nothing, declared via ``reports_partial_work``.
The B matrix and exactness guarantee are heter_aware's; what changes is the
*information set* a deadline decode sees — completed prefixes, masked into
``B_eff`` by :meth:`GradientCode.decode_partial`.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.allocation import Allocation
from repro_torch.core.coding import CodingScheme
from repro_torch.core.registry import GradientCode, MembershipStats, register_scheme
from repro_torch.core.schemes import HeterAwareCode

__all__ = ["BernoulliCode", "PartialWorkCode", "build_bernoulli"]


def _patch_coverage(
    hold: np.ndarray, c: np.ndarray, cap: int, rng: np.random.Generator
) -> np.ndarray:
    """Guarantee every partition ≥1 holder: patch uncovered partitions onto
    c-weighted workers with room.  Mutates ``hold``; returns the (m,) count
    of patches applied per worker (the movement a membership transition
    charges to retained workers)."""
    m = hold.shape[0]
    patched = np.zeros(m, dtype=np.int64)
    for j in np.flatnonzero(~hold.any(axis=0)):
        room = hold.sum(axis=1) < cap
        if not room.any():
            # every worker at cap; m·cap ≥ k guarantees a redundant copy
            # exists somewhere — free that slot first
            h = hold.sum(axis=0)
            ws, js = np.nonzero(hold & (h[None, :] >= 2))
            pick = int(rng.integers(ws.size))
            hold[ws[pick], js[pick]] = False
            room = hold.sum(axis=1) < cap
        w = c * room
        i = int(rng.choice(m, p=w / w.sum()))
        hold[i, j] = True
        patched[i] += 1
    return patched


def _bernoulli_scheme_from_hold(hold: np.ndarray, k: int) -> CodingScheme:
    holders = hold.sum(axis=0)
    B = np.where(hold, 1.0 / holders[None, :], 0.0)
    parts = tuple(tuple(int(j) for j in np.flatnonzero(row)) for row in hold)
    alloc = Allocation(k=k, s=0, counts=tuple(len(ps) for ps in parts), partitions=parts)
    return CodingScheme(name="bernoulli", B=B, allocation=alloc, s=0)


def build_bernoulli(
    k: int,
    s: int,
    c: Sequence[float],
    rng: np.random.Generator | int | None = 0,
    max_load: int | None = None,
) -> CodingScheme:
    """Heterogeneity-aware Bernoulli support + 1/h_j coefficients.

    Every partition is guaranteed ≥1 holder (uncovered partitions are
    patched onto throughput-weighted workers), per-worker load is capped at
    ``max_load`` so elastic re-draws stay inside a fixed slot plan.  The
    scheme's *guaranteed* tolerance is 0 — `s` only sizes the expected
    replication — so the stored ``CodingScheme.s`` is 0.
    """
    rng = np.random.default_rng(rng) if not isinstance(rng, np.random.Generator) else rng
    c = np.asarray(c, dtype=np.float64)
    m = c.shape[0]
    if np.any(c <= 0):
        raise ValueError("throughputs must be positive")
    cap = k if max_load is None else min(k, int(max_load))
    if m * cap < k:
        raise ValueError(f"k={k} partitions cannot be covered with m={m}, max_load={cap}")
    p = np.clip((s + 1) * c / c.sum(), 0.0, 1.0)
    hold = rng.uniform(size=(m, k)) < p[:, None]
    # cap per-worker load (drop a uniform subset of the excess)
    for i in range(m):
        held = np.flatnonzero(hold[i])
        if held.size > cap:
            drop = rng.choice(held, size=held.size - cap, replace=False)
            hold[i, drop] = False
    # guarantee coverage: patch uncovered partitions onto c-weighted workers
    _patch_coverage(hold, c, cap, rng)
    return _bernoulli_scheme_from_hold(hold, k)


@register_scheme("bernoulli")
class BernoulliCode(GradientCode):
    """Stochastic approximate code: Bernoulli(p_i ∝ c_i) support, 1/h_j
    coefficients.  Full availability decodes exactly (a = 1); anything less
    is best-effort — pair with a :class:`~repro_torch.approx.DeadlinePolicy`."""

    exact = False
    supports_rebalance = True

    def build(self, c: np.ndarray) -> CodingScheme:
        return build_bernoulli(
            self.requested_k, self.s, c, rng=self._rng, max_load=self.max_load
        )

    def resize(self, c, old_of_new) -> MembershipStats:
        """Stable stochastic transition: retained workers keep their Bernoulli
        support verbatim (zero movement unless a departure uncovered a
        partition that patches back onto a survivor); joiners draw fresh
        c-proportional rows; 1/h_j coefficients are recomputed from the new
        realized holder counts.  Movement bound: one patch per partition
        whose holders all departed, so ``moved ≤ copies held by the removed
        workers``."""
        c = self._check_resize_args(c, old_of_new)
        prev = self.scheme
        m_new, k = len(old_of_new), self.k
        cap = k if self.max_load is None else min(k, int(self.max_load))
        hold = np.zeros((m_new, k), dtype=bool)
        removed_load = sum(prev.allocation.counts) - sum(
            prev.allocation.counts[o] for o in old_of_new if o is not None
        )
        for i, o in enumerate(old_of_new):
            if o is not None:
                hold[i, list(prev.allocation.partitions[o])] = True
        p = np.clip((self.s + 1) * c / c.sum(), 0.0, 1.0)
        for i, o in enumerate(old_of_new):
            if o is not None:
                continue
            row = self._rng.uniform(size=k) < p[i]
            held = np.flatnonzero(row)
            if held.size > cap:
                drop = self._rng.choice(held, size=held.size - cap, replace=False)
                row[drop] = False
            hold[i] = row
        patched = _patch_coverage(hold, c, cap, self._rng)
        moved = int(sum(patched[i] for i, o in enumerate(old_of_new) if o is not None))
        self._build_rng_state = None  # path-dependent from here on
        self.m = m_new
        self.c = c
        self.scheme = _bernoulli_scheme_from_hold(hold, k)
        self._reset_decode_cache()
        self._membership_epoch += 1
        return MembershipStats(
            m_before=prev.m,
            m_after=m_new,
            retained=sum(1 for o in old_of_new if o is not None),
            moved=moved,
            bound=int(removed_load),
            changed_columns=None,
        )


@register_scheme("partial_work")
class PartialWorkCode(HeterAwareCode):
    """Heter-aware code (Alg. 1) whose workers report per-partition
    completion instead of all-or-nothing: deadline decodes see completed
    prefixes via ``decode_partial``.  Same B, same exactness guarantee."""

    reports_partial_work = True

    def build(self, c: np.ndarray) -> CodingScheme:
        return dataclasses.replace(super().build(c), name="partial_work")
