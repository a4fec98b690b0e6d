"""The five built-in gradient codes, registered as :class:`GradientCode`s.

Construction math lives in core/coding.py (Alg. 1 + baselines) and
core/groups.py (Alg. 2/3); these classes bind it to the registry protocol —
structural-k declarations, rebalance support, and per-scheme decode fast
paths.  Adding a code family = subclass + ``@register_scheme`` here or in
any imported module (see PAPERS.md for the approximate/nested families
queued behind this seam).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.allocation import proportional_counts, remap_allocation
from repro_torch.core.coding import (
    CodingScheme,
    build_cyclic,
    build_fractional_repetition,
    build_heter_aware,
    build_naive,
    remap_alg1_columns,
)
from repro_torch.core.groups import build_group_based, group_code_from_alloc
from repro_torch.core.registry import (
    GradientCode,
    GroupIndicatorMixin,
    MembershipStats,
    register_scheme,
)

__all__ = [
    "HeterAwareCode",
    "GroupBasedCode",
    "CyclicCode",
    "NaiveCode",
    "FractionalRepetitionCode",
]


class _StableRemapMixin:
    """Shared membership transition for codes with an Eq. 5/6 allocation:
    water-fill the new speed vector, remap the assignment with the bounded
    retained-worker movement guarantee, then rebuild coefficients the
    scheme's own way (``_coefficients_for``)."""

    def resize(self, c: Sequence[float], old_of_new: Sequence[int | None]) -> MembershipStats:
        c = self._check_resize_args(c, old_of_new)
        prev = self.scheme
        counts = proportional_counts(self.k, self.s, c, self.max_load)
        remap = remap_allocation(prev.allocation, counts, old_of_new)
        scheme, changed = self._coefficients_for(prev, remap.allocation, old_of_new)
        self._build_rng_state = None  # B is now path-dependent, never replayed
        self.m = len(old_of_new)
        self.c = c
        self.scheme = scheme
        self._reset_decode_cache()
        self._membership_epoch += 1
        return MembershipStats(
            m_before=prev.m,
            m_after=self.m,
            retained=sum(1 for o in old_of_new if o is not None),
            moved=remap.moved,
            bound=remap.bound,
            changed_columns=changed,
        )


@register_scheme("heter_aware")
class HeterAwareCode(_StableRemapMixin, GradientCode):
    """Paper Alg. 1: heterogeneity-aware optimal code (Thm. 5).  Allocation
    ∝ c (Eq. 5/6), decode via LRU-cached least squares.  Membership
    transitions remap the allocation stably and re-solve only the B columns
    the transition disturbed (retained workers keep their C column)."""

    supports_rebalance = True

    def build(self, c: np.ndarray) -> CodingScheme:
        return build_heter_aware(self.requested_k, self.s, c, rng=self._rng, max_load=self.max_load)

    def _coefficients_for(self, prev, alloc_new, old_of_new):
        return remap_alg1_columns(prev, alloc_new, old_of_new, self._rng)


@register_scheme("group_based")
class GroupBasedCode(_StableRemapMixin, GroupIndicatorMixin, GradientCode):
    """Paper Alg. 2/3 (§V): group rows are 0/1 indicators, remainder coded
    at reduced tolerance.  Decode fast path: first fully-available tiling
    group wins (Eq. 8) — robust to mis-estimated throughputs.  Membership
    transitions keep the allocation stable (bounded movement) and re-run
    the group cover + Alg. 3 coefficients on it; a remapped layout may
    admit fewer tiling groups (P shrinks, Ē is coded at s−P — Thm. 6's
    graceful degradation)."""

    supports_rebalance = True

    def build(self, c: np.ndarray) -> CodingScheme:
        return build_group_based(self.requested_k, self.s, c, rng=self._rng, max_load=self.max_load)

    def _coefficients_for(self, prev, alloc_new, old_of_new):
        return group_code_from_alloc(alloc_new, self.s, self._rng), None


@register_scheme("cyclic")
class CyclicCode(GradientCode):
    """Tandon et al. [12] cyclic baseline: k = m, uniform overlapping
    windows, heterogeneity-oblivious (gated by the slowest worker)."""

    structural_k = True

    def build(self, c: np.ndarray) -> CodingScheme:
        return build_cyclic(self.m, self.s, rng=self._rng)


@register_scheme("naive")
class NaiveCode(GradientCode):
    """Uncoded BSP baseline: k = m, one partition each, zero tolerance —
    the iteration must wait for every worker."""

    structural_k = True
    wait_for_all = True

    def build(self, c: np.ndarray) -> CodingScheme:
        return build_naive(self.m)


@register_scheme("fractional_repetition")
class FractionalRepetitionCode(GroupIndicatorMixin, GradientCode):
    """Tandon's FRS baseline: (s+1)|m replication classes, plain-sum
    encoding; tiling groups give an indicator decode fast path."""

    structural_k = True

    def build(self, c: np.ndarray) -> CodingScheme:
        return build_fractional_repetition(self.m, self.s)
