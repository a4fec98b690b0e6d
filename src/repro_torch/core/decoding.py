"""Decode-vector construction (paper §III-B, Eq. 2 / §V Eq. 8).

Given coded gradients ``g̃_i = b_i·[g_1..g_k]^T`` from an *available* worker
set ``A`` (non-stragglers), the master recovers ``g = Σ_j g_j`` with any
``a ∈ R^m`` such that ``supp(a) ⊆ A`` and ``a·B = 1_{1×k}``:

    g = Σ_{i∈A} a_i · g̃_i.

The full decoding matrix ``A ∈ R^{S×m}`` (one row per straggler pattern,
``S = C(m,s)``) is never materialized at scale; per the paper, decode vectors
for "regular" patterns are cached and irregular ones are solved online in
O(mk²) — negligible next to a training step.

The group-based scheme (§V) adds a fast path: if a *group* (workers whose
partition arcs tile the dataset) is fully available, its decode vector is the
0/1 indicator — no solve, fewest workers (Eq. 8).

Inexact decoding (approx subsystem): when no exact set exists — too many
stragglers, a mis-estimated allocation, or an intentionally approximate code
— the same least squares still yields the *best-effort* decode, the ``a``
minimizing ``‖a·B − 1‖₂``.  :func:`best_effort_decode_vector` packages it as
a :class:`DecodeOutcome` (vector + ``exact`` flag + RMS residual) instead of
raising, and accepts a per-entry ``support`` mask so partially-completed
workers (partial-work codes) contribute exactly the partition prefix they
finished.  The residual is what deadline policies bound (DESIGN.md §5).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Iterable, Sequence

import numpy as np

from repro_torch.core.coding import CodingScheme

__all__ = [
    "DecodeError",
    "DecodeOutcome",
    "solve_decode_vector",
    "best_effort_decode_vector",
    "DecodableSetTracker",
    "worker_arrival_order",
    "earliest_decodable_prefix",
    "earliest_decodable_stream",
    "Decoder",
]

_ATOL = 1e-6
# np.allclose(fit, 1, atol=_ATOL) with default rtol — the exact-decode check
# used by both solver paths — accepts per-component misfit up to this:
_EXACT_TOL = _ATOL + 1e-5 * 1.0
# The tracker triggers an exact-solve confirmation well before its own
# (mathematically identical, numerically ~1e-12-apart) misfit estimate
# reaches the solver tolerance, so tracker/solver disagreement can only
# cost a spurious cheap confirm — never a missed decodable prefix.
_TRIGGER_SLACK = 32.0


class DecodeError(RuntimeError):
    """Raised when the available set cannot recover the aggregated gradient."""


@dataclasses.dataclass(frozen=True)
class DecodeOutcome:
    """Result of one decode attempt, exact or best-effort.

    Attributes:
      a: (m,) decode vector; zeros outside the contributing workers.
      exact: ``a·B_eff == 1`` to tolerance — the decoded gradient is the true
        mean gradient.  ``residual == 0.0`` iff ``exact`` (same tolerance).
      residual: RMS misfit ``‖a·B_eff − 1‖₂ / √k`` — 0 for exact decodes,
        1 when nothing arrived (a = 0); deadline policies bound it.
      support: optional (m, k) effective-B mask (1 = worker finished that
        partition); ``None`` means full rows.  Slot-weight builders apply it
        so unfinished partitions never enter the gradient.

    Instances may be LRU-cached by the scheme — treat them as immutable,
    arrays included.
    """

    a: np.ndarray
    exact: bool
    residual: float
    support: np.ndarray | None = None

    @property
    def n_used(self) -> int:
        return int(np.count_nonzero(np.abs(self.a) > 1e-12))


def solve_decode_vector(
    B: np.ndarray, available: Sequence[int], atol: float = _ATOL
) -> np.ndarray:
    """Minimum-norm ``a`` with ``supp(a) ⊆ available`` and ``a·B = 1``.

    Least-squares on the available rows: solve ``B[A]^T x = 1`` and embed.
    Raises DecodeError when 1 is not in the row span (pattern not decodable).
    """
    m, k = B.shape
    avail = sorted(set(int(i) for i in available))
    if not avail:
        raise DecodeError("no workers available")
    rows = B[avail]  # (|A|, k)
    ones = np.ones(k, dtype=np.float64)
    x, *_ = np.linalg.lstsq(rows.T, ones, rcond=None)
    if not np.allclose(rows.T @ x, ones, atol=atol):
        raise DecodeError(f"available set {avail} cannot decode (1 ∉ row span)")
    a = np.zeros(m, dtype=np.float64)
    a[avail] = x
    return a


def best_effort_decode_vector(
    B: np.ndarray,
    available: Iterable[int] | None = None,
    support: np.ndarray | None = None,
    atol: float = _ATOL,
) -> DecodeOutcome:
    """Best-effort decode: the ``a`` minimizing ``‖a·B_eff − 1‖₂``.

    ``B_eff = B * support`` when a (m, k) completion mask is given (partial
    work), else ``B`` itself; rows outside ``available`` (default: all) are
    excluded.  Never raises — an empty/useless available set yields
    ``a = 0`` with residual 1.  ``exact`` uses the same per-component
    tolerance as :func:`solve_decode_vector`, so the two paths agree on
    which patterns are decodable.
    """
    m, k = B.shape
    B_eff = B if support is None else B * np.asarray(support, np.float64)
    avail = (
        sorted(set(int(i) for i in available)) if available is not None else list(range(m))
    )
    # workers with no surviving coefficients contribute nothing to the solve
    avail = [i for i in avail if np.any(B_eff[i])]
    ones = np.ones(k, dtype=np.float64)
    if not avail:
        return DecodeOutcome(
            a=np.zeros(m, dtype=np.float64), exact=False, residual=1.0, support=support
        )
    rows = B_eff[avail]
    x, *_ = np.linalg.lstsq(rows.T, ones, rcond=None)
    fit = rows.T @ x
    exact = bool(np.allclose(fit, ones, atol=atol))
    residual = 0.0 if exact else float(np.linalg.norm(fit - ones) / np.sqrt(k))
    a = np.zeros(m, dtype=np.float64)
    a[avail] = x
    return DecodeOutcome(a=a, exact=exact, residual=residual, support=support)


class DecodableSetTracker:
    """Incremental "decodable yet?" over a growing available-worker set.

    The arrival-driven control plane (DESIGN.md §7) asks, after every worker
    completion, whether the live set can decode.  A fresh least-squares per
    prefix is O(|A|·k²) each — O(m²k²) per iteration at large m.  The
    tracker instead maintains an orthonormal basis of
    ``span{B[i] : i ∈ A}`` (modified Gram-Schmidt with re-orthogonalization)
    and the residual of the all-ones target against it, so each arrival is
    one O(rank·k) update and

    - ``residual``   — RMS best-effort misfit ``min_a ‖a·B[A] − 1‖₂/√k``,
      identical (to fp noise) to ``best_effort_decode_vector``'s residual;
    - ``maybe_decodable`` — a slack-widened trigger for the exact-solve
      confirmation (see ``_TRIGGER_SLACK``): cheap to test every event,
      never false-negative in practice;
    - ``decodable``  — the solver's own exactness tolerance on the tracked
      misfit, for standalone use.

    The tracker answers *whether* a set decodes; the decode *vector* still
    comes from the scheme's (LRU-cached) solver so coefficients stay
    bit-identical with the non-streaming path.  Rows numerically inside the
    current span (no rank growth) cannot change any answer and cost one
    projection.
    """

    def __init__(self, B: np.ndarray, atol: float = _ATOL):
        self.B = np.asarray(B, dtype=np.float64)
        self.m, self.k = self.B.shape
        self.atol = atol
        self._basis = np.empty((min(self.m, self.k), self.k), dtype=np.float64)
        self._rank = 0
        self._misfit = np.ones(self.k, dtype=np.float64)  # 1 − proj_span(1)
        self.available: list[int] = []

    def add(self, worker: int) -> bool:
        """Fold worker ``worker``'s row into the span; True iff rank grew."""
        self.available.append(int(worker))
        if self._rank >= self._basis.shape[0]:
            return False  # span is already the full space
        row = self.B[worker]
        scale = float(np.linalg.norm(row))
        if scale == 0.0:
            return False  # empty allocation: contributes nothing
        v = row.copy()
        q = self._basis[: self._rank]
        for _ in range(2):  # re-orthogonalize: keeps the basis stable
            if self._rank:
                v -= (q @ v) @ q
        nv = float(np.linalg.norm(v))
        if nv <= 1e-12 * scale:
            return False  # row inside the current span
        v /= nv
        self._basis[self._rank] = v
        self._rank += 1
        self._misfit -= float(self._misfit @ v) * v
        return True

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def max_misfit(self) -> float:
        """Largest per-component misfit of the best fit to the ones vector."""
        return float(np.abs(self._misfit).max()) if self.k else 0.0

    @property
    def residual(self) -> float:
        """RMS best-effort residual ``‖a·B[A] − 1‖₂/√k`` of the live set."""
        return float(np.linalg.norm(self._misfit) / np.sqrt(self.k))

    @property
    def decodable(self) -> bool:
        """Exactness at the solver's own tolerance (per-component)."""
        return self.max_misfit <= _EXACT_TOL

    @property
    def maybe_decodable(self) -> bool:
        """Cheap trigger for an exact-solve confirmation (slack-widened)."""
        return self.max_misfit <= _TRIGGER_SLACK * _EXACT_TOL


def worker_arrival_order(
    finish_times: Sequence[float], dead: Iterable[int] = ()
) -> Iterable[tuple[float, int]]:
    """(t, worker) worker-completion events in arrival order — the
    whole-worker ArrivalStream a dense finish vector induces.  Stable order
    on ties (worker index), dead/non-finite workers never emitted."""
    finish_times = np.asarray(finish_times, dtype=np.float64)
    dead = set(int(i) for i in dead)
    for idx in np.argsort(finish_times, kind="stable"):
        i = int(idx)
        if i in dead or not np.isfinite(finish_times[i]):
            continue
        yield float(finish_times[i]), i


def earliest_decodable_stream(
    B: np.ndarray,
    arrivals: Iterable[tuple[float, int]],
    confirm,
    fast_path=None,
    atol: float = _ATOL,
) -> tuple[float, tuple[int, ...]]:
    """Streaming Eq. 3: consume ``(t, worker)`` completion events in arrival
    order, answer "decodable yet?" incrementally, return (τ, used) at the
    earliest decodable prefix.

    ``confirm(live_tuple)`` is the scheme's exact solver: it returns the
    decode vector ``a`` for the live set or ``None`` when the set only
    decodes best-effort (it is invoked once per tracker trigger, not per
    event — the O(rank·k) tracker answers everything else).
    ``fast_path(frozenset)`` is the optional scheme shortcut (group
    indicator), checked first exactly like the non-streaming path so the
    two agree on (τ, used) bit-for-bit.
    """
    tracker = DecodableSetTracker(B, atol)
    live: list[int] = []
    times: dict[int, float] = {}
    for t, w in arrivals:
        w = int(w)
        live.append(w)
        times[w] = float(t)
        a = fast_path(frozenset(live)) if fast_path is not None else None
        if a is None:
            tracker.add(w)
            if not tracker.maybe_decodable:
                continue
            a = confirm(tuple(live))
            if a is None:
                continue
        used = tuple(j for j in live if abs(a[j]) > 1e-12)
        tau = max((times[j] for j in used), default=0.0)
        return float(tau), used
    raise DecodeError("no decodable set among finished workers")


def earliest_decodable_prefix(
    decode_vector, finish_times: Sequence[float], dead: Iterable[int] = ()
) -> tuple[float, tuple[int, ...]]:
    """Smallest time τ at which the set of finished workers decodes —
    Eq. 3's T(B, S) for one concrete pattern.

    ``decode_vector(live)`` is any decode callable (``Decoder`` or
    ``GradientCode``, so scheme fast paths apply); ``finish_times[i]`` =
    time worker i returns its coded gradient (np.inf for faults).
    Returns (τ, used_workers).
    """
    dead = set(dead)
    order = np.argsort(finish_times, kind="stable")
    live: list[int] = []
    for idx in order:
        i = int(idx)
        if i in dead or not np.isfinite(finish_times[i]):
            continue
        live.append(i)
        # a fast path may trigger before the span condition does
        try:
            a = decode_vector(live)
        except DecodeError:
            continue
        used = tuple(j for j in live if abs(a[j]) > 1e-12)
        t = max(finish_times[j] for j in used) if used else 0.0
        return float(t), used
    raise DecodeError("no decodable set among finished workers")


class Decoder:
    """Stateful decoder for one coding scheme.

    - group fast path (§V): all-ones indicator over the first fully-available
      group — O(m) check, exact, uses ≤ m−s workers;
    - LRU-cached lstsq solves for repeated ("regular") straggler patterns;
    - ``min_workers_decode``: earliest-decodable-prefix search used by the
      simulator to find when an iteration can complete (Eq. 3's j*).
    """

    def __init__(self, scheme: CodingScheme, cache_size: int = 4096):
        self.scheme = scheme
        self._solve = lru_cache(maxsize=cache_size)(self._solve_uncached)

    def _solve_uncached(self, avail_key: frozenset[int]) -> np.ndarray:
        return solve_decode_vector(self.scheme.B, sorted(avail_key))

    def decode_vector(self, available: Iterable[int]) -> np.ndarray:
        """Decode vector for an available-worker set, group fast path first."""
        avail = frozenset(int(i) for i in available)
        for group in self.scheme.groups:
            if avail.issuperset(group):
                a = np.zeros(self.scheme.m, dtype=np.float64)
                a[list(group)] = 1.0
                return a
        return self._solve(avail)

    def is_decodable(self, available: Iterable[int]) -> bool:
        try:
            self.decode_vector(available)
            return True
        except DecodeError:
            return False

    def _group_fast_path(self, avail: frozenset[int]) -> np.ndarray | None:
        for group in self.scheme.groups:
            if avail.issuperset(group):
                a = np.zeros(self.scheme.m, dtype=np.float64)
                a[list(group)] = 1.0
                return a
        return None

    def _confirm_exact(self, live: tuple[int, ...]) -> np.ndarray | None:
        try:
            return self._solve(frozenset(live))
        except DecodeError:
            return None

    def earliest_decodable(
        self, finish_times: Sequence[float], dead: Iterable[int] = ()
    ) -> tuple[float, tuple[int, ...]]:
        """Streaming Eq. 3 over the induced worker-arrival order: the
        incremental tracker answers "decodable yet?" per event, the cached
        solver is consulted once at the decodable moment."""
        return earliest_decodable_stream(
            self.scheme.B,
            worker_arrival_order(finish_times, dead),
            confirm=self._confirm_exact,
            fast_path=self._group_fast_path,
        )
