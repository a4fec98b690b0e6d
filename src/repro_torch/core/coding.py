"""Gradient coding matrix construction (paper §IV, Alg. 1 + baselines).

A *gradient coding strategy* is a matrix ``B ∈ R^{m×k}``: row ``b_i`` is both
the set of partitions worker ``i`` computes (its support) and the linear
encoding it applies before sending ``g̃_i = b_i · [g_1..g_k]^T``.

``B`` is robust to any ``s`` stragglers iff for every subset ``I`` of
``m−s`` workers, ``1_{1×k} ∈ span{b_i : i ∈ I}`` (Condition 1, Lemma 1).

Alg. 1 (heter-aware): draw ``C ∈ R^{(s+1)×m}`` with i.i.d. U(0,1) entries
(properties P1/P2 hold w.p. 1, Lemma 3).  For each partition ``j``, its
``s+1`` holders index a square submatrix ``C_j``; embed ``d'_j = C_j^{-1}·1``
into column ``j`` of ``B``.  Then ``C·B = 1_{(s+1)×k}`` and Condition 1 holds
(Lemma 2); with the Eq. 5 allocation the strategy is optimal (Thm. 5):
``T(B) = (s+1)·k / Σc_i``.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Sequence

import numpy as np

from repro_torch.core.allocation import Allocation, allocate, uniform_allocation

__all__ = [
    "CodingScheme",
    "build_heter_aware",
    "build_cyclic",
    "build_naive",
    "build_fractional_repetition",
    "remap_alg1_columns",
    "scheme_to_state",
    "scheme_from_state",
    "make_scheme",
    "satisfies_condition1",
]

# Re-draw C when any per-partition submatrix is ill-conditioned.  U(0,1)
# draws satisfy P1/P2 w.p. 1 but can still be numerically nasty; the paper
# ignores this, we don't.
_COND_MAX = 1e8
_MAX_REDRAWS = 64


@dataclasses.dataclass(frozen=True)
class CodingScheme:
    """A complete gradient coding strategy.

    Attributes:
      name: scheme id ("heter_aware" | "group_based" | "cyclic" | "naive" |
        "fractional_repetition").
      B: (m, k) encoding matrix.  Row i = worker i's encoding coefficients.
      allocation: the partition→worker assignment B's support came from.
      s: designed straggler tolerance.
      groups: optional tuple of worker-index tuples (group-based scheme only);
        each group's partition sets tile the dataset exactly, so the group
        decodes with an all-ones indicator vector.
      C: the auxiliary matrix used by Alg.1 (None for naive/frs).
    """

    name: str
    B: np.ndarray
    allocation: Allocation
    s: int
    groups: tuple[tuple[int, ...], ...] = ()
    C: np.ndarray | None = None

    @property
    def m(self) -> int:
        return self.B.shape[0]

    @property
    def k(self) -> int:
        return self.B.shape[1]

    def worker_load(self) -> np.ndarray:
        """||b_i||_0 per worker (partitions computed per iteration)."""
        return np.asarray(self.allocation.counts, dtype=np.int64)


def _build_from_support(alloc: Allocation, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """Alg. 1 body: returns (B, C) with C·B = 1 for an arbitrary support whose
    every partition has exactly ``s+1`` holders.

    Fully batched: the k per-partition (s+1)×(s+1) systems are stacked and
    solved in one LAPACK call (conditioning checked the same way), so plan
    builds stay milliseconds at m=256+ instead of k Python-level solves.
    """
    m, k, s = alloc.m, alloc.k, alloc.s
    holders = alloc.holders_matrix()  # (k, s+1), validates s+1 holders each
    ones = np.ones((k, s + 1, 1), dtype=np.float64)
    for _ in range(_MAX_REDRAWS):
        C = rng.uniform(size=(s + 1, m))
        Cj = C[:, holders].transpose(1, 0, 2)  # (k, s+1, s+1) per-partition
        if float(np.linalg.cond(Cj).max()) > _COND_MAX:
            continue
        sol = np.linalg.solve(Cj, ones)[..., 0]  # (k, s+1)
        B = np.zeros((m, k), dtype=np.float64)
        B[holders.reshape(-1), np.repeat(np.arange(k), s + 1)] = sol.reshape(-1)
        return B, C
    raise RuntimeError("could not draw a well-conditioned C")  # pragma: no cover


def build_heter_aware(
    k: int, s: int, c: Sequence[float], rng: np.random.Generator | int | None = 0,
    max_load: int | None = None,
) -> CodingScheme:
    """Paper Alg. 1: heterogeneity-aware optimal gradient coding."""
    rng = np.random.default_rng(rng) if not isinstance(rng, np.random.Generator) else rng
    alloc = allocate(k, s, c, max_load)
    B, C = _build_from_support(alloc, rng)
    return CodingScheme(name="heter_aware", B=B, allocation=alloc, s=s, C=C)


def remap_alg1_columns(
    prev: CodingScheme,
    alloc_new: Allocation,
    old_of_new: Sequence[int | None],
    rng: np.random.Generator,
) -> tuple[CodingScheme, int]:
    """Membership-remapped Alg. 1 rebuild: re-solve ONLY the B columns whose
    holder set changed (DESIGN.md §8).

    Retained workers keep their C column; joiners draw fresh ones.  A
    partition whose s+1 holders all survived with the same membership keeps
    its B column bit-for-bit (its C submatrix is unchanged), so a small
    join/leave touches only the columns the transition actually disturbed.
    Ill-conditioned changed submatrices redraw the FRESH columns only (the
    retained ones anchor the unchanged columns' validity); with no fresh
    columns to redraw, fall back to a full redraw + full re-solve.

    Returns ``(scheme, n_changed_columns)``.  ``C·B = 1`` column-wise and
    Condition 1 hold exactly as for a fresh Alg. 1 build (the concatenated
    C stays generic w.p. 1).
    """
    if prev.C is None:
        raise ValueError("remap_alg1_columns needs a scheme built by Alg. 1 (C matrix)")
    m_new, k, s = alloc_new.m, alloc_new.k, alloc_new.s
    if k != prev.k or s != prev.s:
        raise ValueError("membership remap never changes k or s")
    old_idx = np.array([-1 if o is None else int(o) for o in old_of_new], np.int64)
    new_of_old = np.full(prev.m, -1, dtype=np.int64)
    new_of_old[old_idx[old_idx >= 0]] = np.flatnonzero(old_idx >= 0)

    holders_new = alloc_new.holders_matrix()  # (k, s+1), worker-ascending
    holders_old = prev.allocation.holders_matrix()
    # retained workers keep relative order, joiners append, so mapping old
    # holder rows stays ascending — rows compare directly, no re-sort
    mapped_old = new_of_old[holders_old]  # (k, s+1); -1 where holder departed
    changed = (mapped_old < 0).any(axis=1) | (mapped_old != holders_new).any(axis=1)

    fresh_cols = np.flatnonzero(old_idx < 0)
    C = np.empty((s + 1, m_new), dtype=np.float64)
    retained_cols = np.flatnonzero(old_idx >= 0)
    C[:, retained_cols] = prev.C[:, old_idx[retained_cols]]
    ones = np.ones((1, s + 1, 1), dtype=np.float64)
    for attempt in range(_MAX_REDRAWS):
        C[:, fresh_cols] = rng.uniform(size=(s + 1, fresh_cols.size))
        idx = np.flatnonzero(changed)
        if idx.size == 0:
            sol = np.empty((0, s + 1))
            break
        Cj = C[:, holders_new[idx]].transpose(1, 0, 2)  # (nc, s+1, s+1)
        if float(np.linalg.cond(Cj).max()) > _COND_MAX:
            if fresh_cols.size == 0 or attempt == _MAX_REDRAWS - 2:
                # nothing redrawable can fix it: fall back to a full rebuild
                B, C = _build_from_support(alloc_new, rng)
                return (
                    CodingScheme(name=prev.name, B=B, allocation=alloc_new, s=s, C=C),
                    k,
                )
            continue
        sol = np.linalg.solve(Cj, np.broadcast_to(ones, (idx.size, s + 1, 1)))[..., 0]
        break
    else:  # pragma: no cover - loop always breaks or falls back
        raise RuntimeError("could not draw a well-conditioned C")

    B = np.zeros((m_new, k), dtype=np.float64)
    unchanged = np.flatnonzero(~changed)
    if unchanged.size:
        B[mapped_old[unchanged].reshape(-1), np.repeat(unchanged, s + 1)] = (
            prev.B[holders_old[unchanged].reshape(-1), np.repeat(unchanged, s + 1)]
        )
    if idx.size:
        B[holders_new[idx].reshape(-1), np.repeat(idx, s + 1)] = sol.reshape(-1)
    return (
        CodingScheme(name=prev.name, B=B, allocation=alloc_new, s=s, C=C),
        int(changed.sum()),
    )


def scheme_to_state(scheme: CodingScheme) -> dict:
    """JSON-able snapshot of a complete scheme — the explicit form membership
    transitions need (a post-churn B is path-dependent; replaying the
    original build cannot reproduce it)."""
    alloc = scheme.allocation
    return {
        "name": scheme.name,
        "B": [[float(x) for x in row] for row in scheme.B],
        "s": int(scheme.s),
        "k": int(alloc.k),
        "alloc_s": int(alloc.s),
        "counts": [int(x) for x in alloc.counts],
        "partitions": [[int(p) for p in ps] for ps in alloc.partitions],
        "groups": [[int(w) for w in g] for g in scheme.groups],
        "C": None if scheme.C is None else [[float(x) for x in row] for row in scheme.C],
    }


def scheme_from_state(state: dict) -> CodingScheme:
    """Inverse of :func:`scheme_to_state` — bit-exact (JSON floats
    round-trip shortest-repr exact)."""
    alloc = Allocation(
        k=int(state["k"]),
        s=int(state["alloc_s"]),
        counts=tuple(int(x) for x in state["counts"]),
        partitions=tuple(tuple(int(p) for p in ps) for ps in state["partitions"]),
    )
    return CodingScheme(
        name=state["name"],
        B=np.asarray(state["B"], dtype=np.float64),
        allocation=alloc,
        s=int(state["s"]),
        groups=tuple(tuple(int(w) for w in g) for g in state["groups"]),
        C=None if state["C"] is None else np.asarray(state["C"], dtype=np.float64),
    )


def build_cyclic(m: int, s: int, rng: np.random.Generator | int | None = 0) -> CodingScheme:
    """Tandon et al. cyclic scheme: k = m partitions, worker ``i`` holds the
    OVERLAPPING window {i, i+1, ..., i+s} (mod m) — [12]'s support exactly.

    Note this differs from Eq. 6's end-to-end arcs (which, for uniform c,
    degenerate to a fractional-repetition-like structure that decodes from
    fewer workers); the baselines must match the paper's cited scheme.
    Coefficients come from the same Alg. 1 algebra (valid for any support
    with s+1 holders per partition).
    """
    rng = np.random.default_rng(rng) if not isinstance(rng, np.random.Generator) else rng
    parts = tuple(tuple((i + j) % m for j in range(s + 1)) for i in range(m))
    alloc = Allocation(k=m, s=s, counts=(s + 1,) * m, partitions=parts)
    B, C = _build_from_support(alloc, rng)
    return CodingScheme(name="cyclic", B=B, allocation=alloc, s=s, C=C)


def build_naive(m: int) -> CodingScheme:
    """Uncoded baseline: k = m, one partition per worker, zero tolerance."""
    alloc = uniform_allocation(m, 0, m)
    return CodingScheme(name="naive", B=np.eye(m, dtype=np.float64), allocation=alloc, s=0)


def build_fractional_repetition(m: int, s: int) -> CodingScheme:
    """Tandon's FRS: requires (s+1) | m.  m/(s+1) worker groups; group g's
    s+1 workers all hold partition block g (k = m partitions, blocks of s+1),
    encoding = plain sum (all-ones coefficients)."""
    if m % (s + 1) != 0:
        raise ValueError(f"fractional repetition needs (s+1) | m, got m={m}, s={s}")
    k = m
    n_groups = m // (s + 1)
    block = k // n_groups  # == s+1
    counts = [block] * m
    parts = []
    for i in range(m):
        g = i // (s + 1)
        parts.append(tuple(range(g * block, (g + 1) * block)))
    alloc = Allocation(k=k, s=s, counts=tuple(counts), partitions=tuple(parts))
    B = np.zeros((m, k), dtype=np.float64)
    for i, ps in enumerate(parts):
        B[i, list(ps)] = 1.0
    groups = tuple(
        tuple(range(g * (s + 1), (g + 1) * (s + 1))) for g in range(n_groups)
    )
    # each "group" here is a replication class: ANY single member decodes its
    # block; the tiling groups (one worker per class) are what decode g.
    tiling_groups = tuple(
        tuple(g * (s + 1) + r for g in range(n_groups)) for r in range(s + 1)
    )
    del groups
    return CodingScheme(
        name="fractional_repetition", B=B, allocation=alloc, s=s, groups=tiling_groups
    )


def make_scheme(
    name: str,
    m: int,
    k: int,
    s: int,
    c: Sequence[float] | None = None,
    rng: np.random.Generator | int | None = 0,
    max_load: int | None = None,
) -> CodingScheme:
    """DEPRECATED shim over the registry (kept for old callers/tests).

    New code should construct through ``repro_torch.core.registry.get_scheme``,
    which returns the full :class:`GradientCode` (decode fast paths,
    rebalance, structural-k declaration) instead of the bare matrix.
    """
    import warnings

    warnings.warn(
        "make_scheme is deprecated; use repro_torch.core.registry.get_scheme",
        DeprecationWarning,
        stacklevel=2,
    )
    from repro_torch.core.registry import get_scheme

    return get_scheme(name, m=m, k=k, s=s, c=c, rng=rng, max_load=max_load).scheme


def _spans_ones(rows: np.ndarray, atol: float) -> bool:
    k = rows.shape[1]
    ones = np.ones(k)
    x, *_ = np.linalg.lstsq(rows.T, ones, rcond=None)
    return bool(np.allclose(rows.T @ x, ones, atol=atol))


def satisfies_condition1(
    B: np.ndarray,
    s: int,
    atol: float = 1e-6,
    max_patterns: int = 20_000,
    rng: np.random.Generator | int | None = 0,
) -> bool:
    """Check Condition 1 (Lemma 1) — every (m−s)-subset of rows spans the
    all-ones vector.

    Exhaustive when ``C(m, s) <= max_patterns`` (all of paper scale);
    beyond that — the large-m regime, where enumeration is astronomically
    exponential — ``max_patterns`` uniformly sampled straggler patterns are
    verified instead.  A sampled pass is probabilistic evidence, not proof;
    a sampled *failure* is still a definite counterexample."""
    m, k = B.shape
    if s <= 0:
        return _spans_ones(B, atol)
    n_patterns = math.comb(m, s)
    if n_patterns <= max_patterns:
        for I in itertools.combinations(range(m), m - s):
            if not _spans_ones(B[list(I)], atol):
                return False
        return True
    rng = np.random.default_rng(rng) if not isinstance(rng, np.random.Generator) else rng
    alive = np.ones(m, dtype=bool)
    for _ in range(max_patterns):
        dead = rng.choice(m, size=s, replace=False)
        alive[:] = True
        alive[dead] = False
        if not _spans_ones(B[alive], atol):
            return False
    return True
