"""Group-based coding scheme (paper §V, Alg. 2 + Alg. 3).

A *group* G is a set of workers whose partition sets are pairwise disjoint
and together tile the whole dataset (condition ★).  A fully-available group
decodes with the 0/1 indicator vector (Eq. 8) using ``|G| ≤ m−s`` workers —
fewer than the generic ``m−s`` decode — which makes the scheme robust to
*mis-estimated* throughputs: the first-finishing tiling of the data wins,
regardless of which workers were predicted fast.

Alg. 2 enumerates groups recursively and prunes to a pairwise-disjoint set
(condition ★★).  Alg. 3 sets the B-rows of group workers to 1 on their
support; the remaining workers Ē are coded with Alg. 1 at reduced tolerance
``s − P`` (each partition keeps exactly ``s+1−P`` copies inside Ē because the
P disjoint groups each hold exactly one copy).  Robust to any s stragglers
(Thm. 6): if every group is broken, ≥P stragglers are spent on groups and Ē
faces at most s−P.

Note: the paper's Alg. 3 line "Alg.1 under s = m−P" is a typo for ``s − P``;
the Thm. 6 proof uses s−P and only s−P makes the per-column submatrices
square.  Property-tested by exhaustive Condition-1 enumeration.
"""

from __future__ import annotations

import warnings
from typing import Sequence

import numpy as np

from repro_torch.core.allocation import Allocation, allocate
from repro_torch.core.coding import CodingScheme, _build_from_support

__all__ = [
    "GroupSearchResult",
    "find_all_groups",
    "find_greedy_groups",
    "prune_groups",
    "build_group_based",
    "group_code_from_alloc",
    "GREEDY_GROUP_THRESHOLD",
]

# Above this worker count Alg. 2's exact-cover enumeration is replaced by the
# O(m·k) greedy arc-chaining cover — the exponential recursion stops being
# even startable long before m=256.
GREEDY_GROUP_THRESHOLD = 24


class GroupSearchResult(list):
    """Group list + search diagnostics.

    A plain ``list`` everywhere it matters, with a ``truncated`` flag so a
    degraded cover (enumeration stopped at ``max_groups``) is diagnosable
    by callers instead of silently shrinking the pruned candidate pool.
    """

    def __init__(self, groups=(), truncated: bool = False):
        super().__init__(groups)
        self.truncated = bool(truncated)


def _bitmask(parts: Sequence[int]) -> int:
    mask = 0
    for p in parts:
        mask |= 1 << p
    return mask


def find_all_groups(alloc: Allocation, max_groups: int = 20000) -> GroupSearchResult:
    """Alg. 2 FindAllGroups: every worker set tiling the dataset exactly.

    Exact-cover enumeration with canonical ordering (always extend via the
    lowest uncovered partition) so each group is produced exactly once.
    Partition sets are bitmasks; workers with empty assignment are skipped.

    Returns a :class:`GroupSearchResult`; when the enumeration is cut off at
    ``max_groups`` the result's ``truncated`` flag is set and a RuntimeWarning
    is emitted — downstream pruning then sees only a partial candidate pool,
    which can weaken the final disjoint cover.
    """
    full = (1 << alloc.k) - 1
    masks = [_bitmask(ps) for ps in alloc.partitions]
    # workers holding partition p with non-empty assignment
    by_part: list[list[int]] = [[] for _ in range(alloc.k)]
    for w, mask in enumerate(masks):
        for p in alloc.partitions[w]:
            by_part[p].append(w)

    out: list[tuple[int, ...]] = []
    truncated = False

    def rec(remaining: int, chosen: list[int]) -> None:
        nonlocal truncated
        if len(out) >= max_groups:
            truncated = True
            return
        if remaining == 0:
            out.append(tuple(sorted(chosen)))
            return
        lowest = (remaining & -remaining).bit_length() - 1
        for w in by_part[lowest]:
            mw = masks[w]
            if mw & ~remaining:  # would double-cover
                continue
            chosen.append(w)
            rec(remaining & ~mw, chosen)
            chosen.pop()

    rec(full, [])
    if truncated:
        warnings.warn(
            f"find_all_groups stopped at max_groups={max_groups} "
            f"(m={alloc.m}, k={alloc.k}); the group cover is built from a "
            "truncated candidate pool",
            RuntimeWarning,
            stacklevel=2,
        )
    return GroupSearchResult(out, truncated=truncated)


def find_greedy_groups(alloc: Allocation, max_groups: int | None = None) -> GroupSearchResult:
    """O(m·k) greedy disjoint group cover for large m.

    Exploits the Eq. 6 structure: every worker covers a contiguous arc of
    the partition circle, so a group is a chain of arcs that closes exactly
    after one lap.  Greedy chaining — from each candidate origin, repeatedly
    take the longest unused arc starting where the previous one ended —
    finds pairwise-disjoint tilings directly (no enumeration + prune), at
    the cost of possibly fewer groups than exhaustive search; Alg. 3
    degrades gracefully (Ē is coded at s−P for whatever P materializes).

    Workers whose partition set is not a contiguous arc never extend a
    chain (their mask won't match any start), so the function is safe — not
    just fast — on arbitrary allocations: it finds what chains exist.
    """
    k = alloc.k
    cap = alloc.s + 1 if max_groups is None else int(max_groups)
    # arc view: start + length of each worker's assignment (allocation order)
    arcs: dict[int, list[int]] = {}  # start partition -> workers, longest first
    length = {}
    for w, parts in enumerate(alloc.partitions):
        n = len(parts)
        if n == 0:
            continue
        start = parts[0]
        # verify contiguity mod k (cyclic assignment guarantees it; foreign
        # allocations may not)
        if any(parts[i] != (start + i) % k for i in range(n)):
            continue
        arcs.setdefault(start, []).append(w)
        length[w] = n
    for ws in arcs.values():
        ws.sort(key=lambda w: -length[w])

    used: set[int] = set()
    out: list[tuple[int, ...]] = []
    origins = sorted(arcs)
    for origin in origins:
        while len(out) < cap:
            chain: list[int] = []
            pos, covered = origin, 0
            ok = False
            while True:
                cand = [w for w in arcs.get(pos, ()) if w not in used and w not in chain]
                if not cand:
                    break
                w = cand[0]  # longest-first: fewest workers per group
                chain.append(w)
                covered += length[w]
                pos = (pos + length[w]) % k
                if covered == k and pos == origin:
                    ok = True
                    break
                if covered > k:
                    break
            if not ok:
                break
            used.update(chain)
            out.append(tuple(sorted(chain)))
        if len(out) >= cap:
            break
    return GroupSearchResult(out, truncated=False)


def prune_groups(groups: Sequence[tuple[int, ...]]) -> list[tuple[int, ...]]:
    """Alg. 2 PruneGroups: greedily drop the group intersecting the most
    others until the survivors are pairwise worker-disjoint (condition ★★)."""
    pool = [set(g) for g in groups]
    keep = list(range(len(pool)))

    def n_intersections(i: int) -> int:
        return sum(1 for j in keep if j != i and pool[i] & pool[j])

    while True:
        counts = {i: n_intersections(i) for i in keep}
        worst = max(counts.items(), key=lambda kv: (kv[1], -len(pool[kv[0]]), kv[0]), default=None)
        if worst is None or worst[1] == 0:
            break
        keep.remove(worst[0])
    return [tuple(sorted(pool[i])) for i in keep]


def build_group_based(
    k: int, s: int, c: Sequence[float], rng: np.random.Generator | int | None = 0,
    max_load: int | None = None,
) -> CodingScheme:
    """Alg. 3: group rows are 0/1 indicators; Ē coded via Alg. 1 at s−P.

    Exhaustive Alg. 2 enumeration + pruning up to
    :data:`GREEDY_GROUP_THRESHOLD` workers (bit-identical to the paper's
    construction at paper scale); the greedy arc-chaining cover beyond it.
    """
    rng = np.random.default_rng(rng) if not isinstance(rng, np.random.Generator) else rng
    alloc = allocate(k, s, c, max_load)
    return group_code_from_alloc(alloc, s, rng)


def group_code_from_alloc(
    alloc: Allocation, s: int, rng: np.random.Generator
) -> CodingScheme:
    """Group cover + Alg. 3 coefficients for a GIVEN allocation — the piece
    membership transitions reuse on a stability-remapped assignment (whose
    arcs are no longer contiguous; the cover finds whatever tilings remain,
    and P = 0 degrades to plain Alg. 1 at full s)."""
    k = alloc.k
    if alloc.m > GREEDY_GROUP_THRESHOLD:
        groups = list(find_greedy_groups(alloc))
    else:
        groups = prune_groups(find_all_groups(alloc))
    # More than s+1 disjoint groups cannot exist (each holds one copy of each
    # partition and only s+1 copies exist); keep at most s+1 deterministically.
    groups = sorted(groups, key=len)[: s + 1]
    P = len(groups)

    m = alloc.m
    B = np.zeros((m, k), dtype=np.float64)
    in_group = set()
    for g in groups:
        in_group.update(g)
        for w in g:
            B[w, list(alloc.partitions[w])] = 1.0

    ebar = [w for w in range(m) if w not in in_group and alloc.counts[w] > 0]
    C = None
    if ebar:
        s_rem = s - P
        if s_rem < 0:
            # P == s+1 uses every copy; no partitions can remain outside.
            raise AssertionError("non-empty Ē with P > s is impossible for a valid allocation")
        # Sub-allocation restricted to Ē: every partition has exactly s+1−P
        # holders there (the P disjoint groups each hold exactly one copy).
        sub_counts = tuple(alloc.counts[w] for w in ebar)
        sub_parts = tuple(alloc.partitions[w] for w in ebar)
        sub_alloc = Allocation(k=k, s=s_rem, counts=sub_counts, partitions=sub_parts)
        B_sub, C = _build_from_support(sub_alloc, rng)
        for row, w in enumerate(ebar):
            B[w] = B_sub[row]

    return CodingScheme(name="group_based", B=B, allocation=alloc, s=s, groups=tuple(groups), C=C)
