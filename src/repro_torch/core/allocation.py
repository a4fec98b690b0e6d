"""Heterogeneity-aware data-partition allocation (paper §IV-A, Eq. 5/6).

The dataset is split into ``k`` equal partitions; to tolerate ``s`` full
stragglers every partition must be replicated on ``s+1`` distinct workers.
Worker ``i`` with throughput ``c_i`` receives

    n_i = k*(s+1) * c_i / sum(c)          (Eq. 5)

partitions, assigned cyclically (Eq. 6) so that consecutive workers cover
consecutive arcs of the partition circle and every partition lands on exactly
``s+1`` distinct workers.

The paper assumes Eq. 5 yields integers; real clusters do not.  We integerize
with largest-remainder rounding subject to ``sum(n) == k*(s+1)`` and
``n_i <= k`` (an arc longer than the circle would put two copies of one
partition on the same worker, which is useless for straggler tolerance).
"""

from __future__ import annotations

import dataclasses
import itertools
from functools import cached_property
from typing import Sequence

import numpy as np

__all__ = [
    "Allocation",
    "RemapResult",
    "proportional_counts",
    "cyclic_assignment",
    "allocate",
    "remap_allocation",
    "count_moved",
    "support_matrix",
]


@dataclasses.dataclass(frozen=True)
class Allocation:
    """Partition→worker assignment.

    Attributes:
      k: number of data partitions.
      s: number of tolerated stragglers.
      counts: ``n_i`` per worker, shape (m,).
      partitions: tuple of per-worker tuples of partition ids (len n_i each).
    """

    k: int
    s: int
    counts: tuple[int, ...]
    partitions: tuple[tuple[int, ...], ...]

    @property
    def m(self) -> int:
        return len(self.counts)

    @cached_property
    def _flat(self) -> tuple[np.ndarray, np.ndarray]:
        """(worker_ids, partition_ids) of every (worker, partition) pair, in
        allocation order — the vectorized view every large-m consumer
        (support, holders, plan build) derives from in one pass."""
        counts = np.asarray(self.counts, dtype=np.int64)
        workers = np.repeat(np.arange(self.m, dtype=np.int64), counts)
        pids = np.fromiter(
            itertools.chain.from_iterable(self.partitions), dtype=np.int64,
            count=int(counts.sum()),
        )
        return workers, pids

    def holders(self, j: int) -> tuple[int, ...]:
        """Workers holding partition ``j`` (exactly s+1 of them)."""
        workers, pids = self._flat
        return tuple(int(w) for w in np.sort(workers[pids == j]))

    def holders_matrix(self) -> np.ndarray:
        """(k, s+1) int64 holders of every partition, workers ascending —
        the batched view Alg. 1 consumes (one pass, no per-partition scan).
        Raises when any partition does not have exactly s+1 holders."""
        workers, pids = self._flat
        per_part = np.bincount(pids, minlength=self.k)
        if np.any(per_part != self.s + 1):
            j = int(np.argmax(per_part != self.s + 1))
            raise ValueError(
                f"partition {j} has {int(per_part[j])} holders, expected s+1={self.s + 1}"
            )
        order = np.lexsort((workers, pids))  # partition-major, worker ascending
        return workers[order].reshape(self.k, self.s + 1)

    def support(self) -> np.ndarray:
        return support_matrix(self)


def proportional_counts(
    k: int, s: int, c: Sequence[float], max_per_worker: int | None = None
) -> np.ndarray:
    """Integerized Eq. 5: ``n_i ∝ c_i`` with ``sum(n) = k*(s+1)``, ``n_i <= cap``.

    Largest-remainder rounding; overflow beyond the per-worker cap is
    re-distributed.  ``max_per_worker`` (default k) lets the trainer bound
    load skew so elastic re-allocations never outgrow the fixed slot
    capacity (shape stability => no recompilation); a binding cap costs a
    bounded deviation from the Thm. 5 optimum, which we accept by design.
    """
    c = np.asarray(c, dtype=np.float64)
    m = c.shape[0]
    if m <= s:
        raise ValueError(f"need m > s, got m={m}, s={s}")
    if np.any(c <= 0):
        raise ValueError("throughputs must be positive")
    total = k * (s + 1)
    cap = k if max_per_worker is None else min(k, int(max_per_worker))
    if total > m * cap:
        raise ValueError(f"k*(s+1)={total} copies cannot fit on m={m} workers with n_i<={cap}")

    ideal = total * c / c.sum()
    n = np.minimum(np.floor(ideal).astype(np.int64), cap)
    # Largest-remainder distribution of the leftover copies: round-robin in
    # remainder-priority order, skipping workers at cap.  Vectorized as a
    # water-fill — after t full rounds worker w (room r_w) has received
    # min(r_w, t) extras; binary-search the last full round, then hand the
    # remainder to the first still-open workers in priority order.
    leftover = total - int(n.sum())
    if leftover > 0:
        remainder = ideal - np.floor(ideal)
        order = np.argsort(-remainder, kind="stable")
        room = (cap - n)[order].astype(np.int64)
        rounds = np.arange(int(room.max()) + 1)
        given = np.minimum(room[None, :], rounds[:, None]).sum(axis=1)
        t = int(np.searchsorted(given, leftover, side="right") - 1)
        extra = np.minimum(room, t)
        partial = leftover - int(given[t])
        if partial > 0:
            open_idx = np.flatnonzero(room > t)[:partial]
            extra[open_idx] += 1
        n[order] += extra
    assert int(n.sum()) == total
    return n


def cyclic_assignment(k: int, counts: Sequence[int]) -> tuple[tuple[int, ...], ...]:
    """Eq. 6: consecutive arcs on the partition circle.

    Worker i gets partitions ``{(n'_i + 1) .. (n'_i + n_i)} mod k`` where
    ``n'_i = sum_{j<i} n_j``.  Because the arcs are laid end-to-end and the
    total length is ``k*(s+1)``, every partition is covered exactly ``s+1``
    times, each time by a different worker (since ``n_i <= k``).
    """
    counts_arr = np.asarray(counts, dtype=np.int64)
    if counts_arr.size and int(counts_arr.max(initial=0)) > k:
        raise ValueError(f"n_i={int(counts_arr.max())} exceeds k={k}")
    # vectorized arcs: laid end-to-end, worker i's arc starts where i−1's
    # ended, so the flat partition sequence is simply 0,1,2,... mod k
    flat = np.arange(int(counts_arr.sum())) % k
    bounds = np.cumsum(counts_arr)[:-1]
    return tuple(
        tuple(int(p) for p in chunk) for chunk in np.split(flat, bounds)
    )


def allocate(
    k: int, s: int, c: Sequence[float], max_per_worker: int | None = None
) -> Allocation:
    """Full heterogeneity-aware allocation: Eq. 5 counts + Eq. 6 cyclic arcs."""
    counts = proportional_counts(k, s, c, max_per_worker)
    parts = cyclic_assignment(k, counts)
    return Allocation(k=k, s=s, counts=tuple(int(x) for x in counts), partitions=parts)


def uniform_allocation(k: int, s: int, m: int) -> Allocation:
    """Homogeneous allocation (Tandon's cyclic scheme when k == m)."""
    return allocate(k, s, [1.0] * m)


@dataclasses.dataclass(frozen=True)
class RemapResult:
    """Outcome of a membership-preserving allocation remap.

    Attributes:
      allocation: the new assignment (every partition has exactly s+1
        distinct holders, worker i holds ``counts_new[i]`` partitions).
      moved: copies newly acquired by RETAINED workers — the data that must
        actually move between surviving machines (a joining worker's
        bootstrap fetch is not "movement" of existing state).
      bound: the documented stability bound on ``moved``:
        ``sum_i max(0, n_new_i - n_old_i)`` over retained workers, plus one
        re-acquisition per forced shed.  ``moved <= bound`` always holds.
      forced_sheds: kept copies the completion search had to give up (0 in
        every observed case; the bound accounts for them if they happen).
    """

    allocation: Allocation
    moved: int
    bound: int
    forced_sheds: int


def count_moved(
    prev: Allocation, new: Allocation, old_of_new: Sequence[int | None]
) -> int:
    """Copies acquired by retained workers: |new_parts(i) \\ old_parts(o)|
    summed over new workers ``i`` retained from old index ``o``."""
    moved = 0
    for i, o in enumerate(old_of_new):
        if o is None:
            continue
        moved += len(set(new.partitions[i]) - set(prev.partitions[o]))
    return moved


def remap_allocation(
    prev: Allocation,
    counts_new: Sequence[int],
    old_of_new: Sequence[int | None],
) -> RemapResult:
    """Membership-preserving reassignment: grow/shrink the worker set while
    keeping retained workers' partitions wherever the new load counts allow.

    ``old_of_new[i]`` is new worker i's index in ``prev`` (None = joined
    fresh).  The transition protocol (DESIGN.md §8):

      1. every retained worker KEEPS ``min(n_old, n_new)`` of its partitions
         — when it must shed, copies of the partitions with the most other
         surviving holders go first (they create the least deficit);
      2. the per-partition deficits (each partition must end with exactly
         ``s+1`` distinct holders) are filled from workers with spare
         capacity, most-spare-first; a dead end (every spare worker already
         holds the partition) is repaired by an augmenting chain that only
         re-routes *newly assigned* copies, never kept ones.

    Step 1 fixes the movement bound exactly: a retained worker acquires at
    most ``max(0, n_new − n_old)`` partitions, so total retained-worker
    movement is ``Σ max(0, Δn)`` — independent of k and of how many workers
    churned.  Departed load lands on joiners and on retained workers whose
    allocation share grew, never shuffles copies that could have stayed.
    """
    k, s = prev.k, prev.s
    m_new = len(old_of_new)
    counts = np.asarray(counts_new, dtype=np.int64)
    if counts.shape != (m_new,):
        raise ValueError(f"counts_new length {counts.shape} != len(old_of_new)={m_new}")
    if int(counts.sum()) != k * (s + 1):
        raise ValueError(f"sum(counts_new)={int(counts.sum())} != k*(s+1)={k * (s + 1)}")
    if counts.size and int(counts.max(initial=0)) > k:
        raise ValueError(f"n_i={int(counts.max())} exceeds k={k}")

    # --- step 1: kept sets + shed selection -------------------------------
    survived = np.zeros(k, dtype=np.int64)
    kept: list[list[int]] = []
    for i, o in enumerate(old_of_new):
        parts = list(prev.partitions[o]) if o is not None else []
        kept.append(parts)
        for p in parts:
            survived[p] += 1
    bound = 0
    for i, o in enumerate(old_of_new):
        if o is None:
            continue
        excess = len(kept[i]) - int(counts[i])
        bound += max(0, -excess)
        for _ in range(max(0, excess)):
            # shed the copy whose partition keeps the most other holders
            p = max(kept[i], key=lambda q: (survived[q], q))
            kept[i].remove(p)
            survived[p] -= 1

    # --- step 2: fill deficits, most-spare-first, augment on dead ends ----
    holds = [set(ps) for ps in kept]
    new_assign: list[list[int]] = [[] for _ in range(m_new)]
    spare = counts - np.array([len(ps) for ps in kept], dtype=np.int64)
    deficit = (s + 1) - survived
    if np.any(deficit < 0):  # prev had >s+1 holders somewhere: invalid input
        j = int(np.argmin(deficit))
        raise ValueError(f"partition {j} had more than s+1={s + 1} holders")
    forced_sheds = 0

    def _take(i: int, j: int) -> None:
        new_assign[i].append(j)
        holds[i].add(j)
        spare[i] -= 1

    def _augment(j: int) -> bool:
        """Free one unit of capacity on a worker not holding ``j`` by
        re-routing newly assigned copies along a BFS chain ending at a
        worker with spare capacity.  Kept copies never move."""
        parent: dict[int, tuple[int, int]] = {}  # v -> (u, q): v offloads q to u
        frontier = [u for u in range(m_new) if spare[u] > 0]
        seen = set(frontier)
        while frontier:
            nxt: list[int] = []
            for u in frontier:
                for v in range(m_new):
                    if v in seen:
                        continue
                    q = next((q for q in new_assign[v] if q not in holds[u]), None)
                    if q is None:
                        continue
                    parent[v] = (u, q)
                    if j not in holds[v]:
                        # walk the chain: shift each re-routable copy forward
                        while v in parent:
                            u2, q2 = parent[v]
                            new_assign[v].remove(q2)
                            holds[v].discard(q2)
                            spare[v] += 1
                            _take(u2, q2)
                            v = u2
                        return True
                    seen.add(v)
                    nxt.append(v)
            frontier = nxt
        return False

    order = sorted(range(k), key=lambda j: (-deficit[j], j))
    pending = [j for j in order for _ in range(int(deficit[j]))]
    guard = 0
    while pending:
        j = pending.pop(0)
        open_workers = [i for i in range(m_new) if spare[i] > 0 and j not in holds[i]]
        if open_workers:
            _take(max(open_workers, key=lambda i: (spare[i], -i)), j)
            continue
        if _augment(j):
            i = max(
                (i for i in range(m_new) if spare[i] > 0 and j not in holds[i]),
                key=lambda i: (spare[i], -i),
            )
            _take(i, j)
            continue
        # genuinely stuck: give up one kept copy elsewhere (counts as one
        # extra move in the bound) and retry both partitions
        guard += 1
        if guard > k * (s + 1):
            raise RuntimeError("remap_allocation could not complete the assignment")
        victim = next(
            i for i in range(m_new)
            if j not in holds[i] and any(q != j for q in kept[i])
        )
        q = max((q for q in kept[victim] if q != j), key=lambda q: q)
        kept[victim].remove(q)
        holds[victim].discard(q)
        spare[victim] += 1
        forced_sheds += 1  # the +1 re-acquisition lands in the final bound
        pending.insert(0, j)
        pending.append(q)

    partitions = tuple(
        tuple(kept[i]) + tuple(sorted(new_assign[i])) for i in range(m_new)
    )
    alloc = Allocation(
        k=k, s=s, counts=tuple(int(x) for x in counts), partitions=partitions
    )
    # honest movement: what a retained worker holds NOW that it did not hold
    # before (re-acquiring its own forced-shed copy is not a fetch)
    moved = count_moved(prev, alloc, old_of_new)
    assert moved <= bound + forced_sheds, (moved, bound, forced_sheds)
    return RemapResult(
        allocation=alloc, moved=moved, bound=bound + forced_sheds,
        forced_sheds=forced_sheds,
    )


def support_matrix(alloc: Allocation) -> np.ndarray:
    """Boolean (m, k) support structure of B (Eq. 7)."""
    sup = np.zeros((alloc.m, alloc.k), dtype=bool)
    workers, pids = alloc._flat
    sup[workers, pids] = True
    return sup
