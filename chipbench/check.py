"""The comparison that decides ``correct``: the program's first training
steps against the reference's, number by number, each under its limit.

- ``loss_gap``: the largest relative gap of a step's loss.
- ``grad_gap``: by the worst leaf, the gap between the norms of the first
  gradient as the optimizer got it, over the reference's norm of that leaf
  or of the median leaf, whichever is larger.
- ``update_gap``: the same for each leaf's change over the checked steps,
  leaving out the leaves whose reference gradient is under a thousandth of
  the median leaf's (round-off alone moves them under Adam).
- ``stale_leaves``: the program's served leaves that are not, bit for bit,
  its own f32 master weights rounded to the served dtype, after the checked
  steps and again once the window has closed.  ``update_gap`` reads the
  master; this ties what the forward reads to it.  Its limit is 0.

A limit file (``limits/<workload>.json``) gives each number's limit; the
readings it was set from are in PERF.md.
"""

from __future__ import annotations

import math
import statistics

from chipbench.reference.train import Readings

NUMBERS = ("loss_gap", "grad_gap", "update_gap", "stale_leaves")
TINY = 1e-3  # a leaf whose reference gradient is under this share of the median's


def _worst(prog: dict[str, float], ref: dict[str, float], leaves) -> tuple[float, str]:
    med = statistics.median(ref[k] for k in leaves)
    worst, at = 0.0, ""
    for k in leaves:
        p = prog.get(k, math.nan)
        gap = abs(p - ref[k]) / max(ref[k], med, 1e-30)
        if not gap <= worst:  # NaN is worst
            worst, at = gap, k
    return worst, at


def compare(prog: Readings, ref: Readings) -> dict[str, float | str]:
    """The numbers (and the leaf each worst one came from)."""
    if len(prog.losses) != len(ref.losses):
        raise ValueError(f"{len(prog.losses)} program steps against {len(ref.losses)}")
    loss_gap = max(
        (abs(p - r) / abs(r) if math.isfinite(p) else math.inf)
        for p, r in zip(prog.losses, ref.losses)
    )
    grad_gap, grad_at = _worst(prog.grad, ref.grad, sorted(ref.grad))
    med = statistics.median(ref.grad.values())
    moved = sorted(k for k, g in ref.grad.items() if g >= TINY * med)
    update_gap, update_at = _worst(prog.update, ref.update, moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "update_gap": update_gap,
            "stale_leaves": prog.stale,
            "grad_worst_leaf": grad_at, "update_worst_leaf": update_at,
            "update_leaves_left_out": len(ref.grad) - len(moved)}


def judge(numbers: dict, limits: dict[str, float]) -> tuple[bool, list[tuple[str, float, float]]]:
    """(every number finite and within its limit, [(name, number, limit)])."""
    rows = [(n, float(numbers[n]), float(limits[n])) for n in NUMBERS]
    return all(math.isfinite(v) and v <= lim for _, v, lim in rows), rows
