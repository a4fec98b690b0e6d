"""Per-worker straggler forensics (DESIGN.md §10).

The paper's contribution is *timing* — which workers straggle, when their
partial work arrives, how far the estimated speeds ``c`` drift from truth —
but per-step metrics only surface aggregates.  :class:`StragglerForensics`
keeps the per-worker ledger those aggregates throw away:

- **arrival outcomes** per iteration: did worker ``w`` hold load, finish by
  the chosen step instant τ, or arrive late/never;
- **blame**: a late worker on a step that was *hurt* (skipped, decoded
  inexactly, or capped at its deadline) is blamed for it — the top-k blame
  table answers "which worker's misestimation triggered the deadline
  decodes";
- **estimate drift**: per-iteration relative error of the normalized EWMA
  estimate against the normalized true speeds (both sides scale-free — the
  estimator never learns absolute units);
- **rebalance/membership attribution**: every elastic re-encode and churn
  transition is logged with the drift snapshot that preceded it.

Feed it live (the trainer calls :meth:`observe_step` per step when tracing
is on) or rebuild it offline from a tracer JSONL log with
:meth:`from_records` — ``repro_torch.launch.obs_report`` does the latter.

Worker indices are only meaningful within one membership epoch: a churn
transition compacts/extends the worker set, so :meth:`resize` restarts the
per-worker ledger (the pre-churn table is archived in ``epochs``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["StragglerForensics", "WorkerLedger"]

_TOL = 1e-12
_FLUSH_AT = 4096  # pending-snapshot cap: bounds deferred-fold memory


@dataclasses.dataclass
class WorkerLedger:
    """One worker's accumulated forensics within a membership epoch."""

    worker: int
    held: int = 0  # iterations where the worker held load
    done: int = 0  # ... and finished by the chosen step instant τ
    late: int = 0  # ... and did not (deadline miss / fault)
    blame: int = 0  # late on a step that was hurt (skipped/inexact/capped)
    blame_inexact: int = 0  # late specifically on an inexact decode
    load: float = 0.0  # Σ partitions held
    finish_sum: float = 0.0  # Σ finite finish times (arrival timeline mass)
    finish_n: int = 0
    drift_sum: float = 0.0  # Σ (ĉ_norm / c_norm − 1)
    drift_abs_sum: float = 0.0
    drift_n: int = 0

    def row(self, steps: int, total_load: float) -> dict[str, float]:
        """Report row (rates derived from the raw counters)."""
        return {
            "worker": self.worker,
            "held": self.held,
            "done": self.done,
            "late": self.late,
            "blame": self.blame,
            "blame_inexact": self.blame_inexact,
            "late_frac": self.late / self.held if self.held else 0.0,
            "blame_frac": self.blame / max(steps, 1),
            "load_share": self.load / total_load if total_load > 0 else 0.0,
            "mean_finish_s": self.finish_sum / self.finish_n if self.finish_n else float("nan"),
            "mean_drift": self.drift_sum / self.drift_n if self.drift_n else float("nan"),
            "mean_abs_drift": (
                self.drift_abs_sum / self.drift_n if self.drift_n else float("nan")
            ),
        }


class StragglerForensics:
    """Per-worker ledger over one training run (see module docstring)."""

    def __init__(self, m: int, true_speeds=None):
        self.epochs: list[list[dict]] = []  # archived pre-churn blame tables
        self.rebalances: list[dict] = []
        self.transitions: list[dict] = []
        # -- fault ledger (DESIGN.md §11): keyed by ORIGINAL worker id and
        # kept OUTSIDE the per-epoch restart — fault identities survive the
        # membership transitions they themselves cause
        self.faults: list[dict] = []  # injected fault realizations
        self.convictions: list[dict] = []
        self.fault_evictions: list[dict] = []
        self.readmissions: list[dict] = []
        self.suspicion_timeline: dict[int, list[tuple[int, float]]] = {}
        self.retries: dict[int, int] = {}  # orig -> retried uploads
        self.quarantines: dict[int, int] = {}  # orig -> repair exclusions
        self.nonfinite_steps: list[int] = []
        self._start(int(m), true_speeds)

    def _start(self, m: int, true_speeds) -> None:
        self.m = m
        self.true_speeds = (
            np.asarray(true_speeds, np.float64) if true_speeds is not None else None
        )
        # observe_step runs on the hot step path when tracing is on, so it
        # only appends a snapshot; the per-worker fold happens vectorized
        # over the whole pending batch at report time (or every _FLUSH_AT
        # steps, bounding memory)
        self._pending: list[tuple] = []
        self._held = np.zeros(m, np.int64)
        self._done = np.zeros(m, np.int64)
        self._late = np.zeros(m, np.int64)
        self._blame = np.zeros(m, np.int64)
        self._blame_inexact = np.zeros(m, np.int64)
        self._load = np.zeros(m, np.float64)
        self._finish_sum = np.zeros(m, np.float64)
        self._finish_n = np.zeros(m, np.int64)
        self._drift_sum = np.zeros(m, np.float64)
        self._drift_abs_sum = np.zeros(m, np.float64)
        self._drift_n = 0
        self._steps = 0
        self._hurt = 0

    @property
    def steps(self) -> int:
        return self._steps + len(self._pending)

    @property
    def hurt_steps(self) -> int:
        self._flush()
        return self._hurt

    @property
    def workers(self) -> list[WorkerLedger]:
        """Per-worker ledgers materialized from the accumulators."""
        self._flush()
        return [
            WorkerLedger(
                w, held=int(self._held[w]), done=int(self._done[w]),
                late=int(self._late[w]), blame=int(self._blame[w]),
                blame_inexact=int(self._blame_inexact[w]),
                load=float(self._load[w]),
                finish_sum=float(self._finish_sum[w]),
                finish_n=int(self._finish_n[w]),
                drift_sum=float(self._drift_sum[w]),
                drift_abs_sum=float(self._drift_abs_sum[w]),
                drift_n=self._drift_n,
            )
            for w in range(self.m)
        ]

    # -- live feed -----------------------------------------------------------

    def observe_step(
        self,
        step: int,
        *,
        tau: float,
        deadline: float,
        exact: bool,
        skipped: bool,
        finish,
        load,
        c_est,
        c_true=None,
    ) -> None:
        """Record one iteration: per-worker arrival outcomes against the
        chosen step instant τ, plus the estimate-drift sample.  Hot-path
        cheap — copies the snapshot and defers the fold to :meth:`_flush`."""
        self._pending.append((
            float(tau), float(deadline), bool(exact), bool(skipped),
            np.array(finish, np.float64), np.array(load, np.float64),
            np.array(c_est, np.float64),
            np.array(c_true, np.float64) if c_true is not None else None,
        ))
        if len(self._pending) >= _FLUSH_AT:
            self._flush()

    def _flush(self) -> None:
        """Fold every pending iteration into the per-worker accumulators,
        vectorized over the batch."""
        if not self._pending:
            return
        pend, self._pending = self._pending, []
        tau = np.array([p[0] for p in pend])
        deadline = np.array([p[1] for p in pend])
        exact = np.array([p[2] for p in pend])
        skipped = np.array([p[3] for p in pend])
        finish = np.stack([p[4] for p in pend])  # (B, m)
        load = np.stack([p[5] for p in pend])
        c_est = np.stack([p[6] for p in pend])
        self._steps += len(pend)
        # a step is "hurt" when timing failed it: nothing exact decoded, it
        # was skipped outright, or the deadline (not an arrival) set τ
        hurt = skipped | ~exact | (np.isfinite(deadline) & (tau >= deadline - _TOL))
        self._hurt += int(hurt.sum())

        held = load > 0
        fin_ok = np.isfinite(finish)
        on_time = held & fin_ok & (finish <= tau[:, None] + _TOL)
        late = held & ~on_time
        self._held += held.sum(0)
        self._done += on_time.sum(0)
        self._late += late.sum(0)
        self._blame += (late & hurt[:, None]).sum(0)
        self._blame_inexact += (late & (~exact & ~skipped)[:, None]).sum(0)
        self._load += np.where(held, load, 0.0).sum(0)
        self._finish_sum += np.where(fin_ok, finish, 0.0).sum(0)
        self._finish_n += fin_ok.sum(0)

        truths = [p[7] if p[7] is not None else self.true_speeds for p in pend]
        ok = [
            i for i, t in enumerate(truths)
            if t is not None and t.shape == c_est[i].shape and np.all(t > 0)
            and c_est[i].mean() > 0
        ]
        if ok:
            ce = c_est[ok]
            tv = np.stack([truths[i] for i in ok])
            drift = (ce / ce.mean(1, keepdims=True)) / (tv / tv.mean(1, keepdims=True)) - 1.0
            self._drift_sum += drift.sum(0)
            self._drift_abs_sum += np.abs(drift).sum(0)
            self._drift_n += len(ok)

    def on_rebalance(self, step: int, c_est) -> None:
        """An elastic re-encode was applied at ``step`` with estimate
        ``c_est`` — record it with the drift snapshot that triggered it."""
        self._flush()
        row = {"step": int(step), "c_est": [float(x) for x in np.asarray(c_est).ravel()]}
        row["mean_abs_drift"] = (
            float(np.mean(np.abs(self._drift_sum / self._drift_n)))
            if self._drift_n else float("nan")
        )
        self.rebalances.append(row)

    def on_membership(self, step: int, m_after: int, stats: dict | None = None,
                      true_speeds=None) -> None:
        """A churn transition: archive the current epoch's table and restart
        the ledger at the new worker count."""
        self.transitions.append({"step": int(step), "m_after": int(m_after),
                                 **(stats or {})})
        self.epochs.append(self.blame_table())
        self._start(m_after, true_speeds)

    # -- fault ledger (live feed from FaultyClusterSim / FaultSupervisor) ----

    def on_fault(self, step: int, orig: int, kind: str) -> None:
        self.faults.append({"step": int(step), "worker": int(orig), "kind": kind})

    def on_suspicion(self, step: int, orig: int, suspicion: float) -> None:
        self.suspicion_timeline.setdefault(int(orig), []).append(
            (int(step), float(suspicion))
        )

    def on_conviction(self, step: int, orig: int, reason: str,
                      suspicion: float) -> None:
        self.convictions.append({
            "step": int(step), "worker": int(orig), "reason": reason,
            "suspicion": float(suspicion),
        })

    def on_eviction(self, step: int, orig: int) -> None:
        self.fault_evictions.append({"step": int(step), "worker": int(orig)})

    def on_readmit(self, step: int, orig: int) -> None:
        self.readmissions.append({"step": int(step), "worker": int(orig)})

    def on_retry(self, step: int, orig: int, n: int) -> None:
        self.retries[int(orig)] = self.retries.get(int(orig), 0) + int(n)

    def on_quarantine(self, step: int, orig: int) -> None:
        self.quarantines[int(orig)] = self.quarantines.get(int(orig), 0) + 1

    def on_nonfinite(self, step: int) -> None:
        self.nonfinite_steps.append(int(step))

    def fault_report(self) -> dict:
        """The §11 evidence trail: per-worker suspicion peaks + timelines,
        convictions, evictions/re-admissions, retried uploads, quarantined
        slots, and non-finite step indices (all workers by ORIGINAL id)."""
        timeline = {
            orig: {
                "peak": max(s for _, s in tl),
                "last_step": tl[-1][0],
                "samples": len(tl),
            }
            for orig, tl in sorted(self.suspicion_timeline.items())
        }
        return {
            "faults": list(self.faults),
            "convictions": list(self.convictions),
            "evictions": list(self.fault_evictions),
            "readmissions": list(self.readmissions),
            "suspicion": timeline,
            "retries": dict(sorted(self.retries.items())),
            "quarantines": dict(sorted(self.quarantines.items())),
            "nonfinite_steps": list(self.nonfinite_steps),
        }

    # -- reports -------------------------------------------------------------

    def blame_table(self, top_k: int | None = None) -> list[dict]:
        """Per-worker rows, most blamed first (ties: most late, then most
        loaded) — the "who caused the deadline decodes" report."""
        total_load = float(sum(wl.load for wl in self.workers))
        rows = [wl.row(self.steps, total_load) for wl in self.workers]
        rows.sort(key=lambda r: (-r["blame"], -r["late"], -r["load_share"]))
        return rows[:top_k] if top_k is not None else rows

    def summary(self) -> dict[str, float]:
        return {
            "steps": float(self.steps),
            "hurt_steps": float(self.hurt_steps),
            "rebalances": float(len(self.rebalances)),
            "transitions": float(len(self.transitions)),
            "m": float(self.m),
        }

    # -- offline assembly ----------------------------------------------------

    @classmethod
    def from_records(cls, records: list[dict]) -> "StragglerForensics":
        """Rebuild forensics from parsed tracer JSONL records (the
        ``train.step`` event log + rebalance/churn instants), in recorded
        order.  Unknown record names are ignored, so the same log can carry
        serving spans alongside."""
        fx: StragglerForensics | None = None
        for rec in records:
            name, args = rec.get("name"), rec.get("args", {})
            if name == "train.step" and rec.get("kind") == "event":
                m = len(args["load"])
                if fx is None:
                    fx = cls(m)
                elif fx.m != m:  # churn without an observed transition record
                    fx.on_membership(int(args["step"]), m)
                fx.observe_step(
                    int(args["step"]),
                    tau=float(args["tau"]),
                    deadline=float(args["deadline"]),
                    exact=bool(args["exact"]),
                    skipped=bool(args["skipped"]),
                    finish=args["finish"],
                    load=args["load"],
                    c_est=args["c_est"],
                    c_true=args.get("c_true"),
                )
            elif name == "elastic.rebalance" and fx is not None:
                fx.on_rebalance(int(args.get("step", -1)), args.get("c_est", []))
            elif name == "churn" and fx is not None:
                fx.on_membership(
                    int(args.get("step", -1)), int(args.get("m_after", fx.m)), args
                )
        if fx is None:
            fx = cls(0)
        # second pass: the fault ledger is keyed by original worker id and
        # independent of the per-epoch tables, so its instants fold in any
        # order relative to the train.step stream (including before step 0)
        for rec in records:
            if rec.get("kind") != "instant":
                continue
            name, args = rec.get("name"), rec.get("args", {})
            step = int(args.get("step", -1))
            orig = int(args.get("orig", args.get("worker", -1)))
            if name == "fault.inject":
                fx.on_fault(step, orig, args.get("kind", "?"))
            elif name == "fault.suspicion":
                fx.on_suspicion(step, orig, float(args.get("suspicion", 0.0)))
            elif name == "fault.convict":
                fx.on_conviction(step, orig, args.get("reason", "?"),
                                 float(args.get("suspicion", 0.0)))
            elif name == "fault.evict":
                fx.on_eviction(step, orig)
            elif name == "fault.readmit":
                fx.on_readmit(step, orig)
            elif name == "fault.retry":
                fx.on_retry(step, orig, int(args.get("retries", 1)))
            elif name == "guard.quarantine":
                fx.on_quarantine(step, orig)
            elif name == "guard.nonfinite":
                fx.on_nonfinite(step)
        return fx
