"""Offline trace analysis CLI (DESIGN.md §10).

Reads a tracer JSONL event log (``--log-jsonl`` from ``repro_torch.launch.train``
or ``Tracer.write_jsonl``) and prints:

- the **step-phase breakdown** — every span name aggregated through the one
  shared :class:`~repro_torch.obs.stats.Summary` (n / total / mean / p50 / p99),
  split by clock domain so host phase costs and simulated iteration windows
  never mix;
- the **straggler blame report** — :class:`StragglerForensics` rebuilt from
  the ``train.step`` event stream: top-k workers by blame (late on a step
  that was skipped / decoded inexactly / capped at its deadline), estimate
  drift, rebalance and churn attribution.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --reduced \\
      --steps 40 --straggler delay --deadline-mode bounded_residual \\
      --log-jsonl /tmp/run.jsonl
  PYTHONPATH=src python -m repro_torch.launch.obs_report /tmp/run.jsonl --top-k 5
"""

from __future__ import annotations

import argparse
import json

from repro_torch.obs.stats import Summary
from repro_torch.obs.straggler import StragglerForensics

__all__ = ["load_records", "phase_table", "blame_report", "fault_section",
           "render", "main"]


def load_records(path: str) -> list[dict]:
    """Parse a tracer JSONL log (one record per line; blank lines ignored)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def phase_table(records: list[dict]) -> list[dict]:
    """Aggregate every span name into one summary row per (clock, name),
    longest total first within each clock domain."""
    sums: dict[tuple[str, str], Summary] = {}
    for rec in records:
        if rec.get("kind") != "span":
            continue
        key = (rec.get("clock", "wall"), rec["name"])
        sums.setdefault(key, Summary()).add(max(rec["t1"] - rec["t0"], 0.0))
    rows = []
    for (clock, name), s in sums.items():
        row = s.summary()
        rows.append({"clock": clock, "phase": name, "total_s": s.total, **row})
    rows.sort(key=lambda r: (r["clock"], -r["total_s"]))
    return rows


def blame_report(records: list[dict], top_k: int = 10) -> dict:
    """Straggler forensics rebuilt from the event log: run summary, top-k
    blame table, and the rebalance/churn attribution trail."""
    fx = StragglerForensics.from_records(records)
    return {
        "summary": fx.summary(),
        "blame": fx.blame_table(top_k),
        "rebalances": fx.rebalances,
        "transitions": fx.transitions,
        "archived_epochs": len(fx.epochs),
    }


def fault_section(records: list[dict]) -> dict:
    """The §11 fault ledger rebuilt from the event log: injected faults,
    per-worker suspicion timelines, convictions/evictions/re-admissions,
    retried uploads, and quarantined decode slots (workers by ORIGINAL
    id)."""
    return StragglerForensics.from_records(records).fault_report()


def _fmt(v, width: int) -> str:
    if isinstance(v, float):
        return f"{v:>{width}.4g}"
    return f"{v!s:>{width}}"


def render(rows: list[dict], columns: list[str] | None = None) -> str:
    """Fixed-width text table from dict rows (columns = first row's keys)."""
    if not rows:
        return "  (no rows)"
    cols = columns if columns is not None else list(rows[0].keys())
    widths = {c: max(len(c), *(len(_fmt(r.get(c, ""), 0).strip()) for r in rows)) for c in cols}
    head = "  ".join(f"{c:>{widths[c]}}" for c in cols)
    lines = [head, "-" * len(head)]
    for r in rows:
        lines.append("  ".join(_fmt(r.get(c, ""), widths[c]) for c in cols))
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="trace phase breakdown + straggler blame")
    ap.add_argument("log", help="tracer JSONL event log")
    ap.add_argument("--top-k", type=int, default=10, help="blame table rows")
    args = ap.parse_args(argv)

    records = load_records(args.log)
    kinds: dict[str, int] = {}
    for rec in records:
        kinds[rec.get("kind", "?")] = kinds.get(rec.get("kind", "?"), 0) + 1
    print(f"{len(records)} records: " + ", ".join(f"{k}={n}" for k, n in sorted(kinds.items())))

    phases = phase_table(records)
    if phases:
        print("\n== span breakdown (seconds) ==")
        print(render(phases, ["clock", "phase", "n", "total_s", "mean", "p50", "p99", "max"]))

    rep = blame_report(records, args.top_k)
    if rep["summary"]["steps"] > 0:
        print("\n== straggler forensics ==")
        s = rep["summary"]
        print(
            f"steps={s['steps']:.0f} hurt={s['hurt_steps']:.0f} "
            f"rebalances={s['rebalances']:.0f} transitions={s['transitions']:.0f} "
            f"m={s['m']:.0f} archived_epochs={rep['archived_epochs']}"
        )
        print("\n-- top blame (current epoch) --")
        print(render(
            rep["blame"],
            ["worker", "held", "done", "late", "blame", "blame_inexact",
             "late_frac", "load_share", "mean_finish_s", "mean_drift"],
        ))
        if rep["rebalances"]:
            print("\n-- rebalances --")
            print(render(
                [{"step": r["step"], "mean_abs_drift": r["mean_abs_drift"]}
                 for r in rep["rebalances"]],
            ))
        if rep["transitions"]:
            print("\n-- membership transitions --")
            print(render(rep["transitions"]))

    faults = fault_section(records)
    if any(faults[k] for k in
           ("faults", "convictions", "suspicion", "retries", "quarantines",
            "nonfinite_steps")):
        print("\n== faults ==")
        kinds: dict[str, int] = {}
        for f in faults["faults"]:
            kinds[f["kind"]] = kinds.get(f["kind"], 0) + 1
        print(
            "injected: " + (", ".join(f"{k}={n}" for k, n in sorted(kinds.items()))
                            or "none")
            + f"; nonfinite_steps={len(faults['nonfinite_steps'])}"
        )
        if faults["suspicion"]:
            print("\n-- suspicion timeline (per worker) --")
            print(render([
                {"worker": w, **row} for w, row in faults["suspicion"].items()
            ]))
        if faults["convictions"]:
            print("\n-- convictions --")
            print(render(faults["convictions"]))
        if faults["evictions"] or faults["readmissions"]:
            print("\n-- evictions / re-admissions --")
            print(render(
                [{"event": "evict", **r} for r in faults["evictions"]]
                + [{"event": "readmit", **r} for r in faults["readmissions"]],
                ["event", "step", "worker"],
            ))
        if faults["retries"] or faults["quarantines"]:
            workers = sorted(set(faults["retries"]) | set(faults["quarantines"]))
            print("\n-- retries / quarantined slots --")
            print(render([
                {"worker": w, "retried_uploads": faults["retries"].get(w, 0),
                 "quarantines": faults["quarantines"].get(w, 0)}
                for w in workers
            ]))


if __name__ == "__main__":
    main()
