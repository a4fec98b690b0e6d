#!/usr/bin/env python3
"""Readings that set a cell's limits, at the cell's own size, on the card.

    python3 chipbench/control.py --workload <name> --seeds 1,2,... \
        --control-seeds 1,2,3 [--out control-<name>.json]

For each of ``--seeds``: the program's checked first steps, exactly as a
run's set-up drives them, against the plain reference (the lower
readings).  For each of ``--control-seeds`` also, against the same f32
reference: the control, the reference computed with every matmul's
operands in fp8 e4m3, the step below the configuration's bf16; and the
fault of half of each step's rows left out, the mean taken over the rest;
and a state left unchanged, the reference at a learning rate of 0 (its
losses; it reads 1 on ``grad_gap`` and ``update_gap`` by definition, as
the program's first moment and weights would not move).  The benchmark's
own runs never run this; PERF.md keeps what it read and the limits set
from it (``limits/<workload>.json``).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
if sys.path and Path(sys.path[0]).resolve() == _HERE:
    sys.path.pop(0)
for _p in (_HERE.parent / "src", _HERE.parent):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from chipbench import check, manifest, run  # noqa: E402  (first: it sets the allocator)
from chipbench.reference.common import matmul_fp8  # noqa: E402

import torch  # noqa: E402


def readings(bench: manifest.Bench, workload: str, seeds: list[int], control_seeds: list[int],
             device: str = "cuda") -> list[dict]:
    cell = bench.workload(workload)
    cfg, traffic = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    dev = torch.device(device)
    n = int(bench.check(workload)["check_steps"])
    out = []
    for seed in dict.fromkeys(seeds + control_seeds):
        t = time.perf_counter()
        prog, state, data, prog_r, bad = run.setup(bench, cfg, traffic, seed, dev, False, n)
        del prog, state
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ref = run.reference_readings(bench, cfg, data, seed, dev, n)
        row = {"seed": seed, "failed_steps": bad, "losses": prog_r.losses,
               "reference_losses": ref.losses}
        if seed in seeds:
            row["program"] = check.compare(prog_r, ref)
        if seed in control_seeds:
            fp8 = run.reference_readings(bench, cfg, data, seed, dev, n, mm=matmul_fp8)
            half = run.reference_readings(bench, cfg, data, seed, dev, n, keep=0.5)
            frozen = {**cfg, "train": {**cfg["train"], "lr": 0.0}}
            still = run.reference_readings(bench, frozen, data, seed, dev, n)
            row["control_fp8"] = check.compare(fp8, ref)
            row["fault_half_batch"] = check.compare(half, ref)
            row["fault_state_unchanged"] = check.compare(still, ref)
        row["seconds"] = time.perf_counter() - t
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control-seeds", default="", help="comma-separated")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    if not torch.cuda.is_available():
        print("chipbench.control: no CUDA card", file=sys.stderr)
        return 3
    rows = readings(manifest.Bench(), args.workload, ints(args.seeds), ints(args.control_seeds))
    summary = {}
    for kind in ("program", "control_fp8", "fault_half_batch", "fault_state_unchanged"):
        got = [r[kind] for r in rows if kind in r]
        if got:
            summary[kind] = {n: {"min": min(g[n] for g in got), "max": max(g[n] for g in got)}
                             for n in check.NUMBERS}
    print(json.dumps({"workload": args.workload, "device": torch.cuda.get_device_name(),
                      "power_limit": run.power_limit(), "summary": summary}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
