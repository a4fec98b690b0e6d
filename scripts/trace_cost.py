"""What the port's tracer costs when it is on, for one cell of
``BENCHMARK.json``, in one process on the card.

Builds the cell's program with the tracer on, drives its checked first
steps, then steps the same trainer in turns in three modes: ``off`` (no
tracer anywhere), ``host`` (the trainer's and the engine's host spans) and
``regions`` (the model's device regions too), two steps a turn, the second
timed under the CUPTI profiler (it places the first's regions, as every
traced step does).  Prints, a mode, every timed step's wall seconds, the
device's idle seconds in it and the seconds spent placing device regions,
and their medians.

    python scripts/trace_cost.py --workload smollm-360m.heter.s2048 --seed 7 \\
        [--reps 3] [--modes off,host,regions]

From the root of a checkout, on a machine with the card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from chipbench import devtrace, manifest, run  # noqa: E402  (sets the allocator's mode)

import torch  # noqa: E402

from repro_torch.obs.trace import NULL_TRACER  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--modes", default="off,host,regions")
    args = ap.parse_args(argv)
    modes = args.modes.split(",")
    bench = manifest.Bench()
    cell = bench.workload(args.workload)
    cfg, traffic = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    n_check = int(bench.check(cell["name"])["check_steps"])
    dev = torch.device("cuda")
    prog, state, data, _, _ = run.setup(bench, cfg, traffic, args.seed, dev, True, n_check)
    tracer, trainer = prog.tracer, prog.trainer
    place = tracer._place
    placing = []

    def timed_place(*a):
        t = time.perf_counter()
        place(*a)
        placing.append(time.perf_counter() - t)

    tracer._place = timed_place
    out = {m: {"wall_s": [], "idle_s": [], "place_s": []} for m in modes}
    step = n_check
    for _ in range(args.reps):
        for mode in modes:
            host = NULL_TRACER if mode == "off" else tracer
            trainer.tracer = trainer.engine.tracer = host
            trainer.elastic.tracer = trainer.elastic.policy.tracer = host
            prog.model.tracer = tracer if mode == "regions" else NULL_TRACER
            state, _ = prog.step(state, data.batch(step))
            trace = devtrace.DeviceTrace()
            trace.start()
            torch.cuda.synchronize(dev)
            placing.clear()
            t0 = time.perf_counter()
            state, _ = prog.step(state, data.batch(step + 1))
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            trace.stop()
            step += 2
            out[mode]["wall_s"].append(t1 - t0)
            out[mode]["idle_s"].append((t1 - t0) - trace.busy_s(t0, t1))
            out[mode]["place_s"].append(sum(placing))
    prog.close()
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "device": torch.cuda.get_device_name(dev), "power_limit": run.power_limit(),
        "steps": out,
        "median": {m: {k: statistics.median(v) for k, v in d.items()} for m, d in out.items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
