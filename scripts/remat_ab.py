"""Remat's cost on the full-width smollm-360m spmd main path, on the card.

Runs the launcher's command of ``chip_smoke.py``'s phase 5 (``--arch
smollm-360m --backend spmd --scheme heter_aware --s 1 --m 4 --straggler
fault``) in one process once per entry of ``--order``, with the config's
``remat`` set to that entry, so the two variants share one card, one host
and one call.  For each run: every step's host-clock time (each step ends in
a device sync) and the median of steps 1 to ``--steps`` - 1, the peak
memory, and one more step under ``torch.profiler``: the device's busy time
(the kernels' summed self time), the kernels launched, the aten ops
dispatched on the host, and the host ops with the most self time.

The recomputed forward's device time is busy(full) - busy(none); what is
left of the wall gap is spent on the host.

    PYTHONPATH=src python scripts/remat_ab.py [--order none,full,full,none] \\
        [--steps 4] [--warmup 1] [--out remat_ab.json]

With ``PYTHONPATH`` on another tree's ``src`` it times that tree; a tree
whose model ignores ``remat`` runs its one path under either name.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import time

import torch

ARGS = ["--arch", "smollm-360m", "--backend", "spmd", "--scheme", "heter_aware", "--s", "1",
        "--m", "4", "--straggler", "fault"]


def one_run(remat: str, steps: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.launch.train as train

    get_config = train.get_config
    train.get_config = lambda arch: dataclasses.replace(get_config(arch), remat=remat)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def on_step(trainer, step, state, metrics):
        # the last step is the profiled one: start after the one before it
        if step == steps - 1:
            torch.cuda.synchronize()
            prof.start()
        elif step == steps:
            torch.cuda.synchronize()
            prof.stop()

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        out = train.main([*ARGS, "--steps", str(steps + 1), "--device", "cuda"], on_step=on_step)
    finally:
        train.get_config = get_config
    busy = kernels = aten = 0
    host: dict[str, float] = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            busy += ev.self_device_time_total
            kernels += ev.count
        else:
            if ev.key.startswith("aten::"):
                aten += ev.count
            host[ev.key] = ev.self_cpu_time_total / 1e3
    step_s = out["step_s"]
    return {
        "remat": remat, "step_s": step_s[:steps], "median_s": statistics.median(step_s[1:steps]),
        "losses": [h["loss"] for h in out["history"]],
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "profiled_step_s": step_s[steps], "device_busy_s": busy / 1e6,
        "kernels_launched": kernels, "aten_ops": aten,
        "host_top_ms": sorted(host.items(), key=lambda kv: -kv[1])[:8],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--order", default="none,full,full,none")
    ap.add_argument("--steps", type=int, default=4, help="timed steps (the first a warm-up)")
    ap.add_argument("--warmup", type=int, default=1,
                    help="runs of the first entry before the timed ones, not reported")
    ap.add_argument("--out", default=None, help="JSON file for the runs")
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    order = args.order.split(",")
    for _ in range(args.warmup):
        one_run(order[0], args.steps)
    runs = []
    for remat in order:
        t0 = time.perf_counter()
        r = one_run(remat, args.steps)
        r["wall_s"] = time.perf_counter() - t0
        runs.append(r)
        print(f"remat={remat}: steps {[round(t, 4) for t in r['step_s']]} s, median "
              f"{r['median_s']:.4f} s, peak {r['peak_gib']:.2f} GiB; profiled step "
              f"{r['profiled_step_s']:.4f} s wall, device busy {r['device_busy_s']:.4f} s, "
              f"{r['kernels_launched']} kernels, {r['aten_ops']} aten ops; host self time "
              + ", ".join(f"{k} {v:.1f} ms" for k, v in r["host_top_ms"]), flush=True)
    by = {}
    for r in runs:
        by.setdefault(r["remat"], []).append(r)
    if {"none", "full"} <= by.keys():
        med = {k: statistics.median(r["median_s"] for r in v) for k, v in by.items()}
        busy = {k: statistics.median(r["device_busy_s"] for r in v) for k, v in by.items()}
        gap, dev = med["full"] - med["none"], busy["full"] - busy["none"]
        print(f"{card}: step none {med['none']:.4f} s, full {med['full']:.4f} s "
              f"({med['full'] / med['none']:.2f}x); device busy none {busy['none']:.4f} s, "
              f"full {busy['full']:.4f} s; of the {gap:.4f} s gap the recomputed forward's "
              f"device time is {dev:.4f} s, the host's {gap - dev:.4f} s", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "runs": runs}, f, indent=1)


if __name__ == "__main__":
    main()
