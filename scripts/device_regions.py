"""Device time by model region, held to the card's own trace, for one cell
of ``BENCHMARK.json``.

Builds the cell's program with the port's tracer on, drives its checked
first steps, then runs a window of ``--seconds`` under ``torch.profiler``
(CUPTI), as ``chipbench/run.py --trace 1`` does, with no reference check.
From the program's ``device.*`` spans (``Tracer.device_span``) and the
CUPTI kernels of the window's steps it reports:

  - per region and pass (``fwd``, ``recompute``, ``bwd``): the spans'
    seconds a step and the CUPTI busy seconds inside them (their ratio
    shows the two clocks agree and no idle hides in a span);
  - the share of the window's busy time inside any ``device.*`` span, and
    the kernels with the most busy time outside them;
  - the two clocks' agreement: how long after a region's opening event its
    first kernel starts, and how long before its closing event its last
    kernel ends (quartiles, microseconds);
  - idle seconds by the innermost span open where each gap starts, over
    every span and over the host spans alone, the share the first puts on
    ``device.*`` names, and for the gaps that start inside a region how
    far they start from its end;
  - the kernels with the most device time a step over the whole window
    (``top_kernels``, seconds a step by name), and the calls a step of the
    port's counted kernel wrappers (``launches_a_step``).

    python scripts/device_regions.py --workload smollm-360m.heter.s2048 \\
        --seed 7 --seconds 10 [--out regions.json]

From the root of a checkout, on a machine with the card.
"""

from __future__ import annotations

import argparse
import bisect
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


def _overlap(intervals: list[tuple[float, float]], starts: list[float], a: float, b: float) -> float:
    """Seconds of the sorted, disjoint ``intervals`` inside [a, b]."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    out = 0.0
    while i < len(intervals) and intervals[i][0] < b:
        out += max(0.0, min(b, intervals[i][1]) - max(a, intervals[i][0]))
        i += 1
    return out


def _union(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def breakdown(spans: list, trace: devtrace.DeviceTrace, t0: float, t1: float,
              window: set[int]) -> dict:
    n = len(window)
    dev = [(name, a, b, args) for name, a, b, args in spans
           if args.get("on") == "device" and args.get("step") in window]
    busy = trace.busy(t0, t1)
    starts = [a for a, _ in busy]
    busy_s = sum(b - a for a, b in busy)
    regions: dict[str, dict[str, float]] = {}
    for name, a, b, args in dev:
        key = f"{name}.{args.get('kind', '')}.{args['pass']}".replace("..", ".")
        r = regions.setdefault(key, {"span_s": 0.0, "busy_s": 0.0, "n": 0})
        r["span_s"] += b - a
        r["busy_s"] += _overlap(busy, starts, a, b)
        r["n"] += 1
    for r in regions.values():
        r["busy_over_span"] = r["busy_s"] / r["span_s"] if r["span_s"] > 0 else None
        r["span_s_per_step"] = r["span_s"] / n
        r["busy_s_per_step"] = r["busy_s"] / n
    inside = _union([(a, b) for _, a, b, _ in dev])
    in_starts = [a for a, _ in inside]
    inside_busy = sum(_overlap(busy, starts, a, b) for a, b in inside)
    outside: dict[str, float] = {}
    for name, a, b in trace.events:
        a, b = max(a, t0), min(b, t1)
        if b > a:
            rest = (b - a) - _overlap(inside, in_starts, a, b)
            if rest > 0:
                outside[name] = outside.get(name, 0.0) + rest
    # the two clocks: a region's first kernel starts just after its opening
    # event and its last kernel ends just before its closing one
    k_starts = sorted(a for _, a, _ in trace.events)
    k_ends = sorted(b for _, _, b in trace.events)
    lead = [_nearest(k_starts, a) - a for _, a, _, _ in dev]
    lag = [_nearest(k_ends, b) - b for _, _, b, _ in dev]
    gaps = trace.gaps(t0, t1)
    # gaps that start inside a region: how far from its end
    in_region = []
    for g0, g1 in gaps:
        for _, a, b, _ in dev:
            if a <= g0 < b:
                in_region.append((b - g0, g1 - g0))
                break
    idle_all = devtrace.idle_by_span(gaps, spans)
    idle_host = devtrace.idle_by_span(gaps, [s for s in spans if s[3].get("on") != "device"])
    idle_s = sum(b - a for a, b in gaps)
    on_device = sum(v for k, v in idle_all.items() if k.startswith("device."))
    return {
        "steps": n, "window_s": t1 - t0, "busy_s": busy_s, "idle_s": idle_s,
        "regions": dict(sorted(regions.items())),
        "busy_inside_regions_share": inside_busy / busy_s if busy_s else None,
        "top_outside": devtrace.top(outside, n=12),
        "idle_by_span": devtrace.top(idle_all, n=12),
        "idle_by_host_span": devtrace.top(idle_host, n=12),
        "idle_on_device_names_share": on_device / idle_s if idle_s else None,
        "first_kernel_after_open_us": _quartiles(lead),
        "last_kernel_before_close_us": _quartiles(lag),
        "gaps_starting_in_a_region": {
            "n": len(in_region), "of": len(gaps),
            "idle_s": sum(d for _, d in in_region),
            "to_region_end_us": _quartiles([e for e, _ in in_region]),
            "gap_us": _quartiles([d for _, d in in_region]),
        },
    }


def _nearest(sorted_points: list[float], t: float) -> float:
    i = bisect.bisect_left(sorted_points, t)
    near = sorted_points[max(i - 1, 0):i + 1]
    return min(near, key=lambda x: abs(x - t))


def _quartiles(xs: list[float]) -> list[float] | None:
    """Quartiles of ``xs`` seconds, in microseconds."""
    if len(xs) < 2:
        return None
    return [1e6 * q for q in statistics.quantiles(xs, n=4)]


def _counted() -> dict:
    """The port's kernel wrappers that count their calls in ``launches``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_gate_norm as gn
    from repro_torch.kernels import ssd_scan as ssd

    return {"ssd_scan": ssd.ssd_scan, "ssd_scan_bwd": ssd.ssd_scan_bwd,
            "ssd_gate_norm": gn.ssd_gate_norm, "ssd_gate_norm_bwd": gn.ssd_gate_norm_bwd,
            "flash_attention_train_fwd": fa.flash_attention_train_fwd,
            "flash_attention_train_bwd": fa.flash_attention_train_bwd}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    bench = manifest.Bench()
    cell = bench.workload(args.workload)
    cfg, traffic = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    n_check = int(bench.check(cell["name"])["check_steps"])
    dev = torch.device("cuda")
    prog, state, data, _, _ = run.setup(bench, cfg, traffic, args.seed, dev, True, n_check)
    counted = _counted()
    before = {name: fn.launches for name, fn in counted.items()}
    trace = devtrace.DeviceTrace()
    trace.start()
    torch.cuda.synchronize(dev)
    step = n_check
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        state, _ = prog.step(state, data.batch(step))
        step += 1
    torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    trace.stop()
    steps = step - n_check
    top = sorted(trace.by_name(t0, t1).items(), key=lambda kv: -kv[1])[:25]
    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(dev), "power_limit": run.power_limit(),
           **breakdown(prog.spans(), trace, t0, t1, set(range(n_check, step))),
           "top_kernels": [[name[:100], s / steps] for name, s in top],
           "launches_a_step": {name: (fn.launches - before[name]) / steps
                               for name, fn in counted.items()}}
    prog.close()
    text = json.dumps(out, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
