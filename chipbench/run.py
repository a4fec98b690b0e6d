#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once on the card.

    python3 chipbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up reads the cell's configuration and
traffic, makes the weights on the card from the seed, builds the port's
``CodedTrainer`` and drives it through its first steps (the cell's
``check_steps``), whose readings the reference checks and which warm
every shape the window uses.  The window then drives the same trainer,
step after step, for ``--seconds``.  Once it has closed, the program's
state is freed and the plain reference trains again from the same
weights on the same rows; the comparison (``chipbench.check``) decides
``correct``.  The last line of standard output is one JSON object: the
end-to-end metrics with ``--trace 0``, the per-layer ones (and a
``breakdown`` of device time and idle gaps) with ``--trace 1``.  The
numbers compared, each with its limit, are the last lines of standard
error and the result's last key.

Exits non-zero and prints no result without enough CUDA cards, when the
port cannot be imported, or when JAX or the JAX package is loaded.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_HERE = Path(__file__).resolve().parent
_ROOT = _HERE.parent
if sys.path and Path(sys.path[0]).resolve() == _HERE:
    sys.path.pop(0)  # run as a script: this directory's modules are not top-level
for _p in (_ROOT / "src", _ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

# The caching allocator's expandable segments: at 40 rows of 2048 tokens the
# default one leaves a quarter of the card reserved but unusable to
# fragmentation, and smollm-360m's first backward runs out of memory.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402

from chipbench import check, devtrace, manifest, peaks, weights  # noqa: E402
from chipbench.reference import family  # noqa: E402
from chipbench.reference import train as reference  # noqa: E402
from chipbench.synthetic import SyntheticTokens  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole


@dataclasses.dataclass
class Context:
    """What a metric reader may read."""

    model: dict
    traffic: dict
    setup_s: float
    t0: float
    t1: float
    steps: int
    window_steps: list[int]
    tokens_per_step: int
    peak_bytes: int | None
    peaks: dict | None
    trace: devtrace.DeviceTrace | None
    spans: list
    counters: dict

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _bad(metrics: dict) -> bool:
    """A step that did not update: skipped, or a non-finite loss or norm."""
    return bool(metrics.get("skipped", 0.0)) or not (
        math.isfinite(metrics["loss"]) and math.isfinite(metrics["grad_norm"]))


def main(argv=None, *, bench: manifest.Bench | None = None, need_card: bool = True,
         device: str = "cuda") -> int:
    args = parse(argv)
    bench = bench or manifest.Bench()
    cell = bench.workload(args.workload)
    if need_card and (not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"chipbench: {args.workload} needs {cell['chips']} CUDA card(s), found {n}",
              file=sys.stderr)
        return 3
    dev = torch.device(device)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    checked = bench.check(cell["name"])
    n_check = int(checked["check_steps"])
    wanted = bench.metrics(cell["name"], trace=bool(args.trace))
    readers = {m["name"]: bench.reader(m["name"]) for m in wanted}
    try:
        import chipbench.program  # noqa: F401  (the port)
    except ImportError as e:
        print(f"chipbench: cannot import the port: {e}", file=sys.stderr)
        return 4
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    t_setup = {"imports_s": time.perf_counter() - _T_START}

    # -- set-up: the weights, the trainer, the checked first steps ----------
    prog, state, data, readings, bad = setup(bench, cfg, traffic, args.seed, dev,
                                             bool(args.trace), n_check, t_setup)

    # -- the window ------------------------------------------------------------
    trace = devtrace.DeviceTrace() if args.trace and dev.type == "cuda" else None
    if trace is not None:
        trace.start()
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    prog.reset_counters()
    harness_spans = []
    step = n_check
    t0 = time.perf_counter()
    setup_s = t0 - _T_START
    while True:
        a = time.perf_counter()
        batch = data.batch(step)
        harness_spans.append(("harness.batch", a, time.perf_counter(), {}))
        state, m = prog.step(state, batch)
        bad += _bad(m)
        step += 1
        if time.perf_counter() - t0 >= args.seconds:
            break
    a = time.perf_counter()
    _sync(dev)
    t1 = time.perf_counter()
    harness_spans.append(("harness.sync", a, t1, {}))
    t_trace = time.perf_counter()
    if trace is not None:
        trace.stop()
    t_trace = time.perf_counter() - t_trace
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    readings.stale += prog.stale_leaves(state)
    steps = step - n_check
    ctx = Context(
        model=cfg["model"], traffic=traffic, setup_s=setup_s, t0=t0, t1=t1, steps=steps,
        window_steps=list(range(n_check, step)),
        tokens_per_step=traffic["k"] * traffic["part_mb"] * traffic["seq_len"],
        peak_bytes=peak, peaks=peaks.of(kind) if dev.type == "cuda" else None, trace=trace,
        spans=prog.spans() + harness_spans, counters=prog.counters(),
    )
    values = {}
    for name, reader in readers.items():
        v = reader.read(ctx)
        if v is not None:
            values[name] = v
    breakdown = None
    if trace is not None:
        breakdown = {
            "device_ops": devtrace.top(trace.by_name(t0, t1)),
            "idle_gaps": devtrace.top(devtrace.idle_by_span(trace.gaps(t0, t1), ctx.spans)),
        }
    prog.close()
    del state, prog, ctx
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- the reference, once the window has closed and the state is freed ---
    t_ref = time.perf_counter()
    ref = reference_readings(bench, cfg, data, args.seed, dev, n_check)
    t_ref = time.perf_counter() - t_ref
    numbers = check.compare(readings, ref)
    within, rows = check.judge(numbers, checked["limits"])
    correct = within and bad == 0

    plimit = power_limit() if dev.type == "cuda" else None
    found = forbidden_modules()
    if found:
        print(f"chipbench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 5
    device_doc = {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": kind,
                  "count": int(cell["chips"]), "memory_peak_bytes": peak,
                  "power_limit": plimit}
    if trace is not None:
        device_doc["busy_s"] = trace.busy_s(t0, t1)
        device_doc["window_s"] = t1 - t0
    result = {
        "correct": bool(correct),
        "attempted": n_check + steps,
        "failed": int(bad),
        "metrics": {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                    for m in wanted if m["name"] in values},
        "device": device_doc,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["detail"] = {"losses": readings.losses, "reference_losses": ref.losses,
                        "grad_worst_leaf": numbers["grad_worst_leaf"],
                        "update_worst_leaf": numbers["update_worst_leaf"],
                        "update_leaves_left_out": numbers["update_leaves_left_out"],
                        "window_steps": steps, "window_s": t1 - t0,
                        "setup": t_setup, "trace_read_s": t_trace, "reference_s": t_ref,
                        "run_s": time.perf_counter() - _T_START}
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    result["checks"]["failed_steps"] = {"value": int(bad), "limit": 0}
    for name, v, lim in rows:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    print(f"check failed_steps {bad} limit 0", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def setup(bench: manifest.Bench, cfg: dict, traffic: dict, seed: int, dev: torch.device,
          trace: bool, n_check: int, times: dict | None = None):
    """The program over the seed's weights, driven through its first
    ``n_check`` steps by the window's own call and feed.  Returns
    (program, its state, the token source, the program's readings, the
    count of steps that did not update).  ``times`` gets each part's seconds."""
    from chipbench.program import Program

    times = {} if times is None else times
    t = time.perf_counter()
    prog = Program(cfg, traffic, bench.layout(cfg["model"]["family"]), seed, dev, trace=trace)
    served = weights.make(family(cfg["model"]["family"]).leaves(cfg["model"]),
                          _dtypes_of(cfg, bench), seed, dev)
    served0 = {k: v.clone() for k, v in served.items()}
    state = prog.state(served)
    del served
    data = SyntheticTokens(vocab=cfg["data_vocab"], k=traffic["k"], part_mb=traffic["part_mb"],
                           seq_len=traffic["seq_len"], seed=seed)
    _sync(dev)
    times["trainer_and_weights_s"] = time.perf_counter() - t
    losses, grad, bad = [], {}, 0
    for step in range(n_check):
        t = time.perf_counter()
        state, m = prog.step(state, data.batch(step))
        losses.append(float(m["loss"]))
        bad += _bad(m)
        if step == 0:
            grad = prog.first_grad(state)
        times[f"check_step_{step}_s"] = time.perf_counter() - t
    readings = reference.Readings(losses=losses, grad=grad, update=prog.update(state, served0),
                                  stale=prog.stale_leaves(state))
    del served0
    gc.collect()
    return prog, state, data, readings, bad


def reference_readings(bench: manifest.Bench, cfg: dict, data: SyntheticTokens, seed: int,
                       dev: torch.device, steps: int, mm=None,
                       keep: float = 1.0) -> reference.Readings:
    """The reference's readings over the same weights and rows; ``mm`` and
    ``keep`` as :func:`chipbench.reference.train.run` takes them."""
    served = weights.make(family(cfg["model"]["family"]).leaves(cfg["model"]),
                          _dtypes_of(cfg, bench), seed, dev)
    rows = [data.unique_rows(s) for s in range(steps)]
    kw = {} if mm is None else {"mm": mm}
    return reference.run(cfg["model"], cfg["train"], served, rows, dev, keep=keep, **kw)


def _dtypes_of(cfg: dict, bench: manifest.Bench) -> dict[str, str]:
    """Each leaf's served dtype, read from the family's layout in the port."""
    return {name: cfg["model"]["dtype"] if dt == "model" else dt
            for name, (_, dt) in bench.layout(cfg["model"]["family"]).items()}


if __name__ == "__main__":
    sys.exit(main())
