"""Flight-recorder tracing core (DESIGN.md §10).

A :class:`Tracer` records spans, instant events, counters, and structured
log events into a bounded in-memory ring buffer, and exports them two ways:

- **Chrome/Perfetto ``trace_event`` JSON** (``write_chrome``): load the file
  in ``ui.perfetto.dev`` / ``chrome://tracing`` and see the step-phase
  timeline, per-worker arrival tracks, rebalance/churn/inexact-decode
  markers, and request lifecycles.
- **JSONL event log** (``write_jsonl``): one self-describing JSON object
  per record — the machine-readable stream ``repro_torch.launch.obs_report``
  aggregates into phase-breakdown and straggler-blame tables.

Two clock domains coexist (they are different *processes* in the Chrome
export, so they never visually interleave):

- ``wall``  — host seconds since the tracer's construction
  (``Tracer.clock()``, a ``perf_counter`` delta).  Step-phase spans live
  here: what the host actually paid per phase.
- ``sim``   — the virtual simulated clock (trainer: accumulated
  ``sim_iter_time``; serving: the engine's virtual ``now``).  Iteration
  windows, worker arrivals, and request lifecycles live here: what the
  modelled cluster did.

Zero-overhead-when-off contract: instrumented code holds a tracer
reference that is either a real :class:`Tracer` (``enabled = True``) or
the module-level :data:`NULL_TRACER` singleton.  Hot paths guard every
emission with ``if tr.enabled:`` — tracing off therefore costs ONE
attribute check per instrumented site, no allocation, no clock read
(enforced by the ``observability`` overhead gate in BENCH_run.json).
:class:`NullTracer` also no-ops every method, so cold paths may call it
unguarded.
"""

from __future__ import annotations

import json
import math
import time
from collections import deque
from typing import Any, Iterable, Iterator

__all__ = ["NULL_TRACER", "NullTracer", "Tracer", "get_tracer", "set_tracer"]

# Chrome-export process ids per clock domain (pid 0 is reserved by some
# viewers for the browser process; start at 1)
_CLOCK_PID = {"wall": 1, "sim": 2}


class _NullSpan:
    """Reusable no-op context manager — the off-path ``span()`` result."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **args) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled tracer: every method is a no-op, ``enabled`` is False.

    A singleton (:data:`NULL_TRACER`) stands in wherever no tracer was
    configured, so instrumented code never branches on ``None``.
    """

    __slots__ = ()

    enabled = False

    def clock(self) -> float:
        return 0.0

    def span(self, name: str, *, tid: int = 0, **args) -> _NullSpan:
        return _NULL_SPAN

    def span_at(self, name: str, t0: float, t1: float, **kw) -> None:
        pass

    def instant(self, name: str, **kw) -> None:
        pass

    def counter(self, name: str, value: float, **kw) -> None:
        pass

    def event(self, name: str, **fields) -> None:
        pass


NULL_TRACER = NullTracer()


class _Span:
    """Context manager recording one wall-clock span on exit (and entering a
    ``torch.profiler.record_function`` range when the tracer asks for device
    alignment)."""

    __slots__ = ("_tr", "_name", "_tid", "_args", "_t0", "_prof_ctx")

    def __init__(self, tr: "Tracer", name: str, tid: int, args: dict):
        self._tr = tr
        self._name = name
        self._tid = tid
        self._args = args
        self._prof_ctx = None

    def set(self, **args) -> "_Span":
        self._args.update(args)
        return self

    def __enter__(self) -> "_Span":
        ann = self._tr._annotation
        if ann is not None:
            self._prof_ctx = ann(self._name)
            self._prof_ctx.__enter__()
        self._t0 = self._tr.clock()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = self._tr.clock()
        if self._prof_ctx is not None:
            self._prof_ctx.__exit__(*exc)
        self._tr.span_at(self._name, self._t0, t1, clock="wall", tid=self._tid, **self._args)
        return False


class Tracer:
    """In-memory flight recorder with Chrome-trace and JSONL export.

    Args:
      capacity: ring-buffer size in records; the oldest records are evicted
        (and counted in ``n_dropped``) once full — a long run keeps the
        most recent window, never unbounded memory.
      profiler_annotations: wrap wall-clock ``span()`` bodies in
        ``torch.profiler.record_function`` so a device profile captured with
        ``torch.profiler.profile`` lines its kernel slices up with ours.
    """

    enabled = True

    def __init__(self, capacity: int = 1 << 16, *, profiler_annotations: bool = False):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self._buf: deque[dict] = deque(maxlen=int(capacity))
        self._seq = 0
        self.n_dropped = 0
        self._epoch = time.perf_counter()
        self._annotation = None
        if profiler_annotations:
            from torch.profiler import record_function

            self._annotation = record_function

    # -- clocks --------------------------------------------------------------

    def clock(self) -> float:
        """Wall seconds since tracer construction (the ``wall`` domain)."""
        return time.perf_counter() - self._epoch

    # -- recording -----------------------------------------------------------

    def _record(self, rec: dict) -> None:
        if len(self._buf) == self._buf.maxlen:
            self.n_dropped += 1
        rec["seq"] = self._seq
        self._seq += 1
        self._buf.append(rec)

    def span(self, name: str, *, tid: int = 0, **args) -> _Span:
        """Wall-clock span as a context manager (convenience path — hot
        loops record via :meth:`span_at` behind an ``enabled`` guard)."""
        return _Span(self, name, tid, args)

    def span_at(
        self,
        name: str,
        t0: float,
        t1: float,
        *,
        clock: str = "sim",
        tid: int = 0,
        **args,
    ) -> None:
        """Record a span with explicit endpoints in ``clock`` seconds."""
        self._record({
            "kind": "span", "name": name, "t0": float(t0), "t1": float(t1),
            "clock": clock, "tid": int(tid), "args": args,
        })

    def instant(
        self, name: str, *, t: float | None = None, clock: str = "wall",
        tid: int = 0, **args,
    ) -> None:
        """Record a point event (``t`` = None: wall now)."""
        self._record({
            "kind": "instant", "name": name,
            "t": float(t) if t is not None else self.clock(),
            "clock": clock, "tid": int(tid), "args": args,
        })

    def counter(
        self, name: str, value: float, *, t: float | None = None,
        clock: str = "wall", tid: int = 0,
    ) -> None:
        """Record a counter sample (rendered as a track in Perfetto)."""
        self._record({
            "kind": "counter", "name": name,
            "t": float(t) if t is not None else self.clock(),
            "clock": clock, "tid": int(tid), "args": {"value": float(value)},
        })

    def event(self, name: str, **fields) -> None:
        """Structured log record (the JSONL event log — e.g. one
        ``train.step`` record per trainer step with stable keys).  Not
        placed on the Chrome timeline."""
        self._record({
            "kind": "event", "name": name, "t": self.clock(),
            "clock": "wall", "tid": 0, "args": fields,
        })

    # -- introspection -------------------------------------------------------

    def __len__(self) -> int:
        return len(self._buf)

    def records(
        self, kind: str | None = None, name: str | None = None
    ) -> list[dict]:
        """Recorded events (oldest first), optionally filtered."""
        out: Iterable[dict] = self._buf
        if kind is not None:
            out = (r for r in out if r["kind"] == kind)
        if name is not None:
            out = (r for r in out if r["name"] == name)
        return list(out)

    def clear(self) -> None:
        self._buf.clear()
        self.n_dropped = 0

    # -- export --------------------------------------------------------------

    def to_chrome(self) -> dict:
        """Chrome/Perfetto ``trace_event`` document.  Clock domains map to
        processes (wall=1, sim=2); timestamps are microseconds."""
        events: list[dict] = [
            {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
             "args": {"name": f"{clock} clock"}}
            for clock, pid in _CLOCK_PID.items()
        ]
        for rec in self._buf:
            pid = _CLOCK_PID.get(rec["clock"], 1)
            tid = rec["tid"]
            args = _finite(rec["args"])
            if rec["kind"] == "span":
                t0, t1 = rec["t0"], rec["t1"]
                if not (math.isfinite(t0) and math.isfinite(t1)):
                    continue  # a timeline slice needs finite endpoints
                events.append({
                    "ph": "X", "name": rec["name"], "pid": pid, "tid": tid,
                    "ts": t0 * 1e6, "dur": max(t1 - t0, 0.0) * 1e6,
                    "args": args,
                })
            elif rec["kind"] == "instant":
                if not math.isfinite(rec["t"]):
                    continue
                events.append({
                    "ph": "i", "name": rec["name"], "pid": pid, "tid": tid,
                    "ts": rec["t"] * 1e6, "s": "t", "args": args,
                })
            elif rec["kind"] == "counter":
                if not math.isfinite(rec["t"]):
                    continue
                events.append({
                    "ph": "C", "name": rec["name"], "pid": pid, "tid": tid,
                    "ts": rec["t"] * 1e6, "args": args,
                })
            # kind == "event": log records stay off the timeline
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)

    def iter_jsonl(
        self, kinds: tuple[str, ...] | None = None,
        names: tuple[str, ...] | None = None,
    ) -> Iterator[str]:
        for rec in self._buf:
            if kinds is not None and rec["kind"] not in kinds:
                continue
            if names is not None and rec["name"] not in names:
                continue
            yield json.dumps(rec, default=_jsonable)

    def write_jsonl(
        self, path: str, *, kinds: tuple[str, ...] | None = None,
        names: tuple[str, ...] | None = None,
    ) -> int:
        """Write the (filtered) record stream as one JSON object per line.
        Returns the number of lines written."""
        n = 0
        with open(path, "w") as f:
            for line in self.iter_jsonl(kinds, names):
                f.write(line)
                f.write("\n")
                n += 1
        return n


def _finite(obj):
    """Strict-JSON view of span/instant args for the Chrome export: the
    JSONL log keeps honest ``inf``/``nan`` floats (Python's json round-trips
    them), but Perfetto's parser wants RFC-compliant JSON — map non-finite
    floats to their string names."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    return obj


def _jsonable(x: Any):
    """Last-resort JSON coercion for numpy scalars/arrays in event args."""
    if hasattr(x, "tolist"):
        return x.tolist()
    if hasattr(x, "item"):
        return x.item()
    return str(x)


# -- module-level default tracer (the one attribute hot paths check) ---------

_TRACER: NullTracer | Tracer = NULL_TRACER


def get_tracer() -> NullTracer | Tracer:
    """The process-default tracer (``NULL_TRACER`` unless :func:`set_tracer`
    installed a real one)."""
    return _TRACER


def set_tracer(tracer: Tracer | NullTracer | None) -> None:
    """Install (or with None, remove) the process-default tracer."""
    global _TRACER
    _TRACER = tracer if tracer is not None else NULL_TRACER
