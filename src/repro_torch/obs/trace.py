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

Device regions (:meth:`Tracer.device_span`) time work on the card on the
same ``wall`` clock, on their own track (tid 2, ``device``): a pair of
pooled CUDA events a region, recorded on the current stream without a
synchronize, anchored by :meth:`Tracer.sync_device` in the synchronize a
traced step already makes and placed on the host clock by
:meth:`Tracer.place_regions`.  A region's backward is
bracketed by two identity autograd markers (``span.output`` opens it,
``span.input`` closes it), so forward, recompute and backward each get
their own span.  On the CPU, where work runs as it is issued, the region
reads the host clock instead and the records are the same.  A number the
device computes rides along the same way (:meth:`Tracer.device_value` as a
region's arg): copied to pinned host memory on the stream, without a
synchronize, and read when its step's regions are placed.

Zero-overhead-when-off contract: instrumented code holds a tracer
reference that is either a real :class:`Tracer` (``enabled = True``) or
the module-level :data:`NULL_TRACER` singleton.  Hot paths guard every
emission with ``if tr.enabled:`` — tracing off therefore costs ONE
attribute check per instrumented site, no allocation, no clock read, no
event and no autograd node (held by
``tests/test_torch_regions.py::test_tracing_off_adds_no_node_and_is_bit_equal``
and ``tests/test_torch_obs.py::test_tracing_off_records_nothing_and_is_bit_equal``).
:class:`NullTracer` also no-ops every method, so cold paths may call it
unguarded.
"""

from __future__ import annotations

import functools
import json
import math
import threading
import time
from collections import deque
from typing import Any, Iterable, Iterator

__all__ = ["NULL_SPAN", "NULL_TRACER", "NullTracer", "Tracer", "get_tracer", "set_tracer"]

# Chrome-export process ids per clock domain (pid 0 is reserved by some
# viewers for the browser process; start at 1)
_CLOCK_PID = {"wall": 1, "sim": 2}
# the wall clock's track of device regions (tid 0: host phases, 1: the
# prefetcher's thread)
DEVICE_TID = 2


class _NullSpan:
    """Reusable no-op context manager — the off-path ``span()`` result."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **args) -> "_NullSpan":
        return self

    def input(self, x):
        return x

    def output(self, y):
        return y


NULL_SPAN = _NullSpan()


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
        return NULL_SPAN

    def span_at(self, name: str, t0: float, t1: float, **kw) -> None:
        pass

    def device_span(self, name: str, *, device=None, **args) -> _NullSpan:
        return NULL_SPAN

    def device_value(self, t):
        return None

    def instant(self, name: str, **kw) -> None:
        pass

    def counter(self, name: str, value: float, **kw) -> None:
        pass

    def event(self, name: str, **fields) -> None:
        pass


NULL_TRACER = NullTracer()


class _Span:
    """Context manager recording one wall-clock span on exit."""

    __slots__ = ("_tr", "_name", "_tid", "_args", "_t0")

    def __init__(self, tr: "Tracer", name: str, tid: int, args: dict):
        self._tr = tr
        self._name = name
        self._tid = tid
        self._args = args

    def set(self, **args) -> "_Span":
        self._args.update(args)
        return self

    def __enter__(self) -> "_Span":
        self._t0 = self._tr.clock()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = self._tr.clock()
        self._tr.span_at(self._name, self._t0, t1, clock="wall", tid=self._tid, **self._args)
        return False


def _autograd_state() -> tuple[bool, bool]:
    """(whether the autograd engine is running a backward on this thread,
    so that a checkpointed forward run now is a recompute; whether grad
    mode is on)."""
    import torch

    return torch._C._current_graph_task_id() != -1, torch.is_grad_enabled()


class _DeviceSpan:
    """One region of device work: its forward (or recompute) as a context
    manager, its backward between the markers :meth:`output` (whose
    backward opens it) and :meth:`input` (whose backward closes it)."""

    __slots__ = ("_tr", "_name", "_device", "_args", "_t0", "_bwd", "_grad")

    def __init__(self, tr: "Tracer", name: str, device, args: dict):
        self._tr = tr
        self._name = name
        self._device = device
        self._args = args
        self._bwd = None
        self._grad = False

    def set(self, **args) -> "_DeviceSpan":
        """More args, known only once the region's work has started."""
        self._args.update(args)
        return self

    def __enter__(self) -> "_DeviceSpan":
        tr = self._tr
        recompute, self._grad = _autograd_state()
        self._args.update({"on": "device", "pass": "recompute" if recompute else "fwd",
                           "step": tr.step, "parent": tr.phase})
        self._t0 = tr._device_mark(self._device)
        return self

    def __exit__(self, *exc) -> bool:
        tr = self._tr
        tr._device_region(self._name, self._t0, tr._device_mark(self._device), self._args)
        return False

    def input(self, x):
        """``x`` marked as the region's input: the marker's backward, which
        runs once the region's backward has been launched, closes it."""
        return _markers()[1].apply(x, self) if self._grad and x.requires_grad else x

    def output(self, y):
        """``y`` marked as the region's output: the marker's backward opens
        the region's backward span."""
        return _markers()[0].apply(y, self) if self._grad and y.requires_grad else y

    def _open_backward(self) -> None:
        tr = self._tr
        self._bwd = (tr._device_mark(self._device), tr.phase)

    def _close_backward(self) -> None:
        if self._bwd is None:
            return
        tr = self._tr
        t0, parent = self._bwd
        self._bwd = None
        tr._device_region(self._name, t0, tr._device_mark(self._device),
                          {**self._args, "pass": "bwd", "parent": parent})


def _is_tensor(v) -> bool:
    """Whether ``v`` is a torch tensor (this module imports no torch)."""
    return type(v).__module__.startswith("torch") and hasattr(v, "tolist")


@functools.cache
def _markers():
    """The two identity autograd functions that bracket a region's
    backward, built on first use (this module imports no torch): the
    first's backward opens the span, the second's closes it.  Gradients
    pass through untouched."""
    import torch

    class OpenBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, y, span):
            ctx.span = span
            # a saved tensor, so that under checkpointing the recompute runs
            # (on its unpacking) before the backward span opens, not inside it
            ctx.save_for_backward(y.new_empty(0))
            return y.view_as(y)

        @staticmethod
        def backward(ctx, g):
            ctx.saved_tensors  # noqa: B018
            ctx.span._open_backward()
            return g, None

    class CloseBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, span):
            ctx.span = span
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            ctx.span._close_backward()
            return g, None

    return OpenBackward, CloseBackward


class Tracer:
    """In-memory flight recorder with Chrome-trace and JSONL export.

    Args:
      capacity: ring-buffer size in records; the oldest records are evicted
        (and counted in ``n_dropped``) once full — a long run keeps the
        most recent window, never unbounded memory.

    ``step`` and ``phase`` are set by the code that launches device work
    (the engine): the trainer step and the host phase now open, copied into
    every device region as ``step`` and ``parent``.
    """

    enabled = True

    def __init__(self, capacity: int = 1 << 16):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self._buf: deque[dict] = deque(maxlen=int(capacity))
        self._seq = 0
        self.n_dropped = 0
        self._epoch = time.perf_counter()
        # records may come from the autograd engine's device thread (a
        # region's backward) and the prefetcher's thread
        self._lock = threading.Lock()
        self._pending: list[tuple] = []  # device regions not yet synchronized
        self._synced: list[tuple] = []  # (regions, anchor, T) not yet placed
        self._events: list = []  # idle CUDA events, reused
        self.step: int | None = None
        self.phase: str | None = None

    # -- clocks --------------------------------------------------------------

    def clock(self) -> float:
        """Wall seconds since tracer construction (the ``wall`` domain)."""
        return time.perf_counter() - self._epoch

    # -- recording -----------------------------------------------------------

    def _record(self, rec: dict) -> None:
        with self._lock:
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

    # -- device regions ------------------------------------------------------

    def device_span(self, name: str, *, device=None, **args) -> _DeviceSpan:
        """A region of work on ``device`` (a ``torch.device``; None or a CPU
        device reads the host clock) as a context manager; its
        ``input``/``output`` markers bracket the region's backward.  Each
        forward, recompute and backward becomes one span on the ``wall``
        clock, tid 2, once :meth:`place_regions` has placed it; its args are
        ``args`` plus ``on="device"``, ``pass`` (``fwd``, ``recompute`` or
        ``bwd``), ``step`` and ``parent`` (:attr:`step`, :attr:`phase`)."""
        return _DeviceSpan(self, name, device, args)

    def _device_mark(self, device):
        """A point of a device region: a CUDA event recorded on the current
        stream, or the host clock."""
        if device is None or device.type != "cuda":
            return self.clock()
        import torch

        with self._lock:
            e = self._events.pop() if self._events else None
        if e is None:
            e = torch.cuda.Event(enable_timing=True)
        e.record(torch.cuda.current_stream(device))
        return e

    def _device_region(self, name: str, start, end, args: dict) -> None:
        with self._lock:
            self._pending.append((name, start, end, args))

    def device_value(self, t):
        """A device tensor's value as a region's arg: a copy into pinned host
        memory queued on the current stream (no synchronize; a CPU tensor is
        copied as it is).  The region's record holds it as a number, or a
        list, once :meth:`place_regions` has placed it."""
        import torch

        t = t.detach()
        if not t.is_cuda:
            return t.clone()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t, non_blocking=True)

    def sync_device(self, device=None) -> float:
        """Wait for ``device``; returns the clock after the wait.  The device
        regions recorded since the last call are kept with an anchor event,
        recorded just before the synchronize, and ``T``, the clock read right
        after it, which is when the anchor ran; :meth:`place_regions` then
        puts an event ``e`` at ``T - elapsed(e, anchor)``."""
        with self._lock:
            pending, self._pending = self._pending, []
        anchor = None
        if device is not None and device.type == "cuda":
            import torch

            anchor = self._device_mark(device)
            torch.cuda.synchronize(device)
        T = self.clock()
        with self._lock:
            if pending:
                self._synced.append((pending, anchor, T))
            elif anchor is not None:
                self._events.append(anchor)
        return T

    def place_regions(self) -> None:
        """Record, on the ``wall`` clock, the device regions of every
        :meth:`sync_device` so far.  Reading the events takes host time
        (milliseconds for a full-width step's regions), so the engine calls
        this while the device works on the next step; every reader of the
        records calls it too."""
        with self._lock:
            synced, self._synced = self._synced, []
        for pending, anchor, T in synced:
            self._place(pending, anchor, T)

    def _place(self, pending: list[tuple], anchor, T: float) -> None:
        """Record each pending region: host-clock points as they are, an
        event ``e`` at ``T - elapsed(e, anchor)``; the events go back to
        the pool."""
        idle = []
        for name, a, b, args in pending:
            args = {k: v.tolist() if _is_tensor(v) else v for k, v in args.items()}
            if not isinstance(a, float):
                idle += (a, b)
                a, b = (T - e.elapsed_time(anchor) * 1e-3 for e in (a, b))
            self.span_at(name, a, b, clock="wall", tid=DEVICE_TID, **args)
        if anchor is not None:
            idle.append(anchor)
        with self._lock:
            self._events += idle

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
        self.place_regions()
        return len(self._buf)

    def records(
        self, kind: str | None = None, name: str | None = None
    ) -> list[dict]:
        """Recorded events (oldest first), optionally filtered."""
        self.place_regions()
        out: Iterable[dict] = self._buf
        if kind is not None:
            out = (r for r in out if r["kind"] == kind)
        if name is not None:
            out = (r for r in out if r["name"] == name)
        return list(out)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._pending.clear()
            self._synced.clear()
        self.n_dropped = 0

    # -- export --------------------------------------------------------------

    def to_chrome(self) -> dict:
        """Chrome/Perfetto ``trace_event`` document.  Clock domains map to
        processes (wall=1, sim=2); timestamps are microseconds."""
        self.place_regions()
        events: list[dict] = [
            {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
             "args": {"name": f"{clock} clock"}}
            for clock, pid in _CLOCK_PID.items()
        ]
        events.append({"ph": "M", "name": "thread_name", "pid": _CLOCK_PID["wall"],
                       "tid": DEVICE_TID, "args": {"name": "device"}})
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
        self.place_regions()
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
