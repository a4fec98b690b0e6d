"""The device side of a traced run: ``torch.profiler`` (CUPTI) over the
timed window, reduced to device intervals on the host's ``perf_counter``.

The device events are read from the profiler's own event list; nothing is
written to disk.  The trace's clock is tied to the host's by one marker kernel
(``torch.cuda._sleep``, ATen's ``spin_kernel``) launched just after a
synchronize at a known host time; a kernel starts a few microseconds
after its launch, well under the millisecond gaps this reads.
"""

from __future__ import annotations

import time

import torch

MARKER = "spin_kernel"


class DeviceTrace:
    def __init__(self):
        self._prof = None
        self._mark = 0.0
        self.events: list[tuple[str, float, float]] = []  # (name, start, end), host seconds

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._mark = time.perf_counter()
        torch.cuda._sleep(1)
        torch.cuda.synchronize()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        dev = self._device_events()
        self._prof = None
        if not dev:
            raise RuntimeError("the profiler recorded no device activity")
        mark = next((t for t, _, name in dev if MARKER in name), dev[0][0])
        off = mark - self._mark
        self.events = [(name, t - off, t + dur - off) for t, dur, name in dev if MARKER not in name]

    def _device_events(self) -> list[tuple[float, float, str]]:
        """(start, duration, name) of every kernel, copy and memset, in
        seconds, from the profiler's own event list."""
        from torch.autograd import DeviceType

        return sorted((e.start_ns() * 1e-9, e.duration_ns() * 1e-9, e.name())
                      for e in self._prof.profiler.kineto_results.events()
                      if e.device_type() == DeviceType.CUDA)

    def busy(self, t0: float, t1: float) -> list[tuple[float, float]]:
        """The union of device intervals clipped to [t0, t1]."""
        out: list[list[float]] = []
        for _, a, b in self.events:
            a, b = max(a, t0), min(b, t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self, t0: float, t1: float) -> float:
        return sum(b - a for a, b in self.busy(t0, t1))

    def gaps(self, t0: float, t1: float) -> list[tuple[float, float]]:
        """The idle intervals of [t0, t1]."""
        out, at = [], t0
        for a, b in self.busy(t0, t1):
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if t1 > at:
            out.append((at, t1))
        return out

    def by_name(self, t0: float, t1: float) -> dict[str, float]:
        """Device seconds by kernel name inside [t0, t1]."""
        out: dict[str, float] = {}
        for name, a, b in self.events:
            a, b = max(a, t0), min(b, t1)
            if b > a:
                out[name] = out.get(name, 0.0) + (b - a)
        return out


def idle_by_span(gaps: list[tuple[float, float]],
                 spans: list[tuple[str, float, float, dict]]) -> dict[str, float]:
    """Idle seconds by the innermost host span open where each gap starts
    (``no_span_open`` where none is)."""
    points = sorted({t for _, s0, s1, _ in spans for t in (s0, s1)})
    pieces = []  # (start, end, innermost span) between consecutive boundaries
    for a, b in zip(points, points[1:]):
        best, name = float("inf"), "no_span_open"
        for s, s0, s1, _ in spans:
            if s0 <= a and b <= s1 and s1 - s0 < best:
                best, name = s1 - s0, s
        pieces.append((a, b, name))
    out: dict[str, float] = {}
    i = 0
    for a, b in sorted(gaps):
        while i < len(pieces) and pieces[i][1] <= a:
            i += 1
        name = pieces[i][2] if i < len(pieces) and pieces[i][0] <= a else "no_span_open"
        out[name] = out.get(name, 0.0) + (b - a)
    return out


def top(d: dict[str, float], n: int = 10, width: int = 120) -> list[list]:
    return [[k[:width], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
