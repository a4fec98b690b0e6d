"""Fault-schedule construction: CLI spec grammar + the standard bench mix.

Spec grammar (comma-separated events, whitespace ignored)::

    crash:W@T           worker W's finish -> inf from step T onward
    hang:W@T+D          worker W hangs for D steps starting at T, then recovers
    flaky:W@T..U:P      each step in [T, U) worker W's upload is lost w.p. P
                        (retried with exponential backoff; bounded budget)
    corrupt:W@T..U[:P]  each step in [T, U) worker W's payload is non-finite
                        w.p. P (default 1.0)

Examples::

    --faults "crash:3@40"
    --faults "hang:1@20+10,flaky:2@0..100:0.3,corrupt:0@50..60"

W is the ORIGINAL worker id (the index at schedule-creation time — faults
follow the physical node across membership transitions).
"""

from __future__ import annotations

import re

from repro_torch.core.simulator import FaultEvent, FaultSchedule

__all__ = ["parse_fault_spec", "standard_fault_mix"]

_EVENT_RE = re.compile(
    r"""^(?P<kind>crash|hang|flaky|corrupt):(?P<worker>\d+)@(?P<step>\d+)
        (?:\+(?P<duration>\d+)|\.\.(?P<until>\d+))?
        (?::(?P<prob>[0-9.eE+-]+))?$""",
    re.VERBOSE,
)


def parse_fault_spec(spec: str) -> FaultSchedule:
    """Parse the ``--faults`` grammar (module docstring) into a schedule."""
    events: list[FaultEvent] = []
    for raw in spec.split(","):
        tok = raw.strip()
        if not tok:
            continue
        m = _EVENT_RE.match(tok)
        if m is None:
            raise ValueError(
                f"bad fault spec {tok!r}; expected e.g. 'crash:3@40', "
                "'hang:1@20+10', 'flaky:2@0..100:0.3', 'corrupt:0@50..60'"
            )
        kind = m.group("kind")
        step = int(m.group("step"))
        duration: int | None = None
        if m.group("duration") is not None:
            duration = int(m.group("duration"))
        elif m.group("until") is not None:
            until = int(m.group("until"))
            if until <= step:
                raise ValueError(f"fault window must end after it starts: {tok!r}")
            duration = until - step
        prob = float(m.group("prob")) if m.group("prob") is not None else 1.0
        if kind == "crash" and duration is not None:
            raise ValueError(f"crash is permanent — drop the window: {tok!r}")
        if kind == "hang" and duration is None:
            raise ValueError(f"hang needs '+D' (it must end to recover): {tok!r}")
        if kind in ("flaky", "corrupt") and duration is None:
            raise ValueError(f"{kind} needs a '..U' window: {tok!r}")
        events.append(
            FaultEvent(kind=kind, worker=int(m.group("worker")), step=step,
                       duration=duration, prob=prob)
        )
    return FaultSchedule(events)


def standard_fault_mix(
    m: int, *, crash_step: int = 8, hang_step: int = 20, hang_len: int = 6
) -> FaultSchedule:
    """The bench/gate reference mix: 1 crash + 1 hang on distinct workers.
    The gap between onsets gives the supervisor time to convict and evict
    the crashed worker before the hang begins, so an s=1 code never sees
    two dark workers at once."""
    if m < 2:
        raise ValueError("standard fault mix needs m >= 2")
    if crash_step >= hang_step:
        raise ValueError("crash must precede the hang window")
    return FaultSchedule([
        FaultEvent(kind="crash", worker=m - 1, step=crash_step),
        FaultEvent(kind="hang", worker=0, step=hang_step, duration=hang_len),
    ])
