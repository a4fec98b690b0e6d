"""Measurement-driven kernel selection (a partial port of
``src/repro/kernels/autotune.py``).

  - :func:`interleaved_best_us` is the timing discipline: candidates are
    timed in INTERLEAVED rounds, so drift in the machine's load hits all of
    them equally, and each candidate keeps its best round.  Each round is
    timed with CUDA events on the current stream, so the host's
    asynchronous launch cannot make a slow kernel look fast.
  - :func:`wire_kernel_default` decides whether the spmd wire path uses the
    fused int8 encode when the caller leaves ``wire_kernel=None``: True only
    on a CUDA device AND only if the fused encode beats the unfused
    composition (``coded_reduce`` + the plain quantize) in a probe on this
    very card.  A CPU device answers False at once, with no timing cost.

Results are cached per (question, device, shape) for the process lifetime,
with the probe's timings in :data:`PROBE_US`.
The tile and reduce-schedule tuners of the JAX module are not ported.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

_CACHE: dict = {}
PROBE_US: dict = {}  # (question, device, shape) -> the probe's µs per candidate


def interleaved_best_us(
    fns: dict[str, Callable[[], object]],
    *,
    rounds: int = 4,
    iters: int = 3,
    warmup: int = 2,
) -> dict[str, float]:
    """Best-of-interleaved-rounds device time (µs per call) for each
    candidate, on the current CUDA stream.  Warmup calls absorb the build
    and first-launch costs."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    best = {name: float("inf") for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            best[name] = min(best[name], start.elapsed_time(end) / iters * 1e3)
    return best


def wire_kernel_default(
    device: torch.device | str = "cuda", P: int = 8, D: int = 1 << 16
) -> bool:
    """Should the spmd wire path use the fused int8 encode by default?

    True only on a CUDA device and only when the fused encode measures
    faster than the unfused composition at (P, D) on that card.  A CPU
    device: False, instantly."""
    device = torch.device(device)
    if device.type != "cuda":
        return False
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = ("wire_kernel", index, P, D)
    if key not in _CACHE:
        from repro_torch.kernels import ref
        from repro_torch.kernels.coded_reduce import coded_reduce
        from repro_torch.kernels.wire import coded_encode_int8

        dev = torch.device("cuda", index)
        g = torch.zeros((P, D), dtype=torch.float32, device=dev)
        w = torch.ones((P,), dtype=torch.float32, device=dev)
        err = torch.zeros((D,), dtype=torch.float32, device=dev)
        reduce_f32 = functools.partial(coded_reduce, out_dtype=torch.float32)
        with torch.cuda.device(dev):
            times = interleaved_best_us({
                "fused": functools.partial(coded_encode_int8, g, w, err),
                "unfused": functools.partial(ref.encode_int8_ref, g, w, err,
                                             reduce_fn=reduce_f32),
            })
        PROBE_US[key] = times
        _CACHE[key] = times["fused"] <= times["unfused"]
    return _CACHE[key]
