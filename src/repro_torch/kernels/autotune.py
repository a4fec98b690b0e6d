"""Measurement-driven kernel selection (the port of
``src/repro/kernels/autotune.py``).

Every "fastest" choice in the kernel layer is backed by a timing on the
device that will run it, not by an assumption:

  - :func:`interleaved_best_us` is the timing discipline: candidates are
    timed in INTERLEAVED rounds, so drift in the machine's load hits all of
    them equally, and each candidate keeps its best round.  A candidate
    whose output lies on a card is timed with CUDA events on the current
    stream, so the host's asynchronous launch cannot make a slow kernel
    look fast; one whose output lies on the CPU by ``time.perf_counter``.
  - :func:`best_launch` is the counterpart of JAX's ``best_tile_d``: the
    ``(max_blocks, threads)`` launch shape of ``csrc/coded_reduce.cu`` that
    measured fastest at (P, D) on this card.  A CPU device answers None at
    once (the kernel runs on cards only).
  - :func:`best_reduce_schedule` picks the fastest library schedule for the
    (P,)·(P, D) reduction on a device (``matmul``, ``einsum``,
    ``tensordot``, and at P <= 64 the unrolled mul-add chain), and
    :func:`library_reduce` (JAX's ``xla_reduce``) applies it: the body of
    ``ops.coded_reduce(impl="best")`` on a CPU tensor.
  - :func:`wire_kernel_default` decides whether the spmd wire path uses the
    fused int8 encode when the caller leaves ``wire_kernel=None``: True only
    on a CUDA device AND only if the fused encode beats the unfused
    composition (``coded_reduce`` + the plain quantize) in a probe on this
    very card.  A CPU device answers False at once, with no timing cost.

Results are cached per (question, device, shape) for the process lifetime,
with the probe's timings in :data:`PROBE_US`; each choice is also recorded
as an ``autotune`` instant on the installed tracer, so a trace shows what
was picked and why.
"""

from __future__ import annotations

import functools
import time
from typing import Callable

import torch

_CACHE: dict = {}
PROBE_US: dict = {}  # (question, device, shape) -> the probe's µs per candidate

# beyond this the unrolled chain's op count outweighs its single pass, as
# in the JAX module
_UNROLL_MAX_P = 64


def _on_cuda(out) -> bool:
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return any(isinstance(o, torch.Tensor) and o.is_cuda for o in outs)


def interleaved_best_us(
    fns: dict[str, Callable[[], object]],
    *,
    rounds: int = 4,
    iters: int = 3,
    warmup: int = 2,
) -> dict[str, float]:
    """Best-of-interleaved-rounds time (µs per call) for each candidate:
    device time on the current CUDA stream for a candidate that returns a
    CUDA tensor, wall time for one that returns CPU tensors.  Warmup calls
    absorb the build and first-launch costs."""
    on_cuda = {}
    for name, fn in fns.items():
        for _ in range(warmup):
            out = fn()
        on_cuda[name] = _on_cuda(out)
    if any(on_cuda.values()):
        torch.cuda.synchronize()
    best = {name: float("inf") for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            if on_cuda[name]:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    fn()
                end.record()
                end.synchronize()
                us = start.elapsed_time(end) / iters * 1e3
            else:
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn()
                us = (time.perf_counter() - t0) / iters * 1e6
            best[name] = min(best[name], us)
    return best


def _record(question: str, choice, timings: dict[str, float] | None) -> None:
    try:  # tracing is optional; autotune must work without the obs layer
        from repro_torch.obs.trace import get_tracer

        get_tracer().instant(
            "autotune", question=question, choice=str(choice),
            **({f"us_{k}": round(v, 1) for k, v in timings.items()} if timings else {}),
        )
    except Exception:
        pass


def _device_key(device: torch.device | str) -> tuple[str, int | None]:
    device = torch.device(device)
    if device.type == "cuda":
        return "cuda", device.index if device.index is not None else torch.cuda.current_device()
    return device.type, device.index


def best_launch(
    P: int, D: int, device: torch.device | str = "cuda", dtype: torch.dtype = torch.float32
) -> tuple[int, int] | None:
    """The ``(max_blocks, threads)`` of ``csrc/coded_reduce.cu`` that
    measured fastest for a (P, D) ``dtype`` stack on this card (f32 out for
    int8, ``dtype`` out otherwise); None on a CPU device, at once.

    The candidates are every thread count of ``coded_reduce.THREADS`` with
    every block cap of ``coded_reduce.BLOCK_CAPS`` (the default launch
    among them), timed on zeros."""
    dev_type, index = _device_key(device)
    if dev_type != "cuda":
        return None
    key = ("launch", index, P, D, str(dtype))
    if key not in _CACHE:
        from repro_torch.kernels.coded_reduce import BLOCK_CAPS, THREADS, coded_reduce

        dev = torch.device("cuda", index)
        g = torch.zeros((P, D), dtype=dtype, device=dev)
        w = torch.ones((P,), dtype=torch.float32, device=dev)
        out = torch.empty((D,), dtype=torch.float32 if dtype == torch.int8 else dtype,
                          device=dev)
        shapes = [(blocks, threads) for threads in THREADS for blocks in BLOCK_CAPS]
        with torch.cuda.device(dev):
            times = interleaved_best_us({
                f"{b}x{t}": functools.partial(coded_reduce, g, w, out=out, launch=(b, t))
                for b, t in shapes})
        del g, out
        choice = shapes[list(times).index(min(times, key=times.get))]
        PROBE_US[key] = times
        _record(f"launch P={P} D={D} {dtype}", choice, times)
        _CACHE[key] = choice
    return _CACHE[key]


def _unrolled_reduce(w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    acc = w[0] * g[0]
    for p in range(1, g.shape[0]):
        acc = acc + w[p] * g[p]
    return acc


# the library schedules of the (P,)·(P, D) reduce, all in the inputs' dtype
SCHEDULES: dict[str, Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = {
    "matmul": lambda w, g: (w[None, :] @ g)[0],
    "einsum": lambda w, g: torch.einsum("p,pd->d", w, g),
    "tensordot": lambda w, g: torch.tensordot(w, g, dims=1),
    "unroll": _unrolled_reduce,
}


def best_reduce_schedule(P: int, D: int, device: torch.device | str = "cpu") -> str:
    """Fastest library schedule for the (P,)·(P, D) f32 reduction on
    ``device``, among :data:`SCHEDULES` (``unroll`` only at P <= 64).
    Cached per (device, P, D); the probe's timings go into
    :data:`PROBE_US`."""
    dev_type, index = _device_key(device)
    key = ("reduce_schedule", dev_type, index, P, D)
    if key not in _CACHE:
        dev = torch.device(dev_type, index) if index is not None else torch.device(dev_type)
        g = torch.zeros((P, D), dtype=torch.float32, device=dev)
        w = torch.ones((P,), dtype=torch.float32, device=dev)
        names = [n for n in SCHEDULES if n != "unroll" or P <= _UNROLL_MAX_P]
        times = interleaved_best_us({n: functools.partial(SCHEDULES[n], w, g) for n in names})
        del g
        choice = min(times, key=times.get)
        PROBE_US[key] = times
        _record(f"reduce_schedule P={P} D={D}", choice, times)
        _CACHE[key] = choice
    return _CACHE[key]


def library_reduce(
    g: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype | None = None
) -> torch.Tensor:
    """The measured-fastest library schedule applied (JAX's ``xla_reduce``):
    Σ_p w[p]·g[p] in f32, cast to ``out_dtype`` (default ``g.dtype``)."""
    sched = best_reduce_schedule(*g.shape, device=g.device)
    out = SCHEDULES[sched](w.float(), g.float())
    return out.to(g.dtype if out_dtype is None else out_dtype)


def wire_kernel_default(
    device: torch.device | str = "cuda", P: int = 8, D: int = 1 << 16
) -> bool:
    """Should the spmd wire path use the fused int8 encode by default?

    True only on a CUDA device and only when the fused encode measures
    faster than the unfused composition at (P, D) on that card.  A CPU
    device: False, instantly."""
    dev_type, index = _device_key(device)
    if dev_type != "cuda":
        return False
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
        _record(f"wire_kernel P={P} D={D}", times["fused"] <= times["unfused"], times)
        _CACHE[key] = times["fused"] <= times["unfused"]
    return _CACHE[key]
