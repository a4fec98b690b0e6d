"""Double-buffered host→device batch prefetch (the port of
``src/repro/train/prefetch.py``).

The partition-major batch is the only bulk host→device transfer of the
step loop (k·mb unique sequences; the (s+1)× replication happens on the
device).  ``DevicePrefetcher`` overlaps it with compute: batch t+1 is built
on a worker thread while the consumer runs step t.

  - On CUDA the worker copies the numpy batch into pinned host tensors and
    issues the host→device copy on a side stream, recording an event.  The
    consumer makes its current stream wait on that event before it hands
    the batch out, and marks the tensors as used on its stream so the
    caching allocator cannot recycle them while the step still reads them.
  - On the CPU the worker builds the tensors and a plain thread queue
    hands them over.

Failure propagation: a raising ``batch()`` on the worker thread ships a
poison pill through the queue and is re-raised on the consumer thread with
the original exception and traceback.  A consumer that abandons the
iterator mid-run (break, exception, generator GC) signals the worker to
stop and joins it, so no thread outlives the loop.
"""

from __future__ import annotations

import queue
import sys
import threading
from typing import Any, Iterator, Protocol

import numpy as np
import torch

__all__ = ["DevicePrefetcher"]

_DONE = object()  # worker sentinel: range exhausted


class _Poison:
    """Worker-thread failure shipped to the consumer for re-raising."""

    __slots__ = ("exc", "tb")

    def __init__(self, exc: BaseException, tb):
        self.exc = exc
        self.tb = tb


class BatchSource(Protocol):
    def batch(self, step: int) -> Any: ...


class DevicePrefetcher:
    """Iterate ``(step, device_batch)`` over ``[start, stop)`` with one batch
    of lookahead built on a worker thread (at most two batches alive)."""

    def __init__(self, data: BatchSource, start: int, stop: int, device="cuda"):
        self.data = data
        self.start = start
        self.stop = stop
        self.device = torch.device(device)
        self._stream = None

    def _load(self, step: int) -> tuple[dict[str, torch.Tensor], Any]:
        batch = self.data.batch(step)
        if self.device.type != "cuda":
            return {k: torch.as_tensor(np.asarray(v)).to(self.device) for k, v in batch.items()}, None
        with torch.cuda.stream(self._stream):
            out = {
                k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(
                    self.device, non_blocking=True
                )
                for k, v in batch.items()
            }
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return out, ready

    def _worker(self, q: queue.Queue, slots: threading.Semaphore,
                stop_ev: threading.Event) -> None:
        try:
            for step in range(self.start, self.stop):
                # bound the lookahead WITHOUT blocking forever: an abandoned
                # consumer sets stop_ev instead of draining the queue
                while not slots.acquire(timeout=0.1):
                    if stop_ev.is_set():
                        return
                if stop_ev.is_set():
                    return
                q.put((step, *self._load(step)))
            q.put(_DONE)
        except BaseException as exc:  # noqa: BLE001 - shipped to the consumer
            q.put(_Poison(exc, sys.exc_info()[2]))

    def __iter__(self) -> Iterator[tuple[int, dict[str, torch.Tensor]]]:
        if self.start >= self.stop:
            return
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
        q: queue.Queue = queue.Queue()  # unbounded: worker puts never block
        slots = threading.Semaphore(2)  # current + one lookahead
        stop_ev = threading.Event()
        worker = threading.Thread(
            target=self._worker, args=(q, slots, stop_ev), name="prefetch", daemon=True,
        )
        worker.start()
        try:
            while True:
                item = q.get()
                if item is _DONE:
                    return
                slots.release()  # the previous batch slot is free again
                if isinstance(item, _Poison):
                    raise item.exc.with_traceback(item.tb)
                step, batch, ready = item
                if ready is not None:
                    cur = torch.cuda.current_stream(self.device)
                    cur.wait_event(ready)
                    for t in batch.values():
                        t.record_stream(cur)
                yield step, batch
        finally:
            stop_ev.set()
            worker.join(timeout=5.0)
