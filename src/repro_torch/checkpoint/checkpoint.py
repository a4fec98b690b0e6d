"""Checkpointing: keypath-flattened npz + JSON manifest (the port of
``src/repro/checkpoint/checkpoint.py``).

  - *one layout for both packages*: ``step_XXXXXXXX/arrays.npz`` plus
    ``manifest.json`` (format ``repro-ckpt-v1``), arrays stored by the JAX
    keypath (:func:`~repro_torch.checkpoint.placement.leaf_key`), so a
    checkpoint written here restores in the JAX package and the other way
    round.  bf16 leaves are written as f32, which is exact and which the
    JAX package's restore casts back; a bf16 leaf the JAX package wrote is
    read by its bits (:mod:`repro_torch.checkpoint.placement`).
  - *restart-anywhere*: the checkpoint encodes no device or worker count.
  - *async*: :class:`AsyncCheckpointer` copies the state to the host on the
    caller's thread (the only sync point) and serializes and writes it on a
    worker thread, so the step loop never waits on the disk.
  - *atomic*: writes go to ``<dir>.tmp``, then ``os.replace``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint.placement import leaf_key, load_arrays, place_state

__all__ = ["AsyncCheckpointer", "latest_step", "restore_checkpoint", "save_checkpoint"]


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """``{JAX keypath: numpy array}`` over dicts of tensors, dataclasses of
    such (``AdamWState``), python ints and numpy arrays; None is an empty
    subtree, as in JAX.  Tensors are copied to the host, so the result does
    not change when the step updates them in place.  A flat result
    flattens to itself."""
    if tree is None:
        return {}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().to("cpu", copy=True)
        return {prefix: (t.float() if t.dtype == torch.bfloat16 else t).numpy()}
    if isinstance(tree, dict):
        out: dict[str, np.ndarray] = {}
        for k, v in tree.items():
            out.update(_flatten(v, leaf_key(prefix, k)))
        return out
    if dataclasses.is_dataclass(tree):
        out = {}
        for f in dataclasses.fields(tree):
            out.update(_flatten(getattr(tree, f.name), leaf_key(prefix, f.name)))
        return out
    if isinstance(tree, (int, np.integer)):
        return {prefix: np.asarray(tree, np.int32)}  # the JAX optimizer's step
    return {prefix: np.asarray(tree)}


def save_checkpoint(directory: str, step: int, state: Any, meta: dict | None = None) -> str:
    """Write checkpoint for ``step``.  Returns the final path."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    flat = _flatten(state)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {
        "step": step,
        "keys": sorted(flat),
        "meta": meta or {},
        "format": "repro-ckpt-v1",
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def _steps(directory: str) -> list[int]:
    return sorted(
        int(d.split("_")[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    )


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(
    directory: str, step: int, like: Any, device: torch.device | str | None = None
) -> tuple[Any, dict]:
    """Restore into the structure of ``like`` (shapes must match), each
    leaf in its ``like`` leaf's dtype, on that leaf's device unless
    ``device`` is given.  Returns ``(state, meta)``."""
    arrays, meta = load_arrays(directory, step)
    return place_state(like, arrays, device), meta


class AsyncCheckpointer:
    """Off-critical-path checkpointing: a host copy on the caller's thread
    (the step updates the tensors in place, so the copy is taken before the
    next step), serialization and the write on a worker thread."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_error: BaseException | None = None

    def save(self, step: int, state: Any, meta: dict | None = None) -> None:
        self.wait()
        host_state = _flatten(state)

        def _write():
            try:
                save_checkpoint(self.directory, step, host_state, meta)
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self.last_error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def _gc(self) -> None:
        for s in _steps(self.directory)[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)
