"""Standalone state placement: restore I/O split from device placement (the
port of ``src/repro/checkpoint/placement.py``).

  - :func:`load_arrays` — pure filesystem: manifest + npz → host arrays.
  - :func:`place_state` — pure placement: host arrays → tensors under a
    ``like`` structure, each in its ``like`` leaf's dtype, on its device
    (or on ``device``).
  - :func:`place_rows` — per-worker row-state placement under an optional
    row identity map.  The engine's membership sync and a checkpoint
    restore both go through here, so a live transition and a resume land
    the wire-path error-feedback buffer on the device by one code path.

Keys are the JAX package's keypaths, ``/``-joined (``params/blocks/0/attn/wq``,
``opt/mu/...``, ``opt/step``): the port's dotted parameter names map to
them one to one, so a checkpoint moves between the two packages.  numpy
has no bfloat16 here, so the port writes bf16 leaves as f32 (exact) and
reads a bf16 leaf the JAX package wrote (``|V2``: two raw bytes) by viewing
its bits as bf16.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core.aggregator import remap_err_rows

__all__ = ["load_arrays", "place_state", "place_rows", "leaf_key"]


def leaf_key(prefix: str, name: str) -> str:
    """The JAX keypath of a port leaf: dotted parameter names become
    ``/``-joined path parts."""
    name = name.replace(".", "/")
    return f"{prefix}/{name}" if prefix else name


def load_arrays(directory: str, step: int) -> tuple[dict[str, np.ndarray], dict]:
    """Read one checkpoint's arrays + meta.  Filesystem only."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    return arrays, manifest.get("meta", {})


def _to_tensor(key: str, arr: np.ndarray, ref: torch.Tensor, device) -> torch.Tensor:
    if tuple(arr.shape) != tuple(ref.shape):
        raise ValueError(f"{key}: checkpoint shape {arr.shape} != expected {tuple(ref.shape)}")
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        # a bf16 leaf written without a bf16 numpy dtype: its raw bits
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device=ref.device if device is None else device, dtype=ref.dtype)


def place_state(like: Any, arrays: dict[str, np.ndarray], device=None, prefix: str = "") -> Any:
    """Place host ``arrays`` into the structure of ``like``: a dict of
    tensors (dotted names), a dataclass of such (``AdamWState``), a python
    int (a step counter), or None.  Shapes must match ``like``."""
    if like is None:
        return None
    if isinstance(like, torch.Tensor):
        if prefix not in arrays:
            raise KeyError(f"checkpoint missing leaf {prefix!r}")
        return _to_tensor(prefix, arrays[prefix], like, device)
    if isinstance(like, dict):
        return {k: place_state(v, arrays, device, leaf_key(prefix, k)) for k, v in like.items()}
    if dataclasses.is_dataclass(like):
        return dataclasses.replace(like, **{
            f.name: place_state(getattr(like, f.name), arrays, device, leaf_key(prefix, f.name))
            for f in dataclasses.fields(like)
        })
    if isinstance(like, (int, np.integer)):
        if prefix not in arrays:
            raise KeyError(f"checkpoint missing leaf {prefix!r}")
        return int(arrays[prefix])
    raise TypeError(f"{prefix}: cannot place into a {type(like).__name__}")


def place_rows(
    rows, row_map: Sequence[int | None] | None = None, device=None
) -> torch.Tensor:
    """Place a per-worker (m, width) row buffer on ``device``.

    With ``row_map`` (new index → retained old index or None) the rows are
    remapped through :func:`~repro_torch.core.aggregator.remap_err_rows` —
    retained workers keep their row on its device, joiners get zeros.
    Without a map the buffer is placed as is (checkpoint restore, pure
    rebalance)."""
    if isinstance(rows, torch.Tensor):
        t = rows if device is None else rows.to(device)
    else:
        t = torch.as_tensor(np.asarray(rows, np.float32), device=device)
    if row_map is None:
        return t
    return remap_err_rows(t, row_map)
