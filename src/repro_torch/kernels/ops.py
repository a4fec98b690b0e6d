"""Public kernel entry points with an ``impl`` switch (the port of
``src/repro/kernels/ops.py``).

``impl``:
  - "cuda":  the hand-written sm_90a kernel; the tensors must be on a card.
  - "torch": the plain PyTorch version, on any device.
  - None:    "cuda" for a CUDA tensor, "torch" for a CPU one.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.coded_reduce import coded_reduce as _coded_reduce_kernel
from repro_torch.kernels.coded_reduce import coded_reduce_torch

IMPLS = ("cuda", "torch")


def coded_reduce(
    g: torch.Tensor, w: torch.Tensor, impl: str | None = None,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    if impl is None:
        impl = "cuda" if g.is_cuda else "torch"
    if impl == "torch":
        return coded_reduce_torch(g, w, out_dtype)
    if impl == "cuda":
        if not g.is_cuda:
            raise ValueError("impl='cuda' needs CUDA tensors")
        return _coded_reduce_kernel(g, w, out_dtype)
    raise ValueError(f"unknown impl {impl!r}; choose from {IMPLS}")
