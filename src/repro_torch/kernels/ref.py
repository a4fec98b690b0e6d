"""Plain PyTorch oracles for the kernels (the port of
``src/repro/kernels/ref.py``): independent formulations, so a kernel bug
cannot hide in a shared implementation."""

from __future__ import annotations

import torch


def coded_reduce_ref(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """g: (P, D), w: (P,) -> (D,) in ``g.dtype``, summed in f32."""
    return torch.einsum("p,pd->d", w.float(), g.float()).to(g.dtype)
