"""Public kernel entry points with an ``impl`` switch (the port of
``src/repro/kernels/ops.py``).

``impl``:
  - "cuda":  the hand-written sm_90a kernel; the tensors must be on a card.
  - "torch": the plain PyTorch version, on any device.
  - "best":  measured-fastest on this device (``coded_reduce`` only): on a
             CUDA tensor the kernel at ``autotune.best_launch``'s launch
             shape, on a CPU one ``autotune.library_reduce``, the fastest
             library schedule (as JAX's non-TPU branch is) — see
             ``autotune.py``.
  - None:    "cuda" for a CUDA tensor, "torch" for a CPU one.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import autotune, wire
from repro_torch.kernels.coded_reduce import coded_reduce as _coded_reduce_kernel
from repro_torch.kernels.coded_reduce import coded_reduce_torch
from repro_torch.kernels.flash_attention import flash_attention as _flash_attention_kernel
from repro_torch.kernels.flash_attention import flash_attention_torch, flash_attention_train_torch
from repro_torch.kernels.flash_attention import flash_attention_train as _flash_train_kernel
from repro_torch.kernels.ssd_scan import (
    SSDScanFn, ssd_scan_bwd, ssd_scan_torch, ssd_scan_with_states,
)

IMPLS = ("cuda", "torch", "best")


def _resolve(impl: str | None, x: torch.Tensor, best: bool = False) -> str:
    if impl is None:
        return "cuda" if x.is_cuda else "torch"
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; choose from {IMPLS}")
    if impl == "best" and not best:
        raise ValueError("impl='best' is coded_reduce's only")
    if impl == "cuda" and not x.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors")
    return impl


def coded_reduce(
    g: torch.Tensor, w: torch.Tensor, impl: str | None = None,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    impl = _resolve(impl, g, best=True)
    if impl == "best":
        if not g.is_cuda:
            return autotune.library_reduce(g, w, out_dtype)
        launch = autotune.best_launch(*g.shape, device=g.device, dtype=g.dtype)
        return _coded_reduce_kernel(g, w, out_dtype, launch=launch)
    if impl == "torch":
        return coded_reduce_torch(g, w, out_dtype)
    return _coded_reduce_kernel(g, w, out_dtype)


def coded_encode_int8(
    g: torch.Tensor, w: torch.Tensor, err: torch.Tensor, impl: str | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused wire-format encode: ``(q int8, scale, new_err)`` in one call."""
    if _resolve(impl, g) == "torch":
        return wire.coded_encode_int8_torch(g, w, err)
    return wire.coded_encode_int8(g, w, err)


def coded_decode_int8(q: torch.Tensor, ws: torch.Tensor, impl: str | None = None) -> torch.Tensor:
    """Decode straight off stacked int8 wire payloads under a_w·scale_w."""
    if _resolve(impl, q) == "torch":
        return wire.coded_decode_int8_torch(q, ws)
    return wire.coded_decode_int8(q, ws)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int | None = None, impl: str | None = None,
) -> torch.Tensor:
    """Prefill's online-softmax attention, forward only: q (B,S,H,hd), k /
    v (B,S,K,hd) -> (B,S,H,hd) in q's dtype.  No autograd on the kernel."""
    if _resolve(impl, q) == "torch":
        return flash_attention_torch(q, k, v, causal=causal, window=window)
    return _flash_attention_kernel(q, k, v, causal=causal, window=window)


def flash_attention_train(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int | None = None, impl: str | None = None,
) -> torch.Tensor:
    """Training attention with the model's rounding, differentiable either
    way: q (B,S,H,hd) already scaled by hd^-0.5, k / v (B,S,K,hd) ->
    (B,S,H,hd).  The kernels (bf16; they raise on what they do not take)
    through ``FlashAttentionTrainFn``, the plain version (the model's
    chain) by autograd.  ``models.attention`` decides which and passes
    "cuda" or "torch"."""
    if _resolve(impl, q) == "torch":
        return flash_attention_train_torch(q, k, v, causal=causal, window=window)
    return _flash_train_kernel(q, k, v, causal=causal, window=window)


def ssd_scan(
    x: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, *,
    chunk: int = 128, impl: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The SSD chunked scan: ``(y (B,S,H,P) f32, h (B,H,P,N) f32)``.
    Differentiable either way: the kernel through :class:`SSDScanFn`, the
    plain version by autograd.  :func:`ssd_backward_impl` says which
    backward a call gets."""
    if _resolve(impl, x) == "torch":
        return ssd_scan_torch(x, dA, Bm, Cm, chunk)
    bwd = ssd_scan_bwd if ssd_backward_impl(x, Bm, impl) == "kernel" else None  # None: plain
    return SSDScanFn.apply(x, dA, Bm, Cm, chunk, ssd_scan_with_states, bwd)


def ssd_backward_impl(x: torch.Tensor, Bm: torch.Tensor, impl: str | None = None) -> str:
    """What differentiates :func:`ssd_scan` for these tensors and ``impl``:
    "kernel", the backward kernels, for bf16 B and C on the card (the
    tensor-core forward's), or "plain", autograd of the plain version (the
    CPU, f32 B and C)."""
    cuda = _resolve(impl, x) == "cuda"
    return "kernel" if cuda and Bm.dtype == torch.bfloat16 else "plain"
