"""Plain PyTorch oracles for the kernels (the port of
``src/repro/kernels/ref.py``): independent formulations, so a kernel bug
cannot hide in a shared implementation.  The int8 wire format is defined
here, as in the JAX package: :func:`quantize_int8` / :func:`dequantize`
in torch, and :func:`encode_int8_oracle_np`, the bit-level oracle of the
fused encode, in strict per-operation numpy.  :func:`ssd_ref` is the SSD
scan's O(S) sequential recurrence, deliberately not the chunked algorithm
of the kernel and of its plain version."""

from __future__ import annotations

import numpy as np
import torch

_EPS = np.float32(1e-12)
# the format's scale is a MULTIPLY by this f32 constant, not a division by 127
_INV_127 = np.float32(1.0 / 127.0)


def coded_reduce_ref(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """g: (P, D), w: (P,) -> (D,) in ``g.dtype``, summed in f32."""
    return torch.einsum("p,pd->d", w.float(), g.float()).to(g.dtype)


def ssd_ref(
    x: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
    h0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """O(S) sequential state-space recurrence.  x: (B,S,H,P) pre-multiplied
    by dt, dA (B,S,H), Bm / Cm (B,S,G,N), optional initial state h0
    (B,H,P,N).  Returns (y (B,S,H,P) in ``x.dtype``, h (B,H,P,N) f32)."""
    B, S, H, P = x.shape
    rep = H // Bm.shape[2]
    f32 = torch.float32
    Bh = Bm.repeat_interleave(rep, dim=2).to(f32)
    Ch = Cm.repeat_interleave(rep, dim=2).to(f32)
    N = Bm.shape[3]
    h = torch.zeros((B, H, P, N), dtype=f32, device=x.device) if h0 is None else h0.to(f32)
    ys = []
    for t in range(S):
        a = torch.exp(dA[:, t]).to(f32)  # (B,H)
        h = h * a[..., None, None] + torch.einsum("bhp,bhn->bhpn", x[:, t].to(f32), Bh[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), h


def quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization with one global scale, the wire format's
    definition.  Returns ``(q int8, scale f32 0-d)``.

    ``scale`` is max(max|g|, 1e-12) MULTIPLIED by f32(1/127); a NaN
    anywhere in ``g`` gives a NaN scale.  ``g / scale`` is IEEE division
    and ``torch.round`` rounds half to even."""
    g = g.float()
    mx = torch.maximum(g.abs().max(), torch.tensor(_EPS, device=g.device))
    scale = mx * torch.tensor(_INV_127, device=g.device)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def encode_int8_ref(
    g: torch.Tensor, w: torch.Tensor, err: torch.Tensor, *, reduce_fn=None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unfused wire-format composition: reduce -> +err -> quantize ->
    residual.  Materializes the f32 ``coded`` tensor that the fused kernel
    keeps out of device memory.  ``reduce_fn(g, w)`` defaults to
    :func:`coded_reduce_ref`; its result is taken in f32."""
    reduce_fn = coded_reduce_ref if reduce_fn is None else reduce_fn
    coded = reduce_fn(g, w).float() + err
    q, scale = quantize_int8(coded)
    return q, scale, coded - dequantize(q, scale)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def encode_int8_oracle_np(g, w, err, *, reduce_fn):
    """Bit-level oracle of the fused encode.

    Strict per-operation IEEE f32 numpy arithmetic (no compiler, so no
    fusion discretion), except ``new_err``: the correctly-rounded exact
    residual.  ``q·scale`` (8-bit int times 24-bit float) and ``coded`` are
    exact in f64 and so is their difference, so one final cast rounds once,
    as the kernel's fused multiply-subtract does.  ``reduce_fn`` must be the
    kernel's own reduce with an f32 result (on the card, ``coded_reduce``
    with ``out_dtype=torch.float32``) so the accumulation order matches bit
    for bit; it may return a tensor on any device or an array.  Returns
    numpy ``(q int8, scale f32, new_err f32)``."""
    red = _host(reduce_fn(g, w)).astype(np.float32)
    coded = (red + _host(err).astype(np.float32)).astype(np.float32)
    mx = np.maximum(np.max(np.abs(coded)), _EPS).astype(np.float32)
    scale = (mx * _INV_127).astype(np.float32)
    q = np.clip(np.round((coded / scale).astype(np.float32)), -127, 127).astype(np.int8)
    new_err = (
        coded.astype(np.float64) - q.astype(np.float64) * np.float64(scale)
    ).astype(np.float32)
    return q, scale, new_err
