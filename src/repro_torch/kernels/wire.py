"""The int8 wire format's kernels: the fused encode and the int8 decode (the
port of ``src/repro/kernels/wire.py``).

The compressed spmd wire sends each worker's coded gradient as int8 with one
global scale, and keeps the quantization residual as error feedback:

    coded   = Σ_p w[p]·g[p] + err
    scale   = max(max|coded|, EPS_SCALE) · f32(INV_127)
    q       = clip(round_half_even(coded / scale), -127, 127)     int8
    new_err = coded − q·scale, rounded once

:func:`coded_encode_int8` computes all of it in one call.  On a CUDA tensor
it launches the hand-written sm_90a kernel in ``csrc/wire_encode.cu``
(header there: the two-pass design and its bit contract), which keeps the
f32 coded tensor in the ``new_err`` buffer instead of a separate wire
tensor; on a CPU tensor it runs :func:`coded_encode_int8_torch`, the plain
version.  The kernel is bit-equal to ``ref.encode_int8_oracle_np`` with
``coded_reduce`` (f32 out) as its reduce, since both sum in the order of
``csrc/coded_accum.cuh``.

:func:`coded_decode_int8` reads the wire directly: Σ_w ws[w]·q[w] over the
(m, D) int8 payloads, where ws = a_w·scale_w, so dequantization is the
weight multiply.  On the card it is ``coded_reduce``'s int8 → f32 kernel,
as the JAX package's decode is ``coded_reduce_pallas``.

There is no fallback between the two versions: a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels.build import library
from repro_torch.kernels.coded_reduce import coded_reduce, coded_reduce_torch
from repro_torch.kernels.ref import quantize_int8

__all__ = [
    "EPS_SCALE",
    "INV_127",
    "coded_encode_int8",
    "coded_encode_int8_torch",
    "coded_decode_int8",
    "coded_decode_int8_torch",
]

EPS_SCALE = 1e-12  # quantize floor: scale = max(max|coded|, EPS_SCALE)·(1/127)
# the scale is a MULTIPLY by the f32 constant 1/127 (np.float32(INV_127)),
# never a division by 127: an IEEE multiply by an agreed constant is exact
# to reproduce anywhere
INV_127 = 1.0 / 127.0

# dtype codes of the C interface (csrc/wire_encode.cu)
_CODES = {torch.float32: 0, torch.bfloat16: 1}

_bound: ctypes.CDLL | None = None


def coded_encode_int8_torch(
    g: torch.Tensor, w: torch.Tensor, err: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version: ``(q (D,) int8, scale () f32, new_err (D,) f32)``.

    The reduce is :func:`coded_reduce_torch` in f32, the quantize the wire
    format's definition (``ref.quantize_int8``); ``new_err`` is the exact
    residual computed in f64 and rounded once to f32."""
    coded = coded_reduce_torch(g, w, torch.float32) + err
    q, scale = quantize_int8(coded)
    new_err = (coded.double() - q.double() * scale.double()).float()
    return q, scale, new_err


def coded_decode_int8_torch(q: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """The plain version: (m, D) int8, (m,) f32 -> (D,) f32 = Σ_w ws[w]·q[w]."""
    return coded_reduce_torch(q, ws, torch.float32)


def _lib() -> ctypes.CDLL:
    """The built library, its C signatures bound once."""
    global _bound
    if _bound is None:
        lib = library("wire_encode")
        lib.wire_encode_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.wire_encode_launch.restype = ctypes.c_int
        lib.wire_encode_max_rows.argtypes = []
        lib.wire_encode_max_rows.restype = ctypes.c_int
        for name in ("wire_encode_inv127", "wire_encode_eps"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_float
        _bound = lib
    return _bound


def kernel_constants() -> tuple[np.float32, np.float32]:
    """``(EPS, 1/127)`` as the built CUDA library computes with them."""
    lib = _lib()
    return np.float32(lib.wire_encode_eps()), np.float32(lib.wire_encode_inv127())


def _check_out(name: str, out: torch.Tensor | None, D: int, dtype: torch.dtype,
               device: torch.device) -> None:
    if out is not None and (
        out.shape != (D,) or out.dtype != dtype or not out.is_contiguous()
        or out.device != device
    ):
        raise ValueError(f"{name} must be a contiguous ({D},) {dtype} tensor on {device}")


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() and b0 < a0 + a.numel() * a.element_size()


def coded_encode_int8(
    g: torch.Tensor,
    w: torch.Tensor,
    err: torch.Tensor,
    *,
    out_err: torch.Tensor | None = None,
    out_q: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """g: (P, D) f32/bf16; w: (P,) f32; err: (D,) f32 ->
    ``(q (D,) int8, scale () f32, new_err (D,) f32)``.

    ``out_err`` is an optional (D,) f32 result buffer; it may be ``err``
    itself (the update is then in place) but must not partly overlap it.
    ``out_q`` is an optional (D,) int8 result buffer.  A CPU tensor runs
    the plain version; a CUDA tensor launches the kernel (counted in
    ``coded_encode_int8.launches``) or raises."""
    if g.dim() != 2 or w.dim() != 1 or w.shape[0] != g.shape[0]:
        raise ValueError(f"need g (P, D) and w (P,), got {tuple(g.shape)} and {tuple(w.shape)}")
    P, D = g.shape
    if P < 1 or D < 1:
        raise ValueError(f"empty encode: g {tuple(g.shape)}")
    if g.dtype not in _CODES:
        raise TypeError(f"g dtype {g.dtype} not in {list(_CODES)}")
    if err.shape != (D,) or err.dtype != torch.float32:
        raise ValueError(f"err must be a ({D},) float32 tensor, got {tuple(err.shape)} {err.dtype}")
    if w.device != g.device or err.device != g.device:
        raise ValueError("g, w and err must be on one device")
    _check_out("out_err", out_err, D, torch.float32, g.device)
    _check_out("out_q", out_q, D, torch.int8, g.device)
    if out_err is not None and out_err.data_ptr() != err.data_ptr() and _overlaps(out_err, err):
        raise ValueError("out_err must be err itself or disjoint from it")
    if g.device.type == "cpu":
        q, scale, new_err = coded_encode_int8_torch(g, w, err)
        if out_q is not None:
            q = out_q.copy_(q)
        if out_err is not None:
            new_err = out_err.copy_(new_err)
        return q, scale, new_err
    if g.device.type != "cuda":
        raise ValueError(f"coded_encode_int8 runs on cpu or cuda tensors, not {g.device}")
    if w.dtype != torch.float32:
        raise TypeError(f"w must be float32, got {w.dtype}")
    if not (g.is_contiguous() and w.is_contiguous() and err.is_contiguous()):
        raise ValueError("g, w and err must be contiguous")
    lib = _lib()
    if P > lib.wire_encode_max_rows():
        raise ValueError(f"coded_encode_int8 takes at most {lib.wire_encode_max_rows()} rows, got {P}")
    new_err = torch.empty((D,), dtype=torch.float32, device=g.device) if out_err is None else out_err
    q = torch.empty((D,), dtype=torch.int8, device=g.device) if out_q is None else out_q
    scale = torch.empty((), dtype=torch.float32, device=g.device)
    mx = torch.zeros((1,), dtype=torch.int32, device=g.device)  # max|coded| as bits
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = lib.wire_encode_launch(
            g.data_ptr(), w.data_ptr(), err.data_ptr(), new_err.data_ptr(), q.data_ptr(),
            scale.data_ptr(), mx.data_ptr(), P, D, _CODES[g.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(f"coded_encode_int8 launch failed: cudaError_t {rc}")
    coded_encode_int8.launches += 1
    return q, scale, new_err


coded_encode_int8.launches = 0  # kernel launches; the plain CPU version never counts


def coded_decode_int8(q: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """q: (m, D) int8 wire payloads; ws: (m,) f32 per-worker a_w·scale_w ->
    the decoded (D,) f32.  A CPU tensor runs the plain version; a CUDA
    tensor launches ``coded_reduce``'s int8 → f32 kernel (counted in
    ``coded_decode_int8.launches`` and in ``coded_reduce.launches``) or
    raises."""
    if q.dim() != 2 or ws.dim() != 1 or ws.shape[0] != q.shape[0]:
        raise ValueError(f"need q (m, D) and ws (m,), got {tuple(q.shape)} and {tuple(ws.shape)}")
    if q.dtype != torch.int8:
        raise TypeError(f"q must be int8, got {q.dtype}")
    if ws.device != q.device:
        raise ValueError("q and ws must be on one device")
    if q.device.type == "cpu":
        if q.shape[0] < 1 or q.shape[1] < 1:
            raise ValueError(f"empty decode: q {tuple(q.shape)}")
        return coded_decode_int8_torch(q, ws)
    out = coded_reduce(q, ws, torch.float32)
    coded_decode_int8.launches += 1
    return out


coded_decode_int8.launches = 0  # kernel launches; the plain CPU version never counts
