"""ssd_gate_norm: the Mamba2 block's epilogue after the SSD scan.

Per token row, d = H·P columns, head h of column c = c // P, with the
model's rounding points (``models/ssm.py``: the D skip, the SiLU gate and
the gated RMSNorm of mamba2):

    y1  = bf16(y + D[h]·xs)
    g   = bf16(y1 · bf16(silu(z)))
    out = bf16(g · rsqrt(mean(g²) + eps) · norm)

Layouts: y (B,S,H,P) f32 (the scan's output), xs (B,S,H,P) and z (B,S,d) in
the activation dtype, D (H,) f32, norm (d,); out (B,S,d).

- :func:`ssd_gate_norm_torch` is the plain version: the model's chain, op
  for op, bit-equal to ``mamba_forward`` before the kernels; autograd
  differentiates it.
- :func:`ssd_gate_norm_bwd_torch` is the kernels' backward written once in
  plain PyTorch: the same closed form, from the same saved operands, for
  the CPU tests.
- :func:`ssd_gate_norm` and :func:`ssd_gate_norm_bwd` launch the
  hand-written sm_90a kernels of ``csrc/ssd_gate_norm.cu`` (header there:
  the arithmetic, the bound, the design) on bf16 CUDA tensors, counted in
  ``ssd_gate_norm.launches`` and ``ssd_gate_norm_bwd.launches``, and
  :class:`SSDGateNormFn` makes them differentiable.  xs and z may be the
  strided views ``mamba_forward`` holds (slices of the in-projection's
  output): the kernels read them in place.  The JAX package leaves this
  chain to XLA, so no TPU kernel is replaced: the pair exists because the
  eager chain moves some nine times the bytes its operands and results
  need, most of them f32 copies of bf16 tensors.

``kernels.ops.ssd_gate_norm`` routes by device, dtype and type alone
(``ops.ssd_gate_norm_impl``).  There is no fallback between the two: a
CUDA tensor given to the kernel wrappers launches the kernels or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import library
from repro_torch.models.layers import rms_norm

__all__ = [
    "MAX_D", "SSDGateNormFn", "launch_shape", "ssd_gate_norm", "ssd_gate_norm_bwd",
    "ssd_gate_norm_bwd_torch", "ssd_gate_norm_torch",
]

EPT = 16  # most elements a thread holds (csrc/ssd_gate_norm.cu's instantiations)
MAX_THREADS = 1024  # most threads along a row
MAX_D = EPT * MAX_THREADS  # the widest row the kernels take (jamba's d_inner)
_BLOCK = 256  # threads a block where a row takes fewer (several rows a block)

_bound: ctypes.CDLL | None = None


def ssd_gate_norm_torch(
    y: torch.Tensor, xs: torch.Tensor, z: torch.Tensor, D: torch.Tensor, norm: torch.Tensor,
    eps: float = 1e-5,
) -> torch.Tensor:
    """The plain version, the model's chain op for op: (B, S, d) in z's
    dtype."""
    B, S, H, P = xs.shape
    y = y + D[None, None, :, None] * xs.float()
    y = y.reshape(B, S, H * P).to(z.dtype)
    return rms_norm(y * F.silu(z), norm, eps)


def ssd_gate_norm_bwd_torch(
    go: torch.Tensor, y: torch.Tensor, xs: torch.Tensor, z: torch.Tensor, D: torch.Tensor,
    norm: torch.Tensor, eps: float = 1e-5,
) -> tuple[torch.Tensor, ...]:
    """The kernels' backward in plain PyTorch: ``(dy, dxs, dz, dD, dnorm)``
    from out's gradient ``go`` (B, S, d), each in its input's dtype.  The
    forward's values (y1, s, g, r) recomputed as the chain rounds them,
    then in f32 (f64 for f64 inputs), straight through each rounding:

        dn = go·norm,  dg = r·dn − g·r³·Σ(dn·g)/d,  dy = dg·s,
        dxs = D·dy,  dz = dg·y1·σ(z)(1 + z(1 − σ(z))),
        dnorm = Σ_rows go·(g·r),  dD[h] = Σ_{rows, p ∈ h} dy·xs."""
    B, S, H, P = xs.shape
    d = H * P
    f = torch.float64 if y.dtype == torch.float64 else torch.float32
    x = xs.to(f).reshape(B, S, d)
    Dc = D.to(f).repeat_interleave(P)
    y1 = (y.to(f).reshape(B, S, d) + Dc * x).to(z.dtype)
    s = F.silu(z)
    g = (y1 * s).to(f)
    r = torch.rsqrt(g.square().mean(-1, keepdim=True) + eps)
    gof = go.to(f)
    dn = gof * norm.to(f)
    dg = r * dn - g * (r * r * r * (dn * g).sum(-1, keepdim=True) / d)
    dy = dg * s.to(f)
    zf = z.to(f)
    sig = torch.sigmoid(zf)
    dz = (dg * y1.to(f) * (sig * (1 + zf * (1 - sig)))).to(z.dtype)
    dxs = (Dc * dy).to(xs.dtype).reshape(B, S, H, P)
    dD = (dy * x).reshape(B, S, H, P).sum((0, 1, 3)).to(D.dtype)
    dnorm = (gof * (g * r)).sum((0, 1)).to(norm.dtype)
    return dy.reshape(B, S, H, P).to(y.dtype), dxs, dz, dD, dnorm


def launch_shape(d: int, vec: int) -> tuple[int, int, int] | None:
    """``(threads along a row, rows a block, vectors a thread)`` for rows of
    ``d`` columns loaded ``vec`` at a time, or None past :data:`MAX_D`: at
    most EPT elements a thread, the fewest threads (a power of two, 32 at
    least) that hold the row, and rows of fewer than 256 threads stacked
    256 threads a block.  d_inner 2048 at vec 8 gives (128, 2, 2), 8192
    (512, 1, 2), 16384 (1024, 1, 2)."""
    nv = -(-d // vec)
    per = EPT // vec
    tx = 32
    while tx * per < nv:
        tx *= 2
    if tx > MAX_THREADS:
        return None
    items = 1
    while tx * items < nv:
        items *= 2
    return tx, max(1, _BLOCK // tx), items


def _vec(d: int, P: int, *operands: tuple[torch.Tensor, int, int]) -> int:
    """The widest load (8, 4, 2 or 1 elements) every operand takes: it
    divides P (so a vector lies in one head) and d, and each operand's
    base and row strides, given as ``(tensor, batch stride, row
    stride)``, are aligned to its bytes."""
    for vec in (8, 4, 2, 1):
        if P % vec or d % vec:
            continue
        ok = True
        for t, sb, ss in operands:
            nbytes = vec * t.element_size() if t.element_size() == 2 else min(vec, 4) * 4
            step = nbytes // t.element_size()
            ok = ok and t.data_ptr() % nbytes == 0 and sb % step == 0 and ss % step == 0
        if ok:
            return vec
    return 1


def _lib() -> ctypes.CDLL:
    """The built library, its C signatures bound once."""
    global _bound
    if _bound is None:
        lib = library("ssd_gate_norm")
        ll, i, vp = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        lib.ssd_gate_norm_fwd_launch.argtypes = (
            [vp] * 6 + [ll] * 6 + [i] * 4 + [ctypes.c_float] + [i] * 4 + [vp])
        lib.ssd_gate_norm_fwd_launch.restype = i
        lib.ssd_gate_norm_bwd_grid.argtypes = [i] * 8 + [ctypes.POINTER(i)]
        lib.ssd_gate_norm_bwd_grid.restype = i
        lib.ssd_gate_norm_bwd_launch.argtypes = (
            [vp] * 12 + [ll] * 6 + [i] * 4 + [ctypes.c_float] + [i] * 5 + [vp])
        lib.ssd_gate_norm_bwd_launch.restype = i
        _bound = lib
    return _bound


def _rows(t: torch.Tensor, name: str) -> tuple[int, int]:
    """(batch stride, row stride) of a (B, S, ...) operand whose columns
    (every dim after S, flattened) are contiguous."""
    want = 1
    for size, stride in zip(reversed(t.shape[2:]), reversed(t.stride()[2:])):
        if size > 1 and stride != want:
            raise ValueError(f"{name}'s columns must be contiguous, got strides {t.stride()}")
        want *= size
    return tuple(st if n > 1 else 0 for n, st in zip(t.shape[:2], t.stride()[:2]))


def _check(y, xs, z, D, norm) -> tuple:
    """The shape, the launch shape and the operands' strides, or raise."""
    if xs.dim() != 4 or y.shape != xs.shape or z.dim() != 3:
        raise ValueError(f"need y and xs (B,S,H,P), z (B,S,d); got y {tuple(y.shape)}, "
                         f"xs {tuple(xs.shape)}, z {tuple(z.shape)}")
    B, S, H, P = xs.shape
    d = H * P
    if tuple(z.shape) != (B, S, d) or tuple(D.shape) != (H,) or tuple(norm.shape) != (d,):
        raise ValueError(f"shapes disagree: xs {tuple(xs.shape)}, z {tuple(z.shape)}, "
                         f"D {tuple(D.shape)}, norm {tuple(norm.shape)}")
    if min(B, S, H, P) < 1:
        raise ValueError("need non-empty shapes")
    ts = (y, xs, z, D, norm)
    if any(t.device.type != "cuda" or t.device != y.device for t in ts):
        raise ValueError("the gate-norm kernels take CUDA tensors on one device")
    if y.dtype != torch.float32 or D.dtype != torch.float32:
        raise TypeError(f"y and D must be float32, got {y.dtype} and {D.dtype}")
    if not xs.dtype == z.dtype == norm.dtype == torch.bfloat16:
        raise TypeError(f"xs, z and norm must be bfloat16, got {xs.dtype}, {z.dtype}, "
                        f"{norm.dtype}")
    strides = [_rows(y, "y"), _rows(xs, "xs"), _rows(z, "z")]
    vec = _vec(d, P, *((t, *st) for t, st in zip((y, xs, z), strides)), (norm, 0, 0))
    shape = launch_shape(d, vec)
    if shape is None:
        raise ValueError(f"rows of {d} columns at {vec} a load exceed the kernels' "
                         f"{MAX_THREADS} x {EPT // vec} vectors")
    return B, S, H, P, d, vec, shape, [s for st in strides for s in st]


def ssd_gate_norm(
    y: torch.Tensor, xs: torch.Tensor, z: torch.Tensor, D: torch.Tensor, norm: torch.Tensor,
    eps: float = 1e-5,
) -> torch.Tensor:
    """The forward kernel: out (B, S, d) bf16, contiguous.  One launch on
    the current stream, counted in ``ssd_gate_norm.launches``; no autograd
    (see :class:`SSDGateNormFn`).  Raises on what it does not take."""
    B, S, H, P, d, vec, (tx, rows, items), strides = _check(y, xs, z, D, norm)
    D, norm = D.contiguous(), norm.contiguous()
    out = torch.empty((B, S, d), dtype=torch.bfloat16, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = _lib().ssd_gate_norm_fwd_launch(
            y.data_ptr(), xs.data_ptr(), z.data_ptr(), D.data_ptr(), norm.data_ptr(),
            out.data_ptr(), *strides, B * S, S, d, P, eps, vec, tx, rows, items, stream)
    if err != 0:
        raise RuntimeError(f"ssd_gate_norm launch failed: cudaError_t {err}")
    ssd_gate_norm.launches += 1
    return out


ssd_gate_norm.launches = 0  # forward kernel launches (remat's recompute too)


def ssd_gate_norm_bwd(
    go: torch.Tensor, y: torch.Tensor, xs: torch.Tensor, z: torch.Tensor, D: torch.Tensor,
    norm: torch.Tensor, eps: float = 1e-5,
) -> tuple[torch.Tensor, ...]:
    """The backward kernels: ``(dy f32, dxs bf16, dz bf16, dD f32, dnorm
    bf16)``, dy and dxs (B,S,H,P), dz (B,S,d), all contiguous; dnorm and dD
    summed without atomics, so two calls give the same bits.  Two launches
    (the rows; the blocks' partials) on the current stream, counted once in
    ``ssd_gate_norm_bwd.launches``.  Raises on what they do not take."""
    B, S, H, P, d, vec, (tx, rows, items), strides = _check(y, xs, z, D, norm)
    if tuple(go.shape) != (B, S, d) or go.dtype != torch.bfloat16 or go.device != y.device:
        raise ValueError(f"go must be bfloat16 {(B, S, d)} on {y.device}, got {go.dtype} "
                         f"{tuple(go.shape)} on {go.device}")
    go, D, norm = go.contiguous(), D.contiguous(), norm.contiguous()
    if go.data_ptr() % (2 * vec):  # a view off the loads' alignment
        go = go.clone()
    lib = _lib()
    dev = y.device
    dy = torch.empty((B, S, H, P), dtype=torch.float32, device=dev)
    dxs = torch.empty((B, S, H, P), dtype=torch.bfloat16, device=dev)
    dz = torch.empty((B, S, d), dtype=torch.bfloat16, device=dev)
    dD = torch.empty((H,), dtype=torch.float32, device=dev)
    dnorm = torch.empty((d,), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        grid = ctypes.c_int(0)
        err = lib.ssd_gate_norm_bwd_grid(B * S, S, d, P, vec, tx, rows, items, ctypes.byref(grid))
        if err != 0:
            raise RuntimeError(f"ssd_gate_norm backward: no grid, cudaError_t {err}")
        work = torch.empty((grid.value, d + H), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_gate_norm_bwd_launch(
            go.data_ptr(), y.data_ptr(), xs.data_ptr(), z.data_ptr(), D.data_ptr(),
            norm.data_ptr(), dy.data_ptr(), dxs.data_ptr(), dz.data_ptr(), dD.data_ptr(),
            dnorm.data_ptr(), work.data_ptr(), *strides, B * S, S, d, P, eps, vec, tx, rows,
            items, grid.value, stream)
    if err != 0:
        raise RuntimeError(f"ssd_gate_norm backward launch failed: cudaError_t {err}")
    ssd_gate_norm_bwd.launches += 1
    return dy, dxs, dz, dD, dnorm


ssd_gate_norm_bwd.launches = 0  # backward calls, two launches each


class SSDGateNormFn(torch.autograd.Function):
    """``out = ssd_gate_norm(y, xs, z, D, norm, eps)`` differentiated by
    :func:`ssd_gate_norm_bwd`.  Saves its five operands and nothing it
    computed; under no_grad (remat's first forward, serving's prefill)
    nothing is kept past the call."""

    @staticmethod
    def forward(ctx, y, xs, z, D, norm, eps: float):
        ctx.save_for_backward(y, xs, z, D, norm)
        ctx.eps = eps
        return ssd_gate_norm(y, xs, z, D, norm, eps)

    @staticmethod
    def backward(ctx, go):
        y, xs, z, D, norm = ctx.saved_tensors
        return (*ssd_gate_norm_bwd(go, y, xs, z, D, norm, ctx.eps), None)
