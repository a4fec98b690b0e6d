"""ssd_scan: the Mamba2 SSD (state-space duality) chunked scan.

The port of ``src/repro/kernels/ssd_scan.py:ssd_scan_pallas`` and of the
chunked algorithm it computes, ``src/repro/models/ssm.py:ssd_chunked``.
Per (batch, head), with x pre-multiplied by dt and dA = dt·A:

    y[t] = Σ_{s<=t} exp(Σ_{s<u<=t} dA[u]) · (C[t]·B[s]) · x[s]
    h    = Σ_s exp(Σ_{s<u<S} dA[u]) · x[s] ⊗ B[s]          (the final state)

Layouts are the JAX package's: x (B,S,H,P), dA (B,S,H), Bm and Cm
(B,S,G,N) with head h reading group h // (H/G), y (B,S,H,P), h (B,H,P,N).

- :func:`ssd_scan_torch` is the plain version: the chunked algorithm of
  ``ssm.py:68-137`` (intra-chunk products, chunk states, the inter-chunk
  recurrence as a loop over chunks, the carried-state term), in f32.  It is
  the port's one copy of that math: ``models/ssm.py`` re-exports it as
  ``ssd_chunked``.
- :func:`ssd_scan` launches the hand-written sm_90a kernel in
  ``csrc/ssd_scan.cu`` (header there: its design and what bounds it) on a
  CUDA tensor, counted in ``ssd_scan.launches``; on a CPU tensor it runs the
  plain version.  There is no fallback between the two: a CUDA tensor
  launches the kernel or raises.  bf16 B and C (the bf16 model's) run the
  tensor-core kernel, three launches a call; f32 B and C the CUDA-core
  kernel, one launch a call.
- :class:`SSDScanFn` makes the kernel differentiable.  The Pallas kernel
  has no VJP and the JAX trainer differentiates the pure-jnp
  ``ssd_chunked``; the port has a backward of its own for the bf16 kernel:
  :func:`ssd_scan_bwd`, the hand-written sm_90a kernels ``ssd_bwd_*`` of
  ``csrc/ssd_scan.cu`` (five launches a call, counted in
  ``ssd_scan_bwd.launches``), which read the states entering each chunk
  that the forward kept (:func:`ssd_scan_with_states`).
  ``kernels.ops.ssd_scan`` routes by device and B and C's dtype alone: bf16
  B and C on the card take the kernel backward; f32 ones (the CUDA-core
  forward, the f32 cross-checks) take :func:`ssd_scan_bwd_torch`, the plain
  version recomputed from the saved inputs and differentiated by autograd,
  and the CPU runs the plain version under autograd.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import torch

from repro_torch.kernels.build import library

__all__ = [
    "SSDScanFn", "ssd_scan", "ssd_scan_bwd", "ssd_scan_bwd_torch",
    "ssd_scan_torch", "ssd_scan_with_states",
]

# dtype codes of the C interface for Bm / Cm (csrc/ssd_scan.cu)
_CODES = {torch.float32: 0, torch.bfloat16: 1}

_bound: ctypes.CDLL | None = None


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., L) -> (..., L, L) lower-triangular pairwise cumulative sums:
    out[i, j] = sum_{j < t <= i} x[t] (i >= j), -inf above the diagonal.
    The -inf is selected BEFORE the exp that follows, so the masked
    triangle never sees exp of a large positive difference."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def ssd_scan_torch(
    x: torch.Tensor,
    dA: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    chunk: int,
    h0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version (the chunked SSD, differentiable).

    x (B,S,H,P) already multiplied by dt; dA (B,S,H); Bm, Cm (B,S,G,N);
    optional initial state h0 (B,H,P,N).  Returns (y (B,S,H,P) f32,
    final state (B,H,P,N) f32); f64 throughout where x is f64 (the tests'
    reference for the gradients)."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if S % chunk:
        raise ValueError(f"seq {S} not divisible by chunk {chunk}")
    rep = H // G
    nc = S // chunk
    f32 = torch.float64 if x.dtype == torch.float64 else torch.float32

    xc = x.reshape(B, nc, chunk, H, P).to(f32)
    ac = dA.reshape(B, nc, chunk, H).permute(0, 3, 1, 2).to(f32)  # (B,H,nc,L)
    # broadcast groups to heads
    Bh = Bm.reshape(B, nc, chunk, G, N).to(f32).repeat_interleave(rep, dim=3)  # (B,nc,L,H,N)
    Ch = Cm.reshape(B, nc, chunk, G, N).to(f32).repeat_interleave(rep, dim=3)

    a_cum = torch.cumsum(ac, dim=-1)  # (B,H,nc,L)
    Lmat = torch.exp(_segsum(ac))  # (B,H,nc,L,L)

    # 1. intra-chunk (diagonal blocks)
    CB = torch.einsum("bclhn,bcshn->bhcls", Ch, Bh)
    y_diag = torch.einsum("bhcls,bhcls,bcshp->bclhp", CB, Lmat, xc)

    # 2. per-chunk final states
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)  # (B,H,nc,L)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bh, decay_states, xc)

    # 3. inter-chunk recurrence over the nc chunk states
    chunk_decay = torch.exp(a_cum[..., -1])  # (B,H,nc)
    h = torch.zeros((B, H, P, N), dtype=f32, device=x.device) if h0 is None else h0.to(f32)
    h_in = []
    for c in range(nc):
        h_in.append(h)  # the state entering chunk c
        h = h * chunk_decay[:, :, c, None, None] + states[:, c]
    h_in = torch.stack(h_in, dim=1)  # (B,nc,H,P,N)

    # 4. off-diagonal contribution of the carried state
    state_decay = torch.exp(a_cum)  # (B,H,nc,L)
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Ch, h_in, state_decay)

    y = (y_diag + y_off).reshape(B, S, H, P)
    return y, h


def _lib() -> ctypes.CDLL:
    """The built library, its C signature bound once."""
    global _bound
    if _bound is None:
        lib = library("ssd_scan")
        lib.ssd_scan_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.ssd_scan_launch.restype = ctypes.c_int
        lib.ssd_scan_workspace_bytes.argtypes = [ctypes.c_int] * 7
        lib.ssd_scan_workspace_bytes.restype = ctypes.c_longlong
        lib.ssd_scan_bwd_launch.argtypes = (
            [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.ssd_scan_bwd_launch.restype = ctypes.c_int
        lib.ssd_scan_bwd_workspace_bytes.argtypes = [ctypes.c_int] * 6
        lib.ssd_scan_bwd_workspace_bytes.restype = ctypes.c_longlong
        _bound = lib
    return _bound


def _check(x, dA, Bm, Cm, chunk) -> tuple[int, int, int, int, int, int]:
    if x.dim() != 4 or dA.dim() != 3 or Bm.dim() != 4 or Cm.dim() != 4:
        raise ValueError("need x (B,S,H,P), dA (B,S,H), Bm and Cm (B,S,G,N)")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if tuple(dA.shape) != (B, S, H) or tuple(Bm.shape) != (B, S, G, N) or Cm.shape != Bm.shape:
        raise ValueError(
            f"shapes disagree: x {tuple(x.shape)}, dA {tuple(dA.shape)}, "
            f"Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)}"
        )
    if min(B, S, H, P, G, N) < 1 or H % G:
        raise ValueError(f"need non-empty shapes and H % G == 0, got H={H} G={G}")
    if chunk < 1 or S % chunk:
        raise ValueError(f"seq {S} not divisible by chunk {chunk}")
    return B, S, H, P, G, N


def _one_device(*ts: torch.Tensor) -> None:
    devices = {t.device for t in ts}
    if len(devices) != 1:
        raise ValueError(f"x, dA, Bm and Cm must be on one device, got {devices}")


def ssd_scan(
    x: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 128
) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P) f32, dA (B,S,H) f32, Bm / Cm (B,S,G,N) f32 or bf16 ->
    (y (B,S,H,P) f32, h (B,H,P,N) f32).

    ``chunk`` must divide S, the contract of the TPU kernel and of
    :func:`ssd_scan_torch`.  The CUDA kernels cut S into chunks of their own
    (128 rows for bf16 B/C, 64 for f32) whatever ``chunk`` is: the chunked
    algorithm is exact for any chunk length, so the two differ only in
    rounding.  A CPU tensor runs the plain version; a CUDA tensor launches
    the kernel or raises.  The dtype of B and C picks the kernel: bf16 the
    tensor-core kernel (three launches: chunk pass, state pass, output pass,
    in a workspace allocated here), f32 the CUDA-core kernel (one launch).
    ``ssd_scan.launches`` counts calls that launched.  No autograd: see
    :class:`SSDScanFn`."""
    _check(x, dA, Bm, Cm, chunk)
    _one_device(x, dA, Bm, Cm)
    if x.device.type == "cpu":
        return ssd_scan_torch(x, dA, Bm, Cm, chunk)
    y, h, _ = ssd_scan_with_states(x, dA, Bm, Cm, chunk)
    return y, h


ssd_scan.launches = 0  # calls that launched a kernel; the plain CPU version never counts


def ssd_scan_with_states(
    x: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 128
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`ssd_scan` on a CUDA tensor, and its workspace as the launch
    left it: for bf16 B/C the state entering each 128-row chunk (B, nc, H,
    P, N), C B^T and the chunk decays, all f32, which :func:`ssd_scan_bwd`
    reads (f32 B/C: an empty tensor).  Counted in ``ssd_scan.launches``."""
    B, S, H, P, G, N = _check(x, dA, Bm, Cm, chunk)
    _one_device(x, dA, Bm, Cm)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cpu or cuda tensors, not {x.device}")
    if x.dtype != torch.float32 or dA.dtype != torch.float32:
        raise TypeError(f"x and dA must be float32, got {x.dtype} and {dA.dtype}")
    if Bm.dtype not in _CODES or Cm.dtype != Bm.dtype:
        raise TypeError(f"Bm and Cm must share a dtype in {list(_CODES)}, got {Bm.dtype}, {Cm.dtype}")
    if P % 8:
        raise ValueError(f"the kernel tiles P by 8, 16 or 32; P={P} is not a multiple of 8")
    if not all(t.is_contiguous() for t in (x, dA, Bm, Cm)):
        raise ValueError("x, dA, Bm and Cm must be contiguous")
    code = _CODES[Bm.dtype]
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    lib = _lib()
    ws = torch.empty(lib.ssd_scan_workspace_bytes(B, S, H, G, P, N, code), dtype=torch.uint8,
                     device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_launch(
            x.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), h.data_ptr(),
            ws.data_ptr(), B, S, H, G, P, N, code, stream,
        )
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: cudaError_t {err}")
    ssd_scan.launches += 1
    return y, h, ws


def ssd_scan_bwd(
    x: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
    gy: torch.Tensor | None, gh: torch.Tensor | None, ws: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients of a bf16-B/C :func:`ssd_scan_with_states` call from the
    gradients of y (B,S,H,P) and h (B,H,P,N) (None: zero; gh None is
    training's case) and the workspace that call returned: (dx f32, ddA
    f32, dB bf16, dC bf16), dB and dC each rounded once from an f32 sum.
    The kernels of ``csrc/ssd_scan.cu``'s backward (header there: its design
    and what bounds it), five launches in a workspace allocated here, on
    the current stream; deterministic (no atomics).  Raises on what they do
    not take; ``ssd_scan_bwd.launches`` counts calls that launched."""
    B, S, H, P, G, N = _check(x, dA, Bm, Cm, chunk)
    if x.device.type != "cuda" or any(t.device != x.device for t in (dA, Bm, Cm, ws)):
        raise ValueError("the SSD backward kernel takes CUDA tensors on one device")
    if x.dtype != torch.float32 or dA.dtype != torch.float32:
        raise TypeError(f"x and dA must be float32, got {x.dtype} and {dA.dtype}")
    if Bm.dtype != torch.bfloat16 or Cm.dtype != torch.bfloat16:
        raise TypeError(f"the backward kernel takes bf16 Bm and Cm, got {Bm.dtype}, {Cm.dtype}")
    if P % 8:
        raise ValueError(f"the kernel tiles P by 8; P={P} is not a multiple of 8")
    lib = _lib()
    if ws.dtype != torch.uint8 or ws.numel() != lib.ssd_scan_workspace_bytes(B, S, H, G, P, N, 1):
        raise ValueError("ws must be the workspace of the bf16 forward call at these shapes")
    if gy is None:
        gy = torch.zeros((B, S, H, P), dtype=torch.float32, device=x.device)
    for name, t, shape in (("gy", gy, (B, S, H, P)), ("gh", gh, (B, H, P, N))):
        if t is not None and (tuple(t.shape) != shape or t.dtype != torch.float32
                              or t.device != x.device):
            raise ValueError(f"{name} must be float32 {shape} on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    gy = gy.contiguous()
    gh = None if gh is None else gh.contiguous()
    if not all(t.is_contiguous() for t in (x, dA, Bm, Cm)):
        raise ValueError("x, dA, Bm and Cm must be contiguous")
    dx = torch.empty_like(x)
    ddA = torch.empty_like(dA)
    dB = torch.empty_like(Bm)
    dC = torch.empty_like(Cm)
    work = torch.empty(lib.ssd_scan_bwd_workspace_bytes(B, S, H, G, P, N), dtype=torch.uint8,
                       device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_bwd_launch(
            x.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), gy.data_ptr(),
            None if gh is None else gh.data_ptr(), ws.data_ptr(), dx.data_ptr(), ddA.data_ptr(),
            dB.data_ptr(), dC.data_ptr(), work.data_ptr(), B, S, H, G, P, N, stream,
        )
    if err != 0:
        raise RuntimeError(f"ssd_scan backward launch failed: cudaError_t {err}")
    ssd_scan_bwd.launches += 1
    return dx, ddA, dB, dC


ssd_scan_bwd.launches = 0  # calls that launched the backward kernels


def ssd_scan_bwd_torch(
    x: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
    gy: torch.Tensor | None, gh: torch.Tensor | None, *saved: torch.Tensor,
) -> tuple[torch.Tensor | None, ...]:
    """The plain backward: :func:`ssd_scan_torch` recomputed on detached
    copies of the inputs under grad mode, and ``torch.autograd.grad`` of it
    for x, dA, Bm and Cm, each in its input's dtype.  ``saved`` (what a
    forward kept besides its inputs) is not read."""
    ins = [t.detach().requires_grad_(True) for t in (x, dA, Bm, Cm)]
    with torch.enable_grad():
        y, h = ssd_scan_torch(*ins, chunk)
    pairs = [(out, g) for out, g in ((y, gy), (h, gh)) if g is not None]
    outs, grads = zip(*pairs)
    return torch.autograd.grad(outs, ins, grads, allow_unused=True)


class SSDScanFn(torch.autograd.Function):
    """``(y, h) = forward_fn(x, dA, Bm, Cm, chunk)[:2]``, differentiated by
    ``backward_fn``.

    ``forward_fn`` returns (y, h) and, after them, any tensors its backward
    reads (:func:`ssd_scan_with_states`: the workspace).  The forward saves
    the four inputs and those.  ``backward_fn(x, dA, Bm, Cm, chunk, gy, gh,
    *saved)`` returns the gradients of x, dA, Bm and Cm, each in its input's
    dtype; the default, :func:`ssd_scan_bwd_torch`, differentiates the
    plain version.  A gradient of h that no one asked for (training uses y
    only) arrives as None.  Under no_grad (serving's prefill) nothing is
    kept past the call."""

    @staticmethod
    def forward(ctx, x, dA, Bm, Cm, chunk: int, forward_fn: Callable,
                backward_fn: Callable | None = None):
        ctx.set_materialize_grads(False)
        y, h, *saved = forward_fn(x, dA, Bm, Cm, chunk)
        ctx.save_for_backward(x, dA, Bm, Cm, *saved)
        ctx.chunk = chunk
        ctx.backward_fn = backward_fn or ssd_scan_bwd_torch
        return y, h

    @staticmethod
    def backward(ctx, gy, gh):
        if gy is None and gh is None:
            return None, None, None, None, None, None, None
        x, dA, Bm, Cm, *saved = ctx.saved_tensors
        gx, gdA, gB, gC = ctx.backward_fn(x, dA, Bm, Cm, ctx.chunk, gy, gh, *saved)
        return gx, gdA, gB, gC, None, None, None
