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
  ``ssd_chunked``, so the backward recomputes the plain version from the
  saved inputs and differentiates that.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import torch

from repro_torch.kernels.build import library

__all__ = ["SSDScanFn", "ssd_scan", "ssd_scan_torch"]

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
    final state (B,H,P,N) f32)."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if S % chunk:
        raise ValueError(f"seq {S} not divisible by chunk {chunk}")
    rep = H // G
    nc = S // chunk
    f32 = torch.float32

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
    B, S, H, P, G, N = _check(x, dA, Bm, Cm, chunk)
    devices = {t.device for t in (x, dA, Bm, Cm)}
    if len(devices) != 1:
        raise ValueError(f"x, dA, Bm and Cm must be on one device, got {devices}")
    if x.device.type == "cpu":
        return ssd_scan_torch(x, dA, Bm, Cm, chunk)
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
    return y, h


ssd_scan.launches = 0  # calls that launched a kernel; the plain CPU version never counts


class SSDScanFn(torch.autograd.Function):
    """``(y, h) = forward_fn(x, dA, Bm, Cm, chunk)``, differentiated through
    the plain version.

    The forward runs ``forward_fn`` (the kernel wrapper :func:`ssd_scan` on
    the card) and saves only its four inputs.  The backward recomputes
    :func:`ssd_scan_torch` on detached copies under grad mode and returns
    ``torch.autograd.grad`` of it for x, dA, Bm and Cm, each in its input's
    dtype.  A gradient of h that no one asked for (training uses y only)
    arrives as None and is left out."""

    @staticmethod
    def forward(ctx, x, dA, Bm, Cm, chunk: int, forward_fn: Callable):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dA, Bm, Cm)
        ctx.chunk = chunk
        return forward_fn(x, dA, Bm, Cm, chunk)

    @staticmethod
    def backward(ctx, gy, gh):
        ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            y, h = ssd_scan_torch(*ins, ctx.chunk)
        pairs = [(out, g) for out, g in ((y, gy), (h, gh)) if g is not None]
        if not pairs:
            return None, None, None, None, None, None
        outs, grads = zip(*pairs)
        gx, gdA, gB, gC = torch.autograd.grad(outs, ins, grads, allow_unused=True)
        return gx, gdA, gB, gC, None, None
