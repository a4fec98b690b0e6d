"""flash_attention: online-softmax attention (GQA, causal and sliding-window
masks): prefill's forward, and training's forward and backward.

The port of ``src/repro/kernels/flash_attention.py:flash_attention_pallas``.
Layouts are the JAX package's: q (B,S,H,hd), k and v (B,S,K,hd), query head
h reading kv head h // (H/K), the output (B,S,H,hd) in q's dtype.

- :func:`flash_attention_torch` is the plain version of prefill's
  function: q scaled by hd^-0.5 in f32, f32 scores, a masked score set to
  -1e30 by a select, an f32 softmax and an f32 ``p . v``, the TPU kernel's
  ``l == 0`` rule, the output cast to q's dtype.
- :func:`flash_attention` launches the hand-written sm_90a kernel in
  ``csrc/flash_attention.cu`` (header there: its design and what bounds it)
  on CUDA tensors, counted in ``flash_attention.launches``; on CPU tensors
  it runs the plain version.  There is no fallback between the two: CUDA
  tensors launch the kernel or raise.

The prefill kernel has two instantiations, picked by the dtype alone: bf16
runs on the tensor cores (``wgmma`` fed by TMA, P.V split into bf16 hi + lo
so the output stays within one bf16 spacing of the plain version), f32 on
the CUDA cores (it serves the f32 cross-checks).  Neither is a fallback of
the other.

Training has a differentiable pair with the model's own rounding:

- :func:`flash_attention_train_torch` is its plain version, the chain of
  ``models/attention.py`` (f32 scores from q already scaled by hd^-0.5 in
  its dtype, the mask, ``torch.softmax`` in f32, p cast to v's dtype for
  P.V), bit-equal to the model's attention; autograd differentiates it.
- :func:`flash_attention_train` runs :class:`FlashAttentionTrainFn` on
  CUDA tensors, bf16 only: the training instantiation of the forward
  (:func:`flash_attention_train_fwd`, which also returns each row's
  log-sum-exp) and the backward kernels (:func:`flash_attention_train_bwd`),
  each counted in its own ``launches``; on CPU tensors it runs the plain
  version.  The JAX trainer differentiates its plain attention, so no TPU
  kernel is replaced: the pair exists because the plain chain holds five
  (B, K, G, S, S) f32 tensors a layer and runs its score products on the
  CUDA cores.

Unlike the TPU kernel, the CUDA kernels take any S (they mask a ragged last
tile) and read q, k and v through their strides, without a transpose copy.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import library

__all__ = ["HEAD_DIMS", "NEG_INF", "FlashAttentionTrainFn", "flash_attention",
           "flash_attention_torch", "flash_attention_train", "flash_attention_train_bwd",
           "flash_attention_train_fwd", "flash_attention_train_torch"]

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)  # the head sizes the kernel is instantiated for
# dtype codes of the C interface (csrc/flash_attention.cu)
_CODES = {torch.float32: 0, torch.bfloat16: 1}
LSE_ROWS = 128  # the training lse's rows are S rounded up to this (the forward's q tile)

_bound: ctypes.CDLL | None = None


def flash_attention_torch(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int | None = None,
) -> torch.Tensor:
    """The plain version: q (B,S,H,hd), k / v (B,S,K,hd) -> (B,S,H,hd) in
    q's dtype, every step in f32."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    f32 = torch.float32
    qh = q.to(f32).reshape(B, S, K, G, hd) * (hd**-0.5)
    s = torch.einsum("bqkgh,bskh->bkgqs", qh, k.to(f32))  # (B, K, G, S, S)
    pos = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    s = torch.where(mask, s, torch.full((), NEG_INF, dtype=f32, device=q.device))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    p = p / torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.to(f32))
    return o.reshape(B, S, H, hd).to(q.dtype)


def _lib() -> ctypes.CDLL:
    """The built library, its C signature bound once."""
    global _bound
    if _bound is None:
        lib = library("flash_attention")
        lib.flash_attention_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                                          ctypes.c_void_p]
        )
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_train_forward.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.flash_attention_train_forward.restype = ctypes.c_int
        lib.flash_attention_train_backward.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.flash_attention_train_backward.restype = ctypes.c_int
        _bound = lib
    return _bound


def _check(q, k, v, window) -> tuple[int, int, int, int, int]:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("need q (B,S,H,hd), k and v (B,S,K,hd)")
    B, S, H, hd = q.shape
    K = k.shape[2]
    if tuple(k.shape) != (B, S, K, hd) or v.shape != k.shape:
        raise ValueError(
            f"shapes disagree: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    if min(B, S, H, K) < 1 or H % K:
        raise ValueError(f"need non-empty shapes and H % K == 0, got H={H} K={K}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head size {hd} not supported; the kernel takes {HEAD_DIMS}")
    if q.dtype not in _CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"q, k and v must share a dtype in {list(_CODES)}, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"q, k and v must be on one device, got {devices}")
    return B, S, H, K, hd


def _check_cuda(*ts: torch.Tensor) -> None:
    """What the CUDA kernels take beyond :func:`_check`: cuda tensors,
    contiguous, from 16-byte aligned bases (TMA)."""
    if ts[0].device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, not {ts[0].device}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("q, k and v must be contiguous")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("q, k and v must start at 16-byte aligned addresses")


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int | None = None,
) -> torch.Tensor:
    """q (B,S,H,hd), k / v (B,S,K,hd), f32 or bf16 alike, hd in
    :data:`HEAD_DIMS` -> (B,S,H,hd) in q's dtype.

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (counted in ``flash_attention.launches``) or raise: on a shape, dtype or
    head size the kernel does not take, on tensors that are not contiguous
    or not 16-byte aligned (TMA reads from 16-byte aligned bases), and on a
    failed build or launch."""
    B, S, H, K, hd = _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal=causal, window=window)
    _check_cuda(q, k, v)
    o = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, H, K, hd,
            int(causal), 0 if window is None else int(window), hd**-0.5, _CODES[q.dtype],
            stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError_t {err}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0  # kernel launches; the plain CPU version never counts


# -- training ------------------------------------------------------------------


def flash_attention_train_torch(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int | None = None,
) -> torch.Tensor:
    """The training attention's plain version, the model's own chain: q
    (B,S,H,hd) already scaled by hd^-0.5 in its dtype, k / v (B,S,K,hd) ->
    (B,S,H,hd) in v's dtype.  Scores in f32, a masked score set to -1e30 by
    a select, ``torch.softmax`` in f32, p cast to v's dtype for P.V."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    s = torch.einsum("bqkgh,bskh->bkgqs", q.reshape(B, S, K, H // K, hd).float(), k.float())
    if causal or window is not None:
        pos = torch.arange(S, device=q.device)
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
        if causal:
            mask &= pos[None, :] <= pos[:, None]
        if window is not None:
            mask &= pos[None, :] > pos[:, None] - window
        s = torch.where(mask, s, torch.full((), NEG_INF, dtype=s.dtype, device=s.device))
    o = torch.einsum("bkgqs,bskh->bqkgh", torch.softmax(s, dim=-1).to(v.dtype), v)
    return o.reshape(B, S, H, hd)


def _check_train(q, k, v, window) -> tuple[int, int, int, int, int]:
    """:func:`_check`, then what the training kernels take on the card: bf16."""
    dims = _check(q, k, v, window)
    if q.is_cuda and q.dtype != torch.bfloat16:
        raise TypeError(f"the training kernels take bf16 q, k and v, got {q.dtype}")
    return dims


def _lse_rows(S: int) -> int:
    return -(-S // LSE_ROWS) * LSE_ROWS


def flash_attention_train_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int | None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward on the card: q (B,S,H,hd) scaled, k / v
    (B,S,K,hd), bf16 -> (o (B,S,H,hd) bf16, lse (B, H, S_pad) f32), lse the
    log2 of each row's sum of exp(s) (2^(s log2 e)), S_pad = S rounded up to
    :data:`LSE_ROWS`.  Counted in ``flash_attention_train_fwd.launches``."""
    B, S, H, K, hd = _check_train(q, k, v, window)
    _check_cuda(q, k, v)
    o = torch.empty_like(q)
    S_pad = _lse_rows(S)
    lse = torch.empty((B, H, S_pad), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().flash_attention_train_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), B, S, S_pad,
            H, K, hd, int(causal), 0 if window is None else int(window), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention training forward failed: cudaError_t {err}")
    flash_attention_train_fwd.launches += 1
    return o, lse


def flash_attention_train_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, causal: bool, window: int | None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The training backward on the card, :func:`flash_attention_train_fwd`'s
    inputs and outputs with ``do`` (B,S,H,hd) -> (dq of the scaled q, dk,
    dv), bf16: three launches (D = rowsum(do o o), dQ, dK and dV), no
    atomics.  Counted in ``flash_attention_train_bwd.launches``."""
    B, S, H, K, hd = _check_train(q, k, v, window)
    if tuple(o.shape) != tuple(q.shape) or do.shape != o.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"o and do must be q's shape and dtype, got {tuple(o.shape)} {o.dtype}, "
                         f"{tuple(do.shape)} {do.dtype}")
    S_pad = _lse_rows(S)
    if tuple(lse.shape) != (B, H, S_pad) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous f32 ({B}, {H}, {S_pad}), got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    _check_cuda(q, k, v, o, do, lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dsum = torch.empty_like(lse)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().flash_attention_train_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S,
            S_pad, H, K, hd, int(causal), 0 if window is None else int(window), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention training backward failed: cudaError_t {err}")
    flash_attention_train_bwd.launches += 1
    return dq, dk, dv


flash_attention_train_fwd.launches = 0  # training forward launches (remat's recompute too)
flash_attention_train_bwd.launches = 0  # training backward calls, three launches each


class FlashAttentionTrainFn(torch.autograd.Function):
    """The training kernels under autograd: saves q, k, v, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = flash_attention_train_fwd(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_train_bwd(q, k, v, o, do.contiguous(), lse, ctx.causal,
                                               ctx.window)
        return dq, dk, dv, None, None


def flash_attention_train(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int | None = None,
) -> torch.Tensor:
    """Training attention with autograd: q (B,S,H,hd) already scaled by
    hd^-0.5, k / v (B,S,K,hd) -> (B,S,H,hd).

    CPU tensors run the plain version (autograd through the chain); CUDA
    tensors run :class:`FlashAttentionTrainFn` or raise, before any launch:
    on a shape, head size or dtype the kernels do not take (bf16 only), on
    tensors that are not contiguous or not 16-byte aligned, and on a failed
    build or launch."""
    _check_train(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_train_torch(q, k, v, causal=causal, window=window)
    return FlashAttentionTrainFn.apply(q, k, v, causal, window)
