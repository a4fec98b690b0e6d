"""flash_attention: online-softmax attention, forward only (GQA, causal and
sliding-window masks).

The port of ``src/repro/kernels/flash_attention.py:flash_attention_pallas``.
Layouts are the JAX package's: q (B,S,H,hd), k and v (B,S,K,hd), query head
h reading kv head h // (H/K), the output (B,S,H,hd) in q's dtype.

- :func:`flash_attention_torch` is the plain version of the same function:
  q scaled by hd^-0.5 in f32, f32 scores, a masked score set to -1e30 by a
  select, an f32 softmax and an f32 ``p . v``, the TPU kernel's ``l == 0``
  rule, the output cast to q's dtype.
- :func:`flash_attention` launches the hand-written sm_90a kernel in
  ``csrc/flash_attention.cu`` (header there: its design and what bounds it)
  on CUDA tensors, counted in ``flash_attention.launches``; on CPU tensors
  it runs the plain version.  There is no fallback between the two: CUDA
  tensors launch the kernel or raise.

Unlike the TPU kernel, the CUDA kernel takes any S (it masks a ragged last
tile) and reads q, k and v through their strides, without a transpose copy.
There is no backward: serving's prefill is forward-only, and training keeps
the model's plain attention, as the JAX trainer differentiates pure-jnp
``attention_forward``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import library

__all__ = ["HEAD_DIMS", "NEG_INF", "flash_attention", "flash_attention_torch"]

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)  # the head sizes the kernel is instantiated for
# dtype codes of the C interface (csrc/flash_attention.cu)
_CODES = {torch.float32: 0, torch.bfloat16: 1}

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


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int | None = None,
) -> torch.Tensor:
    """q (B,S,H,hd), k / v (B,S,K,hd), f32 or bf16 alike, hd in
    :data:`HEAD_DIMS` -> (B,S,H,hd) in q's dtype.

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (counted in ``flash_attention.launches``) or raise: on a shape, dtype or
    head size the kernel does not take, on tensors that are not contiguous,
    and on a failed build or launch."""
    B, S, H, K, hd = _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, not {q.device}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("q, k and v must be contiguous")
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
