"""Mamba2 (SSD, state-space duality) blocks for training (the port of
``src/repro/models/ssm.py``).

Layer structure follows mamba2:
  in_proj -> [z | xBC | dt];  causal depthwise conv on xBC;  SSD(x, dt, A, B, C);
  y = y + D*x;  gated RMSNorm with z;  out_proj.

The SSD core is ``kernels.ops.ssd_scan``: the hand-written CUDA kernel for a
CUDA tensor (differentiated through the plain version), the plain chunked
algorithm for a CPU tensor.  The chunked math lives once, in
``kernels/ssd_scan.py``; :func:`ssd_chunked` and :func:`_segsum` here are
that code.  The JAX module's sequential oracle ``ssd_sequential`` is
``kernels.ref.ssd_ref`` here, beside the other oracles.  ``softplus`` is
``jax.nn.softplus``'s own definition, ``logaddexp(x, 0)`` (``F.softplus``
returns x itself above 20, which differs from it by under 2e-9).

Serving: :func:`mamba_forward` with ``return_cache`` also returns the
decode cache ``{"h": the final SSD state (B,H,P,N) f32, "conv": the last
k-1 conv inputs (B,k-1,C) in the activation dtype}``; in prefill the SSD
kernel runs forward-only and its final state is that ``h``.
:func:`mamba_decode` advances one token at O(1) state in plain PyTorch.
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import _segsum
from repro_torch.kernels.ssd_scan import ssd_scan_torch as ssd_chunked
from repro_torch.models.layers import dense_init, rms_norm
from repro_torch.models.sharding import on_local_rows, reduce_partial, shard_batch
from repro_torch.obs.trace import NULL_SPAN

__all__ = ["init_mamba", "mamba_decode", "mamba_forward", "ssd_chunked", "_segsum", "_causal_conv"]

Params = dict[str, torch.Tensor]


def init_mamba(
    gen: torch.Generator,
    n_rep: int,
    d_model: int,
    *,
    d_inner: int,
    n_heads: int,
    d_state: int,
    n_groups: int = 1,
    conv_kernel: int = 4,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
) -> Params:
    """``n_rep`` stacked mamba blocks, leaves ``(n_rep, ...)`` (the JAX
    package's vmap over per-layer keys), with its distributions."""
    dev = torch.device(device)
    conv_ch = d_inner + 2 * n_groups * d_state
    d_in_proj = 2 * d_inner + 2 * n_groups * d_state + n_heads
    f32 = torch.float32
    in_proj = dense_init(gen, (n_rep, d_model, d_in_proj), dtype, dev, scale=(1.0 / d_model) ** 0.5)
    conv_w = torch.randn((n_rep, conv_kernel, conv_ch), generator=gen, dtype=f32, device=dev)
    # dt_bias so that softplus(dt_bias) spans ~[1e-3, 1e-1] (mamba2 default)
    u = torch.rand((n_rep, n_heads), generator=gen, dtype=f32, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    dt_bias = dt + torch.log(-torch.expm1(-dt))  # inverse softplus
    out_proj = dense_init(gen, (n_rep, d_inner, d_model), dtype, dev, scale=(1.0 / d_inner) ** 0.5)
    # numpy's f32 log gives the JAX init's bits (torch's log differs in the last ulp)
    a_log = torch.from_numpy(np.log(np.arange(1, n_heads + 1, dtype=np.float32)))
    return {
        "in_proj": in_proj,
        "conv_w": (conv_w * 0.1).to(dtype),
        "conv_b": torch.zeros((n_rep, conv_ch), dtype=dtype, device=dev),
        "A_log": a_log.to(dev).repeat(n_rep, 1),
        "D": torch.ones((n_rep, n_heads), dtype=f32, device=dev),
        "dt_bias": dt_bias,
        "norm": torch.ones((n_rep, d_inner), dtype=dtype, device=dev),
        "out_proj": out_proj,
    }


def _causal_conv(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, state: torch.Tensor | None
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Depthwise causal conv1d, the JAX form: a sum of k shifted products
    plus b, in the activation dtype.  x: (B, S, C), w: (k, C); ``state``
    (B, k-1, C) carries the last k-1 inputs for decode."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+k-1, C)
    S = x.shape[1]
    out = sum(xp[:, i : i + S] * w[i] for i in range(k)) + b
    new_state = xp[:, -(k - 1) :] if k > 1 else None
    return out, new_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mamba_forward(
    params: Params,
    x: torch.Tensor,
    *,
    d_inner: int,
    n_heads: int,
    d_state: int,
    n_groups: int = 1,
    chunk: int = 64,
    impl: str | None = None,
    return_cache: bool = False,
    region=NULL_SPAN,
) -> tuple[torch.Tensor, Params | None]:
    """Train / prefill.  x: (B, S, d_model) -> ``(out (B, S, d_model),
    cache)``, the cache ``{"h", "conv"}`` when ``return_cache``, else None.
    ``impl`` picks the SSD scan (``kernels.ops``): None by the tensors'
    device.  The scan's backward, "kernel" or "plain", is set on ``region``
    (the layer's ``device.mixer`` span) as ``bwd_impl``."""
    B, S, _ = x.shape
    P = d_inner // n_heads
    GN = n_groups * d_state
    # the projection's columns gathered and the batch anchored (a no-op
    # unless sharding axes are installed): DTensor cannot split the SSD's
    # heads across the scan's reshapes, so the block runs whole on each
    # 'model' rank, as the attention does after its anchor
    zxbcdt = shard_batch(x @ params["in_proj"])
    z, xBC, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * GN, n_heads], dim=-1)
    xBC, conv_state = _causal_conv(xBC, params["conv_w"], params["conv_b"], None)
    xBC = F.silu(xBC)
    xs, Bm, Cm = torch.split(xBC, [d_inner, GN, GN], dim=-1)
    xs = xs.reshape(B, S, n_heads, P)
    Bm = Bm.reshape(B, S, n_groups, d_state)
    Cm = Cm.reshape(B, S, n_groups, d_state)
    dt = _softplus(dt.float() + params["dt_bias"])  # (B,S,H)
    A = -torch.exp(params["A_log"])  # (H,)
    xdt, dA = xs * dt[..., None], dt * A  # f32: bf16 x f32 promotes
    pad = (-S) % chunk  # zero-pad to a chunk multiple: x=0 adds nothing to the
    if pad:  # state and dA=0 gives decay exp(0)=1, so padding is exact
        xdt, dA, Bm, Cm = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (xdt, dA, Bm, Cm))
    region.set(bwd_impl=ops.ssd_backward_impl(xdt, Bm, impl))
    y, h = on_local_rows(partial(ops.ssd_scan, chunk=chunk, impl=impl), xdt.contiguous(),
                         dA.contiguous(), Bm.contiguous(), Cm.contiguous(), n_out=2)
    y = y[:, :S]
    y = y + params["D"][None, None, :, None] * xs.float()
    y = y.reshape(B, S, d_inner).to(x.dtype)
    # gated RMSNorm (mamba2): norm(y * silu(z))
    y = rms_norm(y * F.silu(z), params["norm"], 1e-5)
    out = y @ params["out_proj"]
    cache = None
    if return_cache:
        cache = {"h": h, "conv": conv_state}  # f32 state, conv inputs in x's dtype
    return out, cache


def mamba_decode(
    params: Params,
    x: torch.Tensor,
    cache: Params,
    *,
    d_inner: int,
    n_heads: int,
    d_state: int,
    n_groups: int = 1,
) -> tuple[torch.Tensor, Params]:
    """One-token decode.  x: (B, 1, d_model); cache ``{"h", "conv"}``.
    Returns ``(out (B, 1, d_model), new cache)``: the state advanced by
    one step of the recurrence, h' = exp(dt*A) h + (x dt) (x) B, and the
    readout y = C . h' + D x."""
    B = x.shape[0]
    P = d_inner // n_heads
    GN = n_groups * d_state
    rep = n_heads // n_groups
    f32 = torch.float32
    zxbcdt = shard_batch(x @ params["in_proj"])  # as in mamba_forward
    z, xBC, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * GN, n_heads], dim=-1)
    xBC, conv_state = _causal_conv(xBC, params["conv_w"], params["conv_b"], cache["conv"])
    xBC = F.silu(xBC)
    xs, Bm, Cm = torch.split(xBC, [d_inner, GN, GN], dim=-1)
    xs = xs.reshape(B, n_heads, P).to(f32)  # S=1 squeezed
    Bm = Bm.reshape(B, n_groups, d_state).repeat_interleave(rep, dim=1)
    Cm = Cm.reshape(B, n_groups, d_state).repeat_interleave(rep, dim=1)
    dt = _softplus(dt.to(f32)[:, 0] + params["dt_bias"])  # (B,H)
    A = -torch.exp(params["A_log"])
    a = torch.exp(dt * A)  # (B,H)
    h = cache["h"] * a[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", xs * dt[..., None], Bm.to(f32)
    )
    # a state sharded over N (the dry run's cache layout) leaves y a pending
    # sum: carried out here, where torch 2.11's DTensor would move the
    # skip term to a pending sum instead, which it cannot
    y = reduce_partial(torch.einsum("bhpn,bhn->bhp", h, Cm.to(f32)))
    y = y + params["D"][None, :, None] * xs
    y = y.reshape(B, 1, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm"], 1e-5)
    return y @ params["out_proj"], {"h": h, "conv": conv_state}
