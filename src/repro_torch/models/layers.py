"""Shared building blocks: norms, rotary embeddings, the gated MLP and
initializers (the port of ``src/repro/models/layers.py``).

Plain tensor functions over explicit parameter tensors; each keeps the JAX
module's dtype discipline (norm and RoPE math in f32, cast back to the
activation dtype).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# initializers (explicit generator; jax.random streams cannot be replayed,
# so parity with the JAX package is always held at equal weights)
# ---------------------------------------------------------------------------


def dense_init(
    gen: torch.Generator, shape: tuple[int, ...], dtype: torch.dtype,
    device: torch.device, scale: float | None = None,
) -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init, drawn in f32 and cast.  A leaf
    of three or more dims (a stack of layers) is drawn one slab of its
    first dim at a time, so the f32 temporary is one slab, not the leaf."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale if scale is not None else (1.0 / max(fan_in, 1)) ** 0.5

    def draw(slab_shape):
        x = torch.empty(slab_shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return x.mul_(std).to(dtype)

    if len(shape) < 3:
        return draw(shape)
    out = torch.empty(shape, dtype=dtype, device=device)
    for slab in out:
        slab.copy_(draw(slab.shape))
    return out


def embed_init(
    gen: torch.Generator, shape: tuple[int, ...], dtype: torch.dtype,
    device: torch.device,
) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * weight.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(rotary_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """Inverse frequencies for the rotated sub-dimension (rotary_dim <= head_dim)."""
    assert rotary_dim % 2 == 0
    exponents = torch.arange(0, rotary_dim, 2, dtype=torch.float32, device=device) / rotary_dim
    return 1.0 / (theta**exponents)


def apply_rope(
    x: torch.Tensor, positions: torch.Tensor, *, rotary_dim: int, theta: float
) -> torch.Tensor:
    """Rotate the first ``rotary_dim`` dims of the head dimension.

    x: (..., S, H, hd); positions: broadcastable to (..., S).  A rotary
    width of 0 (no positional embedding) returns x as it is.
    """
    if rotary_dim == 0:
        return x
    rot, keep = x[..., :rotary_dim], x[..., rotary_dim:]
    inv = rope_frequencies(rotary_dim, theta, x.device)
    ang = positions[..., None].float() * inv  # (..., S, rot/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    half = rotary_dim // 2
    x1, x2 = rot[..., :half].float(), rot[..., half:].float()
    r1 = (x1 * cos - x2 * sin).to(x.dtype)
    r2 = (x2 * cos + x1 * sin).to(x.dtype)
    return torch.cat([r1, r2, keep], dim=-1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def activation(act: str):
    """The MLP activation by config name: ``"silu"``, or ``"gelu"`` as
    ``jax.nn.gelu``'s default, the tanh approximation."""
    if act == "silu":
        return F.silu
    if act == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {act!r}; the configs use 'silu' or 'gelu'")


def mlp(params: dict[str, torch.Tensor], x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Gated MLP: ``act(x W_gate) * (x W_up)`` then ``W_down``."""
    g = activation(act)(x @ params["w_gate"])
    return (g * (x @ params["w_up"])) @ params["w_down"]


__all__ = [
    "activation", "apply_rope", "dense_init", "embed_init", "mlp", "rms_norm",
    "rope_frequencies",
]
