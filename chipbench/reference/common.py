"""Pieces the families share: RMSNorm, rotary embeddings, and the matmul
the control computes in fp8."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over the whole head dim, the halves rotated as in
    Llama: x (S, H, hd) at positions 0..S-1."""
    S, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang).float()[:, None, :], torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale for the whole tensor (its
    absolute max at 448), back in x's dtype; the gradient passes straight
    through."""
    s = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(x.dtype) * s
    return x + (q - x.detach())


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def matmul_fp8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The control's matmul: both operands in fp8 e4m3, accumulated in f32."""
    return torch.matmul(fp8(a), fp8(b))
