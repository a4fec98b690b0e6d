"""GQA attention for training (the port of ``attention_forward`` in
``src/repro/models/attention.py``).

Plain einsum + softmax, with the JAX module's precision: scores and softmax
in f32 whatever the parameter dtype, probabilities cast back to the value
dtype for the output product.  The JAX function sweeps queries in chunks of
512 with ``lax.scan`` to bound live memory; softmax rows are independent,
so one pass over all queries computes the same values.  The flash-attention
kernel is not on this path (its port is a later slice), nor is the
sliding window: no dense config uses one.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import apply_rope

NEG_INF = -1e30


def _project_qkv(params, x, n_heads, n_kv, head_dim):
    B, S, _ = x.shape
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    return (
        q.reshape(B, S, n_heads, head_dim),
        k.reshape(B, S, n_kv, head_dim),
        v.reshape(B, S, n_kv, head_dim),
    )


def attention_forward(
    params: dict[str, torch.Tensor],
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    rotary_dim: int,
    rope_theta: float,
    causal: bool = True,
) -> torch.Tensor:
    """x: (B, S, d); positions: (S,) or (B, S).  Returns (B, S, d)."""
    B, S, _ = x.shape
    G = n_heads // n_kv
    q, k, v = _project_qkv(params, x, n_heads, n_kv, head_dim)
    pos = positions.expand(B, S) if positions.dim() == 1 else positions
    q = apply_rope(q, pos, rotary_dim=rotary_dim, theta=rope_theta)
    k = apply_rope(k, pos, rotary_dim=rotary_dim, theta=rope_theta)
    q = q.reshape(B, S, n_kv, G, head_dim) * (head_dim**-0.5)

    kpos = pos[0]  # positions are identical across the batch
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float())  # (B, K, G, S, S)
    if causal:
        mask = kpos[None, :] <= kpos[:, None]
        s = torch.where(mask, s, torch.full((), NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v).reshape(B, S, -1)
    return o @ params["wo"]
