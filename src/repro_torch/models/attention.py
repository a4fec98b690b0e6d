"""GQA attention: training and prefill, and one-token cached decode (the
port of ``src/repro/models/attention.py``).

The model's own attention is plain einsum + softmax with the JAX module's
precision: q scaled in the parameter dtype, scores and softmax in f32
whatever the parameter dtype, probabilities cast back to the value dtype
for the output product.  The JAX function sweeps queries in chunks of 512
with ``lax.scan`` to bound live memory; softmax rows are independent, so
one pass over all queries computes the same values.

Prefill may instead run ``kernels.ops.flash_attention`` (``flash=True``):
the hand-written sm_90a kernel or its plain version, as ``impl`` picks
there (None: by device).  Those keep p in f32 and scale q in f32,
so in bf16 they round differently from the model's own attention (by about
one bf16 ulp of p and of the output); in f32 they agree to summation order.
Training keeps the model's own attention: the kernel has no backward.

Sliding-window attention (the JAX module's window mask and ring cache,
used by mixtral and jamba) is not ported at the model level; the flash
kernel itself takes a window.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope

__all__ = ["NEG_INF", "attention_decode", "attention_forward"]

NEG_INF = -1e30

Params = dict[str, torch.Tensor]


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


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B, Sq, K, G, hd), k: (B, Sk, K, hd) -> (B, K, G, Sq, Sk) in f32."""
    return torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float())


def _gqa_out(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p: (B, K, G, Sq, Sk) f32, v: (B, Sk, K, hd) -> (B, Sq, K*G*hd)."""
    o = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v)
    return o.reshape(o.shape[0], o.shape[1], -1)


def _neg_inf(s: torch.Tensor) -> torch.Tensor:
    return torch.full((), NEG_INF, dtype=s.dtype, device=s.device)


def attention_forward(
    params: Params,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    rotary_dim: int,
    rope_theta: float,
    causal: bool = True,
    return_cache: bool = False,
    cache_len: int | None = None,
    flash: bool = False,
    impl: str | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor] | None]:
    """Train / prefill attention.  x: (B, S, d); positions: (S,) or (B, S).
    Returns ``(out (B, S, d), cache)``; the cache is ``{"k", "v"}``
    (B, cache_len, K, hd), the keys and values padded with zeros to
    ``cache_len`` (default S), when ``return_cache``, else None.

    ``flash`` runs ``ops.flash_attention`` with ``impl`` in place of the
    model's own attention (the training path)."""
    B, S, _ = x.shape
    G = n_heads // n_kv
    q, k, v = _project_qkv(params, x, n_heads, n_kv, head_dim)
    pos = positions.expand(B, S) if positions.dim() == 1 else positions
    q = apply_rope(q, pos, rotary_dim=rotary_dim, theta=rope_theta)
    k = apply_rope(k, pos, rotary_dim=rotary_dim, theta=rope_theta)
    if flash:
        o = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                causal=causal, impl=impl)
        out = o.reshape(B, S, n_heads * head_dim)
    else:
        qh = q.reshape(B, S, n_kv, G, head_dim) * (head_dim**-0.5)
        s = _gqa_scores(qh, k)  # (B, K, G, S, S)
        if causal:
            kpos = pos[0]  # positions are identical across the batch
            mask = kpos[None, :] <= kpos[:, None]
            s = torch.where(mask, s, _neg_inf(s))
        out = _gqa_out(torch.softmax(s, dim=-1), v)
    out = out @ params["wo"]
    cache = None
    if return_cache:
        pad = (cache_len or S) - S
        if pad < 0:
            raise ValueError(f"prompt length {S} exceeds cache_len {cache_len}")
        cache = {"k": F.pad(k, (0, 0, 0, 0, 0, pad)), "v": F.pad(v, (0, 0, 0, 0, 0, pad))}
    return out, cache


def attention_decode(
    params: Params,
    x: torch.Tensor,
    cache: dict[str, torch.Tensor],
    pos: torch.Tensor,
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    rotary_dim: int,
    rope_theta: float,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One-token decode.  x: (B, 1, d); pos: a 0-d int tensor (every row at
    one position) or (B,) (slot-indexed serving: each row at its own).
    cache["k"/"v"]: (B, S_cache, K, hd).

    The new key and value are written into the cache IN PLACE, and the
    cache is returned, as the JAX function returns its updated copy.  A
    write past the cache's end is dropped for a ``(B,)`` position (JAX's
    scatter drops it; a free serving slot's position runs on) and clamped
    to the last row for a scalar one (``dynamic_update_slice`` clamps)."""
    B = x.shape[0]
    G = n_heads // n_kv
    q, k, v = _project_qkv(params, x, n_heads, n_kv, head_dim)
    posb = pos[:, None] if pos.dim() else pos.expand(B, 1)
    q = apply_rope(q, posb, rotary_dim=rotary_dim, theta=rope_theta)
    k = apply_rope(k, posb, rotary_dim=rotary_dim, theta=rope_theta)

    kc, vc = cache["k"], cache["v"]
    S_c = kc.shape[1]
    slot = pos.clamp(max=S_c - 1).long()
    if pos.dim():
        rows = torch.arange(B, device=x.device)
        keep = (pos < S_c)[:, None, None]
        kc.index_put_((rows, slot), torch.where(keep, k[:, 0], kc[rows, slot]))
        vc.index_put_((rows, slot), torch.where(keep, v[:, 0], vc[rows, slot]))
    else:
        kc.index_copy_(1, slot.reshape(1), k)
        vc.index_copy_(1, slot.reshape(1), v)

    qh = q.reshape(B, 1, n_kv, G, head_dim) * (head_dim**-0.5)
    s = _gqa_scores(qh, kc)  # (B, K, G, 1, S_c)
    idx = torch.arange(S_c, device=x.device)
    pcol = pos[:, None] if pos.dim() else pos
    valid = (idx <= pcol).expand(B, S_c)
    s = torch.where(valid[:, None, None, None, :], s, _neg_inf(s))
    out = _gqa_out(torch.softmax(s, dim=-1), vc) @ params["wo"]
    return out, {"k": kc, "v": vc}
