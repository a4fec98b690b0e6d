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
Training runs ``kernels.ops.flash_attention_train``: the hand-written
forward and backward, with the model's rounding, where :func:`train_kernel`
says the kernels take the tensors (plain bf16 tensors on the card with a
head size in ``HEAD_DIMS`` and ``impl`` not "torch"), and its plain
version, the model's own chain, everywhere else (the CPU, f32, hubert's
head size, ``impl="torch"``).  The dry run's DTensors run the same chain
with the head split and the batch anchored by ``models.sharding``.

Sliding windows (mixtral): train and prefill mask ``kpos > qpos - window``
(the flash kernel takes the window too); prefill returns a RING cache of
exactly ``window`` rows whatever ``cache_len`` is, position p in slot
``p % window``, holding the last ``min(S, window)`` positions; decode
writes slot ``pos % window`` and reads every slot once the ring has
wrapped.

A KV cache that is a DTensor (the dry run's sharded decode cells) takes
another path: :func:`~repro_torch.models.sharding.on_cache_shards` runs the
write and the attention on each rank's own cache rows, the softmax reduced
across the sequence shards (:func:`_decode_shard`), so the cache keeps its
layout.  A plain cache never does.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.models.layers import apply_rope
from repro_torch.models.sharding import on_cache_shards, shard_batch, split_dim
from repro_torch.obs.trace import NULL_SPAN

__all__ = ["NEG_INF", "attention_decode", "attention_forward", "train_kernel"]

NEG_INF = -1e30

Params = dict[str, torch.Tensor]


def _project_qkv(params, x, n_heads, n_kv, head_dim):
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    # anchor the batch dim (a no-op unless sharding axes are installed).
    # JAX anchors after the head split and rope; here it comes before the
    # split, which a head count the model axis does not divide (8 KV heads
    # over 16) cannot take on a DTensor sharded over heads
    q, k, v = shard_batch(q), shard_batch(k), shard_batch(v)
    return (split_dim(q, -1, (n_heads, head_dim)), split_dim(k, -1, (n_kv, head_dim)),
            split_dim(v, -1, (n_kv, head_dim)))


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B, Sq, K, G, hd), k: (B, Sk, K, hd) -> (B, K, G, Sq, Sk) in f32."""
    return torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float())


def _gqa_out(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p: (B, K, G, Sq, Sk) f32, v: (B, Sk, K, hd) -> (B, Sq, K*G*hd)."""
    o = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v)
    return o.reshape(o.shape[0], o.shape[1], -1)


def _neg_inf(s: torch.Tensor) -> torch.Tensor:
    return torch.full((), NEG_INF, dtype=s.dtype, device=s.device)


def train_kernel(x: torch.Tensor, head_dim: int, impl: str | None) -> bool:
    """Whether training attention on tensors like ``x`` (its q, k and v)
    runs the hand-written kernels: a plain (not DTensor) bf16 tensor on
    the card, a head size the kernels are built for, and ``impl`` not
    "torch"."""
    return (impl != "torch" and not isinstance(x, DTensor) and x.is_cuda
            and x.dtype == torch.bfloat16 and head_dim in HEAD_DIMS)


def _sharded_chain(q, k, v, kpos, *, n_kv, head_dim, causal, window,
                   scale=None) -> torch.Tensor:
    """The model's own chain on DTensors (``flash_attention_train_torch``'s
    arithmetic): the head split by ``split_dim``, which gathers a head dim
    that the mesh cannot split, and the output's batch anchored.  q (B, S,
    H, hd) unscaled, k / v (B, S, K, hd), kpos (S,) -> (B, S, H*hd)."""
    S = q.shape[1]
    scale = head_dim**-0.5 if scale is None else scale
    qh = split_dim(q, 2, (n_kv, q.shape[2] // n_kv)) * scale
    s = _gqa_scores(qh, k)  # (B, K, G, S, S)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= kpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > kpos[:, None] - window
    if causal or window is not None:
        s = torch.where(mask, s, _neg_inf(s))
    return shard_batch(_gqa_out(torch.softmax(s, dim=-1), v))


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
    window: int | None = None,
    return_cache: bool = False,
    cache_len: int | None = None,
    flash: bool = False,
    impl: str | None = None,
    region=NULL_SPAN,
    scale: float | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor] | None]:
    """Train / prefill attention.  x: (B, S, d); positions: (S,) or (B, S).
    Returns ``(out (B, S, d), cache)``; the cache is ``{"k", "v"}`` when
    ``return_cache``, else None: (B, cache_len, K, hd), the keys and values
    padded with zeros to ``cache_len`` (default S), or with a ``window``
    the (B, window, K, hd) ring.

    ``flash`` runs ``ops.flash_attention`` with ``impl`` in place of the
    model's own attention (prefill).  Without it (training),
    ``ops.flash_attention_train`` runs the kernels where
    :func:`train_kernel` admits q and its plain version elsewhere, and
    DTensors run :func:`_sharded_chain`; the choice is set on ``region``
    (the layer's ``device.mixer`` span) as ``impl``, "kernel" or
    "plain".  ``scale`` is the score scale q is multiplied by (None:
    ``head_dim ** -0.5``); prefill at another scale runs the training
    attention, as the prefill kernels scale by ``head_dim ** -0.5``."""
    B, S, _ = x.shape
    scale = head_dim**-0.5 if scale is None else scale
    q, k, v = _project_qkv(params, x, n_heads, n_kv, head_dim)
    pos = positions.expand(B, S) if positions.dim() == 1 else positions
    q = apply_rope(q, pos, rotary_dim=rotary_dim, theta=rope_theta)
    k = apply_rope(k, pos, rotary_dim=rotary_dim, theta=rope_theta)
    if flash and scale == head_dim**-0.5:  # the prefill kernels scale by head_dim ** -0.5
        o = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                causal=causal, window=window, impl=impl)
        out = o.reshape(B, S, n_heads * head_dim)
    elif isinstance(q, DTensor):
        region.set(impl="plain")
        # positions are identical across the batch
        out = _sharded_chain(q, k, v, pos[0], n_kv=n_kv, head_dim=head_dim, causal=causal,
                             window=window, scale=scale)
    else:
        kernel = train_kernel(q, head_dim, impl)
        region.set(impl="kernel" if kernel else "plain")
        o = ops.flash_attention_train((q * scale).contiguous(), k.contiguous(),
                                      v.contiguous(), causal=causal, window=window,
                                      impl="cuda" if kernel else "torch")
        out = o.reshape(B, S, n_heads * head_dim)
    out = out @ params["wo"]
    cache = None
    if return_cache:
        cache = _ring(k, v, pos[0], window) if window is not None else _padded(k, v, cache_len)
    return out, cache


def _padded(k: torch.Tensor, v: torch.Tensor, cache_len: int | None) -> dict[str, torch.Tensor]:
    S = k.shape[1]
    pad = (cache_len or S) - S
    if pad < 0:
        raise ValueError(
            f"prompt length {S} exceeds cache_len {cache_len} (a vision prompt's length "
            "counts its patch positions)")
    return {"k": F.pad(k, (0, 0, 0, 0, 0, pad)), "v": F.pad(v, (0, 0, 0, 0, 0, pad))}


def _ring(k: torch.Tensor, v: torch.Tensor, kpos: torch.Tensor, W: int) -> dict[str, torch.Tensor]:
    """The last ``min(S, W)`` positions in a ring of W rows, position p in
    slot ``p % W``; for S < W the slots past the prompt hold copies of its
    last key and value (decode reads no slot past its position until it
    has written it)."""
    S = k.shape[1]
    take = min(S, W)
    idx = torch.arange(W, device=k.device)
    src = (idx + max(S - W, 0)).clamp(max=S - 1)
    slots = (kpos[-1].long() + 1 - take + idx) % W
    kc, vc = k.new_zeros((k.shape[0], W, *k.shape[2:])), v.new_zeros((v.shape[0], W, *v.shape[2:]))
    kc[:, slots] = k[:, src]
    vc[:, slots] = v[:, src]
    return {"k": kc, "v": vc}


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
    window: int | None = None,
    scale: float | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One-token decode.  x: (B, 1, d); pos: a 0-d int tensor (every row at
    one position) or (B,) (slot-indexed serving: each row at its own).
    cache["k"/"v"]: (B, S_cache, K, hd), the ring of ``window`` rows for a
    sliding window (slot ``pos % S_cache``; every slot valid once a row's
    position has passed the ring).

    The new key and value are written into the cache IN PLACE, and the
    cache is returned, as the JAX function returns its updated copy.  A
    write past the cache's end is dropped for a ``(B,)`` position (JAX's
    scatter drops it; a free serving slot's position runs on) and clamped
    to the last row for a scalar one (``dynamic_update_slice`` clamps).
    ``scale`` as :func:`attention_forward` takes it."""
    B = x.shape[0]
    G = n_heads // n_kv
    scale = head_dim**-0.5 if scale is None else scale
    q, k, v = _project_qkv(params, x, n_heads, n_kv, head_dim)
    posb = pos[:, None] if pos.dim() else pos.expand(B, 1)
    q = apply_rope(q, posb, rotary_dim=rotary_dim, theta=rope_theta)
    k = apply_rope(k, posb, rotary_dim=rotary_dim, theta=rope_theta)

    kc, vc = cache["k"], cache["v"]
    if isinstance(kc, DTensor):
        qh = split_dim(q, 2, (n_kv, G)) * scale
        o = on_cache_shards(functools.partial(_decode_shard, window=window),
                            qh, k, v, kc, vc, pos)
        return o @ params["wo"], {"k": kc, "v": vc}
    S_c = kc.shape[1]
    slot = (pos % S_c if window is not None else pos.clamp(max=S_c - 1)).long()
    if pos.dim():
        rows = torch.arange(B, device=x.device)
        keep = ((pos < S_c) | (window is not None))[:, None, None]
        kc.index_put_((rows, slot), torch.where(keep, k[:, 0], kc[rows, slot]))
        vc.index_put_((rows, slot), torch.where(keep, v[:, 0], vc[rows, slot]))
    else:
        kc.index_copy_(1, slot.reshape(1), k)
        vc.index_copy_(1, slot.reshape(1), v)

    qh = split_dim(q, 2, (n_kv, G)) * scale
    s = _gqa_scores(qh, kc)  # (B, K, G, 1, S_c)
    idx = torch.arange(S_c, device=x.device)
    pcol = pos[:, None] if pos.dim() else pos
    valid = idx <= pcol
    if window is not None:
        valid = valid | (pcol >= S_c)
    valid = valid.expand(B, S_c)
    s = torch.where(valid[:, None, None, None, :], s, _neg_inf(s))
    out = _gqa_out(torch.softmax(s, dim=-1), vc) @ params["wo"]
    return out, {"k": kc, "v": vc}


def _decode_shard(q, k, v, kc, vc, pos, *, start: int, S_c: int, window: int | None, reduce):
    """:func:`attention_decode`'s write and attention on one rank's rows
    ``[start, start + S_loc)`` of a (B, S_c, K, hd) cache sharded by
    sequence (plain local tensors, under ``on_cache_shards``).  The new
    row is written where this rank holds its slot; the scores of the local
    rows are masked by their global positions, and the softmax's max and
    sum and the output's partial sums are ``reduce``d across the shards,
    the output in f32.  q: (B, 1, K, G, hd); returns (B, 1, K·G·hd)."""
    B, S_loc = kc.shape[:2]
    rows = torch.arange(B, device=kc.device)
    posb = pos.expand(B) if pos.dim() == 0 else pos
    slot = (posb % S_c if window is not None else posb.clamp(max=S_c - 1)).long()
    li = slot - start
    mine = (li >= 0) & (li < S_loc)
    if pos.dim() and window is None:
        mine &= posb < S_c  # a (B,) position past the cache writes nothing
    li = li.clamp(0, S_loc - 1)
    for c, new in ((kc, k), (vc, v)):
        c.index_put_((rows, li), torch.where(mine[:, None, None], new[:, 0], c[rows, li]))
    s = _gqa_scores(q, kc)  # (B, K, G, 1, S_loc)
    pcol = posb[:, None]
    valid = start + torch.arange(S_loc, device=kc.device) <= pcol
    if window is not None:
        valid = valid | (pcol >= S_c)
    s = torch.where(valid[:, None, None, None, :], s, _neg_inf(s))
    e = torch.exp(s - reduce(s.amax(-1, keepdim=True), "max"))
    p = e / reduce(e.sum(-1, keepdim=True), "sum")
    return reduce(_gqa_out(p, vc).float(), "sum").to(vc.dtype)
