"""Mixture-of-Experts layer: top-k routing with per-expert capacity (the
port of ``src/repro/models/moe.py``).

Routing is the JAX module's: an f32 router (f32 even in a bf16 model), a
softmax over the experts in f32, the top k of it with the gates
renormalized over the k chosen, and Switch's load-balance loss
``E * sum(me * ce)`` over the first choice.  Each expert takes at most
``C = moe_capacity(T, ...)`` tokens; the (token, choice) pairs claim their
expert's places in ``(t, k)`` order and the overflow is dropped (a zero
contribution).

Both of the JAX module's forms are here, and they route alike; they differ
only in how the expert FFN rounds:

- :func:`moe_apply_dense` (GShard's one-hot einsums in JAX): bf16 operands
  with f32 products and sums, ``h``, the expert outputs and the gates
  rounded to the activation dtype, the combine summed in f32;
- :func:`moe_apply` (argsort and scatter in JAX): every product in the
  activation dtype, and each token's k terms added in that dtype in
  ascending expert order, the order in which the sorted scatter visits
  them.

Here both dispatch by gather and scatter into ``(E, C)`` expert buffers
(a dropped pair goes to its batch row's spare slot, discarded), which computes the same
numbers as the one-hot einsums: every buffer row has one source token.
Both take a batch of rows (B, T, d) and route each row on its own, as the
JAX LM's ``vmap`` of the (T, d) functions over rows does: the capacity
comes from a row's T.  The expert products are plain ``torch`` matmuls;
the JAX module has no kernel here either.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import activation, dense_init
from repro_torch.models.sharding import reduce_partial

__all__ = ["init_moe", "moe_apply", "moe_apply_dense", "moe_capacity"]

Params = dict[str, torch.Tensor]


def init_moe(
    gen: torch.Generator, n_rep: int, d: int, n_experts: int, ff: int,
    dtype: torch.dtype, device: torch.device | str = "cuda",
) -> Params:
    """``n_rep`` stacked MoE layers, leaves ``(n_rep, ...)``, with the JAX
    init's distributions: the router f32 at scale 0.02, and the experts at
    ``n_experts ** -0.5`` (JAX's ``dense_init`` takes the leading dim of
    ``(n_experts, d, ff)`` as the fan-in)."""
    dev = torch.device(device)
    std = (1.0 / n_experts) ** 0.5
    return {
        "router": dense_init(gen, (n_rep, d, n_experts), torch.float32, dev, scale=0.02),
        "w_down": dense_init(gen, (n_rep, n_experts, ff, d), dtype, dev, scale=std),
        "w_gate": dense_init(gen, (n_rep, n_experts, d, ff), dtype, dev, scale=std),
        "w_up": dense_init(gen, (n_rep, n_experts, d, ff), dtype, dev, scale=std),
    }


def moe_capacity(n_tokens: int, n_experts: int, top_k: int, capacity_factor: float) -> int:
    c = int(n_tokens * top_k * capacity_factor / n_experts)
    return max(8, ((c + 7) // 8) * 8)


def _route(params: Params, x: torch.Tensor, top_k: int, capacity_factor: float):
    """x (B, T, d) -> (gates (B, T, k) f32, expert ids (B, T, k), buffer
    rows (B, T*k) into each batch row's (E*C + 1) buffer with dropped pairs
    on its spare last row, aux (B,), E, C).  Every index is local to its
    batch row, so a batch sharded over ranks (DTensor) routes shard by
    shard."""
    B, T, _ = x.shape
    E = params["router"].shape[1]
    C = moe_capacity(T, E, top_k, capacity_factor)
    probs = torch.softmax(x.float() @ params["router"], dim=-1)  # (B, T, E)
    gates, ids = probs.topk(top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    me = probs.mean(1)
    ce = F.one_hot(ids[..., 0], E).float().mean(1)
    aux = E * (me * ce).sum(-1)
    flat = ids.reshape(B, T * top_k)  # (t, k) priority order
    onehot = F.one_hot(flat, E)
    pos = (onehot.cumsum(1) - onehot).gather(-1, flat[..., None])[..., 0]
    rows = torch.where(pos < C, flat * C + pos, torch.full_like(flat, E * C))
    return gates, ids, rows, aux, E, C


def _dispatch(x: torch.Tensor, rows: torch.Tensor, top_k: int, E: int, C: int) -> torch.Tensor:
    """Each kept (t, k) pair's token into its buffer row: (B, E, C, d) in
    x's dtype, zero where an expert has fewer than C tokens."""
    B, T, d = x.shape
    src = x.repeat_interleave(top_k, dim=1)  # (B, T*k, d)
    # zeros laid out as x is (a DTensor keeps its batch sharding); a kept
    # pair owns its slot, so each slot is one token or zero
    buf = torch.zeros_like(x[:, :1]).expand(B, E * C + 1, d).contiguous()
    buf = buf.scatter_add(1, rows[..., None].expand(B, T * top_k, d), src)
    return buf[:, :-1].reshape(B, E, C, d)


def _gather_out(ye: torch.Tensor, rows: torch.Tensor, top_k: int) -> torch.Tensor:
    """Expert outputs (B, E, C, d) back at each (t, k) pair: (B, T, k, d),
    zero for a dropped pair."""
    B, d = ye.shape[0], ye.shape[-1]
    flat = ye.reshape(B, -1, d)
    flat = torch.cat([flat, torch.zeros_like(flat[:, :1])], dim=1)  # (B, E*C + 1, d)
    out = _RowGather.apply(flat, rows[..., None].expand(*rows.shape, d))
    return out.reshape(B, -1, top_k, d)


class _RowGather(torch.autograd.Function):
    """``src.gather(1, idx)`` whose backward scatters into zeros laid out as
    the gradient is: the composite backward of ``gather`` makes its zeros
    from the whole shape, which on a batch-sharded DTensor is the whole
    batch on every rank.  The same numbers either way."""

    @staticmethod
    def forward(ctx, src, idx):
        ctx.save_for_backward(idx)
        ctx.rows = src.shape[1]
        return src.gather(1, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        B, _, d = g.shape
        zeros = torch.zeros_like(g[:, :1]).expand(B, ctx.rows, d).contiguous()
        return zeros.scatter_add(1, idx, g), None


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the incoming gradient contiguous.  A
    DTensor gradient can arrive with a transposed local shard, which the
    expert einsum's backward then views as (E, B·C, ·) and cannot; on a
    plain, contiguous gradient it does nothing."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _experts(spec: str, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _ContiguousGrad.apply(torch.einsum(spec, a, w))


def moe_apply_dense(
    params: Params, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25,
    act: str = "silu",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The dense form's numbers: x (B, T, d), each row routed on its own
    -> (y (B, T, d), aux (B,)).  Operands in the activation dtype, products
    and sums in f32 (bf16 operands widened to f32 are exact), ``h`` and
    the expert outputs rounded to the activation dtype, the gates too."""
    dd, f32 = x.dtype, torch.float32
    gates, _, rows, aux, E, C = _route(params, x, top_k, capacity_factor)
    xe = _dispatch(x, rows, top_k, E, C).to(f32)
    g = _experts("becd,edf->becf", xe, params["w_gate"].to(f32))
    u = _experts("becd,edf->becf", xe, params["w_up"].to(f32))
    h = (activation(act)(g) * u).to(dd)
    # w_down split over its hidden width leaves ye a pending sum: reduced
    # before the gather back to tokens (a no-op unsharded)
    ye = reduce_partial(_experts("becf,efd->becd", h.to(f32), params["w_down"].to(f32))).to(dd)
    out = _gather_out(ye, rows, top_k).to(f32)
    y = (out * gates.to(dd).to(f32)[..., None]).sum(2)
    return y.to(dd), aux


def moe_apply(
    params: Params, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25,
    act: str = "silu",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The sort form's numbers: x (B, T, d), each row routed on its own
    -> (y (B, T, d), aux (B,)).  The expert FFN and the gate products in
    the activation dtype; each token's k terms added in that dtype in
    ascending expert order."""
    dd = x.dtype
    gates, ids, rows, aux, E, C = _route(params, x, top_k, capacity_factor)
    xe = _dispatch(x, rows, top_k, E, C)
    a = activation(act)
    h = a(_experts("becd,edf->becf", xe, params["w_gate"])) * _experts(
        "becd,edf->becf", xe, params["w_up"])
    ye = reduce_partial(_experts("becf,efd->becd", h, params["w_down"]))
    terms = _gather_out(ye, rows, top_k) * gates.to(dd)[..., None]  # (B, T, k, d)
    order = ids.argsort(dim=-1)  # a token's k experts are distinct
    terms = terms.gather(2, order[..., None].expand_as(terms))
    y = terms[:, :, 0]
    for j in range(1, top_k):
        y = y + terms[:, :, j]
    return y.to(dd), aux
