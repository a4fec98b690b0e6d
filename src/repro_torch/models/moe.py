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

A third form has no counterpart in the JAX package: :func:`moe_apply_dropless`
(granite), for an expert layer that holds a contiguous range of the
experts, as under expert parallelism.  It routes over all of them as the
others do, computes every (token, choice) pair whose expert is held, with
no capacity and nothing dropped, and returns the held experts' part of the
result; what the other ranks' experts add is theirs to add.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import activation, dense_init
from repro_torch.models.sharding import reduce_partial

__all__ = ["init_moe", "moe_apply", "moe_apply_dense", "moe_apply_dropless", "moe_capacity"]

Params = dict[str, torch.Tensor]


def init_moe(
    gen: torch.Generator, n_rep: int, d: int, n_experts: int, ff: int,
    dtype: torch.dtype, device: torch.device | str = "cuda", held: int | None = None,
) -> Params:
    """``n_rep`` stacked MoE layers, leaves ``(n_rep, ...)``, with the JAX
    init's distributions: the router f32 at scale 0.02, and the experts at
    ``n_experts ** -0.5`` (JAX's ``dense_init`` takes the leading dim of
    ``(n_experts, d, ff)`` as the fan-in).  ``held`` experts' weights where
    the layer holds a share of them (the router scores all ``n_experts``)."""
    dev = torch.device(device)
    std = (1.0 / n_experts) ** 0.5
    n = held or n_experts
    return {
        "router": dense_init(gen, (n_rep, d, n_experts), torch.float32, dev, scale=0.02),
        "w_down": dense_init(gen, (n_rep, n, ff, d), dtype, dev, scale=std),
        "w_gate": dense_init(gen, (n_rep, n, d, ff), dtype, dev, scale=std),
        "w_up": dense_init(gen, (n_rep, n, d, ff), dtype, dev, scale=std),
    }


def moe_capacity(n_tokens: int, n_experts: int, top_k: int, capacity_factor: float) -> int:
    c = int(n_tokens * top_k * capacity_factor / n_experts)
    return max(8, ((c + 7) // 8) * 8)


def _gates(router: torch.Tensor, x: torch.Tensor, top_k: int):
    """The routing every form shares: x (B, T, d) -> (gates (B, T, k) f32,
    expert ids (B, T, k), aux (B,)).  An f32 router over all E experts, a
    softmax over them, the top k with the gates renormalized over the k
    chosen (equal to a softmax over the k chosen logits, HF Granite's
    form), and Switch's load-balance loss over the first choice."""
    E = router.shape[1]
    probs = torch.softmax(x.float() @ router, dim=-1)  # (B, T, E)
    gates, ids = probs.topk(top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    me = probs.mean(1)
    ce = F.one_hot(ids[..., 0], E).float().mean(1)
    return gates, ids, E * (me * ce).sum(-1)


def _route(params: Params, x: torch.Tensor, top_k: int, capacity_factor: float):
    """x (B, T, d) -> (gates (B, T, k) f32, expert ids (B, T, k), buffer
    rows (B, T*k) into each batch row's (E*C + 1) buffer with dropped pairs
    on its spare last row, aux (B,), E, C).  Every index is local to its
    batch row, so a batch sharded over ranks (DTensor) routes shard by
    shard."""
    B, T, _ = x.shape
    gates, ids, aux = _gates(params["router"], x, top_k)
    E = params["router"].shape[1]
    C = moe_capacity(T, E, top_k, capacity_factor)
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


# ---------------------------------------------------------------------------
# the dropless form over a held share of the experts
# ---------------------------------------------------------------------------


class _PairGather(torch.autograd.Function):
    """x (N, d) -> each pair's token row, in sorted order: ``x[order //
    k]`` (N·k, d).  The backward takes each pair's gradient back to (token,
    choice) order by the inverse permutation, zeroes the pairs that are not
    held (the grouped products leave those rows unwritten) and sums a
    token's k in f32: deterministic, where ``index_select``'s own backward
    adds the k with atomics."""

    @staticmethod
    def forward(ctx, x, order, inv, held, k):
        ctx.save_for_backward(inv, held)
        ctx.k = k
        return x.index_select(0, order // k)

    @staticmethod
    def backward(ctx, g):
        inv, held = ctx.saved_tensors
        gk = g.index_select(0, inv).view(held.shape[0], ctx.k, -1)
        gk = torch.where(held[..., None], gk, torch.zeros((), dtype=g.dtype, device=g.device))
        return gk.sum(1, dtype=torch.float32).to(g.dtype), None, None, None, None


def _zero_past(t: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Rows of ``t`` outside ``valid`` set to zero (by selection: the rows a
    grouped product leaves unwritten may hold anything)."""
    return torch.where(valid[:, None], t, torch.zeros((), dtype=t.dtype, device=t.device))


def _held_grouped(params: Params, xs: torch.Tensor, offs: torch.Tensor,
                  valid: torch.Tensor, act) -> torch.Tensor:
    """The held experts' FFN over the sorted pair rows ``xs`` (N·k, d) as
    three grouped products (``torch._grouped_mm``), expert e over rows
    ``[offs[e-1], offs[e])``.  A grouped product leaves its rows past the
    last offset unwritten, so each product's output is zeroed there: the
    forward and every product of the backward then see zeros in them."""
    g = _zero_past(torch._grouped_mm(xs, params["w_gate"], offs=offs), valid)
    u = _zero_past(torch._grouped_mm(xs, params["w_up"], offs=offs), valid)
    return _zero_past(torch._grouped_mm(act(g) * u, params["w_down"], offs=offs), valid)


def _held_loop(params: Params, xs: torch.Tensor, counts: torch.Tensor, act) -> torch.Tensor:
    """The same by a loop over the held experts, each on its own rows: the
    counts are read on the host (a synchronize)."""
    out, at = [], 0
    for e, c in enumerate(counts.tolist()):
        r = xs[at:at + c]
        out.append((act(r @ params["w_gate"][e]) * (r @ params["w_up"][e])) @ params["w_down"][e])
        at += c
    out.append(xs.new_zeros((xs.shape[0] - at, xs.shape[1])))
    return torch.cat(out)


def moe_apply_dropless(
    params: Params, x: torch.Tensor, *, top_k: int, offset: int = 0, act: str = "silu",
    impl: str = "grouped",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The held experts' part of a MoE layer, nothing dropped: x (B, T, d)
    -> (y (B, T, d), aux (B,), counts (n,)), where the layer holds experts
    ``[offset, offset + n)`` of the router's E (``w_gate`` is (n, d, ff)).

    Routing is :func:`_gates`'.  The (token, choice) pairs are sorted by
    held expert (a stable sort: within an expert in (t, k) order), the
    pairs on experts held elsewhere last; each held expert's FFN runs on
    its own rows, ``impl`` "grouped" (three ``torch._grouped_mm`` over
    every row, offsets on the device: no synchronize) or "loop" (a matmul
    chain per expert, on counts read on the host).  The expert products
    are in the activation dtype; each pair's output times its gate, in the
    activation dtype, and a token's k terms summed in f32.  ``counts`` is
    each held expert's pairs, on the device."""
    B, T, d = x.shape
    N, k, n = B * T, top_k, params["w_gate"].shape[0]
    dd, dev = x.dtype, x.device
    gates, ids, aux = _gates(params["router"], x, top_k)
    local = ids.reshape(N * k) - offset
    held = (local >= 0) & (local < n)
    key = torch.where(held, local, torch.full_like(local, n))  # held elsewhere: last
    order = torch.argsort(key, stable=True)
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(N * k, device=dev))
    counts = torch.zeros(n + 1, dtype=torch.int64, device=dev).scatter_add_(
        0, key, torch.ones_like(key))[:n]
    valid = key.index_select(0, order) < n  # the sorted rows that are held pairs
    xs = _PairGather.apply(x.reshape(N, d), order, inv, held.view(N, k), k)
    a = activation(act)
    if impl == "grouped":
        ye = _held_grouped(params, xs, counts.cumsum(0).to(torch.int32), valid, a)
    elif impl == "loop":
        ye = _held_loop(params, xs, counts, a)
    else:
        raise ValueError(f"unknown dropless impl {impl!r}; 'grouped' or 'loop'")
    terms = ye.index_select(0, inv).view(N, k, d) * gates.reshape(N, k, 1).to(dd)
    y = terms.sum(1, dtype=torch.float32).to(dd)
    return y.view(B, T, d), aux, counts
