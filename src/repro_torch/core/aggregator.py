"""Coded gradient aggregation (the port of ``src/repro/core/aggregator.py``).

Three implementations of the same math:

1. :func:`protocol_reference` — the paper's protocol verbatim: every worker
   materializes its coded gradient g̃_w = Σ_j B[w,j]·g_j, the master decodes
   g = Σ_w a_w·g̃_w.  The oracle.
2. :func:`fused_coded_value_and_grad` — linear encoding commutes with ∇, so
   the decoded gradient is ONE backward pass over the example-weighted loss
   Σ_w a_w Σ_j B[w,j]·L(D_j).
3. :func:`faithful_spmd_step` — the wire protocol: each worker flattens its
   per-slot gradients into an f32 (n_slots, D) stack and encodes them with
   one ``coded_reduce`` launch; the master decode Σ_w (a_w/k)·g̃_w is one
   more ``coded_reduce`` launch over the (m, D) coded stack.  With
   ``compress`` the wire is int8 with per-worker error feedback, encoded by
   the fused ``coded_encode_int8`` kernel and decoded straight off the int8
   payloads (``wire_kernel``), or by ``coded_reduce`` and the plain
   quantize.  One process runs the m workers in turn on one device.
4. :func:`group_spmd_step` — the same protocol across processes, as the JAX
   package's ``shard_map`` runs it across devices: this rank is one coded
   worker of a ``torch.distributed`` group, encodes its own stack, and the
   decode is one ``all_reduce`` of a_w·g̃_w (JAX's psum) or, on the int8
   wire, an ``all_gather`` of the payloads and of scale·a_w feeding one
   ``coded_decode_int8`` launch on every rank.

The numpy half (:class:`CodedPlan`, :func:`make_plan`, the host slot
weights) is a copy of the JAX module's; the ``*_device`` functions are its
in-jit twins as tensor gathers.  :func:`spread_copies_device`, which the
engine's fused pass applies to its slot weights, has no JAX counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.coding import CodingScheme
from repro_torch.core.decoding import Decoder
from repro_torch.kernels.coded_reduce import coded_reduce
from repro_torch.kernels.ref import dequantize, quantize_int8
from repro_torch.kernels.wire import coded_decode_int8, coded_encode_int8
from repro_torch.launch.mesh import CodedGroup, all_gather_flat, all_reduce_sum_
from repro_torch.obs.trace import NULL_TRACER, NullTracer, Tracer

__all__ = [
    "CodedPlan",
    "make_plan",
    "slot_weights",
    "slot_weights_device",
    "support_slot_mask",
    "support_slot_mask_device",
    "uniform_weights",
    "spread_copies_device",
    "pack_coded_batch",
    "pack_flat_device",
    "protocol_reference",
    "fused_coded_value_and_grad",
    "faithful_spmd_step",
    "group_spmd_step",
    "remap_err_rows",
    "FlatView",
]

Params = dict[str, torch.Tensor]
Batch = dict[str, torch.Tensor]
LossFn = Callable[[Params, Batch], torch.Tensor]  # (params, slot_batch) -> scalar


@dataclasses.dataclass(frozen=True)
class CodedPlan:
    """Device-feedable view of a CodingScheme.

    Attributes:
      slot_pids: (m, n_max) int32 partition id per worker slot (0-padded).
      slot_mask: (m, n_max) float, 1 for real slots, 0 for padding.
      slot_coeff: (m, n_max) float32, B[w, slot_pids[w, s]] (0 on padding).
      m, k, n_max: sizes.
    """

    slot_pids: np.ndarray
    slot_mask: np.ndarray
    slot_coeff: np.ndarray
    m: int
    k: int
    n_max: int


def make_plan(scheme: CodingScheme, n_slots: int | None = None) -> CodedPlan:
    """``n_slots`` pads every worker to a fixed slot count so elastic
    re-encodes never change tensor shapes."""
    m, k = scheme.m, scheme.k
    n_max = max(1, max(scheme.allocation.counts))
    if n_slots is not None:
        if n_slots < n_max:
            raise ValueError(f"n_slots={n_slots} < allocation max {n_max}")
        n_max = n_slots
    pids = np.zeros((m, n_max), dtype=np.int32)
    mask = np.zeros((m, n_max), dtype=np.float32)
    coeff = np.zeros((m, n_max), dtype=np.float32)
    for w, parts in enumerate(scheme.allocation.partitions):
        for slot, j in enumerate(parts):
            pids[w, slot] = j
            mask[w, slot] = 1.0
            coeff[w, slot] = scheme.B[w, j]
    return CodedPlan(slot_pids=pids, slot_mask=mask, slot_coeff=coeff, m=m, k=k, n_max=n_max)


def support_slot_mask(plan: CodedPlan, support: np.ndarray) -> np.ndarray:
    """Slot-space view of an (m, k) partial-work completion mask, re-masked
    by ``slot_mask`` because padding slots gather pid 0."""
    done = np.asarray(support, np.float32)[np.arange(plan.m)[:, None], plan.slot_pids]
    return done * plan.slot_mask


def slot_weights(
    plan: CodedPlan, decode_vec: np.ndarray, support: np.ndarray | None = None
) -> np.ndarray:
    """Fused-path weights: W[w,s] = a_w · B[w, pid(w,s)] / k (0 on padding),
    zeroed where the optional (m, k) ``support`` says the work is missing."""
    a = np.asarray(decode_vec, dtype=np.float32).reshape(plan.m, 1)
    w = a * plan.slot_coeff * plan.slot_mask / plan.k
    if support is not None:
        w = w * support_slot_mask(plan, support)
    return w.astype(np.float32)


def uniform_weights(plan: CodedPlan) -> np.ndarray:
    """Uncoded-DP weights (naive scheme): every real slot weight 1/k."""
    return (plan.slot_mask / plan.k).astype(np.float32)


# ---------------------------------------------------------------------------
# device twins of the host pack/weights
# ---------------------------------------------------------------------------


def support_slot_mask_device(
    support: torch.Tensor, slot_pids: torch.Tensor, slot_mask: torch.Tensor
) -> torch.Tensor:
    """On-device :func:`support_slot_mask` (``slot_pids`` int64)."""
    return support.float().gather(1, slot_pids) * slot_mask


def slot_weights_device(
    a: torch.Tensor,
    support: torch.Tensor,
    slot_coeff: torch.Tensor,
    slot_mask: torch.Tensor,
    slot_pids: torch.Tensor,
    k: int,
) -> torch.Tensor:
    """On-device :func:`slot_weights`: W[w,s] = a_w·B[w,pid]·done[w,pid]/k,
    in the dtype ``a`` and ``slot_coeff`` promote to (f32 for f32 inputs).
    Callers without partial work pass an all-ones ``support``."""
    done = support_slot_mask_device(support, slot_pids, slot_mask)
    return a[:, None] * slot_coeff * done / k


def spread_copies_device(weights: torch.Tensor, slot_pids: torch.Tensor,
                         slot_mask: torch.Tensor, k: int) -> torch.Tensor:
    """Slot weights (m, n_slots) with each partition's total spread evenly
    over its copies that carry weight, returned in f32.  The copies are the
    same rows, so the decoded gradient is the same; but an ill-conditioned
    decode weights two copies by nearly opposite large numbers (Tandon's
    cyclic B at m 4, s 1 reaches thousands for a partition whose total is
    1/k), whose gradients a bf16 backward cannot cancel.  Pass weights in
    f64 (the decode vector and B in f64): the totals are then exact to
    about 1e-12, where f32 products leave errors of 1e-3 of a total.  A
    slot of zero weight stays zero.  The sums are products with a one-hot
    (slot, partition) matrix: deterministic."""
    flat = weights.reshape(-1)
    onehot = F.one_hot(slot_pids.reshape(-1), k).to(flat.dtype) * slot_mask.reshape(-1, 1)
    live = (flat != 0).to(flat.dtype)
    even = (flat @ onehot) / (live @ onehot).clamp(min=1)  # (k,)
    return (live * (onehot @ even)).float().view_as(weights)


def pack_flat_device(partition_batch: Batch, slot_pids: torch.Tensor, weights: torch.Tensor) -> Batch:
    """Slot pack: partition-major leaves (k, mb, ...) -> the fused flat
    coded batch (m·n_slots·mb, ...) with per-sequence loss weights.  The
    (s+1)×-replicated working set is made here, on the device."""
    idx = slot_pids.reshape(-1)
    out: Batch = {}
    mb = None
    for key, x in partition_batch.items():
        g = x.reshape(x.shape[0], -1).index_select(0, idx)
        mb = x.shape[1]
        out[key] = g.reshape((-1,) + tuple(x.shape[2:]))
    out["weight"] = (weights.reshape(-1).repeat_interleave(mb) / mb).float()
    return out


def pack_coded_batch(partition_batch: Batch, slot_pids: torch.Tensor) -> Batch:
    """Partition-major (k, mb, ...) -> slot-major (m, n_slots, mb, ...) by an
    ``index_select`` on a (k, mb·rest) view."""
    m, n = slot_pids.shape
    idx = slot_pids.reshape(-1)
    return {
        key: x.reshape(x.shape[0], -1).index_select(0, idx).reshape((m, n) + tuple(x.shape[1:]))
        for key, x in partition_batch.items()
    }


def remap_err_rows(err: torch.Tensor, old_of_new: Sequence[int | None]) -> torch.Tensor:
    """Per-worker wire-state row remap for a membership transition.

    ``err`` is the spmd backend's (m_old, width) error-feedback buffer;
    ``old_of_new[i]`` is the old index that became new worker ``i``, or
    None for a joiner.  Retained workers keep their accumulated residual
    row (gathered on the buffer's device), while joiners (and the rows of
    departed workers) start from zero: a leaver's residual encodes
    coefficients that no longer exist in the remapped B."""
    m_old = int(err.shape[0])
    idx = np.array([m_old if o is None else int(o) for o in old_of_new], np.int64)
    if np.any((idx < 0) | (idx > m_old)):
        raise ValueError(f"row map {list(old_of_new)} out of range for m_old={m_old}")
    padded = torch.cat([err, torch.zeros((1,) + tuple(err.shape[1:]), dtype=err.dtype,
                                         device=err.device)])
    return padded.index_select(0, torch.as_tensor(idx, device=err.device))


# ---------------------------------------------------------------------------
# flat views of a parameter dict (ravel_pytree)
# ---------------------------------------------------------------------------


class FlatView:
    """Offsets of each parameter in the raveled (D,) vector, in the dict's
    order (the JAX flatten order).  :meth:`unravel` follows
    ``jax.flatten_util.ravel_pytree``: when every leaf has one dtype the
    unraveled leaves keep the flat vector's dtype; otherwise each leaf is
    cast back to its own dtype."""

    def __init__(self, params: Params):
        self.keys = list(params)
        self.shapes = [tuple(p.shape) for p in params.values()]
        self.dtypes = [p.dtype for p in params.values()]
        sizes = [p.numel() for p in params.values()]
        self.offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        self.size = int(self.offsets[-1])
        self.single_dtype = len(set(self.dtypes)) == 1

    def write(self, row: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
        """Ravel ``tensors`` (in key order) into the (D,) ``row``, casting to
        its dtype, without an intermediate concatenation."""
        for i, t in enumerate(tensors):
            row[self.offsets[i] : self.offsets[i + 1]].copy_(t.reshape(-1))

    def unravel(self, flat: torch.Tensor) -> Params:
        out = {}
        for i, key in enumerate(self.keys):
            leaf = flat[self.offsets[i] : self.offsets[i + 1]].view(self.shapes[i])
            out[key] = leaf if self.single_dtype else leaf.to(self.dtypes[i])
        return out


def _grad_fn(loss_fn: LossFn) -> Callable[[Params, Batch], tuple[torch.Tensor, list[torch.Tensor]]]:
    """(params, batch) -> (loss, grads in key order, in the params' dtypes)."""

    def fn(params: Params, batch: Batch):
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        with torch.enable_grad():
            loss = loss_fn(leaves, batch)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), list(grads)

    return fn


# ---------------------------------------------------------------------------
# 1. protocol oracle (paper-verbatim)
# ---------------------------------------------------------------------------


def protocol_reference(
    loss_fn: LossFn,
    params: Params,
    partition_batch: Batch,
    scheme: CodingScheme,
    available: Sequence[int] | None = None,
    decode_vec: np.ndarray | None = None,
    support: np.ndarray | None = None,
) -> tuple[Params, list[Params]]:
    """Paper protocol, literally.  Returns (decoded mean gradient, [g̃_w]).

    Workers compute per-partition gradients, encode with their B row (only
    the partitions they finished when ``support`` is given), the master
    decodes from the available set or with ``decode_vec``."""
    m, k = scheme.m, scheme.k
    grad = _grad_fn(loss_fn)
    keys = list(params)
    part_grads = []
    for j in range(k):
        _, g = grad(params, {key: x[j] for key, x in partition_batch.items()})
        part_grads.append(dict(zip(keys, g)))
    coded = []
    for w in range(m):
        gw = {key: torch.zeros_like(p) for key, p in params.items()}
        for j in scheme.allocation.partitions[w]:
            bwj = float(scheme.B[w, j]) * (1.0 if support is None else float(support[w, j]))
            gw = {key: gw[key] + bwj * part_grads[j][key] for key in keys}
        coded.append(gw)
    if decode_vec is not None:
        a = np.asarray(decode_vec, np.float64)
        avail = [i for i in range(m) if abs(a[i]) > 1e-12]
    else:
        avail = list(range(m)) if available is None else list(available)
        a = Decoder(scheme).decode_vector(avail)
    decoded = {key: torch.zeros_like(p) for key, p in params.items()}
    for w in avail:
        if abs(a[w]) < 1e-12:
            continue
        aw = float(a[w])
        decoded = {key: decoded[key] + aw * coded[w][key] for key in keys}
    decoded = {key: g / k for key, g in decoded.items()}
    return decoded, coded


# ---------------------------------------------------------------------------
# 2. fused production path
# ---------------------------------------------------------------------------


def fused_coded_value_and_grad(loss_fn: LossFn) -> Callable[[Params, Batch, torch.Tensor], tuple]:
    """Returns f(params, slot_batch, weights) -> (weighted_loss, grads).

    slot_batch leaves: (m, n_max, mb, ...); weights: (m, n_max) from
    :func:`slot_weights`.  One backward pass over Σ_{w,s} W[w,s]·L(slot)."""

    def weighted_loss(params: Params, batch: tuple[Batch, torch.Tensor]) -> torch.Tensor:
        slot_batch, weights = batch
        flat = {key: x.reshape((-1,) + tuple(x.shape[2:])) for key, x in slot_batch.items()}
        n = weights.numel()
        losses = torch.stack([loss_fn(params, {key: x[i] for key, x in flat.items()})
                              for i in range(n)])
        return (losses * weights.reshape(-1).to(losses.dtype)).sum()

    grad = _grad_fn(weighted_loss)

    def f(params: Params, slot_batch: Batch, weights: torch.Tensor):
        loss, grads = grad(params, (slot_batch, weights))
        return loss, dict(zip(params, grads))

    return f


# ---------------------------------------------------------------------------
# 3. the wire protocol, m workers emulated in one process
# ---------------------------------------------------------------------------


def faithful_spmd_step(
    loss_fn: LossFn,
    params: Params,
    slot_batch: Batch,
    coeff: torch.Tensor,
    a: torch.Tensor,
    err: torch.Tensor | None = None,
    view: FlatView | None = None,
    *,
    compress: bool = False,
    wire_kernel: bool = False,
    wire: dict | None = None,
    tracer: NullTracer | Tracer = NULL_TRACER,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Per-worker flat encode and the master decode, on one device.

    ``slot_batch`` leaves are (m, n_slots, mb, ...); ``coeff`` (m, n_slots)
    holds the effective B coefficients (slot mask and any partial-work
    support folded in); ``a`` (m,) is the decode vector already scaled by
    1/k.  Worker w takes the gradient of every slot in the parameters'
    dtype and ravels it into an f32 (n_slots, D) stack.  Every worker is
    encoded, a faulted one too: its zero decode coefficient drops it, and a
    NaN coefficient poisons the result, as in the JAX psum.

    Uncompressed: g̃_w = Σ_s coeff[w,s]·g_s is ONE ``coded_reduce`` launch
    and the decode Σ_w a_w·g̃_w one more over the (m, D) coded stack, so a
    step makes m+1 launches; ``err`` is passed through untouched.

    ``compress``: ``err`` is the (m, D) f32 per-worker error-feedback
    buffer, UPDATED IN PLACE.  With ``wire_kernel`` worker w is one
    ``coded_encode_int8`` launch (reduce, + err, int8 quantize, residual
    into ``err[w]``), its q stacked into an (m, D) int8 buffer, and the
    decode is one ``coded_decode_int8`` launch under ws = a·scale: m
    encode launches and 1 decode launch a step.  Without it the encode is
    ``coded_reduce``, then ``+ err``, ``quantize_int8``, ``dequantize`` and
    the residual in plain torch (the JAX package's unfused wire), and the
    decode one ``coded_reduce`` over the (m, D) dequantized stack.  A
    ``wire`` dict receives the int8 wire the decode read, ``q`` (m, D) and
    ``ws`` (m,), for inspection.

    With ``tracer`` on, each (worker, slot) gradient pass and its ravel is
    one host span ``phase.spmd.slot`` (``worker``, ``slot``), the host phase
    of the model's device regions launched in it.

    Returns ``(decoded f32 (D,), err)``."""
    view = view if view is not None else FlatView(params)
    traced = tracer.enabled
    m, n_slots = coeff.shape
    dev = coeff.device
    if compress and (err is None or tuple(err.shape) != (m, view.size)):
        raise ValueError(f"compress needs an ({m}, {view.size}) f32 err buffer")
    fused_wire = compress and wire_kernel
    grad = _grad_fn(loss_fn)
    gstack = torch.empty((n_slots, view.size), dtype=torch.float32, device=dev)
    if fused_wire:
        q_all = torch.empty((m, view.size), dtype=torch.int8, device=dev)
        scales = torch.empty((m,), dtype=torch.float32, device=dev)
    else:
        coded = torch.empty((m, view.size), dtype=torch.float32, device=dev)
    for w in range(m):
        for s in range(n_slots):
            if traced:
                t0 = tracer.clock()
                tracer.phase = "phase.spmd.slot"
            _, g = grad(params, {key: x[w, s] for key, x in slot_batch.items()})
            view.write(gstack[s], g)
            del g
            if traced:
                tracer.span_at("phase.spmd.slot", t0, tracer.clock(), clock="wall", worker=w,
                               slot=s)
        cw = coeff[w].contiguous()
        if fused_wire:
            _, scale, _ = coded_encode_int8(gstack, cw, err[w], out_err=err[w], out_q=q_all[w])
            scales[w] = scale
            continue
        coded_reduce(gstack, cw, torch.float32, out=coded[w])
        if compress:
            # the flat g̃_w is what travels: int8 quantize + error feedback
            # apply to it wholesale
            cwire = coded[w].add_(err[w])
            deq = dequantize(*quantize_int8(cwire))
            torch.sub(cwire, deq, out=err[w])
            cwire.copy_(deq)
            del deq
    del gstack
    if fused_wire:
        ws = a.float() * scales
        if wire is not None:
            wire.update(q=q_all, ws=ws)
        return coded_decode_int8(q_all, ws), err
    return coded_reduce(coded, a.float().contiguous(), torch.float32), err


# ---------------------------------------------------------------------------
# 4. the wire protocol across processes, one rank a worker
# ---------------------------------------------------------------------------


def group_spmd_step(
    loss_fn: LossFn,
    params: Params,
    slot_batch: Batch,
    coeff: torch.Tensor,
    a: torch.Tensor,
    err: torch.Tensor | None,
    view: FlatView,
    group: CodedGroup,
    *,
    compress: bool = False,
    wire_kernel: bool = False,
    wire: dict | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """This rank's worker encode and the collective decode: the JAX
    ``faithful_spmd_step``'s ``worker_fn`` on one rank of ``group``.

    ``slot_batch`` leaves are this worker's (n_slots, mb, ...) slots,
    ``coeff`` (n_slots,) its effective B coefficients and ``a`` (m,) the
    whole decode vector already scaled by 1/k (every rank holds it).  The
    worker ravels its slot gradients into an f32 (n_slots, D) stack, as the
    emulated path does, and then:

      - uncompressed: one ``coded_reduce`` launch, ``coded·a_w``, then one
        ``all_reduce`` (SUM) over the group — 1 launch a rank a step;
      - ``compress`` with ``wire_kernel``: one ``coded_encode_int8`` launch
        (the residual into ``err``, this worker's (D,) row, in place), an
        ``all_gather`` of the int8 payloads into an (m·D,) buffer and of
        scale·a_w into (m,), then one ``coded_decode_int8`` launch on
        every rank — 1 encode and 1 decode a rank a step;
      - ``compress`` without it: ``coded_reduce``, ``+ err``, the plain
        quantize and residual, then the ``all_reduce`` of deq·a_w.

    A NaN a_w poisons every rank's result, as the JAX psum does.  Every
    rank ends with the same bits: an ``all_reduce`` hands every rank one
    sum, and the int8 decode reads the same gathered wire everywhere.
    ``wire`` receives the gathered ``q`` (m, D) and ``ws`` (m,).

    Returns ``(decoded f32 (D,), err)``."""
    n_slots = int(coeff.shape[0])
    dev = coeff.device
    if compress and (err is None or tuple(err.shape) != (view.size,)):
        raise ValueError(f"compress needs a ({view.size},) f32 err row")
    grad = _grad_fn(loss_fn)
    gstack = torch.empty((n_slots, view.size), dtype=torch.float32, device=dev)
    for s in range(n_slots):
        _, g = grad(params, {key: x[s] for key, x in slot_batch.items()})
        view.write(gstack[s], g)
        del g
    cw = coeff.contiguous()
    a_w = a[group.rank].float()
    if compress and wire_kernel:
        q, scale, _ = coded_encode_int8(gstack, cw, err, out_err=err)
        del gstack
        q_all = all_gather_flat(q, group).view(group.m, view.size)
        del q
        ws = all_gather_flat(scale * a_w, group)
        if wire is not None:
            wire.update(q=q_all, ws=ws)
        return coded_decode_int8(q_all, ws), err
    coded = coded_reduce(gstack, cw, torch.float32)
    del gstack
    if compress:
        coded.add_(err)
        deq = dequantize(*quantize_int8(coded))
        torch.sub(coded, deq, out=err)
        coded.copy_(deq)
        del deq
    return all_reduce_sum_(coded.mul_(a_w), group), err
