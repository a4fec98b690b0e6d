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
   more ``coded_reduce`` launch over the (m, D) coded stack.  The JAX
   package runs the workers as a ``shard_map`` over m devices with a psum
   decode; here one process runs the m workers in turn on one device.

The numpy half (:class:`CodedPlan`, :func:`make_plan`, the host slot
weights) is a copy of the JAX module's; the ``*_device`` functions are its
in-jit twins as tensor gathers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.coding import CodingScheme
from repro_torch.core.decoding import Decoder
from repro_torch.kernels.coded_reduce import coded_reduce

__all__ = [
    "CodedPlan",
    "make_plan",
    "slot_weights",
    "slot_weights_device",
    "support_slot_mask",
    "support_slot_mask_device",
    "uniform_weights",
    "pack_coded_batch",
    "pack_flat_device",
    "protocol_reference",
    "fused_coded_value_and_grad",
    "faithful_spmd_step",
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
    """On-device :func:`slot_weights`: W[w,s] = a_w·B[w,pid]·done[w,pid]/k.
    Callers without partial work pass an all-ones ``support``."""
    done = support_slot_mask_device(support, slot_pids, slot_mask)
    return (a.float()[:, None] * slot_coeff * done / k).float()


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
    view: FlatView | None = None,
) -> torch.Tensor:
    """Per-worker flat encode and the master decode, on one device.

    ``slot_batch`` leaves are (m, n_slots, mb, ...); ``coeff`` (m, n_slots)
    holds the effective B coefficients (slot mask and any partial-work
    support folded in); ``a`` (m,) is the decode vector already scaled by
    1/k.  Worker w takes the gradient of every slot in the parameters'
    dtype, ravels it into an f32 (n_slots, D) stack and encodes
    g̃_w = Σ_s coeff[w,s]·g_s with ONE ``coded_reduce`` launch; the decode
    Σ_w a_w·g̃_w is one more launch over the (m, D) coded stack, so a step
    makes m+1 launches.  Every worker is encoded, a faulted one too: its
    zero decode coefficient drops it, and a NaN coefficient poisons the
    result, as in the JAX psum.  Returns the decoded f32 (D,) vector."""
    view = view if view is not None else FlatView(params)
    m, n_slots = coeff.shape
    dev = coeff.device
    grad = _grad_fn(loss_fn)
    gstack = torch.empty((n_slots, view.size), dtype=torch.float32, device=dev)
    coded = torch.empty((m, view.size), dtype=torch.float32, device=dev)
    for w in range(m):
        for s in range(n_slots):
            _, g = grad(params, {key: x[w, s] for key, x in slot_batch.items()})
            view.write(gstack[s], g)
            del g
        coded_reduce(gstack, coeff[w].contiguous(), torch.float32, out=coded[w])
    del gstack
    return coded_reduce(coded, a.float().contiguous(), torch.float32)

