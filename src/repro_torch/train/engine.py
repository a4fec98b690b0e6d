"""StepEngine: the coded training step behind one of three interchangeable
gradient backends (the port of ``src/repro/train/engine.py``).

  - ``fused``     — encode/decode folded into per-sequence loss weights;
                    one forward/backward over the (s+1)×-replicated coded
                    batch, packed on the device from the k·mb unique
                    sequences.
  - ``reference`` — the paper's protocol verbatim (O(m·n) backward
                    passes).  The oracle.
  - ``spmd``      — the wire protocol: per-worker flat encode and the
                    master decode through the ``coded_reduce`` CUDA kernel,
                    the m workers run in turn in this one process
                    (:func:`~repro_torch.core.aggregator.faithful_spmd_step`);
                    with ``compress`` the wire is int8 with per-worker error
                    feedback, through the fused ``coded_encode_int8`` kernel
                    and the int8 decode when ``wire_kernel`` is on.

All backends take the same inputs — a partition-major batch and a decode
vector or :class:`~repro_torch.core.decoding.DecodeOutcome` — and give the
same decoded gradient; an outcome's partial-work ``support`` mask zeroes
unfinished partitions in every backend.

Device residency: the plan tensors are uploaded once per plan *object* and
cached on the device; every path that changes plan values (rebalance,
membership change, checkpoint restore) builds a new plan object, so the
next step re-uploads.

Not ported yet: the multi-process spmd path and its mesh rebuild, the
wire state's checkpoint (``state_dict``), and the host-side pack baseline
(``host_pack``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.aggregator import (
    FlatView,
    faithful_spmd_step,
    pack_coded_batch,
    pack_flat_device,
    protocol_reference,
    remap_err_rows,
    slot_weights_device,
    support_slot_mask_device,
)
from repro_torch.core.codec import Codec
from repro_torch.core.decoding import DecodeOutcome
from repro_torch.kernels.autotune import wire_kernel_default
from repro_torch.optim.adam import AdamWState, adamw_init, adamw_update, global_norm
from repro_torch.optim.schedules import cosine_warmup

Params = dict[str, torch.Tensor]

BACKENDS = ("reference", "fused", "spmd")

__all__ = ["BACKENDS", "TrainerState", "StepEngine"]


@dataclasses.dataclass
class TrainerState:
    params: Params
    opt: AdamWState
    step: int


class StepEngine:
    """Coded train step over a model + codec, backend-selectable.

    ``model`` exposes ``init(generator, device) -> params`` and
    ``weighted_loss(params, batch) -> scalar`` where ``batch["weight"]``
    holds per-sequence loss weights.  Parameters are updated in place,
    and so is the spmd backend's compressed-wire error-feedback buffer
    (``_err``), where the JAX engine threads a new array through each step.
    """

    def __init__(
        self,
        model,
        train_cfg: TrainConfig,
        codec: Codec,
        *,
        backend: str = "fused",
        device: torch.device | str = "cuda",
        compress: bool = False,
        wire_kernel: bool | None = None,
    ):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")
        self.model = model
        self.tc = train_cfg
        self.codec = codec
        self.backend = backend
        self.device = torch.device(device)
        self.compress = compress
        # fused int8 wire kernel: None defers to the probe, on only where
        # the fused encode measured faster on this card (never on a CPU)
        if wire_kernel is None:
            wire_kernel = compress and wire_kernel_default(self.device)
        self.wire_kernel = bool(wire_kernel) and compress
        # device-resident plan cache, keyed by plan object IDENTITY
        self._plan_ref = None
        self._dev_pids: torch.Tensor | None = None  # (m, n_slots) int64
        self._dev_coeff: torch.Tensor | None = None  # (m, n_slots) f32
        self._dev_mask: torch.Tensor | None = None  # (m, n_slots) f32
        self._dev_coeff_mask: torch.Tensor | None = None  # slot_coeff*slot_mask
        self._ones_support: torch.Tensor | None = None  # (m, k) f32
        self._view: FlatView | None = None  # ravel layout, built on first spmd step
        # spmd wire state: the per-worker flat error feedback, (m, D) f32 when
        # compressed else (m, 1), keyed to the codec.version it belongs to,
        # and the composed row map of membership transitions since it was
        # last synced
        self._err: torch.Tensor | None = None
        self._err_version: int | None = None
        self._row_map: list[int | None] | None = None

    # -- state -------------------------------------------------------------

    def init_state(self, gen: torch.Generator) -> TrainerState:
        params = self.model.init(gen, self.device)
        return TrainerState(params=params, opt=adamw_init(params), step=0)

    # -- loss adapters ------------------------------------------------------

    def _slot_loss(self, params: Params, micro_batch: dict) -> torch.Tensor:
        """Unweighted mean loss over one partition micro-batch — the
        per-worker loss the protocol backends differentiate."""
        mb = next(iter(micro_batch.values())).shape[0]
        w = torch.full((mb,), 1.0 / mb, dtype=torch.float32, device=self.device)
        return self.model.weighted_loss(params, {**micro_batch, "weight": w})

    @staticmethod
    def _split_decode(a) -> tuple[np.ndarray, np.ndarray | None]:
        """Bare vector or DecodeOutcome -> (vector, support mask or None)."""
        if isinstance(a, DecodeOutcome):
            return a.a, a.support
        return a, None

    # -- device-resident plan views ------------------------------------------

    def _device_plan(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(slot_pids, slot_coeff, slot_mask) as cached device tensors,
        uploaded once per plan object."""
        plan = self.codec.plan
        if self._plan_ref is not plan:
            dev = self.device
            self._dev_pids = torch.as_tensor(plan.slot_pids, dtype=torch.long, device=dev)
            self._dev_coeff = torch.as_tensor(plan.slot_coeff, device=dev)
            self._dev_mask = torch.as_tensor(plan.slot_mask, device=dev)
            self._dev_coeff_mask = torch.as_tensor(plan.slot_coeff * plan.slot_mask, device=dev)
            self._plan_ref = plan
        return self._dev_pids, self._dev_coeff, self._dev_mask

    def _support_dev(self, support: np.ndarray | None) -> torch.Tensor:
        """(m, k) completion mask on the device; all-ones, cached by shape,
        when the step has no partial work."""
        if support is None:
            shape = (self.codec.m, self.codec.k)
            if self._ones_support is None or tuple(self._ones_support.shape) != shape:
                self._ones_support = torch.ones(shape, dtype=torch.float32, device=self.device)
            return self._ones_support
        return torch.as_tensor(np.asarray(support), dtype=torch.float32, device=self.device)

    def _to_device(self, partition_batch: dict) -> dict[str, torch.Tensor]:
        return {
            k: torch.as_tensor(v).to(self.device, non_blocking=True)
            for k, v in partition_batch.items()
        }

    def _device_batch(self, pbatch: dict, a, support) -> dict[str, torch.Tensor]:
        """On-device pack + slot weights: the flat coded batch."""
        pids, coeff, mask = self._device_plan()
        a_dev = torch.as_tensor(np.asarray(a), dtype=torch.float32, device=self.device)
        w = slot_weights_device(
            a_dev, self._support_dev(support), coeff, mask, pids, self.codec.k
        )
        return pack_flat_device(pbatch, pids, w)

    # -- step functions -----------------------------------------------------

    def _lr(self, step: int) -> np.float32:
        return cosine_warmup(
            step, base_lr=self.tc.lr, warmup_steps=self.tc.warmup_steps,
            total_steps=self.tc.total_steps,
        )

    def _adamw(self, params: Params, grads: Params, opt: AdamWState, step: int):
        """AdamW apply behind the non-finite payload guard: a corrupted
        coded sum (NaN/Inf anywhere in the decoded gradient — global_norm
        is finite iff every leaf is) must never touch params or optimizer
        moments, so a non-finite norm skips the in-place update and the
        caller sees the skip in the returned grad norm."""
        tc = self.tc
        lr = self._lr(step)
        gnorm = float(global_norm(grads))
        if np.isfinite(gnorm):
            params, opt = adamw_update(
                params, grads, opt,
                lr=lr, beta1=tc.beta1, beta2=tc.beta2, eps=tc.eps,
                weight_decay=tc.weight_decay, grad_clip=tc.grad_clip,
            )
        return params, opt, gnorm, float(lr)

    def _value_and_grad(self, params: Params, batch: dict) -> tuple[torch.Tensor, Params]:
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        with torch.enable_grad():
            loss = self.model.weighted_loss(leaves, batch)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(params, grads))

    def reset_error_feedback(self) -> None:
        """Zero the spmd backend's per-worker error-feedback residuals, in
        place.  Called after a non-finite decode (a corrupt payload pollutes
        the residual of every worker in that step) and harmless otherwise;
        membership changes reset through the codec-version key instead."""
        if self._err is not None:
            self._err.zero_()

    # -- elastic hooks --------------------------------------------------------

    def check_membership(self, m_new: int) -> None:
        """Feasibility gate for a membership transition.  The emulated spmd
        backend runs any m on one device, so nothing is vetoed."""

    def note_membership(self, old_of_new: Sequence[int | None]) -> None:
        """Record an applied membership transition's row identity map (the
        controller's ``on_transition`` hook).  Transitions between two steps
        compose into one map; the next spmd step consumes it to carry the
        retained workers' error-feedback rows.  The plan cache follows the
        codec's new plan object by itself."""
        if self.backend != "spmd":
            return
        oon = [None if o is None else int(o) for o in old_of_new]
        prev = self._row_map
        self._row_map = oon if prev is None else [None if o is None else prev[o] for o in oon]

    def _sync_err(self, width: int) -> None:
        """Bring the error-feedback buffer to the codec's current version:
        carry the retained workers' rows through the composed row map (joiners
        and departed rows zeroed); keep the whole buffer on a pure rebalance
        (no map, unchanged shape: every worker kept its identity, and the
        residual of gradients already applied does not depend on the
        coefficients); otherwise start from zeros."""
        m = self.codec.m
        if self._err is not None and self._row_map is not None and len(self._row_map) == m:
            self._err = remap_err_rows(self._err, self._row_map)
        elif not (
            self._err is not None and self._row_map is None
            and tuple(self._err.shape) == (m, width)
        ):
            self._err = torch.zeros((m, width), dtype=torch.float32, device=self.device)
        self._row_map = None
        self._err_version = self.codec.version

    # -- gradients (backend seam, used directly by the equivalence tests) ---

    def _spmd_gradients(self, params: Params, pbatch: dict, a, support) -> Params:
        plan = self.codec.plan
        pids, _, mask = self._device_plan()
        if support is None:
            coeff = self._dev_coeff_mask
        else:
            # unfinished partitions never left the worker: mask their slots
            # out of the coded gradient g̃_w
            coeff = self._dev_coeff_mask * support_slot_mask_device(
                self._support_dev(support), pids, mask
            )
        if self._view is None:
            self._view = FlatView(params)
        if self._err is None or self._err_version != self.codec.version:
            # first call, or a membership change / rebalance re-encoded the plan
            self._sync_err(self._view.size if self.compress else 1)
        a_dev = torch.as_tensor(np.asarray(a) / plan.k, dtype=torch.float32, device=self.device)
        sb = pack_coded_batch(pbatch, pids)
        flat, self._err = faithful_spmd_step(
            self._slot_loss, params, sb, coeff, a_dev, self._err, self._view,
            compress=self.compress, wire_kernel=self.wire_kernel,
        )
        return self._view.unravel(flat)

    def gradients(self, params: Params, partition_batch: dict, a) -> Params:
        """Decoded gradient under decode vector ``a`` (ndarray, or a
        :class:`DecodeOutcome` carrying an optional partial-work mask)."""
        a, support = self._split_decode(a)
        pbatch = self._to_device(partition_batch)
        if self.backend == "fused":
            return self._value_and_grad(params, self._device_batch(pbatch, a, support))[1]
        if self.backend == "reference":
            decoded, _ = protocol_reference(
                self._slot_loss, params, pbatch, self.codec.scheme,
                decode_vec=a, support=support,
            )
            return decoded
        return self._spmd_gradients(params, pbatch, a, support)

    # -- the train step -----------------------------------------------------

    def step(
        self, state: TrainerState, partition_batch: dict, a
    ) -> tuple[TrainerState, dict[str, float]]:
        """One optimizer step from a partition-major batch + decode vector
        (or DecodeOutcome).  ``loss`` is the weighted loss at the decoded
        slot weights, before the update."""
        a_vec, support = self._split_decode(a)
        pbatch = self._to_device(partition_batch)
        if self.backend == "fused":
            loss, grads = self._value_and_grad(
                state.params, self._device_batch(pbatch, a_vec, support)
            )
        else:
            grads = self.gradients(state.params, pbatch, a)
            with torch.no_grad():
                loss = self.model.weighted_loss(
                    state.params, self._device_batch(pbatch, a_vec, support)
                )
        loss = float(loss)
        params, opt, gnorm, lr = self._adamw(state.params, grads, state.opt, state.step)
        del grads
        new_state = TrainerState(params=params, opt=opt, step=state.step + 1)
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}
