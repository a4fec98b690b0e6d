"""StepEngine: the coded training step behind one of three interchangeable
gradient backends (the port of ``src/repro/train/engine.py``).

  - ``fused``     — encode/decode folded into per-sequence loss weights;
                    one forward/backward over the (s+1)×-replicated coded
                    batch, packed on the device from the k·mb unique
                    sequences (or, with ``host_pack``, packed on the host
                    in numpy and uploaded whole: the baseline the device
                    pack is held against).
  - ``reference`` — the paper's protocol verbatim (O(m·n) backward
                    passes).  The oracle.
  - ``spmd``      — the wire protocol: per-worker flat encode and the
                    master decode through the ``coded_reduce`` CUDA kernel;
                    with ``compress`` the wire is int8 with per-worker error
                    feedback, through the fused ``coded_encode_int8`` kernel
                    and the int8 decode when ``wire_kernel`` is on.  Without
                    a ``group`` the m workers run in turn in this one
                    process (:func:`~repro_torch.core.aggregator.faithful_spmd_step`);
                    with one, this process is one rank of a
                    ``torch.distributed`` group, one rank a coded worker,
                    and the decode is a collective
                    (:func:`~repro_torch.core.aggregator.group_spmd_step`).

All backends take the same inputs — a partition-major batch and a decode
vector or :class:`~repro_torch.core.decoding.DecodeOutcome` — and give the
same decoded gradient; an outcome's partial-work ``support`` mask zeroes
unfinished partitions in every backend.

Device residency: the plan tensors are uploaded once per plan *object* and
cached on the device; every path that changes plan values (rebalance,
membership change, checkpoint restore) builds a new plan object, so the
next step re-uploads.

Phase spans: with a tracer installed (``engine.tracer``, the trainer's),
each step's phases land on the wall-clock track, as in the JAX engine; the
spmd backend's ``phase.spmd.grads`` closes after a device synchronize, so
it holds the device time of the per-worker gradients, the encode and the
decode.  The engine also tells the tracer the step and the host phase open
while it launches the model (``tracer.step``, ``tracer.phase``), which the
model's device regions carry; the synchronize that closes a traced step
anchors those regions, and the next step places them on the wall clock
while the device works.  Tracing off adds nothing to the step.

The process-group path (``group=``).  Every rank of the world runs the
control plane in lockstep and calls :meth:`StepEngine.step` (or
:meth:`~StepEngine.gradients`) together: rank 0 broadcasts the decode
vector and the support mask, the members (ranks 0..m-1) encode and decode,
and rank 0 broadcasts the step's metrics, so a rank outside the group skips
the gradient and the update but stays in step.  Every member applies AdamW
to the same decoded bits, so the replicas stay bit-equal.  The elastic
rebuild (DESIGN.md §13, :meth:`StepEngine.rebuild`) runs on every rank of
the world at the top of the next gradient call after a ``Codec.version``
bump: the group is re-derived when m moved, each retained worker's
error-feedback row moves from its old rank to its new one, and a rank
that enters the group receives params and optimizer state from rank 0.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.checkpoint.placement import place_rows
from repro_torch.configs.base import TrainConfig
from repro_torch.core.aggregator import (
    FlatView,
    faithful_spmd_step,
    slot_weights,
    group_spmd_step,
    pack_coded_batch,
    pack_flat_device,
    protocol_reference,
    slot_weights_device,
    spread_copies_device,
    support_slot_mask_device,
)
from repro_torch.core.codec import Codec
from repro_torch.core.decoding import DecodeOutcome
from repro_torch.kernels.autotune import wire_kernel_default
from repro_torch.launch.mesh import (
    CodedGroup,
    all_gather_objects,
    broadcast_,
    broadcast_array,
    gather_to_first,
    mesh_devices_for_m,
    remesh_for_m,
    scatter_from_first,
    send_recv_rows,
)
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.optim.adam import AdamWState, adamw_init, adamw_update, global_norm
from repro_torch.optim.schedules import cosine_warmup

Params = dict[str, torch.Tensor]

BACKENDS = ("reference", "fused", "spmd")

__all__ = ["BACKENDS", "TrainerState", "StepEngine", "EngineRebuild"]


@dataclasses.dataclass(frozen=True)
class EngineRebuild:
    """Report of one elastic spmd rebuild (DESIGN.md §13): what was torn
    down, what was carried.  ``err_rows_carried`` counts retained workers
    whose error-feedback row survived the transition; on the process-group
    path each moved from its old rank to its new one."""

    version: int  # Codec.version the engine is now keyed to
    m_before: int
    m_after: int
    mesh_rebuilt: bool  # coded group re-derived because m moved
    program_rebuilt: bool  # (m, n_slots) moved
    err_rows_carried: int
    err_rows_zeroed: int
    ms: float  # host-side rebuild latency (row moves included, an audit not)


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

    ``group`` (spmd only) is the coded workers' process group at the
    codec's m (:func:`~repro_torch.launch.mesh.remesh_for_m`); the engine
    then runs on ``group.device`` and ``_err`` is this rank's own (D,) row
    (None outside the group).  ``audit_rows`` makes every group rebuild
    check, by a sha256 of each row gathered across the ranks, that each
    carried error-feedback row is bit-equal to the row its worker held
    before, and joiners' rows zero; the audits land in ``row_audits``.
    ``wire_out``, when a dict, receives the int8 wire each compressed
    fused-kernel decode read (``q``, ``ws``).  ``host_pack`` (fused only)
    packs the coded batch on the host (:meth:`_flat_batch`) and uploads it
    whole, in place of the device pack.
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
        group: CodedGroup | None = None,
        host_pack: bool = False,
    ):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")
        if group is not None and backend != "spmd":
            raise ValueError("a process group needs backend='spmd'")
        self.model = model
        self.tc = train_cfg
        self.codec = codec
        self.backend = backend
        self.group = group
        self.device = group.device if group is not None else torch.device(device)
        self.compress = compress
        self.host_pack = host_pack
        # fused int8 wire kernel: None defers to the probe, on only where
        # the fused encode measured faster on this card (never on a CPU)
        if wire_kernel is None:
            wire_kernel = compress and wire_kernel_default(self.device)
        self.wire_kernel = bool(wire_kernel) and compress
        # device-resident plan cache, keyed by plan object IDENTITY
        self._plan_ref = None
        self._dev_pids: torch.Tensor | None = None  # (m, n_slots) int64
        self._dev_coeff: torch.Tensor | None = None  # (m, n_slots) f64 B[w, pid]*mask
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
        # the worker set the spmd program was last built for, and whether a
        # rank entered the group since (its params and moments are stale)
        self._spmd_m = codec.m
        self._spmd_nslots = codec.n_slots
        self._state_stale = False
        self.last_rebuild: EngineRebuild | None = None
        self.audit_rows = False
        self.row_audits: list[dict] = []
        self._audit_s = 0.0
        self.wire_out: dict | None = None
        # the trainer installs its tracer; off, every site costs one check
        self.tracer = NULL_TRACER

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
        uploaded once per plan object; slot_coeff is B[w, pid] in f64 (0 on
        padding), for the fused pass's f64 slot weights."""
        plan = self.codec.plan
        if self._plan_ref is not plan:
            dev = self.device
            self._dev_pids = torch.as_tensor(plan.slot_pids, dtype=torch.long, device=dev)
            self._dev_mask = torch.as_tensor(plan.slot_mask, device=dev)
            self._dev_coeff_mask = torch.as_tensor(plan.slot_coeff * plan.slot_mask, device=dev)
            B = np.asarray(self.codec.scheme.B, np.float64)
            self._dev_coeff = torch.as_tensor(
                B[np.arange(plan.m)[:, None], plan.slot_pids] * plan.slot_mask, device=dev)
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

    def _flat_batch(
        self, partition_batch: dict, a: np.ndarray, support: np.ndarray | None = None,
    ) -> dict[str, np.ndarray]:
        """HOST-side pack: partition-major (k, mb, ...) -> the flat coded
        batch (m·n_slots·mb, ...) in slot-major order, with decode and
        encode folded into per-sequence weights, in numpy.  The
        ``host_pack=True`` baseline the device pack is held against."""
        plan = self.codec.plan
        idx = plan.slot_pids.reshape(-1)  # (m*n_slots,)
        out = {}
        mb = None
        for key, arr in partition_batch.items():
            arr = arr.cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
            mb = arr.shape[1]
            out[key] = arr[idx].reshape((-1,) + arr.shape[2:])
        w = slot_weights(plan, a, support)  # (m, n_slots), includes the 1/k
        out["weight"] = (np.repeat(w.reshape(-1), mb) / mb).astype(np.float32)
        return out

    def _host_batch(self, partition_batch: dict, a, support) -> dict[str, torch.Tensor]:
        """:meth:`_flat_batch` uploaded, one tensor a key."""
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in self._flat_batch(partition_batch, a, support).items()}

    def _device_batch(self, pbatch: dict, a, support) -> dict[str, torch.Tensor]:
        """On-device pack + slot weights: the flat coded batch, the weights
        made in f64 from the decode vector and B and each partition's total
        spread evenly over its weighted copies (:func:`spread_copies_device`:
        the same gradient, without an ill-conditioned decode's cancellation
        in a bf16 backward)."""
        pids, coeff, mask = self._device_plan()
        a_dev = torch.as_tensor(np.asarray(a), dtype=torch.float64, device=self.device)
        w = slot_weights_device(
            a_dev, self._support_dev(support), coeff, mask, pids, self.codec.k
        )
        return pack_flat_device(pbatch, pids, spread_copies_device(w, pids, mask, self.codec.k))

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
        caller sees the skip in the returned grad norm.  Traced on the
        device-pack fused path, it records the norm and its read
        (``phase.grad_norm``) and the update's launch (``phase.apply``)."""
        tc = self.tc
        tr = self.tracer
        phases = tr.enabled and self.backend == "fused" and not self.host_pack
        lr = self._lr(step)
        t0 = tr.clock() if phases else 0.0
        gnorm = float(global_norm(grads))
        if phases:
            t1 = tr.clock()
            tr.span_at("phase.grad_norm", t0, t1, clock="wall")
        if np.isfinite(gnorm):
            params, opt = adamw_update(
                params, grads, opt,
                lr=lr, beta1=tc.beta1, beta2=tc.beta2, eps=tc.eps,
                weight_decay=tc.weight_decay, grad_clip=tc.grad_clip,
            )
        if phases:
            tr.span_at("phase.apply", t1, tr.clock(), clock="wall")
        return params, opt, gnorm, float(lr)

    def _row_counts(self, pbatch: dict, a, support) -> dict[str, int]:
        """The fused pass's rows (m·n_slots·mb) and those with a nonzero
        weight, from the host plan and the decode vector: exact integers,
        with no read from the device."""
        mb = int(next(iter(pbatch.values())).shape[1])
        w = slot_weights(self.codec.plan, a, support)
        return {"rows": int(w.size) * mb, "weighted_rows": int(np.count_nonzero(w)) * mb}

    def _value_and_grad(self, params: Params, batch: dict,
                        phases: bool = False) -> tuple[torch.Tensor, Params]:
        """The weighted loss and its gradient; ``phases`` records the
        forward's and the backward's launch as ``phase.forward`` and
        ``phase.backward``."""
        tr = self.tracer
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        with torch.enable_grad():
            if phases:
                t0 = tr.clock()
                tr.phase = "phase.forward"
            loss = self.model.weighted_loss(leaves, batch)
            if phases:
                t1 = tr.clock()
                tr.span_at("phase.forward", t0, t1, clock="wall")
                tr.phase = "phase.backward"
            grads = torch.autograd.grad(loss, list(leaves.values()))
            if phases:
                tr.span_at("phase.backward", t1, tr.clock(), clock="wall")
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
        """Feasibility gate for a membership transition, called BEFORE any
        control-plane state mutates (the ElasticController's
        ``pre_transition`` hook).  On the process-group path the rebuild
        needs one rank a coded worker, so a grow past the world size is
        vetoed here and the codec, estimator and sim stay untouched.  The
        emulated spmd backend runs any m in one process and vetoes
        nothing."""
        if self.group is None:
            return
        needed = mesh_devices_for_m(int(m_new))
        avail = self.group.world_size
        if needed > avail:
            raise ValueError(
                f"spmd rebuild infeasible: m={m_new} needs {needed} devices "
                f"({needed // int(m_new)} per coded worker), only {avail} available"
            )

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
            self._err = place_rows(self._err, self._row_map)
            carried = sum(1 for o in self._row_map if o is not None)
        elif (
            self._err is not None and self._row_map is None
            and tuple(self._err.shape) == (m, width)
        ):
            carried = m
        else:
            self._err = torch.zeros((m, width), dtype=torch.float32, device=self.device)
            carried = 0
        self._row_map = None
        self._err_version = self.codec.version
        return carried

    def _sync_group_rows(self, width: int, m_before: int) -> int:
        """The process-group form of :meth:`_sync_err`, on every rank of the
        world: this rank's new (width,) row is its old one (the worker kept
        its rank), the row of the old worker that became it (received from
        that worker's old rank), or zeros (a joiner, or no carry).  A pure
        rebalance keeps every row.  Ranks outside the new group hold None."""
        g = self.group
        m, rank = self.codec.m, g.rank
        built = self._err_version is not None
        old = self._err
        row_map = self._row_map
        audit = self.audit_rows and built
        t_audit = time.perf_counter()
        before = self._row_digests(old) if audit else None
        self._audit_s = time.perf_counter() - t_audit
        new = None
        if built and row_map is not None and len(row_map) == m:
            sends = [(i, old) for i, o in enumerate(row_map) if o == rank and i != rank]
            recvs = []
            if rank < m:
                o = row_map[rank]
                if o is None:
                    new = torch.zeros(width, dtype=torch.float32, device=self.device)
                elif o == rank:
                    new = old
                else:
                    new = torch.empty(width, dtype=torch.float32, device=self.device)
                    recvs.append((o, new))
            send_recv_rows(sends, recvs, g)
            carried = sum(1 for o in row_map if o is not None)
        elif built and row_map is None and m == m_before:
            new, carried = old, m
            row_map = list(range(m))
        else:
            carried, row_map = 0, [None] * m
        if rank < m and new is None:
            new = torch.zeros(width, dtype=torch.float32, device=self.device)
        self._err = new
        if audit:
            t_audit = time.perf_counter()
            self._audit(before, self._row_digests(new), row_map, m_before)
            self._audit_s += time.perf_counter() - t_audit
        self._row_map = None
        self._err_version = self.codec.version
        return carried

    def _row_digests(self, row: torch.Tensor | None) -> list[str | None]:
        """Every world rank's sha256 of its error-feedback row's bytes."""
        digest = None
        if row is not None:
            digest = hashlib.sha256(row.detach().cpu().numpy().tobytes()).hexdigest()
        return all_gather_objects(digest, self.group)

    def _audit(self, before: list, after: list, row_map: list, m_before: int) -> None:
        """Hold every carried row bit-equal to its old worker's row and every
        other row to zeros; record the audit, raise on a mismatch."""
        width = self._view.size if self.compress else 1
        zero = hashlib.sha256(bytes(4 * width)).hexdigest()
        carried = [(i, o) for i, o in enumerate(row_map) if o is not None]
        bad = [i for i, o in carried if after[i] != before[o]]
        bad += [i for i, o in enumerate(row_map) if o is None and after[i] != zero]
        self.row_audits.append(dict(
            version=int(self.codec.version), m_before=int(m_before), m_after=len(row_map),
            carried=carried, zeroed=[i for i, o in enumerate(row_map) if o is None],
            moved=[(o, i) for i, o in carried if o != i], ok=not bad,
        ))
        if bad:
            raise RuntimeError(f"error-feedback rows of workers {bad} did not carry bit-equal "
                               f"across the rebuild to m={len(row_map)}")

    def rebuild(self) -> EngineRebuild | None:
        """Force the §13 elastic rebuild now if one is pending (normally it
        runs lazily on the next gradient call).  No-op on non-spmd backends
        and on an engine that has not stepped yet.  On the process-group
        path every rank of the world calls it together.  Returns the
        rebuild report, or None when nothing was pending."""
        if self.backend != "spmd" or self._view is None or not self._rebuild_pending():
            return None
        self._rebuild_spmd()
        return self.last_rebuild

    def _rebuild_pending(self) -> bool:
        if self._err_version != self.codec.version:
            return True
        return self.group is None and self._err is None

    def _rebuild_spmd(self) -> None:
        """The elastic rebuild, keyed by ``Codec.version``: re-derive the
        group at the new m (process-group path), carry the retained workers'
        error-feedback rows across the transition (joiners and leavers
        zeroed; a pure rebalance carries every row), and mark the state of
        ranks that entered the group for re-placing from rank 0 (done by
        :meth:`step`, which holds the state)."""
        t0 = time.perf_counter()
        self._audit_s = 0.0
        m = self.codec.m
        m_before = self._spmd_m
        width = self._view.size if self.compress else 1
        mesh_rebuilt = False
        if self.group is not None and self.group.m != m:
            self.group = remesh_for_m(self.group, m)
            mesh_rebuilt = True
        program_rebuilt = mesh_rebuilt or m != self._spmd_m or self.codec.n_slots != self._spmd_nslots
        if self.group is None:
            carried = self._sync_err(width)
        else:
            carried = self._sync_group_rows(width, m_before)
            if m > m_before:
                self._state_stale = True  # ranks m_before..m-1 hold stale state
        self._spmd_m, self._spmd_nslots = m, self.codec.n_slots
        if program_rebuilt and self.device.type == "cuda":
            # the slot stack changed shape: hand the old one's cached blocks
            # back, so ranks sharing a card can each take the new shape
            torch.cuda.empty_cache()
        self.last_rebuild = EngineRebuild(
            version=int(self.codec.version), m_before=int(m_before), m_after=int(m),
            mesh_rebuilt=mesh_rebuilt, program_rebuilt=program_rebuilt,
            err_rows_carried=int(carried), err_rows_zeroed=int(m - carried),
            ms=(time.perf_counter() - t0 - self._audit_s) * 1e3,
        )
        if self.tracer.enabled:
            self.tracer.instant("engine.rebuild", **dataclasses.asdict(self.last_rebuild))

    def state_dict(self) -> dict:
        """JSON-able wire-path state beyond (params, opt): the spmd
        backend's per-worker error-feedback rows keyed to their codec
        version.  Restoring it makes a mid-churn spmd resume bit-exact,
        compression residuals included; other backends return {}.  The
        rows are a JSON list, as in the JAX engine: m·D floats, so a
        compressed full-width engine's state is gigabytes of text.

        On the process-group path the members call it together: the (m, D)
        rows are gathered to rank 0, which returns them in the same layout;
        the other ranks return {}."""
        if self.backend != "spmd" or self._err_version is None:
            return {}
        if self.group is None:
            rows = self._err
        elif not self.group.member:
            return {}
        else:
            rows = gather_to_first(self._err, self.group)
            if rows is None:
                return {}
        return {
            "err": rows.cpu().numpy().astype(np.float32).tolist(),
            "err_version": int(self._err_version),
            "err_width": int(rows.shape[1]),
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore wire-path state.  The codec must already be restored
        (the trainer orders codec → elastic → engine); the rows land on the
        device through :func:`~repro_torch.checkpoint.placement.place_rows`,
        as a membership sync's do.  An empty dict resets to the lazy-build
        state (zeroed error feedback on the next step).

        On the process-group path every rank of the world calls it
        together: the group is re-derived at the restored m, and rank 0's
        ``state`` decides (the other ranks' is not read) — its rows are
        scattered, row w to member w."""
        if self.backend != "spmd":
            return
        self._row_map = None
        self._spmd_m, self._spmd_nslots = self.codec.m, self.codec.n_slots
        if self.group is not None:
            self._load_group_rows(state)
            return
        if not state:
            self._err = None
            self._err_version = None
            return
        self._err = place_rows(np.asarray(state["err"], np.float32), device=self.device)
        self._err_version = int(state["err_version"])

    def _load_group_rows(self, state: dict) -> None:
        if self.group.m != self.codec.m:
            self.group = remesh_for_m(self.group, self.codec.m)
        g = self.group
        head = [0.0, 0.0, 0.0]
        if g.rank == 0 and state:
            head = [1.0, float(state["err_version"]), float(np.shape(state["err"])[1])]
        has, version, width = broadcast_array(head, g)
        self._err = self._err_version = None
        if not has:
            return
        self._err_version = int(version)
        if not g.member:
            return
        self._err = torch.empty(int(width), dtype=torch.float32, device=self.device)
        rows = (place_rows(np.asarray(state["err"], np.float32), device=self.device)
                if g.rank == 0 else None)
        scatter_from_first(rows, self._err, g)

    def _sync(self) -> None:
        """Wait for the device, so a traced span closes on device time."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- gradients (backend seam, used directly by the equivalence tests) ---

    def _spmd_gradients(self, params: Params, pbatch: dict, a, support) -> Params:
        # per-phase spans: pack / the m workers' gradients, encode and
        # decode (tagged with the kernels that ran) / unravel
        tr = self.tracer
        traced = tr.enabled
        t0 = tr.clock() if traced else 0.0
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
        if self._rebuild_pending():
            # first call, or a membership change / rebalance re-encoded the plan
            self._rebuild_spmd()
        a_dev = torch.as_tensor(np.asarray(a) / plan.k, dtype=torch.float32, device=self.device)
        sb = pack_coded_batch(pbatch, pids)
        if traced:
            t1 = tr.clock()
            tr.span_at("phase.spmd.pack", t0, t1, clock="wall", where="host")
        flat, self._err = faithful_spmd_step(
            self._slot_loss, params, sb, coeff, a_dev, self._err, self._view,
            compress=self.compress, wire_kernel=self.wire_kernel, wire=self.wire_out, tracer=tr,
        )
        if traced:
            self._sync()
            t2 = tr.clock()
            kernels = (
                "coded_encode_int8+coded_decode_int8" if self.wire_kernel
                else "coded_reduce" + ("+quantize_int8" if self.compress else "")
            )
            tr.span_at("phase.spmd.grads", t1, t2, clock="wall", kernels=kernels)
        out = self._view.unravel(flat)
        if traced:
            tr.span_at("phase.spmd.unravel", t2, tr.clock(), clock="wall")
        return out

    def _group_prologue(self, params: Params) -> None:
        """What every rank of the world does first on the process-group path:
        the ravel layout, then the lazy elastic rebuild."""
        if self._view is None:
            self._view = FlatView(params)
        if self._rebuild_pending():
            self._rebuild_spmd()

    def _agree_decode(self, a, support) -> tuple[np.ndarray, np.ndarray | None]:
        """Rank 0's decode vector and support mask (m + m·k floats), on every
        rank of the world, so the ranks cannot drift apart."""
        m, k = self.codec.m, self.codec.k
        head = np.zeros(1 + m + m * k, np.float64)
        head[1:1 + m] = np.asarray(a, np.float64)
        if support is not None:
            head[0] = 1.0
            head[1 + m:] = np.asarray(support, np.float64).reshape(-1)
        got = broadcast_array(head, self.group)
        return got[1:1 + m], (got[1 + m:].reshape(m, k) if got[0] else None)

    def _group_gradients(self, params: Params, pbatch: dict, a, support) -> Params | None:
        """This rank's worker encode and the collective decode, with the
        emulated path's phase spans; None on a rank outside the group."""
        if not self.group.member:
            return None
        tr = self.tracer
        traced = tr.enabled
        t0 = tr.clock() if traced else 0.0
        w = self.group.rank
        pids, _, mask = self._device_plan()
        coeff = self._dev_coeff_mask[w]
        if support is not None:
            coeff = coeff * support_slot_mask_device(self._support_dev(support), pids, mask)[w]
        a_dev = torch.as_tensor(np.asarray(a) / self.codec.k, dtype=torch.float32,
                                device=self.device)
        sb = {key: x[0] for key, x in pack_coded_batch(pbatch, pids[w:w + 1]).items()}
        if traced:
            t1 = tr.clock()
            tr.span_at("phase.spmd.pack", t0, t1, clock="wall", where="host")
            tr.phase = "phase.spmd.grads"
        flat, self._err = group_spmd_step(
            self._slot_loss, params, sb, coeff, a_dev, self._err, self._view, self.group,
            compress=self.compress, wire_kernel=self.wire_kernel, wire=self.wire_out,
        )
        if traced:
            self._sync()
            t2 = tr.clock()
            kernels = (
                "coded_encode_int8+all_gather(i8)+coded_decode_int8" if self.wire_kernel
                else "coded_reduce+all_reduce(f32)" + ("+quantize_int8" if self.compress else "")
            )
            tr.span_at("phase.spmd.grads", t1, t2, clock="wall", kernels=kernels)
        out = self._view.unravel(flat)
        if traced:
            tr.span_at("phase.spmd.unravel", t2, tr.clock(), clock="wall")
        return out

    def _replace_state(self, state: TrainerState) -> None:
        """Rank 0's params and optimizer state, in place, on every rank of
        the world: the ranks that entered the group held stale ones (the
        counterpart of the JAX engine's ``_replicate_on_mesh``)."""
        opt = state.opt
        for tree in (state.params, opt.mu, opt.nu, opt.master or {}):
            for t in tree.values():
                broadcast_(t)
        opt.step = int(broadcast_array([opt.step], self.group)[0])

    def gradients(self, params: Params, partition_batch: dict, a) -> Params | None:
        """Decoded gradient under decode vector ``a`` (ndarray, or a
        :class:`DecodeOutcome` carrying an optional partial-work mask).  On
        the process-group path every rank of the world calls it together,
        rank 0's ``a`` is used, and a rank outside the group gets None."""
        a, support = self._split_decode(a)
        if self.backend == "fused" and self.host_pack:
            return self._value_and_grad(params, self._host_batch(partition_batch, a, support))[1]
        pbatch = self._to_device(partition_batch)
        if self.group is not None:
            # every rank of the world; None outside the group
            self._group_prologue(params)
            return self._group_gradients(params, pbatch, *self._agree_decode(a, support))
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
        slot weights, before the update.

        Phase spans, with tracing on: on the fused backend ``phase.upload``
        (with the pass's ``rows`` and ``weighted_rows``) and ``phase.fused``
        (forward, backward and apply), which holds ``phase.forward`` and
        ``phase.backward`` (their launch), ``phase.loss_sync`` (the host
        placing the last step's device regions, then waiting for the loss),
        ``phase.grad_norm``, ``phase.apply`` (the AdamW launch) and
        ``phase.sync``; with ``host_pack``
        ``phase.pack+upload`` (on the host) and ``phase.fused``; the
        gradients (``phase.pack+encode+wire+decode`` on spmd,
        ``phase.gradients`` on reference), ``phase.loss`` and
        ``phase.apply`` on the others.  The last span of a step closes after
        a device synchronize."""
        tr = self.tracer
        traced = tr.enabled
        t0 = tr.clock() if traced else 0.0
        if traced:
            tr.step = int(state.step)
        a_vec, support = self._split_decode(a)
        host_pack = self.backend == "fused" and self.host_pack
        fused = self.backend == "fused" and not host_pack
        pbatch = None if host_pack else self._to_device(partition_batch)
        if self.group is not None:
            return self._group_step(state, pbatch, a_vec, support)
        if host_pack:
            batch = self._host_batch(partition_batch, a_vec, support)
            if traced:
                t1 = tr.clock()
                tr.span_at("phase.pack+upload", t0, t1, clock="wall", where="host")
                tr.phase = "phase.fused"
            loss, grads = self._value_and_grad(state.params, batch)
            del batch
        elif fused:
            batch = self._device_batch(pbatch, a_vec, support)
            if traced:
                t1 = tr.clock()
                tr.span_at("phase.upload", t0, t1, clock="wall",
                           what="unique batch + decode vector + support mask",
                           **self._row_counts(pbatch, a_vec, support))
            loss, grads = self._value_and_grad(state.params, batch, phases=traced)
            del batch
        else:
            if traced:
                tr.phase = "phase.gradients"
            grads = self.gradients(state.params, pbatch, a)
            if traced:
                t1 = tr.clock()
                name = ("phase.pack+encode+wire+decode" if self.backend == "spmd"
                        else "phase.gradients")
                tr.span_at(name, t0, t1, clock="wall", backend=self.backend)
                tr.phase = "phase.loss"
            with torch.no_grad():
                loss = self.model.weighted_loss(
                    state.params, self._device_batch(pbatch, a_vec, support)
                )
        if traced:
            tl = tr.clock()
            tr.place_regions()  # the last step's, while the device works
        loss = float(loss)
        if traced and fused:
            tr.span_at("phase.loss_sync", tl, tr.clock(), clock="wall")
        elif traced and self.backend != "fused":
            t2 = tr.clock()
            tr.span_at("phase.loss", t1, t2, clock="wall")
        params, opt, gnorm, lr = self._adamw(state.params, grads, state.opt, state.step)
        del grads
        if traced:
            ts = tr.clock()
            t_end = tr.sync_device(self.device)
            if host_pack:
                tr.span_at("phase.fused", t1, t_end, clock="wall",
                           phases="fwd+bwd+decode+apply")
            elif fused:
                tr.span_at("phase.sync", ts, t_end, clock="wall")
                tr.span_at("phase.fused", t1, t_end, clock="wall", phases="fwd+bwd+apply")
            else:
                tr.span_at("phase.apply", t2, t_end, clock="wall")
        new_state = TrainerState(params=params, opt=opt, step=state.step + 1)
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    def _group_step(
        self, state: TrainerState, pbatch: dict, a_vec, support
    ) -> tuple[TrainerState, dict[str, float]]:
        """:meth:`step` on the process-group path, on every rank of the
        world: the rebuild and any re-place of entering ranks' state, the
        decode agreed from rank 0, the members' gradient and AdamW apply on
        the same decoded bits, and rank 0's loss, grad norm and lr on every
        rank.  A rank outside the group only keeps step."""
        tr = self.tracer
        traced = tr.enabled
        t0 = tr.clock() if traced else 0.0
        if traced:
            tr.step = int(state.step)
        self._group_prologue(state.params)
        if self._state_stale:
            self._replace_state(state)
            self._state_stale = False
        a_vec, support = self._agree_decode(a_vec, support)
        params, opt = state.params, state.opt
        metrics = np.full(3, np.nan)
        if self.group.member:
            grads = self._group_gradients(params, pbatch, a_vec, support)
            if traced:
                t1 = tr.clock()
                tr.span_at("phase.pack+encode+wire+decode", t0, t1, clock="wall",
                           backend=self.backend)
            loss = np.nan
            if traced:
                tr.phase = "phase.loss"
            if self.group.rank == 0:  # the others take rank 0's
                with torch.no_grad():
                    loss = float(self.model.weighted_loss(
                        params, self._device_batch(pbatch, a_vec, support)))
            if traced:
                t2 = tr.clock()
                tr.span_at("phase.loss", t1, t2, clock="wall")
            params, opt, gnorm, lr = self._adamw(params, grads, opt, state.step)
            del grads
            if traced:
                tr.span_at("phase.apply", t2, tr.sync_device(self.device), clock="wall")
            metrics[:] = (loss, gnorm, lr)
        loss, gnorm, lr = (float(x) for x in broadcast_array(metrics, self.group))
        new_state = TrainerState(params=params, opt=opt, step=state.step + 1)
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}
