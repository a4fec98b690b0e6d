"""Codec: one gradient code + its device-feedable slot plan (DESIGN.md §2).

The codec is the shape-stability boundary of the runtime: it fixes a slot
capacity ``n_slots`` ONCE (from the scheme's *effective* k — structural
schemes force k = m, so capacity is derived only after the scheme settles
k), and every elastic re-encode afterwards only rewrites the *values* of
the plan tensors.  Downstream jitted step functions therefore never
recompile across rebalances.

Rebalance-capable schemes get drift headroom on top of the worst-case
allocation share; structural baselines (cyclic/naive/FRS) get an exact-fit
plan — their allocation ignores throughput estimates, so padding them
(as the old monolithic trainer did, sizing slots from the *requested* k
before the structural override) only wasted compute on zero-weight slots.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Iterable, Sequence

import numpy as np
import torch

from repro_torch.core.aggregator import CodedPlan, make_plan, pack_coded_batch, slot_weights
from repro_torch.core.coding import CodingScheme
from repro_torch.core.decoding import DecodeOutcome
from repro_torch.core.registry import (
    GradientCode,
    MembershipStats,
    get_scheme,
    plan_slot_capacity,
    scheme_class,
)

if TYPE_CHECKING:  # avoid a hard configs dependency at import time
    from repro_torch.configs.base import CodingConfig

__all__ = ["Codec"]


class Codec:
    """Scheme + plan + decode, shape-stable across elastic re-encodes."""

    def __init__(self, code: GradientCode, n_slots: int | None = None):
        self.code = code
        # the cap the CALLER imposed at construction (None = unconstrained):
        # membership transitions re-derive slot capacity per worker set, but
        # must never exceed this (``from_config`` clears it — its max_load
        # is codec-derived, not a user bound)
        self.user_max_load: int | None = (
            None if code.max_load is None else int(code.max_load)
        )
        n_max = max(1, max(code.allocation.counts))
        if n_slots is None:
            # rebalanceable codes keep headroom for allocation drift;
            # structural ones never re-allocate, so exact fit is safe.
            # Stochastic supports (bernoulli) can overshoot the planned
            # share, so the realized max always fits.
            n_slots = (
                max(plan_slot_capacity(code.k, code.s, code.m, code.c), n_max)
                if code.supports_rebalance
                else n_max
            )
        if n_slots < n_max:
            raise ValueError(f"n_slots={n_slots} < allocation max {n_max}")
        self.n_slots = int(n_slots)
        # cap future re-allocations at the fixed capacity, whatever path
        # constructed the code — otherwise a skewed rebalance() could grow
        # a worker past n_slots and break the shape-stability contract
        if code.supports_rebalance and (code.max_load is None or code.max_load > self.n_slots):
            code.max_load = self.n_slots
        self.plan: CodedPlan = make_plan(code.scheme, self.n_slots)
        # monotone plan-identity counter: bumps exactly when plan VALUES may
        # have changed, so device-resident copies of the plan tensors
        # (StepEngine's pack indices / coefficient caches) can be invalidated
        # without comparing arrays
        self.version: int = 0

    @classmethod
    def from_config(
        cls,
        coding: "CodingConfig",
        *,
        m: int,
        c_init: Sequence[float] | None = None,
        rng: np.random.Generator | int | None = 0,
    ) -> "Codec":
        """Build code + plan from a :class:`CodingConfig`.

        Slot capacity is planned from the scheme's EFFECTIVE k (known from
        the class's ``structural_k`` declaration before construction) and
        passed as ``max_load`` so even the first allocation fits the plan.
        """
        kcls = scheme_class(coding.scheme)
        k_req = m * coding.partitions_per_worker
        k_eff = kcls.effective_k(m, k_req)
        cap = None
        if kcls.supports_rebalance:
            c = np.asarray(c_init, np.float64) if c_init is not None else None
            cap = plan_slot_capacity(k_eff, coding.s, m, c)
        code = get_scheme(coding.scheme, m=m, k=k_req, s=coding.s, c=c_init, rng=rng, max_load=cap)
        codec = cls(code, n_slots=cap)
        codec.user_max_load = None  # cap above is capacity-derived, not a user bound
        return codec

    # -- views -------------------------------------------------------------

    @property
    def m(self) -> int:
        return self.code.m

    @property
    def k(self) -> int:
        return self.code.k

    @property
    def s(self) -> int:
        return self.code.s

    @property
    def scheme(self) -> CodingScheme:
        return self.code.scheme

    # -- decode + device views ---------------------------------------------

    def decode_vector(self, available: Iterable[int]) -> np.ndarray:
        return self.code.decode_vector(available)

    def decode_outcome(self, available: Iterable[int]) -> DecodeOutcome:
        """Exact-or-best-effort decode of an available set (never raises)."""
        return self.code.decode_outcome(available)

    def decode_partial(
        self, support: np.ndarray, available: Iterable[int] | None = None
    ) -> DecodeOutcome:
        """Best-effort decode from an (m, k) partial-work completion mask."""
        return self.code.decode_partial(support, available)

    def slot_weights(self, decode: np.ndarray | DecodeOutcome) -> np.ndarray:
        """(m, n_slots) fused-path weights a_w·B[w,pid]/k (0 on padding).

        Accepts a bare decode vector or a :class:`DecodeOutcome`; the
        outcome's partial-work ``support`` mask (if any) zeroes the slots of
        unfinished partitions, so residual propagates into slot weights
        exactly as DESIGN.md §5 specifies.
        """
        if isinstance(decode, DecodeOutcome):
            return slot_weights(self.plan, decode.a, support=decode.support)
        return slot_weights(self.plan, decode)

    def pack(self, partition_batch):
        """Partition-major (k, mb, ...) -> slot-major (m, n_slots, mb, ...)."""
        dev = next(iter(partition_batch.values())).device
        pids = torch.as_tensor(self.plan.slot_pids, dtype=torch.long, device=dev)
        return pack_coded_batch(partition_batch, pids)

    # -- checkpoint state ---------------------------------------------------

    def state_dict(self) -> dict:
        """JSON-able plan identity: the code's explicit scheme state, the
        slot capacity (membership transitions re-derive it), and the
        monotone plan version — the device-cache invalidation counter."""
        return {
            "code": self.code.state_dict(),
            "version": self.version,
            "n_slots": self.n_slots,
            "user_max_load": self.user_max_load,
        }

    def load_state_dict(self, state: dict) -> None:
        shape_before = self.plan.slot_pids.shape
        epoch_before = self.code.membership_epoch
        self.code.load_state_dict(state["code"])
        self.n_slots = int(state.get("n_slots", self.n_slots))
        if "user_max_load" in state:
            uml = state["user_max_load"]
            self.user_max_load = None if uml is None else int(uml)
        self.plan = make_plan(self.code.scheme, self.n_slots)
        # shape stability holds UNLESS a membership transition sits on
        # either side of the restore (forward resume past one, or rollback
        # from beyond one) — then the restore IS the one allowed shape
        # change (same recompile the live transition paid; DESIGN.md §8)
        if epoch_before == 0 and self.code.membership_epoch == 0:
            assert self.plan.slot_pids.shape == shape_before  # contract, §4
        self.version = int(state["version"])

    # -- elastic -----------------------------------------------------------

    def remap_members(
        self, c: Sequence[float], old_of_new: Sequence[int | None]
    ) -> MembershipStats:
        """In-place membership change (DESIGN.md §8): resize the code to
        ``len(old_of_new)`` workers, re-derive the slot capacity for the new
        worker set, rebuild the plan, and bump ``version`` EXACTLY once so
        every device-resident copy (engine plan tensors, decode/outcome
        LRUs died with the old B already) invalidates in one step.

        Unlike :meth:`rebalance`, shapes DO change — (m, n_slots) tracks the
        new m — so downstream jits retrace once; that recompile is inherent
        to changing the worker set and is the entire cost the
        checkpoint-restart path used to pay on every transition.
        """
        code = self.code
        m_new = len(old_of_new)
        cap = None
        prev_max_load = code.max_load
        if code.supports_rebalance:
            k_eff = type(code).effective_k(m_new, code.requested_k)
            c_arr = np.asarray(c, dtype=np.float64)
            cap = plan_slot_capacity(k_eff, code.s, m_new, c_arr)
            # the caller-imposed skew cap survives every transition; if the
            # new worker set cannot fit k(s+1) copies under it, the
            # allocation raises a clear feasibility error rather than
            # silently discarding the caller's bound
            if self.user_max_load is not None:
                cap = min(cap, self.user_max_load)
            code.max_load = cap
        try:
            stats = code.resize(c, old_of_new)
        except Exception:
            # infeasible transition: the code is unchanged — max_load must
            # not stay clobbered for the still-live worker set
            code.max_load = prev_max_load
            raise
        n_max = max(1, max(code.allocation.counts))
        self.n_slots = max(cap, n_max) if cap is not None else n_max
        if code.supports_rebalance and (code.max_load is None or code.max_load > self.n_slots):
            code.max_load = self.n_slots
        self.plan = make_plan(code.scheme, self.n_slots)
        self.version += 1
        return stats

    def rebalance(self, c: Sequence[float]) -> None:
        """Re-encode from fresh throughput estimates; plan VALUES change,
        shapes never do (fixed ``n_slots``) — no recompilation downstream."""
        shape_before = self.plan.slot_pids.shape
        self.code.rebalance(c)
        self.plan = make_plan(self.code.scheme, self.n_slots)
        assert self.plan.slot_pids.shape == shape_before  # contract, DESIGN.md §4
        self.version += 1  # invalidate device-resident plan copies (DESIGN.md §6)
