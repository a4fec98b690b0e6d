"""Slot-allocated decode batch: the continuous-batching substrate
(DESIGN.md §9; the port of ``src/repro/serve/batching.py``).

A :class:`SlotBatch` owns one device-resident decode cache with ``n_slots``
independent rows (KV cache / SSM state / conv inputs per layer — shapes
from :meth:`LM.empty_slot_cache`) and a per-slot ``pos`` vector.  Requests
are *inserted* into a free slot mid-flight (their single-request prefill
cache is copied into the slot row) and *evicted* when they finish; the
batched decode step's shapes stay ``(n_slots, cache_len)`` throughout.
The cache is updated in place.

Slot independence is the correctness contract: every per-row computation
in decode (embedding, attention over a masked cache, SSM state update) is
independent across the batch dimension, so an occupied slot's tokens equal
what a ``B=1`` sequential decode of the same request produces, whatever the
other slots hold (tested in tests/test_torch_serving.py).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.lm import LM, Params

__all__ = ["SlotBatch"]


class SlotBatch:
    """Fixed-capacity decode batch with mid-flight insert/evict.

    Args:
      model: decode-capable LM.
      params: model parameters (the cache goes on their device).
      n_slots: batch capacity — the decode batch size every step.
      cache_len: per-slot cache length; full-attention requests must fit
        ``prompt + new tokens`` inside it (admission enforces this).
    """

    def __init__(self, model: LM, params: Params, n_slots: int, cache_len: int):
        self.model = model
        self.n_slots = int(n_slots)
        self.cache_len = int(cache_len)
        self.cache = model.empty_slot_cache(params, n_slots, cache_len)
        dev = params["embed"].device
        self.next_tok = torch.zeros((n_slots, 1), dtype=torch.int32, device=dev)
        self.occupied = np.zeros(n_slots, dtype=bool)
        self._insert = model.cache_insert_slot
        self._evict = model.cache_evict_slot
        self._step = model.decode_step

    # -- slot management ---------------------------------------------------

    def free_slot(self) -> int | None:
        free = np.flatnonzero(~self.occupied)
        return int(free[0]) if free.size else None

    @property
    def n_active(self) -> int:
        return int(self.occupied.sum())

    def insert(self, slot: int, req_cache: dict, prefill_logits: torch.Tensor) -> int:
        """Copy a single-request prefill cache (batch dim 1) into ``slot``
        and stage its first decode token (the prefill argmax).  Returns that
        first token (host int) — it is *emitted* by the next :meth:`step`,
        matching ``LMServer.generate`` ordering."""
        if self.occupied[slot]:
            raise ValueError(f"slot {slot} is occupied")
        self.cache = self._insert(self.cache, req_cache, slot)
        tok0 = torch.argmax(prefill_logits[0], dim=-1).to(torch.int32)
        self.next_tok[slot, 0] = tok0
        self.occupied[slot] = True
        return int(tok0)

    def evict(self, slot: int) -> None:
        """Free a slot (finished/cancelled request): zero its cache row so
        stale state never leaks into later occupants."""
        self.cache = self._evict(self.cache, slot)
        self.next_tok[slot, 0] = 0
        self.occupied[slot] = False

    # -- decode ------------------------------------------------------------

    def step(self, params: Params) -> np.ndarray:
        """One batched decode step over ALL slots.  Returns the (n_slots,)
        tokens emitted this step — only occupied slots' entries are
        meaningful (free slots decode zeros into a zero cache; their
        outputs are ignored and their rows overwritten at insert).

        The host sync on the emitted vector is deliberate: admission and
        termination decisions (EOS, per-request budgets) are host-side
        control flow, and one (n_slots,) int32 transfer per step is their
        price."""
        emit = self.next_tok[:, 0].cpu().numpy()
        logits, self.cache = self._step(params, self.next_tok, self.cache)
        self.next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return emit
