"""Continuous-batching serving engine with SLO-driven coded prefill
(DESIGN.md §9; the port of ``src/repro/serve/engine.py``).

``ServingEngine`` drives the full request lifecycle on one virtual clock:

  arrival → admission (queue, capacity + cache-fit checks) → coded prefill
  across the replica pool (the SLO policy picks the first decodable replica
  subset; wait-for-all is the recorded counterfactual) → the request joins
  the RUNNING decode batch in a free slot → per-token emission until EOS or
  its budget → eviction, freeing the slot for the next queued request.

Clock model: token *values* are computed for real (the local prefill and
decode, on the parameters' device — replica 0 stands in for the decoded
prefill result); token
*timestamps* come from the virtual clock, which advances by ``decode_dt``
per batched decode step (measured wall time unless pinned) and jumps across
idle gaps to the next arrival.  Prefill latency is the simulated coded
outcome from :class:`~repro_torch.serve.replicas.ReplicaPool` — a request cannot
emit before its prefill's first-decodable instant plus one decode step.
Decoupling values from clocks keeps outputs deterministic (bit-equal to
sequential decode) while the latency distribution carries the
heterogeneity/straggler story — the same split the training simulator uses.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Any

import numpy as np
import torch

from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.serve.batching import SlotBatch
from repro_torch.serve.metrics import RequestRecord, ServingMetrics
from repro_torch.serve.replicas import PrefillOutcome, ReplicaPool
from repro_torch.train.serve import LMServer

PyTree = Any

__all__ = ["Request", "Completion", "ServingEngine"]


@dataclasses.dataclass
class Request:
    """One inference request.

    Attributes:
      rid: caller-chosen id (echoed on the completion).
      tokens: (S,) int32 prompt.
      max_new_tokens: decode budget (truncated to fit the slot cache for
        full-attention models).
      arrival_t: arrival instant on the engine's virtual clock.
      eos_id: stop token (None: decode the full budget).
    """

    rid: int
    tokens: np.ndarray
    max_new_tokens: int
    arrival_t: float = 0.0
    eos_id: int | None = None


@dataclasses.dataclass
class Completion:
    """A finished request: emitted tokens (EOS included when hit) + the
    lifecycle record that went into the metrics."""

    rid: int
    tokens: np.ndarray
    record: RequestRecord


@dataclasses.dataclass
class _Active:
    req: Request
    slot: int
    limit: int
    admit_t: float
    prefill: PrefillOutcome
    prefill_done_t: float
    emitted: list[int] = dataclasses.field(default_factory=list)
    first_token_t: float = np.nan
    done_t: float = np.nan


class ServingEngine:
    """Request queue + admission control + continuous decode batch.

    Args:
      server: the single-replica compute backend (prefill/decode).
      params: model parameters; the engine serves on their device.
      n_slots: decode batch capacity (concurrent requests).
      cache_len: per-slot cache length — admission truncates a request's
        decode budget so ``prompt + new`` fits (full-attention models).
      replicas: coded-prefill latency pool; None = zero-latency prefill
        (pure continuous-batching mode, used by the bit-equality tests).
      max_queue: waiting-request cap; arrivals beyond it are rejected and
        counted in the metrics.
      decode_dt: virtual seconds per batched decode step; None = measured
        wall time of each step (benchmarks pin it for determinism).
      trace: optional flight recorder (DESIGN.md §10).  Each finished
        request lands as nested sim-clock spans on its own track
        (tid = rid): ``request`` ⊇ ``request.queue`` / ``request.prefill``
        / ``request.decode``, plus ``request.first_token`` /
        ``prefill.inexact`` instants — endpoints taken verbatim from the
        :class:`RequestRecord`, so the trace IS the metrics timeline.
    """

    def __init__(
        self,
        server: LMServer,
        params: PyTree,
        *,
        n_slots: int = 4,
        cache_len: int = 128,
        replicas: ReplicaPool | None = None,
        max_queue: int = 256,
        decode_dt: float | None = None,
        trace: Tracer | None = None,
    ):
        self.server = server
        self.params = params
        self.batch = SlotBatch(server.model, params, n_slots, cache_len)
        self.replicas = replicas
        self.max_queue = int(max_queue)
        self.decode_dt = decode_dt
        self.metrics = ServingMetrics()
        self.tracer = trace if trace is not None else NULL_TRACER
        self.now = 0.0
        self._queue: list[tuple[float, int, Request]] = []  # arrival-ordered heap
        self._seq = 0
        self._active: dict[int, _Active] = {}
        self.completions: list[Completion] = []

    # -- admission ---------------------------------------------------------

    def submit(self, req: Request) -> bool:
        """Enqueue a request; False = rejected (queue full or prompt cannot
        fit the slot cache at all)."""
        if len(self._queue) >= self.max_queue:
            self.metrics.reject()
            if self.tracer.enabled:
                self.tracer.instant(
                    "request.reject", t=float(req.arrival_t), clock="sim",
                    tid=int(req.rid), rid=int(req.rid), reason="queue_full",
                )
            return False
        if len(req.tokens) > self.batch.cache_len:
            self.metrics.reject()
            if self.tracer.enabled:
                self.tracer.instant(
                    "request.reject", t=float(req.arrival_t), clock="sim",
                    tid=int(req.rid), rid=int(req.rid), reason="prompt_too_long",
                )
            return False
        heapq.heappush(self._queue, (float(req.arrival_t), self._seq, req))
        self._seq += 1
        return True

    def _admit_one(self, req: Request) -> None:
        slot = self.batch.free_slot()
        assert slot is not None
        S = len(req.tokens)
        # cache-fit admission rule: the slot must hold prompt + new tokens
        # for full-attention models (SWA rings / SSM state never overrun)
        _, limit = self.server.resolve_lengths(S, req.max_new_tokens, self.batch.cache_len)
        tokens = torch.as_tensor(np.asarray(req.tokens, np.int32)[None, :],
                                 device=self.params["embed"].device)
        logits, cache = self.server._prefill(
            self.params, {"tokens": tokens}, cache_len=self.batch.cache_len
        )
        if self.replicas is not None:
            outcome = self.replicas.prefill(S)
        else:
            outcome = PrefillOutcome(0.0, 0.0, 1, True, 0.0)
        admit_t = max(self.now, float(req.arrival_t))
        self.batch.insert(slot, cache, logits)
        self._active[slot] = _Active(
            req=req, slot=slot, limit=limit, admit_t=admit_t,
            prefill=outcome, prefill_done_t=admit_t + outcome.t_first,
        )

    def _admit(self) -> None:
        while self._queue and self.batch.free_slot() is not None:
            arrival, _, req = self._queue[0]
            if arrival > self.now:
                if self._active:
                    break  # batch is busy; future arrivals wait for their clock
                self.now = arrival  # idle engine: jump to the next arrival
            heapq.heappop(self._queue)
            self._admit_one(req)

    # -- decode loop -------------------------------------------------------

    def _finish(self, act: _Active) -> None:
        self.batch.evict(act.slot)
        del self._active[act.slot]
        rec = RequestRecord(
            rid=act.req.rid,
            arrival_t=float(act.req.arrival_t),
            admit_t=act.admit_t,
            prefill_done_t=act.prefill_done_t,
            first_token_t=act.first_token_t,
            done_t=act.done_t,
            n_tokens=len(act.emitted),
            prefill_exact=act.prefill.exact,
            replicas_used=act.prefill.n_used,
            prefill_all_done_t=act.admit_t + act.prefill.t_all,
        )
        self.metrics.observe(rec)
        tr = self.tracer
        if tr.enabled:
            # the request's sim-clock lifecycle, endpoints verbatim from the
            # record (tested for exact agreement in tests/test_obs.py)
            tid = int(rec.rid)
            tr.span_at(
                "request", rec.arrival_t, rec.done_t, clock="sim", tid=tid,
                rid=tid, n_tokens=rec.n_tokens,
                prefill_exact=rec.prefill_exact, replicas_used=rec.replicas_used,
            )
            tr.span_at("request.queue", rec.arrival_t, rec.admit_t, clock="sim", tid=tid)
            tr.span_at(
                "request.prefill", rec.admit_t, rec.prefill_done_t, clock="sim",
                tid=tid, exact=rec.prefill_exact, replicas_used=rec.replicas_used,
                all_done_t=rec.prefill_all_done_t,
            )
            tr.span_at(
                "request.decode", rec.prefill_done_t, rec.done_t, clock="sim",
                tid=tid, n_tokens=rec.n_tokens,
            )
            tr.instant(
                "request.first_token", t=rec.first_token_t, clock="sim",
                tid=tid, rid=tid,
            )
            if not rec.prefill_exact:
                tr.instant(
                    "prefill.inexact", t=rec.prefill_done_t, clock="sim",
                    tid=tid, rid=tid, replicas_used=rec.replicas_used,
                )
        self.completions.append(
            Completion(rid=act.req.rid, tokens=np.asarray(act.emitted, np.int32), record=rec)
        )

    def step(self) -> bool:
        """Admit what fits, run ONE batched decode step, emit/finish.
        Returns True while work remains (active or queued requests)."""
        self._admit()
        if not self._active:
            return bool(self._queue)
        t0 = time.perf_counter()
        emit = self.batch.step(self.params)
        dt = self.decode_dt if self.decode_dt is not None else (time.perf_counter() - t0)
        self.now += dt
        if self.tracer.enabled:
            self.tracer.counter(
                "serve.active", float(len(self._active)), t=self.now, clock="sim"
            )
        for act in list(self._active.values()):
            tok = int(emit[act.slot])
            act.emitted.append(tok)
            # a token cannot be emitted before the request's coded prefill
            # became answerable plus one decode step, and successive tokens
            # of one request are at least a decode step apart
            prev = act.done_t if not np.isnan(act.done_t) else act.prefill_done_t
            t_emit = max(self.now, prev + dt)
            if np.isnan(act.first_token_t):
                act.first_token_t = t_emit
            act.done_t = t_emit
            hit_eos = act.req.eos_id is not None and tok == act.req.eos_id
            if hit_eos or len(act.emitted) >= act.limit:
                self._finish(act)
        return bool(self._active or self._queue)

    def run(self, requests: list[Request]) -> tuple[list[Completion], ServingMetrics]:
        """Drive a whole request trace to completion.  Returns completions
        in rid order + the accumulated metrics."""
        for req in requests:
            self.submit(req)
        while self.step():
            pass
        return sorted(self.completions, key=lambda c: c.rid), self.metrics
