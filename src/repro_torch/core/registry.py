"""Pluggable gradient-code registry (DESIGN.md §1).

A *gradient code* bundles everything the runtime needs from one coding
scheme behind a uniform surface:

  - construction:  throughput estimates ``c`` -> ``B`` matrix + allocation
    (:meth:`GradientCode.build`), re-run on elastic rebalance;
  - decoding:      :meth:`GradientCode.decode_vector` with the scheme's own
    fast path (group indicator for group-structured codes, LRU-cached
    least-squares otherwise) — previously split between ``Decoder`` and
    ``CodingScheme.groups``;
  - declarations:  ``structural_k`` (the scheme dictates ``k = m`` and
    ignores the requested partition count), ``supports_rebalance`` (B
    depends on ``c``), ``wait_for_all`` (naive-BSP iteration semantics).

Schemes self-register under a string name::

    @register_scheme("my_code")
    class MyCode(GradientCode):
        def build(self, c): ...

and the runtime constructs them exclusively through :func:`get_scheme` —
adding a new code family is a one-file change (see core/schemes.py for the
five built-ins).
"""

from __future__ import annotations

import abc
import copy
import dataclasses
import importlib
import math
from functools import lru_cache
from typing import Callable, Iterable, Sequence

import numpy as np

from repro_torch.core.allocation import count_moved
from repro_torch.core.coding import CodingScheme, scheme_from_state, scheme_to_state
from repro_torch.core.decoding import (
    DecodeError,
    DecodeOutcome,
    best_effort_decode_vector,
    earliest_decodable_stream,
    worker_arrival_order,
)

__all__ = [
    "GradientCode",
    "MembershipStats",
    "register_scheme",
    "get_scheme",
    "scheme_class",
    "scheme_names",
]


@dataclasses.dataclass(frozen=True)
class MembershipStats:
    """One in-place membership transition, as the runtime reports it.

    Attributes:
      m_before / m_after: worker count across the transition.
      retained: workers surviving it.
      moved: partition copies newly acquired by retained workers (the data
        that must move between surviving machines).
      bound: the scheme's documented stability bound on ``moved``; None for
        structural schemes (k = m changes, the whole layout is rebuilt and
        movement is inherently unbounded).
      changed_columns: B columns re-solved by the transition; None when the
        scheme rebuilds all coefficients.
    """

    m_before: int
    m_after: int
    retained: int
    moved: int
    bound: int | None
    changed_columns: int | None

_REGISTRY: dict[str, type["GradientCode"]] = {}

# Built-in family modules, registered on first lookup.  The approx package
# sits ABOVE core in the layering, so core must never import it at package-
# import time; deferring to first use keeps the dependency one-directional
# at import and surfaces any approx import error at the lookup, not at
# `import repro_torch.core`.
_FAMILY_MODULES = ("repro_torch.core.schemes", "repro_torch.approx.schemes")
_families_loaded = False


def _load_family_modules() -> None:
    global _families_loaded
    if _families_loaded:
        return
    for mod in _FAMILY_MODULES:
        importlib.import_module(mod)
    # flag only after success: a failed import must re-raise on the next
    # lookup, not be masked as "unknown scheme" (retries are free — importlib
    # caches successful module imports)
    _families_loaded = True


def register_scheme(name: str) -> Callable[[type], type]:
    """Class decorator: register a GradientCode subclass under ``name``."""

    def deco(cls: type) -> type:
        if not (isinstance(cls, type) and issubclass(cls, GradientCode)):
            raise TypeError(f"@register_scheme target must subclass GradientCode, got {cls!r}")
        if name in _REGISTRY and _REGISTRY[name] is not cls:
            raise ValueError(f"scheme {name!r} already registered to {_REGISTRY[name].__name__}")
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def scheme_names() -> tuple[str, ...]:
    """Registered scheme names, sorted."""
    _load_family_modules()
    return tuple(sorted(_REGISTRY))


def scheme_class(name: str) -> type["GradientCode"]:
    _load_family_modules()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown scheme {name!r}; registered: {', '.join(scheme_names()) or '(none)'}"
        ) from None


def get_scheme(
    name: str,
    *,
    m: int,
    k: int | None = None,
    s: int = 1,
    c: Sequence[float] | None = None,
    rng: np.random.Generator | int | None = 0,
    max_load: int | None = None,
) -> "GradientCode":
    """Construct a registered gradient code.  The single public factory."""
    return scheme_class(name)(m=m, k=k, s=s, c=c, rng=rng, max_load=max_load)


class GradientCode(abc.ABC):
    """One gradient coding scheme + its decode state.

    Subclasses implement :meth:`build` (c -> CodingScheme) and may override
    :meth:`_decode_fast_path`.  The base class owns the generic LRU-cached
    least-squares decode, straggler-pattern utilities, and the elastic
    ``rebalance`` contract (rebuild B from fresh estimates, invalidate the
    decode cache, never change ``m``/``k``/``s``).
    """

    name: str = "?"  # set by @register_scheme
    structural_k: bool = False  # True: k is forced to m, requested k ignored
    supports_rebalance: bool = False  # True: B depends on c estimates
    wait_for_all: bool = False  # True: naive BSP, iteration waits for everyone
    exact: bool = True  # True: any ≤s straggler pattern decodes exactly
    reports_partial_work: bool = False  # True: workers stream per-partition results

    def __init__(
        self,
        *,
        m: int,
        k: int | None = None,
        s: int = 1,
        c: Sequence[float] | None = None,
        rng: np.random.Generator | int | None = 0,
        max_load: int | None = None,
        decode_cache_size: int = 4096,
    ):
        if m <= 0:
            raise ValueError(f"need m > 0, got {m}")
        self.m = m
        self.s = int(s)
        self.requested_k = int(k) if k is not None else m
        self.max_load = max_load
        self._rng = rng if isinstance(rng, np.random.Generator) else np.random.default_rng(rng)
        self._decode_cache_size = decode_cache_size
        self._membership_epoch = 0
        c = np.ones(m, dtype=np.float64) if c is None else np.asarray(c, dtype=np.float64)
        if c.shape != (m,):
            raise ValueError(f"len(c)={c.shape[0] if c.ndim else '?'} != m={m}")
        self.c = c
        self.scheme: CodingScheme = self._build_tracked(c)
        self._reset_decode_cache()

    # -- construction ------------------------------------------------------

    @abc.abstractmethod
    def build(self, c: np.ndarray) -> CodingScheme:
        """Construct the encoding matrix/allocation for throughputs ``c``."""

    def _build_tracked(self, c: np.ndarray) -> CodingScheme:
        """`build` + a snapshot of the pre-build RNG state, so a checkpoint
        restore can replay the exact same construction (the RNG is consumed
        only by builds, so replaying the last build realigns it)."""
        self._build_rng_state = copy.deepcopy(self._rng.bit_generator.state)
        return self.build(c)

    def rebalance(self, c: Sequence[float]) -> CodingScheme:
        """Elastic re-encode: rebuild B from fresh throughput estimates.

        Host-side, milliseconds.  ``m``/``k``/``s`` never change, so slot
        plans padded to a fixed capacity stay shape-stable.  No-op for
        schemes whose allocation ignores ``c`` (structural baselines).
        """
        if not self.supports_rebalance:
            return self.scheme
        c = np.asarray(c, dtype=np.float64)
        if c.shape != (self.m,):
            raise ValueError(f"rebalance c shape {c.shape} != ({self.m},)")
        self.c = c
        self.scheme = self._build_tracked(c)
        self._reset_decode_cache()
        return self.scheme

    # -- elastic membership (DESIGN.md §8) -----------------------------------

    def _check_resize_args(
        self, c: np.ndarray, old_of_new: Sequence[int | None]
    ) -> np.ndarray:
        m_new = len(old_of_new)
        if m_new <= self.s:
            raise ValueError(f"membership change needs m > s, got m={m_new}, s={self.s}")
        c = np.asarray(c, dtype=np.float64)
        if c.shape != (m_new,):
            raise ValueError(f"len(c)={c.shape} != new m={m_new}")
        olds = [o for o in old_of_new if o is not None]
        if len(set(olds)) != len(olds) or any(not 0 <= o < self.m for o in olds):
            raise ValueError(f"old_of_new maps old workers out of range or twice: {old_of_new}")
        if olds != sorted(olds):
            raise ValueError("retained workers must keep their relative order")
        if not olds and self.m > 0:
            raise ValueError("membership change must retain at least one worker")
        return c

    def resize(self, c: Sequence[float], old_of_new: Sequence[int | None]) -> MembershipStats:
        """In-place membership change: grow/shrink the worker set to
        ``len(old_of_new)`` workers (``old_of_new[i]`` = new worker i's old
        index, None = joined fresh), re-encoding against throughputs ``c``.

        Base implementation: a full rebuild at the new ``m`` — correct for
        every scheme, with no stability guarantee (structural schemes force
        ``k = m``, so the whole layout changes by construction).  Schemes
        with a stable remap (heter-aware family, group_based, bernoulli)
        override this with a bounded-movement transition.  Either way the
        decode caches die with the old B, and ``m``/``c``/the scheme are
        updated atomically.
        """
        c = self._check_resize_args(c, old_of_new)
        prev = self.scheme
        # the rebuild can reject the new worker set (e.g. structural
        # divisibility at the shrunk m) — snapshot so a failed transition
        # leaves the code EXACTLY as it was, RNG included (a consumed draw
        # would silently desync future rebuilds from a bit-exact resume)
        saved = (self.m, self.requested_k, self.c,
                 copy.deepcopy(self._rng.bit_generator.state))
        self.m = len(old_of_new)
        if self.structural_k:
            self.requested_k = self.m
        self.c = c
        try:
            self.scheme = self._build_tracked(c)
        except Exception:
            self.m, self.requested_k, self.c = saved[:3]
            self._rng.bit_generator.state = saved[3]
            raise
        self._reset_decode_cache()
        self._membership_epoch += 1
        return MembershipStats(
            m_before=prev.m,
            m_after=self.m,
            retained=sum(1 for o in old_of_new if o is not None),
            moved=count_moved(prev.allocation, self.allocation, old_of_new)
            if prev.k == self.k
            else sum(self.allocation.counts[i] for i, o in enumerate(old_of_new) if o is not None),
            bound=None,
            changed_columns=None,
        )

    @property
    def membership_epoch(self) -> int:
        """Transitions applied so far (0 = the constructed worker set)."""
        return self._membership_epoch

    # -- checkpoint state ---------------------------------------------------

    def state_dict(self) -> dict:
        """JSON-able snapshot: sizes, throughputs, the CURRENT RNG state,
        and the scheme itself in explicit form.  A post-membership B is
        path-dependent (incremental column rebuilds, C columns inherited
        across transitions), so restore loads B/allocation/C directly —
        bit-for-bit — instead of replaying the build; restoring the live
        RNG state keeps every FUTURE rebuild aligned with the saved run
        (builds are the only RNG consumer)."""
        return {
            "m": int(self.m),
            "requested_k": int(self.requested_k),
            "max_load": None if self.max_load is None else int(self.max_load),
            "membership_epoch": int(self._membership_epoch),
            "c": [float(x) for x in self.c],
            "rng_state": copy.deepcopy(self._rng.bit_generator.state),
            "scheme": scheme_to_state(self.scheme),
        }

    def load_state_dict(self, state: dict) -> None:
        if "scheme" not in state:
            # pre-§8 checkpoint format: {c, build_rng_state} — replay the
            # build from the saved pre-build RNG snapshot (the old restore
            # semantics).  That format predates membership transitions, so
            # the restore rolls the worker set back to len(c) and epoch 0
            # (the loading code may itself have churned since construction).
            self.c = np.asarray(state["c"], dtype=np.float64)
            self.m = int(self.c.shape[0])
            if self.structural_k:
                self.requested_k = self.m
            self._membership_epoch = 0
            self._rng.bit_generator.state = copy.deepcopy(state["build_rng_state"])
            self.scheme = self._build_tracked(self.c)
            self._reset_decode_cache()
            return
        self.m = int(state["m"])
        self.requested_k = int(state["requested_k"])
        self.max_load = None if state["max_load"] is None else int(state["max_load"])
        self._membership_epoch = int(state["membership_epoch"])
        self.c = np.asarray(state["c"], dtype=np.float64)
        self._rng.bit_generator.state = copy.deepcopy(state["rng_state"])
        self.scheme = scheme_from_state(state["scheme"])
        self._reset_decode_cache()

    # -- convenient views --------------------------------------------------

    @property
    def k(self) -> int:
        return self.scheme.k

    @property
    def B(self) -> np.ndarray:
        return self.scheme.B

    @property
    def allocation(self):
        return self.scheme.allocation

    def worker_load(self) -> np.ndarray:
        return self.scheme.worker_load()

    @classmethod
    def effective_k(cls, m: int, k: int | None) -> int:
        """The k this scheme will actually use — BEFORE construction.  Lets
        the runtime size fixed slot capacity correctly for structural
        schemes (which override any requested k with m)."""
        return m if cls.structural_k else (int(k) if k is not None else m)

    # -- decoding ----------------------------------------------------------

    def _reset_decode_cache(self) -> None:
        self._solve = lru_cache(maxsize=self._decode_cache_size)(self._solve_uncached)

    def _solve_uncached(self, avail_key: frozenset[int]) -> DecodeOutcome:
        return best_effort_decode_vector(self.scheme.B, sorted(avail_key))

    def _decode_fast_path(self, avail: frozenset[int]) -> np.ndarray | None:
        """Scheme-specific O(m) decode shortcut; None -> generic solve."""
        return None

    def decode_outcome(self, available: Iterable[int]) -> DecodeOutcome:
        """Decode the available set, exactly when possible, best-effort
        otherwise — never raises.  ``outcome.residual == 0`` iff an exact
        decode exists for the set.  Outcomes (exact AND inexact) share one
        LRU keyed by the available set; fast-path hits bypass it."""
        avail = frozenset(int(i) for i in available)
        fast = self._decode_fast_path(avail)
        if fast is not None:
            return DecodeOutcome(a=fast, exact=True, residual=0.0)
        return self._solve(avail)

    def decode_vector(self, available: Iterable[int]) -> np.ndarray:
        """Decode vector ``a`` with ``supp(a) ⊆ available``, ``a·B = 1``.
        Raises :class:`DecodeError` when only an inexact decode exists —
        callers that can step inexactly use :meth:`decode_outcome`."""
        outcome = self.decode_outcome(available)
        if not outcome.exact:
            raise DecodeError(
                f"available set cannot decode exactly (rms residual {outcome.residual:.3g})"
            )
        return outcome.a

    def decode_partial(
        self, support: np.ndarray, available: Iterable[int] | None = None
    ) -> DecodeOutcome:
        """Best-effort decode from partially-completed workers.

        ``support`` is the (m, k) completion mask — entry (w, j) is 1 when
        worker w finished partition j (its effective B row is ``B[w]·mask``).
        Continuous masks do not key an LRU, so these solves are uncached.
        """
        support = np.asarray(support, dtype=np.float64)
        if support.shape != self.B.shape:
            raise ValueError(f"support shape {support.shape} != B shape {self.B.shape}")
        return best_effort_decode_vector(self.scheme.B, available, support=support)

    def decode_cache_info(self):
        """LRU stats of the generic solve path (hits/misses/currsize)."""
        return self._solve.cache_info()

    def is_decodable(self, available: Iterable[int]) -> bool:
        return self.decode_outcome(available).exact

    def _confirm_exact(self, live: tuple[int, ...]) -> np.ndarray | None:
        """Exact-solve confirmation for the streaming tracker: the cached
        outcome's vector when the live set decodes exactly, else None."""
        outcome = self._solve(frozenset(live))
        return outcome.a if outcome.exact else None

    def earliest_decodable(
        self, finish_times: Sequence[float], dead: Iterable[int] = ()
    ) -> tuple[float, tuple[int, ...]]:
        """Smallest time τ at which the set of finished workers decodes
        (Eq. 3), honouring this scheme's decode fast path.

        Arrival-driven: the finish vector induces a worker-completion
        stream, a :class:`~repro_torch.core.decoding.DecodableSetTracker` answers
        "decodable yet?" per event in O(rank·k), and the (LRU-cached) exact
        solver runs once at the decodable moment — not per prefix."""
        return earliest_decodable_stream(
            self.scheme.B,
            worker_arrival_order(finish_times, dead),
            confirm=self._confirm_exact,
            fast_path=self._decode_fast_path,
        )

    def earliest_decodable_stream(
        self, arrivals: Iterable[tuple[float, int]]
    ) -> tuple[float, tuple[int, ...]]:
        """Streaming variant: consume (t, worker) completion events directly
        (an :class:`~repro_torch.core.simulator.ArrivalStream` view) without ever
        materializing a dense finish vector."""
        return earliest_decodable_stream(
            self.scheme.B,
            arrivals,
            confirm=self._confirm_exact,
            fast_path=self._decode_fast_path,
        )

    # -- misc --------------------------------------------------------------

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"<{type(self).__name__} name={self.name!r} m={self.m} k={self.k} "
            f"s={self.s} structural_k={self.structural_k}>"
        )


class GroupIndicatorMixin:
    """Decode fast path for group-structured codes (§V Eq. 8): a fully
    available tiling group decodes with its 0/1 indicator — no solve, and
    typically fewer than m−s workers."""

    def _decode_fast_path(self, avail: frozenset[int]) -> np.ndarray | None:
        for group in self.scheme.groups:
            if avail.issuperset(group):
                a = np.zeros(self.m, dtype=np.float64)
                a[list(group)] = 1.0
                return a
        return None


def plan_slot_capacity(
    k: int, s: int, m: int, c: np.ndarray | None, *, headroom: float = 1.25
) -> int:
    """Fixed per-worker slot capacity: worst-case allocation share plus
    drift headroom, so elastic re-allocations never change array shapes.
    With a calibration estimate ``c`` the share is planned from the fastest
    worker's ideal load instead of the uniform share.  ``k`` must be the
    scheme's *effective* k (structural schemes force k = m)."""
    if c is not None:
        c = np.asarray(c, dtype=np.float64)
        base = math.ceil(k * (s + 1) * float(c.max()) / float(c.sum()))
    else:
        base = math.ceil(k * (s + 1) / m)
    return min(k, max(base + 1, math.ceil(base * headroom)))
