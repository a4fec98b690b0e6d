"""Straggler models (paper §VI-A: artificial delays, faults, transients).

Each model samples a per-iteration *slowdown profile*: a vector of
multiplicative slowdown factors (1.0 = healthy, np.inf = dead/full straggler)
plus an additive delay in seconds.  The simulator and the trainer's
straggler-injection hook both consume these profiles, so the benchmarks and
the real SPMD runs exercise identical patterns.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "StragglerProfile",
    "StragglerModel",
    "NoStragglers",
    "FixedDelayStragglers",
    "TransientStragglers",
    "FaultModel",
    "ComposedModel",
]


@dataclasses.dataclass(frozen=True)
class StragglerProfile:
    """One iteration's straggler realization."""

    slowdown: np.ndarray  # (m,) multiplicative, inf = full straggler
    extra_delay: np.ndarray  # (m,) additive seconds

    @property
    def dead(self) -> np.ndarray:
        return ~np.isfinite(self.slowdown)

    def straggler_set(self, threshold: float = np.inf) -> tuple[int, ...]:
        """Workers considered stragglers (dead or delayed past threshold)."""
        mask = self.dead | (self.extra_delay >= threshold)
        return tuple(int(i) for i in np.nonzero(mask)[0])


class StragglerModel:
    def sample(self, m: int, rng: np.random.Generator) -> StragglerProfile:
        raise NotImplementedError


class NoStragglers(StragglerModel):
    def sample(self, m: int, rng: np.random.Generator) -> StragglerProfile:
        return StragglerProfile(np.ones(m), np.zeros(m))


@dataclasses.dataclass
class FixedDelayStragglers(StragglerModel):
    """Fig. 2 setup: ``s`` uniformly-random workers get ``delay`` extra
    seconds each iteration; ``delay=inf`` models a fault."""

    s: int
    delay: float

    def sample(self, m: int, rng: np.random.Generator) -> StragglerProfile:
        slow = np.ones(m)
        extra = np.zeros(m)
        idx = rng.choice(m, size=min(self.s, m), replace=False)
        if np.isinf(self.delay):
            slow[idx] = np.inf
        else:
            extra[idx] = self.delay
        return StragglerProfile(slow, extra)


@dataclasses.dataclass
class TransientStragglers(StragglerModel):
    """Resource-contention transients: each worker independently slowed by a
    lognormal factor with probability p (Dean & Barroso tail-at-scale)."""

    p: float = 0.05
    sigma: float = 1.0
    scale: float = 3.0

    def sample(self, m: int, rng: np.random.Generator) -> StragglerProfile:
        slow = np.ones(m)
        hit = rng.uniform(size=m) < self.p
        slow[hit] = 1.0 + self.scale * rng.lognormal(0.0, self.sigma, size=int(hit.sum()))
        return StragglerProfile(slow, np.zeros(m))


@dataclasses.dataclass
class FaultModel(StragglerModel):
    """Independent per-iteration death probability (VM loss)."""

    p_fault: float = 0.01

    def sample(self, m: int, rng: np.random.Generator) -> StragglerProfile:
        slow = np.ones(m)
        slow[rng.uniform(size=m) < self.p_fault] = np.inf
        return StragglerProfile(slow, np.zeros(m))


@dataclasses.dataclass
class ComposedModel(StragglerModel):
    models: tuple[StragglerModel, ...]

    def sample(self, m: int, rng: np.random.Generator) -> StragglerProfile:
        slow = np.ones(m)
        extra = np.zeros(m)
        for mod in self.models:
            p = mod.sample(m, rng)
            slow = slow * p.slowdown
            extra = extra + p.extra_delay
        return StragglerProfile(slow, extra)
