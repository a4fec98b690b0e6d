"""Deterministic synthetic data pipeline, partition-addressable.

The key property gradient coding needs from a data pipeline: partition ``j``
of step ``t`` must be computable by *any* worker that holds it (partitions
are replicated s+1×).  We make partitions pure functions of
``(seed, step, partition_id)`` — replication then costs zero data movement,
and elastic re-allocation (worker churn, c_i drift) needs no shuffle. A real
deployment would back this with a deterministic-shard dataset (e.g.
tf.data/grain index files keyed the same way); the interface is identical.

Emits partition-major batches: leaves shaped (k, part_mb, ...).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class SyntheticData:
    cfg: ModelConfig
    k: int  # number of partitions
    part_mb: int  # sequences per partition
    seq_len: int
    seed: int = 0

    def _rng(self, step: int, j: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, j, 0xC0DED])
        )

    def partition(self, step: int, j: int) -> dict[str, np.ndarray]:
        """One partition's micro-batch (pure function of (seed, step, j))."""
        cfg = self.cfg
        rng = self._rng(step, j)
        S = self.seq_len
        out: dict[str, np.ndarray] = {}
        if cfg.frontend == "audio":
            out["frames"] = rng.standard_normal((self.part_mb, S, cfg.d_model), np.float32)
            out["labels"] = rng.integers(0, cfg.vocab, (self.part_mb, S)).astype(np.int32)
            return out
        # markov-ish synthetic tokens: mixture of zipf unigram + repetition so
        # a real model exhibits a real (falling) loss curve
        zipf = rng.zipf(1.3, (self.part_mb, S)).astype(np.int64)
        toks = np.minimum(zipf, cfg.vocab - 1)
        rep = rng.uniform(size=(self.part_mb, S)) < 0.3
        toks[:, 1:] = np.where(rep[:, 1:], toks[:, :-1], toks[:, 1:])
        if cfg.frontend == "vision":
            text_len = S - cfg.n_patches
            toks = toks[:, :text_len]
            out["patches"] = rng.standard_normal(
                (self.part_mb, cfg.n_patches, cfg.d_model), np.float32
            ) * 0.02
        out["tokens"] = toks.astype(np.int32)
        out["labels"] = out["tokens"].copy()
        return out

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Partition-major batch: leaves (k, part_mb, ...)."""
        parts = [self.partition(step, j) for j in range(self.k)]
        return {key: np.stack([p[key] for p in parts]) for key in parts[0]}


def partition_batch_specs(cfg: ModelConfig, k: int, part_mb: int, seq_len: int) -> dict[str, tuple]:
    """(shape, dtype) stand-ins for one partition-major batch — the dry-run
    builds ShapeDtypeStructs from these."""
    import numpy as np  # noqa: F811

    S = seq_len
    if cfg.frontend == "audio":
        return {
            "frames": ((k, part_mb, S, cfg.d_model), np.float32),
            "labels": ((k, part_mb, S), np.int32),
        }
    out: dict[str, tuple] = {}
    if cfg.frontend == "vision":
        out["patches"] = ((k, part_mb, cfg.n_patches, cfg.d_model), np.float32)
        out["tokens"] = ((k, part_mb, S - cfg.n_patches), np.int32)
        out["labels"] = ((k, part_mb, S - cfg.n_patches), np.int32)
    else:
        out["tokens"] = ((k, part_mb, S), np.int32)
        out["labels"] = ((k, part_mb, S), np.int32)
    return out
