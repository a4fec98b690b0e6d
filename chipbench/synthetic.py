"""The traffic's token stream: a frozen copy of the port's
``data/pipeline.py:SyntheticData`` for text models.

A partition is a pure function of ``(seed, step, partition)``, so any
worker that holds it can make it and the reference makes the same rows
again.  Token ids are drawn below ``vocab``, the tokenizer's vocabulary
(``data_vocab`` of the configuration file), which may be smaller than the
model's padded embedding.  Kept here, apart from the port, so that a change
to the program cannot move the traffic.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticTokens:
    vocab: int
    k: int  # partitions a step
    part_mb: int  # sequences a partition
    seq_len: int
    seed: int

    def partition(self, step: int, j: int) -> np.ndarray:
        """(part_mb, seq_len) int32 tokens: a zipf unigram mixed with
        repetition of the previous token, as the port's pipeline draws."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step, j, 0xC0DED]))
        shape = (self.part_mb, self.seq_len)
        toks = np.minimum(rng.zipf(1.3, shape).astype(np.int64), self.vocab - 1)
        rep = rng.uniform(size=shape) < 0.3
        toks[:, 1:] = np.where(rep[:, 1:], toks[:, :-1], toks[:, 1:])
        return toks.astype(np.int32)

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Partition-major ``{"tokens", "labels"}``, each (k, part_mb, seq_len);
        the labels are the tokens (the model shifts them)."""
        toks = np.stack([self.partition(step, j) for j in range(self.k)])
        return {"tokens": toks, "labels": toks.copy()}

    def unique_rows(self, step: int) -> np.ndarray:
        """(k * part_mb, seq_len): the step's distinct sequences, partition-major."""
        return self.batch(step)["tokens"].reshape(-1, self.seq_len)
