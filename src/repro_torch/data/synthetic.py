"""Synthetic data, after ``repro.data.synthetic`` (``lm_batch_stream``
and ``recsys_stream``, copied: the reference's module cannot be imported
without JAX).

Deterministic, step-seeded generators: a restarted job regenerates the
exact batch for any step index.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


def lm_batch_stream(batch: int, seq_len: int, vocab: int,
                    start_step: int = 0, seed: int = 17
                    ) -> Iterator[dict]:
    """Zipf-ish token stream with next-token labels: tokens and labels
    [batch, seq_len] int32, one batch per step."""
    step = start_step
    while True:
        rng = np.random.default_rng((seed, step))
        logits = rng.zipf(1.3, size=(batch, seq_len + 1))
        tokens = np.minimum(logits, vocab - 1).astype(np.int32)
        yield {"tokens": tokens[:, :-1],
               "labels": tokens[:, 1:].copy(),
               "step": step}
        step += 1


def recsys_stream(batch: int, n_fields: int, vocab: int,
                  start_step: int = 0, seed: int = 23) -> Iterator[dict]:
    """Uniform hashed ids [batch, n_fields] int32 in [0, vocab) and 0/1
    labels [batch] int32, one batch per step."""
    step = start_step
    while True:
        rng = np.random.default_rng((seed, step))
        ids = rng.integers(0, vocab, size=(batch, n_fields),
                           dtype=np.int64).astype(np.int32)
        # labels correlated with a fixed random hyperplane for learnability
        h = np.random.default_rng(seed).normal(size=n_fields)
        score = (ids % 97 / 97.0) @ h
        labels = (score > np.median(score)).astype(np.int32)
        yield {"ids": ids, "labels": labels, "step": step}
        step += 1
