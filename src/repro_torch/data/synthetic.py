"""Synthetic data, after ``repro.data.synthetic`` (copied: the
reference's module cannot be imported without JAX). The generators make
the same numpy calls in the same order, so their arrays equal the
reference's for the same arguments and seed.

Deterministic, step-seeded generators: a restarted job regenerates the
exact batch for any step index.
"""
from __future__ import annotations

from typing import Iterator, Optional

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


def random_graph(n_nodes: int, n_edges: int, d_feat: int,
                 n_classes: int = 16, seed: int = 7,
                 power_law: bool = True) -> dict:
    """Directed graph with a power-law-ish degree distribution, edges
    sorted by receiver (the arrangement invariant): senders, receivers
    [n_edges] int32, node_feat [n_nodes, d_feat] and edge_feat [n_edges,
    1] float32, labels [n_nodes] int32."""
    rng = np.random.default_rng(seed)
    if power_law:
        w = 1.0 + rng.pareto(2.5, size=n_nodes)   # moderate skew
        p = w / w.sum()
        senders = rng.choice(n_nodes, size=n_edges, p=p)
        receivers = rng.choice(n_nodes, size=n_edges, p=p)
    else:
        senders = rng.integers(0, n_nodes, n_edges)
        receivers = rng.integers(0, n_nodes, n_edges)
    order = np.argsort(receivers, kind="stable")
    return {
        "senders": senders[order].astype(np.int32),
        "receivers": receivers[order].astype(np.int32),
        "node_feat": rng.normal(
            size=(n_nodes, d_feat)).astype(np.float32),
        "edge_feat": rng.normal(size=(n_edges, 1)).astype(np.float32),
        "labels": rng.integers(0, n_classes, n_nodes).astype(np.int32),
    }


def random_geometric_graph(n_nodes: int, cutoff: float = 5.0,
                           box: float = 10.0, seed: int = 7,
                           max_edges: Optional[int] = None) -> dict:
    """3D point cloud with radius-graph edges (the DimeNet/NequIP input):
    positions [n_nodes, 3] float32 uniform in the box, species int32 in
    [0, 8), the directed pairs closer than ``cutoff`` (a random
    ``max_edges`` of them when there are more) sorted by receiver, and
    energy_labels [n_nodes] float32."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, box, size=(n_nodes, 3)).astype(np.float32)
    d2 = ((pos[:, None] - pos[None, :]) ** 2).sum(-1)
    src, dst = np.where((d2 < cutoff ** 2) & (d2 > 0))
    if max_edges is not None and len(src) > max_edges:
        keep = rng.permutation(len(src))[:max_edges]
        src, dst = src[keep], dst[keep]
    order = np.argsort(dst, kind="stable")
    return {
        "positions": pos,
        "species": rng.integers(0, 8, n_nodes).astype(np.int32),
        "senders": src[order].astype(np.int32),
        "receivers": dst[order].astype(np.int32),
        "energy_labels": rng.normal(size=n_nodes).astype(np.float32),
    }


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
