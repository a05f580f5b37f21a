"""Fanout neighbor sampler (GraphSAGE-style) for minibatch_lg, after
``repro.data.sampler`` (copied: the same numpy calls in the same order,
so a sampler of the same seed gives the reference's subgraphs).

The sampler is semi-naive delta evaluation: the frontier at hop k is
delta-reach^k, and restricting the edge relation to the frontier before
sampling is sip semijoin pre-filtering applied to data loading. Host-side
numpy over a CSR adjacency; emits fixed-capacity padded subgraphs (the
engine's bounded-relation idiom) ready for the train step.
"""
from __future__ import annotations

import numpy as np


class NeighborSampler:
    def __init__(self, senders: np.ndarray, receivers: np.ndarray,
                 n_nodes: int, fanouts=(15, 10), seed: int = 0):
        # CSR by destination: sample *incoming* neighborhoods
        order = np.argsort(receivers, kind="stable")
        self.src = senders[order].astype(np.int64)
        self.dst = receivers[order].astype(np.int64)
        self.indptr = np.searchsorted(
            self.dst, np.arange(n_nodes + 1))
        self.n_nodes = n_nodes
        self.fanouts = tuple(fanouts)
        self.rng = np.random.default_rng(seed)
        # fixed output capacities per seed
        edges, frontier = 0, 1
        caps_n, caps_e = 1, 0
        for f in fanouts:
            edges = frontier * f
            caps_e += edges
            caps_n += edges
            frontier = edges
        self.node_cap_per_seed = caps_n
        self.edge_cap_per_seed = caps_e

    def sample(self, seeds: np.ndarray) -> dict:
        """A padded subgraph with relabeled node ids; nodes 0..k are the
        seeds (the loss is computed on them). Padded edges point at the
        last node slot."""
        seeds = np.asarray(seeds, np.int64)
        b = len(seeds)
        node_cap = b * self.node_cap_per_seed
        edge_cap = b * self.edge_cap_per_seed

        mapping: dict[int, int] = {}
        nodes: list[int] = []

        def local(g: int) -> int:
            if g not in mapping:
                mapping[g] = len(nodes)
                nodes.append(g)
            return mapping[g]

        for s in seeds:
            local(int(s))
        e_src: list[int] = []
        e_dst: list[int] = []
        frontier = list(seeds)
        for f in self.fanouts:
            nxt: list[int] = []
            for v in frontier:                      # delta-reach^k
                lo, hi = self.indptr[v], self.indptr[v + 1]
                deg = hi - lo
                if deg == 0:
                    continue
                idx = (np.arange(lo, hi) if deg <= f else
                       self.rng.choice(np.arange(lo, hi), f,
                                       replace=False))
                for e in idx:
                    u = int(self.src[e])
                    e_src.append(local(u))
                    e_dst.append(local(int(v)))
                    nxt.append(u)
            frontier = nxt
        n_real_nodes = len(nodes)
        n_real_edges = len(e_src)
        # pad: edges point at a sacrificial node slot
        senders = np.full(edge_cap, node_cap - 1, np.int32)
        receivers = np.full(edge_cap, node_cap - 1, np.int32)
        senders[:n_real_edges] = e_src
        receivers[:n_real_edges] = e_dst
        order = np.argsort(receivers, kind="stable")
        node_ids = np.full(node_cap, -1, np.int64)
        node_ids[:n_real_nodes] = nodes
        return {
            "senders": senders[order],
            "receivers": receivers[order],
            "node_ids": node_ids,
            "n_nodes": n_real_nodes,
            "n_edges": n_real_edges,
            "n_seeds": b,
        }
