"""GatedGCN [Bresson & Laurent, arXiv:1711.07553; the benchmarked config
of arXiv:2003.00982], after ``repro.models.gnn.gatedgcn``: edge-gated
message passing.

    e'_uv = C e_uv + D h_u + E h_v
    eta_uv = sigmoid(e'_uv)
    h'_v = h_v + ReLU(LN(A h_v + sum_u eta_uv * (B h_u) / (sum eta + eps)))
    e_out = e + ReLU(LN(e'))

The message is the engine's join-flatmap (the edge relation joined with
node payloads, a per-edge map on the join's output); the normalized
aggregation is two vector-monoid reductions on one arrangement, both
through the segment-reduce kernel. The layers run as a Python loop over
the stacked leaves (the reference's ``lax.scan`` computes the same
thing). The config has no ``backend`` or ``unroll``: the device picks
the route and the loop is always unrolled. ``shard_nodes`` (the
reference's perf option, off in every config) places its two
``maybe_shard`` constraints on a mesh: the nodes' state over "model",
the edges' over the data axes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.common import layer_norm, maybe_shard, normal_init
from repro_torch.models.gnn.common import (
    GNNModel, Graph, aggregate, check_sorted, gather,
)


class GatedGCNConfig(NamedTuple):
    n_layers: int = 16
    d_hidden: int = 70
    d_in: int = 1433
    d_edge_in: int = 1
    n_classes: int = 16
    shard_nodes: bool = False   # node dim over 'model' (perf iteration)


def init_params(cfg: GatedGCNConfig, generator: torch.Generator,
                device=None) -> dict:
    """The reference's tree ({"embed_h", "embed_e", "head", "layers"},
    the per-layer leaves stacked [L, ...]), float32 normals drawn from
    ``generator`` (on its device unless ``device`` says); the norms' gains
    1 and biases 0."""
    d = cfg.d_hidden
    s = d ** -0.5
    L = cfg.n_layers

    def draw(shape, std):
        return normal_init(shape, std, torch.float32, generator, device)

    dev = generator.device if device is None else device
    layers = {k: draw((L, d, d), s) for k in "ABCDE"}
    for k, fill in (("ln_h_g", 1.0), ("ln_h_b", 0.0), ("ln_e_g", 1.0),
                    ("ln_e_b", 0.0)):
        layers[k] = torch.full((L, d), fill, dtype=torch.float32,
                               device=dev)
    return {"embed_h": draw((cfg.d_in, d), cfg.d_in ** -0.5),
            "embed_e": draw((cfg.d_edge_in, d), 1.0),
            "head": draw((d, cfg.n_classes), s),
            "layers": layers}


class GatedGCN(GNNModel):
    STACKED = "layers"
    init_params = staticmethod(init_params)

    def forward(self, graph: Graph) -> torch.Tensor:
        """graph -> class logits [N, n_classes]."""
        cfg, p = self.cfg, self.top
        check_sorted(graph.receivers)
        h = graph.node_feat.float() @ p["embed_h"]
        e = (graph.edge_feat.float() @ p["embed_e"]
             if graph.edge_feat is not None
             else torch.zeros((graph.senders.shape[0], cfg.d_hidden),
                              dtype=torch.float32, device=h.device))
        n_nodes = graph.node_feat.shape[0]
        for lp in self.stack:
            hs = gather(h, graph.senders)
            hr = gather(h, graph.receivers)
            e_new = e @ lp["C"] + hr @ lp["D"] + hs @ lp["E"]
            eta = torch.sigmoid(e_new)
            msg = eta * (hs @ lp["B"])
            num = aggregate(msg, graph.receivers, n_nodes, "sum")
            den = aggregate(eta, graph.receivers, n_nodes, "sum")
            agg = num / (den + 1e-6)
            h = h + torch.relu(layer_norm(h @ lp["A"] + agg, lp["ln_h_g"],
                                          lp["ln_h_b"]))
            e = e + torch.relu(layer_norm(e_new, lp["ln_e_g"],
                                          lp["ln_e_b"]))
            if cfg.shard_nodes:
                h = maybe_shard(h, "model", None)
                e = maybe_shard(e, "dp", None)
        return h @ p["head"]
