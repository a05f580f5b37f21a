"""GAT [Velickovic et al., arXiv:1710.10903], after
``repro.models.gnn.gat``; Cora config: 2 layers, 8 hidden units x 8
heads (concat), the second layer averaging heads into the class logits.
Edge softmax = SDDMM -> segment softmax -> SpMM, all three on the shared
receiver-sorted arrangement, the two reductions and the aggregation
through the segment-reduce kernel. The config has no ``backend``: the
device picks the route.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import normal_init
from repro_torch.models.gnn.common import (
    GNNModel, Graph, aggregate, check_sorted, gather, segment_softmax,
)


class GATConfig(NamedTuple):
    n_layers: int = 2
    d_hidden: int = 8
    n_heads: int = 8
    d_in: int = 1433
    n_classes: int = 7


def init_params(cfg: GATConfig, generator: torch.Generator,
                device=None) -> dict:
    """The reference's tree, float32 normals drawn from ``generator`` (on
    its device unless ``device`` says); the two layers' weights are
    top-level leaves, as the reference keeps them."""
    d, H = cfg.d_hidden, cfg.n_heads

    def draw(shape, std):
        return normal_init(shape, std, torch.float32, generator, device)

    return {
        "w1": draw((cfg.d_in, H, d), cfg.d_in ** -0.5),
        "a1_src": draw((H, d), d ** -0.5),
        "a1_dst": draw((H, d), d ** -0.5),
        "w2": draw((H * d, H, cfg.n_classes), (H * d) ** -0.5),
        "a2_src": draw((H, cfg.n_classes), cfg.n_classes ** -0.5),
        "a2_dst": draw((H, cfg.n_classes), cfg.n_classes ** -0.5),
    }


def _gat_layer(x, w, a_src, a_dst, graph: Graph, concat: bool):
    n_nodes = x.shape[0]
    H, dout = w.shape[1], w.shape[2]
    z = (x @ w.reshape(w.shape[0], H * dout)).reshape(n_nodes, H, dout)
    alpha_src = (z * a_src).sum(-1)                       # [N, H]
    alpha_dst = (z * a_dst).sum(-1)
    scores = F.leaky_relu(gather(alpha_src, graph.senders)
                          + gather(alpha_dst, graph.receivers), 0.2)
    att = segment_softmax(scores, graph.receivers, n_nodes)   # [E, H]
    msg = att[:, :, None] * gather(z, graph.senders)      # [E, H, d]
    out = aggregate(msg.reshape(-1, H * dout), graph.receivers,
                    n_nodes, "sum").reshape(n_nodes, H, dout)
    if concat:
        return F.elu(out).reshape(n_nodes, H * dout)
    return out.mean(dim=1)                                # head average


class GAT(GNNModel):
    """The GAT over the reference's tree {"w1", "a1_src", "a1_dst", "w2",
    "a2_src", "a2_dst"} (no stacked subtree)."""

    STACKED = None
    init_params = staticmethod(init_params)

    def forward(self, graph: Graph) -> torch.Tensor:
        """graph -> class logits [N, n_classes]."""
        check_sorted(graph.receivers)
        p = self.top
        x = graph.node_feat.float()
        h = _gat_layer(x, p["w1"], p["a1_src"], p["a1_dst"], graph, True)
        return _gat_layer(h, p["w2"], p["a2_src"], p["a2_dst"], graph,
                          False)
