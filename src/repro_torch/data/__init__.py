"""Synthetic data of the port, after ``repro.data``: the LM token stream,
the recsys id stream, the graph generators and the fanout neighbor
sampler."""
from repro_torch.data.sampler import NeighborSampler
from repro_torch.data.synthetic import (
    lm_batch_stream, random_geometric_graph, random_graph, recsys_stream,
)

__all__ = ["NeighborSampler", "lm_batch_stream", "random_geometric_graph",
           "random_graph", "recsys_stream"]
