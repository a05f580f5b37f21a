"""GNN training through the relational substrate on the port — the
counterpart of ``examples/gnn_relational.py``: GAT on a synthetic
Cora-sized graph, its message passing the engine's arrange ->
gather (join) -> segment-reduce (monoid merge) pipeline, then the
sip-style frontier sampler.

    PYTHONPATH=src python -m repro_torch.launch.gnn_relational \\
        [--steps 120] [--device cpu]

As the reference example: gat-cora's smoke config (2 layers, 4 hidden x
2 heads, 7 classes) trained full-batch on ``random_graph(512, 2048, 24,
n_classes=7, seed=3)`` cut to the smoke input (64 nodes, 256 edges, ids
taken modulo 64, receivers sorted), labels from a hidden linear map of
the features; then ``NeighborSampler`` with fanouts (5, 3) from seeds 0
to 7. On the card every step's aggregations run the segment-reduce
kernel, forward and backward. Weights are drawn from seed 0 on the
device.

Runs on the card; ``--device cpu`` runs the plain torch path (the tests).
"""
from __future__ import annotations

import argparse

import numpy as np

SHAPE = "full_graph_sm"
N_CLASSES = 7


def graph() -> dict:
    """The example's graph, with learnable labels."""
    from repro_torch.data.synthetic import random_graph
    g = random_graph(512, 2048, 24, n_classes=N_CLASSES, seed=3)
    # learnable labels: a hidden linear map of the features
    w_true = np.random.default_rng(0).normal(size=(24, N_CLASSES))
    g["labels"] = (g["node_feat"] @ w_true).argmax(1).astype(np.int32)
    return g


def smoke_batch(arch, g: dict) -> dict:
    """The graph padded / trimmed into the smoke input, as numpy."""
    sizes = arch.input_sizes(SHAPE, smoke=True)
    n, e = sizes["node_feat"][0], sizes["senders"][0]
    return {"senders": g["senders"][:e] % n,
            "receivers": np.sort(g["receivers"][:e] % n),
            "node_feat": g["node_feat"][:n],
            "edge_feat": g["edge_feat"][:e],
            "labels": g["labels"][:n] % N_CLASSES}


def train(steps: int, device, params=None, on_step=None) -> list:
    """``steps`` full-batch AdamW steps of the smoke GAT; ``params`` (the
    reference's tree as tensors, ``params_from_numpy``) replaces the
    seed-0 weights. ``on_step(i)`` is called after each step. Returns
    the per-step losses."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.training.optim import train_state_init

    arch = get_arch("gat-cora")
    cfg = arch.config(SHAPE, True)
    if params is None:
        params = arch.init_fn(cfg, torch.Generator(device).manual_seed(0))
    model = arch.model_fn(cfg, params, device, train=True)
    state = train_state_init(model.param_tree())
    step = arch.step_fn(SHAPE, smoke=True)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in smoke_batch(arch, graph()).items()}
    losses = []
    for i in range(steps):
        state, metrics = step(model, state, batch)
        losses.append(float(metrics["loss"]))
        if on_step is not None:
            on_step(i)
    return losses


def sample_subgraph(g: dict) -> dict:
    """The sip-style frontier sampler (minibatch_lg's substrate) from
    seeds 0 to 7."""
    from repro_torch.data.sampler import NeighborSampler
    smp = NeighborSampler(g["senders"], g["receivers"], 512,
                          fanouts=(5, 3))
    return smp.sample(np.arange(8))


def main(argv=None) -> dict:
    """Runs the example; returns {"losses": [...], "subgraph": {...}}."""
    from repro_torch.models.common import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device, "launch.gnn_relational")

    losses = train(args.steps, device)
    print(f"GAT loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({args.steps} full-batch steps)")
    assert losses[-1] < losses[0], "training should reduce loss"

    sub = sample_subgraph(graph())
    print(f"sampled subgraph: {sub['n_nodes']} nodes, "
          f"{sub['n_edges']} edges for 8 seeds")
    print("gnn_relational OK")
    return {"losses": losses, "subgraph": sub}


if __name__ == "__main__":
    main()
