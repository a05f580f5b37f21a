"""End-to-end training driver, after ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --smoke --device cpu --steps 20 --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --batch 4 --steps 6
    PYTHONPATH=src python -m repro_torch.launch.train --arch fm --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch gatedgcn \
        --shape minibatch_lg --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch granite-moe-1b-a400m --batch 8 --steps 6
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-7b \
        --layers 12 --batch 1 --steps 6

The fault-tolerance loop of the reference: step-seeded data (the batch
of step i is drawn from (seed, i), so a resumed run skips the consumed
batches and sees the same ones), async checkpoints every
``--ckpt-every`` steps and at the end (``CheckpointManager.save_async``,
the reference's leaf keys, so either package restores the other's),
``--resume`` from the newest checkpoint, the straggler watchdog, and the
reference's summary dict. A resumed run gives the same state, byte for
byte, as one that never stopped: on the card the run sets
``torch.use_deterministic_algorithms(True)`` (and
``CUBLAS_WORKSPACE_CONFIG``, unless set, before the card is first used)
for its duration, and the attention backward has no atomics.

Unlike the reference, the full config runs too (``--smoke`` picks the
reduced one), on ``--device`` (default the card; raises without one),
with random weights drawn from seed 0 on the device, as the reference's
are. Reductions for a run on one card, printed with the summary:
``--batch`` sets the per-step batch that one card holds (train_4k is
256 x 4096 across a pod) and ``--layers`` keeps the first N layers of
an LM or a GNN (DimeNet's blocks).

A GNN trains full-batch on one fixed graph, re-yielded every step, as
the reference's launcher does (default shape full_graph_sm): for the
feature archs ``random_graph`` at the shape's capacities, for the
geometric ones ``random_geometric_graph`` padded to the edge capacity
(padded edges at the last node) with DimeNet's triplets.

A fault site ``train.step`` is hit after every step (``engine.faults``):
a ``FaultPlan`` crash there stands in for a killed process.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time

import numpy as np
import torch
import torch.utils.deterministic

from repro_torch.checkpoint.checkpoint import (
    CheckpointManager, restore_checkpoint,
)
from repro_torch.configs import get_arch
from repro_torch.data.synthetic import (
    lm_batch_stream, random_geometric_graph, random_graph, recsys_stream,
)
from repro_torch.engine.faults import fault_point
from repro_torch.models import transformer as T
from repro_torch.models.common import resolve_device
from repro_torch.models.gnn.dimenet import build_triplets
from repro_torch.models.recsys import fm as FM
from repro_torch.training.optim import (
    TrainState, tree_leaves, train_state_init,
)
from repro_torch.training.watchdog import Watchdog


def gnn_batch(arch, shape_name: str, smoke: bool) -> dict:
    """The reference launcher's fixed graph for a GNN arch at the shape,
    as numpy arrays."""
    sizes = arch.input_sizes(shape_name, smoke=smoke)
    n = sizes["node_feat" if arch.kind == "feature" else "positions"][0]
    e = sizes["senders"][0]
    if arch.kind == "feature":
        return random_graph(n, e, sizes["node_feat"][1],
                            n_classes=arch.n_classes)
    g = random_geometric_graph(n, max_edges=e)
    ns = np.full(e, n - 1, np.int32)
    ns[:len(g["senders"])] = g["senders"]
    nr = np.full(e, n - 1, np.int32)
    nr[:len(g["receivers"])] = g["receivers"]
    order = np.argsort(nr, kind="stable")
    batch = {"positions": g["positions"], "species": g["species"],
             "senders": ns[order], "receivers": nr[order],
             "energy_labels": g["energy_labels"]}
    if "t_kj" in sizes:
        batch["t_kj"], batch["t_ji"] = build_triplets(
            batch["senders"], batch["receivers"], sizes["t_kj"][0])
    return batch


def make_batches(arch, shape_name: str, smoke: bool, device,
                 batch: int | None = None):
    """The step-seeded batch stream of the shape (its batch cut to
    ``batch`` rows when given), as tensors on ``device``; for a GNN the
    one graph of ``gnn_batch``, re-yielded."""
    if arch.family == "gnn":
        if batch is not None:
            raise ValueError("--batch cuts an LM's or FM's batch; a GNN "
                             "trains on one whole graph")
        graph = {k: torch.from_numpy(v).to(device)
                 for k, v in gnn_batch(arch, shape_name, smoke).items()}
        while True:
            yield graph
    sizes = arch.input_sizes(shape_name, smoke=smoke)
    cfg = arch.smoke_cfg if smoke else arch.cfg
    if arch.family == "lm":
        b, seq = sizes["tokens"]
        stream = lm_batch_stream(batch or b, seq, cfg.vocab)
        keys = ("tokens", "labels")
    else:
        b, n_fields = sizes["ids"]
        stream = recsys_stream(batch or b, n_fields, cfg.vocab)
        keys = ("ids", "labels")
    for item in stream:
        yield {k: torch.from_numpy(item[k]).to(device) for k in keys}


def build_model(arch, smoke: bool, device, seed: int = 0,
                shape_name: str | None = None):
    """A trainable model of the config with weights drawn from ``seed``
    on ``device`` (a GNN's config is the one of ``shape_name``)."""
    gen = torch.Generator(device).manual_seed(seed)
    if arch.family == "gnn":
        cfg = arch.config(shape_name, smoke)
        return arch.model_fn(cfg, arch.init_fn(cfg, gen), device,
                             train=True)
    cfg = arch.smoke_cfg if smoke else arch.cfg
    if arch.family == "recsys":
        return FM.FM(cfg, FM.init_params(cfg, gen), device, train=True)
    return T.Transformer(cfg, T.init_params(cfg, gen), device, train=True)


def cut_layers(arch, layers: int):
    """The arch with both configs (a GNN: every config it makes) cut to
    their first ``layers`` layers."""
    if arch.family == "gnn":
        return dataclasses.replace(arch, layers=layers)
    return dataclasses.replace(
        arch, cfg=dataclasses.replace(arch.cfg, n_layers=layers),
        smoke_cfg=dataclasses.replace(arch.smoke_cfg, n_layers=layers))


def restore_into(model, state: TrainState, directory) -> tuple:
    """The newest checkpoint under ``directory`` restored into the model's
    parameters (in place) and a fresh state -> (state, step)."""
    restored, step = restore_checkpoint(directory, state)
    with torch.no_grad():
        for p, r in zip(tree_leaves(model.param_tree()),
                        tree_leaves(restored.params)):
            p.copy_(r)
    return TrainState(model.param_tree(), restored.mu, restored.nu,
                      restored.step), step


@contextlib.contextmanager
def deterministic(device: torch.device):
    """torch's deterministic algorithms for the block, on the card with
    cuBLAS's fixed workspace (which must be chosen before cuBLAS first
    runs: it is set here unless the environment has it). The mode's
    filling of every new tensor with NaN is turned off: it only guards
    reads of unwritten memory, which no op of the step makes, and it
    would add a write pass to every op's output."""
    if device.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    fill = torch.utils.deterministic
    before = (torch.are_deterministic_algorithms_enabled(),
              fill.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    fill.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0])
        fill.fill_uninitialized_memory = before[1]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=None,
                    help="reduction: the per-step batch (default the "
                         "shape's)")
    ap.add_argument("--layers", type=int, default=None,
                    help="reduction: keep an LM's or a GNN's first N "
                         "layers")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    if args.layers is not None:
        if arch.family == "recsys":
            raise ValueError("--layers cuts an LM's or a GNN's depth")
        arch = cut_layers(arch, args.layers)
    shape_name = args.shape or {"lm": "train_4k", "gnn": "full_graph_sm"
                                }.get(arch.family, "train_batch")
    device = resolve_device(args.device, "launch.train")
    reduced = {k: v for k, v in (("batch", args.batch),
                                 ("layers", args.layers)) if v is not None}

    with deterministic(device):
        model = build_model(arch, args.smoke, device,
                            shape_name=shape_name)
        state = train_state_init(model.param_tree())
        step_fn = arch.step_fn(shape_name, smoke=args.smoke)
        ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
        start = 0
        if args.resume and ckpt and ckpt.latest_step() is not None:
            state, start = restore_into(model, state, args.ckpt_dir)
            print(f"resumed from step {start}")

        wd = Watchdog()
        batches = make_batches(arch, shape_name, args.smoke, device,
                               args.batch)
        # skip already-consumed batches deterministically
        for _ in range(start):
            next(batches)

        losses = []
        t0 = time.time()
        for step in range(start, args.steps):
            batch = next(batches)
            wd.start()
            state, metrics = step_fn(model, state, batch)
            loss = float(metrics["loss"])
            wd.stop(step)
            losses.append(loss)
            if step % args.log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"({(time.time() - t0):.1f}s)", flush=True)
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save_async(step + 1, state)
            fault_point("train.step")
        if ckpt:
            ckpt.save_async(args.steps, state)
            ckpt.wait()
    summary = {
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "steps": len(losses),
        "straggles": len(wd.straggles),
        "wall_s": time.time() - t0,
    }
    print(summary if not reduced else f"{summary} reduced {reduced}")
    return summary


if __name__ == "__main__":
    main()
