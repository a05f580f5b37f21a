"""GNN substrate, after ``repro.models.gnn.common``: graphs as edge
relations and monoid aggregation.

One propagation layer is the Datalog rule
``h'(v, SUM(m)) :- edge(u, v), h(u, m)``: a join on the edge relation
(``gather``) followed by a keyed aggregation in the (R^d, +) monoid
(``aggregate``), over the edges arranged by destination once a graph
(``arrange_by_receiver``) and shared by every layer. ``aggregate`` and
``segment_softmax`` run through ``kernels.segment_reduce``: the
hand-written CUDA kernel on CUDA tensors, its plain torch version on CPU
tensors, differentiable either way. There is no ``backend`` option: the
device picks the route, as in the rest of the port.

On a mesh (a DTensor graph, its edge relations over the data axes as
``GNNArch.shardings`` lays them out) a segment reduction runs through
``local_map``: each device reduces its edges into a node-sized partial
(sum, max or min), reduced at once (the nodes are whole on every
device); ``gather`` of node rows at sharded edge ids runs through
``local_map`` too, each device taking its edges' rows.

The kernel needs sorted ids, which JAX's ``segment_sum`` does not: the
models call ``check_sorted`` on the ids they aggregate over, which reads
the device once for a tensor (and again only after an in-place edit), so
a graph re-used across steps is checked once.

Graphs are fixed-capacity (padded) like engine relations: padded edges
point at a sacrificial node slot so their contributions drop.

``GNNModel`` holds the reference's parameter tree (top-level leaves and
one subtree of per-layer leaves stacked [L, ...], "layers" or "blocks")
as parameters: a layer's parameters are views of the stacked leaves, so
``param_tree()`` is the reference's tree sharing their storage and an
update of the tree updates the model; ``grad_tree()`` gives zeroed
buffers in the same layout wired as the parameters' ``.grad``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels import segment_reduce as SR
from repro_torch.models.common import (
    parameter, redistributed, replicated, resolve_device, settle, wire_grads,
)
from repro_torch.training.optim import tree_map


class Graph(NamedTuple):
    senders: torch.Tensor           # [E] int32 (sorted by receivers)
    receivers: torch.Tensor         # [E] int32 sorted ascending
    node_feat: torch.Tensor         # [N, F] (or positions [N, 3])
    edge_feat: Optional[torch.Tensor]   # [E, Fe] or None
    n_node: int                     # live prefix
    n_edge: int


def check_sorted(ids: torch.Tensor, what: str = "receivers") -> None:
    """Raises unless ``ids`` is sorted ascending. One device read a
    tensor: a tensor found sorted is marked with its version counter and
    not read again until it is written in place. A meta tensor (a dry
    run) has no values to read and passes."""
    if ids.device.type == "meta" or getattr(
            ids, "_sorted_at_version", None) == ids._version:
        return
    if ids.numel() > 1 and not bool((ids[1:] >= ids[:-1]).all()):
        raise ValueError(f"{what}: ids not sorted ascending; arrange the "
                         f"edges with arrange_by_receiver")
    ids._sorted_at_version = ids._version


def arrange_by_receiver(senders, receivers, *edge_payloads):
    """The arrangement: the edge relation sorted by destination (a stable
    sort, as ``jnp.argsort``), so that aggregation is a sorted-segment
    reduce. Done once a graph, shared by every layer."""
    order = torch.argsort(receivers, stable=True)
    out = [senders[order], receivers[order]]
    for p in edge_payloads:
        out.append(p[order] if p is not None else None)
    return tuple(out)


def aggregate(messages: torch.Tensor, receivers: torch.Tensor,
              n_nodes: int, op: str = "sum") -> torch.Tensor:
    """messages [E, d] sorted by receiver -> [n_nodes, d]: the vector-
    monoid merge, through the segment-reduce kernel."""
    return segment_reduce(messages, receivers, n_nodes, op)


def segment_reduce(values: torch.Tensor, ids: torch.Tensor, n: int,
                   op: str) -> torch.Tensor:
    """``kernels.segment_reduce.segment_reduce``; on DTensors through
    ``local_map``: ``values`` follow the rows of ``ids`` (their shards on
    the dims where the ids are sharded, whole elsewhere), each device
    reduces its rows into a partial ``op`` of the [n, ...] result, and
    the partials are reduced (``settle``: the nodes are whole on every
    device)."""
    if not isinstance(ids, DTensor):
        return SR.segment_reduce(values, ids, n, op)
    mesh = ids.device_mesh
    values = replicated(values, ids)
    rows = tuple(p if p == Shard(0) else Replicate() for p in ids.placements)
    ids, values = redistributed(ids, rows), redistributed(values, rows)
    out = tuple(Partial(op) if p == Shard(0) else p for p in rows)
    return settle(local_map(lambda v, i: SR.segment_reduce(v, i, n, op),
                            out_placements=list(out),
                            in_placements=(rows, rows),
                            device_mesh=mesh)(values, ids))


def degree(receivers: torch.Tensor, n_nodes: int) -> torch.Tensor:
    ones = torch.ones((receivers.shape[0], 1), dtype=torch.float32,
                      device=receivers.device)
    return aggregate(ones, receivers, n_nodes, "sum")[:, 0]


def gather(node_values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The join side, edge(u, v) joined with h(u): rows of
    ``node_values`` at ``idx``, clamped into [0, n - 1] as
    ``jnp.take(..., mode="clip")`` (never wrapped, never raising). At
    sharded ids each device takes its ids' rows (``by_rows``)."""
    return by_rows(_take, idx, node_values, idx, whole=(0,))


def _take(values: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return values.index_select(0, ids.clamp(0, max(values.shape[0] - 1, 0)))


def by_rows(fn, rows: torch.Tensor, *args, whole=()):
    """``fn(*args)``, whose result has a row for each row of ``rows``
    (edge- or triplet-level). When ``rows`` is a DTensor split on its
    first dim, each device runs ``fn`` on its rows through ``local_map``:
    the tensor args at the indices in ``whole`` (the tables it gathers
    from, weights) whole on every device, their gradients partial sums
    over the devices; the other tensors split as ``rows`` is; the result
    too. DTensor's own rules for these row-local ops break on meshes of
    uneven or nested splits in torch before 2.13."""
    if not isinstance(rows, DTensor) or not any(
            p.is_shard() for p in rows.placements):
        return fn(*args)
    mesh = rows.device_mesh
    split = tuple(p if p == Shard(0) else Replicate() for p in rows.placements)
    everywhere = (Replicate(),) * mesh.ndim
    summed = tuple(Partial() if p == Shard(0) else p for p in split)
    ins, grads, vals = [], [], []
    for i, a in enumerate(args):
        if not isinstance(a, torch.Tensor):
            ins.append(None)
            grads.append(None)
            vals.append(a)
            continue
        want = everywhere if i in whole else split
        a = redistributed(replicated(a, rows), want)
        ins.append(want)
        grads.append(summed if i in whole else split)
        vals.append(a)
    return local_map(fn, out_placements=list(split), in_placements=tuple(ins),
                     in_grad_placements=tuple(grads), device_mesh=mesh)(*vals)


def batched_graph_specs(n_graphs: int, nodes_per: int, edges_per: int,
                        d_feat: int) -> dict:
    """Block-diagonal batching of small graphs (molecule shape): name ->
    (shape, dtype) of the batch's flat node and edge relations."""
    N = n_graphs * nodes_per
    E = n_graphs * edges_per
    return dict(senders=((E,), torch.int32), receivers=((E,), torch.int32),
                node_feat=((N, d_feat), torch.float32),
                graph_ids=((N,), torch.int32))


def segment_softmax(scores: torch.Tensor, receivers: torch.Tensor,
                    n_nodes: int) -> torch.Tensor:
    """Edge softmax grouped by receiver (GAT): segment max -> exp ->
    segment sum. scores [E, H]. A node with no in-edge has max -inf,
    taken as 0."""
    smax = segment_reduce(scores, receivers, n_nodes, "max")
    smax = torch.where(torch.isfinite(smax), smax, 0.0)
    ex = torch.exp(scores - gather(smax, receivers))
    ssum = segment_reduce(ex, receivers, n_nodes, "sum")
    return ex / (gather(ssum, receivers) + 1e-9)


def params_from_numpy(tree: dict, device="cuda") -> dict:
    """The reference's parameter tree as numpy arrays (stacked [L, ...]
    per-layer leaves included) -> float32 tensors on ``device``."""
    return tree_map(lambda a: torch.from_numpy(
        np.array(a, np.float32)).to(device), tree)


class GNNModel(nn.Module):
    """A GNN over the reference's parameter tree (see the module
    docstring): ``params`` from the model's ``init_params`` or
    ``params_from_numpy`` (kept, not copied, when on ``device``); without
    one, drawn from ``generator`` (seed 0 when None). Runs on ``device``
    (default the card; raises when there is none); ``train`` makes the
    parameters trainable. Subclasses set ``STACKED`` (the per-layer
    subtree's key, None for a model without one) and ``init_params`` and
    define ``forward``."""

    STACKED = "layers"

    @staticmethod
    def init_params(cfg, generator: torch.Generator, device=None) -> dict:
        raise NotImplementedError

    def __init__(self, cfg, params: Optional[dict] = None, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 train: bool = False):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device, type(self).__name__)
        if params is None:
            if generator is None:
                generator = torch.Generator(self.device).manual_seed(0)
            params = self.init_params(cfg, generator, self.device)
        self._tree = tree_map(lambda t: t.to(self.device), params)
        self._grads: Optional[dict] = None
        tree = self._tree
        self.top = nn.ParameterDict({k: parameter(v, train)
                                     for k, v in tree.items()
                                     if k != self.STACKED})
        stacked = tree.get(self.STACKED, {})
        depth = (next(iter(stacked.values())).shape[0] if stacked else 0)
        self.stack = nn.ModuleList(
            nn.ParameterDict({k: parameter(v[i], train)
                              for k, v in stacked.items()})
            for i in range(depth))

    def param_tree(self) -> dict:
        """The reference's parameter tree (stacked per-layer leaves),
        sharing storage with this module's parameters."""
        return self._tree

    def _pairs(self, tree: dict):
        for k, p in self.top.items():
            yield p, tree[k]
        for i, layer in enumerate(self.stack):
            for k, p in layer.items():
                yield p, tree[self.STACKED][k][i]

    @property
    def grads(self) -> Optional[dict]:
        """The gradient buffers of ``grad_tree`` as the last backward left
        them (None before the first ``grad_tree``)."""
        return self._grads

    def grad_tree(self) -> dict:
        """Zeroed gradient buffers in the reference's layout, wired as the
        parameters' ``.grad`` (layer i of a stacked buffer is layer i's),
        so that the next backward accumulates into them."""
        if self._grads is None:
            self._grads = tree_map(torch.zeros_like, self._tree)
        wire_grads(self._pairs(self._grads))
        return self._grads
