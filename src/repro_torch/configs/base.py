"""ArchSpecs for the LM, GNN and recsys families, after
``repro.configs.base``: the contract between the configs, the launchers
and the dry run (``launch/dryrun.py``).

Per named input shape an arch gives ``input_specs`` (every input of the
step as a tensor on ``torch.device("meta")``, the port's
``jax.ShapeDtypeStruct``: a shape and a dtype, no memory),
``state_specs`` (the parameters, or a ``TrainState`` of parameters,
float32 moments and a step, the same way), ``step_fn`` (the step:
train, LM prefill and decode, recsys serve and retrieval),
``model_flops`` and ``init_smoke``; and ``shardings(mesh, shape)``, the
reference's partition specs of the step's state, inputs and outputs on a
mesh (``P`` trees: one entry a tensor dim, None or mesh axes; the LM's
from ``param_pspecs``, or ``fsdp_pspecs`` for a train shape of an arch
with ``fsdp_train``). ``place`` lays a tree of tensors out on a
``DeviceMesh`` by its specs (``models.common.placements``). The traffic
models at the end reckon a step's HBM bytes on one device of a mesh
(``ONE_CARD``, the 1 x 1 mesh, for a run on one card).

A train step is ``train_step(model, state, batch) -> (state, metrics)``:
the model (built with ``train=True``) holds the parameters, ``state`` is
a ``TrainState`` whose params are the model's ``param_tree()``, and the
step runs the loss with gradients into the model's ``grad_tree()``, then
``adamw_update``, which writes the parameters (so the model) and the
moments in place. Metrics stay on the device: {"loss", "ce", "gnorm"}
(LM), {"loss", "gnorm"} (GNN, recsys), as the reference's. A serve step
is ``step(model, batch)``; every step checks that the model is of the
config it was made for.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, ClassVar, Optional

import torch

from repro_torch.models import transformer as T
from repro_torch.models.common import (
    P, axes_of, cross_entropy_loss, mesh_axes, placements,
)
from repro_torch.models.gnn import dimenet, nequip
from repro_torch.models.gnn.common import Graph
from repro_torch.models.recsys import fm as FM
from repro_torch.training.optim import (
    AdamWConfig, TrainState, adamw_update, train_state_init, tree_leaves,
)

META = torch.device("meta")


def _spec(shape, dtype: torch.dtype) -> torch.Tensor:
    """A shape and a dtype, no memory: the port's ShapeDtypeStruct."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, without devices: what the specs and
    the traffic models read of a mesh."""
    axis_names: tuple
    axis_sizes: tuple


ONE_CARD = AbstractMesh(("data", "model"), (1, 1))


def data_axes(mesh) -> tuple:
    """Batch-parallel axes: ('pod', 'data') on the multi-pod mesh."""
    names = tuple(mesh_axes(mesh))
    return tuple(a for a in ("pod", "data") if a in names)


def _dax(mesh):
    d = data_axes(mesh)
    return d if len(d) > 1 else (d[0] if d else None)


def _n_devices(mesh) -> int:
    return math.prod(mesh_axes(mesh).values())


def _is_leaf(x) -> bool:
    return isinstance(x, P) or not isinstance(x, (dict, list, tuple))


def spec_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of ``rest``, trees of its
    structure): a leaf is a spec (``P``), a tensor or None; dicts, lists,
    tuples and NamedTuples (``TrainState``, ``KVCache``) keep their
    structure."""
    if _is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: spec_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    vals = [spec_map(fn, *xs) for xs in zip(tree, *rest)]
    return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)


def spec_leaves(tree) -> list:
    """The leaves of ``spec_map``'s trees, in its order."""
    out = []
    spec_map(out.append, tree)
    return out


def place(tree, spec_tree, mesh):
    """A tree of tensors as DTensors on ``mesh`` by their specs
    (``models.common.placements``): each tensor is the whole (global)
    tensor, sharded by ``distribute_tensor`` (on the meta device, where
    it holds no values, it is cut to the local shard's shape instead). A
    dim that its mesh dims' product does not divide stays whole, as
    ``maybe_shard`` keeps it."""
    from torch.distributed.tensor import (
        DTensor, Replicate, Shard, distribute_tensor,
    )
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    def one(t, spec):
        if t is None:
            return None
        where = placements(spec, mesh)
        where = tuple(
            Replicate() if isinstance(p, Shard) and t.shape[p.dim] % math.prod(
                mesh.size(i) for i, q in enumerate(where) if q == p) else p
            for p in where)
        if t.device.type != "meta":
            return distribute_tensor(t, mesh, where)
        local, _ = compute_local_shape_and_global_offset(t.shape, mesh, where)
        return DTensor.from_local(
            torch.empty(local, dtype=t.dtype, device=t.device), mesh, where,
            run_check=False, shape=t.shape, stride=t.stride())
    return spec_map(one, tree, spec_tree)


def _sizes(specs: dict) -> dict:
    """Input name -> shape of the tensors among ``specs``."""
    return {k: tuple(v.shape) for k, v in specs.items()
            if isinstance(v, torch.Tensor)}


@dataclass(frozen=True)
class Shape:
    name: str
    kind: str       # train | prefill | decode | recsys_{train,serve,retrieval}
    sizes: dict
    note: str = ""


LM_SHAPES = {
    "train_4k": Shape("train_4k", "train",
                      dict(seq_len=4096, global_batch=256)),
    "prefill_32k": Shape("prefill_32k", "prefill",
                         dict(seq_len=32768, global_batch=32)),
    "decode_32k": Shape("decode_32k", "decode",
                        dict(seq_len=32768, global_batch=128)),
    "long_500k": Shape(
        "long_500k", "decode", dict(seq_len=524288, global_batch=1),
        note=("long-context DECODE lowers (O(L) per token, KV sharded); "
              "prefill at 500k would need sub-quadratic attention, which "
              "no assigned LM arch has — see DESIGN.md")),
}


def _layout_free(cfg):
    """An LM config without its mesh layout (``seq_parallel``,
    ``batch_shard_all``), which changes no parameter and no value."""
    if dataclasses.is_dataclass(cfg):
        return dataclasses.replace(cfg, seq_parallel=False,
                                   batch_shard_all=False)
    return cfg


def _check_model(model, cfg, shape_name: str) -> None:
    if _layout_free(model.cfg) != _layout_free(cfg):
        raise ValueError(f"{shape_name}: model config {model.cfg}, step "
                         f"made for {cfg}")


def _check_state(model, state: TrainState, shape_name: str) -> None:
    """The model must be trainable and the state's parameters its own
    (the step updates them through the state)."""
    if not all(p.requires_grad for p in model.parameters()):
        raise ValueError(f"{shape_name}: the model is frozen; a train step "
                         f"takes a model built with train=True")
    if state.params is not model.param_tree():
        raise ValueError(f"{shape_name}: the state's params are not the "
                         f"model's param_tree()")


@dataclass(frozen=True)
class LMArch:
    name: str
    cfg: T.TransformerConfig
    smoke_cfg: T.TransformerConfig
    family: ClassVar[str] = "lm"
    opt: AdamWConfig = AdamWConfig()
    # the reference's beyond-paper train sharding: train_4k shards the
    # parameters over every mesh axis (ZeRO-3 / FSDP) and the batch over
    # them all (``fsdp_pspecs``; the model's ``batch_shard_all``)
    fsdp_train: bool = False

    @property
    def shapes(self):
        return LM_SHAPES

    def step_cfg(self, shape_name: str, smoke: bool = False):
        """The config a step of the shape runs: ``batch_shard_all`` set
        for a train shape of an ``fsdp_train`` arch at full size, as the
        reference's ``step_fn`` sets it. It differs from ``cfg`` only in
        the mesh layout, so a model of either runs the step."""
        cfg = self.smoke_cfg if smoke else self.cfg
        if (self.shapes[shape_name].kind == "train" and self.fsdp_train
                and not smoke):
            cfg = dataclasses.replace(cfg, batch_shard_all=True)
        return cfg

    # -- shardings -----------------------------------------------------------
    def param_pspecs(self, mesh, smoke: bool = False) -> dict:
        """The reference's tensor- and expert-parallel specs of the
        parameter tree: attention and FFN weights split over "model" (the
        q/k/v columns, wo's rows), the embedding's rows and the unembedding's
        columns too; an MoE's experts over "model" when their count
        divides it, else each expert's d_ff (granite-3b: 40 experts on a
        16-way axis). ``smoke`` takes the smoke config's."""
        cfg = self.smoke_cfg if smoke else self.cfg
        m = "model"
        lay = {"wq": P(None, None, m), "wk": P(None, None, m),
               "wv": P(None, None, m), "wo": P(None, m, None),
               "ln1": P(None, None), "ln2": P(None, None)}
        if cfg.qk_norm:
            lay["qnorm"] = P(None, None)
            lay["knorm"] = P(None, None)
        if cfg.moe:
            msize = mesh_axes(mesh)[m]
            if cfg.moe.n_experts % msize == 0:
                moe = {"router": P(None, None, None),
                       "w_in": P(None, m, None, None),
                       "w_out": P(None, m, None, None)}
                if cfg.moe.glu:
                    moe["w_gate"] = P(None, m, None, None)
            else:
                moe = {"router": P(None, None, None),
                       "w_in": P(None, None, None, m),
                       "w_out": P(None, None, m, None)}
                if cfg.moe.glu:
                    moe["w_gate"] = P(None, None, None, m)
            lay["moe"] = moe
        else:
            lay["w_in"] = P(None, None, m)
            lay["w_out"] = P(None, m, None)
            if cfg.glu:
                lay["w_gate"] = P(None, None, m)
        specs = {"embed": P(m, None), "ln_f": P(None), "layers": lay}
        if not cfg.tie_embeddings:
            specs["unembed"] = P(None, m)
        return specs

    def fsdp_pspecs(self, mesh, smoke: bool = False) -> dict:
        """Every weight over ALL mesh axes on its first divisible dim
        after the layer stack (then the stack itself); small leaves
        (norms) whole. ``smoke`` takes the smoke config's."""
        all_ax = tuple(mesh_axes(mesh))
        n_all = _n_devices(mesh)

        def spec_for(leaf):
            for dim in range(1, leaf.ndim):          # dim 0: the stack
                if leaf.shape[dim] % n_all == 0:
                    ent = [None] * leaf.ndim
                    ent[dim] = all_ax
                    return P(*ent)
            if leaf.ndim and leaf.shape[0] % n_all == 0:
                ent = [None] * leaf.ndim
                ent[0] = all_ax
                return P(*ent)
            return P(*([None] * leaf.ndim))

        return spec_map(spec_for,
                        self.state_specs("train_4k", smoke).params)

    def shardings(self, mesh, shape_name: str, smoke: bool = False):
        """((state specs, batch specs), output specs) of the shape's step,
        the reference's: the batch over the data axes (when it is more
        than 1); train the state over ``param_pspecs`` (or
        ``fsdp_pspecs``, the batch then over every axis when it divides);
        prefill logits over "model"; decode the KV cache's sequence over
        "model", or over every axis when the batch is 1 (long_500k).
        ``smoke`` takes the smoke config's parameters (the shape's batch
        decides the layout, as at full size)."""
        d = data_axes(mesh)
        dax = _dax(mesh)
        pspecs = self.param_pspecs(mesh, smoke)
        sh = self.shapes[shape_name]
        b = sh.sizes["global_batch"]
        batch_ax = dax if b > 1 else None
        if sh.kind == "train":
            if self.fsdp_train:
                pspecs = self.fsdp_pspecs(mesh, smoke)
                if b % _n_devices(mesh) == 0:
                    batch_ax = tuple(mesh_axes(mesh))
            state = TrainState(pspecs, spec_map(lambda s: s, pspecs),
                               spec_map(lambda s: s, pspecs), P())
            batch = dict(tokens=P(batch_ax, None), labels=P(batch_ax, None))
            out = (state, {"loss": P(), "ce": P(), "gnorm": P()})
            return (state, batch), out
        if sh.kind == "prefill":
            batch = dict(tokens=P(batch_ax, None))
            out = (P(batch_ax, "model"), P(batch_ax))
            return (pspecs, batch), out
        if b == 1:
            seq_ax = tuple(list(d) + ["model"])
            cache = T.KVCache(k=P(None, None, None, seq_ax, None),
                              v=P(None, None, None, seq_ax, None),
                              length=P(None))
            batch = dict(token=P(None, None), cache=cache)
            return (pspecs, batch), (P(None, "model"), cache)
        cache = T.KVCache(k=P(None, batch_ax, None, "model", None),
                          v=P(None, batch_ax, None, "model", None),
                          length=P(batch_ax))
        batch = dict(token=P(batch_ax, None), cache=cache)
        return (pspecs, batch), (P(batch_ax, "model"), cache)

    def input_specs(self, shape_name: str, smoke: bool = False,
                    batch: Optional[int] = None) -> dict:
        """The step's inputs as meta tensors, as the reference's: train
        {tokens, labels} [b, seq] int32, prefill {tokens}, decode {token
        [b, 1] int32, cache: a ``KVCache`` of capacity seq, k and v [L,
        b, hkv, seq, hd] in the compute dtype, length [b] int32}. Smoke
        cuts the sequence to 128 and the batch to 4; ``batch`` replaces
        the batch (a run on one card takes a cut of it)."""
        cfg = self.smoke_cfg if smoke else self.cfg
        sh = self.shapes[shape_name]
        seq, b = sh.sizes["seq_len"], sh.sizes["global_batch"]
        if smoke:
            seq, b = min(seq, 128), min(b, 4)
        if batch is not None:
            b = batch
        i32 = torch.int32
        if sh.kind == "train":
            return dict(tokens=_spec((b, seq), i32),
                        labels=_spec((b, seq), i32))
        if sh.kind == "prefill":
            return dict(tokens=_spec((b, seq), i32))
        kv = (cfg.n_layers, b, cfg.n_kv_heads, seq, cfg.hd)
        return dict(token=_spec((b, 1), i32), cache=T.KVCache(
            k=_spec(kv, cfg.compute_dtype), v=_spec(kv, cfg.compute_dtype),
            length=_spec((b,), i32)))

    def input_sizes(self, shape_name: str, smoke: bool = False) -> dict:
        """Input name -> shape of the tensor inputs of ``input_specs``
        (the decode's cache aside)."""
        return _sizes(self.input_specs(shape_name, smoke))

    def state_specs(self, shape_name: str, smoke: bool = False):
        """The step's state as meta tensors: the parameter tree of
        ``init_params``, and for a train shape a ``TrainState`` of it,
        float32 moments and an int32 step."""
        cfg = self.smoke_cfg if smoke else self.cfg
        params = T.init_params(cfg, torch.Generator(), device=META)
        if self.shapes[shape_name].kind == "train":
            return train_state_init(params)
        return params

    def init_smoke(self, generator: torch.Generator) -> dict:
        """Parameters of the smoke config, drawn from ``generator`` on
        its device."""
        return T.init_params(self.smoke_cfg, generator)

    def model_flops(self, shape_name: str,
                    global_batch: Optional[int] = None) -> float:
        """The reference's count from the active parameters N (an MoE's
        top-k experts): 6 N a token to train, 2 N to prefill, 2 N a new
        token to decode; ``global_batch`` replaces the shape's batch
        (a run on one card takes a cut of it)."""
        sh = self.shapes[shape_name]
        n = self.cfg.active_param_count()
        b = sh.sizes["global_batch"] if global_batch is None else global_batch
        if sh.kind == "decode":
            return 2.0 * n * b
        return (6.0 if sh.kind == "train" else 2.0) * n * sh.sizes[
            "seq_len"] * b

    def step_fn(self, shape_name: str, smoke: bool = False) -> Callable:
        """The step of a shape; the model must be a ``Transformer`` of the
        config that ``smoke`` picks. A train shape gives
        ``train_step(model, state, batch)`` (the model built with
        ``train=True``; a dense or an MoE FFN, whose loss adds 0.01 times
        its load-balancing loss); prefill ``serve_prefill(model, batch)
        -> (last-position logits [b, V], cache.length)``; decode
        ``serve_decode(model, batch) -> (logits [b, V], cache)``, which
        writes the token's K and V into ``batch["cache"]`` in place, as
        the reference's ``serve_prefill`` and ``serve_decode``."""
        cfg = self.step_cfg(shape_name, smoke)
        kind = self.shapes[shape_name].kind
        opt = self.opt
        if kind == "prefill":
            def serve_prefill(model, batch):
                _check_model(model, cfg, shape_name)
                logits, cache = model.prefill(batch["tokens"])
                return logits, cache.length
            return serve_prefill
        if kind == "decode":
            def serve_decode(model, batch):
                _check_model(model, cfg, shape_name)
                return model.decode_step(batch["token"], batch["cache"])
            return serve_decode

        def train_step(model, state: TrainState, batch):
            _check_model(model, cfg, shape_name)
            _check_state(model, state, shape_name)
            grads = model.grad_tree()
            loss, ce = model.loss_fn(batch["tokens"], batch["labels"],
                                     layout=cfg)
            loss.backward()
            state, gnorm = adamw_update(state, grads, opt)
            return state, {"loss": loss.detach(), "ce": ce.detach(),
                           "gnorm": gnorm}
        return train_step


# -- GNN family ----------------------------------------------------------------

def _fanout_caps(batch_nodes=1024, fanouts=(15, 10)):
    """Fixed capacities for the fanout-sampled subgraph (minibatch_lg)."""
    nodes, edges, frontier = batch_nodes, 0, batch_nodes
    for f in fanouts:
        new = frontier * f
        edges += new
        nodes += new
        frontier = new
    return nodes, edges


GNN_SHAPES = {
    "full_graph_sm": Shape(
        "full_graph_sm", "graph",
        dict(n_nodes=2708, n_edges=10556, d_feat=1433, triplet_mult=8)),
    "minibatch_lg": Shape(
        "minibatch_lg", "graph",
        dict(n_nodes=_fanout_caps()[0], n_edges=_fanout_caps()[1],
             d_feat=602, triplet_mult=4,
             base_nodes=232965, base_edges=114615892,
             batch_nodes=1024, fanout=(15, 10)),
        note="fixed-capacity fanout-(15,10) sampled subgraph; sampler in "
             "repro_torch.data.sampler"),
    "ogb_products": Shape(
        "ogb_products", "graph",
        dict(n_nodes=2449029, n_edges=61859140, d_feat=100,
             triplet_mult=2)),
    "molecule": Shape(
        "molecule", "graph",
        dict(n_nodes=30 * 128, n_edges=64 * 128, d_feat=16,
             triplet_mult=16, batch=128)),
}


@dataclass(frozen=True)
class GNNArch:
    """A GNN arch: its config depends on the shape's feature width
    (``make_cfg(d_feat, smoke)``), unlike an LM's. ``init_fn(cfg,
    generator)`` draws the reference's parameter tree, ``model_fn(cfg,
    params, device, train)`` builds the model over it. ``layers``, when
    set, cuts the depth (n_layers, or n_blocks for DimeNet) of every
    config the arch makes (``launch.train --layers``)."""
    name: str
    kind: str                    # "feature" (gatedgcn, gat) | "geometric"
    make_cfg: Callable
    init_fn: Callable
    model_fn: Callable
    n_classes: int = 16
    family: ClassVar[str] = "gnn"
    opt: AdamWConfig = AdamWConfig(lr=1e-3)
    layers: Optional[int] = None
    shard_nodes: bool = False   # the reference's perf option (gatedgcn)

    @property
    def shapes(self):
        return GNN_SHAPES

    def _dims(self, shape_name: str, smoke: bool) -> dict:
        """The shape's sizes; smoke cuts nodes to 64, edges to 256 and
        features to 24; node and edge capacities round up to multiples of
        32 (padded edges target a sacrificial node slot; padded nodes are
        isolated), as the reference's."""
        s = dict(self.shapes[shape_name].sizes)
        if smoke:
            s["n_nodes"] = min(s["n_nodes"], 64)
            s["n_edges"] = min(s["n_edges"], 256)
            s["d_feat"] = min(s["d_feat"], 24)
        s["n_edges"] = ((s["n_edges"] + 31) // 32) * 32
        s["n_nodes"] = ((s["n_nodes"] + 31) // 32) * 32
        return s

    def config(self, shape_name: str, smoke: bool = False):
        """The model config of a shape (its depth cut to ``layers``)."""
        cfg = self.make_cfg(self._dims(shape_name, smoke)["d_feat"], smoke)
        if self.shard_nodes and not smoke and "shard_nodes" in getattr(
                cfg, "_fields", ()):
            cfg = cfg._replace(shard_nodes=True)
        if self.layers is not None:
            depth = "n_blocks" if hasattr(cfg, "n_blocks") else "n_layers"
            cfg = cfg._replace(**{depth: self.layers})
        return cfg

    def input_specs(self, shape_name: str, smoke: bool = False) -> dict:
        """The step's inputs as meta tensors, as the reference's:
        senders, receivers [E] int32; feature archs node_feat [N, d_feat],
        edge_feat [E, 1] float32 and labels [N] int32; geometric archs
        positions [N, 3] float32, species [N] int32, energy_labels [N]
        float32, and for DimeNet t_kj, t_ji [E triplet_mult] int32."""
        s = self._dims(shape_name, smoke)
        N, E = s["n_nodes"], s["n_edges"]
        i32, f32 = torch.int32, torch.float32
        specs = dict(senders=_spec((E,), i32), receivers=_spec((E,), i32))
        if self.kind == "feature":
            specs.update(node_feat=_spec((N, s["d_feat"]), f32),
                         edge_feat=_spec((E, 1), f32),
                         labels=_spec((N,), i32))
        else:
            specs.update(positions=_spec((N, 3), f32),
                         species=_spec((N,), i32),
                         energy_labels=_spec((N,), f32))
            if self.name == "dimenet":
                T_ = E * s.get("triplet_mult", 4)
                specs.update(t_kj=_spec((T_,), i32), t_ji=_spec((T_,), i32))
        return specs

    def input_sizes(self, shape_name: str, smoke: bool = False) -> dict:
        """Input name -> shape of ``input_specs``."""
        return _sizes(self.input_specs(shape_name, smoke))

    def state_specs(self, shape_name: str, smoke: bool = False):
        """The train state as meta tensors: a ``TrainState`` of the
        config's parameter tree, float32 moments and an int32 step."""
        return train_state_init(self.init_fn(
            self.config(shape_name, smoke), torch.Generator(), device=META))

    def init_smoke(self, generator: torch.Generator,
                   shape_name: str = "full_graph_sm"):
        """(parameters, config) of the smoke config at the shape, drawn
        from ``generator`` on its device."""
        cfg = self.config(shape_name, True)
        return self.init_fn(cfg, generator), cfg

    def model_flops(self, shape_name: str) -> float:
        """The reference's count: about 2 (E + N) d^2 a layer, times 3
        for the forward and backward."""
        s = self.shapes[shape_name].sizes
        cfg = self.config(shape_name, False)
        d = getattr(cfg, "d_hidden", getattr(cfg, "channels", 64))
        L = getattr(cfg, "n_layers", getattr(cfg, "n_blocks", 2))
        return 2.0 * (s["n_edges"] + s["n_nodes"]) * d * d * L * 3

    def shardings(self, mesh, shape_name: str):
        """((state specs, batch specs), output specs), the reference's:
        the state whole on every device; the edge relations (senders,
        receivers, edge features, triplets) over the data axes, the node
        relations whole."""
        dax = _dax(mesh)
        pspec = spec_map(lambda _: P(), self.state_specs(shape_name))
        batch = {}
        for k, v in self.input_specs(shape_name).items():
            if k in ("senders", "receivers", "t_kj", "t_ji", "edge_feat"):
                batch[k] = P(dax) if v.ndim == 1 else P(dax, None)
            else:
                batch[k] = P(*([None] * v.ndim))
        return (pspec, batch), (pspec, {"loss": P(), "gnorm": P()})

    def loss_fn(self, shape_name: str, smoke: bool = False) -> Callable:
        """``loss(model, batch)``, with gradients: cross-entropy of the
        node logits against ``labels`` (feature archs) or the mean squared
        error of the per-node energy against ``energy_labels`` (geometric
        archs), as the reference's train step computes it."""
        kind, name = self.kind, self.name

        def loss(model, batch):
            if kind == "feature":
                g = Graph(batch["senders"], batch["receivers"],
                          batch["node_feat"], batch.get("edge_feat"),
                          batch["node_feat"].shape[0],
                          batch["senders"].shape[0])
                return cross_entropy_loss(model(g), batch["labels"])
            if name == "dimenet":
                g = dimenet.GeoGraph(batch["positions"], batch["species"],
                                     batch["senders"], batch["receivers"],
                                     batch["t_kj"], batch["t_ji"])
            else:
                g = nequip.GeoGraph(batch["positions"], batch["species"],
                                    batch["senders"], batch["receivers"])
            err = model(g) - batch["energy_labels"]
            return torch.mean(err * err)
        return loss

    def step_fn(self, shape_name: str, smoke: bool = False) -> Callable:
        """``train_step(model, state, batch)``: ``loss_fn``'s loss, its
        gradients, then AdamW; the model must be of the config the shape
        and ``smoke`` give, built with ``train=True``."""
        cfg = self.config(shape_name, smoke)
        opt = self.opt
        loss = self.loss_fn(shape_name, smoke)

        def train_step(model, state: TrainState, batch):
            _check_model(model, cfg, shape_name)
            _check_state(model, state, shape_name)
            grads = model.grad_tree()
            value = loss(model, batch)
            value.backward()
            state, gnorm = adamw_update(state, grads, opt)
            return state, {"loss": value.detach(), "gnorm": gnorm}
        return train_step


RECSYS_SHAPES = {
    "train_batch": Shape("train_batch", "recsys_train",
                         dict(batch=65536)),
    "serve_p99": Shape("serve_p99", "recsys_serve", dict(batch=512)),
    "serve_bulk": Shape("serve_bulk", "recsys_serve",
                        dict(batch=262144)),
    "retrieval_cand": Shape("retrieval_cand", "recsys_retrieval",
                            dict(batch=1, n_candidates=1_000_000)),
}


@dataclass(frozen=True)
class RecsysArch:
    name: str
    cfg: FM.FMConfig
    smoke_cfg: FM.FMConfig
    family: ClassVar[str] = "recsys"
    opt: AdamWConfig = AdamWConfig(lr=1e-3, weight_decay=0.0)

    @property
    def shapes(self):
        return RECSYS_SHAPES

    def input_specs(self, shape_name: str, smoke: bool = False) -> dict:
        """The step's inputs as meta tensors (int32 ids and labels), as
        the reference's: retrieval {context_ids [n_fields], candidate_ids
        [C]}, serve {ids [B, n_fields]}, train also {labels [B]}; smoke
        cuts the batch to 32 rows and the candidates to 1024."""
        cfg = self.smoke_cfg if smoke else self.cfg
        sh = self.shapes[shape_name]
        s = dict(sh.sizes)
        if smoke:
            s["batch"] = min(s["batch"], 32)
            if "n_candidates" in s:
                s["n_candidates"] = min(s["n_candidates"], 1024)
        i32 = torch.int32
        if sh.kind == "recsys_retrieval":
            return dict(context_ids=_spec((cfg.n_fields,), i32),
                        candidate_ids=_spec((s["n_candidates"],), i32))
        specs = dict(ids=_spec((s["batch"], cfg.n_fields), i32))
        if sh.kind == "recsys_train":
            specs["labels"] = _spec((s["batch"],), i32)
        return specs

    def input_sizes(self, shape_name: str, smoke: bool = False) -> dict:
        """Input name -> shape of ``input_specs``."""
        return _sizes(self.input_specs(shape_name, smoke))

    def state_specs(self, shape_name: str, smoke: bool = False):
        """The step's state as meta tensors: the FM parameters, and for
        train_batch a ``TrainState`` of them, float32 moments and an int32
        step."""
        cfg = self.smoke_cfg if smoke else self.cfg
        params = FM.init_params(cfg, torch.Generator(), device=META)
        if self.shapes[shape_name].kind == "recsys_train":
            return train_state_init(params)
        return params

    def model_flops(self, shape_name: str) -> float:
        """The reference's count: 4 n_fields k a row by the sum-square
        trick (times 3 to train), 2 C k for retrieval over C
        candidates."""
        cfg = self.cfg
        sh = self.shapes[shape_name]
        if sh.kind == "recsys_retrieval":
            return 2.0 * sh.sizes["n_candidates"] * cfg.embed_dim
        mult = 3.0 if sh.kind == "recsys_train" else 1.0
        return 4.0 * cfg.n_fields * cfg.embed_dim * sh.sizes["batch"] * mult

    def shardings(self, mesh, shape_name: str):
        """((state specs, batch specs), output specs), the reference's:
        the tables' rows over "model", the batch (or the candidates) over
        the data axes."""
        dax = _dax(mesh)
        pspec = {"v": P("model", None), "w": P("model", None), "b": P()}
        kind = self.shapes[shape_name].kind
        if kind == "recsys_train":
            state = TrainState(pspec, spec_map(lambda s: s, pspec),
                               spec_map(lambda s: s, pspec), P())
            batch = dict(ids=P(dax, None), labels=P(dax))
            return (state, batch), (state, {"loss": P(), "gnorm": P()})
        if kind == "recsys_serve":
            return (pspec, dict(ids=P(dax, None))), P(dax)
        batch = dict(context_ids=P(None), candidate_ids=P(dax))
        return (pspec, batch), P(dax)

    def init_smoke(self, generator: torch.Generator) -> dict:
        """Parameters of the smoke config, drawn from ``generator`` on
        its device."""
        return FM.init_params(self.smoke_cfg, generator)

    def step_fn(self, shape_name: str, smoke: bool = False) -> Callable:
        """``train_step(model, state, batch)`` for train_batch (the model
        built with ``train=True``), ``serve(model, batch)`` -> logits [B]
        for the serve shapes, ``retrieve(model, batch)`` -> scores [C]
        for retrieval; the model must be an ``FM`` of the config that
        ``smoke`` picks."""
        cfg = self.smoke_cfg if smoke else self.cfg
        kind = self.shapes[shape_name].kind
        opt = self.opt

        def check(model):
            _check_model(model, cfg, shape_name)

        if kind == "recsys_train":
            def train_step(model, state: TrainState, batch):
                check(model)
                _check_state(model, state, shape_name)
                grads = model.grad_tree()
                loss = model.loss_fn(batch["ids"], batch["labels"])
                loss.backward()
                state, gnorm = adamw_update(state, grads, opt)
                return state, {"loss": loss.detach(), "gnorm": gnorm}
            return train_step

        if kind == "recsys_serve":
            def serve(model, batch):
                check(model)
                return model(batch["ids"])
            return serve

        def retrieve(model, batch):
            check(model)
            return model.retrieval_scores(batch["context_ids"],
                                          batch["candidate_ids"])
        return retrieve


# -- traffic models: a step's HBM bytes on one device of a mesh --------------
# The reference's formulas (its EXPERIMENTS.md, Roofline): the dry run's
# memory time and its "fits the card" test read them. At ``ONE_CARD``
# every tree is whole on the one device.

def _tree_bytes(spec_tree) -> int:
    """Bytes of every tensor of a tree (specs or real tensors)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(spec_tree))


def _sharded_bytes(spec_tree, pspec_tree, mesh) -> int:
    """Bytes on one device of a tree of tensors laid out by its specs: a
    leaf's bytes over the product of its spec's axis sizes (floored, as
    the reference's)."""
    sizes = mesh_axes(mesh)

    def leaf_bytes(t, spec):
        denom = math.prod(sizes[a] for e in spec for a in axes_of(e))
        return t.numel() * t.element_size() // max(denom, 1)
    return sum(spec_leaves(spec_map(leaf_bytes, spec_tree, pspec_tree)))


def _dp(mesh) -> int:
    """The data-parallel degree: every axis but "model"."""
    return math.prod(v for k, v in mesh_axes(mesh).items() if k != "model")


def lm_traffic_model(arch: LMArch, mesh, shape_name: str,
                     batch: Optional[int] = None) -> dict:
    """{"bytes", "state_bytes", "act_bytes"} of one step on one device
    of ``mesh``: train reads the parameters three times and writes them
    (bf16, taken as 2/10 of the state), reads and writes the gradients
    and the float32 moments, and moves 3 L b s d_model bf16 activations
    of its b = batch / dp rows; prefill reads the parameters and moves L
    b s d_model activations; decode reads the parameters and reads and
    writes the cache (its inputs). Plus the inputs once. ``batch``
    replaces the shape's batch."""
    sh = arch.shapes[shape_name]
    b = sh.sizes["global_batch"] if batch is None else batch
    (state_sp, batch_sp), _ = arch.shardings(mesh, shape_name)
    state = _sharded_bytes(arch.state_specs(shape_name), state_sp, mesh)
    io = _sharded_bytes(arch.input_specs(shape_name, batch=batch), batch_sp,
                        mesh)
    b_local = max(b // _dp(mesh), 1)
    cfg = arch.cfg
    if sh.kind == "train":
        params = state * 2 // 10
        weights = 5 * params + 8 * (state - params) // 2
        acts = (3 * cfg.n_layers * b_local * sh.sizes["seq_len"]
                * cfg.d_model * 2)
        return dict(bytes=weights + acts + io, state_bytes=state,
                    act_bytes=acts)
    if sh.kind == "prefill":
        acts = cfg.n_layers * b_local * sh.sizes["seq_len"] * cfg.d_model * 2
        return dict(bytes=state + acts + io, state_bytes=state,
                    act_bytes=acts)
    return dict(bytes=state + 2 * io, state_bytes=state, act_bytes=0)


def gnn_traffic_model(arch: GNNArch, mesh, shape_name: str) -> dict:
    """{"bytes", "state_bytes", "act_bytes"} of one train step on one
    device of ``mesh``: the state read and written (5 times its bytes), a
    layer's edge traffic over the device's E / dp edges (gather the
    senders' features, write the messages, read them into the segment
    sum: 3 L E d 16 B with the backward) and node traffic over the whole
    nodes (3 L N d 8 B), and the inputs once. A graph shape has no batch
    to cut."""
    s = arch.shapes[shape_name].sizes
    (state_sp, batch_sp), _ = arch.shardings(mesh, shape_name)
    state = _sharded_bytes(arch.state_specs(shape_name), state_sp, mesh)
    io = _sharded_bytes(arch.input_specs(shape_name), batch_sp, mesh)
    cfg = arch.config(shape_name)
    d = getattr(cfg, "d_hidden", getattr(cfg, "channels", 64))
    L = getattr(cfg, "n_layers", getattr(cfg, "n_blocks", 2))
    edges = 3 * L * max(s["n_edges"] // _dp(mesh), 1) * d * 4 * 4
    nodes = 3 * L * s["n_nodes"] * d * 4 * 2
    return dict(bytes=5 * state + edges + nodes + io, state_bytes=state,
                act_bytes=edges)


def recsys_traffic_model(arch: RecsysArch, mesh, shape_name: str,
                         batch: Optional[int] = None) -> dict:
    """{"bytes", "state_bytes", "act_bytes"} of one step on one device of
    ``mesh``: the table rows it touches for its batch / dp rows (k + 1
    float32 a field and row; retrieval one a candidate of C / dp), six
    times over to train (AdamW reads and writes them). ``batch`` replaces
    the shape's batch."""
    sh = arch.shapes[shape_name]
    cfg = arch.cfg
    (state_sp, _), _ = arch.shardings(mesh, shape_name)
    state = _sharded_bytes(arch.state_specs(shape_name), state_sp, mesh)
    dp = _dp(mesh)
    if sh.kind == "recsys_retrieval":
        c = max(sh.sizes["n_candidates"] // dp, 1)
        return dict(bytes=c * (cfg.embed_dim + 1) * 4, state_bytes=state,
                    act_bytes=0)
    b = max((sh.sizes["batch"] if batch is None else batch) // dp, 1)
    touched = b * cfg.n_fields * (cfg.embed_dim + 1) * 4
    mult = 6 if sh.kind == "recsys_train" else 1
    return dict(bytes=touched * mult, state_bytes=state, act_bytes=0)
