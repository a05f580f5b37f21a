"""ArchSpecs for the LM and recsys families, after
``repro.configs.base`` (its LMArch and RecsysArch parts).

The reference's ArchSpec also serves the dry-run, the sharding specs
and the roofline harness (abstract inputs, mesh shardings, FLOP
counts); none of that is ported. What remains: the full and smoke
configs, the named input shapes and their sizes, ``init_smoke``, the
optimizer config, and the step functions: the train steps of both
families, and the recsys serve and retrieval steps (the LM serves
through ``launch.serve``).

A train step is ``train_step(model, state, batch) -> (state, metrics)``:
the model (built with ``train=True``) holds the parameters, ``state`` is
a ``TrainState`` whose params are the model's ``param_tree()``, and the
step runs the loss with gradients into the model's ``grad_tree()``, then
``adamw_update``, which writes the parameters (so the model) and the
moments in place. Metrics stay on the device: {"loss", "ce", "gnorm"}
(LM), {"loss", "gnorm"} (recsys), as the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, ClassVar

import torch

from repro_torch.models import transformer as T
from repro_torch.models.recsys import fm as FM
from repro_torch.training.optim import AdamWConfig, TrainState, adamw_update


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


def _check_model(model, cfg, shape_name: str) -> None:
    if model.cfg != cfg:
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

    @property
    def shapes(self):
        return LM_SHAPES

    def input_sizes(self, shape_name: str, smoke: bool = False) -> dict:
        """Input name -> shape (int32) of a step, as the reference's
        ``input_specs``: train {tokens, labels} [b, seq], prefill
        {tokens}, decode {token} [b, 1] (its cache aside); smoke cuts the
        sequence to 128 and the batch to 4."""
        sh = self.shapes[shape_name]
        seq, b = sh.sizes["seq_len"], sh.sizes["global_batch"]
        if smoke:
            seq, b = min(seq, 128), min(b, 4)
        if sh.kind == "train":
            return dict(tokens=(b, seq), labels=(b, seq))
        if sh.kind == "prefill":
            return dict(tokens=(b, seq))
        return dict(token=(b, 1))

    def init_smoke(self, generator: torch.Generator) -> dict:
        """Parameters of the smoke config, drawn from ``generator`` on
        its device."""
        return T.init_params(self.smoke_cfg, generator)

    def step_fn(self, shape_name: str, smoke: bool = False) -> Callable:
        """``train_step(model, state, batch)`` for a train shape; the model
        must be a ``Transformer`` of the config that ``smoke`` picks,
        built with ``train=True``."""
        cfg = self.smoke_cfg if smoke else self.cfg
        if self.shapes[shape_name].kind != "train":
            raise NotImplementedError(
                f"{self.name} {shape_name}: the LM serves through "
                f"repro_torch.launch.serve")
        opt = self.opt

        def train_step(model, state: TrainState, batch):
            _check_model(model, cfg, shape_name)
            _check_state(model, state, shape_name)
            grads = model.grad_tree()
            loss, ce = model.loss_fn(batch["tokens"], batch["labels"])
            loss.backward()
            state, gnorm = adamw_update(state, grads, opt)
            return state, {"loss": loss.detach(), "ce": ce.detach(),
                           "gnorm": gnorm}
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

    def input_sizes(self, shape_name: str, smoke: bool = False) -> dict:
        """Input name -> shape (all int32 ids, int32 labels) of a step,
        as the reference's ``input_specs``; smoke cuts the batch to 32
        rows and the candidates to 1024."""
        cfg = self.smoke_cfg if smoke else self.cfg
        sh = self.shapes[shape_name]
        s = dict(sh.sizes)
        if smoke:
            s["batch"] = min(s["batch"], 32)
            if "n_candidates" in s:
                s["n_candidates"] = min(s["n_candidates"], 1024)
        if sh.kind == "recsys_retrieval":
            return dict(context_ids=(cfg.n_fields,),
                        candidate_ids=(s["n_candidates"],))
        sizes = dict(ids=(s["batch"], cfg.n_fields))
        if sh.kind == "recsys_train":
            sizes["labels"] = (s["batch"],)
        return sizes

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
