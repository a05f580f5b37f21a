"""ArchSpecs for the LM and recsys families, after
``repro.configs.base`` (its LMArch and RecsysArch parts).

The reference's ArchSpec also serves the dry-run, the sharding specs
and the roofline harness (abstract inputs, mesh shardings, FLOP
counts); none of that is ported. What remains: the full and smoke
configs, the named input shapes, ``init_smoke``, and for the recsys
family the input sizes and the serve and retrieval step functions.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.models import transformer as T
from repro_torch.models.recsys import fm as FM


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


@dataclass(frozen=True)
class LMArch:
    name: str
    cfg: T.TransformerConfig
    smoke_cfg: T.TransformerConfig

    @property
    def shapes(self):
        return LM_SHAPES

    def init_smoke(self, generator: torch.Generator) -> dict:
        """Parameters of the smoke config, drawn from ``generator`` on
        its device."""
        return T.init_params(self.smoke_cfg, generator)


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
        """``serve(model, batch)`` -> logits [B] for the serve shapes,
        ``retrieve(model, batch)`` -> scores [C] for retrieval; the
        model must be an ``FM`` of the config that ``smoke`` picks."""
        cfg = self.smoke_cfg if smoke else self.cfg
        kind = self.shapes[shape_name].kind
        if kind == "recsys_train":
            raise NotImplementedError(
                f"{self.name} {shape_name}: FM training is not ported yet "
                f"(no backward for the interaction kernel); see ROADMAP.md")

        def check(model):
            if model.cfg != cfg:
                raise ValueError(f"{shape_name}: model config "
                                 f"{model.cfg}, step made for {cfg}")

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
