"""ArchSpec for the LM family, after ``repro.configs.base`` (its LMArch
part only).

The reference's ArchSpec also serves the dry-run, the sharding specs
and the roofline harness (abstract inputs, step functions, mesh
shardings, FLOP counts); none of that is ported. What remains: the
full and smoke configs, the named input shapes, and ``init_smoke``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models import transformer as T


@dataclass(frozen=True)
class Shape:
    name: str
    kind: str                  # train | prefill | decode
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
