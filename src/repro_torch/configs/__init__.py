"""Architecture registry, after ``repro.configs``: ``get_arch(name)``
-> ArchSpec.

The LM configs (dense and MoE) and the FM recommender are ported; the
GNN names of the reference's registry raise ``NotImplementedError``."""
from __future__ import annotations

import importlib

_ARCH_MODULES = {
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b",
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
    "fm": "repro_torch.configs.fm",
}
# in the reference's registry, not ported yet (ROADMAP.md Queue 1)
NOT_PORTED = ("gatedgcn", "dimenet", "nequip", "gat-cora")


def get_arch(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to repro_torch yet; see "
            f"ROADMAP.md")
    if name not in _ARCH_MODULES:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[name]).ARCH
