"""Architecture registry, after ``repro.configs``: ``get_arch(name)``
-> ArchSpec.

Every name of the reference's registry resolves: the LM configs (dense
and MoE), the GNNs and the FM recommender."""
from __future__ import annotations

import importlib

_ARCH_MODULES = {
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b",
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
    "gatedgcn": "repro_torch.configs.gatedgcn",
    "dimenet": "repro_torch.configs.dimenet",
    "nequip": "repro_torch.configs.nequip",
    "gat-cora": "repro_torch.configs.gat_cora",
    "fm": "repro_torch.configs.fm",
}

ARCH_NAMES = tuple(_ARCH_MODULES)


def get_arch(name: str):
    if name not in _ARCH_MODULES:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[name]).ARCH


def all_archs() -> dict:
    """Every registered name -> its ArchSpec."""
    return {name: get_arch(name) for name in _ARCH_MODULES}
