"""fm [Rendle ICDM'10]: 39 sparse fields, embed_dim=10, 2-way FM via the
sum-square trick; 4M-row hashed embedding table."""
from repro_torch.configs.base import RecsysArch
from repro_torch.models.recsys.fm import FMConfig

ARCH = RecsysArch(
    "fm",
    cfg=FMConfig(n_fields=39, embed_dim=10, vocab=4_000_000),
    smoke_cfg=FMConfig(n_fields=8, embed_dim=4, vocab=1000),
)
