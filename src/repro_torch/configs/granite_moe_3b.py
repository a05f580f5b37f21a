"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0-3b-a800m-base]:
32L, d_model=1536, 24 heads (GQA kv=8, head_dim=64), per-expert
d_ff=512, vocab=49155, 40 experts top-8."""
from repro_torch.configs.base import LMArch
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

_FULL = TransformerConfig(
    name="granite-moe-3b-a800m", n_layers=32, d_model=1536, n_heads=24,
    n_kv_heads=8, d_ff=0, vocab=49155, act="silu", glu=True,
    moe=MoEConfig(n_experts=40, top_k=8, d_ff=512, glu=True),
)

_SMOKE = TransformerConfig(
    name="granite-moe-3b-a800m-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=0, vocab=256, act="silu", glu=True, dtype="float32",
    remat=False, moe=MoEConfig(n_experts=4, top_k=2, d_ff=32, glu=True),
)

ARCH = LMArch("granite-moe-3b-a800m", _FULL, _SMOKE)
