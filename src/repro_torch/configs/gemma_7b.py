"""gemma-7b [arXiv:2403.08295]: 28L, d_model=3072, 16 heads (kv=16),
head_dim=256, d_ff=24576, GeGLU, vocab=256000, tied embeddings, input
embedding scaled by sqrt(d_model)."""
from repro_torch.configs.base import LMArch
from repro_torch.models.transformer import TransformerConfig

_FULL = TransformerConfig(
    name="gemma-7b", n_layers=28, d_model=3072, n_heads=16,
    n_kv_heads=16, head_dim=256, d_ff=24576, vocab=256000, act="gelu",
    glu=True, tie_embeddings=True,
)

_SMOKE = TransformerConfig(
    name="gemma-7b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, head_dim=32, d_ff=128, vocab=256, act="gelu",
    glu=True, dtype="float32", remat=False,
)

# fsdp_train: the reference's beyond-paper train sharding (ZeRO-3 / FSDP)
ARCH = LMArch("gemma-7b", _FULL, _SMOKE, fsdp_train=True)
