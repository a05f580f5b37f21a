"""chatglm3-6b [arXiv:2406.12793]: 28L, d_model=4096, 32 heads (GQA
kv=2), d_ff=13696, vocab=65024, 2d RoPE (rotary on half the head dims),
SwiGLU, untied embeddings."""
from repro_torch.configs.base import LMArch
from repro_torch.models.transformer import TransformerConfig

_FULL = TransformerConfig(
    name="chatglm3-6b", n_layers=28, d_model=4096, n_heads=32,
    n_kv_heads=2, d_ff=13696, vocab=65024, act="silu", glu=True,
    rope_fraction=0.5, tie_embeddings=False,
)

_SMOKE = TransformerConfig(
    name="chatglm3-6b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=256, act="silu", glu=True,
    rope_fraction=0.5, tie_embeddings=False, dtype="float32", remat=False,
)

# fsdp_train: the reference's beyond-paper train sharding (ZeRO-3 / FSDP)
ARCH = LMArch("chatglm3-6b", _FULL, _SMOKE, fsdp_train=True)
