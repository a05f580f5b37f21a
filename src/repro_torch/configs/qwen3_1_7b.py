"""qwen3-1.7b [hf:Qwen/Qwen3-1.7B family spec]: 28L, d_model=2048,
16 heads (GQA kv=8, head_dim=128), d_ff=6144, vocab=151936, qk-norm."""
from repro_torch.configs.base import LMArch
from repro_torch.models.transformer import TransformerConfig

_FULL = TransformerConfig(
    name="qwen3-1.7b", n_layers=28, d_model=2048, n_heads=16,
    n_kv_heads=8, head_dim=128, d_ff=6144, vocab=151936, act="silu",
    glu=True, qk_norm=True, rope_theta=1_000_000.0,
)

_SMOKE = TransformerConfig(
    name="qwen3-1.7b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, vocab=256, act="silu",
    glu=True, qk_norm=True, dtype="float32", remat=False,
)

# fsdp_train: the reference's beyond-paper train sharding (ZeRO-3 / FSDP)
ARCH = LMArch("qwen3-1.7b", _FULL, _SMOKE, fsdp_train=True)
