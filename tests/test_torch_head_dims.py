"""Every attention shape the port ships is one its CUDA kernels take.

The attention kernels (``csrc/flash_attention*.cu``) are instantiated per
head dim, and on a CUDA tensor a head dim outside
``flash_attention.HEAD_DIMS`` (``BWD_HEAD_DIMS`` with grad) raises: no
fallback to the plain version. So each ``TransformerConfig`` of the port
(the full and smoke config of every LM arch, and ``launch/train_lm.py``'s
SMALL and FULL_100M) must have its head dim in both tables, and the
backward's products table (read by ``chip_smoke.py``'s timed check) must
cover every head dim of the backward in both dtypes. The head dims are
the reference's: the port serves and trains what ``repro.configs``
defines."""
import pytest

from repro_torch.configs import ARCH_NAMES, get_arch
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import train_lm
from repro_torch.models.transformer import TransformerConfig

LM_ARCHS = [n for n in ARCH_NAMES
            if isinstance(getattr(get_arch(n), "cfg", None),
                          TransformerConfig)]
CONFIGS = ([(f"{n}:{which}", getattr(get_arch(n), which))
            for n in LM_ARCHS for which in ("cfg", "smoke_cfg")]
           + [("train_lm:SMALL", train_lm.SMALL),
              ("train_lm:FULL_100M", train_lm.FULL_100M)])


def test_every_lm_arch_is_covered():
    """The five LM archs of the reference's registry are all here."""
    assert sorted(LM_ARCHS) == sorted([
        "chatglm3-6b", "gemma-7b", "granite-moe-1b-a400m",
        "granite-moe-3b-a800m", "qwen3-1.7b"])


@pytest.mark.parametrize("name,cfg", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_config_head_dim_is_a_kernel_width(name, cfg):
    assert cfg.hd in FA.HEAD_DIMS, name
    assert cfg.hd in FA.BWD_HEAD_DIMS, name


def test_small_head_dims_are_the_reference_smoke_configs():
    """16 and 32 are in the tables because the reference's smoke configs
    (and train_lm's SMALL) use them: qwen3-1.7b at 16, gemma-7b at 32."""
    assert get_arch("qwen3-1.7b").smoke_cfg.hd == 16
    assert get_arch("gemma-7b").smoke_cfg.hd == 32
    assert train_lm.SMALL.hd == 32
    assert FA.HEAD_DIMS == FA.BWD_HEAD_DIMS == (16, 32, 64, 128, 256)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_head_dims_are_the_references(name):
    """The port's full and smoke configs have the reference's head dims
    and head counts."""
    from repro.configs import get_arch as ref_arch
    for which in ("cfg", "smoke_cfg"):
        ours, theirs = getattr(get_arch(name), which), getattr(
            ref_arch(name), which)
        assert (ours.hd, ours.n_heads, ours.n_kv_heads) == (
            theirs.hd, theirs.n_heads, theirs.n_kv_heads), (name, which)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bwd_products_cover_the_backward_head_dims(dtype):
    table = FA.BWD_PRODUCTS[dtype]
    assert sorted(table) == sorted(FA.BWD_HEAD_DIMS)
    for d, (dkdv, dq) in table.items():
        assert dkdv >= 4 and dq >= 3, (dtype, d)   # S^T, dP^T + 2; S, dP + 1


def test_bwd_stem_routes_every_head_dim():
    """Each backward head dim has a source in both dtypes: float32 at
    every d the 3xTF32 source; bf16 at 256 its own, else the d <= 128
    one."""
    import torch
    for d in FA.BWD_HEAD_DIMS:
        assert FA.bwd_stem(torch.float32, d) == "flash_attention_bwd_tf32"
        assert FA.bwd_stem(torch.bfloat16, d) == (
            "flash_attention_bwd256" if d == 256 else "flash_attention_bwd")
