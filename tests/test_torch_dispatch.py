"""Which prefill attention kernel serves which inputs, and the arithmetic
of the bfloat16 kernel emulated on the CPU.

``flash_attention`` sends bfloat16 to the wgmma kernel
(``csrc/flash_attention_wgmma.cu``) and float32 to the 3xTF32 one
(``csrc/flash_attention_tf32.cu``), both on the tensor cores;
``prefill_kernel`` is that choice as a pure function (the 3xTF32
arithmetic is emulated in ``tests/test_torch_tf32_split.py``). The
wgmma kernel feeds P to its P.V product in bfloat16, split into a hi
and a lo part; ``_emulate`` repeats its
blocked online softmax in torch so that the precision argument for the
split is checked here against the plain version, within the tolerance
the card's checks use. (Rounded once instead, P misses that tolerance:
PERF.md gives the figure and the mutant run on the card that shows it.)"""
import math

import pytest
import torch

from repro_torch.kernels import flash_attention as FA

# the card's bf16 tolerance (chip_smoke.ATTN_TOL, tests/test_torch_cuda.py)
RTOL, ATOL = 1e-2, 1e-4


def test_bf16_goes_to_the_tensor_core_kernel():
    assert FA.prefill_kernel(torch.bfloat16) == "wgmma"


def test_f32_goes_to_the_cuda_core_kernel():
    """float32 now goes to the tensor cores too: error-compensated TF32
    (the name is kept from when it went to the CUDA cores)."""
    assert FA.prefill_kernel(torch.float32) == "tf32x3"


def test_each_kernel_has_its_own_launch_key():
    assert {"flash_attention_tf32", "flash_attention_wgmma"} <= set(
        FA.LAUNCHES)
    assert "flash_attention" not in FA.LAUNCHES


def _emulate(q, k, v, causal, bk=128):
    """The tensor-core kernel's arithmetic: KV tiles of ``bk`` keys, the
    online softmax in exp2 form in float32, P split into bfloat16 hi and
    lo parts before P.V, l from the unrounded P, the output rounded once
    to bfloat16."""
    q, k, v = q.float(), k.float(), v.float()
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    k = k.repeat_interleave(hq // hkv, 1)
    v = v.repeat_interleave(hq // hkv, 1)
    sl2 = math.log2(math.e) / math.sqrt(d)
    m = torch.full((b, hq, sq, 1), -math.inf)
    l = torch.zeros((b, hq, sq, 1))
    o = torch.zeros((b, hq, sq, d))
    row = torch.arange(sq)[:, None] + (skv - sq)
    for kv0 in range(0, skv, bk):
        s = q @ k[:, :, kv0:kv0 + bk].transpose(-1, -2)
        col = torch.arange(kv0, min(kv0 + bk, skv))[None]
        if causal:
            s = s.masked_fill(col > row, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_use = torch.where(m_new == -math.inf, 0.0, m_new)
        p = torch.exp2(s * sl2 - m_use * sl2)
        alpha = torch.exp2((m - m_use) * sl2)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float()
        pv = hi @ v[:, :, kv0:kv0 + bk] + lo @ v[:, :, kv0:kv0 + bk]
        o = o * alpha + pv
        m = m_new
    safe = torch.where(l == 0, 1.0, l)
    return torch.where(l == 0, 0.0, o / safe).bfloat16()


SHAPES = [(4, 4, 128, 128, 64), (4, 2, 77, 77, 128), (16, 1, 33, 200, 64),
          (4, 4, 130, 61, 128), (2, 2, 300, 300, 128)]


def _worst(shape, causal):
    hq, hkv, sq, skv, d = shape
    g = torch.Generator().manual_seed(sq * 7 + d)
    q = torch.randn((2, hq, sq, d), generator=g).bfloat16()
    k = torch.randn((2, hkv, skv, d), generator=g).bfloat16()
    v = torch.randn((2, hkv, skv, d), generator=g).bfloat16()
    want = FA.flash_attention_plain(q, k, v, causal=causal).float()
    got = _emulate(q, k, v, causal).float()
    seen = torch.isfinite(want)     # the plain version gives NaN for a
    err = (got - want).abs()[seen]  # row with no visible key
    return float((err / (ATOL + RTOL * want.abs()[seen])).max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_split_p_holds_the_bf16_tolerance(shape, causal):
    """P as bf16 hi + lo: within rtol 1e-2, atol 1e-4 of the float32
    plain version (the output's own rounding is most of the error)."""
    assert _worst(shape, causal) <= 1.0
