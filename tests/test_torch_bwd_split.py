"""The arithmetic of the attention backward kernels (``csrc/flash_
attention_bwd.cu``), emulated in torch on the CPU and held against the
float64 backward: why P and dS enter their second products as bf16 hi +
lo parts.

The kernels form S = Q K^T and dP = dO V^T in f32 accumulators (bf16
products are exact, their sums taken in f32), P = exp2(S scale log2 e -
lse log2 e) and dS = P (dP - D) in f32, then dV = P^T dO, dK = dS^T Q and
dQ = dS K with P and dS as bf16 A operands, the sums in f32 and each
output rounded once to bf16. With P and dS split into hi =
bf16(x) and lo = bf16(x - hi), two products each, every term is exact to
about 2^-16 of itself, and the outputs are the f32 plain version's up to
their bf16 rounding. Rounded once to bf16 (as FlashAttention and SDPA
feed them), every term is off by up to 2^-9 of itself, and the sums over
hundreds of keys or queries drift outside the tolerance that
``chip_smoke.hold_bwd`` holds the kernels to: |err| <= BWD_RTOL |want| +
BWD_ATOL_SHARE max |want| per output.

Inputs are randn rounded to bf16, as the card's checks make them, made
with numpy from a seed; o (bf16) and lse (f32) are the exact forward's,
rounded as the forward kernel stores them."""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's torch ops on one thread: the test workers share
    the cores, and torch's idle OpenMP threads spinning on an
    oversubscribed host make them tens of times slower."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


BWD_RTOL, BWD_ATOL_SHARE = 1e-2, 1e-3    # chip_smoke.py's hold_bwd
LOG2E = math.log2(math.e)
# (hq, hkv): GQA 2:1 and 16:1
GROUPS = [(4, 2), (16, 1)]


def bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (to nearest, ties to even), as float64."""
    return x.to(torch.bfloat16).double()


def f32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float32, as float64."""
    return x.float().double()


def split(x: torch.Tensor):
    """The kernels' split of an f32 value: hi = bf16(x), lo = bf16(x -
    hi) (the residual is exact in f32)."""
    hi = bf16(x)
    return hi, bf16(x - hi)


def inputs(d, hq, hkv, s, causal, seed=0):
    """q, do [1, hq, s, d] and k, v [1, hkv, s, d], randn rounded to
    bf16; o (bf16) and lse (f32) of the exact forward."""
    rng = np.random.default_rng(seed * 1000 + d * 10 + hq + s)
    q, do = (bf16(torch.from_numpy(rng.standard_normal((1, hq, s, d))))
             for _ in range(2))
    k, v = (bf16(torch.from_numpy(rng.standard_normal((1, hkv, s, d))))
            for _ in range(2))
    o, lse = ref.attention_lse_ref(q, k, v, causal)
    return q, k, v, do, bf16(o), f32(lse)


def emulate(q, k, v, o, do, lse, causal, mode="split"):
    """(dq, dk, dv) as the kernels compute them. ``mode`` "split": P and
    dS as bf16 hi + lo, f32 sums, bf16 outputs; "once": P and dS rounded
    once to bf16, else the same; "exact": no rounding anywhere (float64
    throughout)."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    exact = mode == "exact"
    r32 = (lambda x: x) if exact else f32
    kk = k.repeat_interleave(group, 1)
    vv = v.repeat_interleave(group, 1)
    scale = 1.0 / math.sqrt(d)
    sc = r32(q @ kk.transpose(-1, -2))
    dp = r32(do @ vv.transpose(-1, -2))
    visible = torch.ones(s, s, dtype=torch.bool)
    if causal:
        visible = visible.tril()
    if exact:
        p = torch.exp(sc * scale - lse[..., None])
    else:
        scale_log2 = float(np.float32(scale * LOG2E))
        lse2 = f32(lse * np.float32(LOG2E))
        p = f32(torch.exp2(f32(sc * scale_log2) - lse2[..., None]))
    p = torch.where(visible, p, 0.0)
    delta = r32((do * o).sum(-1, keepdim=True))
    ds = r32(p * r32(dp - delta))

    def operand(x):
        if mode == "split":
            hi, lo = split(x)
            return hi + lo          # two products, each exact in f32
        return x if exact else bf16(x)

    pa, dsa = operand(p), operand(ds)
    out = (lambda x: x) if exact else bf16
    dv = r32(pa.transpose(-1, -2) @ do)
    dk = r32(dsa.transpose(-1, -2) @ q)
    dq = r32(dsa @ kk)

    def group_sum(x):
        return x.reshape(b, -1, group, s, d).sum(2)
    return (out(r32(dq * scale)), out(r32(group_sum(dk) * scale)),
            out(group_sum(dv)))


def worst(got, want):
    """The largest |got - want| / (BWD_RTOL |want| + BWD_ATOL_SHARE max
    |want|) over dq, dk and dv: <= 1 is within hold_bwd's tolerance."""
    out = 0.0
    for g, w in zip(got, want):
        allowed = BWD_RTOL * w.abs() + BWD_ATOL_SHARE * w.abs().max()
        out = max(out, float(((g - w).abs() / allowed).max()))
    return out


SHAPES = [(d, hq, hkv, s, causal)
          for d in (64, 128) for hq, hkv in GROUPS for s in (77, 300)
          for causal in (True, False)]


def test_split_is_exact_to_16_bits():
    """hi + lo is within 2**-16 of x (relative), and lo is what is left:
    a single bf16 rounding is off by up to 2**-9."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        100_000).astype(np.float32)).double()
    hi, lo = split(x)
    rel = ((hi + lo - x).abs() / x.abs()).max()
    assert float(rel) <= 2.0 ** -16
    assert float(((hi - x).abs() / x.abs()).max()) > 2.0 ** -10


@pytest.mark.parametrize("d,hq,hkv,s,causal", SHAPES)
def test_split_holds_the_tolerance_with_margin(d, hq, hkv, s, causal):
    q, k, v, do, o, lse = inputs(d, hq, hkv, s, causal)
    want = ref.attention_bwd_ref(q, k, v, o, do, lse, causal)
    assert worst(emulate(q, k, v, o, do, lse, causal), want) <= 0.5


@pytest.mark.parametrize("d,hq,hkv,s,causal", SHAPES)
def test_rounding_p_and_ds_once_is_at_least_twice_worse(d, hq, hkv, s,
                                                        causal):
    """The single rounding's worst ratio is at least twice the split's on
    the same inputs: the reason the kernels keep two products each."""
    q, k, v, do, o, lse = inputs(d, hq, hkv, s, causal)
    want = ref.attention_bwd_ref(q, k, v, o, do, lse, causal)
    good = worst(emulate(q, k, v, o, do, lse, causal), want)
    once = worst(emulate(q, k, v, o, do, lse, causal, mode="once"), want)
    assert once >= 2 * good


@pytest.mark.parametrize("causal", [True, False])
def test_unrounded_emulation_is_attention_bwd_ref(causal):
    """Without its roundings the emulation is the plain version's
    arithmetic: equal to attention_bwd_ref in float64 (which
    test_torch_train pins to autograd) to 1e-12."""
    q, k, v, do, o, lse = inputs(64, 4, 2, 77, causal)
    got = emulate(q, k, v, o, do, lse, causal, mode="exact")
    want = ref.attention_bwd_ref(q, k, v, o, do, lse, causal)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float64
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)
