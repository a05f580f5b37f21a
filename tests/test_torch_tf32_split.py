"""The arithmetic of the float32 prefill kernel (``csrc/flash_attention_
tf32.cu``), emulated in torch on the CPU and held against float64
attention: why each operand is split into TF32 hi and lo parts, and why
the sums go into fresh fragments.

The tensor core's arithmetic (the split, the three products, the
toward-zero accumulation) is modelled in ``tests/tf32_emulation.py``.
The kernel sums every two d steps of Q K^T into a fresh fragment that it
adds to S in f32 (round to nearest), and each KV tile's P V into a fresh
fragment merged into O with the softmax rescale.

Inputs are the served model's head shape (GQA 2:1) at small sq and skv,
made with numpy from a seed, with q and k scaled so that the scores span
+-60 in log2 units: there an error of delta in a score is a relative
error of about delta ln 2 in its weight, so one TF32 pass (11 significant
bits) misses the float32 tolerance by orders of magnitude."""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from tf32_emulation import mma_sum, split, tf32_read, tf32_rna


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's torch ops on one thread: the test workers share
    the cores, and torch's idle OpenMP threads spinning on an
    oversubscribed host make them tens of times slower (alone, the
    module takes as long on one thread as on eight)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

RTOL, ATOL = 2e-5, 2e-5     # ATTN_TOL for float32 (chip_smoke.py)
SPAN = 60.0                 # max |score| in log2 units
# keys per KV tile and d steps per fresh fragment of the kernel, by d
TILE = {64: 32, 128: 32, 256: 16}
KG = 2
SHAPES = [(96, 96), (130, 61)]       # (sq, skv): square, and sq > skv


def scores(qs, k, fresh):
    """(q scale log2 e) . k for a KV tile as the kernel sums it: with
    ``fresh``, every KG d steps in a fresh fragment added to S in f32;
    without, all d steps straight into S."""
    qp, kp = split(qs), split(k.transpose(-1, -2).contiguous())
    if not fresh:
        return mma_sum(qp, kp)
    s, step = None, 8 * KG
    for c0 in range(0, qs.shape[-1], step):
        cs = slice(c0, c0 + step)
        f = mma_sum((qp[0][..., cs], qp[1][..., cs]),
                    (kp[0][..., cs, :], kp[1][..., cs, :]))
        s = f if s is None else s + f
    return s


def emulate(q, k, v, causal, passes=3, fresh=True):
    """The kernel's blocked online softmax in float32 with its splits and
    fragments (``passes=3``); ``passes=1`` feeds hi parts alone, one TF32
    pass."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    k = k.repeat_interleave(hq // hkv, 1)
    v = v.repeat_interleave(hq // hkv, 1)
    qs = q * np.float32(math.log2(math.e) / math.sqrt(d))
    m = torch.full((b, hq, sq, 1), -math.inf)
    l = torch.zeros((b, hq, sq, 1))
    o = torch.zeros((b, hq, sq, d))
    row = torch.arange(sq)[:, None] + (skv - sq)
    bk = TILE[d]
    for kv0 in range(0, skv, bk):
        kt, vt = k[:, :, kv0:kv0 + bk], v[:, :, kv0:kv0 + bk]
        if passes == 1:
            s = tf32_rna(qs) @ tf32_rna(kt).transpose(-1, -2)
        else:
            s = scores(qs, kt, fresh)
        col = torch.arange(kv0, kv0 + kt.shape[2])[None]
        if causal:
            s = s.masked_fill(col > row, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_use = torch.where(m_new == -math.inf, 0.0, m_new)
        p = torch.exp2(s - m_use)
        alpha = torch.exp2(m - m_use)
        l = l * alpha + p.sum(-1, keepdim=True)
        if passes == 1:
            pv = tf32_rna(p) @ tf32_rna(vt)
        else:
            pv = mma_sum(split(p), split(vt))
        o = o * alpha + pv
        m = m_new
    return torch.where(l == 0, 0.0, o / torch.where(l == 0, 1.0, l))


def inputs(d, sq, skv, seed=0):
    """q [1, 16, sq, d], k and v [1, 8, skv, d]; q and k scaled alike so
    that the largest |score| in log2 units is SPAN."""
    rng = np.random.default_rng(seed * 1000 + d + sq)
    q = rng.standard_normal((1, 16, sq, d)).astype(np.float32)
    k = rng.standard_normal((1, 8, skv, d)).astype(np.float32)
    v = rng.standard_normal((1, 8, skv, d)).astype(np.float32)
    s = np.einsum("bhqd,bhkd->bhqk", q, np.repeat(k, 2, axis=1))
    c = np.float32(math.sqrt(SPAN / (np.abs(s).max() / math.sqrt(d)
                                     * math.log2(math.e))))
    return tuple(torch.from_numpy(x) for x in (q * c, k * c, v))


def worst(got, want):
    """max |got - want| / (ATOL + RTOL |want|): <= 1 is within the
    tolerance."""
    err = (got.double() - want).abs()
    return float((err / (ATOL + RTOL * want.abs())).max())


def test_rna_rounds_to_nearest_ties_away_and_clears_the_low_bits():
    ulp = 2.0 ** -10                    # of a TF32 value in [1, 2)
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      1 + 1.5 * ulp, 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0, 0.0],
                        dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)
    assert int((tf32_rna(x).view(torch.int32) & 0x1FFF).abs().max()) == 0


def test_split_is_exact_to_22_bits():
    """hi + lo as the tensor core reads them is within 2**-21 of x, and
    the residual x - hi is exact in f32."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        100_000).astype(np.float32))
    hi, lo = split(x)
    assert torch.equal(hi.double() + (x - hi).double(), x.double())
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max()
    assert float(rel) <= 2.0 ** -21


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv", SHAPES)
@pytest.mark.parametrize("d", [64, 128, 256])
def test_three_passes_hold_the_f32_tolerance(d, sq, skv, causal):
    q, k, v = inputs(d, sq, skv)
    want = ref.attention_f64(q, k, v, causal)
    assert worst(emulate(q, k, v, causal), want) <= 1.0


@pytest.mark.parametrize("d", [64, 128, 256])
def test_one_tf32_pass_misses_the_f32_tolerance(d):
    q, k, v = inputs(d, 96, 96)
    want = ref.attention_f64(q, k, v, True)
    assert worst(emulate(q, k, v, True), want) <= 1.0
    assert worst(emulate(q, k, v, True, passes=1), want) > 10.0


def test_lo_must_be_the_residual_of_the_hi_the_hardware_uses():
    """Feeding x itself as hi (the tensor core truncates it) with lo
    taken from the rounded hi loses the bits the split is for."""
    q, k, v = inputs(128, 96, 96)
    want = ref.attention_f64(q, k, v, True)
    qs = q * np.float32(math.log2(math.e) / math.sqrt(128))
    kt = k.repeat_interleave(2, 1).transpose(-1, -2).contiguous()

    def mismatched(x):
        return tf32_read(x), tf32_read(x - tf32_rna(x))

    exact = qs.double() @ kt.double()
    good = mma_sum(split(qs), split(kt))
    bad = mma_sum(mismatched(qs), mismatched(kt))
    assert float((good - exact).abs().max()) < 1e-4
    assert float((bad - exact).abs().max()) > 1e-2
    assert worst(emulate(q, k, v, True), want) <= 1.0


def test_scores_summed_straight_through_the_tensor_core_drift():
    """At d = 256, Q K^T accumulated straight into S (each step rounded
    toward zero at the score's magnitude) misses the tolerance; fresh
    fragments every KG steps hold it."""
    q, k, v = inputs(256, 96, 96)
    want = ref.attention_f64(q, k, v, True)
    assert worst(emulate(q, k, v, True), want) <= 1.0
    assert worst(emulate(q, k, v, True, fresh=False), want) > 1.0
