"""The arithmetic of the float32 attention backward kernels (``csrc/
flash_attention_bwd_tf32.cu``), emulated in torch on the CPU and held
against the float64 backward: why every product is three TF32 passes,
and why the sums go into fresh fragments.

The kernels' tensor-core arithmetic is the forward's (the split, the three
products lo.hi + hi.lo + hi.hi, toward-zero accumulation; modelled in
``tests/tf32_emulation.py``). The dK/dV kernel forms S^T = K Q^T and
dP^T = V dO^T, every two d steps in a fresh fragment added in f32 (round
to nearest), P^T = exp2(S^T scale log2 e - lse log2 e) and dS^T = P^T
(dP^T - D) in f32, then dV += P^T dO and dK += dS^T Q, each stage of BQ
query rows in a fresh fragment added to dV or dK, over every query head
of the GQA group in turn. The dQ kernel forms S = Q K^T and dP = dO V^T
the same way (Q and dO as the A operands, so its products run in another
order) and dQ += dS K, each stage of BKQ keys in a fresh fragment.

Inputs: q, do [1, hq, s, d] and k, v [1, hkv, s, d] made with numpy from
a seed, q and k scaled alike so that the largest |score| in log2 units is
60 (as the forward's test makes them: there an error of delta in a score
is a relative error of about delta ln 2 in P); o and lse are the float64
forward's, rounded to float32 as the forward kernel stores them. The
tolerance is ``chip_smoke.BWD_TOL["float32"]``: |err| <= RTOL |want| +
SHARE max |want| per output, against ``attention_bwd_ref`` in float64 on
the same float32 inputs."""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from tf32_emulation import mma_sum, split, tf32_rna


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's torch ops on one thread: the test workers share
    the cores, and torch's idle OpenMP threads spinning on an
    oversubscribed host make them tens of times slower."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


RTOL, SHARE = 1e-4, 1e-5    # chip_smoke.BWD_TOL["float32"]
SPAN = 60.0                 # max |score| in log2 units
LOG2E = math.log2(math.e)
KG = 2                      # d steps a fresh fragment of S^T, dP^T, S, dP
# query rows a dK/dV stage and keys a dQ stage of the kernels, by d
BQ = {64: 32, 128: 16, 256: 8}
BKQ = {64: 32, 128: 16, 256: 8}
GROUPS = [(4, 2), (16, 1)]  # (hq, hkv): GQA 2:1 and 16:1


def f32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float32 (to nearest), as float64."""
    return x.float().double()


def over_d(a, b, fresh=True):
    """a b^T over the last axis (d) as the kernels sum it, a the A
    operand: with ``fresh``, every KG d steps after the first in a fresh
    fragment added in f32; without, all d steps straight through."""
    ap, bp = split(a), split(b.transpose(-1, -2).contiguous())
    if not fresh:
        return mma_sum(ap, bp)
    out, step = None, 8 * KG
    for c0 in range(0, a.shape[-1], step):
        cs = slice(c0, c0 + step)
        f = mma_sum((ap[0][..., cs], ap[1][..., cs]),
                    (bp[0][..., cs, :], bp[1][..., cs, :]))
        out = f if out is None else out + f
    return out


def over_tiles(a, b, tile, fresh=True):
    """a b over a's last axis in stages of ``tile`` as the kernels sum
    it: each stage's product in a fresh fragment added to the f32 output
    in stage order; without ``fresh``, every stage straight into it."""
    ap, bp = split(a), split(b)
    if not fresh:
        return mma_sum(ap, bp)
    out = None
    for c0 in range(0, a.shape[-1], tile):
        cs = slice(c0, c0 + tile)
        f = mma_sum((ap[0][..., cs], ap[1][..., cs]),
                    (bp[0][..., cs, :], bp[1][..., cs, :]))
        out = f if out is None else out + f
    return out


def one_pass(a, b):
    """a b with both operands rounded to TF32 once, the sums in f32."""
    return tf32_rna(a) @ tf32_rna(b)


def emulate(q, k, v, o, do, lse, causal, passes=3, fresh=True):
    """(dq, dk, dv) in float32 as the kernels compute them: ``passes``
    3 is the kernels' arithmetic; 1 feeds every product its operands
    rounded to TF32 once. ``fresh`` False sums dV and dK straight through
    the accumulator (every stage of every head into one fragment)."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    kk = k.repeat_interleave(group, 1)
    vv = v.repeat_interleave(group, 1)
    sl2 = float(np.float32(LOG2E / math.sqrt(d)))
    scale = float(np.float32(1 / math.sqrt(d)))
    lse2 = f32(lse.double() * float(np.float32(LOG2E)))[..., None]
    delta = f32((do.double() * o.double()).sum(-1, keepdim=True))
    visible = torch.ones(s, s, dtype=torch.bool)
    if causal:
        visible = visible.tril()

    def p_and_ds(sc, dp):
        """P and dS of [b, hq, queries, keys] scores, as float32."""
        p = torch.exp2(f32(sc.double() * sl2 - lse2).float())
        p = torch.where(visible, p, 0.0)
        return p, (p.double() * f32(dp.double() - delta)).float()

    def pad(x, axis, tile):
        """x padded with zeros along ``axis`` (-1 or -2) to whole
        stages of ``tile`` (s long there)."""
        n = -s % tile
        return torch.nn.functional.pad(x, [0, n] if axis == -1
                                       else [0, 0, 0, n])

    def rows_of_group(x):
        """[b, hq, s, d] -> [b, hkv, group x padded s, d]: the group's
        heads end to end, as the dK/dV kernel walks them."""
        return pad(x, -2, BQ[d]).reshape(b, hkv, -1, d)

    def cols_of_group(x):
        """[b, hq, keys, s] -> [b, hkv, keys, group x padded s]."""
        x = pad(x, -1, BQ[d])
        return x.reshape(b, hkv, group, *x.shape[2:]).permute(
            0, 1, 3, 2, 4).reshape(b, hkv, x.shape[2], -1)

    prod_d = over_d if passes == 3 else (
        lambda a, b_: one_pass(a, b_.transpose(-1, -2)))
    # the dK/dV kernel: S^T and dP^T with K and V the A operands
    pt, dst = (x.transpose(-1, -2) for x in p_and_ds(
        prod_d(kk, q).transpose(-1, -2), prod_d(vv, do).transpose(-1, -2)))
    a_v, a_k = cols_of_group(pt), cols_of_group(dst)
    b_v, b_k = rows_of_group(do), rows_of_group(q)
    if passes == 3:
        dv = over_tiles(a_v, b_v, BQ[d], fresh)
        dk = over_tiles(a_k, b_k, BQ[d], fresh)
    else:
        dv, dk = one_pass(a_v, b_v), one_pass(a_k, b_k)
    # the dQ kernel: S and dP with Q and dO the A operands
    _, ds = p_and_ds(prod_d(q, kk), prod_d(do, vv))
    ds, kp = pad(ds, -1, BKQ[d]), pad(kk, -2, BKQ[d])
    dq = (over_tiles(ds, kp, BKQ[d]) if passes == 3 else one_pass(ds, kp))
    return (f32(dq.double() * scale).float(), f32(dk.double() * scale).float(),
            dv)


def inputs(d, hq, hkv, s, causal, seed=0):
    """q, do [1, hq, s, d], k, v [1, hkv, s, d] float32, q and k scaled
    so that the largest |score| is SPAN in log2 units; o and lse of the
    float64 forward, rounded to float32."""
    rng = np.random.default_rng(seed * 1000 + d * 10 + hq + s)
    q, do = (rng.standard_normal((1, hq, s, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((1, hkv, s, d)).astype(np.float32)
            for _ in range(2))
    sc = np.einsum("bhqd,bhkd->bhqk", q, np.repeat(k, hq // hkv, axis=1))
    c = np.float32(math.sqrt(SPAN / (np.abs(sc).max() / math.sqrt(d)
                                     * LOG2E)))
    q, k, v, do = (torch.from_numpy(x) for x in (q * c, k * c, v, do))
    o, lse = ref.attention_lse_ref(q.double(), k.double(), v.double(),
                                   causal)
    return q, k, v, do, o.float(), lse.float()


def want_of(q, k, v, do, o, lse, causal):
    """attention_bwd_ref in float64 on the float32 inputs."""
    return ref.attention_bwd_ref(*(t.double() for t in (q, k, v, o, do,
                                                        lse)), causal)


def worst(got, want):
    """The largest |got - want| / (RTOL |want| + SHARE max |want|) over
    dq, dk and dv: <= 1 is within the tolerance."""
    out = 0.0
    for g, w in zip(got, want):
        allowed = RTOL * w.abs() + SHARE * w.abs().max()
        out = max(out, float(((g.double() - w).abs() / allowed).max()))
    return out


SHAPES = [(d, hq, hkv, s, causal)
          for d in (64, 128, 256) for hq, hkv in GROUPS for s in (77, 300)
          for causal in (True, False)]


@pytest.mark.parametrize("d,hq,hkv,s,causal", SHAPES)
def test_three_passes_hold_the_f32_tolerance_with_margin(d, hq, hkv, s,
                                                         causal):
    q, k, v, do, o, lse = inputs(d, hq, hkv, s, causal)
    want = want_of(q, k, v, do, o, lse, causal)
    assert worst(emulate(q, k, v, o, do, lse, causal), want) <= 0.5


@pytest.mark.parametrize("d", [64, 128, 256])
def test_one_tf32_pass_misses_the_f32_tolerance(d):
    q, k, v, do, o, lse = inputs(d, 4, 2, 77, True)
    want = want_of(q, k, v, do, o, lse, True)
    assert worst(emulate(q, k, v, o, do, lse, True), want) <= 0.5
    assert worst(emulate(q, k, v, o, do, lse, True, passes=1), want) > 10.0


@pytest.mark.parametrize("d", [64, 128, 256])
def test_float32_plain_version_meets_the_f32_tolerance(d):
    """attention_bwd_ref itself in float32, the yardstick's arithmetic
    in the working type, holds the tolerance it sets."""
    q, k, v, do, o, lse = inputs(d, 16, 1, 300, True)
    want = want_of(q, k, v, do, o, lse, True)
    assert worst(ref.attention_bwd_ref(q, k, v, o, do, lse, True),
                 want) <= 1.0


def test_dv_dk_summed_straight_through_the_tensor_core_drift():
    """dV and dK of one key summed over 16 heads x 300 rows straight
    through the accumulator (each stage rounded toward zero at the
    output's magnitude) miss the tolerance; fresh fragments a stage hold
    it (the emulation's worst ratios are in PERF.md)."""
    q, k, v, do, o, lse = inputs(64, 16, 1, 300, False)
    want = want_of(q, k, v, do, o, lse, False)
    fresh = emulate(q, k, v, o, do, lse, False)
    straight = emulate(q, k, v, o, do, lse, False, fresh=False)
    ratios = [worst(x[1:], want[1:]) for x in (fresh, straight)]
    print(f"dk, dv worst ratio: fresh {ratios[0]}, straight {ratios[1]}")
    assert ratios[0] <= 0.5
    assert ratios[1] > 1.0
