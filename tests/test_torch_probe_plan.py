"""The rank probe's search plan (``csrc/merge_probe.cu``) in plain torch,
step for step: the shared-memory sample of stride ``sample_plan(m, W)``,
the search of the sample, the branchless lower search of the window and
the galloping upper rank with its ``build[m - 1]`` shortcut, with the
kernel's index arithmetic. The kernel itself runs only on the card
(``tests/test_torch_cuda.py``); here its plan is held equal to
``torch.searchsorted`` left and right, exactly, where the plan is easy
to get wrong: duplicate runs across sample boundaries, KEY_PAD tails,
builds just below, at and above one sample's worth of keys, probes
outside the keys, sorted and unsorted probes, one and two words."""
import zlib

import numpy as np
import pytest
import torch

from repro_torch.engine.relation import KEY_PAD
from repro_torch.kernels.merge_probe import sample_plan

PAD = int(KEY_PAD)


def _less(a, b):
    """Row-wise a < b under word-wise lexicographic order ([n, W])."""
    lt = torch.zeros(a.shape[0], dtype=torch.bool)
    eq = torch.ones(a.shape[0], dtype=torch.bool)
    for w in range(a.shape[1]):
        lt = lt | (eq & (a[:, w] < b[:, w]))
        eq = eq & (a[:, w] == b[:, w])
    return lt


def _halvings(x: int) -> int:
    """ceil(log2(x)): the steps n -> n - n // 2 that bring n <= x to 1."""
    return 0 if x <= 1 else (x - 1).bit_length()


def probe_plan(build, probe):
    """(lo, hi) of [n, W] probes in a sorted [m, W] build by the kernel's
    plan, all probes side by side as the kernel's threads run them."""
    m, w = build.shape
    n = probe.shape[0]
    stride, n_samples = sample_plan(m, w)
    sample = build[torch.arange(n_samples) * stride]
    # c = #{samples < q}: first j in [0, n_samples] with sample >= q
    b = torch.zeros(n, dtype=torch.int64)
    sn = n_samples + 1
    for _ in range(_halvings(n_samples + 1)):
        half = sn >> 1
        b = torch.where(_less(sample[b + half - 1], probe), b + half, b)
        sn -= half
    c = b
    # the window [base, end]; build[end] >= q or end = m
    base = (c - 1) * stride + 1
    end = torch.where(c == n_samples, m, c * stride)
    b = torch.where(c == 0, 0, base)
    size = torch.where(c == 0, 1, end - base + 1)
    assert bool((size >= 1).all()) and bool((size <= stride).all())
    for _ in range(_halvings(stride)):
        half = size >> 1
        x = build[(b + half - 1).clamp(0, max(m - 1, 0))]
        b = torch.where((half > 0) & _less(x, probe), b + half, b)
        size = size - half
    lo = b
    hi = torch.full((n,), m, dtype=torch.int64)
    if m == 0:
        return lo, hi
    # upper rank: build[m - 1] <= q gives m; else gallop from lo
    need = _less(probe, build[m - 1].expand(n, w))
    at_lo = build[lo.clamp(max=m - 1)]
    run = need & ~_less(probe, at_lo)            # build[lo] == q
    hi = torch.where(need, lo, hi)
    a = lo.clone()                               # build[a] <= q
    gt = torch.full((n,), m - 1, dtype=torch.int64)   # build[gt] > q
    active, d = run.clone(), 1
    while bool(active.any()):
        p = torch.where(d >= m - 1 - lo, m - 1, lo + d)
        stop = active & _less(probe, build[p])
        gt = torch.where(stop, p, gt)
        a = torch.where(active & ~stop, p, a)
        active = active & ~stop
        d <<= 1
    # first j in [a + 1, gt] with build[j] > q
    base, cnt = a + 1, gt - a
    while bool((run & (cnt > 1)).any()):
        h = cnt >> 1
        x = build[(base + h - 1).clamp(0, m - 1)]
        go = run & (h > 0) & ~_less(probe, x)
        base = torch.where(go, base + h, base)
        cnt = torch.where(run, cnt - h, cnt)
    return lo, torch.where(run, base, hi)


def _searchsorted(build, probe):
    """The reference: torch.searchsorted over each row's rank among all
    rows (lexicographic), left and right."""
    rows = np.concatenate([build, probe])
    _, rank = np.unique(rows, axis=0, return_inverse=True)
    rank = torch.from_numpy(rank.reshape(-1).astype(np.int64))
    rb, rp = rank[:build.shape[0]], rank[build.shape[0]:]
    return (torch.searchsorted(rb, rp, side="left"),
            torch.searchsorted(rb, rp, side="right"))


def _keys(rng, k, w, distinct):
    """k rows of w words; word 0 from ``distinct`` values, so rows tie
    on word 0 (and repeat at w = 1)."""
    cols = [rng.integers(0, distinct, k) * ((1 << 62) // distinct)]
    cols += [rng.integers(0, 1 << 62, k) for _ in range(w - 1)]
    return np.stack(cols, axis=1).astype(np.int64)


def _lexsorted(rows):
    return rows[np.lexsort(rows.T[::-1])] if rows.shape[0] else rows


def _case(case, w, rng):
    cap = sample_plan(1 << 30, w)[1]             # keys in a full sample
    sizes = {"m0": 0, "m1": 1, "m_cap-1": cap - 1, "m_cap": cap,
             "m_cap+1": cap + 1, "m_3cap+7": 3 * cap + 7}
    if case in sizes:
        m = sizes[case]
        build = _keys(rng, m, w, max(m // 2, 1))
    elif case == "straddle":    # runs of 1 to 2 strides, across samples
        m = 3 * cap + 7
        stride = sample_plan(m, w)[0]
        runs = rng.integers(1, 2 * stride + 1, m)
        vals = _keys(rng, m, w, 1 << 20)
        build = np.repeat(_lexsorted(vals), runs, axis=0)[:m]
    elif case == "pad_half":
        m = 2 * cap + 5
        build = _keys(rng, m, w, m // 3)
        build[m // 2:] = PAD
    else:                       # "all_pad"
        m = cap + 3
        build = np.full((m, w), PAD, dtype=np.int64)
    return _lexsorted(build)


@pytest.mark.parametrize("order", ["unsorted", "sorted"])
@pytest.mark.parametrize("w", [1, 2])
@pytest.mark.parametrize("case", ["m0", "m1", "m_cap-1", "m_cap",
                                  "m_cap+1", "m_3cap+7", "straddle",
                                  "pad_half", "all_pad"])
def test_probe_plan_equals_searchsorted(case, w, order):
    rng = np.random.default_rng(zlib.crc32(f"{case} {w}".encode()))
    build = _case(case, w, rng)
    m = build.shape[0]
    n = 3000
    probe = _keys(rng, n, w, 1 << 20)            # mostly misses
    if m:
        probe[: n // 3] = build[rng.integers(0, m, n // 3)]    # hits
        probe[n // 3: n // 3 + 50] = build[0]
        probe[n // 3 + 50: n // 3 + 100] = build[m - 1]
    probe[::17] = PAD                            # KEY_PAD probes
    probe[::23] = -1                             # below every key
    probe[::29] = PAD - 1                        # above every live key
    if order == "sorted":
        probe = _lexsorted(probe)
    else:
        probe = probe[rng.permutation(n)]
    lo, hi = probe_plan(torch.from_numpy(build), torch.from_numpy(probe))
    want_lo, want_hi = _searchsorted(build, probe)
    assert torch.equal(lo, want_lo)
    assert torch.equal(hi, want_hi)


def test_sample_plan_bounds():
    """The kernel's sample: within 32 KB, covering the build exactly."""
    for w in (1, 2, 3, 4):
        for m in (0, 1, 1023, 1024, 4095, 4096, 4097, 123457, (1 << 31) - 1):
            stride, ns = sample_plan(m, w)
            assert ns * w * 8 <= 32768 and stride >= 1
            if m:
                assert (ns - 1) * stride < m <= ns * stride
            else:
                assert ns == 0
