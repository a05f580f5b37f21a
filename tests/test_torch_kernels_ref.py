"""The port's plain kernel versions (repro_torch.kernels.ref, and the
wrappers on CPU tensors) against the JAX package's references and its
Pallas kernels in interpret mode, on the same seeded inputs. All data is
integer except one float32 sum, so comparisons are exact unless stated.

Probe contract: ``lo`` must match for every probe; the Pallas ``hi`` may
overcount for KEY_PAD probes, so it is compared on live probes only
(the port's ``hi`` is exact everywhere and is compared in full against
the searchsorted reference)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine.relation import KEY_PAD
from repro.kernels import ops, ref as jref
from repro_torch.engine.backend import (
    CUDA, TORCH, CudaDispatch, TorchDispatch, resolve_backend,
)
from repro_torch.kernels import ref as tref
from repro_torch.kernels.merge_probe import merge_probe
from repro_torch.kernels.segment_reduce import segment_reduce

PAD64 = int(KEY_PAD)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _lexsorted(rows):
    w = rows.shape[1]
    return rows[np.lexsort(tuple(rows[:, c] for c in reversed(range(w))))]


def _probe_cases():
    rng = np.random.default_rng(3)
    top = (1 << 63) - 1
    build63 = np.sort(rng.integers(0, top, 200, dtype=np.int64))
    mixed = np.concatenate([np.sort(rng.integers(0, 1000, 40)),
                            np.full(24, PAD64)]).astype(np.int64)
    big = (1 << 20) << 42                 # 3-column pack with bit 62 set
    return {
        "duplicates": (np.array([2, 2, 2, 2, 5, 5, 9, 9, 9], np.int64),
                       np.array([1, 2, 2, 3, 5, 9, 9, 10], np.int64)),
        "all_pad_build": (np.full(64, PAD64, np.int64),
                          np.sort(rng.integers(0, 1 << 40, 32))),
        "all_pad_probe": (np.sort(rng.integers(0, 1 << 40, 32)),
                          np.full(16, PAD64, np.int64)),
        "empty_build": (np.zeros((0,), np.int64),
                        np.array([0, 3, 1 << 40, PAD64], np.int64)),
        "pad_tails": (mixed, np.concatenate([
            np.sort(rng.choice(mixed[:40], 20)),
            np.full(12, PAD64)]).astype(np.int64)),
        "63bit": (build63, np.sort(np.concatenate(
            [rng.choice(build63, 50),
             rng.integers(0, top, 77, dtype=np.int64)]))),
        "bit62": (np.array([big], np.int64),
                  np.array([5, big, big + 1], np.int64)),
    }


@pytest.mark.parametrize("case", sorted(_probe_cases()))
def test_probe_matches_reference_and_pallas(case):
    build, probe = (np.asarray(a, np.int64) for a in _probe_cases()[case])
    lo, hi = merge_probe(_t(build), _t(probe))
    rlo, rhi = jref.merge_probe_ref(jnp.asarray(build), jnp.asarray(probe))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(rlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(rhi))
    plo, phi = ops.merge_probe_counts(
        jnp.asarray(build), jnp.asarray(probe), backend="interpret",
        probe_block=128, build_block=128)
    live = probe != PAD64
    np.testing.assert_array_equal(lo.numpy(), np.asarray(plo))
    np.testing.assert_array_equal(hi.numpy()[live], np.asarray(phi)[live])
    assert lo.dtype == hi.dtype == torch.int32


def test_probe_unsorted_probes_and_lo_only():
    """Binary search needs no sorted probes; ``upper=False`` gives lo."""
    rng = np.random.default_rng(8)
    build = np.sort(rng.integers(0, 50, 80)).astype(np.int64)
    probe = np.concatenate([rng.integers(0, 60, 40),
                            [PAD64, 0, PAD64]]).astype(np.int64)
    lo, hi = merge_probe(_t(build), _t(probe))
    np.testing.assert_array_equal(
        lo.numpy(), np.searchsorted(build, probe, side="left"))
    np.testing.assert_array_equal(
        hi.numpy(), np.searchsorted(build, probe, side="right"))
    np.testing.assert_array_equal(
        merge_probe(_t(build), _t(probe), upper=False).numpy(), lo.numpy())


def _multi_case(width, seed):
    rng = np.random.default_rng(10 * width + seed)
    live = _lexsorted(rng.integers(0, 4, size=(70, width)).astype(np.int64))
    if seed == 1:                       # words over the full 63-bit range
        live = _lexsorted(rng.integers(0, (1 << 63) - 1, size=(50, width),
                                       dtype=np.int64))
    build = np.concatenate([live, np.full((24, width), PAD64, np.int64)])
    probe = _lexsorted(np.concatenate([
        live[rng.integers(0, live.shape[0], 20)],
        rng.integers(0, 5, size=(17, width)),
        np.full((6, width), PAD64)]).astype(np.int64))
    return build, probe


@pytest.mark.parametrize("width", [1, 2, 3, 4])
@pytest.mark.parametrize("seed", range(2))
def test_probe_multi_matches_reference_and_pallas(width, seed):
    build, probe = _multi_case(width, seed)
    lo, hi = tref.merge_probe_multi_ref(_t(build), _t(probe))
    rlo, rhi = jref.merge_probe_multi_ref(jnp.asarray(build),
                                          jnp.asarray(probe))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(rlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(rhi))
    plo, phi = ops.merge_probe_multi(
        jnp.asarray(build), jnp.asarray(probe), backend="interpret",
        probe_block=16, build_block=16)
    live = ~np.all(probe == PAD64, axis=1)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(plo))
    np.testing.assert_array_equal(hi.numpy()[live], np.asarray(phi)[live])
    # the wrapper on CPU tensors is the plain version
    wlo, whi = merge_probe(_t(build), _t(probe))
    np.testing.assert_array_equal(wlo.numpy(), lo.numpy())
    np.testing.assert_array_equal(whi.numpy(), hi.numpy())


def test_probe_multi_empty_build_and_unsorted_probes():
    rng = np.random.default_rng(4)
    probe = rng.integers(0, 9, size=(10, 3)).astype(np.int64)
    for build in (np.zeros((0, 3), np.int64),
                  _lexsorted(rng.integers(0, 9, size=(30, 3)))):
        build = np.asarray(build, np.int64)
        lo, hi = tref.merge_probe_multi_ref(_t(build), _t(probe))
        rlo, rhi = jref.merge_probe_multi_ref(jnp.asarray(build),
                                              jnp.asarray(probe))
        np.testing.assert_array_equal(lo.numpy(), np.asarray(rlo))
        np.testing.assert_array_equal(hi.numpy(), np.asarray(rhi))


@pytest.mark.parametrize("width", [1, 3])
def test_merge_ranks_match_reference(width):
    rng = np.random.default_rng(width)
    a = _lexsorted(np.concatenate([
        rng.integers(0, 6, size=(30, width)),
        np.full((10, width), PAD64)]).astype(np.int64))
    b = _lexsorted(np.concatenate([
        a[rng.integers(0, 30, 8)], rng.integers(0, 6, size=(9, width)),
        np.full((7, width), PAD64)]).astype(np.int64))
    if width == 1:
        got = tref.merge_ranks_ref(_t(a[:, 0]), _t(b[:, 0]))
        want = jref.merge_ranks_ref(jnp.asarray(a[:, 0]),
                                    jnp.asarray(b[:, 0]))
    else:
        got = tref.merge_ranks_multi_ref(_t(a), _t(b))
        want = jref.merge_ranks_multi_ref(jnp.asarray(a), jnp.asarray(b))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert g.dtype == torch.int32
    # a stable merge: every output slot is filled exactly once
    pos = np.sort(np.concatenate([got[0].numpy(), got[1].numpy()]))
    np.testing.assert_array_equal(pos, np.arange(a.shape[0] + b.shape[0]))


def test_expand_indices_match_reference():
    counts = np.array([0, 3, 1, 0, 2, 0], np.int32)
    offsets = np.cumsum(counts).astype(np.int32)
    for out_cap in (4, 6, 9):
        got = tref.expand_indices_ref(_t(offsets), out_cap)
        want = jref.expand_indices_ref(jnp.asarray(offsets), out_cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _segment_case(n, num_segments, d, seed, wrap=False):
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(-2, num_segments + 3, n)).astype(np.int32)
    shape = (n,) if d == 1 else (n, d)
    if wrap:   # sums past 2**31 - 1 wrap exactly
        vals = rng.integers(1 << 29, (1 << 31) - 1, shape)
    else:
        vals = rng.integers(-50, 50, shape)
    return vals.astype(np.int32), seg


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("d", [1, 3])
def test_segment_reduce_matches_reference_and_pallas(op, d):
    """Out-of-range ids (negative and >= num_segments) are dropped,
    empty segments get the jax identities."""
    vals, seg = _segment_case(64, 40, d, seed=d)
    got = segment_reduce(_t(vals), _t(seg), 40, op)
    want = jref.segment_reduce_ref(jnp.asarray(vals), jnp.asarray(seg),
                                   40, op)
    pal = ops.segment_reduce(jnp.asarray(vals), jnp.asarray(seg), 40, op,
                             backend="interpret")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pal))


def test_segment_reduce_tiled_mode_and_int32_wrap():
    """num_segments > 8192 takes the TPU's tiled kernel; int32 sums
    wrap past 2**31."""
    vals, seg = _segment_case(48, 8200, 1, seed=5, wrap=True)
    seg[:20] = 7                                # one long, wrapping run
    seg = np.sort(seg)
    for op in ("sum", "min", "max"):
        got = segment_reduce(_t(vals), _t(seg), 8200, op)
        want = jref.segment_reduce_ref(jnp.asarray(vals), jnp.asarray(seg),
                                       8200, op)
        pal = ops.segment_reduce(jnp.asarray(vals), jnp.asarray(seg), 8200,
                                 op, backend="interpret")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), np.asarray(pal))
    total = int(vals[seg == 7].astype(np.int64).sum())
    wrapped = (total + (1 << 31)) % (1 << 32) - (1 << 31)
    assert int(segment_reduce(_t(vals), _t(seg), 8200, "sum")[7]) == wrapped


def test_segment_reduce_float32_sum():
    rng = np.random.default_rng(6)
    seg = np.sort(rng.integers(0, 30, 200)).astype(np.int32)
    vals = rng.random((200, 4)).astype(np.float32)
    got = segment_reduce(_t(vals), _t(seg), 32, "sum")
    want = jref.segment_reduce_ref(jnp.asarray(vals), jnp.asarray(seg), 32,
                                   "sum")
    # summation order differs from XLA's
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    mn = segment_reduce(_t(vals), _t(seg), 32, "min").numpy()
    assert np.isinf(mn[30:]).all() and (mn[30:] > 0).all()


def test_dispatch_serves_its_device():
    """CPU tensors go to the plain versions; the CUDA dispatch refuses
    them rather than falling back."""
    assert resolve_backend("auto", "cpu") is TORCH
    assert resolve_backend("auto", "cuda") is CUDA
    assert isinstance(TORCH, TorchDispatch) and isinstance(CUDA,
                                                           CudaDispatch)
    assert not TORCH.needs_sorted_probe and not CUDA.needs_sorted_probe
    with pytest.raises(ValueError):
        resolve_backend("pallas")
    keys = torch.arange(8, dtype=torch.int64)
    lo, hi = TORCH.probe(keys, keys)
    np.testing.assert_array_equal(TORCH.probe_lo(keys, keys).numpy(),
                                  lo.numpy())
    with pytest.raises(ValueError, match="CUDA"):
        CUDA.probe(keys, keys)
    with pytest.raises(ValueError, match="CUDA"):
        CUDA.segment_reduce(keys.to(torch.int32),
                            keys.to(torch.int32), 8, "sum")
