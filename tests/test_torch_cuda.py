"""The hand-written CUDA kernels against their plain torch versions, the
port's engine on the card (host mode, device mode's captured loop,
incremental maintenance and two shards) against the same engine on the
CPU or unsharded, the
port's transformer (dense and MoE) on the card against itself on the
CPU, and the MoE layer on the card against float64. Needs an
NVIDIA GPU and nvcc; run there with

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py imports the JAX package,
which the port and this file do not need), and skipped with the reason
where no CUDA device is present."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.engine.relation import KEY_PAD

ROOT = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _lexsorted(rows):
    w = rows.shape[1]
    return rows[np.lexsort(tuple(rows[:, c] for c in reversed(range(w))))]


@pytest.mark.parametrize("width", [1, 2, 3, 4])
@pytest.mark.parametrize("case", ["random", "pad_tails", "empty_build",
                                  "63bit", "long_runs", "sorted_probes"])
def test_probe_kernel_matches_plain(cuda, width, case):
    """Small builds (the sample is the whole build), and builds of more
    than 4 samples' worth of keys (the sample at its ceiling, windows of
    several keys): runs of equal keys far longer than the sample stride,
    and sorted probes (the merge of two arrangements)."""
    from repro_torch.kernels import merge_probe as MP
    rng = np.random.default_rng(width)
    top = (1 << 63) - 1 if case == "63bit" else 5
    m, n = 300, 200
    if case in ("long_runs", "sorted_probes"):
        cap = MP.sample_plan(1 << 30, width)[1]     # the sample's ceiling
        m, n = 5 * cap + 123, 5000
        top = {"long_runs": 7 if width == 1 else 2,
               "sorted_probes": 1 << 40}[case]
    build = _lexsorted(rng.integers(0, top, size=(m, width),
                                    dtype=np.int64))
    probe = rng.integers(0, top, size=(n, width), dtype=np.int64)
    probe[:50] = build[rng.integers(0, m, 50)]
    if case == "pad_tails":
        build[250:] = int(KEY_PAD)
        probe[::7] = int(KEY_PAD)
    if case == "empty_build":
        build = build[:0]
    if case == "long_runs":
        assert MP.sample_plan(m, width)[0] > 1
        build[-m // 5:] = int(KEY_PAD)
        probe[::11] = int(KEY_PAD)
    if case == "sorted_probes":
        probe[::13] = -1                        # below every key
        probe[::17] = int(KEY_PAD)              # above every live key
        probe = _lexsorted(probe)
    b = torch.from_numpy(build).to(cuda)
    p = torch.from_numpy(probe).to(cuda)
    if width == 1:
        b, p = b[:, 0].contiguous(), p[:, 0].contiguous()
    before = dict(MP.LAUNCHES)
    lo, hi = MP.merge_probe(b, p)
    lo_only = MP.merge_probe(b, p, upper=False)
    plo, phi = MP.merge_probe_plain(b, p)
    torch.cuda.synchronize()
    assert torch.equal(lo, plo) and torch.equal(hi, phi)
    assert torch.equal(lo_only, plo)
    key = "probe" if width == 1 else "probe_multi"
    assert MP.LAUNCHES[key] == before[key] + 2


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("d", [1, 5])
def test_segment_kernel_matches_plain_int32(cuda, op, d):
    """Out-of-range ids dropped, empty segments at the identities, sums
    wrapping past 2**31."""
    from repro_torch.kernels import segment_reduce as SR
    rng = np.random.default_rng(d)
    n, segs = 5000, 1200
    seg = np.sort(rng.integers(-3, segs + 4, n)).astype(np.int32)
    seg[100:400] = seg[100]                          # one long run
    seg = np.sort(seg)
    vals = rng.integers(-(1 << 31), (1 << 31) - 1, (n, d), dtype=np.int64)
    vals = vals.astype(np.int32)
    v = torch.from_numpy(vals[:, 0] if d == 1 else vals).to(cuda)
    s = torch.from_numpy(seg).to(cuda)
    out = SR.segment_reduce(v.contiguous(), s, segs, op)
    ref = SR.segment_reduce_plain(v, s, segs, op)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def test_segment_kernel_float32_and_deterministic(cuda):
    from repro_torch.kernels import segment_reduce as SR
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    seg = torch.sort(torch.randint(0, 3000, (20000,), generator=g,
                                   device=cuda, dtype=torch.int32)).values
    vals = torch.rand((20000, 64), generator=g, device=cuda)
    vals = (vals * 256).floor() / 256      # sums exact in any order
    out = SR.segment_reduce(vals, seg, 4096, "sum")
    again = SR.segment_reduce(vals, seg, 4096, "sum")
    ref = SR.segment_reduce_plain(vals, seg, 4096, "sum")
    assert torch.equal(out, again)          # a fixed addition order
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=0)


def _segment_case(case, n, rng):
    """Sorted int32 ids for n rows over 1000 segments."""
    if case == "one_long_run":      # one id over most rows: many tiles
        seg = np.sort(rng.integers(0, 1000, n))
        seg[n // 10: n - n // 10] = seg[n // 10]
    elif case == "all_dead_high":
        seg = np.full(n, 1000)
    elif case == "all_dead_negative":
        seg = np.full(n, -7)
    elif case == "negative_head":   # a third of the rows dropped
        seg = np.sort(rng.integers(-500, 1000, n))
    else:                           # "random": ids both sides of range
        seg = np.sort(rng.integers(-3, 1004, n))
    return np.ascontiguousarray(seg, dtype=np.int32)


@pytest.mark.parametrize("d", [1, 5, 10, 64])
@pytest.mark.parametrize("n", [1, 2047, 2048, 70001])
@pytest.mark.parametrize("case", ["one_long_run", "all_dead_high",
                                  "all_dead_negative", "negative_head",
                                  "random"])
def test_segment_kernel_tiles_and_dead_ids(cuda, case, n, d):
    """Runs across tile edges (one run over most of 70,001 rows), every
    id dead above or below the range, a head of negative ids, n below,
    at and past a tile (2048 rows at d = 1) and no multiple of it; int32
    min and wrapping sums, and float32 sums exact in any order, all
    equal to the plain version."""
    from repro_torch.kernels import segment_reduce as SR
    rng = np.random.default_rng(n + d)
    s = torch.from_numpy(_segment_case(case, n, rng)).to(cuda)
    ints = rng.integers(-(1 << 31), (1 << 31) - 1, (n, d), dtype=np.int64)
    v = torch.from_numpy(ints.astype(np.int32)).to(cuda)
    f = torch.from_numpy(rng.integers(-512, 512, (n, d)) / 256.0).to(
        device=cuda, dtype=torch.float32)
    if d == 1:
        v, f = v[:, 0].contiguous(), f[:, 0].contiguous()
    before = SR.LAUNCHES["segment_reduce"]
    for vals, op in ((v, "min"), (v, "sum"), (f, "sum"), (f, "max")):
        out = SR.segment_reduce(vals, s, 1000, op)
        ref = SR.segment_reduce_plain(vals, s, 1000, op)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), (case, op)
    assert SR.LAUNCHES["segment_reduce"] == before + 4


@pytest.mark.parametrize("d", [1, 10])
def test_segment_kernel_float_sums_are_bit_identical(cuda, d):
    """Values whose sums round: two runs give the same bits, and the sums
    are near the plain version's (which adds in another order)."""
    from repro_torch.kernels import segment_reduce as SR
    g = torch.Generator(device=cuda)
    g.manual_seed(d)
    n = 300_000
    seg = torch.sort(torch.randint(0, 2000, (n,), generator=g, device=cuda,
                                   dtype=torch.int32)).values
    vals = torch.randn((n, d), generator=g, device=cuda)
    if d == 1:
        vals = vals[:, 0].contiguous()
    a = SR.segment_reduce(vals, seg, 2000, "sum")
    b = SR.segment_reduce(vals, seg, 2000, "sum")
    ref = SR.segment_reduce_plain(vals, seg, 2000, "sum")
    mag = SR.segment_reduce_plain(vals.abs(), seg, 2000, "sum")
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert bool(((a - ref).abs() <= 1e-6 * mag).all())


def test_wrappers_refuse_bad_inputs(cuda):
    from repro_torch.kernels.merge_probe import merge_probe
    from repro_torch.kernels.segment_reduce import segment_reduce
    keys = torch.arange(8, device=cuda)
    with pytest.raises(TypeError):
        merge_probe(keys.to(torch.int32), keys.to(torch.int32))
    with pytest.raises(ValueError):
        merge_probe(keys, keys.cpu())
    with pytest.raises(ValueError):
        merge_probe(torch.zeros((4, 5), dtype=torch.int64, device=cuda),
                    torch.zeros((4, 5), dtype=torch.int64, device=cuda))
    with pytest.raises(TypeError):
        segment_reduce(keys, keys.to(torch.int32), 8, "sum")
    with pytest.raises(ValueError, match="contiguous"):
        segment_reduce(torch.zeros((8, 2), device=cuda).t(),
                       keys[:2].to(torch.int32), 8, "sum")
    with pytest.raises(ValueError, match="shared memory"):
        segment_reduce(torch.zeros((8, 100_000), device=cuda),
                       keys.to(torch.int32), 8, "sum")


@pytest.mark.parametrize("program", ["TC", "Sum", "WideReach2"])
def test_engine_on_card_matches_cpu(cuda, program):
    from benchmarks.programs import equivalence_datasets
    from repro_torch.core.optimizer import compile_program
    from repro_torch.engine import Engine, EngineConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    src, edbs = equivalence_datasets()[program]
    caps = dict(idb_cap=1 << 10, intermediate_cap=1 << 12)
    outs = []
    reset_launch_counts()
    for device in ("cuda", "cpu"):
        engine = Engine(compile_program(src),
                        EngineConfig(device=device, **caps))
        outs.append(engine.run(dict(edbs)))
    (gpu, gst), (cpu, cst) = outs
    for name in cpu:
        np.testing.assert_array_equal(gpu[name], cpu[name])
    assert gst.iterations == cst.iterations
    counts = launch_counts()
    assert counts["probe_multi" if program == "WideReach2" else "probe"] > 0
    if program == "Sum":
        assert counts["segment_reduce"] > 0


def _device_mode(program, device, **cfg):
    from benchmarks.programs import CC, equivalence_datasets
    from repro_torch.core.optimizer import compile_program
    from repro_torch.engine import Engine, EngineConfig
    if program == "CC":     # a MIN monoid: the segment reduce too
        rng = np.random.default_rng(3)
        src, edbs = CC, {"edge": rng.integers(0, 40, size=(60, 2))}
    else:
        src, edbs = equivalence_datasets()[program]
    engine = Engine(compile_program(src), EngineConfig(
        device=device, mode="device", idb_cap=1 << 10,
        intermediate_cap=1 << 12, **cfg))
    return engine, dict(edbs)


@pytest.mark.parametrize("jit", [True, False])
@pytest.mark.parametrize("program", ["TC", "Negation", "WideReach2", "CC"])
def test_device_mode_on_card_matches_cpu(cuda, program, jit):
    """One captured CUDA graph per recursive stratum, replayed to the
    fixpoint: the same facts, iterations and (empty) delta logs as the
    same loop run eagerly on the CPU; the kernels launch inside it.
    With the graph memo every loop is captured on its miss (a later run
    replays it); without it only a loop that goes on past its warm-up."""
    from repro_torch.engine.observe import REGISTRY
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    before = REGISTRY.get("engine.graph_captures")
    engine, edbs = _device_mode(program, "cuda", jit=jit)
    gpu, gst = engine.run(edbs)
    captures = REGISTRY.get("engine.graph_captures") - before
    counts = launch_counts()
    engine, edbs = _device_mode(program, "cpu")
    cpu, cst = engine.run(edbs)
    for name in cpu:
        np.testing.assert_array_equal(gpu[name], cpu[name])
    assert gst.iterations == cst.iterations
    assert gst.delta_sizes == cst.delta_sizes
    assert captures == sum(1 for v in gst.iterations.values()
                           if v > (0 if jit else 1))
    assert counts["probe_multi" if program == "WideReach2" else "probe"] > 0
    if program == "CC":
        assert counts["segment_reduce"] > 0


@pytest.mark.parametrize("program", ["TC", "CC"])
def test_graph_memo_replays_without_capture_on_card(cuda, program):
    """A second run on the same Engine replays the memo's graphs: no
    capture, one memo hit a loop, the same facts and iterations, and the
    first run's results unchanged by the replays."""
    from repro_torch.engine import Observation
    from repro_torch.engine.observe import REGISTRY
    obs = Observation()
    engine, edbs = _device_mode(program, "cuda", observe=obs)
    first, fst = engine.run(edbs)
    kept = {k: v.copy() for k, v in first.items()}
    held = {k: (r.data.clone(), int(r.n))
            for k, r in engine.last_env.items()}
    env = engine.last_env
    loops = sum(1 for v in fst.iterations.values() if v > 0)
    before = REGISTRY.get("engine.graph_captures")
    # other data at the same capacities (as many rows), then the first
    other = {k: np.asarray(v) + 1 for k, v in edbs.items()}
    engine.run(other)
    second, sst = engine.run(edbs)
    assert REGISTRY.get("engine.graph_captures") == before
    assert obs.registry.get("memo_jit.hit") >= loops
    assert sst.iterations == fst.iterations
    for name in kept:
        np.testing.assert_array_equal(second[name], kept[name])
        np.testing.assert_array_equal(first[name], kept[name])
    for k, (data, n) in held.items():
        assert int(env[k].n) == n
        assert torch.equal(env[k].data, data)


def test_durable_recover_on_card_matches_uninterrupted(cuda, tmp_path):
    """Snapshot + WAL replay on the card: a cold recover() equals the
    uninterrupted engine's state and iterations, and both equal the
    same stream on the CPU."""
    from benchmarks.programs import equivalence_datasets
    from repro_torch.core.optimizer import compile_program
    from repro_torch.engine import (
        DurableIncrementalEngine, EngineConfig, ResilienceConfig,
    )
    src, edbs = equivalence_datasets()["TC"]
    rng = np.random.default_rng(6)
    steps = [({"edge": rng.integers(0, 16, size=(4, 2))}, {}),
             ({}, {"edge": np.asarray(edbs["edge"])[:5]}),
             ({"edge": rng.integers(0, 16, size=(3, 2))},
              {"edge": np.asarray(edbs["edge"])[5:8]})]
    runs = []
    for device in ("cuda", "cpu"):
        cfg = EngineConfig(device=device, mode="device", idb_cap=1 << 10,
                           intermediate_cap=1 << 12)
        d = tmp_path / device
        dur = DurableIncrementalEngine(
            compile_program(src), cfg, directory=d,
            resilience=ResilienceConfig(snapshot_every=2))
        dur.initialize(dict(edbs))
        for ins, dele in steps:
            out = dur.apply(inserts=ins, deletes=dele)
        dur.close()
        cold = DurableIncrementalEngine(compile_program(src), cfg,
                                        directory=d)
        rec = cold.recover()
        assert cold.applied_seq == len(steps)
        for name in out:
            np.testing.assert_array_equal(rec[name], out[name])
        assert cold.inc._stats.iterations == dur.inc._stats.iterations
        runs.append((out, dur.inc._stats.iterations))
    (gpu, git), (cpu, cit) = runs
    for name in cpu:
        np.testing.assert_array_equal(gpu[name], cpu[name])
    assert git == cit


def test_incremental_device_mode_on_card_matches_cpu(cuda):
    from benchmarks.programs import equivalence_datasets
    from repro_torch.core.optimizer import compile_program
    from repro_torch.engine import EngineConfig, make_engine
    src, edbs = equivalence_datasets()["TC"]
    rng = np.random.default_rng(4)
    steps = [({"edge": rng.integers(0, 16, size=(4, 2))}, {}),
             ({}, {"edge": np.asarray(edbs["edge"])[:5]}),
             ({"edge": rng.integers(0, 16, size=(3, 2))},
              {"edge": np.asarray(edbs["edge"])[5:8]})]
    runs = []
    for device in ("cuda", "cpu"):
        inc = make_engine(compile_program(src), EngineConfig(
            device=device, mode="device", idb_cap=1 << 10,
            intermediate_cap=1 << 12), incremental=True)
        snaps = [inc.initialize(dict(edbs))]
        snaps += [inc.apply(inserts=i, deletes=d) for i, d in steps]
        runs.append((snaps, inc._stats.iterations))
    (gpu, git), (cpu, cit) = runs
    for g, c in zip(gpu, cpu):
        for name in c:
            np.testing.assert_array_equal(g[name], c[name])
    assert git == cit


@pytest.mark.parametrize("mode", ["host", "device"])
@pytest.mark.parametrize("program", ["Reach", "CC"])
def test_sharded_engine_on_card_matches_unsharded(cuda, program, mode):
    """Two shards on the card (one thread each, one stream) give the
    unsharded run's facts and iterations; the probe and, for CC, the
    segment reduce launch on the shards' threads."""
    from benchmarks.programs import CC, equivalence_datasets
    from repro_torch.core.optimizer import compile_program
    from repro_torch.engine import Engine, EngineConfig, make_engine
    from repro_torch.engine.shard import ShardedEngine
    from repro_torch.kernels import launch_counts, reset_launch_counts
    if program == "CC":
        rng = np.random.default_rng(3)
        src, edbs = CC, {"edge": rng.integers(0, 1 << 20, size=(600, 2))}
    else:
        src, edbs = equivalence_datasets()[program]
    caps = dict(idb_cap=1 << 10, intermediate_cap=1 << 12, mode=mode)
    want, wst = Engine(compile_program(src),
                       EngineConfig(**caps)).run(dict(edbs))
    reset_launch_counts()
    engine = make_engine(compile_program(src), EngineConfig(shards=2,
                                                            **caps))
    assert isinstance(engine, ShardedEngine)
    got, gst = engine.run(dict(edbs))
    engine.close()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    assert gst.iterations == wst.iterations
    counts = launch_counts()
    assert counts["probe"] > 0
    if program == "CC":
        assert counts["segment_reduce"] > 0


# -- attention kernels --------------------------------------------------------

# (rtol, atol). The kernels and the plain versions both compute in float32
# and round once to the output's dtype, so bfloat16 outputs differ by at
# most one unit in the last place: 2**-7 of the value at worst.
ATTN_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-2, 1e-4)}


def _normal(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (16, 1)])
@pytest.mark.parametrize("sq,skv", [(128, 128), (77, 77), (33, 200),
                                    (130, 61)])
def test_flash_attention_kernel_matches_plain(cuda, d, dtype, hq, hkv, sq,
                                              skv):
    """GQA groups 1, 2 and 16; tails that are no tile multiple; a chunk
    of queries at the end of a longer cache; more queries than keys.
    bfloat16 runs the wgmma kernel, float32 the 3xTF32 one."""
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=cuda)
    gen.manual_seed(d + sq)
    q = _normal(gen, (2, hq, sq, d), dtype, cuda)
    k = _normal(gen, (2, hkv, skv, d), dtype, cuda)
    v = _normal(gen, (2, hkv, skv, d), dtype, cuda)
    key = ("flash_attention_wgmma" if dtype == torch.bfloat16
           else "flash_attention_tf32")
    for causal in (True, False):
        before = dict(FA.LAUNCHES)
        out = FA.flash_attention(q, k, v, causal=causal)
        want = FA.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert FA.LAUNCHES == {**before, key: before[key] + 1}
        assert out.dtype == dtype and out.shape == q.shape
        rtol, atol = ATTN_TOL[dtype]
        torch.testing.assert_close(out.float(), want.float(), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv", [(24, 8), (16, 8)])
@pytest.mark.parametrize("sq,skv", [(128, 128), (77, 77), (33, 200),
                                    (2048, 2048)])
def test_flash_attention_granite_heads(cuda, dtype, hq, hkv, sq, skv):
    """The granite MoE models' attention: head dim 64, GQA 3:1
    (granite-moe-3b-a800m, 24:8) and 2:1 (granite-moe-1b-a400m, 16:8),
    tails, a chunk and the served prompt length."""
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=cuda)
    gen.manual_seed(hq + sq)
    q = _normal(gen, (2, hq, sq, 64), dtype, cuda)
    k = _normal(gen, (2, hkv, skv, 64), dtype, cuda)
    v = _normal(gen, (2, hkv, skv, 64), dtype, cuda)
    out = FA.flash_attention(q, k, v, causal=True)
    want = FA.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    rtol, atol = ATTN_TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("case", ["scores_60", "long_rows", "gqa_16"])
def test_flash_attention_f32_where_the_split_matters(cuda, d, case):
    """float32 on the 3xTF32 kernel, a second call giving the same bits:
    q and k scaled so that the scores span +-60 in log2 units (as in
    tests/test_torch_tf32_split.py), held against float64 attention,
    because there the plain float32 version is itself off float64 by
    about the tolerance at d = 256; 4133 keys under a chunk of 300
    queries (long rows, a ragged last tile) and chatglm3's GQA 16:1,
    held against the plain version."""
    import math
    from repro_torch.kernels import flash_attention as FA, ref
    gen = torch.Generator(device=cuda)
    gen.manual_seed(d + len(case))
    hq, hkv, sq, skv = {"scores_60": (16, 8, 256, 256),
                        "long_rows": (4, 2, 300, 4133),
                        "gqa_16": (32, 2, 520, 520)}[case]
    q = _normal(gen, (2, hq, sq, d), torch.float32, cuda)
    k = _normal(gen, (2, hkv, skv, d), torch.float32, cuda)
    v = _normal(gen, (2, hkv, skv, d), torch.float32, cuda)
    if case == "scores_60":
        s = q @ k.repeat_interleave(hq // hkv, 1).transpose(-1, -2)
        c = math.sqrt(60 / (float(s.abs().max()) / math.sqrt(d)
                            * math.log2(math.e)))
        q, k = q * c, k * c
    rtol, atol = ATTN_TOL[torch.float32]
    for causal in (True, False):
        before = FA.LAUNCHES["flash_attention_tf32"]
        out = FA.flash_attention(q, k, v, causal=causal)
        again = FA.flash_attention(q, k, v, causal=causal)
        if case == "scores_60":
            want = ref.attention_f64(q, k, v, causal)
        else:
            want = FA.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert FA.LAUNCHES["flash_attention_tf32"] == before + 2
        assert torch.equal(out, again)
        torch.testing.assert_close(out.double(), want.double(), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 4), (16, 1)])
@pytest.mark.parametrize("S", [1, 100, 2112, 5000])
def test_flash_decode_kernel_matches_plain(cuda, d, dtype, hq, hkv, S):
    """kv_len in {0, 1, S} and a random length, per row; any S."""
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=cuda)
    gen.manual_seed(d + S)
    b = 4
    q = _normal(gen, (b, hq, d), dtype, cuda)
    k = _normal(gen, (b, hkv, S, d), dtype, cuda)
    v = _normal(gen, (b, hkv, S, d), dtype, cuda)
    lens = torch.tensor([0, 1, S, (S * 2) // 3], dtype=torch.int32,
                        device=cuda)
    before = (FA.LAUNCHES["flash_decode"],
              FA.LAUNCHES["flash_decode_combine"])
    out = FA.flash_decode(q, k, v, lens)
    want = FA.flash_decode_plain(q, k, v, lens)
    torch.cuda.synchronize()
    assert (FA.LAUNCHES["flash_decode"],
            FA.LAUNCHES["flash_decode_combine"]) == (before[0] + 1,
                                                     before[1] + 1)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    rtol, atol = ATTN_TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), rtol=rtol,
                               atol=atol)
    # the int form of kv_len
    torch.testing.assert_close(
        FA.flash_decode(q, k, v, S).float(),
        FA.flash_decode_plain(q, k, v, S).float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv", [(32, 2), (16, 16), (6, 2)])
def test_flash_decode_ragged_stages_and_deterministic(cuda, d, dtype, hq,
                                                      hkv):
    """Lengths that end inside a stage of the K/V ring and inside a
    split (S = 4133, kv_len 4133, 2999, 1025, 31), GQA groups 16
    (chatglm3), 1 (gemma, d = 256) and 3 (heads that do not fill a warp's
    four); a second call gives the same bits."""
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=cuda)
    gen.manual_seed(d + hq)
    S = 4133
    q = _normal(gen, (4, hq, d), dtype, cuda)
    k = _normal(gen, (4, hkv, S, d), dtype, cuda)
    v = _normal(gen, (4, hkv, S, d), dtype, cuda)
    lens = torch.tensor([S, 2999, 1025, 31], dtype=torch.int32, device=cuda)
    out = FA.flash_decode(q, k, v, lens)
    again = FA.flash_decode(q, k, v, lens)
    want = FA.flash_decode_plain(q, k, v, lens)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    rtol, atol = ATTN_TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("hq,hkv", [(16, 8), (32, 2)])
@pytest.mark.parametrize("sq", [8192, 1000])
def test_flash_attention_bf16_against_the_blockwise_plain(cuda, hq, hkv, sq):
    """The bf16 prefill kernel at 8192 keys (qwen3's and chatglm3's heads,
    d = 128), where the plain version is blockwise_attention: the whole
    causal square and a chunk of 1000 queries at its end."""
    from repro_torch.kernels import flash_attention as FA, ref
    gen = torch.Generator(device=cuda)
    gen.manual_seed(hq + sq)
    skv = 8192
    q = _normal(gen, (1, hq, sq, 128), torch.bfloat16, cuda)
    k = _normal(gen, (1, hkv, skv, 128), torch.bfloat16, cuda)
    v = _normal(gen, (1, hkv, skv, 128), torch.bfloat16, cuda)
    calls = []
    blockwise = ref.blockwise_attention

    def counted(*args, **kw):
        calls.append(1)
        return blockwise(*args, **kw)

    ref.blockwise_attention = counted
    try:
        want = FA.flash_attention_plain(q, k, v, causal=True)
    finally:
        ref.blockwise_attention = blockwise
    out = FA.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert calls == [1]
    rtol, atol = ATTN_TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv", [(16, 8), (32, 2)])
def test_flash_decode_over_131072_positions(cuda, dtype, hq, hkv):
    """The decode kernel over a 131,072-position cache (64 splits of
    2048; qwen3's and chatglm3's heads, d = 128) at full, ragged and
    short lengths, against decode_attention_ref; a second call gives the
    same bits."""
    from repro_torch.kernels import flash_attention as FA, ref
    gen = torch.Generator(device=cuda)
    gen.manual_seed(hq)
    S = 131072
    q = _normal(gen, (3, hq, 128), dtype, cuda)
    k = _normal(gen, (3, hkv, S, 128), dtype, cuda)
    v = _normal(gen, (3, hkv, S, 128), dtype, cuda)
    lens = torch.tensor([S, S - 4097, 33], dtype=torch.int32, device=cuda)
    out = FA.flash_decode(q, k, v, lens)
    again = FA.flash_decode(q, k, v, lens)
    want = ref.decode_attention_ref(q, k, v, lens)
    torch.cuda.synchronize()
    assert FA.decode_splits(3, hkv, S)[1] == 2048
    assert torch.equal(out, again)
    rtol, atol = ATTN_TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), rtol=rtol,
                               atol=atol)


def test_attention_wrappers_refuse_what_no_kernel_takes(cuda):
    from repro_torch.kernels import flash_attention as FA
    q = torch.zeros((1, 4, 8, 48), device=cuda)       # head dim 48
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_decode(q[:, :, 0], q, q, 8)
    q = torch.zeros((1, 4, 8, 64), device=cuda)
    with pytest.raises(TypeError):
        FA.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):
        FA.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="heads"):
        FA.flash_attention(q, q[:, :3], q[:, :3])
    strided = torch.zeros((1, 4, 64, 8), device=cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_attention(strided, q, q)
    with pytest.raises(ValueError, match="kv_len"):
        FA.flash_decode(q[:, :, 0].contiguous(), q, q,
                        torch.tensor([8], device=cuda))
    # the tensor-core kernel's TMA loads need 16-byte aligned inputs
    flat = torch.zeros(4 * 8 * 64 + 1, dtype=torch.bfloat16, device=cuda)
    odd = flat[1:].view(1, 4, 8, 64)
    with pytest.raises(ValueError, match="aligned"):
        FA.flash_attention(odd, q.bfloat16(), q.bfloat16())
    # and the 3xTF32 kernel's cp.async copies
    flat32 = torch.zeros(4 * 8 * 64 + 1, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        FA.flash_attention(flat32[1:].view(1, 4, 8, 64), q, q)
    # so do the decode kernel's bulk copies
    with pytest.raises(ValueError, match="aligned"):
        FA.flash_decode(q[:, :, 0].bfloat16().contiguous(), odd, odd, 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transformer_on_card_matches_cpu(cuda, dtype):
    """A qwen3-shaped model with head dim 64 (the smoke configs
    themselves: ``test_smoke_config_on_card_matches_cpu``): prefill + 3
    greedy steps on the card against the same weights on the CPU."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_arch("qwen3-1.7b").smoke_cfg,
                              d_model=128, head_dim=64, dtype=dtype)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, size=(3, 37))
    steps = 3 if dtype == "float32" else 1
    cpu = serve.generate(T.Transformer(cfg, params, device="cpu"),
                         prompts, steps)
    reset_launch_counts()
    gpu = serve.generate(T.Transformer(cfg, params, device=cuda), prompts,
                         steps)
    counts = launch_counts()
    prefill = ("flash_attention_wgmma" if dtype == "bfloat16"
               else "flash_attention_tf32")
    assert counts[prefill] == cfg.n_layers
    assert counts["flash_decode"] == counts["flash_decode_combine"] == (
        steps * cfg.n_layers)
    np.testing.assert_array_equal(gpu.tokens, cpu.tokens)
    got, want = gpu.logits.float().cpu(), cpu.logits.float()
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    else:   # cuBLAS and the CPU round bf16 products at other places
        assert float((got - want).abs().max()) <= 2e-2 * float(
            want.abs().max())


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma-7b", "chatglm3-6b"])
def test_smoke_config_on_card_matches_cpu(cuda, arch):
    """The reference's dense smoke configs as the port gives them
    (float32; head dim 16, 32 and 16, chatglm3's rotary on half of d):
    prefill + 3 greedy steps on the card, through the 3xTF32 prefill and
    the decode kernel at that head dim, against the same weights on the
    CPU: the same tokens, logits within 1e-3."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    cfg = get_arch(arch).smoke_cfg
    assert cfg.hd in (16, 32) and cfg.dtype == "float32"
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, size=(3, 37))
    cpu = serve.generate(T.Transformer(cfg, params, device="cpu"),
                         prompts, 3)
    reset_launch_counts()
    gpu = serve.generate(T.Transformer(cfg, params, device=cuda), prompts,
                         3)
    counts = launch_counts()
    assert counts["flash_attention_tf32"] == cfg.n_layers
    assert counts["flash_decode"] == 3 * cfg.n_layers
    np.testing.assert_array_equal(gpu.tokens, cpu.tokens)
    torch.testing.assert_close(gpu.logits.float().cpu(), cpu.logits.float(),
                               rtol=1e-3, atol=1e-3)


def _chip_smoke():
    """chip_smoke.py, whose MoE checks these tests share."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_granite_moe_on_card_matches_cpu(cuda):
    """granite-moe-3b-a800m's smoke config (4 experts, top-2) with head
    dim 64 in float32: prefill + 3 greedy steps on the card against the
    same weights on the CPU. The card's run takes the CPU run's expert
    choices; a token whose own choice differs must have a float32 margin
    p_(k) - p_(k+1) under chip_smoke.MOE_MARGIN."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    C = _chip_smoke()
    cfg = dataclasses.replace(get_arch("granite-moe-3b-a800m").smoke_cfg,
                              d_model=128, head_dim=64)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, size=(3, 37))
    with C.moe_routing(torch, M) as recorded:
        cpu = serve.generate(T.Transformer(cfg, params, device="cpu"),
                             prompts, 3)
    reset_launch_counts()
    replay = [e.to(cuda) for e in recorded]
    with C.moe_routing(torch, M, replay=replay) as log:
        gpu = serve.generate(T.Transformer(cfg, params, device=cuda),
                             prompts, 3)
    counts = launch_counts()
    assert counts["flash_attention_tf32"] == cfg.n_layers
    assert counts["flash_decode"] == 3 * cfg.n_layers
    assert all(m < C.MOE_MARGIN for _, _, margins in log for m in margins)
    np.testing.assert_array_equal(gpu.tokens, cpu.tokens)
    torch.testing.assert_close(gpu.logits.cpu(), cpu.logits, rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("t,groups", [(2048, 4), (8, 32)])
def test_moe_ffn_on_card_at_the_served_group_shape(cuda, t, groups):
    """granite-moe-3b-a800m's MoE layer (d 1536, 40 experts of 512,
    top-8) in bf16 at the served prefill's group shape (tg = 512, cap
    128) and at a decode step's (8 groups of one token), under the chip
    phase's gates (chip_smoke.check_moe_layer: routing, slots, keep,
    gates and output against float64, no host read)."""
    from repro_torch.models import moe as M
    cfg = M.MoEConfig(n_experts=40, top_k=8, d_ff=512)
    gen = torch.Generator(device=cuda).manual_seed(t)
    params = M.init_moe(cfg, 1536, torch.bfloat16, gen)
    x = torch.randn((t, 1536), generator=gen, device=cuda).bfloat16()
    out = _chip_smoke().check_moe_layer(torch, f"moe t={t}", params, x, cfg,
                                        groups)
    assert 0.0 <= out["dropped"] < 0.2
    if t == 8:
        assert out["dropped"] == 0.0


def test_moe_route_refuses_tf32(cuda):
    """With TF32 matmuls allowed process-wide, the router raises on the
    card (it must be float32); the flag is left as it was found."""
    from repro_torch.models import moe as M
    cfg = M.MoEConfig(n_experts=4, top_k=2, d_ff=8)
    params = M.init_moe(cfg, 64, torch.float32,
                        torch.Generator(device=cuda).manual_seed(0))
    x = torch.ones((3, 64), device=cuda)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            M.moe_ffn(params, x, cfg)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert M.moe_ffn(params, x, cfg)[0].shape == (3, 64)


# -- the FM interaction kernel ------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,f,k,form", [
    (32, 39, 10, "shared"), (1000, 39, 10, "shared"),
    (4096, 26, 16, "shared"), (7, 13, 4, "shared"),
    (300, 39, 10, "per_row"), (1, 39, 10, "per_row"), (77, 1, 1, "per_row"),
    (129, 5, 32, "per_row"), (50, 300, 7, "per_row"), (50, 300, 7, "shared"),
    (40, 39, 10, "ones"), (40, 39, 10, "expanded_v"), (40, 39, 10,
                                                       "strided_x")])
def test_fm_interaction_kernel_matches_plain(cuda, dtype, b, f, k, form):
    """Shared and per-row v; k from 1 to the limit 32; field counts that
    take several shared-memory chunks; x broadcast by stride 0 (the
    model's ones), v broadcast over rows by stride 0, x transposed.
    Tolerance: ``ref.fm_allowed_error``."""
    from repro_torch.kernels import fm_interaction as FI, ref
    gen = torch.Generator(device=cuda)
    gen.manual_seed(b + f + k)
    x = _normal(gen, (b, f), dtype, cuda)
    if form == "ones":
        x = torch.ones((1, 1), dtype=dtype, device=cuda).expand(b, f)
    elif form == "strided_x":
        x = _normal(gen, (f, b), dtype, cuda).t()
    v = _normal(gen, (f, k) if form == "shared" else (b, f, k), dtype, cuda)
    if form == "expanded_v":
        v = v[:1].expand(b, f, k)
    before = FI.LAUNCHES["fm_interaction"]
    out = FI.fm_interaction(x, v)
    want = FI.fm_interaction_plain(x, v)
    torch.cuda.synchronize()
    assert FI.LAUNCHES["fm_interaction"] == before + 1
    assert out.dtype == dtype and out.shape == (b,)
    err = (out.float() - want.float()).abs()
    allowed = ref.fm_allowed_error(x, v, want)
    assert bool((err <= allowed).all()), float(err.max())
    # the same inputs give the same bits (no atomics)
    assert torch.equal(FI.fm_interaction(x, v), out)


def test_fm_interaction_refuses_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels import fm_interaction as FI
    x = torch.ones((4, 6), device=cuda)
    v = torch.ones((6, 3), device=cuda)
    # with grad the call goes through the backward's autograd Function
    assert FI.fm_interaction(x, v.clone().requires_grad_()).grad_fn
    with pytest.raises(TypeError):
        FI.fm_interaction(x.half(), v.half())
    with pytest.raises(TypeError):
        FI.fm_interaction(x, v.bfloat16())
    with pytest.raises(ValueError, match="k"):
        FI.fm_interaction(x, torch.ones((6, 33), device=cuda))
    with pytest.raises(ValueError, match="match"):
        FI.fm_interaction(x, torch.ones((5, 3), device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        FI.fm_interaction(x, torch.ones((3, 6), device=cuda).t())
    with pytest.raises(ValueError, match="device"):
        FI.fm_interaction(x, v.cpu())
    before = FI.LAUNCHES["fm_interaction"]
    assert FI.fm_interaction(x[:0], v).shape == (0,)
    assert FI.LAUNCHES["fm_interaction"] == before


def test_fm_on_card_matches_cpu(cuda):
    """The FM model at 39 fields x k 10 (vocab 10,000) on the card against
    the same weights on the CPU: serve, retrieval and embedding_bag,
    with ids out of range, through the kernels."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.recsys import fm as TFM
    cfg = TFM.FMConfig(n_fields=39, embed_dim=10, vocab=10_000)
    params = TFM.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(-5, 10_100, (600, 39)).astype(
        np.int32))
    bag_ids = torch.from_numpy(np.sort(rng.integers(0, 50, 300)).astype(
        np.int32))
    outs = {}
    reset_launch_counts()
    for dev in ("cpu", cuda):
        model = TFM.FM(cfg, params, device=dev)
        outs[str(dev)] = [t.cpu() for t in (
            model(ids), model.retrieval_scores(ids[0], ids[:, 1]),
            TFM.embedding_bag(model.v, ids[:300, 2].to(dev),
                              bag_ids.to(dev), 60, "mean"))]
    counts = launch_counts()
    assert counts["fm_interaction"] == 1 and counts["segment_reduce"] == 2
    for got, want in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)


def test_fm_retrieval_refuses_tf32(cuda):
    """The retrieval matvec is float32 as in the reference: with TF32
    matmuls allowed process-wide, retrieval_scores raises on the card
    (and the model leaves the flag as it found it)."""
    from repro_torch.models.recsys import fm as TFM
    cfg = TFM.FMConfig(n_fields=4, embed_dim=10, vocab=100)
    model = TFM.FM(cfg, device=cuda)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    ids = torch.arange(4, dtype=torch.int32)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            model.retrieval_scores(ids, ids)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert model.retrieval_scores(ids, ids).shape == (4,)


# last in the file: a failed capture leaves nothing for later tests to
# trip on
def test_device_mode_capture_failure_raises(cuda):
    """A host read inside the iteration fails the eager warm-up (sync
    debug mode "error") or the capture, and the run raises: there is no
    fallback to the eager loop or to host mode."""
    engine, edbs = _device_mode("TC", "cuda")
    real = engine._stratum_iter

    def reads_host(*args):
        state, ovf = real(*args)
        if engine._capturing:
            int(state["tc"][1].n)
        return state, ovf
    engine._stratum_iter = reads_host
    with pytest.raises(RuntimeError):
        engine.run(edbs)

    def reads_host_always(*args):
        state, ovf = real(*args)
        int(state["tc"][1].n)
        return state, ovf
    engine._stratum_iter = reads_host_always
    with pytest.raises(RuntimeError, match="synchroniz"):
        engine.run(edbs)


def test_device_mode_after_a_failed_capture(cuda):
    """A capture that fails leaves no entry in the graph memo and the
    side stream usable: the same Engine then runs, captures and
    replays."""
    from repro_torch.engine.observe import REGISTRY
    engine, edbs = _device_mode("TC", "cuda")
    real = engine._stratum_iter

    def reads_host(*args):
        state, ovf = real(*args)
        if engine._capturing:
            int(state["tc"][1].n)
        return state, ovf
    engine._stratum_iter = reads_host
    with pytest.raises(RuntimeError):
        engine.run(edbs)
    assert engine._graph_memo == {}
    engine._stratum_iter = real
    before = REGISTRY.get("engine.graph_captures")
    out, stats = engine.run(edbs)
    assert REGISTRY.get("engine.graph_captures") == before + 1
    cpu_engine, _ = _device_mode("TC", "cpu")
    want, wst = cpu_engine.run(edbs)
    np.testing.assert_array_equal(out["tc"], want["tc"])
    assert stats.iterations == wst.iterations


# -- training: the backward kernels and the train step -----------------------

def _one_key_bound(q, k, v, do):
    """Bounds on |dq| and |dk| where every row sees one key (s = 1): there
    dS = P (dP - D) is 0 in exact arithmetic (D = dO . o and o = v), and
    what is left is the float32 rounding of dP and D, two d-term dot
    products of dO and v: at most 4 d 2**-24 of their sum of |terms|
    (3 for the two sums, accumulated in either order and rounded either
    way, 1 of margin for P's and the scale's own roundings). For float32
    inputs dP is 3xTF32, each term within about 3 2**-22 of itself and
    each fragment's six steps rounded toward zero, under 32 2**-24 of the
    sum in all: inside the same bound at every d."""
    group, d = q.shape[1] // k.shape[1], q.shape[-1]
    scale = d ** -0.5
    kk, vv = (t.float().repeat_interleave(group, 1) for t in (k, v))
    noise = 4 * d * 2.0 ** -24 * (do.float().abs() * vv.abs()).sum(
        -1, keepdim=True)
    dq = scale * noise * kk.abs()
    dk = (scale * noise * q.float().abs()).reshape(
        k.shape[0], k.shape[1], group, *k.shape[2:]).sum(2)
    return dq, dk


def _bwd_case(cuda, b, d, hq, hkv, s, causal, dtype):
    """The backward kernels of ``dtype`` against attention_bwd_ref on the
    same inputs: in float32 for bfloat16 inputs, in float64 for float32
    ones (``chip_smoke.hold_bwd``'s tolerance of the dtype)."""
    from repro_torch.kernels import flash_attention as FA, ref
    cs = _chip_smoke()
    gen = torch.Generator(device=cuda).manual_seed(d + hq + s)
    q = torch.randn((b, hq, s, d), generator=gen, device=cuda).to(dtype)
    k = torch.randn((b, hkv, s, d), generator=gen, device=cuda).to(dtype)
    v = torch.randn((b, hkv, s, d), generator=gen, device=cuda).to(dtype)
    do = torch.randn((b, hq, s, d), generator=gen, device=cuda).to(dtype)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=cuda)
    o = FA._prefill(q, k, v, causal, lse)
    f32 = dtype == torch.float32

    def plain(*ts):
        return [t.double() if f32 else t for t in ts]

    _, want_lse = ref.attention_lse_ref(*plain(q, k, v), causal)
    torch.testing.assert_close(plain(lse)[0], want_lse, rtol=0,
                               atol=cs.LSE_ATOL[cs.dtype_name(q)])
    before = dict(FA.LAUNCHES)
    got = FA.flash_attention_bwd(q, k, v, o, do, lse, causal)
    stem = FA.bwd_stem(dtype, d)
    pre = ("flash_attention_bwd_tf32_pre" if f32
           else "flash_attention_bwd_pre")
    for key in (pre, f"{stem}_dkdv", f"{stem}_dq"):
        assert FA.LAUNCHES[key] == before[key] + 1
    want = ref.attention_bwd_ref(*plain(q, k, v, o, do), lse, causal)
    if s == 1:
        cs.hold_bwd(torch, "backward", got[2:], want[2:])
        for g, bound in zip(got[:2], _one_key_bound(q, k, v, do)):
            assert bool((g.float().abs() <= bound).all())
    else:
        cs.hold_bwd(torch, "backward", got, want)
    again = FA.flash_attention_bwd(q, k, v, o, do, lse, causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bfloat16", "float32"])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (16, 1)])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 77, 128, 129, 257, 300])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_matches_plain(cuda, d, hq, hkv, s, causal,
                                           dtype):
    """The attention backward (three launches) against attention_bwd_ref
    on the same inputs, o and lse from the forward kernel (lse against
    attention_lse_ref): bf16 inputs against the plain version in float32,
    BWD_RTOL of a value plus BWD_ATOL_SHARE of the output's largest;
    float32 inputs (flash_attention_bwd_tf32.cu, every d) against it in
    float64, BWD_TOL["float32"]; a repeat gives the same bits. bf16 at
    d = 256 runs flash_attention_bwd256.cu's kernels (64-key dK/dV CTAs
    with 64-row stages, 128-row dQ CTAs with 32-key stages).
    s = 1 (one row, one key), 63, 64 and 65 (about a 64-key tile or
    stage), 129 (one key past a 128-key tile or a 128-row dQ CTA) and 257
    (one past two) are the tiles' edges. At
    s = 1 the exact dq and dk are 0, and the kernels and the plain
    version both return float32 rounding noise of dP - D (about 1e-7;
    the mma.sync kernel the d 64 / 128 one replaced gave the same), which no tolerance relative to the plain version's largest
    value can hold: there dv is held to hold_bwd and dq, dk to the bound
    of that rounding (``_one_key_bound``)."""
    _bwd_case(cuda, 2, d, hq, hkv, s, causal, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bfloat16", "float32"])
@pytest.mark.parametrize("d,hq,hkv", [(128, 16, 8), (256, 16, 16),
                                      (64, 16, 1)])
def test_flash_attention_bwd_matches_plain_at_4096(cuda, d, hq, hkv, dtype):
    """The same at one 4096-token sequence, causal: d = 128 with GQA 2:1
    (32 dK/dV and dQ tiles a head, the longest first), gemma-7b's d = 256
    with 16 heads (64 tiles a head) and d = 64 at GQA 16:1 (every query
    head of the group summed into one key's dK and dV, 65,536 rows)."""
    _bwd_case(cuda, 1, d, hq, hkv, 4096, True, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bfloat16", "float32"])
def test_attention_autograd_on_card_matches_plain(cuda, dtype):
    """flash_attention with grad on the card (the prefill kernel of the
    dtype with lse, the backward kernels) against the same autograd
    Function through the plain versions: on the same bf16 inputs, or on
    the float32 inputs cast to float64 (hold_bwd's tolerance of the
    dtype; the output within ATTN_TOL)."""
    from repro_torch.kernels import flash_attention as FA
    cs = _chip_smoke()
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((1, 8, 200, 128), generator=gen,
                           device=cuda).to(dtype) for _ in range(3))
    k, v = k[:, :4].contiguous(), v[:, :4].contiguous()
    do = torch.randn((1, 8, 200, 128), generator=gen, device=cuda).to(dtype)
    plain = torch.float64 if dtype == torch.float32 else dtype
    grads = []
    for fn, dt in ((FA.flash_attention, dtype),
                   (FA.attention_plain_autograd, plain)):
        leaves = [t.to(dt).requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, causal=True)
        grads.append((out, *torch.autograd.grad(out, leaves, do.to(dt))))
    cs.hold_bwd(torch, "autograd", grads[0][1:], grads[1][1:])
    rtol, atol = cs.ATTN_TOL[cs.dtype_name(q)]
    torch.testing.assert_close(grads[0][0].double(), grads[1][0].double(),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,f,k,form", [
    (65536, 39, 10, "ones"), (1000, 39, 10, "strided_x"),
    (333, 100, 16, "ones"), (77, 13, 4, "shared"), (4096, 400, 32, "ones"),
    (65537, 39, 10, "ones"), (4096, 39, 10, "offset"),
    (500, 39, 10, "strided_v"), (64, 2000, 32, "ones"),
    (1001, 13, 3, "strided_x")])
def test_fm_interaction_bwd_matches_plain(cuda, dtype, b, f, k, form):
    """The FM backward kernel against fm_interaction_bwd_ref: dv (and dx
    when x is not the broadcast ones) within 1e-5 of the row's
    |S| + |v| sums times |g| (float32; bfloat16 also one unit of the
    value), the same bits on a repeat. The plan's route: bulk for per-row
    v contiguous across rows (65,537 rows: a tail tile of one row; 13 x 3
    values a row: tails that end inside a 16-byte unit; 400 x 32: a row a
    tile), staged for a shared v, a v one element past an aligned base
    ("offset"), a batch stride of f k + 8 ("strided_v") and 2000 x 32
    (a row too large for two stages, the fields in several chunks).
    bfloat16 dv is held against the plain version in float64 on the same
    inputs, with the tolerance unchanged: the kernel and the float32 plain
    version each round a float32 value to bfloat16, and where the exact
    value lies on a rounding midpoint they may round to neighbouring
    values, a full unit apart, while 2**-8 of a value just above a power
    of two is half a unit (the strided_v case meets one such value)."""
    from repro_torch.kernels import fm_interaction as FI, ref
    gen = torch.Generator(device=cuda).manual_seed(b)
    x = (torch.ones((1, 1), device=cuda).expand(b, f) if form == "ones"
         else torch.randn((f, b), generator=gen, device=cuda).t()
         if form == "strided_x"
         else torch.randn((b, f), generator=gen, device=cuda))
    v = torch.randn((f, k) if form == "shared" else (b, f, k),
                    generator=gen, device=cuda) * 0.1
    g = torch.randn((b,), generator=gen, device=cuda)
    x, v, g = x.to(dtype), v.to(dtype), g.to(dtype)
    if form == "offset":
        v = torch.cat([v.new_zeros(1), v.reshape(-1)])[1:].view(b, f, k)
    if form == "strided_v":
        wide = v.new_zeros((b, f * k + 8))
        wide[:, :f * k] = v.reshape(b, f * k)
        v = wide[:, :f * k].view(b, f, k)
    route = ("staged" if form in ("shared", "offset", "strided_v")
             or f == 2000 else "bulk")
    assert FI.backward_plan(x, v).route == route
    need_dx = form != "ones"
    dx, dv = FI.fm_interaction_bwd(x, v, g, need_dx=need_dx)
    rdx, rdv = ref.fm_interaction_bwd_ref(x, v, g)
    assert dv.shape == v.shape and dv.dtype == dtype
    vb = v.float() if v.dim() == 3 else v.float().expand(b, f, k)
    xs = x.float()[:, :, None] * vb
    allowed = 1e-5 * (xs.sum(1, keepdim=True).abs() + xs.abs()).sum(
        1, keepdim=True) * (g.float().abs() * x.float().abs().amax(1))[
            :, None, None] + 1e-12
    if form == "shared":
        allowed = allowed.sum(0)
    if dtype == torch.bfloat16:
        rdv = ref.fm_interaction_bwd_ref(x.double(), v.double(),
                                         g.double())[1]
        allowed = allowed + rdv.float().abs() * 2 ** -8
    assert bool(((dv.float() - rdv.float()).abs() <= allowed).all())
    if need_dx:
        torch.testing.assert_close(dx.float(), rdx.float(), rtol=2e-2 if
                                   dtype == torch.bfloat16 else 1e-4,
                                   atol=1e-3 * float(rdx.float().abs().max()))
    assert torch.equal(FI.fm_interaction_bwd(x, v, g, need_dx=need_dx)[1], dv)


def test_training_refusals_on_card(cuda):
    """What the card's training path does not take raises: a head dim
    the kernels are not built for, and sq != skv with grad."""
    from repro_torch.kernels import flash_attention as FA
    q = torch.zeros((1, 4, 64, 96), device=cuda,
                    dtype=torch.bfloat16).requires_grad_()
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention(q, q, q)
    q = torch.zeros((1, 4, 64, 128), device=cuda,
                    dtype=torch.bfloat16).requires_grad_()
    kv = torch.zeros((1, 4, 96, 128), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="skv"):
        FA.flash_attention(q, kv, kv)
    with torch.no_grad():       # serving the same shapes still works
        assert FA.flash_attention(q, kv, kv).shape == q.shape


def test_qwen3_train_step_on_card_matches_cpu(cuda):
    """One train_4k step of qwen3-1.7b at full width and 2 layers, B = 1
    over 256 tokens, on the card (the attention kernels, forward with lse
    and backward) against the same weights and batch on the CPU (the
    plain versions), both in bf16: loss and ce within 2e-3, gnorm 1e-2,
    every gradient leaf and mu within 2e-2 of its scale, nu 4e-2 (cuBLAS
    and the CPU round bf16 products at other places, and the differences
    add up through two layers)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    from repro_torch.training.optim import train_state_init, tree_map
    cs = _chip_smoke()
    arch = train.cut_layers(get_arch("qwen3-1.7b"), 2)
    params = T.init_params(arch.cfg, torch.Generator().manual_seed(0))
    tokens = np.random.default_rng(0).integers(
        0, arch.cfg.vocab, size=(1, 257)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens[:, :-1]),
             "labels": torch.from_numpy(tokens[:, 1:].copy())}
    out = {}
    for dev in ("cpu", "cuda"):
        model = T.Transformer(arch.cfg, cs.snapshot(params), device=dev,
                              train=True)
        state = train_state_init(model.param_tree())
        reset_launch_counts()
        with train.deterministic(torch.device(dev)):
            state, m = arch.step_fn("train_4k")(
                model, state, {k: t.to(dev) for k, t in batch.items()})
        out[dev] = (
            {k: float(v) for k, v in m.items()},
            tree_map(lambda t: t.detach().cpu(), model.grads),
            tree_map(lambda t: t.cpu(), state.mu),
            tree_map(lambda t: t.cpu(), state.nu))
    counts = launch_counts()
    assert counts["flash_attention_wgmma"] == 4        # forward + remat
    assert counts["flash_attention_bwd_dkdv"] == 2
    (mg, gg, mug, nug), (mc, gc, muc, nuc) = out["cuda"], out["cpu"]
    for key, rel in (("loss", 2e-3), ("ce", 2e-3), ("gnorm", 1e-2)):
        assert abs(mg[key] - mc[key]) <= rel * abs(mc[key]), key
    cs.hold_close(torch, "card vs cpu", gg, gc, 2e-2, "gradient")
    cs.hold_close(torch, "card vs cpu", mug, muc, 2e-2, "mu")
    cs.hold_close(torch, "card vs cpu", nug, nuc, 4e-2, "nu")


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m",
                                  "granite-moe-3b-a800m"])
def test_moe_train_step_on_card_matches_plain(cuda, name):
    """One train_4k step of a granite MoE at full width and 2 layers, B =
    1 over 512 tokens, through the kernels (the wgmma forward with lse,
    the d = 64 backward) against the same step through the plain
    attention on the card, the plain step replaying the kernel step's
    routing (chip_smoke.check_train_step_plain's tolerances: loss and ce
    2e-3, gnorm 1e-2, gradients and mu 2e-2 of each leaf's scale, nu
    4e-2); the dispatch and combine run as gathers both ways."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    _chip_smoke().check_train_step_plain(torch, 0, "cuda", name, seq=512)
    counts = launch_counts()
    assert counts["flash_attention_wgmma"] == 4        # forward + remat
    assert counts["flash_attention_bwd_dkdv"] == 2


def test_gemma_train_step_on_card_matches_plain(cuda):
    """The same for gemma-7b (head dim 256: the backward of
    flash_attention_bwd256.cu) at full width and 2 layers over 512
    tokens."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    _chip_smoke().check_train_step_plain(torch, 0, "cuda", "gemma-7b",
                                         seq=512)
    counts = launch_counts()
    assert counts["flash_attention_bwd256_dkdv"] == 2
    assert counts["flash_attention_bwd256_dq"] == 2


# -- the GNN path ------------------------------------------------------------

@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("d", [1, 8, 32, 56, 64, 70, 96, 128, 160])
def test_segment_reduce_backward_on_card_matches_cpu(cuda, op, d):
    """The differentiable segment reduce at the GNN widths: the kernel's
    forward bit-equal to the CPU's for max/min (sums within 1e-6 of
    scale), the backward's gather and tie shares the same; ties, a
    padded tail and a dropped head included. The backward of max and min
    launches the kernel once more (the tie counts)."""
    from repro_torch.kernels import segment_reduce as SR
    g = torch.Generator().manual_seed(d)
    n, segs = 5000, 700
    vals = torch.randint(-3, 4, (n, d), generator=g).float() * 0.5
    ids = torch.sort(torch.randint(-5, segs + 20, (n,), generator=g,
                                   dtype=torch.int32)).values
    cot = torch.randn((segs, d), generator=g)
    got = []
    for dev in ("cpu", cuda):
        v = vals.to(dev).requires_grad_()
        before = SR.LAUNCHES["segment_reduce"]
        out = SR.segment_reduce(v, ids.to(dev), segs, op)
        (gv,) = torch.autograd.grad(out, v, cot.to(dev))
        if dev != "cpu":
            assert SR.LAUNCHES["segment_reduce"] == before + (
                1 if op == "sum" else 2)
        got.append((out.detach().cpu(), gv.cpu()))
    (oc, gc), (og, gg) = got
    if op == "sum":
        assert (og - oc).abs().max() <= 1e-6 * oc.abs().max()
    else:
        assert torch.equal(og, oc)
    assert torch.equal(gg, gc)


@pytest.mark.parametrize("name", ["gatedgcn", "gat-cora", "dimenet",
                                  "nequip"])
def test_gnn_train_step_on_card_matches_cpu(cuda, name):
    """Two train steps of the smoke config at molecule (geometric) or
    full_graph_sm (feature) on the card against the CPU's, from the same
    weights: loss within 1e-5 relative, every gradient leaf within 1e-4
    of its scale; float32 matmuls (TF32 off)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import train
    from repro_torch.training.optim import (
        train_state_init, tree_leaves, tree_map)
    arch = get_arch(name)
    shape = "full_graph_sm" if arch.kind == "feature" else "molecule"
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = []
    for dev in ("cpu", cuda):
        model = train.build_model(arch, True, "cpu", 0, shape)
        if dev != "cpu":
            model = arch.model_fn(model.cfg, tree_map(
                lambda t: t.detach().to(dev), model.param_tree()), dev,
                train=True)
        state = train_state_init(model.param_tree())
        batch = next(train.make_batches(arch, shape, True, dev))
        losses = []
        with train.deterministic(torch.device(dev)):
            for _ in range(2):
                state, m = arch.step_fn(shape, smoke=True)(model, state,
                                                           batch)
                losses.append(float(m["loss"]))
        runs.append((losses, [t.cpu() for t in tree_leaves(model.grads)]))
    (lc, gc), (lg, gg) = runs
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    for a, b in zip(gg, gc):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max() + 1e-30
