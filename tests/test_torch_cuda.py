"""The hand-written CUDA kernels against their plain torch versions, and
the port's engine on the card against the same engine on the CPU. Needs
an NVIDIA GPU and nvcc; run there with

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py imports the JAX package,
which the port and this file do not need), and skipped with the reason
where no CUDA device is present."""
import numpy as np
import pytest
import torch

from repro_torch.engine.relation import KEY_PAD

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
                                  "63bit"])
def test_probe_kernel_matches_plain(cuda, width, case):
    from repro_torch.kernels import merge_probe as MP
    rng = np.random.default_rng(width)
    top = (1 << 63) - 1 if case == "63bit" else 5
    build = _lexsorted(rng.integers(0, top, size=(300, width),
                                    dtype=np.int64))
    probe = rng.integers(0, top, size=(200, width), dtype=np.int64)
    probe[:50] = build[rng.integers(0, 300, 50)]
    if case == "pad_tails":
        build[250:] = int(KEY_PAD)
        probe[::7] = int(KEY_PAD)
    if case == "empty_build":
        build = build[:0]
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
