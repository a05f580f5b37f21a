#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port of FlowLog (``src/repro_torch``) on one
NVIDIA GPU and checks it.

    python3 chip_smoke.py [--seed 0] [--scale 22]

Phases, each printing its wall time:

1. device    the card's name and power limit;
2. build     the CUDA kernels under src/repro_torch/csrc/, compiled with
             nvcc in parallel, with ptxas' register/spill report;
3. kernels   each kernel against its plain torch version on the card, at
             the shapes the engine gives it, timed with CUDA events beside
             its byte bound and one library call;
4. engine    Reach, CC and SSSP with the port's Engine on the card over a
             Graph500 Kronecker graph (scale 22, edge factor 16, A, B, C =
             0.57, 0.19, 0.19), each checked against scipy.sparse.csgraph;
5. wide      Reach again under force_multiword(), so every key is two
             words and every probe takes the multi-word kernel;
6. launches  each kernel's launch count over phases 4-5; a zero fails.

With ``--profile``, each of Reach, CC and SSSP then runs once more under
torch.profiler, which prints device time by kernel family and the
device's busy share of the run's wall time (not part of the checks).

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}, printed only if every phase
passed. Exits non-zero, with no result, when no CUDA device is present or
the repo's sources are not beside this file.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3, NVIDIA's data sheet

REACH = """
.input edge
.input source
.output reach
reach(x) :- source(x).
reach(y) :- reach(x), edge(x, y).
"""

CC = """
.input edge
.output cc
cc(x, MIN(x)) :- edge(x, _).
cc(y, MIN(y)) :- edge(_, y).
cc(x, MIN(i)) :- edge(y, x), cc(y, i).
cc(x, MIN(i)) :- edge(x, y), cc(y, i).
"""

SSSP = """
.input edge
.input source
.output dist
dist(x, MIN(0)) :- source(x).
dist(y, MIN(d + c)) :- dist(x, d), edge(x, y, c).
"""


@contextlib.contextmanager
def phase(name):
    """Prints a phase's wall time when it ends without an error."""
    print(f"== phase {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"== phase {name} done in {time.perf_counter() - t0:.3f} s",
          flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# -- timing ------------------------------------------------------------------

def cuda_ms(torch, fn, reps=5, warmup=2) -> float:
    """Mean device time of ``fn()`` in ms, from CUDA events around
    ``reps`` back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


# -- phase 3: kernels against their plain versions --------------------------

def probe_inputs(torch, gen, m, n, w, dev):
    """Sorted build keys [m, w] (or [m] for w = 1) with duplicates and a
    KEY_PAD tail; unsorted probe keys [n, w] mixing hits, misses and
    KEY_PAD rows, plus a KEY_PAD tail — the engine's arrangement shapes."""
    from repro_torch.engine.relation import KEY_PAD, lex_order_words
    live = m * 3 // 4
    cols = []
    for c in range(w):
        hi = (1 << 62) if c else (1 << 20)    # ties on word 0 when w > 1
        cols.append(torch.randint(0, hi, (m,), generator=gen, device=dev,
                                  dtype=torch.int64))
    build = torch.stack(cols, dim=1)
    if w == 1:      # 62-bit keys drawn from m / 2 values: duplicates
        build[:, 0] = torch.randint(0, m // 2, (m,), generator=gen,
                                    device=dev) * ((1 << 62) // m)
    build[live:] = KEY_PAD
    build = build[lex_order_words(build)].contiguous()
    hits = build[torch.randint(0, live, (n // 2,), generator=gen,
                               device=dev)]
    miss = torch.randint(0, 1 << 62, (n - n // 2, w), generator=gen,
                         device=dev, dtype=torch.int64)
    probe = torch.cat([hits, miss])
    probe = probe[torch.randperm(n, generator=gen, device=dev)]
    probe[:: 17] = KEY_PAD                  # dead probes among live ones
    probe[n - n // 8:] = KEY_PAD            # and a dead tail
    if w == 1:
        return build[:, 0].contiguous(), probe[:, 0].contiguous()
    return build, probe.contiguous()


def check_probe(torch, gen, dev, w, m, n):
    from repro_torch.kernels import merge_probe as MP
    build, probe = probe_inputs(torch, gen, m, n, w, dev)
    lo, hi = MP.merge_probe(build, probe)
    plo, phi = MP.merge_probe_plain(build, probe)
    torch.cuda.synchronize()
    err = max(int((lo.long() - plo.long()).abs().max()),
              int((hi.long() - phi.long()).abs().max()))
    if err:
        raise AssertionError(f"probe W={w}: kernel differs from the "
                             f"plain version (max abs err {err})")
    ms = cuda_ms(torch, lambda: MP.merge_probe(build, probe))
    plain_ms = cuda_ms(torch, lambda: MP.merge_probe_plain(build, probe),
                       reps=2, warmup=1)
    library_ms = None
    if w == 1:
        library_ms = cuda_ms(torch, lambda: (
            torch.searchsorted(build, probe, side="left"),
            torch.searchsorted(build, probe, side="right")))
    nbytes = (m + n) * w * 8 + 2 * n * 4
    print(f"probe W={w} m={m} n={n}: exact; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library {library_ms} ms, byte bound "
          f"{bound_ms(nbytes):.4f} ms ({nbytes} B)", flush=True)
    return dict(max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms(nbytes), bound_by="bytes",
                library_ms=library_ms)


def segment_inputs(torch, gen, n, d, num_segments, dtype, dev):
    """Sorted segment ids over [0, num_segments) with a dead tail at
    num_segments (out of range, dropped), and values [n, d]."""
    live = n * 7 // 8
    seg = torch.sort(torch.randint(0, num_segments, (live,), generator=gen,
                                   device=dev, dtype=torch.int32)).values
    seg = torch.cat([seg, torch.full((n - live,), num_segments,
                                     dtype=torch.int32, device=dev)])
    if dtype == torch.int32:
        vals = torch.randint(-(1 << 31), (1 << 31) - 1, (n, d),
                             generator=gen, device=dev, dtype=torch.int32)
    else:       # multiples of 2**-8: a segment's sum is exact in any order
        vals = torch.randint(0, 256, (n, d), generator=gen, device=dev,
                             dtype=torch.int32).float() / 256
    if d == 1:
        vals = vals[:, 0].contiguous()
    return vals, seg


def check_segment(torch, gen, dev, n, d, num_segments, dtype, op,
                  timed=False):
    from repro_torch.kernels import segment_reduce as SR
    vals, seg = segment_inputs(torch, gen, n, d, num_segments, dtype, dev)
    out = SR.segment_reduce(vals, seg, num_segments, op)
    ref = SR.segment_reduce_plain(vals, seg, num_segments, op)
    torch.cuda.synchronize()
    if dtype == torch.int32:
        err = int((out.long() - ref.long()).abs().max())
        if err:
            raise AssertionError(f"segment_reduce {op} int32: kernel "
                                 f"differs (max abs err {err})")
    else:
        # the plain version adds in another order (atomics)
        torch.testing.assert_close(out, ref, rtol=1e-6, atol=0)
        err = float((out - ref).abs().max())
    label = (f"segment_reduce {op} {str(dtype).split('.')[-1]} n={n} d={d} "
             f"segments={num_segments}")
    if not timed:
        print(f"{label}: max abs err {err}", flush=True)
        return None
    ms = cuda_ms(torch, lambda: SR.segment_reduce(vals, seg,
                                                  num_segments, op))
    plain_ms = cuda_ms(torch, lambda: SR.segment_reduce_plain(
        vals, seg, num_segments, op), reps=2, warmup=1)
    # the library call: one scatter_reduce into a buffer with a spare
    # slot for the dead ids (its index must be int64 and in range)
    idx = seg.long()
    fill = torch.iinfo(torch.int32).max if op == "min" else 0
    red = {"sum": "sum", "min": "amin", "max": "amax"}[op]
    base = torch.full((num_segments + 1,), fill, dtype=vals.dtype,
                      device=dev)
    library_ms = cuda_ms(torch, lambda: base.scatter_reduce(
        0, idx, vals, reduce=red))
    nbytes = n * 4 + n * d * 4 + num_segments * d * 4
    print(f"{label}: max abs err {err}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, byte bound "
          f"{bound_ms(nbytes):.4f} ms ({nbytes} B)", flush=True)
    return dict(max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms(nbytes), bound_by="bytes",
                library_ms=library_ms)


def run_kernel_checks(torch, seed, dev, m=1 << 26, n=1 << 22,
                      big=1 << 27):
    """Probe: build m keys, probe n keys. Segment reduce: n = segments
    = big (the engine's capacity-sized duplicate-combine)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    results = {}
    results["merge_probe"] = check_probe(torch, gen, dev, 1, m, n)
    for w in (2, 3, 4):
        r = check_probe(torch, gen, dev, w, m, n)
        if w == 2:       # the word count force_multiword gives the engine
            results["merge_probe_multi"] = r
    for op in ("sum", "max"):
        check_segment(torch, gen, dev, big, 1, big, torch.int32, op)
    # CC and SSSP combine duplicates with MIN over capacity-sized buffers
    results["segment_reduce"] = check_segment(
        torch, gen, dev, big, 1, big, torch.int32, "min", timed=True)
    check_segment(torch, gen, dev, big // 8, 1, big // 32, torch.float32,
                  "sum")
    check_segment(torch, gen, dev, big // 64, 64, big // 256,
                  torch.float32, "sum")
    return results


# -- phase 4: engine at real size --------------------------------------------

def kronecker_edges(scale: int, edge_factor: int, seed: int):
    """Graph500 Kronecker generator (initiator A, B, C = 0.57, 0.19,
    0.19) with its random vertex permutation: edge_factor * 2**scale
    directed edges, duplicates and self-loops included."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n, m = 1 << scale, edge_factor << scale
    a, b, c = 0.57, 0.19, 0.19
    ab = a + b
    c_norm, a_norm = np.float32(c / (1 - ab)), np.float32(a / ab)
    src = np.zeros(m, np.int32)
    dst = np.zeros(m, np.int32)
    for bit in range(scale):
        ii = rng.random(m, dtype=np.float32) > ab
        jj = rng.random(m, dtype=np.float32) > np.where(ii, c_norm, a_norm)
        src |= ii.astype(np.int32) << bit
        dst |= jj.astype(np.int32) << bit
    perm = rng.permutation(n).astype(np.int32)
    weights = rng.integers(1, 50, size=m).astype(np.int32)
    return perm[src], perm[dst], weights


def reference_answers(scale, src, dst, weights, source):
    """Reach, CC and SSSP by scipy.sparse.csgraph, as sorted arrays."""
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse.csgraph import (
        breadth_first_order, connected_components, dijkstra)
    t0 = [time.perf_counter()]

    def stamp(what):
        now = time.perf_counter()
        print(f"  scipy reference: {what} {now - t0[0]:.3f} s", flush=True)
        t0[0] = now

    # collapse duplicate (x, y) edges to their least weight (a CSR would
    # sum them): sort packed (x, y, w) keys, keep each (x, y)'s first
    n = 1 << scale
    key = (src.astype(np.int64) << scale | dst) << 6 | weights  # w < 64
    key = np.unique(key)
    first = np.ones(key.shape[0], bool)
    first[1:] = (key[1:] >> 6) != (key[:-1] >> 6)
    key = key[first]
    x = (key >> (scale + 6)).astype(np.int32)
    y = ((key >> 6) & (n - 1)).astype(np.int32)
    w = (key & 63).astype(np.float64)
    g = sp.csr_matrix((w, (x, y)), shape=(n, n))
    stamp("dedupe + CSR")
    reach = np.sort(breadth_first_order(g, source, directed=True,
                                        return_predecessors=False))
    stamp("breadth_first_order")
    ncomp, label = connected_components(g, directed=False)
    comp_min = np.full(ncomp, n, np.int64)
    np.minimum.at(comp_min, label, np.arange(n))
    nodes = np.unique(np.concatenate([x, y]))
    cc = np.stack([nodes, comp_min[label[nodes]]], axis=1)
    stamp("connected_components")
    dist = dijkstra(g, indices=source)
    stamp("dijkstra")
    hit = np.flatnonzero(np.isfinite(dist))
    sssp = np.stack([hit, dist[hit].astype(np.int64)], axis=1)
    return reach, cc, sssp


def run_engine(torch, name, src_text, edbs, n, edge_cap, want,
               multiword=False):
    import numpy as np
    from repro_torch.core.optimizer import compile_program
    from repro_torch.engine import Engine, EngineConfig
    from repro_torch.engine.relation import force_multiword
    from repro_torch.kernels import launch_counts, reset_launch_counts
    cfg = EngineConfig(idb_cap=n, intermediate_cap=edge_cap,
                       device="cuda")
    engine = Engine(compile_program(src_text), cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    if multiword:
        with force_multiword():
            out, stats = engine.run(edbs)
    else:
        out, stats = engine.run(edbs)
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    label = name + (" (force_multiword)" if multiword else "")
    print(f"{label}: iterations {stats.iterations}, wall "
          f"{stats.wall_s:.3f} s, grow_retries {stats.grow_retries}, "
          f"peak memory {peak} B, facts {stats.total_facts}, "
          f"launches {counts}", flush=True)
    if stats.grow_retries:
        raise AssertionError(f"{label}: {stats.grow_retries} grow retries")
    got = out[{"Reach": "reach", "CC": "cc", "SSSP": "dist"}[name]]
    got = np.asarray(got, np.int64)
    if got.ndim == 2 and got.shape[1] == 1:
        got = got[:, 0]
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError(
            f"{label}: {got.shape[0]} facts differ from the scipy "
            f"reference ({want.shape[0]} facts)")
    print(f"{label}: {got.shape[0]} facts equal the scipy reference",
          flush=True)
    return counts


def kernel_family(name: str) -> str:
    low = name.lower()
    for family, marks in (("probe (ours)", ("probe_kernel",)),
                          ("segment_reduce (ours)", ("segment_reduce",)),
                          ("sort", ("sort", "radix")),
                          ("memcpy/memset", ("memcpy", "memset")),
                          ("index/scatter/gather",
                           ("index", "scatter", "gather"))):
        if any(m in low for m in marks):
            return family
    return "other elementwise/reduce"


def profile_engine(torch, name, text, edbs, n, edge_cap):
    """One warm run under torch.profiler: device time per kernel family
    and busy share (sum of kernel time over the run's wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.optimizer import compile_program
    from repro_torch.engine import Engine, EngineConfig
    engine = Engine(compile_program(text), EngineConfig(
        idb_cap=n, intermediate_cap=edge_cap, device="cuda"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run(edbs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    families: dict = {}
    top = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0))
        fam = kernel_family(e.key)
        ms, count = families.get(fam, (0.0, 0))
        families[fam] = (ms + us / 1e3, count + e.count)
        top.append((us / 1e3, e.count, e.key[:90]))
    busy = sum(ms for ms, _ in families.values())
    if not families:
        print(f"profile {name}: the profiler saw no device time "
              f"(not measured)", flush=True)
        return
    print(f"profile {name}: wall {wall_ms:.1f} ms under the profiler, "
          f"device busy {busy:.1f} ms ({100 * busy / wall_ms:.1f}%)")
    for fam, (ms, count) in sorted(families.items(), key=lambda x: -x[1][0]):
        print(f"  {fam}: {ms:.1f} ms in {count} kernels "
              f"({100 * ms / wall_ms:.1f}% of wall)")
    for ms, count, key in sorted(top, reverse=True)[:8]:
        print(f"    {ms:9.1f} ms  x{count:<5d} {key}")
    sys.stdout.flush()


def run_engine_phases(torch, seed, scale, profile=False):
    import numpy as np
    n = 1 << scale
    edge_factor = 16
    t0 = time.perf_counter()
    src, dst, weights = kronecker_edges(scale, edge_factor, seed)
    outdeg = np.bincount(src, minlength=n)
    source = int(np.argmax(outdeg))
    print(f"graph: scale {scale}, {n} vertices, {src.shape[0]} directed "
          f"edges before dedupe, source {source} (out-degree "
          f"{int(outdeg[source])}), made in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    t0 = time.perf_counter()
    want_reach, want_cc, want_sssp = reference_answers(
        scale, src, dst, weights, source)
    print(f"scipy references in {time.perf_counter() - t0:.3f} s",
          flush=True)
    edges = np.stack([src, dst], axis=1)
    wedges = np.stack([src, dst, weights], axis=1)
    sources = np.array([[source]])
    # every IDB fact is keyed by a vertex (< n rows), and every join
    # output row is one edge (<= edge_factor * n rows): caps that cannot
    # overflow, so the run needs no grow retry
    edge_cap = edge_factor * n
    totals: dict = {}
    runs = [("Reach", REACH, {"edge": edges, "source": sources},
             want_reach, False),
            ("CC", CC, {"edge": edges}, want_cc, False),
            ("SSSP", SSSP, {"edge": wedges, "source": sources},
             want_sssp, False)]
    with phase("engine"):
        for name, text, edbs, want, mw in runs:
            counts = run_engine(torch, name, text, edbs, n, edge_cap,
                                want, mw)
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
    with phase("wide"):
        counts = run_engine(torch, "Reach", REACH,
                            {"edge": edges, "source": sources}, n,
                            edge_cap, want_reach, multiword=True)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    if profile:
        with phase("profile"):
            for name, text, edbs, _, _ in runs:
                profile_engine(torch, name, text, edbs, n, edge_cap)
    return totals


KERNELS = [
    ("merge_probe", "probe", "src/repro_torch/csrc/merge_probe.cu",
     "src/repro/kernels/merge_probe.py:53", None),
    ("merge_probe_multi", "probe_multi",
     "src/repro_torch/csrc/merge_probe.cu",
     "src/repro/kernels/merge_probe.py:220", None),
    ("segment_reduce", "segment_reduce",
     "src/repro_torch/csrc/segment_reduce.cu",
     "src/repro/kernels/segment_reduce.py:50",
     "src/repro/kernels/segment_reduce.py:79"),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=int, default=22,
                    help="Graph500 scale (2**scale vertices)")
    ap.add_argument("--profile", action="store_true",
                    help="also profile Reach, CC and SSSP on the card")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import _build, launch_counts
    except ImportError as e:
        print(f"chip_smoke: the port's sources are not beside this "
              f"script ({e})", file=sys.stderr)
        return 1

    t_all = time.perf_counter()
    with phase("device"):
        kind = torch.cuda.get_device_name(0)
        smi = nvidia_smi_line()
        print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
              f"device {kind}; {torch.cuda.device_count()} visible")
        print(smi, flush=True)
    with phase("build"):
        reports = _build.build_all()
        for name, text in sorted(reports.items()):
            lines = [ln for ln in text.splitlines()
                     if "registers" in ln or "spill" in ln
                     or "error" in ln.lower()]
            print(f"{name}.cu:\n  " + "\n  ".join(lines), flush=True)
    with phase("kernels"):
        measured = run_kernel_checks(torch, args.seed, torch.device("cuda"))
        torch.cuda.empty_cache()
    totals = run_engine_phases(torch, args.seed, args.scale, args.profile)
    with phase("launches"):
        print("kernels " + json.dumps(totals), flush=True)
        missing = [k for k, v in totals.items() if v == 0]
        if missing or set(totals) != set(launch_counts()):
            raise AssertionError(f"kernels never launched on the main "
                                 f"path: {missing}")
    entries = []
    for name, count_key, source, replaces, also in KERNELS:
        e = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": totals[count_key]}
        e.update(measured[name])
        if also:
            e["also_replaces"] = also
        entries.append(e)
    print(f"total {time.perf_counter() - t_all:.3f} s")
    print(nvidia_smi_line())
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
