"""Time to fixpoint of the port's Engine, host mode beside device mode.

    PYTHONPATH=src python -m repro_torch.launch.fixpoint --graph kronecker \
        --scale 22 --programs Reach,CC,SSSP,Reach-mw --modes host,device
    PYTHONPATH=src python -m repro_torch.launch.fixpoint --graph grid \
        --side 2048 --programs Reach --modes host,device
    PYTHONPATH=src python -m repro_torch.launch.fixpoint --shards 2 \
        --programs Reach,CC,SSSP --modes host

Graphs, made from ``--seed``:

- ``kronecker``: Graph500's generator (edge factor 16, initiator A, B, C
  = 0.57, 0.19, 0.19, a random vertex permutation; the graph of
  ``chip_smoke.py``), source the vertex of largest out-degree. Low
  diameter: 6 to 9 iterations a program.
- ``grid``: a road-like lattice of side x side vertices, each joined to
  its right and lower neighbour in both directions (degree at most 4),
  weights in [1, 50), source the corner vertex 0. Its diameter is
  2 (side - 1), so Reach and CC run that many iterations and more.

Each program runs in each mode, in the order given, on the card, with
capacities that cannot overflow (every IDB fact is keyed by a vertex,
every join row is one edge); with ``--shards N`` (N >= 2) on the sharded
engine, N shards on the one card. One line per run, then a JSON list of
the runs: wall seconds (``EngineStats.wall_s``: host clock around a run
that ends in the facts' device-to-host read), iterations, grow retries,
peak device memory, the shard count and one shard's all-to-all bytes
(``shard.all_to_all.bytes``), and whether the facts were checked. On
the grid, Reach (every vertex) and CC (every vertex labelled 0) are
checked; on the Kronecker graph ``chip_smoke.py`` holds the facts to
scipy.
``Reach-mw`` is Reach under ``force_multiword()``.

The script reaches the port through ``compile_program``, ``make_engine``
and ``EngineConfig`` only (``shards`` only when ``--shards`` is given),
so it also times an older checkout of the port in host mode: run it by
its path with that checkout's ``src`` on ``PYTHONPATH``.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

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

PROGRAMS = {"Reach": REACH, "CC": CC, "SSSP": SSSP}
EDGE_FACTOR = 16


def kronecker_edges(scale: int, edge_factor: int, seed: int):
    """Graph500 Kronecker generator (initiator A, B, C = 0.57, 0.19,
    0.19) with its random vertex permutation: edge_factor * 2**scale
    directed edges, duplicates and self-loops included, and a weight in
    [1, 50) per edge."""
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


def grid_edges(side: int, seed: int):
    """The side x side lattice: vertex r * side + c joined to (r, c + 1)
    and (r + 1, c) in both directions -> (src, dst, weights in [1, 50))."""
    v = np.arange(side * side, dtype=np.int32).reshape(side, side)
    a = np.concatenate([v[:, :-1].ravel(), v[:-1, :].ravel()])
    b = np.concatenate([v[:, 1:].ravel(), v[1:, :].ravel()])
    src, dst = np.concatenate([a, b]), np.concatenate([b, a])
    weights = np.random.default_rng(seed).integers(
        1, 50, size=src.shape[0]).astype(np.int32)
    return src, dst, weights


def graph_edbs(src, dst, weights, source: int) -> dict:
    """program -> its EDBs over the graph."""
    edges = np.stack([src, dst], axis=1)
    sources = np.array([[source]])
    return {"Reach": {"edge": edges, "source": sources},
            "CC": {"edge": edges},
            "SSSP": {"edge": np.stack([src, dst, weights], axis=1),
                     "source": sources}}


def engine_config(n: int, edge_cap: int, mode: str, observe=None,
                  shards: int = 0):
    """Capacities that cannot overflow on a graph of n vertices and at
    most edge_cap edges, on the card (``shards`` >= 2: that many shards
    of the sharded engine)."""
    from repro_torch.engine import EngineConfig
    return EngineConfig(idb_cap=n, intermediate_cap=edge_cap,
                        device="cuda", mode=mode, observe=observe,
                        **({"shards": shards} if shards else {}))


def run_one(program: str, edbs: dict, n: int, edge_cap: int, mode: str,
            want: dict, shards: int = 0) -> dict:
    """One run of ``program`` in ``mode``; returns its numbers. ``want``:
    output relation -> its expected rows, for the programs checked."""
    import torch
    from repro_torch.core.optimizer import compile_program
    from repro_torch.engine import make_engine
    from repro_torch.engine.observe import REGISTRY
    from repro_torch.engine.relation import force_multiword
    name = program.removesuffix("-mw")
    engine = make_engine(compile_program(PROGRAMS[name]),
                         engine_config(n, edge_cap, mode, shards=shards))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sent = REGISTRY.get("shard.all_to_all.bytes")
    if program.endswith("-mw"):
        with force_multiword():
            out, stats = engine.run(edbs[name])
    else:
        out, stats = engine.run(edbs[name])
    sent = REGISTRY.get("shard.all_to_all.bytes") - sent
    if hasattr(engine, "close"):
        engine.close()
    checked = name in want
    if checked:
        rel, rows = want[name]
        if not np.array_equal(np.asarray(out[rel], np.int64), rows):
            raise AssertionError(f"{program}, {mode} mode: {rel} differs "
                                 f"from the expected {rows.shape[0]} rows")
    return {"program": program, "mode": mode, "wall_s": stats.wall_s,
            "iterations": stats.iterations,
            "grow_retries": stats.grow_retries,
            "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
            "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
            "shards": shards or 1, "all_to_all_bytes": sent,
            "facts_checked": checked}


def main(argv=None) -> list:
    import time
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--graph", choices=("kronecker", "grid"),
                    default="kronecker")
    ap.add_argument("--scale", type=int, default=22,
                    help="kronecker: 2**scale vertices")
    ap.add_argument("--side", type=int, default=2048,
                    help="grid: side**2 vertices")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--programs", default="Reach,CC,SSSP,Reach-mw")
    ap.add_argument("--modes", default="host,device")
    ap.add_argument("--shards", type=int, default=0,
                    help="N >= 2: the sharded engine, N shards on the card")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    want: dict = {}
    if args.graph == "kronecker":
        n = 1 << args.scale
        src, dst, weights = kronecker_edges(args.scale, EDGE_FACTOR,
                                            args.seed)
        source = int(np.argmax(np.bincount(src, minlength=n)))
        label = f"kronecker scale {args.scale}"
    else:
        n = args.side * args.side
        src, dst, weights = grid_edges(args.side, args.seed)
        source = 0
        want = {"Reach": ("reach", np.arange(n)[:, None]),
                "CC": ("cc", np.stack([np.arange(n), np.zeros(n, np.int64)],
                                      axis=1))}
        label = f"grid {args.side} x {args.side}"
    edbs = graph_edbs(src, dst, weights, source)
    print(f"graph: {label}, {n} vertices, {src.shape[0]} directed edges, "
          f"made in {time.perf_counter() - t0:.3f} s", flush=True)
    runs = []
    for program in args.programs.split(","):
        for mode in args.modes.split(","):
            r = run_one(program, edbs, n, src.shape[0], mode, want,
                        args.shards)
            print(f"{label}: {r['program']} {r['mode']}, shards "
                  f"{r['shards']}: wall "
                  f"{r['wall_s']:.4f} s, iterations {r['iterations']}, "
                  f"grow_retries {r['grow_retries']}, peak allocated "
                  f"{r['peak_allocated_bytes']} B, reserved "
                  f"{r['peak_reserved_bytes']} B, all-to-all "
                  f"{r['all_to_all_bytes']} B a shard, facts "
                  f"{'checked' if r['facts_checked'] else 'not checked'}",
                  flush=True)
            runs.append(r)
    print(json.dumps(runs))
    return runs


if __name__ == "__main__":
    main()
