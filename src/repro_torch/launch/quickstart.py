"""Quickstart on the port — the counterpart of ``examples/quickstart.py``:
write a Datalog program, run it batch, then update it incrementally (the
FlowLog workflow, paper Secs. 1-3).

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]

Runs on the card; ``--device cpu`` runs the plain torch path (the tests).
"""
from __future__ import annotations

import argparse

import numpy as np

PROGRAM = """
// multi-hop reachability with an excluded-node filter (negation)
.input edge
.input source
.input blocked
.output reach
reach(x) :- source(x).
reach(y) :- reach(x), edge(x, y), !blocked(y).

// connected components via recursive MIN aggregation (paper Sec. 9)
.output cc
cc(x, MIN(x)) :- edge(x, _).
cc(y, MIN(y)) :- edge(_, y).
cc(x, MIN(i)) :- edge(y, x), cc(y, i).
cc(x, MIN(i)) :- edge(x, y), cc(y, i).
"""

CAPS = dict(idb_cap=1 << 12, intermediate_cap=1 << 14)


def edbs() -> dict:
    """The example's inputs: 120 random edges over 50 nodes (seed 0),
    source 0, node 13 blocked."""
    rng = np.random.default_rng(0)
    return {"edge": rng.integers(0, 50, size=(120, 2)),
            "source": np.array([[0]]),
            "blocked": np.array([[13]])}


def main(argv=None) -> dict:
    """Runs the example; returns {"batch": the batch run's relations,
    "updated": the relations after the update}."""
    from repro_torch.core.optimizer import CompileOptions, compile_program
    from repro_torch.engine import Engine, EngineConfig, IncrementalEngine

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    inputs = edbs()
    edges = inputs["edge"]

    # -- 1. compile: front-end -> structural optimizer -> fused IR
    compiled = compile_program(PROGRAM, CompileOptions())
    print("=== optimized IR (first stratum) ===")
    print(compiled.strata[1].plans[0].root.pretty()
          if len(compiled.strata) > 1 else
          compiled.strata[0].plans[0].root.pretty())

    # -- 2. batch evaluation
    engine = Engine(compiled, EngineConfig(device=args.device, **CAPS))
    out, stats = engine.run(inputs)
    print(f"\nreach: {out['reach'].shape[0]} nodes, "
          f"cc: {out['cc'].shape[0]} labeled, "
          f"iterations: {stats.iterations}, wall: {stats.wall_s:.3f}s")

    # -- 3. incremental maintenance (insert + delete)
    inc = IncrementalEngine(compiled, EngineConfig(device=args.device,
                                                   **CAPS))
    inc.initialize(inputs)
    upd = inc.apply(inserts={"edge": np.array([[0, 49], [49, 13]])},
                    deletes={"edge": edges[:2]})
    print(f"after update: reach={upd['reach'].shape[0]} "
          f"cc={upd['cc'].shape[0]}")
    assert set(upd) >= {"reach", "cc"}
    print("quickstart OK")
    return {"batch": out, "updated": upd}


if __name__ == "__main__":
    main()
