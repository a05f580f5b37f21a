"""Andersen points-to analysis on the port (the paper's flagship domain)
with the optimizer ablation — the counterpart of
``examples/program_analysis.py``: the FlowLog plan (planner + SIP +
fusion + sharing) against the DDlog-style no-opt plan (all four off),
which must derive the same facts.

    PYTHONPATH=src python -m repro_torch.launch.program_analysis \\
        [--n-vars 120] [--seed 0] [--device cpu]

The program is the reference's synthesized one (``n_vars`` variables;
``n_vars / 2`` address-of, ``n_vars`` copy, ``n_vars / 3`` load and
``n_vars / 3`` store statements, uniform over the variables, from
``--seed``). Capacities come from the input: ``pt`` holds at most
``n_vars`` x the distinct address-of targets facts (``idb_cap``), and a
join row budget of ``n_vars**3 / 80`` (``intermediate_cap``; at least the
reference's 2**17) covers the largest join of either plan, about 0.0083
``n_vars**3`` rows at 240 to 480 variables on this generator. A budget of
2**31 rows or more is refused: the engine's row offsets are int32. A
capacity overflow grows the caps and reruns; the retries are printed, not
hidden.

Prints per plan the fixpoint's wall (``EngineStats.wall_s``), its
iterations, grow retries, ``pt`` facts, the peak device memory and the
launches of the engine's kernels. Runs on the card; ``--device cpu``
runs the plain torch path (the tests).
"""
from __future__ import annotations

import argparse

import numpy as np

ANDERSEN = """
.input addr      // p = &x
.input assign    // p = q
.input load      // p = *q
.input store     // *p = q
.output pt
pt(p, x) :- addr(p, x).
pt(p, x) :- assign(p, q), pt(q, x).
pt(p, x) :- load(p, q), pt(q, r), pt(r, x).
pt(r, x) :- store(p, q), pt(p, r), pt(q, x).
"""

MAX_JOIN_ROWS = 1 << 31     # the engine's row offsets are int32


def synthesize_program(n_vars=120, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "addr": rng.integers(0, n_vars, size=(n_vars // 2, 2)),
        "assign": rng.integers(0, n_vars, size=(n_vars, 2)),
        "load": rng.integers(0, n_vars, size=(n_vars // 3, 2)),
        "store": rng.integers(0, n_vars, size=(n_vars // 3, 2)),
    }


def capacities(n_vars: int, edbs: dict) -> dict:
    """``idb_cap`` from pt's bound, ``intermediate_cap`` from the join
    budget (see the module docstring)."""
    targets = len(np.unique(edbs["addr"][:, 1]))
    join_rows = max(1 << 17, n_vars ** 3 // 80)
    if join_rows >= MAX_JOIN_ROWS:
        raise ValueError(
            f"n_vars={n_vars}: a join budget of {join_rows} rows does not "
            f"fit the engine's int32 row offsets (< {MAX_JOIN_ROWS})")
    return dict(idb_cap=max(1 << 15, n_vars * targets),
                intermediate_cap=join_rows)


def main(argv=None) -> dict:
    """Runs both plans; returns {label: (pt, EngineStats, peak bytes or
    None, kernel launches)}."""
    import torch

    from repro_torch.core.optimizer import CompileOptions, compile_program
    from repro_torch.engine import Engine, EngineConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-vars", type=int, default=120)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    edbs = synthesize_program(args.n_vars, args.seed)
    caps = capacities(args.n_vars, edbs)
    print(f"andersen: {args.n_vars} variables (seed {args.seed}), "
          f"{sum(len(v) for v in edbs.values())} statements; {caps}")
    on_card = torch.device(args.device).type == "cuda"
    results = {}
    for label, opts in [
        ("flowlog (plan+sip)", CompileOptions()),
        ("no-opt (DDlog-like)", CompileOptions(
            use_planner=False, use_sip=False, use_fusion=False,
            use_sharing=False)),
    ]:
        cp = compile_program(ANDERSEN, opts)
        eng = Engine(cp, EngineConfig(device=args.device, **caps))
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        out, stats = eng.run(edbs)
        launches = {k: v for k, v in launch_counts().items() if v}
        peak = torch.cuda.max_memory_allocated() if on_card else None
        results[label] = (out["pt"], stats, peak, launches)
        print(f"{label:22s} {stats.wall_s:9.4f}s  "
              f"pt={out['pt'].shape[0]:9d} "
              f"iters={stats.total_iterations} "
              f"grow_retries={stats.grow_retries} "
              f"peak={'n/a' if peak is None else f'{peak} B'} "
              f"launches={launches}", flush=True)
        del eng, out
        if on_card:
            torch.cuda.empty_cache()
    first, *rest = [r[0] for r in results.values()]
    assert all(np.array_equal(first, r) for r in rest), \
        "optimizations must not change semantics"
    print("program_analysis OK")
    return results


if __name__ == "__main__":
    main()
