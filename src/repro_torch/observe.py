"""``python -m repro_torch.observe`` — fixpoint profiler / trace exporter,
after ``repro.observe``.

Runs a demo Datalog fixpoint with the engine's observability layer
(``repro_torch.engine.observe``) attached, prints the fixpoint report
(per-stratum iteration/delta table, per-rule time share, metrics), and
optionally exports a Chrome ``trace_event`` JSON loadable in Perfetto /
``chrome://tracing``, checked against its schema and for the fixpoint's
spans.

Usage::

    python -m repro_torch.observe                          # demo TC
    python -m repro_torch.observe --demo monitor           # 3 strata
    python -m repro_torch.observe --trace /tmp/trace.json  # Chrome trace
    python -m repro_torch.observe --updates 20             # + update stream
    python -m repro_torch.observe --check /tmp/trace.json  # validate a file
    python -m repro_torch.observe --json                   # stable dict

The flags are the reference's, with ``--device cuda|cpu`` (default the
card; raises without one) in place of its ``--backend jnp|pallas``: the
port's kernel wrappers choose by the tensors' device. ``--check`` reads
the file only and touches no device.

The demos are the reference's, scaled by ``--size``. Their capacities
are the reference's (``idb_cap`` 2**13, ``intermediate_cap`` 2**15),
raised when ``--size`` needs more: a fact keyed by a node (the monitor
demo's views) and a join row drawn from an EDB row then fit without a
grow retry, which would otherwise rerun the fixpoint up to eight times at
a size such as 2**20. ``--mode device`` shows the post-hoc summary path
(the iterations run inside one captured CUDA graph replayed per read, so
per-iteration delta cardinalities exist in host mode only).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


# -- built-in demo programs (scaled by --size) --------------------------------

def _demo_tc(size: int):
    src = """
    .input edge
    .output tc
    tc(x,y) :- edge(x,y).
    tc(x,z) :- tc(x,y), edge(y,z).
    """
    rng = np.random.default_rng(0)
    edges = rng.integers(0, size, size=(size * 2, 2))
    return src, {"edge": edges}


def _demo_monitor(size: int):
    # 2 strata: recursive reachability + monoid shortest hop count,
    # then a stratified negation view — exercises stratum spans,
    # monoid merge, and antijoin in one trace.
    src = """
    .input link
    .input monitor
    .output reaches
    reaches(x) :- monitor(x).
    reaches(y) :- reaches(x), link(x, y).
    .output pathlen
    pathlen(x, MIN(0)) :- monitor(x).
    pathlen(y, MIN(d + 1)) :- pathlen(x, d), link(x, y).
    .output dark
    dark(x) :- link(x, _), !reaches(x).
    """
    rng = np.random.default_rng(0)
    links = rng.integers(0, size, size=(size * 3, 2))
    return src, {"link": links, "monitor": np.array([[0]])}


DEMOS = {"tc": _demo_tc, "monitor": _demo_monitor}

# the fixpoint's spans a trace must hold (host mode adds the iterations
# and rule passes; device mode has the stratum summary only)
REQUIRED_SPANS = {"host": {"run", "stratum", "iteration", "rule"},
                  "device": {"run", "stratum"}}


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def demo_caps(size: int, edbs: dict) -> dict:
    """The reference CLI's capacities, raised to the demo's size (see the
    module docstring)."""
    rows = max(len(v) for v in edbs.values())
    return dict(idb_cap=max(1 << 13, _pow2_at_least(size)),
                intermediate_cap=max(1 << 15, _pow2_at_least(2 * rows)))


def run_demo(args):
    """The demo of ``args`` under an ``Observation`` -> (observation, the
    output relations, the EDBs they were derived from: after
    ``--updates``, the maintained ones)."""
    from repro_torch.core.optimizer import compile_program
    from repro_torch.engine import EngineConfig, make_engine
    from repro_torch.engine import observe as O

    src, edbs = DEMOS[args.demo](args.size)
    obs = O.Observation(f"demo:{args.demo}")
    with obs.activate():
        compiled = compile_program(src)
    cfg = EngineConfig(mode=args.mode, device=args.device,
                       shards=args.shards, observe=obs,
                       **demo_caps(args.size, edbs))

    if args.updates:
        inc = make_engine(compiled, cfg, incremental=True)
        try:
            out = inc.initialize(edbs)
            rng = np.random.default_rng(1)
            name, rows = next(iter(edbs.items()))
            hi = int(rows.max()) + 1
            for _ in range(args.updates):
                ins = rng.integers(0, hi, size=(3, rows.shape[1]))
                cur = inc.edbs[name]    # the mirror: sorted, distinct
                dele = cur[rng.permutation(len(cur))[:2]]
                out = inc.apply(inserts={name: ins}, deletes={name: dele})
            edbs = inc.edbs
        finally:
            _close(inc.engine)
    else:
        eng = make_engine(compiled, cfg)
        try:
            out, _stats = eng.run(edbs)
        finally:
            _close(eng)
    return obs, out, edbs


def _close(engine) -> None:
    """Stops a sharded engine's worker threads (a plain one has none)."""
    close = getattr(engine, "close", None)
    if close is not None:
        close()


def trace_errors(trace: dict, mode: str) -> list[str]:
    """Schema violations of a Chrome trace, then the required spans it
    lacks."""
    from repro_torch.engine.observe import validate_chrome_trace
    errs = validate_chrome_trace(trace)
    names = {e.get("name") for e in trace.get("traceEvents", [])}
    need = REQUIRED_SPANS[mode]
    return errs + [f"missing {m!r} span(s)" for m in sorted(need - names)]


def report(args, obs) -> int:
    """Prints the run's report (``--json``: the stable dict) and writes
    and checks the ``--trace``; returns the exit code."""
    if args.json:
        print(json.dumps(obs.to_dict(), indent=2, default=str))
    else:
        print(obs.fixpoint_report())

    if args.trace:
        obs.save_chrome_trace(args.trace)
        trace = obs.to_chrome_trace()
        errs = trace_errors(trace, args.mode)
        if errs:
            print(f"trace INVALID ({len(errs)} violation(s)):")
            for e in errs:
                print(f"  {e}")
            return 1
        need = REQUIRED_SPANS[args.mode]
        print(f"trace: {args.trace} "
              f"({len(trace['traceEvents'])} events, schema ok, "
              f"spans: {', '.join(sorted(need))})")
    return 0


def _check(path: str) -> int:
    from repro_torch.engine.observe import validate_chrome_trace
    with open(path) as f:
        trace = json.load(f)
    errs = validate_chrome_trace(trace)
    if errs:
        print(f"{path}: INVALID ({len(errs)} violation(s))")
        for e in errs:
            print(f"  {e}")
        return 1
    print(f"{path}: valid Chrome trace "
          f"({len(trace['traceEvents'])} events)")
    return 0


def parse_args(argv: list[str] | None = None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.observe",
        description="Fixpoint profiler: run a demo with tracing on, "
                    "print the report, export/validate Chrome traces")
    ap.add_argument("--demo", choices=sorted(DEMOS), default="tc")
    ap.add_argument("--size", type=int, default=64,
                    help="demo graph node count (default 64)")
    ap.add_argument("--mode", choices=("host", "device"), default="host")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the engine runs (default the card)")
    ap.add_argument("--shards", type=int, default=0)
    ap.add_argument("--updates", type=int, default=0,
                    help="also run N incremental update batches and "
                         "report per-update latency")
    ap.add_argument("--trace", metavar="PATH",
                    help="export Chrome trace_event JSON here")
    ap.add_argument("--json", action="store_true",
                    help="print the stable dict (bench row form) "
                         "instead of the report")
    ap.add_argument("--check", metavar="PATH",
                    help="validate an existing trace file and exit")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    if args.check:
        return _check(args.check)
    obs, _out, _edbs = run_demo(args)
    return report(args, obs)


if __name__ == "__main__":
    sys.exit(main())
