"""Incremental Datalog serving on the port — the counterpart of
``examples/incremental_serving.py``: materialize views over a live fact
stream, answer after every update batch, track latency.

    PYTHONPATH=src python -m repro_torch.launch.incremental_serving \\
        [--updates 30] [--hosts 200] [--durable [DIR]] [--mode device]
    PYTHONPATH=src python -m repro_torch.launch.incremental_serving \\
        --graph kronecker --scale 20 --mode device --durable
    PYTHONPATH=src python -m repro_torch.launch.incremental_serving \\
        --shards 8 --device cpu

The view: which hosts the monitoring target reaches over the links,
avoiding quarantined hosts (negation), and each one's hop count (a MIN
monoid). ``--graph random`` is the reference example's graph (``--hosts``
hosts, 4 random links each, target 0, hosts 7 and 23 quarantined);
``--graph kronecker`` serves the Graph500 graph of
``launch/fixpoint.py`` at ``--scale`` (target the vertex of largest
out-degree, 1% of the vertices quarantined). Every update batch inserts
3 random links and deletes 2 present ones, drawn from a generator seeded
as the reference example seeds it.

``--durable [DIR]`` serves through the durability layer
(engine/resilience.py): every batch is write-ahead logged before it is
applied and the state snapshots every 10 batches. The demo injects a
simulated crash mid-stream (engine/faults.py) and a transient capacity
overflow in two maintenance rule passes, restarts from snapshot + log
replay, and prints the ``resilience.*`` counters. The port runs every
rule pass eagerly, so the overflow fires in either ``--mode``.

``--shards N`` (N >= 2) serves the same stream from the sharded engine
(engine/shard.py), N shards on the one device, as the reference
example's ``--shards`` does on its mesh.

Runs on the card; ``--device cpu`` runs the plain torch path (the
tests).
"""
from __future__ import annotations

import argparse
import contextlib
import tempfile
import time

import numpy as np

# network reachability monitoring: link updates stream in; the view is
# which hosts can reach the monitoring target, avoiding quarantined ones
PROGRAM = """
.input link
.input monitor
.input quarantined
.output reaches
reaches(x) :- monitor(x).
reaches(y) :- reaches(x), link(x, y), !quarantined(y).
.output pathlen
pathlen(x, MIN(0)) :- monitor(x).
pathlen(y, MIN(d + 1)) :- pathlen(x, d), link(x, y), !quarantined(y).
"""

SNAPSHOT_EVERY = 10


def serving_edbs(graph: str, hosts: int, scale: int, rng) -> dict:
    """The EDBs a serve starts from (see the module docstring)."""
    if graph == "random":
        return {"link": rng.integers(0, hosts, size=(hosts * 4, 2)),
                "monitor": np.array([[0]]),
                "quarantined": np.array([[7], [23]])}
    from repro_torch.launch.fixpoint import EDGE_FACTOR, kronecker_edges
    n = 1 << scale
    src, dst, _ = kronecker_edges(scale, EDGE_FACTOR, int(rng.integers(1 << 31)))
    target = int(np.argmax(np.bincount(src, minlength=n)))
    quarantined = rng.choice(n, size=max(1, n // 100), replace=False)
    quarantined = quarantined[quarantined != target]
    return {"link": np.stack([src, dst], axis=1),
            "monitor": np.array([[target]]),
            "quarantined": quarantined[:, None]}


def main(argv=None) -> dict:
    """Serve the stream; returns the final view."""
    from repro_torch.core.optimizer import compile_program
    from repro_torch.engine import EngineConfig, Observation, make_engine
    from repro_torch.engine import faults as F

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--updates", type=int, default=30)
    ap.add_argument("--hosts", type=int, default=200,
                    help="--graph random: the number of hosts")
    ap.add_argument("--graph", choices=("random", "kronecker"),
                    default="random")
    ap.add_argument("--scale", type=int, default=16,
                    help="--graph kronecker: 2**scale hosts")
    ap.add_argument("--mode", choices=("host", "device"), default="host")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=0,
                    help="N >= 2: the sharded engine, N shards on the "
                         "device")
    ap.add_argument("--durable", nargs="?", const="", default=None,
                    metavar="DIR",
                    help="serve through the durable resilience layer "
                         "(WAL + snapshots in DIR, default a tempdir), "
                         "with a mid-stream crash/recover demo")
    args = ap.parse_args(argv)
    if args.shards < 0:
        ap.error(f"--shards: a shard count, not {args.shards}")

    rng = np.random.default_rng(1)
    edbs = serving_edbs(args.graph, args.hosts, args.scale, rng)
    n_hosts = args.hosts if args.graph == "random" else 1 << args.scale
    if args.graph == "random":
        caps = dict(idb_cap=1 << 12, intermediate_cap=1 << 14)
    else:   # every IDB fact is keyed by a host, every join row is a link
        caps = dict(idb_cap=n_hosts,
                    intermediate_cap=len(edbs["link"]) + 3 * args.updates)

    # the engine's own metrics layer measures each apply() from the
    # inside: maintenance latency (excluding snapshot export) and the
    # IDB rows actually changed per batch — engine/observe.py
    obs = Observation("serving")
    cfg = EngineConfig(mode=args.mode, device=args.device, observe=obs,
                       shards=args.shards, **caps)
    cp = compile_program(PROGRAM)
    tmp = None
    plan = None
    if args.durable is not None:
        from repro_torch.engine.resilience import (
            DurableIncrementalEngine, ResilienceConfig,
        )
        state_dir = args.durable
        if not state_dir:
            tmp = tempfile.TemporaryDirectory()
            state_dir = tmp.name
        rcfg = ResilienceConfig(snapshot_every=SNAPSHOT_EVERY)

        def fresh():
            return DurableIncrementalEngine(
                cp, cfg, directory=state_dir, resilience=rcfg)
        dur = fresh()
        inc = dur.inc
        # the demo's fault schedule: one crash between WAL append and
        # apply, plus a transient overflow the ladder must absorb
        plan = F.FaultPlan([
            F.FaultSpec("resilience.after_log", kind="crash",
                        hit=max(2, args.updates // 2)),
            F.FaultSpec("engine.rule_pass", kind="overflow",
                        hit=30, last=31),
        ])
    else:
        dur = None
        inc = make_engine(cp, cfg, incremental=True)

    try:
        t0 = time.perf_counter()
        out = (dur or inc).initialize(edbs)
        print(f"initialized: {out['reaches'].shape[0]} reachable hosts "
              f"({time.perf_counter() - t0:.2f}s)"
              + (f" [durable, state in {state_dir}]" if dur else ""))

        crashes = 0
        with (F.install(plan) if plan else contextlib.nullcontext()):
            for step in range(args.updates):
                ins = rng.integers(0, n_hosts, size=(3, 2))
                cur = inc.edbs["link"]
                dele = cur[rng.permutation(len(cur))[:2]]
                batch = dict(inserts={"link": ins}, deletes={"link": dele})
                if dur is None:
                    out = inc.apply(**batch)
                    continue
                while True:
                    try:
                        out = dur.apply(**batch)
                        break
                    except F.SimulatedCrash:
                        crashes += 1
                        dur.close()
                        dur = fresh()
                        inc = dur.inc
                        dur.recover()   # snapshot + WAL replay
                        print(f"  step {step}: simulated crash — recovered "
                              f"at seq {dur.applied_seq}, re-submitting")

        lat = obs.registry.percentiles("update.latency_s")
        dlt = obs.registry.percentiles("update.delta_rows")
        strategies = {
            k.split(".", 1)[1]: v
            for k, v in obs.registry.counters_snapshot(
                "incremental.").items()
            if k.split(".", 1)[1] in ("seed-insert", "dred", "recompute")}
        print(f"{lat['count']} update batches: "
              f"maintenance p50={lat['p50'] * 1e3:.0f}ms "
              f"p99={lat['p99'] * 1e3:.0f}ms max={lat['max'] * 1e3:.0f}ms, "
              f"delta rows p50={dlt['p50']:.0f} max={dlt['max']:.0f}")
        print(f"strategies: {strategies}, "
              f"view={out['reaches'].shape[0]} hosts, "
              f"max hop count={out['pathlen'][:, 1].max()}")
        if dur is not None:
            res = obs.registry.counters_snapshot("resilience.")
            ladder = {k.rsplit(".", 1)[1]: v for k, v in res.items()
                      if k.startswith("resilience.ladder.")}
            print(f"resilience: {crashes} crash(es) absorbed, "
                  f"{res.get('resilience.replayed_updates', 0)} update(s) "
                  f"replayed from the WAL, "
                  f"{res.get('resilience.snapshots', 0)} snapshot(s), "
                  f"ladder rungs fired: {ladder or 'none'}")
            dur.checkpoint()
    finally:
        if dur is not None:
            dur.close()
        if tmp is not None:
            tmp.cleanup()
    print("incremental_serving OK")
    return out


if __name__ == "__main__":
    main()
