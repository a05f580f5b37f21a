"""Deterministic fault injection for the resilience layer (engine/
resilience.py; tests/test_resilience.py drives it).

A ``FaultPlan`` is a list of ``FaultSpec``s, each naming a *fault
site* — a string identifier compiled into the engine at host-side
decision points (never inside a jitted trace, so injection can raise
without corrupting a compilation) — plus a hit window and a fault
kind. ``fault_point(site)`` is a no-op unless a plan is installed
(``install``), so production runs pay one truthiness check per site.

Fault kinds:

* ``crash``    — raises ``SimulatedCrash``: the process "dies" at that
  point. Harnesses catch it, throw the in-memory engine away, and
  restart from durable state (snapshot + update-log replay).
* ``io``       — raises ``FaultError``: a transient IO failure
  (modelled on a failed write/fsync) that surfaces to the caller.
* ``overflow`` — raises the engine's ``OverflowError_``: a capacity
  exhaustion, the input to the graceful-degradation ladder.

Hit counting is per concrete site name and monotonic across the life
of the plan, so a plan threaded through a crash/restart cycle (the
differential harness keeps ONE plan across restarts) fires each spec
exactly in its window and then goes quiet — that is what makes
randomized crash schedules reproducible from a seed.

Fault sites currently compiled in:

  engine.run            — top of a batch fixpoint (``Engine._run_once``)
  engine.stratum        — entry of every stratum body (both engines)
  engine.rule_pass      — entry of every maintenance rule pass (both
                          engines; the sharded engine uses the same name
                          so plans are engine-portable)
  incremental.apply     — top of ``IncrementalEngine.apply``
  incremental.maintain  — before each per-stratum maintenance strategy
  checkpoint.write      — before checkpoint array serialization (io)
  checkpoint.commit     — before the atomic ``os.replace`` publish
  checkpoint.retention  — after publish, before retention cleanup
  wal.before_append     — before a WAL record is written (crash here
                          loses the un-acknowledged batch — correct)
  wal.write             — the WAL write itself (io)
  wal.after_append      — after fsync, before apply (the logged-but-
                          not-applied crash the replay path must absorb)
  resilience.after_log  — in ``DurableIncrementalEngine.apply`` between
                          log append and maintenance
"""
from __future__ import annotations

import contextlib
import random
from dataclasses import dataclass

KINDS = ("crash", "io", "overflow")


class FaultError(RuntimeError):
    """Simulated IO failure injected at a named fault site."""


class SimulatedCrash(Exception):
    """Simulated process death injected at a named fault site.

    Deliberately NOT a RuntimeError: nothing in the engine catches it,
    so it unwinds to the harness like a real crash would."""


@dataclass(frozen=True)
class FaultSpec:
    """Fire ``kind`` at ``site`` for hit counts in [hit, last].

    ``site`` may end with ``*`` to prefix-match (e.g. ``checkpoint.*``).
    ``last=0`` means fire exactly once (at ``hit``); ``last=-1`` means
    fire forever from ``hit`` on."""
    site: str
    kind: str = "crash"
    hit: int = 1
    last: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")

    def matches(self, site: str, count: int) -> bool:
        if self.site.endswith("*"):
            if not site.startswith(self.site[:-1]):
                return False
        elif site != self.site:
            return False
        if count < self.hit:
            return False
        last = self.hit if self.last == 0 else self.last
        return last < 0 or count <= last


class FaultPlan:
    """A deterministic schedule of injected faults.

    ``fire(site)`` counts the hit and raises if any spec's window
    covers it; ``fired`` logs every injection as (site, count, kind)
    so tests can assert the schedule actually exercised something."""

    def __init__(self, specs=()):
        self.specs: list[FaultSpec] = list(specs)
        self.counts: dict[str, int] = {}
        self.fired: list[tuple[str, int, str]] = []

    @classmethod
    def seeded(cls, seed: int, sites, n_faults: int = 3,
               max_hit: int = 10, kinds=("crash",)) -> "FaultPlan":
        """Randomized-but-reproducible plan: ``n_faults`` specs drawn
        from ``sites`` x ``kinds`` with hit counts in [1, max_hit]."""
        rng = random.Random(seed)
        sites = list(sites)
        specs = [FaultSpec(site=rng.choice(sites),
                           kind=rng.choice(list(kinds)),
                           hit=rng.randint(1, max_hit))
                 for _ in range(n_faults)]
        return cls(specs)

    def fire(self, site: str) -> None:
        count = self.counts.get(site, 0) + 1
        self.counts[site] = count
        for spec in self.specs:
            if spec.matches(site, count):
                self.fired.append((site, count, spec.kind))
                raise _exception_for(spec.kind, site, count)

    def __repr__(self):
        return f"FaultPlan({self.specs!r}, fired={self.fired!r})"


def _exception_for(kind: str, site: str, count: int) -> BaseException:
    msg = f"injected {kind} at fault site {site!r} (hit {count})"
    if kind == "crash":
        return SimulatedCrash(msg)
    if kind == "io":
        return FaultError(msg)
    # lazy import: engine.py imports this module for fault_point
    from repro_torch.engine.engine import OverflowError_
    return OverflowError_(msg)


# ambient plan stack (mirrors observe.py's activation pattern): the
# innermost installed plan receives every fault_point
_ACTIVE: list[FaultPlan] = []


def active() -> FaultPlan | None:
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def install(plan: FaultPlan):
    """Install ``plan`` for the dynamic extent of the with-block."""
    _ACTIVE.append(plan)
    try:
        yield plan
    finally:
        _ACTIVE.remove(plan)


def fault_point(site: str) -> None:
    """Host-side injection hook. No-op unless a plan is installed."""
    if _ACTIVE:
        _ACTIVE[-1].fire(site)
