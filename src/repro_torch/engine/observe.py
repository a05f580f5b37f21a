"""Engine-wide observability — the instrumentation contract.

A copy of ``repro.engine.observe`` (pure Python). Its notes on jit,
device mode, memo-jit and trace-time counting describe the JAX engine;
the torch engine runs eagerly in host mode, so rule spans measure real
execution (``phase="eval"``) and counters advance once per call.

FlowLog's pitch is an explicit per-rule IR separating recursive control
from logical plans; this module makes the *runtime* side of that split
visible: every engine layer reports what it does, to whom, and at what
cost, through two primitives that are zero-overhead when unused.

The two primitives
==================

``MetricsRegistry``
    Counters, gauges, and histograms under explicit dotted names, with
    nested **scoped windows** (``registry.scope()``) that attribute
    counter deltas to one block while outer scopes keep seeing totals —
    the generalization of the old ``relation.counter_scope()``. One
    process-global instance, ``REGISTRY``, absorbs the former global
    ``relation.COUNTERS`` (the ``arrange.*`` namespace) plus the
    trace-time launch counters every layer now emits; per-``Observation``
    registries hold run-scoped metrics (update latencies, delta sizes).

``Observation``
    A structured span tracer attached to ``EngineConfig.observe``.
    Spans form a tree (``with obs.span(name, **attrs):``), carry wall
    times and attributes, and record the global-counter delta accrued
    inside them, so any span can answer "how many sorts / kernel probes
    / all-to-alls did this emit". Exporters:

    * ``to_chrome_trace()`` — Chrome ``trace_event`` JSON (one
      ``traceEvents`` list of complete ``"X"`` events), loadable in
      Perfetto / ``chrome://tracing``;
    * ``fixpoint_report()`` — a human-readable per-stratum iteration /
      delta-cardinality table plus per-rule time share;
    * ``to_dict()`` — a stable dict (``schema_version`` pinned) that
      ``benchmarks/run.py`` embeds in ``results/bench.json`` rows.

What is traced at which layer
=============================

* **compile** (``core/optimizer/pipeline.py``) — one span per optimizer
  stage per rule variant (plan/sip/fusion) and per whole-program pass
  (sharing, verify), under an ambient observation
  (``Observation.activate()``); ``compile_program`` is engine-free, so
  activation is how the CLI / bench attaches the tracer.
* **engine** (``engine.py``) — ``run`` > ``stratum s<i>`` > ``init`` /
  ``iteration <k>`` / ``final`` spans. Host mode reads per-iteration
  delta cardinalities from the loop's *existing* termination reads
  (``int(delta.n)`` — a sync the host loop always performs), so
  observe-on adds **no** host syncs inside jitted steps; each iteration
  span carries ``deltas`` (rows per IDB). Device mode hides iterations
  inside ``lax.while_loop`` — its stratum span records the post-hoc
  summary (iteration count from the loop carry, no per-iteration
  cardinalities) and says so (``detail="post-hoc"``).
* **rule passes** — per-rule spans (``rule <head> [v<k>]``) are emitted
  while the pass *traces* (inside ``jax.jit``), so they measure
  trace/lowering cost and launch-counter attribution per rule, not
  steady-state execution (one compiled step is opaque below the
  iteration span); they carry ``phase="trace"``. With ``jit=False``
  they measure real execution.
* **graph memo** (``Engine._memo_get``, the counterpart of the
  reference's ``_memo_jit``) — the port traces nothing, so these count
  device mode's captured CUDA graphs (on the CPU, the entries whose
  iteration runs eagerly over the same static buffers):
  ``memo_jit.hit`` (a stratum loop replayed an entry: no warm-up, no
  capture), ``memo_jit.miss`` (an entry warmed up and captured) and
  ``memo_jit.retrace`` (a structural key captured again at new
  capacities or carry structure, dropping its old entry: an auto-grow
  or ladder growth) per observation; ``engine.graph_captures`` on the
  global REGISTRY counts the captures on the card.
* **auto-grow** — ``engine.grow_retries`` counter + a ``grow-retry``
  span per overflow retry with the doubled capacities.
* **arrangements** (``relation.py`` / ``relops.py``) — the ``arrange.*``
  counters (sorts, merge_sorted, cache hit/miss/fastpath) are global
  trace-time counters: under jit they advance once per *compilation*,
  counting ops emitted into the graph — exactly the per-iteration
  launch counts ``benchmarks/arrange.py`` reports.
* **relops / kernels** (``relops.py``, ``backend.py``) — trace-time op
  launch counters ``relops.*`` (join/membership/merge/dedupe/reduce)
  and per-backend kernel-dispatch counters ``kernel.<backend>.*``
  (probe, segment_reduce, merge_ranks, expand).
* **sharding** (``shard.py``) — every padded-bucket all-to-all counts
  ``shard.all_to_all.launches`` / ``.slots`` / ``.bytes`` at trace
  time: the padded buffer IS the wire volume (each launch moves the
  whole ``[S, cap, arity]`` buffer regardless of live rows), so the
  byte counter is exact, static, and free. Host-side gathers/scatters
  get real-time spans. In the port one thread runs each shard's body;
  the reference traces that body once, so the port records its spans
  and counters from shard 0 only (``muted``): the counts are one
  shard's, per call.
* **incremental** (``incremental.py``) — ``apply`` > per-stratum
  maintenance spans tagged with the chosen strategy (``seed-insert`` /
  ``dred`` / ``recompute``), DRed round counts, and per-update
  histograms in the observation registry: ``update.latency_s``,
  ``update.delta_rows`` (IDB-level rows changed per apply).

Zero-overhead contract
======================

``EngineConfig.observe=None`` (the default) short-circuits every hook
to an attribute check; no span objects exist, no jax ops are added, and
fixpoints are byte-identical with the layer on OR off (the observe
equivalence suite in tests/test_observe.py pins observe-on vs
observe-off byte-identical outputs and iteration counts across
jnp/pallas/sharded/incremental configs). The always-on global counters
are plain Python int increments at *trace* time (amortized across every
memoized execution), the same cost class as the old
``relation.COUNTERS``.

This module imports nothing from the engine (stdlib only), so every
layer — including ``relation.py`` at the bottom and
``core/optimizer/pipeline.py`` outside the engine — can import it
without cycles.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Optional

# stable schema for to_dict() / bench rows; bump on breaking changes to
# the exported dict/trace structure so downstream report tooling can
# branch on it
SCHEMA_VERSION = 1


# -- metrics registry ---------------------------------------------------------

class MetricsRegistry:
    """Counters, gauges, histograms under dotted names, with nested
    scoped delta windows. Values are plain Python numbers — never
    tensors — so touching the registry can neither add device ops nor
    force a sync."""

    def __init__(self):
        self._counters: dict[str, int] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, list[float]] = {}

    # counters ---------------------------------------------------------------
    def inc(self, name: str, amount: int = 1) -> None:
        self._counters[name] = self._counters.get(name, 0) + amount

    def get(self, name: str, default: int = 0) -> int:
        return self._counters.get(name, default)

    def set(self, name: str, value: int) -> None:
        """Direct counter write — exists for the relation.COUNTERS
        back-compat shim (reset_counters); new code should inc()."""
        self._counters[name] = value

    # gauges -----------------------------------------------------------------
    def gauge(self, name: str, value: float) -> None:
        self._gauges[name] = value

    def get_gauge(self, name: str, default: float = 0.0) -> float:
        return self._gauges.get(name, default)

    # histograms -------------------------------------------------------------
    def observe(self, name: str, value: float) -> None:
        self._hists.setdefault(name, []).append(float(value))

    def percentiles(self, name: str,
                    qs: tuple = (50, 99)) -> Optional[dict]:
        xs = sorted(self._hists.get(name, ()))
        if not xs:
            return None
        out = {"count": len(xs), "sum": sum(xs),
               "min": xs[0], "max": xs[-1]}
        for q in qs:
            # nearest-rank percentile; no numpy dependency down here
            idx = min(len(xs) - 1, max(0, round(q / 100 * len(xs)) - 1))
            out[f"p{q}"] = xs[idx]
        return out

    # windows ----------------------------------------------------------------
    def counters_snapshot(self, prefix: str = "") -> dict[str, int]:
        return {k: v for k, v in self._counters.items()
                if k.startswith(prefix)}

    @contextlib.contextmanager
    def scope(self, prefix: str = ""):
        """Scoped counter window: yields a dict that, on exit, holds the
        counter deltas accumulated inside the block (restricted to
        ``prefix``). The registry itself keeps accumulating — outer
        scopes still see totals — so nested windows compose, which is
        what lets one bench attribute launch counts to one config while
        other live engines trace concurrently (the old
        ``relation.counter_scope`` contract, generalized)."""
        before = self.counters_snapshot(prefix)
        window: dict[str, int] = {}
        try:
            yield window
        finally:
            after = self.counters_snapshot(prefix)
            for k in set(after) | set(before):
                window[k] = after.get(k, 0) - before.get(k, 0)

    def snapshot(self) -> dict:
        """Full registry state as plain data (stable bench/export form)."""
        return {
            "counters": dict(self._counters),
            "gauges": dict(self._gauges),
            "histograms": {k: self.percentiles(k)
                           for k in self._hists},
        }


# The process-global trace-time registry: launch counters every layer
# emits unconditionally (plain int increments at trace time). The
# ``arrange.*`` namespace is the former relation.COUNTERS.
REGISTRY = MetricsRegistry()


# Per-thread switch: the sharded engine's worker threads of shards 1 to
# S - 1 run with it set, so every span and counter of a shard body is
# recorded once, by shard 0 (the reference traces that body once).
_THREAD = threading.local()


def muted() -> bool:
    """Whether this thread records no spans and counts nothing."""
    return getattr(_THREAD, "muted", False)


@contextlib.contextmanager
def mute(on: bool = True):
    """Turn this thread's spans and counters off (``on``) for a block."""
    prev = muted()
    _THREAD.muted = on
    try:
        yield
    finally:
        _THREAD.muted = prev


def trace_count(name: str, amount: int = 1) -> None:
    """Global trace-time launch counter (see REGISTRY). Under jit these
    advance while *tracing* — once per compilation — which is exactly
    the per-iteration launch count structural benches report."""
    if not muted():
        REGISTRY.inc(name, amount)


# -- spans --------------------------------------------------------------------

class Span:
    """One node of the trace tree. Times are perf_counter seconds
    relative to the observation's origin; ``counters`` holds the global
    REGISTRY counter delta accrued while the span was open."""

    __slots__ = ("name", "t0", "t1", "attrs", "children", "counters")

    def __init__(self, name: str, t0: float, attrs: dict):
        self.name = name
        self.t0 = t0
        self.t1: Optional[float] = None
        self.attrs = attrs
        self.children: list[Span] = []
        self.counters: dict[str, int] = {}

    @property
    def dur(self) -> float:
        return (self.t1 if self.t1 is not None else self.t0) - self.t0

    def find(self, name: str) -> list["Span"]:
        """All descendant spans (self included) with this exact name."""
        out = [self] if self.name == name else []
        for c in self.children:
            out += c.find(name)
        return out

    def tree_lines(self, depth: int = 0) -> list[str]:
        extras = ""
        if self.attrs:
            extras = " " + " ".join(
                f"{k}={v}" for k, v in sorted(self.attrs.items()))
        lines = [f"{'  ' * depth}{self.name}"
                 f" [{self.dur * 1e3:.1f}ms]{extras}"]
        for c in self.children:
            lines += c.tree_lines(depth + 1)
        return lines

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "t0_s": round(self.t0, 6),
            "dur_s": round(self.dur, 6),
            "attrs": dict(self.attrs),
            "counters": {k: v for k, v in self.counters.items() if v},
            "children": [c.to_dict() for c in self.children],
        }


# Ambient observation stack: lets engine-free layers (compile_program)
# attach spans without threading an object through every signature.
_ACTIVE: list["Observation"] = []


def ambient() -> Optional["Observation"]:
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def ambient_span(name: str, **attrs):
    """Span on the ambient observation, no-op when none is active —
    the hook engine-free code (the optimizer pipeline) uses."""
    obs = ambient()
    if obs is None:
        yield None
        return
    with obs.span(name, **attrs) as sp:
        yield sp


@contextlib.contextmanager
def span(obs: Optional["Observation"], name: str, **attrs):
    """Span helper tolerating ``obs=None`` (the zero-overhead default):
    engine layers write ``with O.span(self._obs, ...)`` unconditionally
    and pay one None check when observability is off."""
    if obs is None or muted():
        yield None
        return
    with obs.span(name, **attrs) as sp:
        yield sp


def count(obs: Optional["Observation"], name: str,
          amount: int = 1) -> None:
    """Observation-scoped counter, no-op when obs is None."""
    if obs is not None and not muted():
        obs.registry.inc(name, amount)


class Observation:
    """A tracing session: attach to ``EngineConfig.observe`` (engine
    layers pick it up), and/or ``activate()`` it around compilation so
    ambient spans land in it. Reusable across runs — spans accumulate
    under successive roots."""

    def __init__(self, label: str = "observe"):
        self.label = label
        self.registry = MetricsRegistry()   # run-scoped metrics
        self.roots: list[Span] = []
        self._stack: list[Span] = []
        self._origin = time.perf_counter()

    # -- recording -----------------------------------------------------------
    def _now(self) -> float:
        return time.perf_counter() - self._origin

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        sp = Span(name, self._now(), attrs)
        before = dict(REGISTRY._counters)
        if self._stack:
            self._stack[-1].children.append(sp)
        else:
            self.roots.append(sp)
        self._stack.append(sp)
        try:
            yield sp
        finally:
            self._stack.pop()
            sp.t1 = self._now()
            after = REGISTRY._counters
            sp.counters = {
                k: after.get(k, 0) - before.get(k, 0)
                for k in set(after) | set(before)
                if after.get(k, 0) != before.get(k, 0)}

    def event(self, name: str, **attrs) -> None:
        """Zero-duration marker under the current span."""
        sp = Span(name, self._now(), attrs)
        sp.t1 = sp.t0
        if self._stack:
            self._stack[-1].children.append(sp)
        else:
            self.roots.append(sp)

    @contextlib.contextmanager
    def activate(self):
        """Make this the ambient observation (for compile tracing and
        other engine-free layers)."""
        _ACTIVE.append(self)
        try:
            yield self
        finally:
            _ACTIVE.remove(self)

    # -- queries -------------------------------------------------------------
    def find(self, name: str) -> list[Span]:
        return [sp for r in self.roots for sp in r.find(name)]

    # -- exporters -----------------------------------------------------------
    def to_chrome_trace(self) -> dict:
        """Chrome ``trace_event`` JSON object format: complete ("X")
        events with microsecond timestamps, loadable in Perfetto /
        chrome://tracing. Counter deltas and attributes ride in
        ``args``."""
        events: list[dict] = []

        def emit(sp: Span, depth: int):
            args = {str(k): v for k, v in sp.attrs.items()}
            if sp.counters:
                args["counters"] = dict(sp.counters)
            events.append({
                "name": sp.name,
                "cat": self.label,
                "ph": "X",
                "ts": round(sp.t0 * 1e6, 3),
                "dur": round(sp.dur * 1e6, 3),
                "pid": 1,
                "tid": 1,
                "args": args,
            })
            for c in sp.children:
                emit(c, depth + 1)

        for r in self.roots:
            emit(r, 0)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"label": self.label,
                          "schema_version": SCHEMA_VERSION},
        }

    def save_chrome_trace(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)

    def stratum_summary(self) -> list[dict]:
        """Per-stratum iteration/delta table from the span tree (host
        mode carries per-iteration cardinalities; device mode the
        post-hoc iteration count only)."""
        out = []
        for st in self.find("stratum"):
            iters = st.find("iteration")[0:]
            iters = [s for s in iters if s is not st]
            deltas = [s.attrs.get("delta_rows") for s in iters]
            out.append({
                "stratum": st.attrs.get("key"),
                "mode": st.attrs.get("mode"),
                "iterations": st.attrs.get(
                    "iterations", len(iters)),
                "delta_trajectory": [d for d in deltas
                                     if d is not None],
                "wall_s": round(st.dur, 6),
            })
        return out

    def rule_summary(self) -> list[dict]:
        """Per-rule trace-time share (phase="trace" spans; see module
        docstring for what per-rule time means under jit)."""
        agg: dict[str, dict] = {}
        for sp in self.find("rule"):
            key = sp.attrs.get("head", "?")
            label = f"{key} [{sp.attrs.get('rule', '?')}]"
            a = agg.setdefault(label, {"rule": label, "head": key,
                                       "spans": 0, "wall_s": 0.0,
                                       "counters": {}})
            a["spans"] += 1
            a["wall_s"] += sp.dur
            for k, v in sp.counters.items():
                a["counters"][k] = a["counters"].get(k, 0) + v
        total = sum(a["wall_s"] for a in agg.values()) or 1.0
        rows = sorted(agg.values(), key=lambda a: -a["wall_s"])
        for a in rows:
            a["wall_s"] = round(a["wall_s"], 6)
            a["share"] = round(a["wall_s"] / total, 3)
        return rows

    def fixpoint_report(self) -> str:
        """Human-readable fixpoint profile: per-stratum iteration /
        delta table, per-rule time share, and the run-scoped metrics."""
        lines = [f"== fixpoint report: {self.label} =="]
        lines.append("-- strata --")
        for row in self.stratum_summary():
            traj = row["delta_trajectory"]
            tr = ("deltas=" + ",".join(str(d) for d in traj)
                  if traj else f"detail={row['mode']}")
            lines.append(
                f"  {row['stratum']}: {row['iterations']} iter(s), "
                f"{row['wall_s'] * 1e3:.1f}ms, {tr}")
        rules = self.rule_summary()
        if rules:
            lines.append("-- rules (trace-time share) --")
            for a in rules:
                lines.append(
                    f"  {a['share'] * 100:5.1f}%  "
                    f"{a['wall_s'] * 1e3:7.1f}ms  {a['rule']}")
        snap = self.registry.snapshot()
        if any(snap.values()):
            lines.append("-- metrics --")
            for k, v in sorted(snap["counters"].items()):
                lines.append(f"  {k} = {v}")
            for k, v in sorted(snap["gauges"].items()):
                lines.append(f"  {k} = {v}")
            for k, p in sorted(snap["histograms"].items()):
                if p:
                    lines.append(
                        f"  {k}: n={p['count']} p50={p['p50']:.4g} "
                        f"p99={p['p99']:.4g} max={p['max']:.4g}")
        if not self.roots:
            lines.append("  (no spans recorded)")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        """Stable embedding form for bench rows (results/bench.json)."""
        return {
            "schema_version": SCHEMA_VERSION,
            "label": self.label,
            "strata": self.stratum_summary(),
            "rules": self.rule_summary(),
            "metrics": self.registry.snapshot(),
            "span_count": sum(1 for r in self.roots
                              for _ in _walk(r)),
        }


def _walk(sp: Span):
    yield sp
    for c in sp.children:
        yield from _walk(c)


def validate_chrome_trace(trace: dict) -> list[str]:
    """Schema check for the exported Chrome trace: returns a list of
    violations (empty = valid). Used by the test suite so the export
    format cannot bitrot."""
    errs = []
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        return ["missing traceEvents list"]
    for i, ev in enumerate(trace["traceEvents"]):
        for field in ("name", "ph", "ts", "pid", "tid"):
            if field not in ev:
                errs.append(f"event {i}: missing {field!r}")
        if ev.get("ph") == "X" and "dur" not in ev:
            errs.append(f"event {i} ({ev.get('name')}): X without dur")
        if not isinstance(ev.get("ts", 0), (int, float)):
            errs.append(f"event {i}: non-numeric ts")
    return errs
