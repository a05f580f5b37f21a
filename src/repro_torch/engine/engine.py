"""Semi-naive, stratum-by-stratum fixpoint engine (paper Sec. 2.2, 3),
host mode, on one device — the counterpart of ``repro.engine.engine``.

Python drives the iteration loop; each iteration runs the plan's relops
eagerly on ``EngineConfig.device`` (the card by default; an engine asked
for CUDA without one raises rather than falling back to the CPU). The
loop reads, once per iteration, each IDB's delta size and the overflow
flag together, which decides termination. Capacity overflow (bounded
join outputs; relation.py) retries the run with doubled capacities
(``auto_grow``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.core import ir as I
from repro_torch.engine import faults as F
from repro_torch.engine import observe as O
from repro_torch.engine import relops as R
from repro_torch.engine.backend import KernelDispatch, resolve_backend
from repro_torch.engine.lower import Env, Evaluator, LowerConfig
from repro_torch.engine.relation import (
    Relation, UNSORTED, empty, from_numpy, live_mask, pow2_cap,
    to_numpy, to_numpy_with_val,
)
from repro_torch.engine.semiring import PRESENCE, Semiring, monoid_for


@dataclass
class EngineConfig:
    idb_cap: int = 1 << 14
    idb_caps: dict = field(default_factory=dict)      # per-IDB override
    intermediate_cap: int = 1 << 15
    max_iters: int = 100_000
    # "host" only: the device-resident loop is not ported yet
    mode: str = "host"
    auto_grow: bool = True
    max_grow_retries: int = 8
    semiring: Semiring = PRESENCE  # execution algebra (Sec. 8)
    # arrangement layer (relation.py docstring): share arrangements per
    # evaluation pass, skip no-op arranges via the sort-order witness,
    # and maintain full arrangements by rank merge. False = sort per op;
    # the fixpoints are byte-identical either way.
    arrangements: bool = True
    # runtime arrangement sanitizer (core/analysis/sanitize.py): False,
    # True (every stratum boundary) or N >= 2 (every Nth boundary)
    check_invariants: "bool | int" = False
    # span tracing (engine/observe.py); None short-circuits every hook
    observe: Optional["O.Observation"] = None
    # where relations live and relops run; "cuda" runs the hand-written
    # kernels (csrc/), "cpu" their plain torch versions
    device: str = "cuda"


@dataclass
class EngineStats:
    iterations: dict = field(default_factory=dict)    # stratum -> n_iters
    delta_sizes: dict = field(default_factory=dict)   # stratum -> [sizes]
    wall_s: float = 0.0
    grow_retries: int = 0
    total_facts: dict = field(default_factory=dict)
    # the capacities the run completed at
    effective_caps: dict = field(default_factory=dict)

    @property
    def total_iterations(self) -> int:
        return sum(self.iterations.values())


class OverflowError_(RuntimeError):
    pass


def _resolve_device(spec: str) -> torch.device:
    device = torch.device(spec)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"EngineConfig.device={spec!r} but no CUDA device is "
            f"available; pass device='cpu' to run the plain torch path")
    return device


class Engine:
    """Executes a CompiledProgram over EDB data."""

    def __init__(self, compiled: I.CompiledProgram,
                 config: EngineConfig | None = None):
        self.compiled = compiled
        self.cfg = config or EngineConfig()
        if self.cfg.mode != "host":
            raise NotImplementedError(
                f"mode={self.cfg.mode!r}: only mode='host' is ported; the "
                f"device-resident loop is queued in ROADMAP.md "
                f"('Device mode')")
        self.device = _resolve_device(self.cfg.device)
        self.backend: KernelDispatch = resolve_backend("auto", self.device)
        self.monoid: dict[str, tuple[Semiring, int]] = {}
        for name, (func, vpos) in compiled.monoid_idbs.items():
            self.monoid[name] = (monoid_for(func), vpos)
        # effective capacities: attempt-local growth state; run() doubles
        # these on overflow and restores the entry caps when it returns
        self._intermediate_cap = int(self.cfg.intermediate_cap)
        self._idb_cap_default = int(self.cfg.idb_cap)
        self._idb_caps = dict(self.cfg.idb_caps)
        # stratum-boundary counter for the sanitizer's sampling mode
        self._sanitize_count = 0

    # -- effective capacities -------------------------------------------------
    @property
    def intermediate_cap(self) -> int:
        return self._intermediate_cap

    def _idb_cap(self, name: str) -> int:
        return int(self._idb_caps.get(name, self._idb_cap_default))

    def effective_caps(self) -> dict:
        return {"intermediate_cap": self._intermediate_cap,
                "idb_cap": self._idb_cap_default,
                "idb_caps": dict(self._idb_caps)}

    def set_caps(self, caps: dict) -> None:
        self._intermediate_cap = int(
            caps.get("intermediate_cap", self._intermediate_cap))
        self._idb_cap_default = int(
            caps.get("idb_cap", self._idb_cap_default))
        if "idb_caps" in caps:
            self._idb_caps = {k: int(v)
                              for k, v in caps["idb_caps"].items()}

    def grow_caps(self, factor: int = 2) -> dict:
        """Multiply every effective capacity; returns the new caps."""
        self._intermediate_cap *= factor
        self._idb_cap_default *= factor
        self._idb_caps = {k: v * factor for k, v in self._idb_caps.items()}
        return self.effective_caps()

    # -- helpers -------------------------------------------------------------
    def _sr_of(self, name: str) -> Semiring:
        if name in self.monoid:
            return self.monoid[name][0]
        return self.cfg.semiring

    def _stored_arity(self, name: str) -> int:
        a = self.compiled.arities[name]
        if name in self.monoid:
            a -= 1
        return max(a, 1)

    def _empty_idb(self, name: str) -> Relation:
        sr = self._sr_of(name)
        return empty(self._idb_cap(name), self._stored_arity(name),
                     sr.identity if sr.has_value else None,
                     device=self.device)

    def _zero_flag(self) -> torch.Tensor:
        return torch.zeros((), dtype=torch.bool, device=self.device)

    def _split_monoid(self, name: str, rel: Relation) -> Relation:
        """Derived plan outputs carry the lattice value as a data column;
        split it into the val payload (Sec. 9)."""
        if name not in self.monoid:
            return rel
        sr, vpos = self.monoid[name]
        data_cols = [c for c in range(rel.arity) if c != vpos]
        data = rel.data[:, data_cols]
        val = torch.where(live_mask(rel), rel.data[:, vpos], sr.identity)
        # a column-subset view loses the sort guarantee
        return Relation(data, val.to(torch.int32), rel.n, order=UNSORTED)

    # -- plan evaluation ------------------------------------------------------
    def _merge_head(self, rels: list, sr: Semiring, cap: int):
        """Combine all derived relations for one head IDB into a single
        sorted distinct relation."""
        if len(rels) == 1:
            return R.dedupe(rels[0].data, rels[0].val, sr, cap,
                            backend=self.backend)
        return R.concat_all(rels, sr, cap, backend=self.backend)

    def _eval_plans(self, plans, env: Env, ev: Evaluator):
        """Evaluate plans, concat per head IDB -> derived relations."""
        obs = self.cfg.observe
        by_head: dict[str, list[Relation]] = {}
        for p in plans:
            with O.span(obs, "rule", head=p.head,
                        rule=("nonrec" if p.variant < 0
                              else f"v{p.variant}"),
                        phase="eval"):
                rel = ev.eval(p.root, env)
                rel = self._split_monoid(p.head, rel)
            by_head.setdefault(p.head, []).append(rel)
        out: dict[str, Relation] = {}
        for head, rels in by_head.items():
            merged, ov = self._merge_head(
                rels, self._sr_of(head), self._idb_cap(head))
            env.overflow = env.overflow | ov
            out[head] = merged
        return out

    def export_monoid(self, name: str, rel: Relation) -> np.ndarray:
        """Re-attach a monoid IDB's lattice value as a column."""
        data, val = to_numpy_with_val(rel)
        _, vpos = self.monoid[name]
        cols = []
        di = 0
        for c in range(self.compiled.arities[name]):
            if c == vpos:
                cols.append(val)
            else:
                cols.append(data[:, di])
                di += 1
        return np.stack(cols, axis=1) if cols else data

    # -- stratum bodies -------------------------------------------------------
    def _ground_relation(self, sp: I.StratumPlan, name: str) -> Relation:
        """Ground facts for one IDB as a Relation."""
        facts = sp.facts.get(name, [])
        sr = self._sr_of(name)
        if not facts:
            return self._empty_idb(name)
        arr = np.array(facts, dtype=np.int64)
        if name in self.monoid:
            _, vpos = self.monoid[name]
            vals = arr[:, vpos]
            dcols = [c for c in range(arr.shape[1]) if c != vpos]
            arr = arr[:, dcols] if dcols else np.zeros(
                (len(vals), 1), np.int64)
            return from_numpy(
                arr, self._idb_cap(name), val=vals,
                val_identity=sr.identity, dedupe=False, device=self.device)
        if arr.shape[1] == 0:
            arr = np.zeros((arr.shape[0], 1), np.int64)
        return from_numpy(arr, self._idb_cap(name), device=self.device)

    def _stratum_init(self, rels, init_rels, nonrec, idbs, ev,
                      monoid_names):
        """Facts + nonrecursive rules once -> initial (full, delta)."""
        cache = ev.begin_pass()
        env = Env(dict(rels), self.compiled.shared, monoid_names,
                  device=self.device)
        derived = self._eval_plans(nonrec, env, ev)
        state = {}
        for name in idbs:
            full0 = init_rels[name]
            if name in derived:
                sr = self._sr_of(name)
                full0, delta0, ov = R.merge_with_delta(
                    full0, derived[name], sr, self._idb_cap(name),
                    backend=self.backend, cache=cache,
                    incremental=self.cfg.arrangements)
                env.overflow = env.overflow | ov
            else:
                delta0 = full0
            state[name] = (full0, delta0)
        return state, env.overflow

    def _stratum_iter(self, state, base, rec, idbs, ev, monoid_names):
        """One semi-naive iteration -> (new_state, overflow). One
        ``ArrangementCache`` spans the whole iteration."""
        cache = ev.begin_pass()
        inc = self.cfg.arrangements
        env_rels = dict(base)
        ovf = self._zero_flag()
        for name in idbs:
            full, delta = state[name]
            sr = self._sr_of(name)
            full_new, ov = R.merge(full, delta, sr, self._idb_cap(name),
                                   backend=self.backend, incremental=inc)
            ovf = ovf | ov
            env_rels[(name, I.FULL)] = full
            env_rels[(name, I.FULL_OLD)] = full
            env_rels[(name, I.DELTA)] = delta
            env_rels[(name, I.FULL_NEW)] = full_new
        env = Env(env_rels, self.compiled.shared, monoid_names,
                  device=self.device)
        derived = self._eval_plans(rec, env, ev)
        new_state = {}
        for name in idbs:
            sr = self._sr_of(name)
            full_new = env_rels[(name, I.FULL_NEW)]
            if name in derived:
                nf, nd, ov = R.merge_with_delta(
                    full_new, derived[name], sr, self._idb_cap(name),
                    backend=self.backend, cache=cache, incremental=inc)
                ovf = ovf | ov
            else:
                nf = full_new
                nd = self._empty_idb(name)
            new_state[name] = (nf, nd)
        return new_state, ovf | env.overflow

    def _stratum_seed(self, given, idbs, ev):
        """Seeded semi-naive continuation entry: merge each IDB's seed
        delta into its stored full arrangement -> (full, delta) state."""
        cache = ev.begin_pass()
        state = {}
        ovf = self._zero_flag()
        for name in idbs:
            full, seed = given[name]
            sr = self._sr_of(name)
            if seed is None:
                state[name] = (full, self._empty_idb(name))
            else:
                nf, nd, ov = R.merge_with_delta(
                    full, seed, sr, self._idb_cap(name),
                    backend=self.backend, cache=cache,
                    incremental=self.cfg.arrangements)
                ovf = ovf | ov
                state[name] = (nf, nd)
        return state, ovf

    # -- runtime invariant sanitizer (core/analysis/sanitize.py) ---------------
    _sanitize_layer = "engine"

    def _sanitize_due(self) -> bool:
        ci = self.cfg.check_invariants
        if not ci:
            return False
        self._sanitize_count += 1
        n = 1 if ci is True else int(ci)
        return n <= 1 or self._sanitize_count % n == 0

    def _sanitize_env(self, env, where: str) -> None:
        """Validate every stored arrangement when cfg.check_invariants is
        set; the sanitizer reads numpy, so it gets host copies."""
        if not self._sanitize_due():
            return
        from repro_torch.core.analysis.sanitize import sanitize_env
        host = {k: Relation(r.data.cpu(),
                            None if r.val is None else r.val.cpu(),
                            r.n.cpu(), order=r.order)
                for k, r in env.items()}
        sanitize_env(self, host, where, self._sanitize_layer)

    # -- stratum execution ----------------------------------------------------
    def _run_stratum(self, sp: I.StratumPlan, env_rels, stats,
                     stratum_key, init_state=None):
        with O.span(self.cfg.observe, "stratum", key=stratum_key,
                    mode=self.cfg.mode,
                    recursive=bool(sp.recursive)) as st_span:
            return self._run_stratum_body(
                sp, env_rels, stats, stratum_key, init_state, st_span)

    def _run_stratum_body(self, sp: I.StratumPlan, env_rels, stats,
                          stratum_key, init_state=None, st_span=None):
        F.fault_point("engine.stratum")
        base_env_rels = env_rels
        obs = self.cfg.observe
        cfg = self.cfg
        ev = Evaluator(LowerConfig(self.intermediate_cap, cfg.semiring,
                                   self.backend, cfg.arrangements))
        monoid_names = set(self.monoid)
        idbs = sorted(sp.idbs)
        nonrec = [p for p in sp.plans if p.variant == -1]
        rec = [p for p in sp.plans if p.variant >= 0]

        if init_state is not None:
            with O.span(obs, "seed"):
                state, ovf = self._stratum_seed(init_state, idbs, ev)
        else:
            init_rels = {name: self._ground_relation(sp, name)
                         for name in idbs}
            with O.span(obs, "init", nonrec_rules=len(nonrec)):
                state, ovf = self._stratum_init(
                    dict(base_env_rels), init_rels, nonrec, idbs, ev,
                    monoid_names)
        if bool(ovf):
            raise OverflowError_(f"overflow during init of {stratum_key}")

        if not sp.recursive or not rec:
            full_env = dict(base_env_rels)
            for name in idbs:
                full_env[(name, I.FULL)] = state[name][0]
            stats.iterations[stratum_key] = 0
            if st_span is not None:
                st_span.attrs["iterations"] = 0
            self._sanitize_env(full_env, f"stratum {stratum_key} boundary")
            return full_env

        stratum_iters = 0
        delta_log = []
        sizes = {n: int(state[n][1].n) for n in idbs}
        while not all(v == 0 for v in sizes.values()):
            delta_total = sum(sizes.values())
            delta_log.append(delta_total)
            with O.span(obs, "iteration", index=stratum_iters,
                        delta_rows=delta_total,
                        deltas=dict(sizes) if obs else None):
                state, ovf = self._stratum_iter(
                    state, base_env_rels, rec, idbs, ev, monoid_names)
                # one device-to-host read per iteration: the overflow
                # flag and every delta size together
                flags = torch.stack(
                    [ovf.to(torch.int32)]
                    + [state[n][1].n for n in idbs]).tolist()
                sizes = dict(zip(idbs, flags[1:]))
            if flags[0]:
                raise OverflowError_(
                    f"overflow in stratum {stratum_key} "
                    f"iter {stratum_iters}")
            stratum_iters += 1
            if stratum_iters >= cfg.max_iters:
                raise RuntimeError(
                    f"no fixpoint after {cfg.max_iters} iterations")

        # final merge of the (empty) last deltas into the fulls
        with O.span(obs, "final-merge"):
            full_env = dict(base_env_rels)
            for name in idbs:
                full, delta = state[name]
                merged, ov = R.merge(full, delta, self._sr_of(name),
                                     self._idb_cap(name),
                                     backend=self.backend,
                                     incremental=cfg.arrangements)
                if bool(ov):
                    raise OverflowError_(f"overflow finalizing {name}")
                full_env[(name, I.FULL)] = merged
        stats.iterations[stratum_key] = stratum_iters
        stats.delta_sizes[stratum_key] = delta_log
        if st_span is not None:
            st_span.attrs["iterations"] = stratum_iters
        self._sanitize_env(full_env, f"stratum {stratum_key} boundary")
        return full_env

    # -- public ---------------------------------------------------------------
    def run(self, edbs: dict[str, np.ndarray],
            edb_caps: Optional[dict] = None) -> tuple[dict, EngineStats]:
        """Evaluate the program. Returns ({relation: np.ndarray}, stats).
        Monoid IDBs come back with the value re-attached as a column.
        Overflow retries grow the effective caps for this call only; the
        caps the run completed at are in ``stats.effective_caps``."""
        entry_caps = self.effective_caps()
        attempt = 0
        try:
            while True:
                try:
                    out, stats = self._run_once(edbs, edb_caps)
                    stats.grow_retries = attempt
                    stats.effective_caps = self.effective_caps()
                    return out, stats
                except OverflowError_:
                    attempt += 1
                    if not self.cfg.auto_grow or (
                            attempt > self.cfg.max_grow_retries):
                        raise
                    grown = self.grow_caps()
                    obs = self.cfg.observe
                    if obs is not None:
                        obs.registry.inc("engine.grow_retries")
                        obs.event(
                            "grow-retry", attempt=attempt,
                            intermediate_cap=grown["intermediate_cap"],
                            idb_cap=grown["idb_cap"])
        finally:
            self.set_caps(entry_caps)

    def _edb_env(self, edbs, edb_caps) -> dict:
        """Host EDB arrays -> (name, FULL) Relation environment."""
        env_rels: dict[tuple[str, str], Relation] = {}
        for name in self.compiled.edbs:
            arity = max(self.compiled.arities.get(name, 1), 1)
            data = np.asarray(edbs.get(name, np.zeros((0, arity))))
            if data.ndim == 1:
                data = data[:, None]
            if data.shape[1] == 0:
                data = np.zeros((data.shape[0], 1), np.int64)
            if data.shape[1] != arity:
                raise ValueError(
                    f"EDB {name}: expected arity {arity}, "
                    f"got {data.shape[1]}")
            cap = (edb_caps or {}).get(name, pow2_cap(data.shape[0]))
            env_rels[(name, I.FULL)] = from_numpy(data, cap,
                                                  device=self.device)
        return env_rels

    def _export(self, env_rels, stats) -> dict:
        out: dict[str, np.ndarray] = {}
        for name in self.compiled.arities:
            key = (name, I.FULL)
            if key not in env_rels:
                continue
            rel = env_rels[key]
            if name in self.monoid:
                out[name] = self.export_monoid(name, rel)
            else:
                out[name] = to_numpy(rel)
            stats.total_facts[name] = out[name].shape[0]
        return out

    def _run_once(self, edbs, edb_caps):
        F.fault_point("engine.run")
        t0 = time.perf_counter()
        stats = EngineStats()
        with O.span(self.cfg.observe, "run",
                    strata=len(self.compiled.strata),
                    mode=self.cfg.mode, shards=1,
                    backend=type(self.backend).__name__):
            env_rels = self._edb_env(edbs, edb_caps)
            for sp in self.compiled.strata:
                env_rels = self._run_stratum(
                    sp, env_rels, stats, f"s{sp.index}")
            out = self._export(env_rels, stats)
        stats.wall_s = time.perf_counter() - t0
        self.last_env = env_rels
        return out, stats
