"""Incremental Datalog maintenance (paper Sec. 9 'Algebraic Semantics')
— the counterpart of ``repro.engine.incremental``.

FlowLog supports both batch and incremental execution from the same IR.
This module maintains materialized IDBs under EDB insertions/deletions
over whichever driver ``make_engine`` selects for the config (one
device, or ``shards >= 2`` -> ``ShardedEngine``); every maintenance pass
runs through the driver's hooks (``run_rule_pass``, ``_stored``,
``_host_relation``, ``_difference_stored``, ``_union_stored``), so the
seeded continuations and recomputes run whichever loop
``EngineConfig.mode`` selects (in device mode on one device, the
captured loop) and a sharded state stays home-partitioned.

Maintenance algorithm
=====================

* **Stratum pruning** — only strata downstream of a changed relation are
  touched (dependency closure over the stratified program); pure IR
  work.
* **Insertions** — seeded semi-naive continuation: every derivation
  using at least one inserted tuple is produced by re-evaluating each
  rule with one changed-relation occurrence retagged to scan only the
  inserted rows (``retag_scans``); the resulting seed delta then drives
  the normal semi-naive loop from the existing fixpoint
  (``Engine._stratum_seed``). Sound and complete for set semantics.
* **Deletions** — delete/re-derive (DRed, simplified): over-approximate
  deletable facts with the same seed trick against the *old* state,
  remove them, then re-derive survivors from the reduced state and
  continue to fixpoint. Monoid (MIN/MAX) IDBs, stratified aggregates
  and changes to a negated relation fall back to stratum recompute.

Host-side sets
==============

The reference keeps the EDB mirror, the before/after IDB diffs and the
DRed candidate frontier as Python sets of tuples, which at millions of
rows cost seconds and gigabytes. Here each is a ``_RowSet``: sorted,
distinct numpy keys, one per int32 row, ordered as the rows are
lexicographically (the column itself for one column, two columns
packed into an int64, wider rows as a structured view compared field by
field). A new set is sorted on the engine's device; membership is a
``searchsorted``, an insert an ``np.insert`` at the searched positions. The semantics are the reference's: inserts of
present rows and deletes of absent rows are dropped, every change array
is sorted and distinct, and the DRed rounds, candidate counts,
iteration counts and snapshots are the same.

The maintained state IS an arrangement (relation.py docstring): the
stored fulls stay sorted across updates, so a seeded continuation
reuses the final arrangement of the previous run directly — the seed
merge is the incremental ``relops.merge_sorted`` path, and each seed
pass opens one ``ArrangementCache`` so every retagged rule occurrence
shares the stored relations' per-key arrangements.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import ir as I
from repro_torch.engine import faults as F
from repro_torch.engine import observe as O
from repro_torch.engine.engine import EngineConfig, EngineStats
from repro_torch.engine.relation import (
    Relation, from_numpy, pow2_cap, to_numpy,
)

CHANGED = "changed"

_INT32 = np.iinfo(np.int32)
_SIGN = np.uint32(1 << 31)


# -- host row sets ------------------------------------------------------------

def _row_keys(rows: np.ndarray) -> np.ndarray:
    """int32 rows [n, k] -> [n] keys whose order is the rows'
    lexicographic order: the column for k = 1; for k = 2 the int64
    x * 2**32 + (y + 2**31) (the high half is x's bits, the low half y's
    with the sign bit flipped); wider rows as a structured view that
    numpy compares field by field."""
    k = rows.shape[1]
    if k == 1:
        return rows[:, 0].copy()
    if k == 2:
        keys = np.empty(len(rows), np.int64)
        halves = keys.view(np.uint32).reshape(-1, 2)
        hi, lo = (1, 0) if np.little_endian else (0, 1)
        halves[:, hi] = rows[:, 0].view(np.uint32)
        halves[:, lo] = rows[:, 1].view(np.uint32) ^ _SIGN
        return keys
    fields = np.dtype([(f"c{i}", "<i4") for i in range(k)])
    return np.ascontiguousarray(rows).view(fields).ravel()


def _key_rows(keys: np.ndarray, k: int) -> np.ndarray:
    """``_row_keys``' inverse."""
    if k == 1:
        return keys[:, None].copy()
    if k == 2:
        halves = keys.view(np.uint32).reshape(-1, 2)
        hi, lo = (1, 0) if np.little_endian else (0, 1)
        rows = np.empty((len(keys), 2), np.int32)
        rows[:, 0] = halves[:, hi].view(np.int32)
        rows[:, 1] = (halves[:, lo] ^ _SIGN).view(np.int32)
        return rows
    return np.ascontiguousarray(keys).view(np.int32).reshape(-1, k)


def _sorted_distinct(keys: np.ndarray, device) -> np.ndarray:
    """Sorted distinct keys. Integer keys are sorted on ``device`` (the
    engine's: a host sort of tens of millions of keys takes minutes on
    some hosts, the card's milliseconds); structured ones by numpy."""
    if keys.dtype.names is not None:
        return np.unique(keys)
    if len(keys) < 2 or bool(np.all(keys[1:] > keys[:-1])):
        return keys
    return torch.unique(torch.from_numpy(keys).to(device)).cpu().numpy()


def _member(sorted_keys: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """keys[i] in sorted_keys, for sorted distinct ``sorted_keys``."""
    m = len(sorted_keys)
    if m == 0:
        return np.zeros(len(keys), bool)
    idx = np.minimum(np.searchsorted(sorted_keys, keys), m - 1)
    return sorted_keys[idx] == keys


def _as_rows(rows, arity: int) -> np.ndarray:
    """An update batch or snapshot -> int32 rows [n, arity]; tolerates
    empty batches (a zero-row array cannot be reshaped with -1). Values
    must fit int32, as relations store them."""
    rows = np.asarray(rows)
    if rows.size == 0:
        return np.zeros((0, arity), np.int32)
    rows = rows.reshape(len(rows), -1)
    if rows.shape[1] != arity:
        raise ValueError(f"rows of {rows.shape[1]} columns where the "
                         f"relation has {arity}")
    if rows.dtype == np.int32:
        return rows
    if rows.min() < _INT32.min or rows.max() > _INT32.max:
        raise ValueError("row values must fit int32, as relations "
                         "store them")
    return rows.astype(np.int32)


class _RowSet:
    """A set of int32 rows of one arity, kept as sorted distinct keys;
    ``device`` sorts the keys of a new set or batch."""

    __slots__ = ("arity", "device", "keys", "_rows")

    def __init__(self, arity: int, rows=None, device="cpu"):
        self.arity = arity
        self.device = device
        self._set(self._batch(
            np.zeros((0, arity), np.int32) if rows is None else rows))

    def _set(self, keys: np.ndarray) -> None:
        self.keys = keys
        self._rows = None

    def copy(self) -> "_RowSet":
        """A set that later changes of this one leave as it is: ``_set``
        replaces the arrays and never writes into them, so they are
        shared."""
        out = _RowSet.__new__(_RowSet)
        out.arity, out.device = self.arity, self.device
        out.keys, out._rows = self.keys, self._rows
        return out

    def __len__(self) -> int:
        return len(self.keys)

    @property
    def rows(self) -> np.ndarray:
        """The rows, sorted and distinct, int32 [n, arity]: decoded once
        per change of the set, and read-only."""
        if self._rows is None:
            self._rows = _key_rows(self.keys, self.arity)
            self._rows.flags.writeable = False
        return self._rows

    def _batch(self, rows) -> np.ndarray:
        return _sorted_distinct(_row_keys(_as_rows(rows, self.arity)),
                                self.device)

    def add(self, rows) -> np.ndarray:
        """Insert rows; returns those that were absent, sorted and
        distinct."""
        keys = self._batch(rows)
        new = keys[~_member(self.keys, keys)]
        if len(new):
            self._set(np.insert(self.keys,
                                np.searchsorted(self.keys, new), new))
        return _key_rows(new, self.arity)

    def remove(self, rows) -> np.ndarray:
        """Delete rows; returns those that were present, sorted and
        distinct."""
        keys = self._batch(rows)
        old = keys[_member(self.keys, keys)]
        if len(old):
            self._set(np.delete(self.keys,
                                np.searchsorted(self.keys, old)))
        return _key_rows(old, self.arity)

    def difference(self, other: "_RowSet") -> np.ndarray:
        """Rows of self not in other, sorted and distinct."""
        return _key_rows(self.keys[~_member(other.keys, self.keys)],
                         self.arity)


# -- IR retagging -------------------------------------------------------------

def _unique_rules(plans: list[I.RulePlan]) -> list[I.RulePlan]:
    """One representative plan per source rule (variants collapse)."""
    seen: set[tuple[str, str]] = set()
    out = []
    for p in plans:
        key = (p.head, p.source)
        if key not in seen:
            seen.add(key)
            out.append(p)
    return out


def _retag_all_full(root: I.IR) -> I.IR:
    return I.retag_scans(root, lambda rel, idx: I.FULL)


def _count_occurrences(root: I.IR, rel: str) -> int:
    return sum(1 for n in I.iter_nodes(root)
               if isinstance(n, I.Scan) and n.rel == rel)


def _retag_one_changed(root: I.IR, rel: str, occ: int) -> I.IR:
    def version_of(r, idx):
        if r == rel and idx == occ:
            return CHANGED
        return I.FULL
    return I.retag_scans(root, version_of)


class IncrementalEngine:
    """Materialized-view maintenance over a CompiledProgram, one-device
    or sharded (``config.shards``), in either engine mode."""

    def __init__(self, compiled: I.CompiledProgram,
                 config: EngineConfig | None = None):
        from repro_torch.engine import make_engine
        self.compiled = compiled
        self.engine = make_engine(compiled, config)
        # the EDB mirror: name -> the current rows as a _RowSet
        self._mirror: dict[str, _RowSet] = {}
        self._env: dict[tuple[str, str], Relation] = {}
        self._stats = EngineStats()
        # relation -> strata indexes that (transitively) depend on it
        self._downstream = self._dependency_closure()

    @property
    def edbs(self) -> dict[str, np.ndarray]:
        """The EDB mirror: name -> current rows, sorted, distinct, int32."""
        return {name: s.rows for name, s in self._mirror.items()}

    # -- dependency analysis --------------------------------------------------
    def _dependency_closure(self) -> dict[str, set[int]]:
        produces: dict[int, set[str]] = {}
        consumes: dict[int, set[str]] = {}
        for sp in self.compiled.strata:
            produces[sp.index] = set(sp.idbs)
            cons = set()
            for p in sp.plans:
                for n in I.iter_nodes(p.root):
                    if isinstance(n, I.Scan):
                        cons.add(n.rel)
                for n in self._shared_scans(p.root):
                    cons.add(n)
            consumes[sp.index] = cons
        self._consumes = consumes
        # relations consumed in a NEGATED position (under an Antijoin's
        # right subtree) per stratum: a change there acts inverted on
        # the head, so such strata fall back to recompute
        self._neg_consumes = {
            sp.index: set().union(*(self._negated_scans(p.root)
                                    for p in sp.plans), set())
            for sp in self.compiled.strata}
        downstream: dict[str, set[int]] = {}

        def affected(rels: set[str]) -> set[int]:
            hit: set[int] = set()
            live = set(rels)
            for sp in self.compiled.strata:
                if consumes[sp.index] & live:
                    hit.add(sp.index)
                    live |= produces[sp.index]
            return hit

        for name in set(self.compiled.arities):
            downstream[name] = affected({name})
        return downstream

    def _negated_scans(self, root: I.IR) -> set[str]:
        """Relations scanned under any Antijoin's negated (right) side,
        expanding shared subplans."""

        def scans_under(node) -> set[str]:
            s: set[str] = set()
            for m in I.iter_nodes(node):
                if isinstance(m, I.Scan):
                    s.add(m.rel)
                elif isinstance(m, I.SharedRef):
                    s |= scans_under(self.compiled.shared[m.ref])
            return s

        out: set[str] = set()
        for n in I.iter_nodes(root):
            if isinstance(n, I.Antijoin):
                out |= scans_under(n.right)
            elif isinstance(n, I.SharedRef):
                out |= self._negated_scans(self.compiled.shared[n.ref])
        return out

    def _shared_scans(self, root: I.IR) -> set[str]:
        out: set[str] = set()
        for n in I.iter_nodes(root):
            if isinstance(n, I.SharedRef):
                sub = self.compiled.shared[n.ref]
                for m in I.iter_nodes(sub):
                    if isinstance(m, I.Scan):
                        out.add(m.rel)
                out |= self._shared_scans(sub)
        return out

    # -- public ----------------------------------------------------------------
    def _arity(self, name: str, rows=None) -> int:
        """Stored row width of a relation (a relation the program does
        not know takes its rows' width)."""
        if name not in self.compiled.arities and rows is not None and (
                np.asarray(rows).size):
            return np.asarray(rows).reshape(len(rows), -1).shape[1]
        return max(self.compiled.arities.get(name, 1), 1)

    def initialize(self, edbs: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        self._mirror = {k: self._row_set(self._arity(k, v), v)
                        for k, v in edbs.items()}
        out, stats = self.engine.run(edbs)
        if stats.grow_retries:
            # run() restores its entry caps on return, but the stored
            # fulls were materialized at the grown caps — keep
            # maintenance executing at the caps that worked
            self.engine.set_caps(stats.effective_caps)
        self._env = self.engine.last_env
        self._stats = stats
        return out

    def restore_mirror(self, rows_by_name: dict) -> None:
        """Replace the EDB mirror with these rows per EDB (a snapshot's,
        engine/resilience.py). Values outside int32 are refused with a
        ValueError, as in ``apply``."""
        self._mirror = {name: self._row_set(self._arity(name, rows), rows)
                        for name, rows in rows_by_name.items()}

    def rollback_point(self) -> tuple:
        """What a maintenance pass changes — the environment, the EDB
        mirror and the iteration counts — as a copy that ``rollback``
        gives back (the resilience ladder's retry point). Relations are
        never written in place and a ``_RowSet`` replaces its arrays, so
        shallow copies are enough."""
        return (dict(self._env),
                {k: s.copy() for k, s in self._mirror.items()},
                dict(self._stats.iterations))

    def rollback(self, point: tuple) -> None:
        """Return to the state of ``rollback_point``'s ``point``."""
        env, mirror, iterations = point
        self._env = dict(env)
        self._mirror = {k: s.copy() for k, s in mirror.items()}
        self._stats.iterations = dict(iterations)

    def _check_edbs(self, names) -> None:
        for name in names:
            if name not in self.compiled.edbs:
                raise ValueError(f"{name} is not an EDB")

    def _apply_to_mirror(self, inserts: dict, deletes: dict):
        """Inserts land, then deletes -> (rows actually inserted, rows
        actually deleted) per EDB, each sorted and distinct."""
        real_ins: dict[str, np.ndarray] = {}
        real_del: dict[str, np.ndarray] = {}
        for name, rows in inserts.items():
            mirror = self._mirror.setdefault(
                name, self._row_set(self._arity(name)))
            new = mirror.add(rows)
            if len(new):
                real_ins[name] = new
        for name, rows in deletes.items():
            mirror = self._mirror.get(name)
            if mirror is None:
                continue
            old = mirror.remove(rows)
            if len(old):
                real_del[name] = old
        return real_ins, real_del

    def apply(self, inserts: Optional[dict[str, np.ndarray]] = None,
              deletes: Optional[dict[str, np.ndarray]] = None
              ) -> dict[str, np.ndarray]:
        F.fault_point("incremental.apply")
        inserts = inserts or {}
        deletes = deletes or {}
        self._check_edbs(set(inserts) | set(deletes))
        real_ins, real_del = self._apply_to_mirror(inserts, deletes)
        changed = set(real_ins) | set(real_del)
        if not changed:
            return self.snapshot()

        obs = self.engine.cfg.observe
        idb_delta_rows = 0
        with O.span(obs, "apply",
                    changed=",".join(sorted(changed)),
                    insert_rows=sum(len(v) for v in real_ins.values()),
                    delete_rows=sum(len(v) for v in real_del.values()),
                    ) as ap_span:
            affected: set[int] = set()
            for name in changed:
                affected |= self._downstream.get(name, set())

            for name in changed:
                self._refresh_edb(name)

            # change sets grow as strata update (IDB-level diffs feed
            # downstream)
            ins_changes: dict[str, np.ndarray] = dict(real_ins)
            del_changes: dict[str, np.ndarray] = dict(real_del)
            for sp in self.compiled.strata:
                if sp.index not in affected:
                    continue
                consumed = self._consumes[sp.index]
                my_ins = {k: v for k, v in ins_changes.items()
                          if k in consumed}
                my_del = {k: v for k, v in del_changes.items()
                          if k in consumed}
                if not my_ins and not my_del:
                    continue
                old_snap = {n: self._snapshot_set(n) for n in sp.idbs}
                monoid_hit = any(n in self.compiled.monoid_idbs
                                 for n in sp.idbs)
                # stratified aggregates (Reduce) are order-sensitive in
                # their inputs: seeds over changed subsets would
                # aggregate partial groups, so recompute — except a
                # Reduce feeding a MIN/MAX monoid IDB (a partial-subset
                # MIN monoid-merges to the true MIN)
                agg_hit = any(
                    isinstance(n, I.Reduce)
                    for p in sp.plans
                    if p.head not in self.compiled.monoid_idbs
                    for n in I.iter_nodes(p.root))
                # a change to a relation this stratum NEGATES is
                # inverted and non-monotone on the head — seeds cannot
                # express it, so recompute
                neg_hit = bool((set(my_ins) | set(my_del))
                               & self._neg_consumes[sp.index])
                if agg_hit or neg_hit or (my_del and monoid_hit):
                    strategy = "recompute"
                elif my_del:
                    strategy = "dred"
                else:
                    strategy = "seed-insert"
                with O.span(obs, "maintain-stratum",
                            key=f"s{sp.index}", strategy=strategy):
                    F.fault_point("incremental.maintain")
                    O.count(obs, f"incremental.{strategy}")
                    if strategy == "recompute":
                        self._recompute_stratum(sp)
                    elif strategy == "dred":
                        self._dred_stratum(sp, my_ins, my_del)
                    else:
                        self._insert_stratum(sp, my_ins)
                # IDB-level diffs for downstream strata
                for n in sp.idbs:
                    new_snap = self._snapshot_set(n)
                    added = new_snap.difference(old_snap[n])
                    removed = old_snap[n].difference(new_snap)
                    idb_delta_rows += len(added) + len(removed)
                    if len(added):
                        ins_changes[n] = added
                    if len(removed):
                        del_changes[n] = removed
            # maintained arrangements must satisfy the same contract a
            # batch run leaves behind (core/analysis/sanitize.py); this
            # covers the seed-merge and DRed update paths
            self.engine._sanitize_env(self._env, "incremental apply",
                                      "incremental")
        if obs is not None:
            # per-update maintenance latency (the span closes before the
            # final snapshot export) + IDB-level churn per update
            obs.registry.observe("update.latency_s", ap_span.dur)
            obs.registry.observe("update.delta_rows", idb_delta_rows)
        return self.snapshot()

    def _rows(self, rel) -> np.ndarray:
        """Stored relation -> host rows (the one gather point)."""
        return to_numpy(self.engine._host_relation(rel))

    def _snapshot_idb(self, name: str) -> np.ndarray:
        rel = self._env.get((name, I.FULL))
        if rel is None:
            return np.zeros((0, self._arity(name)))
        if name in self.engine.monoid:
            return self.engine.export_monoid(
                name, self.engine._host_relation(rel))
        return self._rows(rel)

    def _row_set(self, arity: int, rows=None) -> _RowSet:
        return _RowSet(arity, rows, device=self.engine.device)

    def _snapshot_set(self, name: str) -> _RowSet:
        return self._row_set(self._arity(name), self._snapshot_idb(name))

    def _rel_from_rows(self, name: str, rows: np.ndarray) -> Relation:
        """Rows (with monoid value column re-attached, if any) -> Relation
        in stored layout."""
        rows = np.asarray(rows).reshape(len(rows), -1)
        cap = pow2_cap(len(rows))
        device = self.engine.device
        if name in self.engine.monoid:
            sr, vpos = self.engine.monoid[name]
            vals = rows[:, vpos]
            dcols = [c for c in range(rows.shape[1]) if c != vpos]
            data = rows[:, dcols] if dcols else np.zeros(
                (len(vals), 1), np.int64)
            return from_numpy(data, cap, val=vals, val_identity=sr.identity,
                              dedupe=False, device=device)
        return from_numpy(rows, cap, device=device)

    def _stored_from_rows(self, rows_by_name: dict[str, np.ndarray]) -> dict:
        return self.engine._stored(
            {name: self._rel_from_rows(name, rows)
             for name, rows in rows_by_name.items()})

    def _edb_rows(self, name: str) -> np.ndarray:
        """Current mirror rows for one EDB (sorted; empty-safe)."""
        mirror = self._mirror.get(name)
        if mirror is None:
            return np.zeros((0, self._arity(name)), np.int32)
        return mirror.rows

    def _refresh_edb(self, name: str) -> None:
        """Mirror -> stored EDB relation in the env."""
        rows = self._edb_rows(name)
        self._env[(name, I.FULL)] = self.engine._stored(
            {name: from_numpy(rows, pow2_cap(len(rows)),
                              device=self.engine.device)})[name]

    # -- recompute rungs --------------------------------------------------------
    def apply_base(self, inserts: Optional[dict] = None,
                   deletes: Optional[dict] = None) -> set:
        """Apply an update batch to the base EDB state only — the host
        mirror plus the stored EDB relations — WITHOUT maintaining any
        IDB. Returns the set of EDB names actually changed. Idempotent:
        re-applying rows already present (or deleting rows already
        absent) is a no-op, so a caller can re-base after a partially
        failed maintenance pass and recompute from a consistent EDB
        state."""
        inserts = inserts or {}
        deletes = deletes or {}
        self._check_edbs(set(inserts) | set(deletes))
        real_ins, real_del = self._apply_to_mirror(inserts, deletes)
        changed = set(real_ins) | set(real_del)
        for name in changed:
            self._refresh_edb(name)
        return changed

    def recompute_strata(self, changed: Optional[set] = None) -> None:
        """Recompute strata from the current EDB state through the
        engine (``_run_stratum``): every stratum when ``changed`` is
        None, else the dependency closure downstream of the changed
        relations, in stratum order so each recomputed IDB feeds later
        strata."""
        if changed is None:
            affected = {sp.index for sp in self.compiled.strata}
        else:
            affected = set()
            for name in changed:
                affected |= self._downstream.get(name, set())
        for sp in self.compiled.strata:
            if sp.index in affected:
                self._recompute_stratum(sp)

    def reinitialize(self) -> dict[str, np.ndarray]:
        """Full batch recompute from the current EDB mirror: re-runs the
        whole program and replaces the maintained state wholesale."""
        edbs = {name: self._edb_rows(name) for name in self._mirror}
        out, stats = self.engine.run(edbs)
        if stats.grow_retries:
            self.engine.set_caps(stats.effective_caps)
        self._env = self.engine.last_env
        self._stats = stats
        return out

    def snapshot(self) -> dict[str, np.ndarray]:
        out = {}
        for name in self.compiled.arities:
            key = (name, I.FULL)
            if key in self._env:
                out[name] = self._snapshot_idb(name)
        return out

    # -- internals --------------------------------------------------------------
    def _recompute_stratum(self, sp: I.StratumPlan) -> None:
        stats = EngineStats()
        env = {k: v for k, v in self._env.items()
               if k[0] not in sp.idbs}
        self._env = self.engine._run_stratum(env_rels=env, sp=sp,
                                             stats=stats,
                                             stratum_key=f"inc_s{sp.index}")
        self._stats.iterations[f"inc_s{sp.index}"] = (
            stats.iterations.get(f"inc_s{sp.index}", 0))

    def _seed_roots(self, sp: I.StratumPlan,
                    changed_names) -> list[tuple[str, I.IR]]:
        """Every rule with one changed-relation occurrence scanning only
        the changed rows."""
        roots: list[tuple[str, I.IR]] = []
        for p in _unique_rules(sp.plans):
            plain = _retag_all_full(p.root)
            for rel_name in sorted(changed_names):
                occs = _count_occurrences(plain, rel_name)
                for occ in range(occs):
                    roots.append(
                        (p.head, _retag_one_changed(plain, rel_name, occ)))
        return roots

    def _seed(self, sp: I.StratumPlan, changed_rows: dict,
              env_rels, restrict=None) -> dict:
        """Evaluate every rule with one changed-occurrence scan; union
        by head. ``changed_rows`` must already be in stored form.
        Changed IDB inputs from lower strata are handled by passing
        their full (already updated) relations — the seed only needs
        the changed occurrences because lower strata were updated
        first."""
        roots = self._seed_roots(sp, set(changed_rows))
        if not roots:
            return {}
        rels = dict(env_rels)
        for name, rel in changed_rows.items():
            rels[(name, CHANGED)] = rel
        memo_key = (sp.index, "seed", tuple(sorted(changed_rows)),
                    tuple(sorted(restrict)) if restrict else ())
        with O.span(self.engine.cfg.observe, "seed-pass",
                    stratum=f"s{sp.index}",
                    changed=",".join(sorted(changed_rows))):
            return self.engine.run_rule_pass(
                rels, roots, restrict=restrict, memo_key=memo_key,
                context=(f"stratum=s{sp.index} pass=seed "
                         f"changed={','.join(sorted(changed_rows))}"))

    def _insert_stratum(self, sp: I.StratumPlan,
                        inserts: dict[str, np.ndarray]) -> None:
        changed_rel = self._stored_from_rows(inserts)
        seeds = self._seed(sp, changed_rel, self._env)
        self._continue_fixpoint(sp, seeds)

    def _dred_stratum(self, sp, inserts, deletes) -> None:
        # 1. over-delete to FIXPOINT: candidates derivable from deleted
        #    tuples against the OLD state, propagated through stratum IDB
        #    occurrences until no new candidates (classic DRed phase 1).
        #    The env still holds old IDB fulls; changed EDB fulls are
        #    already new, so reconstruct the old EDB view for the seeds.
        del_rel = self._stored_from_rows(deletes)
        old_env = dict(self._env)
        for name, rows in deletes.items():
            # old view = new ∪ deleted (works for EDBs and lower IDBs)
            if name in self.engine.monoid:
                cur = self.engine.export_monoid(
                    name, self.engine._host_relation(
                        self._env[(name, I.FULL)]))
            else:
                cur = self._rows(self._env[(name, I.FULL)])
            allrows = np.concatenate([cur, rows]) if len(cur) else rows
            old_env[(name, I.FULL)] = self._stored_from_rows(
                {name: allrows})[name]

        # the "only facts that actually exist can be deleted" filter is
        # a semijoin against the current fulls, evaluated inside the
        # pass — only the small candidate set ever reaches the host
        obs = self.engine.cfg.observe
        exists = {n: self._env[(n, I.FULL)] for n in sp.idbs}
        candidates: dict[str, _RowSet] = {}
        rounds = 0
        with O.span(obs, "dred-candidates") as cand_span:
            frontier = del_rel
            while frontier:
                rounds += 1
                step = self._seed(sp, frontier, old_env, restrict=exists)
                new_rows: dict[str, np.ndarray] = {}
                for head, rel in step.items():
                    rows = self._rows(rel)
                    if head not in candidates:
                        candidates[head] = self._row_set(rows.shape[1])
                    new = candidates[head].add(rows)
                    if len(new):
                        new_rows[head] = new
                frontier = self._stored_from_rows(new_rows)
            if cand_span is not None:
                cand_span.attrs["rounds"] = rounds
                cand_span.attrs["candidate_rows"] = sum(
                    len(v) for v in candidates.values())
        O.count(obs, "incremental.dred_rounds", rounds)

        candidates_rel = self._stored_from_rows(
            {name: rows.rows for name, rows in candidates.items()
             if len(rows)})

        # 2. remove candidates from stored fulls
        with O.span(obs, "dred-remove"):
            for name, cand in candidates_rel.items():
                self._env[(name, I.FULL)] = (
                    self.engine._difference_stored(
                        self._env[(name, I.FULL)], cand))

        # 3. re-derive: run rules against the reduced state; anything still
        #    derivable (incl. candidates with alternate support) comes back
        #    through the standard fixpoint continuation.
        plain_roots = [(p.head, _retag_all_full(p.root))
                       for p in _unique_rules(sp.plans)]
        with O.span(obs, "dred-rederive"):
            rederive = self.engine.run_rule_pass(
                dict(self._env), plain_roots, restrict=candidates_rel,
                memo_key=(sp.index, "rederive",
                          tuple(sorted(candidates_rel))),
                context=f"stratum=s{sp.index} pass=dred-rederive")
        # 4. insertions seeded on the post-deletion state
        if inserts:
            ins_rel = self._stored_from_rows(inserts)
            ins_seeds = self._seed(sp, ins_rel, self._env)
            for head, rel in ins_seeds.items():
                if head in rederive:
                    rederive[head] = self.engine._union_stored(
                        [rederive[head], rel], self.engine._sr_of(head),
                        self.engine._idb_cap(head),
                        context=(f"stratum=s{sp.index} "
                                 f"pass=dred-insert-union head={head}"))
                else:
                    rederive[head] = rel
        self._continue_fixpoint(sp, rederive)

    def _continue_fixpoint(self, sp: I.StratumPlan,
                           seeds: dict[str, Relation]) -> None:
        """Merge seeds into fulls, then run the stratum's semi-naive loop
        from (full, seed-delta) to fixpoint — through the engine, so in
        device mode the continuation runs the captured loop."""
        stats = EngineStats()
        env = dict(self._env)
        self._env = self.engine._run_stratum(
            sp=sp, env_rels={k: v for k, v in env.items()
                             if k[0] not in sp.idbs},
            stats=stats, stratum_key=f"inc_s{sp.index}",
            init_state={
                name: (env.get((name, I.FULL),
                               self.engine._stored_empty_idb(name)),
                       seeds.get(name))
                for name in sorted(sp.idbs)})
        self._stats.iterations[f"inc_s{sp.index}"] = (
            stats.iterations.get(f"inc_s{sp.index}", 0))
