"""Semi-naive, stratum-by-stratum fixpoint engine (paper Sec. 2.2, 3),
on one device — the counterpart of ``repro.engine.engine``.

Two execution modes, sharing one iteration body (``_stratum_iter``)
that runs the plan's relops on ``EngineConfig.device`` (the card by
default; an engine asked for CUDA without one raises rather than
falling back to the CPU):

* ``host``   — Python drives the iteration loop eagerly and reads, once
  per iteration, each IDB's delta size and the overflow flag together;
  per-iteration delta sizes land in ``EngineStats.delta_sizes``.
* ``device`` — the reference's ``lax.while_loop``. On the card one
  iteration is captured as a CUDA graph over static buffers after one
  eager warm-up iteration, and replayed in place; each replay folds
  ``any_delta`` and the overflow flag into a three-word device log that
  the host reads (a few bytes) before the next replay. Like the
  reference it runs at least one iteration, logs no per-iteration
  sizes, and stops quietly at ``max_iters``. On the CPU the same loop
  runs eagerly over the same static buffers. A capture that fails
  raises; there is no fallback to the eager loop.

The graph memo (``_device_loop``) is the counterpart of the reference's
``_memo_jit``: a stratum's captured iteration is kept across ``run()``
and incremental ``apply()`` calls and replayed by every later loop of
that stratum at the same capacities and carry structure, with no
warm-up and no capture.

Capacity overflow (bounded join outputs; relation.py) retries the run
with doubled capacities (``auto_grow``); in device mode the retry
captures again at the new capacities, replacing the memo's entry.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.core import ir as I
from repro_torch.engine import faults as F
from repro_torch.engine import observe as O
from repro_torch.engine import relation as RL
from repro_torch.engine import relops as R
from repro_torch.engine.backend import KernelDispatch, resolve_backend
from repro_torch.engine.lower import Env, Evaluator, LowerConfig
from repro_torch.engine.relation import (
    Relation, UNSORTED, empty, from_numpy, live_mask, pow2_cap,
    take_columns, to_numpy, to_numpy_with_val,
)
from repro_torch.engine.semiring import PRESENCE, Semiring, monoid_for


@dataclass
class EngineConfig:
    idb_cap: int = 1 << 14
    idb_caps: dict = field(default_factory=dict)      # per-IDB override
    intermediate_cap: int = 1 << 15
    max_iters: int = 100_000
    mode: str = "host"            # host | device
    auto_grow: bool = True
    max_grow_retries: int = 8
    semiring: Semiring = PRESENCE  # execution algebra (Sec. 8)
    # device mode keeps each stratum's captured iteration across runs
    # and applies (the graph memo); False captures every loop and frees
    # the graph with it, as the reference's jit=False skips its memo
    jit: bool = True
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
    # sharded execution (engine/shard.py): ``shards >= 2`` makes
    # ``make_engine`` return a ShardedEngine over that many shards;
    # ``shard_mesh`` optionally supplies a prebuilt ShardMesh whose sole
    # axis is named "shards" (default: every shard on ``device``,
    # launch.mesh.make_shard_mesh)
    shards: int = 0
    shard_mesh: object = None


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


MODES = ("host", "device")


def _relation_tensors(rel: Relation) -> list:
    return [t for t in (rel.data, rel.val, rel.n) if t is not None]


def _carry_spec(rel: Relation) -> tuple:
    """What a while-loop carry fixes of a relation: everything but the
    tensors' contents."""
    return (rel.order, rel.val is None,
            tuple((tuple(t.shape), t.dtype, t.device)
                  for t in _relation_tensors(rel)))


def _check_carry(before: dict, after: dict, stratum_key) -> None:
    """Device mode's loop carry must keep its structure (the reference's
    ``lax.while_loop`` enforces it by the carry's pytree type): the same
    IDBs, and for each full and delta the same sort-order witness,
    capacity, arity, dtypes and presence of ``val``."""
    if before.keys() != after.keys():
        raise TypeError(f"device-mode carry of {stratum_key}: IDBs "
                        f"{sorted(before)} became {sorted(after)}")
    for name in before:
        for part, b, a in zip(("full", "delta"), before[name], after[name]):
            if _carry_spec(b) != _carry_spec(a):
                raise TypeError(
                    f"device-mode carry of {stratum_key}: {name} {part} "
                    f"changed from {_carry_spec(b)} to {_carry_spec(a)}")


def _clone_relation(rel: Relation) -> Relation:
    return Relation(rel.data.clone(),
                    None if rel.val is None else rel.val.clone(),
                    rel.n.clone(), order=rel.order)


def _tree_relations(tree: dict) -> list:
    """A loop state ({name: (full, delta)}) or base ({(name, version):
    relation}) as a flat list of relations, in key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += list(v) if isinstance(v, tuple) else [v]
    return out


def _clone_tree(tree: dict) -> dict:
    return {k: (tuple(_clone_relation(r) for r in v)
                if isinstance(v, tuple) else _clone_relation(v))
            for k, v in tree.items()}


def _tree_spec(tree: dict) -> tuple:
    """The carry spec of every relation of a state or base, by key."""
    return tuple((k, tuple(_carry_spec(r) for r in
                           (v if isinstance(v, tuple) else (v,))))
                 for k, v in sorted(tree.items()))


def _copy_into(static: dict, new: dict) -> None:
    """Copy a state or base into static buffers of the same structure. A
    new tensor that shares storage with a static one is cloned first, so
    no copy reads a buffer an earlier copy wrote."""
    dst = [t for r in _tree_relations(static) for t in _relation_tensors(r)]
    src = [t for r in _tree_relations(new) for t in _relation_tensors(r)]
    owned = {t.untyped_storage().data_ptr() for t in dst}
    src = [t.clone() if t.untyped_storage().data_ptr() in owned else t
           for t in src]
    for d, t in zip(dst, src):
        d.copy_(t)


class _LoopGraph:
    """One stratum's device-mode iteration: the static buffers it reads
    (``base``, the relations its rules scan) and updates in place
    (``state``, each IDB's full and delta), the three-word ``log``, the
    CUDA graph that runs it (None on the CPU, where ``Engine._iterate``
    runs the step eagerly over the same buffers), and the plans and
    ``Evaluator`` it was built with. The graph memo's entry."""

    __slots__ = ("rec", "idbs", "ev", "monoid_names", "log", "state",
                 "base", "graph")

    def __init__(self, rec, idbs, ev, monoid_names, device):
        self.rec, self.idbs, self.ev = rec, idbs, ev
        self.monoid_names = monoid_names
        self.log = torch.zeros((3,), dtype=torch.int32, device=device)
        self.log[0] = 1
        self.state = self.base = self.graph = None

    def load(self, state: dict, base: dict) -> None:
        """A new loop over this entry: its state and base into the static
        buffers, the log back to [1, 0, 0]."""
        _copy_into(self.state, state)
        _copy_into(self.base, base)
        self.log.zero_()
        self.log[0] = 1

    def result(self) -> dict:
        """The state, cloned out of the static buffers: the next loop
        over this entry overwrites them, while the run's results, an
        incremental engine's environment or a rollback copy may still
        hold what is returned."""
        return _clone_tree(self.state)


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
        if self.cfg.mode not in MODES:
            raise ValueError(f"mode={self.cfg.mode!r}: expected one of "
                             f"{MODES}")
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
        # device mode on the card: the stream the loop runs on, and
        # whether an iteration is being captured (rule spans say so)
        self._side_stream = None
        self._capturing = False
        # the graph memo: ("device", stratum index) -> (full key, its
        # _LoopGraph); one entry a stratum (see _memo_get)
        self._graph_memo: dict = {}

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

    def _overflow_msg(self, what: str, context: str = "") -> str:
        caps = self.effective_caps()
        ctx = f" [{context}]" if context else ""
        msg = (f"overflow in {what}{ctx}: "
               f"intermediate_cap={caps['intermediate_cap']} "
               f"idb_cap={caps['idb_cap']}")
        if caps["idb_caps"]:
            msg += f" idb_caps={caps['idb_caps']}"
        return msg

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
        data = take_columns(rel.data,
                            [c for c in range(rel.arity) if c != vpos])
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

    def _rule_phase(self) -> str:
        """How to read a rule span's duration: the work itself ("eval"),
        or the recording of a CUDA graph that replays it ("capture")."""
        return "capture" if self._capturing else "eval"

    def _eval_plans(self, plans, env: Env, ev: Evaluator):
        """Evaluate plans, concat per head IDB -> derived relations."""
        obs = self.cfg.observe
        by_head: dict[str, list[Relation]] = {}
        for p in plans:
            with O.span(obs, "rule", head=p.head,
                        rule=("nonrec" if p.variant < 0
                              else f"v{p.variant}"),
                        phase=self._rule_phase()):
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

    def _rule_pass_body(self, rels, roots, restrict, ev):
        """Maintenance-pass body (incremental.py): evaluate pre-retagged
        rule roots against the stored relations, union the results per
        head, and optionally restrict a head to candidate rows by a
        semijoin. One arrangement scope spans the whole pass, so every
        retagged occurrence shares the stored fulls' arrangements."""
        obs = self.cfg.observe
        ev.begin_pass()
        env = Env(dict(rels), self.compiled.shared, set(self.monoid),
                  device=self.device)
        by_head: dict[str, list[Relation]] = {}
        for head, root in roots:
            with O.span(obs, "rule", head=head, rule="maintenance",
                        phase=self._rule_phase()):
                out = ev.eval(root, env)
                split = self._split_monoid(head, out)
            by_head.setdefault(head, []).append(split)
        derived: dict[str, Relation] = {}
        for head, outs in by_head.items():
            merged, ov = self._merge_head(
                outs, self._sr_of(head), self._idb_cap(head))
            env.overflow = env.overflow | ov
            cand = restrict.get(head)
            if cand is not None:
                cols = tuple(range(merged.arity))
                merged, ov2 = ev._semijoin_op(merged, cand, cols, cols)
                env.overflow = env.overflow | ov2
            derived[head] = merged
        return derived, env.overflow

    # -- maintenance driver hooks (incremental.py) ----------------------------
    def _maintenance_evaluator(self) -> Evaluator:
        return Evaluator(LowerConfig(
            self.intermediate_cap, self.cfg.semiring, self.backend,
            self.cfg.arrangements))

    def run_rule_pass(self, env_rels, roots, restrict=None,
                      memo_key=None, context: str = "") -> dict:
        """Driver entry for an incremental maintenance pass: ``roots``
        is a list of (head, retagged IR) pairs; ``env_rels`` maps
        (name, version) to stored relations (including any
        changed-occurrence entries); ``restrict`` optionally maps a
        head to a candidate relation its result is semijoined with.
        Returns head -> stored relation. The pass runs eagerly in either
        mode: ``memo_key``, which names the pass's structure for the
        reference's compiled-pass memo, has no effect here, because
        nothing is traced. ``context`` (stratum key + pass name) goes
        into the overflow message beside the current capacities."""
        F.fault_point("engine.rule_pass")
        derived, ovf = self._rule_pass_body(
            dict(env_rels), roots, restrict or {},
            self._maintenance_evaluator())
        if bool(ovf):
            raise OverflowError_(
                self._overflow_msg("incremental rule pass", context))
        return derived

    def _stored(self, rels: dict) -> dict:
        """Host-built Relations -> this driver's storage form (identity
        here; ShardedEngine scatters each to its home shards)."""
        return rels

    def _stored_empty_idb(self, name: str) -> Relation:
        return self._empty_idb(name)

    def _difference_stored(self, rel: Relation, sub: Relation) -> Relation:
        """Stored-form set difference (DRed candidate removal)."""
        out, _ = R.difference(rel, sub, backend=self.backend)
        return out

    def _union_stored(self, rels: list, sr: Semiring, cap: int,
                      context: str = "") -> Relation:
        """Stored-form union (combining maintenance seed sets)."""
        out, ov = R.concat_all(rels, sr, cap, backend=self.backend)
        if bool(ov):
            raise OverflowError_(self._overflow_msg(
                "maintenance seed union", context))
        return out

    def _host_relation(self, rel: Relation) -> Relation:
        """An environment relation as one Relation (identity here;
        ShardedEngine gathers)."""
        return rel

    # -- runtime invariant sanitizer (core/analysis/sanitize.py) ---------------
    _sanitize_layer = "engine"

    def _sanitize_due(self) -> bool:
        ci = self.cfg.check_invariants
        if not ci:
            return False
        self._sanitize_count += 1
        n = 1 if ci is True else int(ci)
        return n <= 1 or self._sanitize_count % n == 0

    def _sanitize_env(self, env, where: str, layer: str = "") -> None:
        """Validate every stored arrangement when cfg.check_invariants is
        set; the sanitizer reads numpy, so it gets host copies."""
        if not self._sanitize_due():
            return
        from repro_torch.core.analysis.sanitize import sanitize_env
        host = {k: self._sanitize_copy(r) for k, r in env.items()}
        sanitize_env(self, host, where, layer or self._sanitize_layer)

    def _sanitize_copy(self, rel: Relation) -> Relation:
        """A stored relation's host copy for the sanitizer."""
        return Relation(rel.data.cpu(),
                        None if rel.val is None else rel.val.cpu(),
                        rel.n.cpu(), order=rel.order)

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

        delta_log = []
        with self._loop_stream():
            if cfg.mode == "device":
                with O.span(obs, "fixpoint-loop", detail="post-hoc"):
                    state, stratum_iters = self._device_loop(
                        sp.index, state, base_env_rels, rec, idbs, ev,
                        monoid_names, stratum_key)
            else:
                state, stratum_iters, delta_log = self._host_loop(
                    state, base_env_rels, rec, idbs, ev, monoid_names,
                    stratum_key)

            # final merge of the last deltas into the fulls (empty unless
            # device mode stopped at max_iters)
            with O.span(obs, "final-merge"):
                full_env = dict(base_env_rels)
                for name in idbs:
                    full, delta = state[name]
                    merged, ov = R.merge(full, delta, self._sr_of(name),
                                         self._idb_cap(name),
                                         backend=self.backend,
                                         incremental=cfg.arrangements)
                    if bool(ov):
                        raise OverflowError_(
                            f"overflow finalizing {name}")
                    full_env[(name, I.FULL)] = merged
        stats.iterations[stratum_key] = stratum_iters
        stats.delta_sizes[stratum_key] = delta_log
        if st_span is not None:
            st_span.attrs["iterations"] = stratum_iters
        self._sanitize_env(full_env, f"stratum {stratum_key} boundary")
        return full_env

    def _host_loop(self, state, base, rec, idbs, ev, monoid_names,
                   stratum_key):
        """mode="host": eager iterations while any delta is non-empty ->
        (state, iterations, per-iteration delta sizes)."""
        obs = self.cfg.observe
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
                    state, base, rec, idbs, ev, monoid_names)
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
            if stratum_iters >= self.cfg.max_iters:
                raise RuntimeError(
                    f"no fixpoint after {self.cfg.max_iters} iterations")
        return state, stratum_iters, delta_log

    @contextlib.contextmanager
    def _loop_stream(self):
        """Device mode on the card runs a stratum's loop and final merge
        on a side stream (a graph is captured on one), ordered after and
        before the current stream's work."""
        if self.cfg.mode != "device" or self.device.type != "cuda":
            yield
            return
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(self.device)
        main = torch.cuda.current_stream(self.device)
        self._side_stream.wait_stream(main)
        try:
            with torch.cuda.stream(self._side_stream):
                yield
        finally:
            main.wait_stream(self._side_stream)

    def _scanned(self, plans) -> set:
        """Relations the plans scan, through shared subplans too."""
        names: set = set()
        seen: set = set()
        stack = [p.root for p in plans]
        while stack:
            for n in I.iter_nodes(stack.pop()):
                if isinstance(n, I.Scan):
                    names.add(n.rel)
                elif isinstance(n, I.SharedRef) and n.ref not in seen:
                    seen.add(n.ref)
                    stack.append(self.compiled.shared[n.ref])
        return names

    def _memo_get(self, key: tuple) -> Optional[_LoopGraph]:
        """The graph memo's entry for ``key`` (None on a miss). ``key[0]``
        is the structural key ("device", stratum index); the rest is what
        a captured iteration bakes in: the capacities, ``force_multiword``
        and the carry spec of every relation the step reads or updates.
        One entry a structural key: a key seen at other capacities or
        structure (auto-grow, the resilience ladder) drops its entry and
        counts a retrace, so the memo never holds two graphs of one
        stratum. Counts ``memo_jit.hit`` / ``.miss`` / ``.retrace`` on
        the attached observation, as the reference's ``_memo_jit``."""
        obs = self.cfg.observe
        held = self._graph_memo.get(key[0])
        if held is not None and held[0] == key:
            O.count(obs, "memo_jit.hit")
            return held[1]
        O.count(obs, "memo_jit.miss")
        if held is not None:
            O.count(obs, "memo_jit.retrace")
            del self._graph_memo[key[0]]
        return None

    def _device_loop(self, sp_index, state, base, rec, idbs, ev,
                     monoid_names, stratum_key):
        """mode="device": the reference's ``lax.while_loop`` -> (state,
        iterations).

        The carry's scalars live in a device log [any_delta, overflow,
        iterations] that starts at [1, 0, 0], so at least one iteration
        runs; an iteration counts while any_delta & ~overflow, and the
        loop stops when the log says no delta, on overflow (raised, so
        ``run()`` grows the caps and captures again) or at
        ``max_iters`` (quietly, with the partial fixpoint). Each
        iteration is followed by one host read of the log.

        On a memo miss the first iteration runs eagerly, as the warm-up
        that capture needs (it also loads every kernel library), with
        synchronizing calls turned into errors, so a hidden host read
        fails here and not as a broken capture. The state and the base
        relations the rules scan are then copied into static buffers,
        and on the card one iteration is captured into a CUDA graph that
        computes the next state from them, folds its flags into the log
        and copies the state back. The entry goes into the memo (with
        ``cfg.jit``; without it, a loop that the warm-up already ended
        captures nothing), and each later iteration is one replay in
        place.
        On a hit the run's state and base are copied into the entry's
        buffers and the first iteration is already a replay. The state
        is cloned out when the loop ends."""
        if self.cfg.max_iters <= 0:
            return state, 0
        scanned = self._scanned(rec)
        base = {k: r for k, r in base.items() if k[0] in scanned}
        key = (("device", sp_index), self._intermediate_cap,
               self._idb_cap_default, tuple(sorted(self._idb_caps.items())),
               RL.multiword_forced(), _tree_spec(state), _tree_spec(base))
        loop = self._memo_get(key) if self.cfg.jit else None
        if loop is None:
            loop = _LoopGraph(rec, idbs, ev, monoid_names, self.device)
            state = self._warm_up(loop, state, base, stratum_key)
            flags = loop.log.tolist()
            goes_on = self._loop_goes_on(flags, stratum_key)
            if not (goes_on or self.cfg.jit):
                return state, flags[2]    # nothing would replay it
            self._capture(loop, state, base, stratum_key)
            if self.cfg.jit:
                self._graph_memo[key[0]] = (key, loop)
        else:
            loop.load(state, base)
            goes_on = True
        while goes_on:
            self._iterate(loop, stratum_key)
            flags = loop.log.tolist()
            goes_on = self._loop_goes_on(flags, stratum_key)
        return loop.result(), flags[2]

    def _loop_step(self, loop: _LoopGraph, st: dict, base: dict,
                   stratum_key) -> dict:
        """One iteration of ``loop`` from ``st`` over ``base`` -> the next
        state; folds its flags into the loop's log."""
        new, ovf = self._stratum_iter(st, base, loop.rec, loop.idbs,
                                      loop.ev, loop.monoid_names)
        _check_carry(st, new, stratum_key)
        log = loop.log
        any_delta = torch.stack([new[n][1].n > 0 for n in loop.idbs]).any()
        counted = (log[0] != 0) & (log[1] == 0)
        log.copy_(torch.stack([any_delta.to(torch.int32),
                               ((log[1] != 0) | ovf).to(torch.int32),
                               log[2] + counted.to(torch.int32)]))
        return new

    def _warm_up(self, loop, state, base, stratum_key) -> dict:
        if self.device.type != "cuda":
            return self._loop_step(loop, state, base, stratum_key)
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return self._loop_step(loop, state, base, stratum_key)
        finally:
            torch.cuda.set_sync_debug_mode(prev)

    def _iterate(self, loop: _LoopGraph, stratum_key) -> None:
        """One iteration in place: a replay, or on the CPU the step run
        eagerly over the same static buffers."""
        if loop.graph is not None:
            loop.graph.replay()
        else:
            _copy_into(loop.state, self._loop_step(loop, loop.state,
                                                   loop.base, stratum_key))

    def _loop_goes_on(self, log: list, stratum_key) -> bool:
        any_delta, overflow, iters = log
        if overflow:
            raise OverflowError_(f"overflow in stratum {stratum_key}")
        return bool(any_delta) and iters < self.cfg.max_iters

    def _capture(self, loop: _LoopGraph, state, base, stratum_key) -> None:
        """Copy ``state`` and ``base`` into the loop's static buffers and,
        on the card, capture one step over them that writes the next
        state back into them. Raises if the capture fails, leaving
        ``loop`` without a graph (and out of the memo)."""
        loop.state = _clone_tree(state)
        loop.base = _clone_tree(base)
        if self.device.type != "cuda":
            return
        graph = torch.cuda.CUDAGraph()
        O.trace_count("engine.graph_captures")
        self._capturing = True
        try:
            with O.span(self.cfg.observe, "graph-capture"), \
                    torch.cuda.graph(graph, stream=self._side_stream):
                _copy_into(loop.state, self._loop_step(
                    loop, loop.state, loop.base, stratum_key))
        finally:
            self._capturing = False
        loop.graph = graph

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
            rel = self._host_relation(env_rels[key])
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
                    mode=self.cfg.mode, shards=self.cfg.shards or 1,
                    backend=type(self.backend).__name__):
            env_rels = self._edb_env(edbs, edb_caps)
            for sp in self.compiled.strata:
                env_rels = self._run_stratum(
                    sp, env_rels, stats, f"s{sp.index}")
            out = self._export(env_rels, stats)
        stats.wall_s = time.perf_counter() - t0
        self.last_env = env_rels
        return out, stats
