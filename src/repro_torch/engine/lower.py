"""IR -> torch dataflow (the executor's render step, paper Fig. 1).

``Evaluator`` walks an optimized IR and runs fixed-capacity torch ops over
``Relation`` structs. SharedRefs are memoized per evaluation pass — the
executor-level realization of shared subplans / CTE reuse (Sec. 7) —
and below them the per-pass ``relops.ArrangementCache``
(``Evaluator.begin_pass``) shares the *physical sorts*: every
join/membership/reduce of the pass resolves its operand arrangements
through one cache keyed on (relation identity, key columns), so two
rules probing the same relation on the same key emit one sort.

Scans resolve through an environment mapping (relation, version) to the
current Relation; monoid IDBs (Sec. 9) expose their lattice value as a
trailing data column.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core import ir as I
from repro_torch.engine import relops as R
from repro_torch.engine.backend import KernelDispatch
from repro_torch.engine.observe import trace_count
from repro_torch.engine.relation import PAD, Relation, live_mask
from repro_torch.engine.semiring import PRESENCE, Semiring


@dataclass
class LowerConfig:
    intermediate_cap: int = 1 << 15
    # execution algebra for row diffs: PRESENCE (batch) or COUNTING
    semiring: Semiring = PRESENCE
    # kernel dispatch for probe/reduce hot ops (backend.py); None = the
    # plain torch versions (CPU tensors)
    backend: Optional[KernelDispatch] = None
    # arrangement layer (relops.ArrangementCache + witness fast path):
    # share one sort per (relation, key) across all rules/subplans of
    # an evaluation pass. False = the pre-arrangement sort-per-op
    # behavior (the equivalence baseline).
    arrangements: bool = True


class Env:
    """(relation name, version) -> Relation, plus shared-subplan memo."""

    def __init__(self, rels: dict[tuple[str, str], Relation],
                 shared: dict[str, I.IR], monoid_arity_extended: set[str],
                 device="cuda"):
        self.rels = rels
        self.shared = shared
        self.monoid = monoid_arity_extended
        self.device = torch.device(device)
        self.memo: dict[str, tuple[Relation, torch.Tensor]] = {}
        self.overflow = torch.zeros((), dtype=torch.bool, device=device)

    def scan(self, name: str, version: str) -> Relation:
        key = (name, version)
        if key not in self.rels:
            # non-stratum relations only exist at FULL
            key = (name, I.FULL)
        rel = self.rels[key]
        if name in self.monoid and rel.val is not None:
            return Relation(R.as_columns(rel), None, rel.n)
        return rel


def _schema_cols(schema) -> dict[str, int]:
    out = {}
    for i, c in enumerate(schema):
        if isinstance(c, str):
            out.setdefault(c, i)
        elif isinstance(c, I.Expr) and c.name:
            out.setdefault(c.name, i)
    return out


def _eval_ref(ref, data: torch.Tensor, cols: dict[str, int]):
    """Evaluate a ColumnRef against loose rows [n, width]."""
    if isinstance(ref, int):
        return torch.full((data.shape[0],), ref, dtype=torch.int32,
                          device=data.device)
    if isinstance(ref, I.Expr):
        l = _eval_ref(ref.lhs, data, cols)
        r = _eval_ref(ref.rhs, data, cols)
        if ref.op == "+":
            return l + r
        if ref.op == "-":
            return l - r
        if ref.op == "*":
            return l * r
        raise ValueError(ref.op)
    return data[:, cols[ref]]


_COMP = {
    "=": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}


def _comp_mask(comparisons, data, cols):
    mask = torch.ones((data.shape[0],), dtype=torch.bool,
                      device=data.device)
    for c in comparisons:
        mask &= _COMP[c.op](_eval_ref(c.lhs, data, cols),
                            _eval_ref(c.rhs, data, cols))
    return mask


def _project(schema, data, cols):
    if not schema:
        return torch.zeros((data.shape[0], 0), dtype=torch.int32,
                           device=data.device)
    return torch.stack(
        [_eval_ref(c, data, cols) for c in schema], dim=1).to(torch.int32)


class Evaluator:
    """Renders IR to physical relops.

    Every call into a physical operator goes through an overridable
    ``_*_op`` hook so alternate execution strategies can wrap the ops
    without re-implementing the IR walk."""

    def __init__(self, cfg: LowerConfig):
        self.cfg = cfg
        # arrangement-sharing scope; engine calls begin_pass() once per
        # evaluation pass (iteration / seed pass)
        self.cache: Optional[R.ArrangementCache] = None

    def begin_pass(self) -> Optional[R.ArrangementCache]:
        """Open a fresh arrangement-sharing scope. One cache per
        evaluation pass: all rules/subplans rendered until the next
        begin_pass share arrangements
        keyed on operand identity. Returns the cache (None when the
        arrangement layer is disabled)."""
        self.cache = R.ArrangementCache() if self.cfg.arrangements else None
        return self.cache

    # -- physical-op hooks ---------------------------------------------------
    def _dedupe_op(self, data, val, out_cap):
        return R.dedupe(data, val, self.cfg.semiring, out_cap,
                        backend=self.cfg.backend)

    def _join_op(self, left, right, l_keys, r_keys, l_out, r_out, out_cap):
        return R.join(left, right, l_keys, r_keys, l_out, r_out,
                      self.cfg.semiring, out_cap,
                      backend=self.cfg.backend, cache=self.cache)

    def _semijoin_op(self, left, right, l_keys, r_keys):
        return R.semijoin(left, right, l_keys, r_keys, left.capacity,
                          self.cfg.semiring, backend=self.cfg.backend,
                          cache=self.cache)

    def _antijoin_op(self, left, right, l_keys, r_keys):
        return R.antijoin(left, right, l_keys, r_keys, left.capacity,
                          self.cfg.semiring, backend=self.cfg.backend,
                          cache=self.cache)

    def _concat_op(self, rels, out_cap):
        return R.concat_all(rels, self.cfg.semiring, out_cap,
                            backend=self.cfg.backend)

    def _reduce_op(self, child, group_cols, agg_specs, out_cap):
        return R.reduce_groups(child, group_cols, agg_specs, out_cap,
                               backend=self.cfg.backend,
                               cache=self.cache)

    # -- public -------------------------------------------------------------
    def eval(self, node: I.IR, env: Env) -> Relation:
        rel, ovf = self._eval(node, env)
        env.overflow = env.overflow | ovf
        return rel

    # -- dispatch -----------------------------------------------------------
    def _eval(self, node: I.IR, env: Env):
        meth = getattr(self, f"_eval_{type(node).__name__.lower()}")
        return meth(node, env)

    def _eval_scan(self, node: I.Scan, env: Env):
        return env.scan(node.rel, node.version), env.overflow.new_zeros(())

    def _eval_sharedref(self, node: I.SharedRef, env: Env):
        if node.ref not in env.memo:
            trace_count("lower.sharedref_misses")
            sub = env.shared[node.ref]
            rel, ovf = self._eval(sub, env)
            env.memo[node.ref] = (rel, ovf)
        else:
            trace_count("lower.sharedref_hits")
        rel, ovf = env.memo[node.ref]
        return rel, ovf

    def _eval_map(self, node: I.Map, env: Env):
        return self._map_like(node.child, node.schema, (), env)

    def _eval_flatmap(self, node: I.FlatMap, env: Env):
        return self._map_like(node.child, node.schema, node.comparisons, env)

    def _eval_filter(self, node: I.Filter, env: Env):
        child, ovf = self._eval(node.child, env)
        cols = _schema_cols(node.child.schema)
        mask = _comp_mask(node.comparisons, child.data, cols) & (
            live_mask(child))
        d, v, n, ov2 = R._scatter_compact(
            child.data, child.val, mask, child.capacity, 0)
        return Relation(d, v if child.val is not None else None, n), ovf | ov2

    def _map_like(self, child_ir, schema, comparisons, env):
        child, ovf = self._eval(child_ir, env)
        cols = _schema_cols(child_ir.schema)
        mask = _comp_mask(comparisons, child.data, cols) & live_mask(child)
        data = _project(schema, child.data, cols)
        data = torch.where(mask[:, None], data, PAD)
        out, ov2 = self._dedupe_op(data, child.val, child.capacity)
        return out, ovf | ov2

    def _eval_join(self, node: I.Join, env: Env):
        data, val, valid, ovf = self._loose_join(node, env, node.schema, ())
        out, ov2 = self._dedupe_op(data, val, self._join_cap())
        return out, ovf | ov2

    def _eval_joinflatmap(self, node: I.JoinFlatMap, env: Env):
        data, val, valid, ovf = self._loose_join(
            node, env, node.schema, node.comparisons)
        out, ov2 = self._dedupe_op(data, val, self._join_cap())
        return out, ovf | ov2

    def _join_cap(self) -> int:
        return self.cfg.intermediate_cap

    def _loose_join(self, node, env, out_schema, comparisons):
        left, ovl = self._eval(node.left, env)
        right, ovr = self._eval(node.right, env)
        lcols = _schema_cols(node.left.schema)
        rcols = _schema_cols(node.right.schema)
        l_keys = tuple(lcols[k] for k in node.keys)
        r_keys = tuple(rcols[k] for k in node.keys)
        l_out = tuple(range(left.arity))
        r_out = tuple(i for i in range(right.arity)
                      if i not in set(r_keys))
        data, val, valid, total, ovj = self._join_op(
            left, right, l_keys, r_keys, l_out, r_out, self._join_cap())
        # joined loose schema: left schema ++ right schema minus key dups
        joined_names: dict[str, int] = {}
        w = 0
        for c in node.left.schema:
            if isinstance(c, str):
                joined_names.setdefault(c, w)
            elif isinstance(c, I.Expr) and c.name:
                joined_names.setdefault(c.name, w)
            w += 1
        for i, c in enumerate(node.right.schema):
            if i in set(r_keys):
                continue
            if isinstance(c, str):
                joined_names.setdefault(c, w)
            elif isinstance(c, I.Expr) and c.name:
                joined_names.setdefault(c.name, w)
            w += 1
        mask = _comp_mask(comparisons, data, joined_names) & valid
        out_data = _project(out_schema, data, joined_names)
        out_data = torch.where(mask[:, None], out_data, PAD)
        out_val = val
        if val is not None:
            out_val = torch.where(mask, val, self.cfg.semiring.identity)
        return out_data, out_val, mask, ovl | ovr | ovj

    def _eval_semijoin(self, node: I.Semijoin, env: Env):
        left, ovl = self._eval(node.left, env)
        right, ovr = self._eval(node.right, env)
        lcols = _schema_cols(node.left.schema)
        rcols = _schema_cols(node.right.schema)
        l_keys = tuple(lcols[k] for k in node.keys)
        r_keys = tuple(rcols[k] for k in node.keys)
        out, ov = self._semijoin_op(left, right, l_keys, r_keys)
        return out, ovl | ovr | ov

    def _eval_antijoin(self, node: I.Antijoin, env: Env):
        left, ovl = self._eval(node.left, env)
        right, ovr = self._eval(node.right, env)
        lcols = _schema_cols(node.left.schema)
        rcols = _schema_cols(node.right.schema)
        l_keys = tuple(lcols[k] for k in node.keys)
        r_keys = tuple(rcols[k] for k in node.keys)
        out, ov = self._antijoin_op(left, right, l_keys, r_keys)
        return out, ovl | ovr | ov

    def _eval_concat(self, node: I.Concat, env: Env):
        return self._concat([node.left, node.right], env)

    def _eval_concatall(self, node: I.ConcatAll, env: Env):
        return self._concat(list(node.inputs), env)

    def _concat(self, irs, env):
        rels = []
        ovf = env.overflow.new_zeros(())
        for ir in irs:
            r, o = self._eval(ir, env)
            rels.append(r)
            ovf |= o
        cap = max(r.capacity for r in rels)
        out, ov = self._concat_op(rels, cap)
        return out, ovf | ov

    def _eval_distinct(self, node: I.Distinct, env: Env):
        child, ovf = self._eval(node.child, env)
        out, ov = self._dedupe_op(child.data, child.val, child.capacity)
        return out, ovf | ov

    def _eval_reduce(self, node: I.Reduce, env: Env):
        child, ovf = self._eval(node.child, env)
        cols = _schema_cols(node.child.schema)
        group_cols = tuple(cols[g] for g in node.group)
        agg_specs = tuple((f, cols[c]) for f, c in node.aggs)
        reduced, ov = self._reduce_op(
            child, group_cols, agg_specs, child.capacity)
        # reduce_groups emits [group..., aggs...]; permute to node.schema
        perm = []
        gi, ai = 0, 0
        for c in node.schema:
            if gi < len(node.group) and c == node.group[gi]:
                perm.append(gi)
                gi += 1
            else:
                perm.append(len(node.group) + ai)
                ai += 1
        if perm != list(range(len(perm))):
            data = reduced.data[:, perm]
            reduced, ov2 = R.dedupe(data, None, self.cfg.semiring,
                                    reduced.capacity,
                                    backend=self.cfg.backend)
            ov = ov | ov2
        return reduced, ovf | ov
