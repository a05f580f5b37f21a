"""Front-end -> optimized IR bundle (paper Fig. 1: front-end, optimizer).

Per rule:  build join graph -> choose rooted JST (structural cost, Sec. 5)
        -> sip semijoin reduction (Sec. 6) -> lower to IR -> logic fusion
        (Sec. 4) -> and across all rules: subplan sharing (Sec. 7).

Semi-naive delta-variants are generated here (one IR per recursive-atom
position), before sharing, so common subtrees across variants are shared.
"""
from __future__ import annotations

import contextlib
import sys
from dataclasses import dataclass

from repro_torch.core import ir as I
from repro_torch.core.datalog.ast import (
    Aggregate, Atom, BinExpr, Comparison, Const, Program, Rule, Var,
)
from repro_torch.core.datalog.parser import parse_program
from repro_torch.core.datalog.stratify import stratify
from repro_torch.core.analysis.verify import (
    verify_ir_or_raise, verify_program_or_raise,
)
from repro_torch.core.optimizer import joingraph as JG
from repro_torch.core.optimizer import sip as SIP
from repro_torch.core.optimizer.fusion import fuse
from repro_torch.core.optimizer.sharing import share_subplans

# Test harness hook (tests/conftest.py): when True, the IR verifier runs
# after every optimizer pass even for compiles that pass verify=False.
# Deliberately-malformed tests opt out via @pytest.mark.no_ir_verify.
FORCE_VERIFY = False


def _ambient_span(name: str, **attrs):
    """Compile-pass span on the ambient engine.observe.Observation, if
    one is active. Resolved through sys.modules so core stays importable
    without pulling in the engine package (and jax): if observe was
    never imported, no Observation can be active, so a nullcontext is
    exactly equivalent."""
    obs_mod = sys.modules.get("repro_torch.engine.observe")
    if obs_mod is None:
        return contextlib.nullcontext()
    return obs_mod.ambient_span(name, **attrs)


@dataclass
class CompileOptions:
    use_planner: bool = True      # Sec. 5 structural optimizer (else listing)
    use_sip: bool = True          # Sec. 6 semijoin prefiltering
    use_fusion: bool = True       # Sec. 4 logic fusion
    use_sharing: bool = True      # Sec. 7 subplan sharing
    sip_min_atoms: int = 3
    max_spanning_trees: int = 2000
    verify: bool = True           # core.analysis IR verifier after each pass

    @property
    def verify_on(self) -> bool:
        return self.verify or FORCE_VERIFY


class LoweringError(ValueError):
    pass


def _term_ref(t, where: str) -> I.ColumnRef:
    if isinstance(t, Var):
        return t.name
    if isinstance(t, Const):
        return t.value
    if isinstance(t, BinExpr):
        return I.Expr(t.op, _term_ref(t.lhs, where), _term_ref(t.rhs, where))
    raise LoweringError(f"unsupported term {t} in {where}")


def _comp_to_ir(c: Comparison) -> I.CompOp:
    return I.CompOp(c.op, _term_ref(c.lhs, "comparison"),
                    _term_ref(c.rhs, "comparison"))


def _schema_vars(schema) -> set[str]:
    return {c for c in schema if isinstance(c, str)}


def _leaf_ir(atom: Atom, version: str, needed: set[str],
             comparisons: list[Comparison]) -> tuple[I.IR, list[Comparison]]:
    """Scan + (Map/Filter) handling constants, duplicate vars, wildcards,
    and leaf-bound comparisons. Returns (ir, comparisons_applied)."""
    cols: list[str] = []
    filters: list[I.CompOp] = []
    seen: set[str] = set()
    for i, a in enumerate(atom.args):
        if isinstance(a, Const):
            name = f"__c{i}"
            filters.append(I.CompOp("=", name, a.value))
        elif isinstance(a, Var):
            if a.name in seen:
                name = f"__dup{i}"
                filters.append(I.CompOp("=", a.name, name))
            else:
                name = a.name
                seen.add(a.name)
        else:
            raise LoweringError(f"unsupported body arg {a}")
        cols.append(name)
    scan = I.Scan(atom.name, tuple(cols), version)
    ir: I.IR = scan

    applied: list[Comparison] = []
    for c in comparisons:
        if c.var_names <= atom.var_names:
            filters.append(_comp_to_ir(c))
            applied.append(c)
    if filters:
        ir = I.Filter(ir, tuple(filters))
    out_cols = tuple(v for v in cols
                     if not v.startswith("__") and v in needed)
    if out_cols != tuple(cols):
        ir = I.Map(ir, out_cols)
    return ir, applied


@dataclass
class _RuleCtx:
    rule: Rule
    graph: JG.JoinGraph
    versions: dict[int, str]                  # body position -> scan version
    pending_comps: list[Comparison]
    pending_negs: list[Atom]
    head_var_names: set[str]


def _needed_for(ctx: _RuleCtx, subtree_atom_idxs: set[int]) -> set[str]:
    """Vars a subtree's output must keep: head vars + vars of graph atoms
    outside the subtree + pending comparison/negation vars."""
    need = set(ctx.head_var_names)
    for i in range(ctx.graph.n):
        if i not in subtree_atom_idxs:
            need |= set(ctx.graph.atoms[i].var_names)
    for c in ctx.pending_comps:
        need |= set(c.var_names)
    for a in ctx.pending_negs:
        need |= set(a.var_names)
    return need


def _apply_pending(ctx: _RuleCtx, ir: I.IR) -> I.IR:
    """Apply comparisons / antijoins whose vars are now bound."""
    bound = _schema_vars(ir.schema)
    comps = [c for c in ctx.pending_comps if c.var_names <= bound]
    if comps:
        ir = I.Filter(ir, tuple(_comp_to_ir(c) for c in comps))
        ctx.pending_comps = [c for c in ctx.pending_comps if c not in comps]
    negs = [a for a in ctx.pending_negs if a.var_names <= bound]
    for a in negs:
        leaf, _ = _leaf_ir(a, ctx.versions.get(("neg", a), I.FULL),
                           set(a.var_names), [])
        keys = tuple(sorted(a.var_names))
        ir = I.Antijoin(ir, leaf, keys)
    ctx.pending_negs = [a for a in ctx.pending_negs if a not in negs]
    return ir


def _compose_plan(ctx: _RuleCtx, leaf_irs: list[I.IR],
                  choices: list[JG.PlanChoice]) -> I.IR:
    """Post-order composition of the rooted JSTs, one per component,
    cross-producting components smallest-cost-first."""
    g = ctx.graph

    def subtree_atoms(rt: JG.RootedTree, v: int) -> set[int]:
        s = {v}
        for c in rt.children.get(v, []):
            s |= subtree_atoms(rt, c)
        return s

    def build(rt: JG.RootedTree, v: int) -> I.IR:
        ir = leaf_irs[v]
        ir = _apply_pending(ctx, ir)
        kids = rt.children.get(v, [])
        # smaller subtrees first (heuristic mirror of the cost model)
        kids = sorted(kids, key=lambda c: len(subtree_atoms(rt, c)))
        for c in kids:
            child_ir = build(rt, c)
            keys = tuple(sorted(
                _schema_vars(ir.schema) & _schema_vars(child_ir.schema)))
            joined = _joined_schema(ir.schema, child_ir.schema)
            ir = I.Join(ir, child_ir, keys, joined)
            ir = _apply_pending(ctx, ir)
        # project away vars no longer needed: keep vars of atoms outside
        # this subtree (future join keys) + head/pending vars
        needed = _needed_for(ctx, subtree_atoms(rt, v))
        out = tuple(c for c in ir.schema
                    if isinstance(c, str) and c in needed)
        if out != ir.schema:
            ir = I.Map(ir, out)
        return ir

    results: list[tuple[set[int], I.IR]] = []
    for choice in choices:
        rt = choice.tree
        atoms = subtree_atoms(rt, rt.root)
        ir = build(rt, rt.root)
        results.append((atoms, ir))

    # cross-product components (zero-weight edges; sequenced as given,
    # choose_plan returns components smallest-first)
    merged_atoms, ir = results[0]
    for atoms, other in results[1:]:
        keys = tuple(sorted(
            _schema_vars(ir.schema) & _schema_vars(other.schema)))
        ir = I.Join(ir, other, keys, _joined_schema(ir.schema, other.schema))
        merged_atoms |= atoms
        ir = _apply_pending(ctx, ir)
    return ir


def _joined_schema(left, right):
    out = list(left)
    lvars = _schema_vars(left)
    for c in right:
        if not (isinstance(c, str) and c in lvars):
            out.append(c)
    return tuple(out)


def lower_rule(
    rule: Rule,
    stratum_idbs: frozenset[str],
    versions: dict[int, str],
    options: CompileOptions,
) -> tuple[I.IR, bool]:
    """Lower one rule variant to IR. Returns (root, is_monoid_agg)."""
    graph = JG.build_join_graph(rule)
    head_vars = {v.name for v in rule.head_vars}

    ctx = _RuleCtx(
        rule=rule,
        graph=graph,
        versions=versions,
        pending_comps=list(rule.comparisons),
        pending_negs=list(rule.negative_body),
        head_var_names=set(head_vars),
    )

    # -- leaves (with version tags, constants, leaf filters)
    leaf_irs: list[I.IR] = []
    for i, atom in enumerate(graph.atoms):
        body_pos = graph.positions[i]
        needed = _needed_for(ctx, {i})
        # also keep vars needed by subsumed semijoins on this host
        for (_, sub) in graph.subsumed.get(i, []):
            needed |= sub.var_names
        leaf, applied = _leaf_ir(
            atom, versions.get(body_pos, I.FULL), needed, ctx.pending_comps)
        for c in applied:
            ctx.pending_comps.remove(c)
        # subsumed atoms -> semijoin pushdown onto the host leaf (Sec. 5.2)
        for (sub_pos, sub) in graph.subsumed.get(i, []):
            sub_leaf, _ = _leaf_ir(
                sub, versions.get(sub_pos, I.FULL), set(sub.var_names), [])
            keys = tuple(sorted(sub.var_names & atom.var_names))
            if keys:
                leaf = I.Semijoin(leaf, sub_leaf, keys)
            else:
                # ground guard atom (all constants): cross-semijoin
                leaf = I.Semijoin(leaf, sub_leaf, ())
        leaf_irs.append(leaf)

    # -- sip (Sec. 6)
    if options.use_sip and graph.n >= options.sip_min_atoms:
        with _ambient_span("pass", stage="sip", atoms=graph.n):
            schedule = SIP.plan_sip(graph, start=0)
            leaf_irs = SIP.apply_sip(leaf_irs, schedule)
            if options.verify_on:
                for i, leaf in enumerate(leaf_irs):
                    verify_ir_or_raise(
                        leaf, where=f"leaf {i} of {rule}",
                        pass_name="sip")

    # -- rooted JST composition (Sec. 5)
    with _ambient_span("pass", stage="plan",
                       planner=bool(options.use_planner)):
        if options.use_planner:
            choices = JG.choose_plan(
                graph, frozenset(head_vars), options.max_spanning_trees)
        else:
            choices = JG.listing_order_plan(graph)
        ir = _compose_plan(ctx, leaf_irs, choices)

    if ctx.pending_comps or ctx.pending_negs:
        # vars never became bound together — should not happen for safe rules
        raise LoweringError(
            f"unbound pendings in {rule}: {ctx.pending_comps} "
            f"{ctx.pending_negs}")

    # -- head projection / aggregation
    is_recursive = any(a.name in stratum_idbs for a in rule.positive_body)
    aggs = rule.aggregates
    if not aggs:
        out_schema = tuple(
            _term_ref(t, "head") for t in rule.head_terms)
        if not out_schema:
            out_schema = (0,)  # 0-ary heads stored with a dummy const column
        ir = I.Map(ir, out_schema)
        return ir, False

    if len(aggs) > 1:
        raise LoweringError("at most one aggregate per head supported")
    if is_recursive:
        # recursive aggregation -> monoid diff (Sec. 9); value column is
        # emitted in head position; engine combines with MIN/MAX on merge.
        agg = aggs[0]
        if agg.func not in ("MIN", "MAX"):
            raise LoweringError(
                f"recursive {agg.func} is not a lattice monoid; only "
                f"MIN/MAX supported (paper Sec. 9)")
        out_schema = []
        for t in rule.head_terms:
            if isinstance(t, Aggregate):
                r = _term_ref(t.var, "aggregate")
                if isinstance(r, I.Expr):
                    r = I.Expr(r.op, r.lhs, r.rhs, name="__agg")
                out_schema.append(r)
            else:
                out_schema.append(_term_ref(t, "head"))
        ir = I.Map(ir, tuple(out_schema))
        return ir, True

    # stratified aggregation -> Reduce
    pre_schema: list[I.ColumnRef] = []
    group: list[str] = []
    agg_specs: list[tuple[str, str]] = []
    for k, t in enumerate(rule.head_terms):
        if isinstance(t, Aggregate):
            r = _term_ref(t.var, "aggregate")
            name = f"__agg{k}"
            if isinstance(r, I.Expr):
                r = I.Expr(r.op, r.lhs, r.rhs, name=name)
            elif isinstance(r, int):
                r = I.Expr("+", r, 0, name=name)  # named const column
            elif isinstance(r, str):
                name = r
            pre_schema.append(r)
            agg_specs.append((t.func, name))
        else:
            r = _term_ref(t, "head")
            pre_schema.append(r)
            if isinstance(r, str):
                group.append(r)
    ir = I.Map(ir, tuple(pre_schema))
    out_schema = tuple(
        c if not isinstance(c, I.Expr) else (c.name or c)
        for c in pre_schema)
    ir = I.Reduce(ir, tuple(group), tuple(agg_specs), out_schema)
    return ir, False


def compile_program(
    program: Program | str,
    options: CompileOptions | None = None,
) -> I.CompiledProgram:
    with _ambient_span("compile"):
        return _compile_program(program, options)


def _compile_program(
    program: Program | str,
    options: CompileOptions | None = None,
) -> I.CompiledProgram:
    if isinstance(program, str):
        program = parse_program(program)
    options = options or CompileOptions()
    program.validate()
    strata = stratify(program)

    arities: dict[str, int] = {}
    for name in program.idbs | program.edbs:
        arities[name] = program.arity_of(name)

    plans_all: list[I.RulePlan] = []
    stratum_plans: list[I.StratumPlan] = []
    monoid_idbs: dict[str, str] = {}

    for st in strata:
        sp = I.StratumPlan(st.index, st.idbs, st.recursive, [])
        for rule in st.rules:
            if not rule.body:  # ground fact
                tup = tuple(
                    t.value for t in rule.head_terms if isinstance(t, Const))
                if len(tup) != len(rule.head_terms):
                    raise LoweringError(f"non-ground fact {rule}")
                sp.facts.setdefault(rule.head_name, []).append(tup)
                continue
            rec_positions = [
                i for i, a in enumerate(rule.positive_body)
                if a.name in st.idbs]
            if not rec_positions:
                variants = [(-1, {})]
            else:
                variants = []
                for k, p in enumerate(rec_positions):
                    versions: dict[int, str] = {}
                    for j, q in enumerate(rec_positions):
                        versions[q] = (I.FULL_NEW if j < k
                                       else I.DELTA if j == k
                                       else I.FULL_OLD)
                    variants.append((k, versions))
            for var_idx, versions in variants:
                with _ambient_span("compile-rule", head=rule.head_name,
                                   variant=var_idx):
                    root, is_monoid = lower_rule(
                        rule, st.idbs, versions, options)
                    if options.verify_on:
                        verify_ir_or_raise(
                            root, where=f"{rule} [variant {var_idx}]",
                            pass_name="planning" if options.use_planner
                            else "listing")
                    if options.use_fusion:
                        with _ambient_span("pass", stage="fusion"):
                            root = fuse(root)
                        if options.verify_on:
                            verify_ir_or_raise(
                                root,
                                where=f"{rule} [variant {var_idx}]",
                                pass_name="fusion")
                if is_monoid:
                    agg = rule.aggregates[0]
                    vpos = next(
                        i for i, t in enumerate(rule.head_terms)
                        if isinstance(t, Aggregate))
                    prev = monoid_idbs.get(rule.head_name)
                    if prev is not None and prev != (agg.func, vpos):
                        raise LoweringError(
                            f"conflicting monoids for {rule.head_name}")
                    monoid_idbs[rule.head_name] = (agg.func, vpos)
                plan = I.RulePlan(rule.head_name, root, var_idx, repr(rule))
                sp.plans.append(plan)
                plans_all.append(plan)
        stratum_plans.append(sp)

    # Capability check against the engine's physical key representation:
    # the semi-naive merge (merge_with_delta / difference) keys ALL
    # stored head columns with a multi-word lexicographic key
    # (relation.pack_key_words), whose advertised ceiling is
    # relation.MAX_STORED_COLUMNS. Arities beyond it would degrade the
    # probe (one more word per 3 columns, unbounded kernel unroll), so
    # reject at compile time, naming an offending rule. (Monoid IDBs
    # store the lattice value out-of-row, hence the stored arity is
    # head arity - 1.)
    from repro_torch.engine.relation import MAX_STORED_COLUMNS
    for st in strata:
        for rule in st.rules:
            name = rule.head_name
            stored = arities[name] - (1 if name in monoid_idbs else 0)
            if stored > MAX_STORED_COLUMNS:
                raise LoweringError(
                    f"IDB {name!r} stores {stored} head columns, but the "
                    f"engine's multi-word row key supports at most "
                    f"{MAX_STORED_COLUMNS} (relation.MAX_STORED_COLUMNS); "
                    f"offending rule: {rule}")

    # monoid consistency: every rule deriving a monoid IDB must emit the
    # value column; non-aggregate rules for a monoid IDB are treated as
    # emitting their last column as the value (e.g. facts).
    shared: dict[str, I.IR] = {}
    if options.use_sharing:
        with _ambient_span("pass", stage="sharing", plans=len(plans_all)):
            roots = [p.root for p in plans_all]
            new_roots, shared = share_subplans(roots)
            for p, r in zip(plans_all, new_roots):
                object.__setattr__(p, "root", r)

    compiled = I.CompiledProgram(
        strata=stratum_plans,
        arities=arities,
        edbs=set(program.edbs),
        outputs=set(program.outputs),
        shared=shared,
        monoid_idbs=monoid_idbs,
    )
    if options.verify_on:
        # whole-program pass: SharedRef discipline, stratified negation,
        # head arities, stored-arity ceiling — named for the last pass
        # that rewrote the plans
        with _ambient_span("pass", stage="verify"):
            verify_program_or_raise(
                compiled, "sharing" if options.use_sharing else "lowering")
    return compiled
