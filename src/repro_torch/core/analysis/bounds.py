"""Worst-case plan analyzer — abstract interpretation over rule IRs
computing per-node cardinality upper bounds.

Given sizes for the leaf relations, every IR node gets an upper bound
on its output cardinality:

* unary nodes (Map / Filter / FlatMap / Distinct / Reduce / Semijoin /
  Antijoin) never grow their input, so they pass the child (left)
  bound through;
* ``Concat`` / ``ConcatAll`` sum their inputs;
* a ``Join`` / ``JoinFlatMap`` takes the *minimum* of three sound
  bounds: the Cartesian product ``|L| * |R|``, a distinctness-aware
  key bound (if the join keys cover every column of one side's base
  relation, each left row matches at most one right row — the bound is
  the other side's), and the AGM bound of the maximal join subtree
  rooted here (fractional edge cover over the subtree's hyperedges,
  restricted to weights {0, 1/2, 1} — a sound relaxation since any
  subset of feasible covers upper-bounds the true optimum from above).

The per-rule report compares the *peak* intermediate bound against the
rule's output bound: a plan whose intermediates can dwarf its own
output is a blow-up risk (exactly the join-order failure mode the
robustness benchmark measures), and ``flagged`` marks rules whose
risk ratio exceeds ``flag_factor``.

All arithmetic is in log2-space floats to survive 40-atom rules.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field

from repro_torch.core import ir as I

_LOG_HALF_CAP = 10  # max hyperedges for exhaustive {0,1/2,1} enumeration


def _log2(x: float) -> float:
    return math.log2(x) if x > 0 else float("-inf")


@dataclass(frozen=True)
class NodeBound:
    node: str        # type name of the IR node
    log2_bound: float
    detail: str = ""


@dataclass(frozen=True)
class RuleBoundReport:
    head: str
    variant: int
    source: str
    log2_out: float         # bound on the rule's output cardinality
    log2_peak: float        # max bound over all intermediate nodes
    peak_node: str          # IR node type where the peak occurs
    flagged: bool           # peak / max(out, 1 row) > flag_factor
    nodes: tuple[NodeBound, ...] = ()

    @property
    def risk(self) -> float:
        """log2 of peak-to-output blow-up ratio (>= 0)."""
        return max(self.log2_peak - max(self.log2_out, 0.0), 0.0)


@dataclass
class ProgramBoundReport:
    rules: list[RuleBoundReport] = field(default_factory=list)
    sizes: dict[str, int] = field(default_factory=dict)

    @property
    def log2_peak(self) -> float:
        return max((r.log2_peak for r in self.rules), default=0.0)

    @property
    def flagged(self) -> list[RuleBoundReport]:
        return [r for r in self.rules if r.flagged]

    def pretty(self) -> str:
        out = []
        for r in sorted(self.rules, key=lambda r: -r.log2_peak):
            mark = " **BLOW-UP RISK**" if r.flagged else ""
            out.append(
                f"  {r.head}[v{r.variant}] peak 2^{r.log2_peak:.1f} "
                f"@{r.peak_node}, out 2^{r.log2_out:.1f}, "
                f"risk 2^{r.risk:.1f}{mark}  {r.source}")
        return "\n".join(out) if out else "  (no rules)"


# -- hyperedge collection for AGM --------------------------------------------

@dataclass(frozen=True)
class _Edge:
    vars: frozenset
    log2_size: float


def _agm_log2(edges: list[_Edge]) -> float:
    """AGM bound: min over fractional edge covers of sum(w_e * log|R_e|),
    with weights restricted to {0, 1/2, 1}. Sound (restricting the LP
    feasible set can only raise the minimum); exact for the common
    cycles (triangle: all-1/2)."""
    allvars = frozenset().union(*(e.vars for e in edges))
    if not allvars:
        return sum(e.log2_size for e in edges)
    m = len(edges)
    best = float("inf")
    if m <= _LOG_HALF_CAP:
        for ws in itertools.product((0.0, 0.5, 1.0), repeat=m):
            cover: dict = {v: 0.0 for v in allvars}
            for w, e in zip(ws, edges):
                for v in e.vars:
                    cover[v] += w
            if all(c >= 1.0 for c in cover.values()):
                best = min(best, sum(w * e.log2_size
                                     for w, e in zip(ws, edges)))
    if best == float("inf"):
        # fallback: greedy weight-1 set cover (always feasible)
        uncovered = set(allvars)
        total = 0.0
        for e in sorted(edges, key=lambda e: e.log2_size):
            if uncovered & e.vars:
                uncovered -= e.vars
                total += e.log2_size
        best = total
    return best


class _Analyzer:
    def __init__(self, sizes: dict[str, int], shared: dict[str, I.IR],
                 default_size: int):
        self.sizes = sizes
        self.shared = shared
        self.default = default_size
        self._shared_bounds: dict[str, float] = {}
        self._fresh = itertools.count()

    def leaf_size(self, rel: str) -> float:
        return _log2(max(self.sizes.get(rel, self.default), 1))

    # -- bounds ---------------------------------------------------------

    def bound(self, node: I.IR, out: list[NodeBound],
              _stack: frozenset = frozenset()) -> float:
        b = self._bound(node, out, _stack)
        out.append(NodeBound(type(node).__name__, b))
        return b

    def _bound(self, node, out, stack) -> float:
        if isinstance(node, I.Scan):
            return self.leaf_size(node.rel)
        if isinstance(node, I.SharedRef):
            if node.ref in stack or node.ref not in self.shared:
                return self.leaf_size(node.ref)
            if node.ref not in self._shared_bounds:
                self._shared_bounds[node.ref] = self.bound(
                    self.shared[node.ref], out, stack | {node.ref})
            return self._shared_bounds[node.ref]
        if isinstance(node, (I.Map, I.FlatMap, I.Filter, I.Distinct,
                             I.Reduce)):
            return self.bound(node.child, out, stack)
        if isinstance(node, (I.Semijoin, I.Antijoin)):
            # reducers/negation never grow the left side; still visit
            # the right for its own intermediate bounds
            b = self.bound(node.left, out, stack)
            self.bound(node.right, out, stack)
            return b
        if isinstance(node, (I.Concat, I.ConcatAll)):
            kids = [self.bound(c, out, stack) for c in node.children]
            finite = [k for k in kids if k > float("-inf")]
            if not finite:
                return float("-inf")
            top = max(finite)
            return top + _log2(sum(2.0 ** (k - top) for k in finite))
        if isinstance(node, (I.Join, I.JoinFlatMap)):
            bl = self.bound(node.left, out, stack)
            br = self.bound(node.right, out, stack)
            cand = [bl + br]  # Cartesian product
            # distinctness-aware key bound: keys covering one whole
            # side of a base relation => at most one match per row
            for keyed, other in ((node.left, br), (node.right, bl)):
                names = {n for n in I.schema_names(keyed.schema)
                         if n is not None}
                if names and names <= set(node.keys) and \
                        self._is_setlike(keyed, stack):
                    cand.append(other)
            # AGM over the maximal join subtree rooted here
            edges = self._hyperedges(node, stack)
            if edges is not None and len(edges) >= 2:
                cand.append(_agm_log2(edges))
            return min(cand)
        raise TypeError(f"unknown IR node {type(node).__name__}")

    def _is_setlike(self, node, stack) -> bool:
        """True if the node's output is duplicate-free (a stored
        relation or a Distinct/Reduce of anything)."""
        if isinstance(node, (I.Scan, I.Distinct, I.Reduce)):
            return True
        if isinstance(node, I.SharedRef):
            if node.ref in self.shared and node.ref not in stack:
                return self._is_setlike(self.shared[node.ref],
                                        stack | {node.ref})
            return True  # materialized shared outputs are distinct
        if isinstance(node, (I.Filter, I.Semijoin, I.Antijoin)):
            return self._is_setlike(node.left if hasattr(node, "left")
                                    else node.child, stack)
        return False

    # -- hyperedge extraction -------------------------------------------

    def _hyperedges(self, node, stack):
        """Hyperedges of the maximal join subtree rooted at ``node``,
        or None when the subtree contains a node AGM can't model
        soundly as a conjunctive query (Concat/Reduce)."""
        if isinstance(node, (I.Join, I.JoinFlatMap)):
            l = self._hyperedges(node.left, stack)
            r = self._hyperedges(node.right, stack)
            if l is None or r is None:
                return None
            return l + r
        if isinstance(node, (I.Filter, I.Distinct)):
            return self._hyperedges(node.child, stack)
        if isinstance(node, I.FlatMap):
            return self._edge_of(node, node.child.schema, stack)
        if isinstance(node, I.Map):
            return self._edge_of(node, node.child.schema, stack)
        if isinstance(node, (I.Semijoin, I.Antijoin)):
            return self._hyperedges(node.left, stack)
        if isinstance(node, I.Scan):
            return self._edge_of(node, node.schema, stack)
        if isinstance(node, I.SharedRef):
            if node.ref in self.shared and node.ref not in stack:
                sub = self.shared[node.ref]
                inner = self._hyperedges(sub, stack | {node.ref})
                if inner is not None and len(inner) == 1:
                    # single-edge expansion: rename the def's output
                    # vars to this occurrence's names
                    return self._edge_of(node, node.schema, stack)
            return self._edge_of(node, node.schema, stack)
        return None

    def _edge_of(self, node, var_schema, stack):
        """One hyperedge: the node's *output* variables, sized by the
        node's bound (projections keep the edge sound: projecting
        can't grow cardinality)."""
        names = frozenset(
            n if n is not None else f"_anon{next(self._fresh)}"
            for n in I.schema_names(node.schema))
        scratch: list[NodeBound] = []
        return [_Edge(names, self.bound(node, scratch, stack))]


def analyze_rule(plan: I.RulePlan, sizes: dict[str, int],
                 shared: dict[str, I.IR] | None = None, *,
                 default_size: int = 1000,
                 flag_factor: float = 8.0) -> RuleBoundReport:
    """Bound one rule plan. ``sizes`` maps relation name -> row count
    (EDBs and, when known, IDBs); unknown relations get
    ``default_size``."""
    an = _Analyzer(sizes, shared or {}, default_size)
    nodes: list[NodeBound] = []
    out_b = an.bound(plan.root, nodes)
    # peak over *derived* nodes only: a big leaf Scan is input size,
    # not a blow-up the plan is responsible for
    derived = [nb for nb in nodes
               if nb.node not in ("Scan", "SharedRef")] \
        or [NodeBound("Scan", out_b)]
    peak = max(derived, key=lambda nb: nb.log2_bound)
    risk = peak.log2_bound - max(out_b, 0.0)
    return RuleBoundReport(
        head=plan.head, variant=plan.variant, source=plan.source,
        log2_out=out_b, log2_peak=peak.log2_bound,
        peak_node=peak.node,
        flagged=risk > _log2(flag_factor),
        nodes=tuple(nodes))


def analyze_program(compiled: I.CompiledProgram,
                    sizes: dict[str, int] | None = None, *,
                    default_size: int = 1000,
                    flag_factor: float = 8.0) -> ProgramBoundReport:
    """Bound every rule of a compiled program.

    When ``sizes`` omits IDBs, they are estimated stratum-by-stratum:
    a non-recursive IDB gets the sum of its rules' output bounds; a
    recursive one gets at least ``default_size`` (recursion can grow
    past any static estimate, so the estimate is a floor used only to
    rank plans, never claimed sound for IDB outputs — intermediate
    *per-iteration* bounds relative to these sizes are the point)."""
    sizes = dict(sizes or {})
    report = ProgramBoundReport(sizes=sizes)
    for sp in compiled.strata:
        # estimate missing IDB sizes for this stratum
        est: dict[str, float] = {}
        for p in sp.plans:
            if p.head in sizes:
                continue
            an = _Analyzer(sizes, compiled.shared, default_size)
            b = an.bound(p.root, [])
            est[p.head] = est.get(p.head, float("-inf"))
            top = max(est[p.head], b)
            if top > float("-inf"):
                est[p.head] = top + _log2(
                    2.0 ** (est[p.head] - top) + 2.0 ** (b - top))
        for h, lb in est.items():
            n = int(min(2.0 ** max(lb, 0.0), 2.0 ** 62))
            sizes[h] = max(n, default_size if sp.recursive else n)
        # final per-rule reports with sizes fixed
        for p in sp.plans:
            report.rules.append(analyze_rule(
                p, sizes, compiled.shared,
                default_size=default_size, flag_factor=flag_factor))
    return report
