"""Dependency graph + stratification (paper Sec. 2.1).

We build the predicate-level dependency graph (equivalent to the paper's
rule-level graph for stratification purposes), find strongly connected
components with Tarjan's algorithm, verify stratified negation/aggregation
(no negative or aggregate edge inside an SCC), and emit strata in
topological order. Each stratum carries its rules and per-rule recursive
flags, which drive semi-naive delta-variant generation in the engine.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.datalog.ast import Program, Rule


@dataclass
class Stratum:
    index: int
    idbs: frozenset[str]
    rules: list[Rule]
    recursive: bool

    def recursive_atoms(self, rule: Rule) -> list[int]:
        """Positions (into rule.positive_body) of atoms in this stratum."""
        return [i for i, a in enumerate(rule.positive_body)
                if a.name in self.idbs]

    def __repr__(self) -> str:
        kind = "rec" if self.recursive else "nonrec"
        return f"Stratum#{self.index}({kind}, {sorted(self.idbs)})"


def _tarjan(nodes: list[str], edges: dict[str, set[str]]) -> list[list[str]]:
    """Tarjan SCC; returns components in *reverse* topological order."""
    index_of: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    sccs: list[list[str]] = []
    counter = [0]

    def strongconnect(v: str) -> None:
        # iterative to avoid recursion limits on deep programs
        work = [(v, iter(sorted(edges.get(v, ()))))]
        index_of[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index_of:
                    index_of[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(edges.get(w, ())))))
                    advanced = True
                    break
                elif w in on_stack:
                    low[node] = min(low[node], index_of[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index_of[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                sccs.append(comp)

    for v in nodes:
        if v not in index_of:
            strongconnect(v)
    return sccs


def stratify(program: Program) -> list[Stratum]:
    idbs = program.idbs
    # predicate dependency graph: edge p -> q if p in body of a rule with head q
    edges: dict[str, set[str]] = {p: set() for p in idbs}
    neg_edges: set[tuple[str, str]] = set()
    for r in program.rules:
        for a in r.body:
            if a.name in idbs:
                edges.setdefault(a.name, set()).add(r.head_name)
                if a.negated:
                    neg_edges.add((a.name, r.head_name))
        if r.has_aggregate:
            # aggregation over an IDB in the same SCC would be unstratified
            # unless handled by the monoid path (recursive aggregation, Sec. 9).
            pass

    sccs = _tarjan(sorted(idbs), edges)  # reverse topological order
    sccs.reverse()                       # topological order

    comp_of: dict[str, int] = {}
    for ci, comp in enumerate(sccs):
        for name in comp:
            comp_of[name] = ci

    for (src, dst) in neg_edges:
        if comp_of.get(src) == comp_of.get(dst):
            raise ValueError(
                f"program is not stratifiable: negative cycle through "
                f"{src} -> {dst}")

    strata: list[Stratum] = []
    for ci, comp in enumerate(sccs):
        comp_set = frozenset(comp)
        rules = [r for r in program.rules if r.head_name in comp_set]
        recursive = any(
            a.name in comp_set for r in rules for a in r.positive_body
        ) or any(
            # self-loop single-node SCC
            a.name == r.head_name for r in rules for a in r.positive_body
        )
        strata.append(Stratum(ci, comp_set, rules, recursive))
    return strata


def rule_is_recursive(rule: Rule, stratum: Stratum) -> bool:
    return any(a.name in stratum.idbs for a in rule.positive_body)
