"""Join graph, join spanning trees (JST), and the structural cost model
(paper Sec. 5).

The optimizer's search space is *all rooted JSTs of the rule's weighted
join graph* (Sec. 5.2): maximum spanning trees, which collapse to join
trees for acyclic rules. A rooted JST defines a join-project plan via
post-order traversal; its structural cost is the maximum number of
distinct variables participating in any single transformation (Sec. 5.1),
which upper-bounds worst-case intermediate sizes [Zhao et al. 2024].

Semijoin-subsumed atoms (vars ⊆ another atom's vars) are excluded from the
graph and pushed down as leaf semijoins (Sec. 5.2 'Search Space').
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

from repro_torch.core.datalog.ast import Atom, Rule


@dataclass
class JoinGraph:
    """Nodes are indices into ``atoms``; ``subsumed[i]`` lists atoms pushed
    down onto atom i as semijoins. ``positions[i]`` is atom i's index into
    the rule's positive body (for semi-naive delta tagging); subsumed
    entries carry their body position too."""
    atoms: list[Atom]
    edges: dict[tuple[int, int], int]          # (i<j) -> weight (#shared vars)
    positions: list[int] = field(default_factory=list)
    subsumed: dict[int, list[tuple[int, Atom]]] = field(default_factory=dict)

    @property
    def n(self) -> int:
        return len(self.atoms)

    def neighbors(self, i: int) -> list[int]:
        out = []
        for (a, b) in self.edges:
            if a == i:
                out.append(b)
            elif b == i:
                out.append(a)
        return sorted(out)

    def weight(self, i: int, j: int) -> int:
        return self.edges.get((min(i, j), max(i, j)), 0)


def build_join_graph(rule: Rule) -> JoinGraph:
    pos = list(rule.positive_body)
    var_sets = [a.var_names for a in pos]

    # -- semijoin subsumption: atom i subsumed by atom j if vars_i ⊆ vars_j.
    # Pushed down to the host leaf; the host with the largest overlap wins.
    subsumed_idx: set[int] = set()
    host_of: dict[int, int] = {}
    order = sorted(range(len(pos)), key=lambda i: (len(var_sets[i]), i))
    for i in order:
        if len(pos) - len(subsumed_idx) <= 1:
            break  # keep at least one atom in the graph
        best, best_overlap = None, -1
        for j in range(len(pos)):
            if j == i or j in subsumed_idx:
                continue
            if var_sets[i] <= var_sets[j]:
                ov = len(var_sets[i] & var_sets[j])
                if ov > best_overlap:
                    best, best_overlap = j, ov
        if best is not None:
            subsumed_idx.add(i)
            host_of[i] = best

    keep = [i for i in range(len(pos)) if i not in subsumed_idx]
    remap = {old: new for new, old in enumerate(keep)}
    atoms = [pos[i] for i in keep]
    subsumed: dict[int, list[tuple[int, Atom]]] = {}
    for i, j in host_of.items():
        # hosts may themselves be subsumed transitively; chase to a kept atom
        while j in host_of:
            j = host_of[j]
        subsumed.setdefault(remap[j], []).append((i, pos[i]))

    edges: dict[tuple[int, int], int] = {}
    for i, j in itertools.combinations(range(len(atoms)), 2):
        w = len(atoms[i].var_names & atoms[j].var_names)
        if w > 0:
            edges[(i, j)] = w
    return JoinGraph(atoms, edges, keep, subsumed)


# -- spanning tree enumeration ----------------------------------------------


class _UnionFind:
    def __init__(self, n: int):
        self.p = list(range(n))

    def find(self, x: int) -> int:
        while self.p[x] != x:
            self.p[x] = self.p[self.p[x]]
            x = self.p[x]
        return x

    def union(self, a: int, b: int) -> bool:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return False
        self.p[ra] = rb
        return True

    def copy(self) -> "_UnionFind":
        u = _UnionFind(0)
        u.p = list(self.p)
        return u


def connected_components(n: int, edges) -> list[list[int]]:
    uf = _UnionFind(n)
    for (i, j) in edges:
        uf.union(i, j)
    comps: dict[int, list[int]] = {}
    for v in range(n):
        comps.setdefault(uf.find(v), []).append(v)
    return sorted(comps.values(), key=len)


def enumerate_spanning_trees(
    nodes: list[int],
    edges: dict[tuple[int, int], int],
    cap: int = 2000,
) -> list[list[tuple[int, int]]]:
    """All spanning trees of the (connected) subgraph on ``nodes``, capped.
    Simple include/exclude recursion with union-find pruning [Winter 1986
    describes an optimal enumeration; this bounded version suffices for
    rule-sized graphs — DOOP's largest is an 8-way join]."""
    es = sorted(
        [e for e in edges if e[0] in nodes and e[1] in nodes],
        key=lambda e: -edges[e])
    need = len(nodes) - 1
    out: list[list[tuple[int, int]]] = []

    def rec(idx: int, chosen: list[tuple[int, int]], uf: _UnionFind):
        if len(out) >= cap:
            return
        if len(chosen) == need:
            out.append(list(chosen))
            return
        if idx >= len(es):
            return
        # prune: not enough edges left
        if len(es) - idx < need - len(chosen):
            return
        e = es[idx]
        uf2 = uf.copy()
        if uf2.union(e[0], e[1]):
            chosen.append(e)
            rec(idx + 1, chosen, uf2)
            chosen.pop()
        rec(idx + 1, chosen, uf)

    uf = _UnionFind(max(nodes) + 1 if nodes else 1)
    rec(0, [], uf)
    return out


def maximum_spanning_trees(
    nodes: list[int],
    edges: dict[tuple[int, int], int],
    cap: int = 2000,
) -> list[list[tuple[int, int]]]:
    trees = enumerate_spanning_trees(nodes, edges, cap)
    if not trees:
        return []
    best = max(sum(edges[e] for e in t) for t in trees)
    return [t for t in trees if sum(edges[e] for e in t) == best]


# -- structural cost of a rooted JST ----------------------------------------


@dataclass
class RootedTree:
    root: int
    children: dict[int, list[int]]           # node -> ordered child list
    parent: dict[int, int]

    def depth(self) -> int:
        def d(v: int) -> int:
            kids = self.children.get(v, [])
            return 1 + max((d(c) for c in kids), default=0)
        return d(self.root)


def root_tree(
    tree_edges: list[tuple[int, int]], root: int
) -> RootedTree:
    adj: dict[int, list[int]] = {}
    for (i, j) in tree_edges:
        adj.setdefault(i, []).append(j)
        adj.setdefault(j, []).append(i)
    children: dict[int, list[int]] = {}
    parent: dict[int, int] = {}
    stack = [root]
    seen = {root}
    while stack:
        v = stack.pop()
        for w in adj.get(v, []):
            if w not in seen:
                seen.add(w)
                parent[w] = v
                children.setdefault(v, []).append(w)
                stack.append(w)
    return RootedTree(root, children, parent)


def structural_cost(
    rt: RootedTree,
    atom_vars: list[frozenset[str]],
    needed_top: frozenset[str],
) -> int:
    """Max #distinct variables over every transformation of the post-order
    join-project plan defined by the rooted JST (paper Sec. 5.1)."""
    subtree_nodes: dict[int, set[int]] = {}

    def collect(v: int) -> set[int]:
        s = {v}
        for c in rt.children.get(v, []):
            s |= collect(c)
        subtree_nodes[v] = s
        return s

    all_nodes = collect(rt.root)
    max_cost = 0

    def visit(v: int) -> frozenset[str]:
        nonlocal max_cost
        max_cost = max(max_cost, len(atom_vars[v]))       # scan cost
        acc = set(atom_vars[v])
        kids = rt.children.get(v, [])
        results = [(c, visit(c)) for c in kids]
        results.sort(key=lambda cr: len(cr[1]))           # join small first
        for c, rvars in results:
            max_cost = max(max_cost, len(acc | rvars))    # join step cost
            acc |= rvars
        # project away vars no longer needed: keep vars of atoms outside
        # this subtree (future join keys) and the head/top vars
        outside: set[str] = set(needed_top)
        for u in all_nodes - subtree_nodes[v]:
            outside |= atom_vars[u]
        return frozenset(acc & outside)

    visit(rt.root)
    return max_cost


@dataclass
class PlanChoice:
    """One component's chosen rooted JST."""
    tree: RootedTree
    cost: int


def choose_plan(
    graph: JoinGraph,
    needed_top: frozenset[str],
    max_trees: int = 2000,
) -> list[PlanChoice]:
    """Pick min-cost rooted JSTs, tie-broken toward bushier (shallower)
    trees (Sec. 5.3), one per connected component (cross products between
    components are sequenced smallest-first by the lowering)."""
    atom_vars = [a.var_names for a in graph.atoms]
    comps = connected_components(graph.n, graph.edges)
    choices: list[PlanChoice] = []
    for comp in comps:
        if len(comp) == 1:
            rt = RootedTree(comp[0], {}, {})
            choices.append(
                PlanChoice(rt, len(atom_vars[comp[0]])))
            continue
        best: tuple[int, int, RootedTree] | None = None
        for tree_edges in maximum_spanning_trees(comp, graph.edges, max_trees):
            for root in comp:
                rt = root_tree(tree_edges, root)
                cost = structural_cost(rt, atom_vars, needed_top)
                key = (cost, rt.depth())
                if best is None or key < (best[0], best[1]):
                    best = (cost, rt.depth(), rt)
        assert best is not None
        choices.append(PlanChoice(best[2], best[0]))
    return choices


def listing_order_plan(graph: JoinGraph) -> list[PlanChoice]:
    """Left-deep plan in the written atom order (what Soufflé/DDlog do,
    Sec. 5.3) — used as the no-planner baseline and in ablations. Encoded
    as a 'caterpillar' rooted tree: root = last atom, chain down to first."""
    comps = connected_components(graph.n, graph.edges)
    choices = []
    for comp in comps:
        comp = sorted(comp)
        children: dict[int, list[int]] = {}
        parent: dict[int, int] = {}
        for prev, nxt in zip(comp, comp[1:]):
            children[nxt] = [prev]
            parent[prev] = nxt
        rt = RootedTree(comp[-1], children, parent)
        choices.append(PlanChoice(rt, -1))
    return choices
