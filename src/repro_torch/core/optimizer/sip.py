"""Sideways information passing (paper Sec. 6).

Generalized two-pass Yannakakis-style semijoin reduction over *arbitrary*
(possibly cyclic) join graphs:

  pass 1: BFS from a start atom; when visiting atom v, semijoin-reduce v
          by every already-visited neighbor (on their shared variables);
  pass 2: traverse in reverse visit order; reduce each atom by its
          neighbors that come later in the visit order (already re-reduced).

The rewriting is represented directly in the IR: each atom's leaf subtree
is replaced by a chain of Semijoins. Soundness is by construction — a
semijoin with any other body atom only drops tuples that cannot
participate in this rule's output. For semi-naive delta variants the
reducers reference FULL_NEW versions of recursive atoms (a superset of
every variant's atom, hence still sound).

Subplan sharing (Sec. 7) then deduplicates the p1/p2-style intermediate
reducers across the variants and across rules, mirroring the paper's
"new IRs for auxiliary semijoin rules".
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

from repro_torch.core import ir as I
from repro_torch.core.optimizer.joingraph import JoinGraph


@dataclass
class SipSchedule:
    """For each atom index: the list of (other_atom_idx, shared_vars) to
    semijoin against, in application order (pass-1 filters then pass-2)."""
    order: list[int]
    reducers: dict[int, list[tuple[int, tuple[str, ...]]]]


def plan_sip(graph: JoinGraph, start: int = 0) -> SipSchedule:
    n = graph.n
    if n < 2:
        return SipSchedule(list(range(n)), {})
    # BFS order over the join graph (cross-component atoms appended)
    order: list[int] = []
    seen: set[int] = set()
    for s in [start] + [i for i in range(n) if i != start]:
        if s in seen:
            continue
        q = deque([s])
        seen.add(s)
        while q:
            v = q.popleft()
            order.append(v)
            for w in graph.neighbors(v):
                if w not in seen:
                    seen.add(w)
                    q.append(w)

    pos = {v: i for i, v in enumerate(order)}
    reducers: dict[int, list[tuple[int, tuple[str, ...]]]] = {
        i: [] for i in range(n)}

    def shared(i: int, j: int) -> tuple[str, ...]:
        return tuple(sorted(
            graph.atoms[i].var_names & graph.atoms[j].var_names))

    # pass 1: reduce v by visited neighbors
    for v in order:
        for w in graph.neighbors(v):
            if pos[w] < pos[v]:
                reducers[v].append((w, shared(v, w)))
    # pass 2: reduce v by later neighbors (their pass-1-reduced forms)
    for v in reversed(order):
        for w in graph.neighbors(v):
            if pos[w] > pos[v]:
                reducers[v].append((w, shared(v, w)))
    return SipSchedule(order, reducers)


def apply_sip(
    leaf_irs: list[I.IR],
    schedule: SipSchedule,
) -> list[I.IR]:
    """Wrap each atom's leaf IR in its semijoin-reduction chain.

    Reduced forms are built in two passes mirroring plan_sip, so pass-2
    chains reference pass-1-reduced (not raw) neighbors — the
    p1/p2 -> p3/c4 structure of Example 6.1.
    """
    n = len(leaf_irs)
    pos = {v: i for i, v in enumerate(schedule.order)}
    pass1: list[I.IR] = list(leaf_irs)
    # pass 1 in visit order
    for v in schedule.order:
        ir = leaf_irs[v]
        for (w, keys) in schedule.reducers.get(v, []):
            if pos[w] < pos[v] and keys:
                ir = I.Semijoin(ir, pass1[w], keys)
        pass1[v] = ir
    # pass 2 in reverse order
    final: list[I.IR] = list(pass1)
    for v in reversed(schedule.order):
        ir = pass1[v]
        for (w, keys) in schedule.reducers.get(v, []):
            if pos[w] > pos[v] and keys:
                ir = I.Semijoin(ir, final[w], keys)
        final[v] = ir
    return final
