"""Subplan sharing (paper Sec. 7).

Greedy canonical-form hashing: normalize every IR subtree (variable
positions encoded relative to children — see ``IR.canonical``), hash each
subtree, and when a hash repeats, truncate the subtree and replace it by a
``SharedRef`` pointer to the first occurrence's output. The executor
computes each shared subplan once per iteration and all referees read the
memoized output — this subsumes shared arrangements (a re-keyed sorted
copy of a relation is a Map subtree) and extends to common subexpressions
(a shared Join-FlatMap output), exactly the Fig. 5 mechanism.
"""
from __future__ import annotations

from collections import Counter

from repro_torch.core import ir as I

# Node types eligible for sharing. Scans are excluded: relations are
# already stored once (sorted); sharing a bare scan saves nothing.
_SHAREABLE = (I.Map, I.FlatMap, I.Join, I.JoinFlatMap, I.Semijoin,
              I.Antijoin, I.Reduce, I.Distinct, I.Filter)


def _count_subtrees(roots: list[I.IR]) -> Counter:
    counts: Counter = Counter()

    def visit(n: I.IR):
        if isinstance(n, _SHAREABLE):
            counts[n.canonical_hash()] += 1
        for c in n.children:
            visit(c)

    for r in roots:
        visit(r)
    return counts


def share_subplans(
    roots: list[I.IR],
) -> tuple[list[I.IR], dict[str, I.IR]]:
    """Returns rewritten roots + table of shared subplans (hash -> IR).

    Every occurrence of a repeated subtree becomes SharedRef(hash); the
    shared table entry holds the subtree with *its own* children also
    shared (nested sharing), so the executor evaluates a DAG.
    """
    counts = _count_subtrees(roots)
    shared: dict[str, I.IR] = {}

    def rewrite(n: I.IR) -> I.IR:
        kids = tuple(rewrite(c) for c in n.children)
        # Note: canonical hash must be computed on the *pre-rewrite* node so
        # nested shared children don't change the hash; we compute it before
        # swapping children in.
        h = n.canonical_hash() if isinstance(n, _SHAREABLE) else None
        if kids != n.children:
            n2 = n.with_children(kids)
        else:
            n2 = n
        if h is not None and counts[h] >= 2:
            if h not in shared:
                shared[h] = n2
            return I.SharedRef(h, _plain_schema(n.schema))
        return n2

    new_roots = [rewrite(r) for r in roots]
    return new_roots, shared


def _plain_schema(schema):
    """SharedRef occurrences keep this occurrence's names for the shared
    output's columns (paper: 'identical up to variable renaming')."""
    out = []
    for c in schema:
        if isinstance(c, I.Expr):
            out.append(c.name if c.name is not None else c)
        else:
            out.append(c)
    return tuple(out)


def sharing_stats(roots: list[I.IR], shared: dict[str, I.IR]) -> dict:
    n_refs = 0

    def visit(n: I.IR):
        nonlocal n_refs
        if isinstance(n, I.SharedRef):
            n_refs += 1
        for c in n.children:
            visit(c)

    for r in list(roots) + list(shared.values()):
        visit(r)
    return {"shared_subplans": len(shared), "shared_refs": n_refs}
