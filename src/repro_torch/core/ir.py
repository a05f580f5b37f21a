"""Relational IR (paper Sec. 3).

Each Datalog rule compiles to a tree of logical transformations — "the IR
always reads like an ordinary SQL query plan". Leaf nodes are table scans,
interior nodes are transformations, and every node carries an explicit
output ``schema``: a tuple of column descriptors, each either a variable
name (str) or an int constant column.

The IR is *logical*: nothing here touches JAX. The executor
(repro_torch.engine.lower) renders an IR bundle into the physical dataflow.

Scan versions implement semi-naive evaluation (Sec. 2.2): the engine
instantiates each recursive rule once per delta-variant, with recursive
leaves tagged FULL_NEW / DELTA / FULL_OLD. Variants are generated *before*
subplan sharing, so arrangements of non-delta subtrees are shared across
variants — exactly the arrangement-reuse story of Sec. 7.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field, replace
from typing import Optional, Union

@dataclass(frozen=True)
class Expr:
    """Arithmetic output column, e.g. ``d + c`` — evaluated during a
    Map/FlatMap pass. Operands are column names, int constants, or nested
    Exprs. ``name`` (if set) lets downstream nodes reference the computed
    column (e.g. the Reduce over ``MIN(d + c)``)."""
    op: str  # + - *
    lhs: "ColumnRef"
    rhs: "ColumnRef"
    name: Optional[str] = None

    def __repr__(self) -> str:
        n = f" as {self.name}" if self.name else ""
        return f"({self.lhs}{self.op}{self.rhs}{n})"


ColumnRef = Union[str, int, Expr]  # variable | constant column | arithmetic


def schema_index(schema: tuple["ColumnRef", ...], name: str) -> int:
    """Position of column ``name`` in a schema; matches plain var names and
    named Expr columns."""
    for i, c in enumerate(schema):
        if isinstance(c, str) and c == name:
            return i
        if isinstance(c, Expr) and c.name == name:
            return i
    raise KeyError(f"column {name!r} not in schema {schema}")


def schema_names(schema: tuple["ColumnRef", ...]) -> list[Optional[str]]:
    out: list[Optional[str]] = []
    for c in schema:
        if isinstance(c, str):
            out.append(c)
        elif isinstance(c, Expr):
            out.append(c.name)
        else:
            out.append(None)
    return out

# scan versions for semi-naive evaluation
FULL = "full"          # current full relation (non-recursive reference)
DELTA = "delta"        # last iteration's new tuples
FULL_OLD = "full_old"  # full before this iteration's delta was merged
FULL_NEW = "full_new"  # full including this iteration's delta


@dataclass(frozen=True)
class CompOp:
    """A comparison over a node's schema: ``lhs op rhs`` where each side is
    a column name or an int constant."""
    op: str
    lhs: ColumnRef
    rhs: ColumnRef

    def __repr__(self) -> str:
        return f"{self.lhs}{self.op}{self.rhs}"


class IR:
    """Base class; all concrete nodes are frozen dataclasses."""
    schema: tuple[ColumnRef, ...]

    @property
    def children(self) -> tuple["IR", ...]:
        return ()

    def with_children(self, kids: tuple["IR", ...]) -> "IR":
        raise NotImplementedError

    # -- canonicalization (Sec. 7) ----------------------------------------
    def canonical(self) -> str:
        """Canonical form encoding variable positions relative to children
        (paper Fig. 5): two subtrees identical up to variable renaming have
        equal canonical strings."""
        raise NotImplementedError

    def canonical_hash(self) -> str:
        return hashlib.blake2b(
            self.canonical().encode(), digest_size=8).hexdigest()

    def _col_index(self, ref: ColumnRef, kids_schema: tuple[ColumnRef, ...]):
        if isinstance(ref, int):
            return ("c", ref)
        if isinstance(ref, Expr):
            return ("e", ref.op, self._col_index(ref.lhs, kids_schema),
                    self._col_index(ref.rhs, kids_schema))
        return ("v", schema_index(kids_schema, ref))

    def pretty(self, indent: int = 0) -> str:
        pad = "  " * indent
        name = type(self).__name__
        extra = self._pretty_extra()
        lines = [f"{pad}{name}{extra} -> {list(self.schema)}"]
        for c in self.children:
            lines.append(c.pretty(indent + 1))
        return "\n".join(lines)

    def _pretty_extra(self) -> str:
        return ""


@dataclass(frozen=True)
class Scan(IR):
    rel: str
    schema: tuple[ColumnRef, ...]
    version: str = FULL

    @property
    def children(self):
        return ()

    def with_children(self, kids):
        assert not kids
        return self

    def canonical(self) -> str:
        # variables are canonicalized away: a scan exposes rel.0, rel.1, ...
        # duplicate variables within the atom are structural, so encode them.
        dup = []
        seen: dict[ColumnRef, int] = {}
        for i, c in enumerate(self.schema):
            if isinstance(c, str):
                if c in seen:
                    dup.append((i, seen[c]))
                else:
                    seen[c] = i
        return f"scan({self.rel},{self.version},{len(self.schema)},{dup})"

    def _pretty_extra(self):
        v = "" if self.version == FULL else f"[{self.version}]"
        return f"({self.rel}{v})"


@dataclass(frozen=True)
class Map(IR):
    """Projection / column re-organization (paper: Map re-organizes data
    into key-value layout; key layout is physical and decided at lowering,
    so the logical Map just fixes column order)."""
    child: IR
    schema: tuple[ColumnRef, ...]

    @property
    def children(self):
        return (self.child,)

    def with_children(self, kids):
        return replace(self, child=kids[0])

    def canonical(self) -> str:
        cols = [self._col_index(c, self.child.schema) for c in self.schema]
        return f"map({self.child.canonical()},{cols})"


@dataclass(frozen=True)
class Filter(IR):
    child: IR
    comparisons: tuple[CompOp, ...]

    @property
    def schema(self):
        return self.child.schema

    @property
    def children(self):
        return (self.child,)

    def with_children(self, kids):
        return replace(self, child=kids[0])

    def canonical(self) -> str:
        cs = sorted(
            (c.op, self._col_index(c.lhs, self.child.schema),
             self._col_index(c.rhs, self.child.schema))
            for c in self.comparisons)
        return f"filter({self.child.canonical()},{cs})"

    def _pretty_extra(self):
        return f"({list(self.comparisons)})"


@dataclass(frozen=True)
class FlatMap(IR):
    """Fused Map+Filter (paper Sec. 4): filter + project in one pass."""
    child: IR
    schema: tuple[ColumnRef, ...]
    comparisons: tuple[CompOp, ...] = ()

    @property
    def children(self):
        return (self.child,)

    def with_children(self, kids):
        return replace(self, child=kids[0])

    def canonical(self) -> str:
        cols = [self._col_index(c, self.child.schema) for c in self.schema]
        cs = sorted(
            (c.op, self._col_index(c.lhs, self.child.schema),
             self._col_index(c.rhs, self.child.schema))
            for c in self.comparisons)
        return f"flatmap({self.child.canonical()},{cols},{cs})"

    def _pretty_extra(self):
        return f"({list(self.comparisons)})" if self.comparisons else ""


@dataclass(frozen=True)
class Join(IR):
    """Natural join on ``keys`` (variables present on both sides). Both
    inputs are arranged on the key at the physical layer (paper Sec. 2.3)."""
    left: IR
    right: IR
    keys: tuple[str, ...]
    schema: tuple[ColumnRef, ...]

    @property
    def children(self):
        return (self.left, self.right)

    def with_children(self, kids):
        return replace(self, left=kids[0], right=kids[1])

    def canonical(self) -> str:
        lk = [schema_index(self.left.schema, k) for k in self.keys]
        rk = [schema_index(self.right.schema, k) for k in self.keys]
        cols = []
        for c in self.schema:
            if isinstance(c, str) and c in self.left.schema:
                cols.append(("l", schema_index(self.left.schema, c)))
            elif isinstance(c, str):
                cols.append(("r", schema_index(self.right.schema, c)))
            else:
                cols.append(("c", c))
        return (f"join({self.left.canonical()},{self.right.canonical()},"
                f"{lk},{rk},{cols})")

    def _pretty_extra(self):
        return f"(on {list(self.keys)})"


@dataclass(frozen=True)
class JoinFlatMap(IR):
    """Fused Join + Map/Filter (paper Sec. 4, 'Join-FlatMap'): renders to a
    single join_core-style physical op that filters and projects each match
    without materializing the full join output."""
    left: IR
    right: IR
    keys: tuple[str, ...]
    schema: tuple[ColumnRef, ...]
    comparisons: tuple[CompOp, ...] = ()

    @property
    def children(self):
        return (self.left, self.right)

    def with_children(self, kids):
        return replace(self, left=kids[0], right=kids[1])

    def _joined_schema(self):
        joined = list(self.left.schema)
        for c in self.right.schema:
            if c not in joined or isinstance(c, int):
                joined.append(c)
        return tuple(joined)

    def canonical(self) -> str:
        lk = [schema_index(self.left.schema, k) for k in self.keys]
        rk = [schema_index(self.right.schema, k) for k in self.keys]
        js = self._joined_schema()
        cols = [self._col_index(c, js) for c in self.schema]
        cs = sorted(
            (c.op, self._col_index(c.lhs, js), self._col_index(c.rhs, js))
            for c in self.comparisons)
        return (f"jfm({self.left.canonical()},{self.right.canonical()},"
                f"{lk},{rk},{cols},{cs})")

    def _pretty_extra(self):
        f = f", {list(self.comparisons)}" if self.comparisons else ""
        return f"(on {list(self.keys)}{f})"


@dataclass(frozen=True)
class Semijoin(IR):
    """left ⋉ right on keys; schema = left.schema. Used for subsumed atoms
    (Sec. 5.2 'search space excludes semijoins ... pushed down') and for
    the sip reducers (Sec. 6)."""
    left: IR
    right: IR
    keys: tuple[str, ...]

    @property
    def schema(self):
        return self.left.schema

    @property
    def children(self):
        return (self.left, self.right)

    def with_children(self, kids):
        return replace(self, left=kids[0], right=kids[1])

    def canonical(self) -> str:
        lk = [schema_index(self.left.schema, k) for k in self.keys]
        rk = [schema_index(self.right.schema, k) for k in self.keys]
        return (f"semijoin({self.left.canonical()},"
                f"{self.right.canonical()},{lk},{rk})")

    def _pretty_extra(self):
        return f"(on {list(self.keys)})"


@dataclass(frozen=True)
class Antijoin(IR):
    """left ▷ right on keys (stratified negation). Under Boolean diffs this
    lowers through the lift operator (Sec. 8)."""
    left: IR
    right: IR
    keys: tuple[str, ...]

    @property
    def schema(self):
        return self.left.schema

    @property
    def children(self):
        return (self.left, self.right)

    def with_children(self, kids):
        return replace(self, left=kids[0], right=kids[1])

    def canonical(self) -> str:
        lk = [schema_index(self.left.schema, k) for k in self.keys]
        rk = [schema_index(self.right.schema, k) for k in self.keys]
        return (f"antijoin({self.left.canonical()},"
                f"{self.right.canonical()},{lk},{rk})")

    def _pretty_extra(self):
        return f"(on {list(self.keys)})"


@dataclass(frozen=True)
class Concat(IR):
    left: IR
    right: IR

    @property
    def schema(self):
        return self.left.schema

    @property
    def children(self):
        return (self.left, self.right)

    def with_children(self, kids):
        return replace(self, left=kids[0], right=kids[1])

    def canonical(self) -> str:
        return f"concat({self.left.canonical()},{self.right.canonical()})"


@dataclass(frozen=True)
class ConcatAll(IR):
    """Fused multiway union (Sec. 4 'Multiple Concat'; RecStep's unified
    IDB evaluation)."""
    inputs: tuple[IR, ...]

    @property
    def schema(self):
        return self.inputs[0].schema

    @property
    def children(self):
        return self.inputs

    def with_children(self, kids):
        return replace(self, inputs=tuple(kids))

    def canonical(self) -> str:
        return f"concat_all({sorted(c.canonical() for c in self.inputs)})"


@dataclass(frozen=True)
class Distinct(IR):
    child: IR

    @property
    def schema(self):
        return self.child.schema

    @property
    def children(self):
        return (self.child,)

    def with_children(self, kids):
        return replace(self, child=kids[0])

    def canonical(self) -> str:
        return f"distinct({self.child.canonical()})"


@dataclass(frozen=True)
class Reduce(IR):
    """Grouped aggregation; ``aggs`` are (func, column) pairs appended after
    the group columns. Recursive aggregation is *not* expressed here — it is
    baked into the diff monoid (Sec. 9); Reduce is for stratified aggregates."""
    child: IR
    group: tuple[str, ...]
    aggs: tuple[tuple[str, str], ...]
    schema: tuple[ColumnRef, ...]

    @property
    def children(self):
        return (self.child,)

    def with_children(self, kids):
        return replace(self, child=kids[0])

    def canonical(self) -> str:
        g = [schema_index(self.child.schema, c) for c in self.group]
        a = [(f, schema_index(self.child.schema, c)) for f, c in self.aggs]
        return f"reduce({self.child.canonical()},{g},{a})"

    def _pretty_extra(self):
        return f"({list(self.group)}; {list(self.aggs)})"


@dataclass(frozen=True)
class SharedRef(IR):
    """Pointer to the output of a shared subplan (Sec. 7). ``schema`` gives
    this occurrence's variable names for the shared output's columns."""
    ref: str            # canonical hash of the shared subplan
    schema: tuple[ColumnRef, ...]

    @property
    def children(self):
        return ()

    def with_children(self, kids):
        return self

    def canonical(self) -> str:
        return f"ref({self.ref})"

    def _pretty_extra(self):
        return f"(0x{self.ref})"


# ---------------------------------------------------------------------------


def iter_nodes(node: IR):
    yield node
    for c in node.children:
        yield from iter_nodes(c)


def rewrite_bottom_up(node: IR, fn) -> IR:
    kids = tuple(rewrite_bottom_up(c, fn) for c in node.children)
    if kids != node.children:
        node = node.with_children(kids)
    return fn(node)


def retag_scans(node: IR, version_of) -> IR:
    """Clone IR with Scan versions replaced via ``version_of(rel, occurrence_idx)``.
    Occurrence indices count scans of the same relation left-to-right."""
    counts: dict[str, int] = {}

    def go(n: IR) -> IR:
        kids = tuple(go(c) for c in n.children)
        if kids != n.children:
            n = n.with_children(kids)
        if isinstance(n, Scan):
            idx = counts.get(n.rel, 0)
            counts[n.rel] = idx + 1
            v = version_of(n.rel, idx)
            if v is not None and v != n.version:
                n = replace(n, version=v)
        return n

    return go(node)


@dataclass(frozen=True)
class RulePlan:
    """Optimized IR for one rule (one delta-variant of it)."""
    head: str
    root: IR
    variant: int = 0          # which recursive atom is the delta (-1: nonrec)
    source: str = ""          # original rule text, for debugging


@dataclass
class StratumPlan:
    index: int
    idbs: frozenset[str]
    recursive: bool
    plans: list[RulePlan]
    # ground facts contributed by 0-body rules: head -> list of tuples
    facts: dict[str, list[tuple[int, ...]]] = field(default_factory=dict)


@dataclass
class CompiledProgram:
    strata: list[StratumPlan]
    arities: dict[str, int]
    edbs: set[str]
    outputs: set[str]
    shared: dict[str, IR] = field(default_factory=dict)  # hash -> subplan
    # aggregate IDBs evaluated under a value monoid (Sec. 9):
    # name -> (func, value column position in the head)
    monoid_idbs: dict[str, tuple] = field(default_factory=dict)

    def pretty(self) -> str:
        out = []
        for s in self.strata:
            out.append(f"=== Stratum {s.index} "
                       f"({'recursive' if s.recursive else 'flat'}) "
                       f"{sorted(s.idbs)} ===")
            for p in s.plans:
                out.append(f"-- {p.head} (variant {p.variant}) {p.source}")
                out.append(p.root.pretty(1))
        if self.shared:
            out.append("=== shared subplans ===")
            for h, sub in self.shared.items():
                out.append(f"-- 0x{h}")
                out.append(sub.pretty(1))
        return "\n".join(out)
