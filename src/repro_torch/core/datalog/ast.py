"""Datalog AST.

Follows the paper's grammar (Sec. 2.1): a program is a set of rules
``h :- p1, ..., pk.`` over EDB (input) and IDB (derived) atoms, with the
common extensions of Sec. 2.1: comparisons/constraints, stratified negation,
and (possibly recursive) aggregation expressed as head terms like
``two_hops(x, z, COUNT(y))``.

Terms are integers-only at runtime (the paper pre-hashes strings to ints,
Sec. 10 "Programs and Datasets"); the AST keeps symbolic variables.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Union

_wildcard_counter = itertools.count()


@dataclass(frozen=True)
class Var:
    name: str

    def __repr__(self) -> str:
        return self.name


@dataclass(frozen=True)
class Const:
    value: int

    def __repr__(self) -> str:
        return str(self.value)


def Wildcard() -> Var:
    """Fresh anonymous variable (an ``_`` in the source)."""
    return Var(f"__any{next(_wildcard_counter)}")


@dataclass(frozen=True)
class BinExpr:
    """Arithmetic term over body-bound variables, e.g. ``d + c`` in
    ``sssp(y, MIN(d + c)) :- sssp(x, d), edge(x, y, c).``"""
    op: str          # + - *
    lhs: "Term"
    rhs: "Term"

    def __post_init__(self):
        if self.op not in ("+", "-", "*"):
            raise ValueError(f"unknown arithmetic op {self.op}")

    @property
    def var_names(self) -> frozenset[str]:
        out: set[str] = set()
        for t in (self.lhs, self.rhs):
            if isinstance(t, Var):
                out.add(t.name)
            elif isinstance(t, BinExpr):
                out |= t.var_names
        return frozenset(out)

    def __repr__(self) -> str:
        return f"({self.lhs} {self.op} {self.rhs})"


Term = Union[Var, Const, "BinExpr"]

AGG_FUNCS = ("COUNT", "SUM", "MIN", "MAX")


@dataclass(frozen=True)
class Aggregate:
    """Aggregate head term, e.g. ``MIN(d)`` or ``MIN(d + c)``. ``COUNT``
    takes a var too (the counted variable) per the paper's
    ``two_hops(x,z,COUNT(y))``."""
    func: str
    var: Union[Var, BinExpr]

    def __post_init__(self):
        if self.func not in AGG_FUNCS:
            raise ValueError(f"unknown aggregate {self.func}")

    def __repr__(self) -> str:
        return f"{self.func}({self.var})"


HeadTerm = Union[Var, Const, Aggregate]


@dataclass(frozen=True)
class Atom:
    name: str
    args: tuple[Term, ...]
    negated: bool = False

    @property
    def vars(self) -> tuple[Var, ...]:
        seen, out = set(), []
        for a in self.args:
            if isinstance(a, Var) and a.name not in seen:
                seen.add(a.name)
                out.append(a)
        return tuple(out)

    @property
    def var_names(self) -> frozenset[str]:
        return frozenset(a.name for a in self.args if isinstance(a, Var))

    def __repr__(self) -> str:
        inner = ", ".join(map(repr, self.args))
        return f"{'!' if self.negated else ''}{self.name}({inner})"


COMPARISON_OPS = ("=", "!=", "<", "<=", ">", ">=")


@dataclass(frozen=True)
class Comparison:
    op: str
    lhs: Term
    rhs: Term

    def __post_init__(self):
        if self.op not in COMPARISON_OPS:
            raise ValueError(f"unknown comparison op {self.op}")

    @property
    def var_names(self) -> frozenset[str]:
        return frozenset(
            t.name for t in (self.lhs, self.rhs) if isinstance(t, Var))

    def __repr__(self) -> str:
        return f"{self.lhs} {self.op} {self.rhs}"


@dataclass(frozen=True)
class Rule:
    head_name: str
    head_terms: tuple[HeadTerm, ...]
    body: tuple[Atom, ...]
    comparisons: tuple[Comparison, ...] = ()

    @property
    def positive_body(self) -> tuple[Atom, ...]:
        return tuple(a for a in self.body if not a.negated)

    @property
    def negative_body(self) -> tuple[Atom, ...]:
        return tuple(a for a in self.body if a.negated)

    @property
    def head_vars(self) -> tuple[Var, ...]:
        out, seen = [], set()
        for t in self.head_terms:
            t = t.var if isinstance(t, Aggregate) else t
            if isinstance(t, Var):
                names = [t.name]
            elif isinstance(t, BinExpr):
                names = sorted(t.var_names)
            else:
                names = []
            for n in names:
                if n not in seen:
                    seen.add(n)
                    out.append(Var(n))
        return tuple(out)

    @property
    def group_vars(self) -> tuple[Var, ...]:
        """Head vars excluding aggregated ones (the GROUP BY key)."""
        out, seen = [], set()
        for t in self.head_terms:
            if isinstance(t, Var) and t.name not in seen:
                seen.add(t.name)
                out.append(t)
        return tuple(out)

    @property
    def aggregates(self) -> tuple[Aggregate, ...]:
        return tuple(t for t in self.head_terms if isinstance(t, Aggregate))

    @property
    def has_aggregate(self) -> bool:
        return any(isinstance(t, Aggregate) for t in self.head_terms)

    @property
    def body_var_names(self) -> frozenset[str]:
        s: set[str] = set()
        for a in self.body:
            s |= a.var_names
        return frozenset(s)

    def validate(self) -> None:
        """Range restriction + safety checks."""
        pos_vars: set[str] = set()
        for a in self.positive_body:
            pos_vars |= a.var_names
        for v in self.head_vars:
            if v.name not in pos_vars:
                raise ValueError(
                    f"unsafe rule: head var {v} not bound in positive body "
                    f"of {self}")
        for a in self.negative_body:
            if not a.var_names <= pos_vars:
                raise ValueError(
                    f"unsafe negation: {a} has vars unbound in positive body")
        for c in self.comparisons:
            if not c.var_names <= pos_vars:
                raise ValueError(
                    f"unsafe comparison: {c} has vars unbound in positive body")

    def __repr__(self) -> str:
        h = f"{self.head_name}({', '.join(map(repr, self.head_terms))})"
        parts = list(map(repr, self.body)) + list(map(repr, self.comparisons))
        return f"{h} :- {', '.join(parts)}."


@dataclass
class Program:
    rules: list[Rule] = field(default_factory=list)
    declarations: dict[str, int] = field(default_factory=dict)  # name -> arity
    inputs: set[str] = field(default_factory=set)    # EDB names
    outputs: set[str] = field(default_factory=set)

    @property
    def idbs(self) -> set[str]:
        return {r.head_name for r in self.rules}

    @property
    def edbs(self) -> set[str]:
        names: set[str] = set()
        for r in self.rules:
            for a in r.body:
                names.add(a.name)
        return (names | self.inputs) - self.idbs

    def arity_of(self, name: str) -> int:
        if name in self.declarations:
            return self.declarations[name]
        for r in self.rules:
            if r.head_name == name:
                return len(r.head_terms)
            for a in r.body:
                if a.name == name:
                    return len(a.args)
        raise KeyError(name)

    def validate(self) -> None:
        for r in self.rules:
            r.validate()
            if r.head_name in self.inputs:
                raise ValueError(f"EDB {r.head_name} cannot be a rule head")
        # arity consistency
        arities: dict[str, int] = dict(self.declarations)
        def _check(name: str, n: int) -> None:
            if name in arities and arities[name] != n:
                raise ValueError(
                    f"arity mismatch for {name}: {arities[name]} vs {n}")
            arities[name] = n
        for r in self.rules:
            _check(r.head_name, len(r.head_terms))
            for a in r.body:
                _check(a.name, len(a.args))

    def __repr__(self) -> str:
        return "\n".join(map(repr, self.rules))


def fresh_vars(prefix: str, n: int) -> tuple[Var, ...]:
    return tuple(Var(f"{prefix}{i}") for i in range(n))
