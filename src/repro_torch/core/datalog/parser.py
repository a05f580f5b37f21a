"""Parser for the Soufflé-style surface grammar used by the paper.

Supported subset (Sec. 2-3 of the paper, Soufflé conventions):

    // line comment
    .decl edge(x: number, y: number)
    .input edge
    .output reach
    reach(x) :- target(x).
    reach(x) :- edge(x, y), edge(y, z), reach(z), x != z, !blocked(x).
    two_hops(x, z, COUNT(y)) :- edge(x, y), edge(y, z).
    cc(x, MIN(i)) :- edge(y, x), cc(y, i).
    fact(1, 2).                      // ground fact (constant-only head)

Identifiers starting with lowercase/uppercase both allowed; `_` is a
wildcard; integer literals are constants. Negation is `!atom(...)`.
"""
from __future__ import annotations

import re
from typing import Iterator

from repro_torch.core.datalog.ast import (
    AGG_FUNCS, Aggregate, Atom, BinExpr, Comparison, Const, Program, Rule,
    Term, Var, Wildcard,
)

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|//[^\n]*|\#[^\n]*)
  | (?P<decl>\.\w+)
  | (?P<num>-?\d+)
  | (?P<id>[A-Za-z_][A-Za-z0-9_?]*)
  | (?P<op><=|>=|!=|:-|<|>|=|!|\(|\)|,|\.|:|\+|-|\*)
    """,
    re.VERBOSE,
)


def _tokenize(src: str) -> Iterator[tuple[str, str]]:
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise SyntaxError(f"unexpected character {src[pos]!r} at {pos}")
        pos = m.end()
        kind = m.lastgroup
        if kind != "ws":
            yield kind, m.group()
    yield "eof", ""


class _Parser:
    def __init__(self, src: str):
        self.toks = list(_tokenize(src))
        self.i = 0

    def peek(self) -> tuple[str, str]:
        return self.toks[self.i]

    def next(self) -> tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, value: str) -> None:
        kind, v = self.next()
        if v != value:
            raise SyntaxError(f"expected {value!r}, got {v!r}")

    # -- grammar -----------------------------------------------------------
    def parse_program(self) -> Program:
        prog = Program()
        while self.peek()[0] != "eof":
            kind, v = self.peek()
            if kind == "decl":
                self._parse_directive(prog)
            else:
                self._parse_rule_or_fact(prog)
        prog.validate()
        return prog

    def _parse_directive(self, prog: Program) -> None:
        _, d = self.next()
        if d == ".decl":
            _, name = self.next()
            self.expect("(")
            arity = 0
            while self.peek()[1] != ")":
                _, _attr = self.next()          # attr name
                if self.peek()[1] == ":":       # optional `: type`
                    self.next()
                    self.next()
                arity += 1
                if self.peek()[1] == ",":
                    self.next()
            self.expect(")")
            prog.declarations[name] = arity
        elif d in (".input", ".output"):
            _, name = self.next()
            (prog.inputs if d == ".input" else prog.outputs).add(name)
            # ignore optional Soufflé IO qualifiers up to end-of-line-ish
            while self.peek()[1] == "(":  # e.g. .input edge(IO=file)
                depth = 0
                while True:
                    _, v = self.next()
                    depth += v == "("
                    depth -= v == ")"
                    if depth == 0:
                        break
        else:
            raise SyntaxError(f"unknown directive {d}")

    def _parse_term(self) -> Term:
        kind, v = self.next()
        if kind == "num":
            return Const(int(v))
        if kind == "id":
            return Wildcard() if v == "_" else Var(v)
        raise SyntaxError(f"expected term, got {v!r}")

    def _parse_arith(self) -> Term:
        """term (('+'|'-'|'*') term)* — left-associative, no precedence
        (parenthesised nesting unsupported; fine for MIN(d + c) style)."""
        t = self._parse_term()
        while self.peek()[1] in ("+", "-", "*"):
            _, op = self.next()
            rhs = self._parse_term()
            t = BinExpr(op, t, rhs)
        return t

    def _parse_head_term(self):
        kind, v = self.peek()
        if kind == "id" and v in AGG_FUNCS:
            self.next()
            self.expect("(")
            inner = self._parse_arith()
            self.expect(")")
            if not isinstance(inner, (Var, BinExpr, Const)):
                raise SyntaxError("aggregate argument must be a variable, "
                                  "constant, or arithmetic expression")
            return Aggregate(v, inner)
        return self._parse_arith()

    def _parse_atom(self, negated: bool = False) -> Atom:
        _, name = self.next()
        self.expect("(")
        args: list[Term] = []
        while self.peek()[1] != ")":
            args.append(self._parse_term())
            if self.peek()[1] == ",":
                self.next()
        self.expect(")")
        return Atom(name, tuple(args), negated=negated)

    def _parse_rule_or_fact(self, prog: Program) -> None:
        _, name = self.next()
        self.expect("(")
        head_terms = []
        while self.peek()[1] != ")":
            self.i -= 0
            head_terms.append(self._parse_head_term())
            if self.peek()[1] == ",":
                self.next()
        self.expect(")")
        kind, v = self.peek()
        if v == ".":                               # ground fact
            self.next()
            rule = Rule(name, tuple(head_terms), body=())
            prog.rules.append(rule)
            return
        self.expect(":-")
        body: list[Atom] = []
        comparisons: list[Comparison] = []
        while True:
            kind, v = self.peek()
            if v == "!":
                self.next()
                body.append(self._parse_atom(negated=True))
            elif kind in ("id", "num"):
                # lookahead: atom `name(` vs comparison `term op term`
                save = self.i
                t = self._parse_term()
                nxt = self.peek()[1]
                if nxt == "(" and isinstance(t, Var):
                    self.i = save
                    body.append(self._parse_atom())
                else:
                    op_kind, op = self.next()
                    if op not in ("=", "!=", "<", "<=", ">", ">="):
                        raise SyntaxError(f"expected comparison op, got {op!r}")
                    rhs = self._parse_term()
                    comparisons.append(Comparison(op, t, rhs))
            elif v == "true":
                self.next()
            else:
                raise SyntaxError(f"unexpected token {v!r} in rule body")
            kind, v = self.peek()
            if v == ",":
                self.next()
                continue
            self.expect(".")
            break
        prog.rules.append(
            Rule(name, tuple(head_terms), tuple(body), tuple(comparisons)))


def parse_program(src: str) -> Program:
    return _Parser(src).parse_program()


def parse_rule(src: str) -> Rule:
    prog = Program()
    p = _Parser(src)
    p._parse_rule_or_fact(prog)
    return prog.rules[0]
