"""IR verifier — structural invariant checks over rule IRs and whole
``CompiledProgram``s (the contract in ``core/analysis/__init__``).

Two entry points:

* ``verify_ir(root, ...)`` — per-tree checks (ColumnRef resolution,
  arity consistency, scan versions, Reduce well-formedness, SharedRef
  arity against a definition table). Called by the pipeline after each
  per-rule pass (sip, planning, fusion) with the pass named in the
  diagnostic.
* ``verify_program(compiled, ...)`` — whole-program checks on top of
  per-tree ones: SharedRef single-definition / acyclicity,
  negation-in-stratum safety, head arities, the stored-arity ceiling.
  Called after subplan sharing (the last pass) and by the CLI.

Both return a list of ``Diagnostic``s; the ``*_or_raise`` variants wrap
them in ``VerificationError`` whose message names the offending pass —
"discovered by the verifier after pass X", never "discovered as a
wrong fixpoint".
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core import ir as I

# accepted Scan versions: the four semi-naive tags plus the incremental
# maintenance retag (engine/incremental.py CHANGED)
_SCAN_VERSIONS = (I.FULL, I.DELTA, I.FULL_OLD, I.FULL_NEW, "changed")


@dataclass(frozen=True)
class Diagnostic:
    """One verifier finding. ``check`` is a stable kebab-case slug
    (tests assert on it); ``pass_name`` names the optimizer pass after
    which the check ran; ``where`` locates the rule / shared subplan."""
    check: str
    where: str
    message: str
    pass_name: str = ""

    def __str__(self) -> str:
        p = f" [after pass {self.pass_name}]" if self.pass_name else ""
        return f"{self.check}{p} at {self.where}: {self.message}"


class VerificationError(ValueError):
    """Raised when IR verification fails; carries the diagnostics."""

    def __init__(self, diagnostics: list[Diagnostic]):
        self.diagnostics = list(diagnostics)
        lines = [f"IR verification failed "
                 f"({len(self.diagnostics)} violation(s)):"]
        lines += [f"  - {d}" for d in self.diagnostics]
        super().__init__("\n".join(lines))


def _names(schema) -> set[str]:
    """Referenceable column names of a schema (vars + named Exprs)."""
    return {n for n in I.schema_names(schema) if n is not None}


def _ref_names(ref) -> set[str]:
    """All str names a ColumnRef reads."""
    if isinstance(ref, str):
        return {ref}
    if isinstance(ref, I.Expr):
        return _ref_names(ref.lhs) | _ref_names(ref.rhs)
    return set()


def _check_refs(refs, avail: set[str], node, what: str, where: str,
                pass_name: str, out: list[Diagnostic]) -> None:
    for ref in refs:
        missing = _ref_names(ref) - avail
        if missing:
            out.append(Diagnostic(
                "columnref-resolution", where,
                f"{type(node).__name__} {what} references "
                f"{sorted(missing)} not in input schema "
                f"{sorted(avail)}", pass_name))


def verify_ir(root: I.IR, *, arities: dict[str, int] | None = None,
              shared: dict[str, I.IR] | None = None,
              where: str = "<ir>", pass_name: str = "",
              ) -> list[Diagnostic]:
    """Per-tree structural checks; returns diagnostics (empty = clean).

    ``arities`` (optional) enables the Scan-arity check; ``shared``
    (optional) enables SharedRef resolution/arity checks and recursion
    into definitions (each definition verified once)."""
    out: list[Diagnostic] = []
    seen_defs: set[str] = set()

    def visit(node: I.IR, loc: str) -> None:
        if isinstance(node, I.Scan):
            if node.version not in _SCAN_VERSIONS:
                out.append(Diagnostic(
                    "scan-version", loc,
                    f"Scan({node.rel}) has unknown version "
                    f"{node.version!r}", pass_name))
            if arities is not None and node.rel in arities:
                want = max(arities[node.rel], 1)
                if len(node.schema) != want:
                    out.append(Diagnostic(
                        "arity-consistency", loc,
                        f"Scan({node.rel}) has {len(node.schema)} "
                        f"columns but {node.rel} is declared with "
                        f"arity {want}", pass_name))
        elif isinstance(node, (I.Map, I.FlatMap)):
            avail = _names(node.child.schema)
            _check_refs(node.schema, avail, node, "schema", loc,
                        pass_name, out)
            if isinstance(node, I.FlatMap):
                for c in node.comparisons:
                    _check_refs((c.lhs, c.rhs), avail, node,
                                f"comparison {c}", loc, pass_name, out)
        elif isinstance(node, I.Filter):
            avail = _names(node.child.schema)
            for c in node.comparisons:
                _check_refs((c.lhs, c.rhs), avail, node,
                            f"comparison {c}", loc, pass_name, out)
        elif isinstance(node, I.Join):
            lnames = _names(node.left.schema)
            rnames = _names(node.right.schema)
            for k in node.keys:
                for side, names in (("left", lnames), ("right", rnames)):
                    if k not in names:
                        out.append(Diagnostic(
                            "columnref-resolution", loc,
                            f"Join key {k!r} missing from {side} "
                            f"schema {sorted(names)}", pass_name))
            _check_refs(node.schema, lnames | rnames, node, "schema",
                        loc, pass_name, out)
        elif isinstance(node, I.JoinFlatMap):
            lnames = _names(node.left.schema)
            rnames = _names(node.right.schema)
            for k in node.keys:
                for side, names in (("left", lnames), ("right", rnames)):
                    if k not in names:
                        out.append(Diagnostic(
                            "columnref-resolution", loc,
                            f"JoinFlatMap key {k!r} missing from "
                            f"{side} schema {sorted(names)}", pass_name))
            avail = lnames | rnames
            _check_refs(node.schema, avail, node, "schema", loc,
                        pass_name, out)
            for c in node.comparisons:
                _check_refs((c.lhs, c.rhs), avail, node,
                            f"comparison {c}", loc, pass_name, out)
        elif isinstance(node, (I.Semijoin, I.Antijoin)):
            lnames = _names(node.left.schema)
            rnames = _names(node.right.schema)
            for k in node.keys:
                for side, names in (("left", lnames), ("right", rnames)):
                    if k not in names:
                        out.append(Diagnostic(
                            "columnref-resolution", loc,
                            f"{type(node).__name__} key {k!r} missing "
                            f"from {side} schema {sorted(names)}",
                            pass_name))
        elif isinstance(node, (I.Concat, I.ConcatAll)):
            widths = {len(c.schema) for c in node.children}
            if len(widths) > 1:
                out.append(Diagnostic(
                    "arity-consistency", loc,
                    f"{type(node).__name__} inputs disagree on arity: "
                    f"{sorted(widths)}", pass_name))
        elif isinstance(node, I.Reduce):
            avail = _names(node.child.schema)
            for g in node.group:
                if g not in avail:
                    out.append(Diagnostic(
                        "reduce-group-key", loc,
                        f"Reduce group key {g!r} not in child schema "
                        f"{sorted(avail)}", pass_name))
            for func, col in node.aggs:
                if col not in avail:
                    out.append(Diagnostic(
                        "reduce-group-key", loc,
                        f"Reduce {func} input column {col!r} not in "
                        f"child schema {sorted(avail)}", pass_name))
            if len(node.schema) != len(node.group) + len(node.aggs):
                out.append(Diagnostic(
                    "arity-consistency", loc,
                    f"Reduce schema has {len(node.schema)} columns, "
                    f"expected {len(node.group)} group + "
                    f"{len(node.aggs)} aggregate", pass_name))
        elif isinstance(node, I.SharedRef):
            if shared is not None:
                sub = shared.get(node.ref)
                if sub is None:
                    out.append(Diagnostic(
                        "sharedref-dangling", loc,
                        f"SharedRef(0x{node.ref}) has no definition in "
                        f"the shared table", pass_name))
                else:
                    if len(node.schema) != len(sub.schema):
                        out.append(Diagnostic(
                            "sharedref-arity", loc,
                            f"SharedRef(0x{node.ref}) exposes "
                            f"{len(node.schema)} columns but its "
                            f"definition emits {len(sub.schema)}",
                            pass_name))
                    if node.ref not in seen_defs:
                        seen_defs.add(node.ref)
                        visit(sub, f"shared 0x{node.ref} (from {loc})")
        for c in node.children:
            visit(c, loc)

    visit(root, where)
    return out


def verify_ir_or_raise(root: I.IR, **kw) -> None:
    diags = verify_ir(root, **kw)
    if diags:
        raise VerificationError(diags)


# -- whole-program checks ----------------------------------------------------

def _shared_cycles(shared: dict[str, I.IR],
                   pass_name: str) -> list[Diagnostic]:
    """Detect reference cycles among shared definitions (DFS with a
    visiting stack)."""
    out: list[Diagnostic] = []
    state: dict[str, int] = {}   # 0 = visiting, 1 = done

    def refs_of(node: I.IR):
        for n in I.iter_nodes(node):
            if isinstance(n, I.SharedRef):
                yield n.ref

    def dfs(h: str, path: tuple[str, ...]) -> None:
        if state.get(h) == 1:
            return
        if state.get(h) == 0:
            cyc = path[path.index(h):] + (h,)
            out.append(Diagnostic(
                "sharedref-cycle", f"shared 0x{h}",
                "SharedRef definitions form a cycle: "
                + " -> ".join(f"0x{x}" for x in cyc), pass_name))
            return
        state[h] = 0
        for r in refs_of(shared.get(h, I.SharedRef(h, ()))):
            if r in shared:
                dfs(r, path + (h,))
        state[h] = 1

    for h in shared:
        dfs(h, ())
    return out


def _expanded_canonical(node: I.IR, shared: dict[str, I.IR],
                        memo: dict[str, str],
                        stack: frozenset = frozenset()) -> str:
    """Canonical string with SharedRefs expanded to their definitions
    (cycle-tolerant: a back-reference renders as ref(h))."""
    if isinstance(node, I.SharedRef):
        if node.ref in stack or node.ref not in shared:
            return f"ref({node.ref})"
        if node.ref not in memo:
            memo[node.ref] = _expanded_canonical(
                shared[node.ref], shared, memo, stack | {node.ref})
        return memo[node.ref]
    kids = [_expanded_canonical(c, shared, memo, stack)
            for c in node.children]
    # splice expanded children into the node's own canonical encoding:
    # re-derive the node-local encoding with child canonicals replaced
    try:
        own = node.canonical()
    except Exception:  # malformed node: fall back to repr
        return repr(node)
    for c, k in zip(node.children, kids):
        try:
            own = own.replace(c.canonical(), k)
        except Exception:
            pass
    return own


def verify_program(compiled: I.CompiledProgram, *, pass_name: str = "",
                   ) -> list[Diagnostic]:
    """Whole-program verification (contract items 1-7 of
    ``core/analysis/__init__``)."""
    from repro_torch.engine.relation import MAX_STORED_COLUMNS

    out: list[Diagnostic] = []
    shared = compiled.shared

    # dedicated cycle check first — the per-tree recursion below guards
    # itself with seen-sets but reports nothing for cycles
    out += _shared_cycles(shared, pass_name)
    cyclic = any(d.check == "sharedref-cycle" for d in out)

    # duplicate definitions: two hashes whose expanded canonical forms
    # coincide would evaluate the same subplan twice per iteration
    if not cyclic:
        memo: dict[str, str] = {}
        by_canon: dict[str, list[str]] = {}
        for h, sub in shared.items():
            by_canon.setdefault(
                _expanded_canonical(sub, shared, memo), []).append(h)
        for canon, hs in by_canon.items():
            if len(hs) > 1:
                out.append(Diagnostic(
                    "sharedref-duplicate-def",
                    "shared table",
                    "structurally identical subplan defined under "
                    + " and ".join(f"0x{h}" for h in sorted(hs)),
                    pass_name))

    for sp in compiled.strata:
        for p in sp.plans:
            loc = (f"stratum {sp.index} rule {p.head}"
                   f"[variant {p.variant}] {p.source}")
            out += verify_ir(p.root, arities=compiled.arities,
                             shared=shared, where=loc,
                             pass_name=pass_name)

            # head arity: the rule root must emit exactly the declared
            # head width (monoid value columns ride in-row at IR level)
            declared = max(compiled.arities.get(p.head, 1), 1)
            if len(p.root.schema) != declared:
                out.append(Diagnostic(
                    "head-arity", loc,
                    f"rule root emits {len(p.root.schema)} columns but "
                    f"head {p.head} is declared with arity {declared}",
                    pass_name))

            # stratified negation: nothing of this stratum may be
            # scanned under an Antijoin's negated side
            neg = _negated_scans(p.root, shared)
            bad = neg & set(sp.idbs)
            if bad:
                out.append(Diagnostic(
                    "negation-in-stratum", loc,
                    f"IDB(s) {sorted(bad)} of stratum {sp.index} are "
                    f"scanned under an Antijoin right subtree within "
                    f"their own stratum (unstratified negation)",
                    pass_name))

    # stored-arity ceiling (monoid IDBs store the value out-of-row)
    for name, arity in compiled.arities.items():
        if name in compiled.edbs:
            continue
        stored = arity - (1 if name in compiled.monoid_idbs else 0)
        if stored > MAX_STORED_COLUMNS:
            out.append(Diagnostic(
                "stored-arity", f"IDB {name}",
                f"stores {stored} head columns, above the engine's "
                f"multi-word row-key ceiling "
                f"relation.MAX_STORED_COLUMNS={MAX_STORED_COLUMNS}",
                pass_name))
    return out


def _negated_scans(root: I.IR, shared: dict[str, I.IR],
                   _stack: frozenset = frozenset()) -> set[str]:
    """Relations scanned under any Antijoin's right subtree, expanding
    SharedRefs (cycle-tolerant mirror of
    ``IncrementalEngine._negated_scans``)."""

    def scans_under(node, stack) -> set[str]:
        s: set[str] = set()
        for m in I.iter_nodes(node):
            if isinstance(m, I.Scan):
                s.add(m.rel)
            elif isinstance(m, I.SharedRef):
                if m.ref in shared and m.ref not in stack:
                    s |= scans_under(shared[m.ref], stack | {m.ref})
        return s

    out: set[str] = set()
    for n in I.iter_nodes(root):
        if isinstance(n, I.Antijoin):
            out |= scans_under(n.right, _stack)
        elif isinstance(n, I.SharedRef):
            if n.ref in shared and n.ref not in _stack:
                out |= _negated_scans(shared[n.ref], shared,
                                      _stack | {n.ref})
    return out


def verify_program_or_raise(compiled: I.CompiledProgram,
                            pass_name: str = "") -> None:
    diags = verify_program(compiled, pass_name=pass_name)
    if diags:
        raise VerificationError(diags)
