"""Static analysis over the relational IR — the one place the full IR
invariant contract is stated (paper Secs. 3-7).

Every ``CompiledProgram`` the optimizer pipeline emits is expected to
satisfy the following invariants, and ``verify.verify_program`` /
``verify.verify_ir`` check all of them after **each** optimizer pass
(sip -> joingraph planning -> fusion -> sharing), so a pass that emits
malformed IR is named in the diagnostic instead of being discovered as
a wrong fixpoint:

IR invariant contract
=====================

1. **ColumnRef resolution.** Every ``str`` column reference at every
   node — Map/FlatMap schemas, Filter/FlatMap/JoinFlatMap comparisons,
   Join/Semijoin/Antijoin keys, Reduce group and aggregate columns,
   Expr operands — resolves by name into the schema of the node's
   input(s) (``ir.schema_names``). Int refs are constant columns and
   always resolve.
2. **Arity consistency.** A ``Scan``'s schema width equals the declared
   arity of the scanned relation; ``Concat``/``ConcatAll`` inputs all
   share one arity; a ``Reduce`` schema has exactly
   ``len(group) + len(aggs)`` columns; every rule root's schema width
   equals the declared arity of its head.
3. **Scan versions.** Every ``Scan.version`` is one of the semi-naive
   tags (FULL / DELTA / FULL_OLD / FULL_NEW) or the incremental
   maintenance tag (``incremental.CHANGED``); DELTA / FULL_OLD /
   FULL_NEW scans only ever reference IDBs of the scan's own stratum
   (lower-stratum and EDB references are FULL by construction).
4. **SharedRef discipline** (Sec. 7). Every ``SharedRef.ref`` resolves
   to exactly one definition in ``CompiledProgram.shared``; no two
   definitions are structurally identical after expansion (a duplicate
   definition would silently double evaluation); the reference graph
   over shared definitions is acyclic; and each occurrence's schema
   width equals its definition's output width.
5. **Stratified negation** (Sec. 2). No IDB of stratum *k* is scanned —
   directly or through a SharedRef — under the right (negated) subtree
   of an ``Antijoin`` inside stratum *k*'s own plans. Negation only
   ever sees fully-computed lower strata.
6. **Reduce well-formedness.** Group keys and aggregate input columns
   name columns of the child schema, and group columns reappear in the
   output schema.
7. **Stored-arity ceiling.** Every stored head arity (head arity minus
   one for monoid IDBs, whose lattice value lives out-of-row) is
   ``<= engine.relation.MAX_STORED_COLUMNS`` — the multi-word row-key
   capability ceiling the semi-naive merge relies on.

The *runtime* counterpart — the arrangement contract of
``repro/engine/relation.py`` (rows ``[0, n)`` live, sorted
lexicographically by the sort-order witness, duplicate-free; rows
``[n, cap)`` all-PAD with identity payload; every ``ShardedRelation``
block a valid arrangement homed by full-row hash) — is validated
against actual device data by ``sanitize`` when
``EngineConfig.check_invariants`` is set, at stratum boundaries in
``engine.py`` / ``shard.py`` and after incremental ``apply()``.

``bounds`` is the third layer: worst-case cardinality analysis
(AGM-style fractional covers on cyclic join subtrees, distinctness-
aware key bounds on tree-shaped ones) producing the per-rule
blow-up-risk report the robustness benchmark pins.

CLI (reference package only): ``python -m repro.analysis`` compiles a program
or the shared benchmark corpus, prints the verifier report and
per-rule bounds, and exits nonzero on violations.
"""
from repro_torch.core.analysis.verify import (  # noqa: F401
    Diagnostic, VerificationError, verify_ir, verify_program,
)
from repro_torch.core.analysis.bounds import (  # noqa: F401
    ProgramBoundReport, RuleBoundReport, analyze_program,
)
from repro_torch.core.analysis.sanitize import (  # noqa: F401
    SanitizerError, check_relation, check_sharded, sanitize_env,
)
