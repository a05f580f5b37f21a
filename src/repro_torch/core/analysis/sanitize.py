"""Runtime arrangement sanitizer — validates the ``engine/relation.py``
arrangement contract against *actual device data*.

The sort-order witness machinery (``Relation.order``) is pure trust at
run time: ``relops.arrange`` skips the sort whenever a witness claims
the rows are already arranged, so a wrong witness silently corrupts
every downstream merge/probe. Behind ``EngineConfig.check_invariants``
the engines call ``sanitize_env`` at stratum boundaries (and after
incremental ``apply``), pulling each stored relation to the host and
checking:

* ``0 <= n <= capacity``;
* the PAD tail: rows ``[n, cap)`` are all-PAD in every column, and the
  value tail equals the semiring identity;
* sortedness: live rows, permuted by the witness (``sort_prefix()``),
  are strictly lexicographically increasing — witnesses are full
  column permutations, so strictness gives distinctness for free;
* distinctness for ``UNSORTED`` relations via ``np.unique``;
* shard homing: every live row of a ``ShardedRelation`` block lives on
  the shard its full-row FNV-1a hash selects, and every block is a
  valid single-device arrangement on its own.

Violations raise ``SanitizerError`` naming the engine layer
("engine" / "shard" / "incremental"), the stratum boundary, and the
relation — so a corrupted arrangement is caught where it was produced,
not where the next merge consumes it.

Imports of the engine modules are function-local: ``engine.py`` and
``shard.py`` call into this module, so top-level imports would cycle.
"""
from __future__ import annotations

import numpy as np


class SanitizerError(AssertionError):
    """An arrangement invariant does not hold on device data."""


_FNV_OFFSET = np.uint64(14695981039346656037)
_FNV_PRIME = np.uint64(1099511628211)


def _host_row_hash(rows: np.ndarray) -> np.ndarray:
    """Host mirror of ``shard._row_hash`` over all columns (uint64
    FNV-1a; int32 values are widened exactly like jax's astype)."""
    with np.errstate(over="ignore"):
        h = np.full((rows.shape[0],), _FNV_OFFSET, np.uint64)
        for c in range(rows.shape[1]):
            h = (h ^ rows[:, c].astype(np.int64).astype(np.uint64)) \
                * _FNV_PRIME
    return h


def check_relation(rel, name: str = "?", where: str = "",
                   val_identity=None) -> list[str]:
    """All arrangement-contract violations of one Relation (empty list
    = clean). Pulls ``data``/``val``/``n`` to the host."""
    from repro_torch.engine.relation import PAD, UNSORTED

    out: list[str] = []
    loc = f"{name}{f' @ {where}' if where else ''}"
    data = np.asarray(rel.data)
    cap, arity = data.shape
    n = int(rel.n)
    if not (0 <= n <= cap):
        out.append(f"{loc}: live count n={n} outside [0, cap={cap}]")
        return out  # nothing else is well-defined

    tail = data[n:]
    if tail.size and not np.all(tail == int(PAD)):
        bad = int(np.argmax(~np.all(tail == int(PAD), axis=1)))
        out.append(
            f"{loc}: PAD-tail violated — row {n + bad} (of cap {cap}) "
            f"is {tail[bad].tolist()}, expected all-PAD")
    if rel.val is not None and val_identity is not None:
        vtail = np.asarray(rel.val)[n:]
        if vtail.size and not np.all(vtail == val_identity):
            out.append(
                f"{loc}: value tail not at semiring identity "
                f"{val_identity} past n={n}")

    live = data[:n].astype(np.int64)
    order = rel.order
    if order is not None and tuple(order) == UNSORTED:
        if n:
            uniq = np.unique(live, axis=0)
            if uniq.shape[0] != n:
                out.append(
                    f"{loc}: {n - uniq.shape[0]} duplicate row(s) "
                    f"(UNSORTED relations must still be distinct)")
        return out

    perm = rel.sort_prefix()
    if sorted(perm) != list(range(arity)):
        # partial witness: check non-strict order on witness columns,
        # distinctness on full rows
        cols = [c for c in perm if 0 <= c < arity]
        view = live[:, cols]
        if n > 1:
            prev, cur = view[:-1], view[1:]
            if not _lex_le(prev, cur).all():
                i = int(np.argmax(~_lex_le(prev, cur)))
                out.append(
                    f"{loc}: sort witness order={order} violated at "
                    f"rows {i},{i + 1}: {view[i].tolist()} > "
                    f"{view[i + 1].tolist()}")
            if np.unique(live, axis=0).shape[0] != n:
                out.append(f"{loc}: duplicate rows under partial "
                           f"witness {order}")
        return out

    view = live[:, list(perm)]
    if n > 1:
        prev, cur = view[:-1], view[1:]
        lt = _lex_lt(prev, cur)
        if not lt.all():
            i = int(np.argmax(~lt))
            kind = ("duplicate" if (prev[i] == cur[i]).all()
                    else "mis-sorted")
            out.append(
                f"{loc}: {kind} rows {i},{i + 1} under witness "
                f"order={order}: {view[i].tolist()} !< "
                f"{view[i + 1].tolist()}")
    return out


def _lex_lt(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise strict lexicographic a < b."""
    lt = np.zeros(a.shape[0], bool)
    eq = np.ones(a.shape[0], bool)
    for c in range(a.shape[1]):
        lt |= eq & (a[:, c] < b[:, c])
        eq &= a[:, c] == b[:, c]
    return lt


def _lex_le(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return _lex_lt(a, b) | np.all(a == b, axis=1)


def check_sharded(srel, name: str = "?", where: str = "",
                  val_identity=None) -> list[str]:
    """Violations of a ShardedRelation: every block a valid arrangement
    plus full-row-hash homing of each live row on its block."""
    from repro_torch.engine.relation import Relation

    out: list[str] = []
    shards = srel.num_shards
    for s in range(shards):
        block = Relation(
            srel.data[s],
            srel.val[s] if srel.val is not None else None,
            srel.n[s])
        out += check_relation(block, f"{name}[shard {s}/{shards}]",
                              where, val_identity)
        n = int(srel.n[s])
        if n:
            rows = np.asarray(srel.data[s][:n])
            dest = (_host_row_hash(rows) >> np.uint64(33)) \
                % np.uint64(shards)
            stray = dest != s
            if stray.any():
                i = int(np.argmax(stray))
                out.append(
                    f"{name}[shard {s}/{shards}]"
                    f"{f' @ {where}' if where else ''}: row "
                    f"{rows[i].tolist()} homed to shard {int(dest[i])} "
                    f"but stored on shard {s}")
    return out


def sanitize_env(engine, env: dict, where: str, layer: str) -> None:
    """Check every stored relation of an engine environment; raise
    ``SanitizerError`` naming the layer and boundary on violation.

    ``engine`` supplies per-relation semiring identities via
    ``_sr_of`` (duck-typed; absent => tails unchecked)."""
    violations: list[str] = []
    for key, rel in env.items():
        # engine environments key stored relations as (name, version)
        if isinstance(key, tuple):
            name = key[0]
            label = name if key[1] == "full" else f"{name}[{key[1]}]"
        else:
            name = label = key
        ident = None
        sr = engine._sr_of(name) if hasattr(engine, "_sr_of") else None
        if sr is not None and getattr(sr, "has_value", False):
            ident = sr.identity
        if hasattr(rel, "num_shards"):
            violations += check_sharded(rel, label, where, ident)
        else:
            violations += check_relation(rel, label, where, ident)
    if violations:
        lines = [f"arrangement sanitizer failed in layer '{layer}' "
                 f"at {where} ({len(violations)} violation(s)):"]
        lines += [f"  - {v}" for v in violations]
        raise SanitizerError("\n".join(lines))
