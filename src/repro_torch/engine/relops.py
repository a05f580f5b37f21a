"""Physical relational operators in torch — the differential-operator
layer, the counterpart of ``repro.engine.relops``.

Every op consumes/produces the sorted, distinct, fixed-capacity
``Relation`` (relation.py) and returns an overflow flag (a 0-d bool
tensor) when a bounded data-dependent output may have been truncated.
Ops never write into an input tensor, so the per-pass
``ArrangementCache`` can key on tensor identity.

The hot primitives (probe ranks, segment reduce, merge ranks, expand)
go through an injected ``KernelDispatch`` (backend.py). ``backend=None``
means the plain torch versions, which serve CPU tensors only.

Scatters: the reference drops out-of-range targets (``mode="drop"``),
which torch does not do (an out-of-range index raises on the CPU and
asserts on the device). Here every scatter writes into a buffer with one
spare row, sends each dropped target to that row, and returns the
buffer without it. Gathers that the reference clamps (``mode="clip"``)
clamp their indices explicitly.

Correspondence to DD operators (paper Sec. 2.3):
    arrange        -> ``arrange`` (sort by join-key prefix)
    join_core      -> ``join`` (rank probe + bounded expand)
    distinct       -> ``dedupe``
    concat         -> ``concat_all`` + ``dedupe``
    antijoin       -> ``antijoin`` (membership, negated)
    reduce         -> ``reduce_groups`` (sorted segment aggregation)
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.engine.backend import TORCH, KernelDispatch
from repro_torch.engine.observe import trace_count
from repro_torch.engine.relation import (
    KEY_PAD, PAD, Relation, lex_order, lex_order_words, live_mask,
    pack_key_words, rows_equal_prev, take_columns,
)
from repro_torch.engine.semiring import PRESENCE, Semiring


def _probe_ranks(bk: KernelDispatch, build_words, probe_words):
    """(lo, hi) ranks for [*, W] key words; W = 1 squeezes onto the
    single-word probe."""
    if build_words.shape[1] == 1:
        return bk.probe(build_words[:, 0], probe_words[:, 0])
    return bk.probe_multi(build_words, probe_words)


def _probe_lo_ranks(bk: KernelDispatch, build_words, probe_words):
    if build_words.shape[1] == 1:
        return bk.probe_lo(build_words[:, 0], probe_words[:, 0])
    return bk.probe_lo_multi(build_words, probe_words)


def _take_rows(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(data, idx, axis=0, mode="clip")``."""
    return data[idx.clamp(0, data.shape[0] - 1)]


def _scatter_rows(cap: int, fill, targets: torch.Tensor,
                  src: torch.Tensor) -> torch.Tensor:
    """``full(cap, fill).at[targets].set(src, mode="drop")`` for
    non-negative targets: targets >= cap land in a spare row that is
    cut off."""
    out = torch.full((cap + 1,) + tuple(src.shape[1:]), fill,
                     dtype=src.dtype, device=src.device)
    out.index_put_((targets.clamp(max=cap),), src)
    return out[:cap]


def _scatter_compact(data, val, keep, out_cap, val_identity):
    """Stable compaction: keep[i] rows move to positions cumsum-1; the
    result preserves input order. Returns (data, val, n, overflow)."""
    pos = torch.cumsum(keep, 0, dtype=torch.int32) - 1
    n = keep.sum(dtype=torch.int32)
    overflow = n > out_cap
    tgt = torch.where(keep, pos, out_cap)
    out = _scatter_rows(out_cap, PAD, tgt, data)
    vout = None
    if val is not None:
        vout = _scatter_rows(out_cap, val_identity, tgt, val)
    return out, vout, torch.clamp(n, max=out_cap), overflow


def dedupe(data: torch.Tensor, val: Optional[torch.Tensor], sr: Semiring,
           out_cap: int, assume_sorted: bool = False,
           backend: Optional[KernelDispatch] = None):
    """Sort rows, combine duplicate rows' values with ``sr.add``
    (presence: drop duplicates), emit sorted distinct rows. All-PAD rows
    are dropped. Returns (Relation, overflow). The duplicate-combine is
    a sorted-segment reduction through ``backend``."""
    bk = backend or TORCH
    trace_count("relops.dedupe")
    rows = data.shape[0]
    if sr.has_value and val is None:
        val = torch.ones((rows,), dtype=sr.dtype, device=data.device)
    if not assume_sorted:
        order = lex_order(data)
        data = data[order]
        if val is not None:
            val = val[order]
    if data.shape[1] == 0:
        raise ValueError("zero-arity relations are stored with a dummy "
                         "constant column (see engine)")
    live = ~torch.all(data == PAD, dim=1)
    first = live & ~(rows_equal_prev(data) & live)
    if val is not None and sr.has_value:
        seg = torch.cumsum(first, 0, dtype=torch.int32) - 1
        seg = torch.where(live, seg, rows)  # dead rows out of range
        op = "sum" if sr.name == "counting" else sr.name
        combined = bk.segment_reduce(val, seg, rows, op)
        # a first row's segment id is its group's index
        val = torch.where(first, combined[seg.clamp(0, rows - 1)], val)
        if sr.name == "counting":
            # drop rows whose combined count is 0 (retraction fixpoint)
            first = first & (val != 0)
    d, v, n, ov = _scatter_compact(
        data, val, first, out_cap, sr.identity if sr.has_value else 0)
    if not sr.has_value:
        v = None
    return Relation(d, v, n), ov


def arrange(rel: Relation, key_cols: tuple[int, ...]) -> Relation:
    """Sort a relation so ``key_cols`` form the primary sort order (the
    DD 'arrangement'). No sort runs when ``key_cols`` is already a
    prefix of the relation's sort-order witness. Ties among the other
    columns follow the output's witness."""
    key_cols = tuple(key_cols)
    if rel.arranged_by(key_cols):
        trace_count("arrange.cache_fastpath")
        return rel
    perm = key_cols + tuple(c for c in range(rel.arity)
                            if c not in key_cols)
    order = lex_order(take_columns(rel.data, perm))
    data = rel.data[order]
    val = rel.val[order] if rel.val is not None else None
    return Relation(data, val, rel.n, order=perm)


class ArrangementCache:
    """Shares arrangements across all rules/subplans of one evaluation
    pass (Sec. 7 plan-level sharing at the physical layer).

    Keying: ``(id(rel.data), key_cols)``, verified on lookup by ``is``
    against all three stored tensors (data, val, n), which the entry
    holds so a recycled id never aliases a dead relation. One cache per
    evaluation pass."""

    def __init__(self):
        self._entries: dict = {}
        self.hits = 0
        self.misses = 0

    def arrange(self, rel: Relation, key_cols: tuple[int, ...]
                ) -> Relation:
        key_cols = tuple(key_cols)
        if rel.arranged_by(key_cols):
            trace_count("arrange.cache_fastpath")
            return rel
        key = (id(rel.data), key_cols)
        ent = self._entries.get(key)
        if ent is not None and ent[0] is rel.data and (
                ent[1] is rel.val) and ent[2] is rel.n:
            self.hits += 1
            trace_count("arrange.cache_hits")
            return ent[3]
        self.misses += 1
        trace_count("arrange.cache_misses")
        arranged = arrange(rel, key_cols)
        self._entries[key] = (rel.data, rel.val, rel.n, arranged)
        return arranged

    def memo(self, tag, keyed_leaves: tuple, compute):
        """Generic sharing for non-sort physical work keyed on a
        relation's identity — e.g. a sharded repartition whose result
        many ops of the same pass reuse (shard.ShardedEvaluator).
        ``keyed_leaves`` is the tuple of objects the work depends on;
        every leaf is held strongly and re-verified with ``is``."""
        key = (tag,) + tuple(id(x) for x in keyed_leaves)
        ent = self._entries.get(key)
        if ent is not None and all(
                a is b for a, b in zip(ent[0], keyed_leaves)):
            self.hits += 1
            trace_count("arrange.cache_hits")
            return ent[1]
        self.misses += 1
        trace_count("arrange.cache_misses")
        out = compute()
        self._entries[key] = (keyed_leaves, out)
        return out


def _arrange(cache: Optional[ArrangementCache], rel: Relation,
             key_cols: tuple[int, ...]) -> Relation:
    if cache is not None:
        return cache.arrange(rel, key_cols)
    return arrange(rel, key_cols)


def expand_indices(counts: torch.Tensor, offsets: torch.Tensor,
                   out_cap: int):
    """The bounded 'repeat' pattern: output slot j maps to input row i =
    searchsorted(offsets, j, 'right') with within-group index j -
    offsets[i-1]. Returns (row_idx, within_idx, valid, total), as the
    reference's; ``join`` dispatches through ``KernelDispatch.expand``."""
    del counts  # offsets alone determine the expansion
    from repro_torch.kernels import ref
    return ref.expand_indices_ref(offsets, out_cap)


def join(left: Relation, right: Relation,
         l_keys: tuple[int, ...], r_keys: tuple[int, ...],
         l_out: tuple[int, ...], r_out: tuple[int, ...],
         sr: Semiring, out_cap: int,
         arranged: bool = False,
         backend: Optional[KernelDispatch] = None,
         cache: Optional[ArrangementCache] = None):
    """Sort-merge inner join. Output columns = left[l_out] ++ right[r_out]
    (unsorted). Returns (data, val, valid_mask, total, overflow) — loose
    rows, so fused consumers can filter/project before compaction. The
    count/locate probe and the bounded expand go through ``backend``."""
    bk = backend or TORCH
    trace_count("relops.join")
    if not arranged:
        left = _arrange(cache, left, l_keys)
        right = _arrange(cache, right, r_keys)
    llive = live_mask(left)
    lk = pack_key_words(left.data, l_keys, llive)
    rk = pack_key_words(right.data, r_keys, live_mask(right))
    lo, hi = _probe_ranks(bk, rk, lk)
    counts = torch.where(llive, hi - lo, 0)
    offsets = torch.cumsum(counts, 0, dtype=torch.int32)
    li, within, valid, total = bk.expand(offsets, out_cap)
    ri = _take_rows(lo, li) + within
    ldata = _take_rows(left.data, li)
    rdata = _take_rows(right.data, ri)
    cols = []
    if l_out:
        cols.append(take_columns(ldata, l_out))
    if r_out:
        cols.append(take_columns(rdata, r_out))
    data = torch.cat(cols, dim=1) if cols else torch.zeros(
        (out_cap, 0), dtype=torch.int32, device=left.device)
    val = None
    if sr.has_value and sr.mul is not None:
        lval = _take_rows(left.val, li) if left.val is not None else 1
        rval = _take_rows(right.val, ri) if right.val is not None else 1
        val = sr.mul(lval, rval)
    overflow = total > out_cap
    return data, val, valid, total, overflow


def membership(left: Relation, right: Relation,
               l_keys: tuple[int, ...], r_keys: tuple[int, ...],
               right_arranged: bool = False,
               backend: Optional[KernelDispatch] = None,
               cache: Optional[ArrangementCache] = None) -> torch.Tensor:
    """Boolean mask over left rows: does the key appear in right? (The
    lift operator of Sec. 8 materializes this 0/1.)"""
    bk = backend or TORCH
    trace_count("relops.membership")
    if not right_arranged:
        right = _arrange(cache, right, r_keys)
    llive = live_mask(left)
    if len(l_keys) == 0:
        # ground guard: right non-empty? (dead left rows stay dead)
        return (right.n > 0) & llive
    lk = pack_key_words(left.data, l_keys, llive)
    rk = pack_key_words(right.data, r_keys, live_mask(right))
    if bk.needs_sorted_probe:
        order = lex_order_words(lk)
        lo, hi = _probe_ranks(bk, rk, lk[order])
        found = torch.zeros((left.capacity,), dtype=torch.bool,
                            device=left.device)
        found = found.index_put((order,), hi > lo)
    else:
        lo, hi = _probe_ranks(bk, rk, lk)
        found = hi > lo
    return found & llive


def semijoin(left: Relation, right: Relation,
             l_keys: tuple[int, ...], r_keys: tuple[int, ...],
             out_cap: Optional[int] = None, sr: Semiring = PRESENCE,
             backend: Optional[KernelDispatch] = None,
             cache: Optional[ArrangementCache] = None):
    out_cap = out_cap or left.capacity
    keep = membership(left, right, l_keys, r_keys, backend=backend,
                      cache=cache)
    d, v, n, ov = _scatter_compact(
        left.data, left.val, keep, out_cap,
        sr.identity if sr.has_value else 0)
    return Relation(d, v if left.val is not None else None, n,
                    order=left.order), ov


def antijoin(left: Relation, right: Relation,
             l_keys: tuple[int, ...], r_keys: tuple[int, ...],
             out_cap: Optional[int] = None, sr: Semiring = PRESENCE,
             backend: Optional[KernelDispatch] = None,
             cache: Optional[ArrangementCache] = None):
    out_cap = out_cap or left.capacity
    keep = ~membership(left, right, l_keys, r_keys, backend=backend,
                       cache=cache) & live_mask(left)
    d, v, n, ov = _scatter_compact(
        left.data, left.val, keep, out_cap,
        sr.identity if sr.has_value else 0)
    return Relation(d, v if left.val is not None else None, n,
                    order=left.order), ov


def difference(a: Relation, b: Relation,
               backend: Optional[KernelDispatch] = None,
               cache: Optional[ArrangementCache] = None):
    """Rows of a (all columns as key) not present in b."""
    cols = tuple(range(a.arity))
    return antijoin(a, b, cols, cols, backend=backend, cache=cache)


def concat_all(rels: Sequence[Relation], sr: Semiring, out_cap: int,
               backend: Optional[KernelDispatch] = None):
    """Multiway union with value combine (ConcatAll, Sec. 4)."""
    data = torch.cat([r.data for r in rels], dim=0)
    val = None
    if sr.has_value:
        val = torch.cat([
            r.val if r.val is not None
            else torch.ones((r.capacity,), dtype=sr.dtype, device=r.device)
            for r in rels])
    return dedupe(data, val, sr, out_cap, backend=backend)


def merge_sorted(full: Relation, delta: Relation, sr: Semiring,
                 out_cap: int,
                 backend: Optional[KernelDispatch] = None):
    """full ∪ delta for two identity-sorted arrangements without a
    re-sort: ``merge_ranks`` gives each row its output position in the
    stable merge (full wins ties), rows scatter once into a
    [cap_f + cap_d] buffer, and ``dedupe(assume_sorted=True)`` combines
    duplicates and compacts."""
    bk = backend or TORCH
    trace_count("arrange.merge_sorted")
    m, n = full.capacity, delta.capacity
    cols = tuple(range(full.arity))
    fk = pack_key_words(full.data, cols, live_mask(full))
    dk = pack_key_words(delta.data, cols, live_mask(delta))
    if fk.shape[1] == 1:
        pos_f, pos_d = bk.merge_ranks(fk[:, 0], dk[:, 0])
    else:
        pos_f, pos_d = bk.merge_ranks_multi(fk, dk)
    pos = torch.cat([pos_f, pos_d])
    data = _scatter_rows(m + n, PAD, pos,
                         torch.cat([full.data, delta.data]))
    val = None
    if sr.has_value:
        fval = full.val if full.val is not None else torch.ones(
            (m,), dtype=sr.dtype, device=full.device)
        dval = delta.val if delta.val is not None else torch.ones(
            (n,), dtype=sr.dtype, device=delta.device)
        val = _scatter_rows(m + n, sr.identity, pos,
                            torch.cat([fval, dval]))
    return dedupe(data, val, sr, out_cap, assume_sorted=True,
                  backend=backend)


def merge(full: Relation, delta: Relation, sr: Semiring, out_cap: int,
          backend: Optional[KernelDispatch] = None,
          incremental: bool = True):
    """full ∪ delta with sr.add combine. Returns (Relation, overflow).
    Identity-sorted operands take ``merge_sorted``; otherwise (or with
    ``incremental=False``) concat + sort. Both give the same bytes."""
    if incremental and full.identity_sorted and delta.identity_sorted:
        return merge_sorted(full, delta, sr, out_cap, backend=backend)
    return concat_all([full, delta], sr, out_cap, backend=backend)


def merge_with_delta(full: Relation, derived: Relation, sr: Semiring,
                     out_cap: int,
                     backend: Optional[KernelDispatch] = None,
                     cache: Optional[ArrangementCache] = None,
                     incremental: bool = True):
    """Merge ``derived`` into ``full``; return (new_full, new_delta, ovf).

    PRESENCE: delta = derived rows not already in full (set difference).
    MIN/MAX:  delta = rows whose lattice value strictly improved.
    The semi-naive frontier step (Sec. 2.2) and the monoid iteration of
    Sec. 9."""
    new_full, ov1 = merge(full, derived, sr, out_cap, backend=backend,
                          incremental=incremental)
    if not sr.has_value:
        delta, ov2 = difference(derived, full, backend=backend,
                                cache=cache)
        return new_full, delta, ov1 | ov2
    # lattice: look up each new_full row's key in old full (lo rank
    # only) and compare values
    bk = backend or TORCH
    cols = tuple(range(full.arity))
    new_live = live_mask(new_full)
    fk = pack_key_words(full.data, cols, live_mask(full))
    nk = pack_key_words(new_full.data, cols, new_live)
    lo = _probe_lo_ranks(bk, fk, nk)
    if fk.shape[1] == 1:
        found = (_take_rows(fk[:, 0], lo) == nk[:, 0]) & (
            nk[:, 0] != KEY_PAD)
    else:
        found = torch.all(_take_rows(fk, lo) == nk, dim=1) & new_live
    old_val = torch.where(found, _take_rows(full.val, lo), sr.identity)
    improved = new_live & sr.improves(new_full.val, old_val)
    d, v, n, ov2 = _scatter_compact(
        new_full.data, new_full.val, improved, out_cap, sr.identity)
    return new_full, Relation(d, v, n), ov1 | ov2


def reduce_groups(rel: Relation, group_cols: tuple[int, ...],
                  aggs: tuple[tuple[str, int], ...], out_cap: int,
                  backend: Optional[KernelDispatch] = None,
                  cache: Optional[ArrangementCache] = None):
    """Stratified grouped aggregation: sort by group key, segment-reduce.
    Output data columns = group_cols ++ one column per agg. COUNT counts
    distinct tuples (set semantics, as Datalog COUNT(y))."""
    bk = backend or TORCH
    trace_count("relops.reduce_groups")
    r = _arrange(cache, rel, group_cols)
    cap = r.capacity
    live = live_mask(r)
    gkey = pack_key_words(r.data, group_cols, live)
    first = live.clone()
    if cap > 1:
        first[1:] &= torch.any(gkey[1:] != gkey[:-1], dim=1)
    seg = torch.cumsum(first, 0, dtype=torch.int32) - 1
    seg = torch.where(live, seg, cap)
    outs = []
    for func, col in aggs:
        x = r.data[:, col]
        if func == "COUNT":
            res = bk.segment_reduce(torch.ones_like(x), seg, cap, "sum")
        elif func == "SUM":
            res = bk.segment_reduce(x, seg, cap, "sum")
        elif func == "MIN":
            res = bk.segment_reduce(x, seg, cap, "min")
        elif func == "MAX":
            res = bk.segment_reduce(x, seg, cap, "max")
        else:
            raise ValueError(func)
        outs.append(res)
    ngroups = first.sum(dtype=torch.int32)
    agg_mat = torch.stack(outs, dim=1).to(torch.int32)    # [cap, n_aggs]
    rows = torch.cat([take_columns(r.data, group_cols),
                      agg_mat[seg.clamp(0, cap - 1)]], dim=1)
    # first rows move to their group index; the rest are dropped
    out = _scatter_rows(out_cap, PAD, torch.where(first, seg, out_cap),
                        rows)
    overflow = ngroups > out_cap
    # rows come out in group-key order; re-sort to full-row order
    return dedupe(out, None, PRESENCE, out_cap, assume_sorted=False,
                  backend=backend)[0], overflow


def as_columns(rel: Relation) -> torch.Tensor:
    """Expose a monoid relation's value as a trailing data column (Scan
    of a monoid IDB; Sec. 9)."""
    if rel.val is None:
        return rel.data
    vcol = torch.where(live_mask(rel), rel.val, PAD).to(torch.int32)
    return torch.cat([rel.data, vcol[:, None]], dim=1)
