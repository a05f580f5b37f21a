"""Fixed-capacity relations and the **arrangement contract** every engine
layer builds on — the torch counterpart of ``repro.engine.relation``.

A ``Relation`` is a plain object holding three tensors and one piece of
host metadata:

    data  : int32[capacity, arity]   tuple columns
    val   : int32[capacity] | None   diff/monoid payload (None = presence,
                                     the zero-bit struct of Sec. 8)
    n     : int32[] (0-d tensor)     live row count, on the data's device
    order : tuple[int, ...] | None   sort-order witness (None = identity)

Arrangement contract
====================

A sorted ``Relation`` *is* an arrangement; every probe/merge consumer
relies on three invariants every relop maintains:

  * **Sorted + distinct.** Rows ``[0, n)`` are live, sorted
    lexicographically by the witness column sequence, and
    duplicate-free; rows ``[n, cap)`` are PAD (all-PAD columns,
    identity payload), which sort last (PAD is the int32 maximum).
  * **Sort-order witness.** ``order`` records the exact column sequence
    the rows are sorted by (``None`` = identity). ``relops.arrange``
    skips the sort when the requested key is a prefix of it.
  * **Maintenance is incremental.** ``relops.merge`` interleaves the
    sorted ``full`` with the small sorted ``delta`` by rank
    (``merge_sorted``) instead of concatenating and re-sorting.

Relops never update a relation's tensors in place: the per-pass
``relops.ArrangementCache`` keys on ``id(rel.data)`` and verifies with
``is``, so an in-place write would leave a cached arrangement aliasing
stale data.

Multi-word row keys
===================

``pack_key_words`` maps ``k`` selected columns to ``ceil(k/3)`` int64
words of up to ``KEY_CHUNK`` = 3 columns each. Comparing word vectors
lexicographically equals comparing the column tuples lexicographically;
dead rows are ``KEY_PAD`` in every word. Keys of <= 3 columns are one
word, bit-for-bit ``pack_columns``. A full 3-column word assumes
non-negative values < 2**21; 1- and 2-column words are safe for any
non-negative int32. Under ``force_multiword()`` every key gains one
constant word, so W <= 4 for the stored arities the compiler admits
(``MAX_STORED_COLUMNS`` = 8).

Torch has no ``lexsort``: ``lex_order`` and ``lex_order_words`` are
chained stable sorts, least significant key first.
"""
from __future__ import annotations

import contextlib
from collections.abc import MutableMapping
from typing import Optional

import numpy as np
import torch

from repro_torch.engine import observe as _observe

PAD = torch.iinfo(torch.int32).max
KEY_PAD = torch.iinfo(torch.int64).max

# columns packed per key word (21 bits each in a full word)
KEY_CHUNK = 3
# capability ceiling for stored IDB arities (compile-time check in
# core/optimizer/pipeline.py); key_width(8) = 3 words
MAX_STORED_COLUMNS = 8

# test hook (see force_multiword): when true, pack_key_words appends a
# constant extra word so even narrow keys take the multi-word path
_FORCE_MULTIWORD = False

# counters for the arrangement layer live in the metrics registry
# (engine/observe.py) under ``arrange.*``; ``COUNTERS`` is a dict view.
# In this eager port they count calls, not compiled ops.
_COUNTER_NS = "arrange."
_COUNTER_KEYS = ("sorts", "merge_sorted", "cache_hits",
                 "cache_misses", "cache_fastpath")


class _CountersView(MutableMapping):
    """Dict facade over the ``arrange.*`` registry counters."""

    def __getitem__(self, k):
        return _observe.REGISTRY.get(_COUNTER_NS + k)

    def __setitem__(self, k, v):
        _observe.REGISTRY.set(_COUNTER_NS + k, int(v))

    def __delitem__(self, k):
        raise TypeError("COUNTERS keys are fixed")

    def __iter__(self):
        return iter(_COUNTER_KEYS)

    def __len__(self):
        return len(_COUNTER_KEYS)

    def __repr__(self):
        return repr(dict(self))


COUNTERS = _CountersView()

# Sort-order witness sentinel: rows in no guaranteed order (e.g. the
# engine's monoid column split). Such relations never take the arrange
# fast path or the merge_sorted maintenance path.
UNSORTED = ("unsorted",)


def reset_counters() -> None:
    """Deprecated: zeroes the ``arrange.*`` registry counters. Prefer
    ``counter_scope`` (or a registry scope) to a global reset."""
    for k in _COUNTER_KEYS:
        _observe.REGISTRY.set(_COUNTER_NS + k, 0)


def counters_snapshot() -> dict:
    """Deprecated: the ``arrange.*`` registry counters as a dict of short
    keys."""
    return dict(COUNTERS)


@contextlib.contextmanager
def counter_scope():
    """Yields a dict that, on exit, holds exactly the ``arrange.*``
    counts accumulated inside the block; the registry keeps
    accumulating across it."""
    before = {k: COUNTERS[k] for k in _COUNTER_KEYS}
    for k in _COUNTER_KEYS:
        _observe.REGISTRY.set(_COUNTER_NS + k, 0)
    window: dict = {}
    try:
        yield window
    finally:
        window.update({k: COUNTERS[k] for k in _COUNTER_KEYS})
        for k in _COUNTER_KEYS:
            _observe.REGISTRY.inc(_COUNTER_NS + k, before[k])


class Relation:
    """See module docstring. ``order`` is the sort-order witness;
    construction sites that produce identity-sorted rows omit it."""

    __slots__ = ("data", "val", "n", "order")

    def __init__(self, data: torch.Tensor, val: Optional[torch.Tensor],
                 n: torch.Tensor, order: Optional[tuple] = None):
        self.data = data
        self.val = val
        self.n = n
        self.order = tuple(order) if order is not None else None

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def arity(self) -> int:
        return self.data.shape[1]

    @property
    def device(self) -> torch.device:
        return self.data.device

    def sort_prefix(self) -> tuple:
        """The full column sequence live rows are sorted by."""
        if self.order is not None:
            return self.order
        return tuple(range(self.arity))

    def arranged_by(self, key_cols) -> bool:
        """True iff rows are already sorted primarily by exactly this
        key-column sequence (the ``relops.arrange`` fast-path test)."""
        if self.order == UNSORTED:
            return False
        key_cols = tuple(key_cols)
        return self.sort_prefix()[:len(key_cols)] == key_cols

    @property
    def identity_sorted(self) -> bool:
        """True iff the witness is the identity sequence — the state
        ``merge_sorted`` maintenance requires of both operands."""
        return self.order is None or self.order == tuple(
            range(self.arity))

    def __repr__(self):
        return (f"Relation(cap={self.capacity}, arity={self.arity}, "
                f"order={self.order}, device={self.device})")


def pow2_cap(n: int, floor: int = 16) -> int:
    """Smallest power-of-two capacity holding ``n`` rows with headroom
    (the engine-wide growth policy for host-built relations)."""
    return max(floor, int(2 ** np.ceil(np.log2(n + 1))))


def _count(n: int, device) -> torch.Tensor:
    """A row count from the host: a host-to-device copy, so only where
    host data enters (``from_numpy``, ``from_arrays``)."""
    return torch.tensor(n, dtype=torch.int32, device=device)


def empty(cap: int, arity: int, val_identity=None,
          device="cuda") -> Relation:
    """An empty relation, built by device fills alone (no host copy), so
    a captured iteration may build one."""
    data = torch.full((cap, arity), PAD, dtype=torch.int32, device=device)
    val = None
    if val_identity is not None:
        val = torch.full((cap,), val_identity, dtype=torch.int32,
                         device=device)
    return Relation(data, val, torch.zeros((), dtype=torch.int32,
                                           device=device))


def _stable_lex_perm(data: torch.Tensor) -> torch.Tensor:
    """Stable lexicographic ordering permutation of int32 rows (column 0
    most significant), as ``np.lexsort`` over reversed columns gives it.
    Columns go in pairs: ``c0 * 2**32 + (c1 + 2**31)`` is an int64 key
    order-isomorphic to the pair (c0, c1) for any int32 values, so each
    stable sort pass handles two columns."""
    rows, arity = data.shape
    perm = torch.arange(rows, device=data.device)
    c = arity
    while c > 0:
        lo = max(c - 2, 0)
        cols = data[perm, lo:c].to(torch.int64)
        if c - lo == 2:
            key = (cols[:, 0] << 32) + (cols[:, 1] + (1 << 31))
        else:
            key = cols[:, 0]
        perm = perm[torch.argsort(key, stable=True)]
        c = lo
    return perm


def from_numpy(rows: np.ndarray, cap: int, val: Optional[np.ndarray] = None,
               val_identity=None, dedupe: bool = True,
               device="cuda") -> Relation:
    """Build a sorted, distinct relation from an (n, arity) int array.
    The sort and the duplicate drop run on ``device``."""
    rows = np.asarray(rows)
    if rows.dtype != np.int32:
        rows = np.asarray(rows, dtype=np.int64).astype(np.int32)
    if rows.ndim == 1:
        rows = rows[:, None]
    n, arity = rows.shape
    if n > cap:
        raise ValueError(f"{n} rows exceed capacity {cap}")
    # torch.from_numpy wants a writable C-contiguous array
    t = torch.from_numpy(np.require(rows, requirements="CW")).to(device)
    v = None
    if val is not None:
        v = torch.from_numpy(np.asarray(val).astype(np.int32)).to(device)
    if n:
        perm = _stable_lex_perm(t)
        t = t[perm]
        if v is not None:
            v = v[perm]
        elif dedupe:
            keep = torch.ones((n,), dtype=torch.bool, device=device)
            keep[1:] = torch.any(t[1:] != t[:-1], dim=1)
            t = t[keep]
            n = t.shape[0]
    data = torch.full((cap, arity), PAD, dtype=torch.int32, device=device)
    data[:n] = t
    vout = None
    if v is not None:
        identity = 0 if val_identity is None else val_identity
        vout = torch.full((cap,), identity, dtype=torch.int32,
                          device=device)
        vout[:n] = v
    elif val_identity is not None:
        vout = torch.full((cap,), val_identity, dtype=torch.int32,
                          device=device)
    return Relation(data, vout, _count(n, device))


def from_arrays(data: np.ndarray, val: Optional[np.ndarray], n: int,
                order: Optional[tuple] = None, device="cuda") -> Relation:
    """A relation from its raw arrays, taken as they are (no sort, no
    dedupe): e.g. ``np.asarray(rel.data)``, ``.val`` and ``int(rel.n)``
    of a reference relation, so one arranged state feeds both
    packages."""
    d = torch.from_numpy(np.array(data, np.int32)).to(device)
    v = None if val is None else torch.from_numpy(
        np.array(val, np.int32)).to(device)
    return Relation(d, v, _count(int(n), device), order=order)


def to_arrays(rel: Relation):
    """(data, val, n) as numpy arrays and an int — ``from_arrays``'s
    inverse."""
    return (rel.data.cpu().numpy(),
            None if rel.val is None else rel.val.cpu().numpy(),
            int(rel.n))


def to_numpy(rel: Relation) -> np.ndarray:
    n = int(rel.n)
    return rel.data[:n].cpu().numpy()


def to_numpy_with_val(rel: Relation):
    n = int(rel.n)
    return rel.data[:n].cpu().numpy(), (
        rel.val[:n].cpu().numpy() if rel.val is not None else None)


# -- packed row keys ---------------------------------------------------------

def pack_columns(data: torch.Tensor, cols: tuple[int, ...],
                 live: torch.Tensor) -> torch.Tensor:
    """Pack selected (join-key) columns into a single monotone int64 key;
    dead rows map to KEY_PAD so they sort last. Keys of 1-2 columns are
    always safe (31 bits each for non-negative int32); 3 columns assume
    values < 2^21."""
    k = len(cols)
    key = torch.zeros((data.shape[0],), dtype=torch.int64,
                      device=data.device)
    if k == 0:
        return torch.where(live, key, KEY_PAD)
    bits = {1: 62, 2: 31, 3: 21}.get(k)
    if bits is None:
        raise ValueError(
            f"pack_columns packs at most {KEY_CHUNK} columns per word "
            f"(got {k}); use pack_key_words for wider keys")
    for c in cols:
        key = (key << bits) | data[:, c].to(torch.int64)
    return torch.where(live, key, KEY_PAD)


def key_width(num_cols: int) -> int:
    """Words needed to key ``num_cols`` columns (>= 1; 3 cols/word)."""
    return max(1, -(-num_cols // KEY_CHUNK))


def pack_key_words(data: torch.Tensor, cols: tuple[int, ...],
                   live: torch.Tensor) -> torch.Tensor:
    """Multi-word lexicographic key: int64[rows, key_width(len(cols))]
    (plus one constant word under ``force_multiword``)."""
    words = [pack_columns(data, cols[i:i + KEY_CHUNK], live)
             for i in range(0, max(len(cols), 1), KEY_CHUNK)]
    if _FORCE_MULTIWORD:
        zero = torch.zeros((), dtype=torch.int64, device=data.device)
        words.append(torch.where(live, zero, KEY_PAD))
    return torch.stack(words, dim=1)


def multiword_forced() -> bool:
    """Whether ``force_multiword`` is in effect (a captured iteration
    bakes it in, so the graph memo keys on it)."""
    return _FORCE_MULTIWORD


@contextlib.contextmanager
def force_multiword():
    """Test hook: make every key >= 2 words by appending a constant word
    (0 for live rows, KEY_PAD for dead — order- and semantics-
    preserving), so narrow programs run the multi-word probe path."""
    global _FORCE_MULTIWORD
    prev = _FORCE_MULTIWORD
    _FORCE_MULTIWORD = True
    try:
        yield
    finally:
        _FORCE_MULTIWORD = prev


def take_columns(data: torch.Tensor, cols) -> torch.Tensor:
    """``data[:, list(cols)]`` for a static column sequence, gathered as
    a stack of column views: indexing with a Python list copies the list
    from the host on every call, which a captured iteration may not."""
    cols = tuple(cols)
    if cols == tuple(range(data.shape[1])):
        return data
    if not cols:
        return data.new_zeros((data.shape[0], 0))
    return torch.stack([data[:, c] for c in cols], dim=1)


def live_mask(rel: Relation) -> torch.Tensor:
    return torch.arange(rel.capacity, device=rel.device) < rel.n


def lex_order(data: torch.Tensor) -> torch.Tensor:
    """Row ordering permutation: lexicographic by column 0, 1, ...; PAD
    rows sort last. Stable, like ``jnp.lexsort``."""
    _observe.trace_count("arrange.sorts")
    return _stable_lex_perm(data)


def lex_order_words(words: torch.Tensor) -> torch.Tensor:
    """Stable ordering permutation for multi-word keys [rows, W]:
    lexicographic by word 0, 1, ...; all-KEY_PAD rows sort last."""
    perm = torch.argsort(words[:, -1], stable=True)
    for c in range(words.shape[1] - 2, -1, -1):
        perm = perm[torch.argsort(words[perm, c], stable=True)]
    return perm


def rows_equal_prev(data: torch.Tensor) -> torch.Tensor:
    """For sorted data: row i equals row i-1 (row 0 -> False)."""
    out = torch.zeros((data.shape[0],), dtype=torch.bool,
                      device=data.device)
    if data.shape[0] > 1:
        out[1:] = torch.all(data[1:] == data[:-1], dim=1)
    return out
