"""Boolean / algebraic specialization (paper Sec. 8-9), on torch tensors.

Every relation row conceptually carries a ``diff`` drawn from a monoid.
Batch Datalog only needs *presence*: restricting the diff to the
Booleans turns join into AND, concat into OR, and lets the diff be
stored as a zero-bit struct. Incremental Datalog needs (Z, +);
recursive aggregation bakes MIN/MAX into the diff.

* ``PRESENCE``  — no value tensor at all.
* ``COUNTING``  — int32 multiplicities; negative = retraction.
* ``MIN/MAX``   — lattice value combined on dedupe/merge; the delta of an
                  iteration is the set of rows whose value *improved*
                  (how CC/SSSP run without retractions, Sec. 9).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

_I32 = torch.iinfo(torch.int32)


@dataclass(frozen=True)
class Semiring:
    name: str
    has_value: bool
    # identity for merge-combine; also the pad value for invalid rows
    identity: Optional[int]
    # combine two diffs for the same tuple (concat/merge): OR / + / MIN
    add: Optional[Callable]
    # combine diffs of joined tuples: AND / * / pass-through
    mul: Optional[Callable]
    # does a merged value "improve" (generate a delta) over the old one?
    improves: Optional[Callable]
    dtype: Optional[torch.dtype] = None


PRESENCE = Semiring(
    name="presence",
    has_value=False,
    identity=None,
    add=None,
    mul=None,
    improves=None,
)

COUNTING = Semiring(
    name="counting",
    has_value=True,
    identity=0,
    add=lambda a, b: a + b,
    mul=lambda a, b: a * b,
    improves=lambda new, old: new != old,
    dtype=torch.int32,
)

MIN_MONOID = Semiring(
    name="min",
    has_value=True,
    identity=_I32.max,
    add=torch.minimum,
    mul=None,               # MIN values flow through joins as data columns
    improves=lambda new, old: new < old,
    dtype=torch.int32,
)

MAX_MONOID = Semiring(
    name="max",
    has_value=True,
    identity=_I32.min,
    add=torch.maximum,
    mul=None,
    improves=lambda new, old: new > old,
    dtype=torch.int32,
)


def monoid_for(func: str) -> Semiring:
    if func == "MIN":
        return MIN_MONOID
    if func == "MAX":
        return MAX_MONOID
    raise ValueError(f"no lattice monoid for {func}")
