"""Every ported relop against the JAX relop on the same arranged state
(built once by repro's from_numpy and handed to the port through
``from_arrays``): byte-identical data, values, live counts, witnesses
and overflow flags, on random arrangements with PAD tails, duplicates,
overflow, COUNTING cancellation and multi-word keys."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import relops as JO
from repro.engine.backend import JNP
from repro.engine.relation import (
    force_multiword as j_force, from_numpy as j_from_numpy,
)
from repro.engine.semiring import (
    COUNTING as J_COUNTING, MIN_MONOID as J_MIN, PRESENCE as J_PRESENCE,
)
from repro_torch.engine import relops as TO
from repro_torch.engine.relation import (
    force_multiword as t_force, from_arrays, to_arrays,
)
from repro_torch.engine.semiring import (
    COUNTING as T_COUNTING, MIN_MONOID as T_MIN, PRESENCE as T_PRESENCE,
)

SRS = {"presence": (J_PRESENCE, T_PRESENCE),
       "counting": (J_COUNTING, T_COUNTING),
       "min": (J_MIN, T_MIN)}


def _port(jrel):
    return from_arrays(np.asarray(jrel.data),
                       None if jrel.val is None else np.asarray(jrel.val),
                       int(jrel.n), order=jrel.order, device="cpu")


def _pair(rng, n, cap, arity, hi=6, valued=None):
    rows = rng.integers(0, hi, size=(n, arity))
    kw = {}
    if valued is not None:
        kw = dict(val=rng.integers(-4, 5, n), val_identity=valued,
                  dedupe=False)
        rows = np.unique(rows, axis=0)
        kw["val"] = kw["val"][:rows.shape[0]]
    jrel = j_from_numpy(rows, cap, **kw)
    return jrel, _port(jrel)


def _same(trel, jrel):
    data, val, n = to_arrays(trel)
    np.testing.assert_array_equal(data, np.asarray(jrel.data))
    assert n == int(jrel.n)
    assert (val is None) == (jrel.val is None)
    if val is not None:
        np.testing.assert_array_equal(val, np.asarray(jrel.val))
    assert trel.order == jrel.order


def _flag(t, j):
    assert bool(t) == bool(j)


@pytest.mark.parametrize("sr", sorted(SRS))
@pytest.mark.parametrize("out_cap", [64, 8])
def test_dedupe(sr, out_cap):
    """Duplicates combine with sr.add (COUNTING cancels to zero and
    drops), PAD rows drop, an undersized out_cap overflows."""
    jsr, tsr = SRS[sr]
    rng = np.random.default_rng(1)
    rows = rng.integers(0, 4, size=(48, 3)).astype(np.int32)
    rows[40:] = np.iinfo(np.int32).max
    val = rng.integers(-2, 3, 48).astype(np.int32) if jsr.has_value else None
    jrel, jov = JO.dedupe(jnp.asarray(rows), None if val is None else
                          jnp.asarray(val), jsr, out_cap, backend=JNP)
    trel, tov = TO.dedupe(torch.from_numpy(rows), None if val is None else
                          torch.from_numpy(val), tsr, out_cap)
    _same(trel, jrel)
    _flag(tov, jov)


@pytest.mark.parametrize("key", [(0,), (1,), (1, 0), (2, 0, 1)])
def test_arrange_and_cache(key):
    rng = np.random.default_rng(2)
    jrel, trel = _pair(rng, 30, 48, 3)
    _same(TO.arrange(trel, key), JO.arrange(jrel, key))
    cache = TO.ArrangementCache()
    a1 = cache.arrange(trel, key)
    a2 = cache.arrange(trel, key)
    assert a1 is a2 or key == (0,)       # (0,) is the witness fast path
    assert cache.hits == (0 if key == (0,) else 1)


@pytest.mark.parametrize("keys", [((0,), (0,)), ((1,), (0,)),
                                  ((0, 1), (1, 0)), ((0, 1, 2), (0, 1, 2)),
                                  ((0, 1, 2, 3), (0, 1, 2, 3))])
@pytest.mark.parametrize("out_cap", [256, 16])
def test_join(keys, out_cap):
    """Loose join outputs (data, valid, total, overflow) byte-equal,
    narrow and 4-column (multi-word) keys, with and without overflow."""
    l_keys, r_keys = keys
    rng = np.random.default_rng(len(l_keys))
    arity = max(4, len(l_keys))
    jl, tl = _pair(rng, 30, 40, arity, hi=3)
    jr, tr = _pair(rng, 25, 32, arity, hi=3)
    l_out = tuple(range(arity))
    r_out = tuple(c for c in range(arity) if c not in r_keys)
    jout = JO.join(jl, jr, l_keys, r_keys, l_out, r_out, J_PRESENCE,
                   out_cap, backend=JNP)
    tout = TO.join(tl, tr, l_keys, r_keys, l_out, r_out, T_PRESENCE,
                   out_cap)
    for t, j in zip(tout[:1] + tout[2:4], jout[:1] + jout[2:4]):
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
    assert tout[1] is None and jout[1] is None
    _flag(tout[4], jout[4])


def test_join_counting_values():
    rng = np.random.default_rng(9)
    jl, tl = _pair(rng, 20, 32, 2, hi=4, valued=0)
    jr, tr = _pair(rng, 20, 32, 2, hi=4, valued=0)
    jout = JO.join(jl, jr, (1,), (0,), (0, 1), (1,), J_COUNTING, 128,
                   backend=JNP)
    tout = TO.join(tl, tr, (1,), (0,), (0, 1), (1,), T_COUNTING, 128)
    valid = np.asarray(jout[2])
    np.testing.assert_array_equal(tout[1].numpy()[valid],
                                  np.asarray(jout[1])[valid])


@pytest.mark.parametrize("keys", [((1,), (0,)), ((0, 1), (0, 1)), ((), ()),
                                  ((0, 1, 2, 3), (0, 1, 2, 3))])
def test_membership_semijoin_antijoin(keys):
    l_keys, r_keys = keys
    rng = np.random.default_rng(3)
    jl, tl = _pair(rng, 40, 64, 4, hi=3)
    jr, tr = _pair(rng, 25, 32, 4, hi=3)
    np.testing.assert_array_equal(
        TO.membership(tl, tr, l_keys, r_keys).numpy(),
        np.asarray(JO.membership(jl, jr, l_keys, r_keys, backend=JNP)))
    for jop, top in ((JO.semijoin, TO.semijoin),
                     (JO.antijoin, TO.antijoin)):
        jrel, jov = jop(jl, jr, l_keys, r_keys, backend=JNP)
        trel, tov = top(tl, tr, l_keys, r_keys)
        _same(trel, jrel)
        _flag(tov, jov)


def test_difference_and_empty_sides():
    rng = np.random.default_rng(11)
    ja, ta = _pair(rng, 30, 64, 2, hi=10)
    jb, tb = _pair(rng, 30, 64, 2, hi=10)
    je, te = _pair(rng, 0, 16, 2)
    for (x, y), (u, v) in (((ta, tb), (ja, jb)), ((ta, te), (ja, je)),
                           ((te, ta), (je, ja))):
        trel, tov = TO.difference(x, y)
        jrel, jov = JO.difference(u, v, backend=JNP)
        _same(trel, jrel)
        _flag(tov, jov)


@pytest.mark.parametrize("sr", sorted(SRS))
def test_concat_all(sr):
    jsr, tsr = SRS[sr]
    rng = np.random.default_rng(4)
    ident = jsr.identity if jsr.has_value else None
    ja, ta = _pair(rng, 20, 32, 2, hi=5, valued=ident)
    jb, tb = _pair(rng, 12, 16, 2, hi=5, valued=ident)
    jrel, jov = JO.concat_all([ja, jb], jsr, 32, backend=JNP)
    trel, tov = TO.concat_all([ta, tb], tsr, 32)
    _same(trel, jrel)
    _flag(tov, jov)


@pytest.mark.parametrize("sr", sorted(SRS))
@pytest.mark.parametrize("arity", [2, 5])
@pytest.mark.parametrize("incremental", [True, False])
def test_merge(sr, arity, incremental):
    """merge_sorted (incremental) and concat + sort: same bytes as the
    reference, duplicates across the boundary and an overflow."""
    jsr, tsr = SRS[sr]
    rng = np.random.default_rng(arity)
    ident = jsr.identity if jsr.has_value else None
    jf, tf = _pair(rng, 30, 64, arity, hi=3, valued=ident)
    jd, td = _pair(rng, 12, 16, arity, hi=3, valued=ident)
    for out_cap in (64, 24):
        jrel, jov = JO.merge(jf, jd, jsr, out_cap, backend=JNP,
                             incremental=incremental)
        trel, tov = TO.merge(tf, td, tsr, out_cap, incremental=incremental)
        _same(trel, jrel)
        _flag(tov, jov)


@pytest.mark.parametrize("sr", ["presence", "min"])
@pytest.mark.parametrize("arity", [2, 4])
def test_merge_with_delta(sr, arity):
    """The semi-naive frontier step: set difference under PRESENCE,
    strict lattice improvement under MIN."""
    jsr, tsr = SRS[sr]
    rng = np.random.default_rng(5 + arity)
    ident = jsr.identity if jsr.has_value else None
    jf, tf = _pair(rng, 20, 64, arity, hi=3, valued=ident)
    jd, td = _pair(rng, 20, 32, arity, hi=3, valued=ident)
    jout = JO.merge_with_delta(jf, jd, jsr, 64, backend=JNP)
    tout = TO.merge_with_delta(tf, td, tsr, 64)
    _same(tout[0], jout[0])
    _same(tout[1], jout[1])
    _flag(tout[2], jout[2])


def test_merge_with_delta_force_multiword():
    rng = np.random.default_rng(17)
    jf, tf = _pair(rng, 20, 64, 2, hi=5, valued=J_MIN.identity)
    jd, td = _pair(rng, 20, 32, 2, hi=5, valued=J_MIN.identity)
    with j_force(), t_force():
        jout = JO.merge_with_delta(jf, jd, J_MIN, 64, backend=JNP)
        tout = TO.merge_with_delta(tf, td, T_MIN, 64)
    _same(tout[0], jout[0])
    _same(tout[1], jout[1])


@pytest.mark.parametrize("group", [(0,), (1, 0), (), (0, 1, 2, 3)])
def test_reduce_groups(group):
    rng = np.random.default_rng(len(group))
    jrel, trel = _pair(rng, 50, 64, 5, hi=4)
    aggs = (("COUNT", 4), ("SUM", 4), ("MIN", 4), ("MAX", 4))
    for out_cap in (64, 4):
        jr, jov = JO.reduce_groups(jrel, group, aggs, out_cap, backend=JNP)
        tr, tov = TO.reduce_groups(trel, group, aggs, out_cap)
        _same(tr, jr)
        _flag(tov, jov)


def test_as_columns():
    rng = np.random.default_rng(6)
    jrel, trel = _pair(rng, 10, 16, 2, hi=5, valued=J_MIN.identity)
    np.testing.assert_array_equal(TO.as_columns(trel).numpy(),
                                  np.asarray(JO.as_columns(jrel)))
    assert TO.as_columns(_port(j_from_numpy(np.ones((2, 2)), 4))).shape == (
        4, 2)
