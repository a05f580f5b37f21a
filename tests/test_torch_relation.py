"""repro_torch.engine.relation against repro.engine.relation on the same
seeded inputs: packed keys byte-equal (single-word, multi-word and under
force_multiword in both packages), lex orders equal to jnp.lexsort, and
host-built relations identical."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine import relation as JR
from repro_torch.engine import relation as TR


def _both(rows):
    return jnp.asarray(rows, jnp.int32), torch.from_numpy(
        np.asarray(rows, np.int32))


def _live(cap, n):
    return jnp.arange(cap) < n, torch.arange(cap) < n


def test_constants_match():
    assert (TR.PAD, TR.KEY_PAD) == (int(JR.PAD), int(JR.KEY_PAD))
    assert (TR.KEY_CHUNK, TR.MAX_STORED_COLUMNS) == (
        JR.KEY_CHUNK, JR.MAX_STORED_COLUMNS)
    assert [TR.key_width(k) for k in range(10)] == [
        JR.key_width(k) for k in range(10)]
    assert [TR.pow2_cap(n) for n in (0, 1, 15, 16, 1000)] == [
        JR.pow2_cap(n) for n in (0, 1, 15, 16, 1000)]


@pytest.mark.parametrize("cols", [(), (0,), (1, 0), (0, 1, 2), (2, 0, 1)])
def test_pack_columns_byte_equal(cols):
    rng = np.random.default_rng(len(cols))
    jd, td = _both(rng.integers(0, 1 << 20, size=(32, 3)))
    jl, tl = _live(32, 20)
    np.testing.assert_array_equal(
        TR.pack_columns(td, cols, tl).numpy(),
        np.asarray(JR.pack_columns(jd, cols, jl)))


def test_pack_columns_62bit_single_column():
    """One column packs into the top bits (shift 62): int32 values up to
    PAD land on the sign bit exactly as in the reference."""
    jd, td = _both(np.array([[0], [1], [3], [(1 << 31) - 2]]))
    jl, tl = _live(4, 4)
    np.testing.assert_array_equal(
        TR.pack_columns(td, (0,), tl).numpy(),
        np.asarray(JR.pack_columns(jd, (0,), jl)))


@pytest.mark.parametrize("ncols", [1, 3, 4, 5, 6, 8])
@pytest.mark.parametrize("forced", [False, True])
def test_pack_key_words_byte_equal(ncols, forced):
    rng = np.random.default_rng(ncols)
    jd, td = _both(rng.integers(0, 100, size=(16, ncols)))
    jl, tl = _live(16, 9)
    cols = tuple(range(ncols))
    if forced:
        with JR.force_multiword(), TR.force_multiword():
            want = np.asarray(JR.pack_key_words(jd, cols, jl))
            got = TR.pack_key_words(td, cols, tl).numpy()
        assert got.shape[1] == TR.key_width(ncols) + 1
    else:
        want = np.asarray(JR.pack_key_words(jd, cols, jl))
        got = TR.pack_key_words(td, cols, tl).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.all(got[9:] == TR.KEY_PAD)           # dead rows, every word
    assert not np.any(got[:9] == TR.KEY_PAD)


def test_force_multiword_restores_on_exit():
    with TR.force_multiword():
        assert TR._FORCE_MULTIWORD
    assert not TR._FORCE_MULTIWORD


@pytest.mark.parametrize("arity", [1, 2, 3, 5])
def test_lex_order_equals_jnp_lexsort(arity):
    """Chained stable sorts give lexsort's permutation exactly, ties,
    PAD rows and negative values included."""
    rng = np.random.default_rng(arity)
    rows = rng.integers(-3, 3, size=(60, arity))
    rows[50:] = int(JR.PAD)
    rows[::7] = rows[1::7][: rows[::7].shape[0]]
    jd, td = _both(rows)
    np.testing.assert_array_equal(TR.lex_order(td).numpy(),
                                  np.asarray(JR.lex_order(jd)))


@pytest.mark.parametrize("width", [1, 2, 4])
def test_lex_order_words_equals_reference(width):
    rng = np.random.default_rng(width)
    words = rng.integers(0, 4, size=(50, width)).astype(np.int64)
    words[40:] = int(JR.KEY_PAD)
    np.testing.assert_array_equal(
        TR.lex_order_words(torch.from_numpy(words)).numpy(),
        np.asarray(JR.lex_order_words(jnp.asarray(words))))


@pytest.mark.parametrize("ncols", [4, 5, 6, 8])
def test_multiword_order_isomorphism(ncols):
    """Sorting by word vectors == sorting by the column tuples."""
    rng = np.random.default_rng(ncols)
    rows = rng.integers(0, 4, size=(50, ncols))
    words = TR.pack_key_words(torch.from_numpy(rows.astype(np.int32)),
                              tuple(range(ncols)),
                              torch.ones(50, dtype=torch.bool))
    by_words = TR.lex_order_words(words).numpy()
    by_cols = np.lexsort(tuple(rows[:, c] for c in reversed(range(ncols))))
    np.testing.assert_array_equal(rows[by_words], rows[by_cols])


def test_rows_equal_prev():
    rows = np.array([[1, 2], [1, 2], [1, 3], [4, 0], [4, 0]])
    jd, td = _both(rows)
    np.testing.assert_array_equal(TR.rows_equal_prev(td).numpy(),
                                  np.asarray(JR.rows_equal_prev(jd)))


def _assert_same(trel, jrel):
    data, val, n = TR.to_arrays(trel)
    np.testing.assert_array_equal(data, np.asarray(jrel.data))
    assert n == int(jrel.n)
    assert (val is None) == (jrel.val is None)
    if val is not None:
        np.testing.assert_array_equal(val, np.asarray(jrel.val))


@pytest.mark.parametrize("kind", ["dedupe", "valued", "identity", "keep"])
def test_from_numpy_identical(kind):
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 5, size=(40, 2))
    kw = {}
    if kind == "valued":
        kw = dict(val=rng.integers(-3, 9, 40), val_identity=2 ** 31 - 1,
                  dedupe=False)
    elif kind == "identity":
        kw = dict(val_identity=0)
    elif kind == "keep":
        kw = dict(dedupe=False)
    trel = TR.from_numpy(rows, 64, device="cpu", **kw)
    _assert_same(trel, JR.from_numpy(rows, 64, **kw))
    assert trel.order is None and trel.n.dtype == torch.int32
    np.testing.assert_array_equal(TR.to_numpy(trel),
                                  JR.to_numpy(JR.from_numpy(rows, 64, **kw)))


def test_from_numpy_rejects_overfull_and_takes_1d():
    with pytest.raises(ValueError):
        TR.from_numpy(np.arange(20), 16, device="cpu")
    _assert_same(TR.from_numpy(np.array([3, 1, 3]), 16, device="cpu"),
                 JR.from_numpy(np.array([3, 1, 3]), 16))


def test_from_arrays_round_trip():
    """A reference relation's arrays feed the port unchanged."""
    jrel = JR.from_numpy(np.array([[1, 2], [0, 5]]), 8, val=np.array(
        [4, 7]), val_identity=0, dedupe=False)
    trel = TR.from_arrays(np.asarray(jrel.data), np.asarray(jrel.val),
                          int(jrel.n), order=(1, 0), device="cpu")
    _assert_same(trel, jrel)
    assert trel.order == (1, 0) and not trel.identity_sorted
    assert trel.arranged_by((1,)) and not trel.arranged_by((0,))
    empty = TR.empty(8, 2, val_identity=5, device="cpu")
    _assert_same(empty, JR.empty(8, 2, val_identity=5))


def test_counter_scope_windows():
    with TR.counter_scope() as outer:
        TR.lex_order(torch.zeros((4, 1), dtype=torch.int32))
        with TR.counter_scope() as inner:
            TR.lex_order(torch.zeros((4, 1), dtype=torch.int32))
    assert inner["sorts"] == 1 and outer["sorts"] == 2
