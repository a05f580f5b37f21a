"""The port's IncrementalEngine against the JAX package's, step by step,
in host mode and in device mode (on the CPU, the device loop without
capture), on the CPU. Device mode's streams are in
``tests/test_torch_incremental_device.py``.

Seeded update streams (inserts, deletes of present rows, mixed steps,
duplicate re-inserts, empty batches, delete-then-reinsert) over TC,
Negation (recompute on a negated change), WideReach2 (multi-word rows)
and CC (a monoid: deletes fall back to recompute): after every step the
port's snapshot, EDB mirror and ``_stats.iterations`` equal the
reference's, and its snapshot equals the port's own batch run of the
current EDBs. Then the single cases of ``tests/test_incremental.py``:
DRed (with its rounds and candidate counts), stratum pruning, a
downstream aggregate and negation recompute."""
import functools

import numpy as np
import pytest
import torch

from benchmarks.programs import CC, UNREACH, equivalence_datasets
from repro.core.optimizer import compile_program as j_compile
from repro.engine import EngineConfig as JConfig
from repro.engine import observe as JO
from repro.engine.incremental import IncrementalEngine as JInc
from repro_torch.core.optimizer import compile_program as t_compile
from repro_torch.engine import EngineConfig as TConfig
from repro_torch.engine import Observation, make_engine

CAPS = dict(idb_cap=1 << 10, intermediate_cap=1 << 12)
MODES = ("host", "device")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops (up to eight shard threads): under a parallel
    run the workers share the cores, and torch's idle OpenMP threads
    spinning on an oversubscribed host make such ops far slower."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
# program -> (steps, stream seed)
STREAMS = {"TC": (30, 201), "Negation": (30, 202), "WideReach2": (30, 203),
           "CC": (30, 204)}


def _source(program: str) -> str:
    return CC if program == "CC" else equivalence_datasets()[program][0]


def _edbs(program: str) -> dict:
    if program == "CC":
        rng = np.random.default_rng(3)
        return {"edge": rng.integers(0, 24, size=(40, 2))}
    return {k: np.asarray(v)
            for k, v in equivalence_datasets()[program][1].items()}


def gen_stream(seed: int, edbs: dict, n_steps: int) -> list:
    """Seeded (inserts, deletes) steps: random insert batches (empty
    ones too), deletes of current rows, mixed steps, re-inserts of
    present rows, empty batches, and a delete whose rows come back on
    the next step."""
    rng = np.random.default_rng(seed)
    arity = {k: np.asarray(v).reshape(len(v), -1).shape[1]
             for k, v in edbs.items()}
    mirror = {k: set(map(tuple, np.asarray(v).reshape(-1, arity[k])))
              for k, v in edbs.items()}
    dom = {k: int(np.asarray(v).max(initial=0)) + 2
           for k, v in edbs.items()}
    names = sorted(edbs)
    kinds = ["ins", "del", "mixed", "dup", "empty", "delreins"]
    steps, pending = [], {}
    for _ in range(n_steps):
        ins, dele, pending = dict(pending), {}, {}
        kind = kinds[int(rng.integers(len(kinds)))]
        name = names[int(rng.integers(len(names)))]
        a = arity[name]

        def current(k: int) -> np.ndarray:
            cur = sorted(mirror[name])
            if not cur or not k:
                return np.zeros((0, a), int)
            return np.array([cur[j] for j in rng.permutation(len(cur))[:k]])

        if kind in ("ins", "mixed"):
            batch = rng.integers(0, dom[name], size=(int(rng.integers(5)), a))
            ins[name] = np.concatenate(
                [ins.get(name, np.zeros((0, a), int)), batch]).astype(int)
        if kind in ("del", "mixed"):
            dele[name] = current(int(rng.integers(0, 4)))
        if kind == "dup":
            ins[name] = current(int(rng.integers(1, 4)))
        if kind == "empty":
            ins.setdefault(name, np.zeros((0, a), int))
            dele[name] = np.zeros((0, a), int)
        if kind == "delreins":
            rows = current(int(rng.integers(1, 3)))
            if len(rows):
                dele[name] = rows
                pending[name] = rows
        for n_, r in ins.items():
            mirror[n_] |= set(map(tuple, np.asarray(r).reshape(-1,
                                                                arity[n_])))
        for n_, r in dele.items():
            mirror[n_] -= set(map(tuple, np.asarray(r).reshape(-1,
                                                                arity[n_])))
        steps.append((ins, dele))
    return steps


def _stream(program: str) -> list:
    steps, seed = STREAMS[program]
    return gen_stream(seed, _edbs(program), steps)


def _ref_mirror(inc) -> dict:
    return {name: np.array(sorted(rows), np.int32).reshape(
                len(rows), max(inc.compiled.arities[name], 1))
            for name, rows in inc.edbs.items()}


@functools.lru_cache(maxsize=None)
def reference_stream(program: str, mode: str) -> list:
    """(snapshot, iterations, EDB mirror) after initialize and after
    every step of the program's stream, by the reference."""
    inc = JInc(j_compile(_source(program)), JConfig(
        kernel_backend="jnp", mode=mode, **CAPS))
    inc.initialize({k: v.copy() for k, v in _edbs(program).items()})
    out = [(inc.snapshot(), dict(inc._stats.iterations), _ref_mirror(inc))]
    for ins, dele in _stream(program):
        snap = inc.apply(inserts=ins, deletes=dele)
        out.append((snap, dict(inc._stats.iterations), _ref_mirror(inc)))
    return [({k: np.asarray(v) for k, v in snap.items()}, it, mirror)
            for snap, it, mirror in out]


def assert_same(got: dict, want: dict, ctx: str) -> None:
    assert got.keys() == want.keys(), ctx
    for name in want:
        assert got[name].dtype == want[name].dtype, f"{name} {ctx}"
        np.testing.assert_array_equal(got[name], want[name],
                                      err_msg=f"{name} {ctx}")


def port_engine(src: str, mode: str, incremental: bool = True,
                shards: int = 0):
    return make_engine(t_compile(src), TConfig(device="cpu", mode=mode,
                                               shards=shards, **CAPS),
                       incremental=incremental)


def assert_stream_matches(program: str, mode: str, shards: int = 0) -> None:
    want = reference_stream(program, mode)
    src = _source(program)
    inc = port_engine(src, mode, shards=shards)
    batch = port_engine(src, mode, incremental=False)
    snap = inc.initialize({k: v.copy() for k, v in _edbs(program).items()})
    assert_same(snap, want[0][0], "initialize")
    assert inc._stats.iterations == want[0][1]
    for step, (ins, dele) in enumerate(_stream(program)):
        ctx = f"program={program} mode={mode} shards={shards} step={step}"
        snap = inc.apply(inserts=ins, deletes=dele)
        ref_snap, ref_iters, ref_mirror = want[step + 1]
        assert_same(snap, ref_snap, ctx)
        assert inc._stats.iterations == ref_iters, ctx
        assert_same(inc.edbs, ref_mirror, ctx)
        out, _ = batch.run(inc.edbs)
        assert_same(snap, out, ctx + " (batch)")


@pytest.mark.parametrize("program", list(STREAMS))
def test_stream_matches_reference_and_batch(program):
    """Host mode; device mode's streams are in
    tests/test_torch_incremental_device.py (a file of their own, so a
    parallel run can give them to another worker)."""
    assert_stream_matches(program, "host")


@pytest.mark.parametrize("shards", (2, 8))
@pytest.mark.parametrize("program", list(STREAMS))
def test_sharded_stream_matches_reference_and_batch(program, shards):
    """The same streams over the sharded driver (``shards`` through
    make_engine): seeded continuations and DRed run shard-local, CC's and
    Negation's recomputes through the sharded loop, and after every step
    the state, iterations and mirror are the reference's unsharded
    IncrementalEngine's and the port's batch run's."""
    assert_stream_matches(program, "host", shards)


TC_SRC = """
.input edge
.output tc
tc(x,y) :- edge(x,y).
tc(x,z) :- tc(x,y), edge(y,z).
"""

CASES = {
    # DRed: deletes of TC edges, then a mixed step
    "dred": (TC_SRC, {"edge": np.random.default_rng(7).integers(
        0, 20, size=(30, 2))}, [
        ({}, {"edge": "first:4"}),
        ({}, {"edge": "first:4"}),
        ({"edge": np.array([[1, 2], [2, 3], [3, 1]])}, {"edge": "first:2"}),
    ]),
    # a change to e2 must not touch the stratum of a
    "pruning": ("""
    .input e1
    .input e2
    .output a
    .output b
    a(x,y) :- e1(x,y).
    a(x,z) :- a(x,y), e1(y,z).
    b(x,y) :- e2(x,y), a(x,x).
    """, {"e1": np.array([[0, 0], [0, 1]]), "e2": np.array([[0, 5]])}, [
        ({"e2": np.array([[0, 7]])}, {}),
    ]),
    # a stratified COUNT downstream of a maintained TC (recompute)
    "downstream-aggregate": ("""
    .input edge
    .output tc
    .output outdeg
    tc(x,y) :- edge(x,y).
    tc(x,z) :- tc(x,y), edge(y,z).
    outdeg(x, COUNT(y)) :- tc(x,y).
    """, {"edge": np.random.default_rng(8).integers(0, 15, size=(25, 2))}, [
        ({"edge": np.random.default_rng(9).integers(0, 15, size=(5, 2))},
         {"edge": "first:4"}),
    ]),
    # changes to a negated relation: unreach grows, then shrinks
    "negation": (UNREACH, {
        "edge": np.array([[0, 1], [1, 2], [2, 3], [9, 2]]),
        "source": np.array([[0]])}, [
        ({}, {"edge": np.array([[1, 2]])}),
        ({"edge": np.array([[0, 9]])}, {}),
    ]),
}


def _resolve(batch: dict, mirror: dict) -> dict:
    """"first:k" -> the first k rows of the current (sorted) EDB."""
    out = {}
    for name, rows in batch.items():
        if isinstance(rows, str):
            k = int(rows.split(":")[1])
            rows = np.asarray(mirror[name])[:k]
        out[name] = rows
    return out


def _dred_attrs(roots) -> list:
    return [(s.attrs["rounds"], s.attrs["candidate_rows"])
            for root in roots for s in root.find("dred-candidates")]


@functools.lru_cache(maxsize=None)
def reference_case(case: str, mode: str) -> list:
    src, edbs, steps = CASES[case]
    obs = JO.Observation()
    inc = JInc(j_compile(src), JConfig(kernel_backend="jnp", mode=mode,
                                       observe=obs, **CAPS))
    inc.initialize({k: v.copy() for k, v in edbs.items()})
    out = []
    for ins, dele in steps:
        mirror = _ref_mirror(inc)
        snap = inc.apply(inserts=_resolve(ins, mirror),
                         deletes=_resolve(dele, mirror))
        out.append(({k: np.asarray(v) for k, v in snap.items()},
                    dict(inc._stats.iterations), _dred_attrs(obs.roots)))
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(CASES))
def test_single_case_matches_reference(case, mode):
    src, edbs, steps = CASES[case]
    obs = Observation()
    inc = make_engine(t_compile(src), TConfig(
        device="cpu", mode=mode, observe=obs, **CAPS), incremental=True)
    inc.initialize({k: v.copy() for k, v in edbs.items()})
    for step, ((ins, dele), want) in enumerate(
            zip(steps, reference_case(case, mode))):
        ctx = f"case={case} mode={mode} step={step}"
        snap = inc.apply(inserts=_resolve(ins, inc.edbs),
                         deletes=_resolve(dele, inc.edbs))
        assert_same(snap, want[0], ctx)
        assert inc._stats.iterations == want[1], ctx
        assert _dred_attrs(obs.roots) == want[2], ctx
    if case == "dred":
        assert _dred_attrs(obs.roots), "no DRed pass ran"
    if case == "pruning":
        assert "inc_s0" not in inc._stats.iterations


def test_row_sets_keep_the_reference_semantics():
    """The host mirror: present inserts and absent deletes are dropped,
    changes come back sorted and distinct, for 1, 2 and 5 columns."""
    from repro_torch.engine.incremental import _RowSet
    rng = np.random.default_rng(11)
    for arity in (1, 2, 5):
        rows = rng.integers(-3, 4, size=(40, arity))
        s = _RowSet(arity, rows)
        want = set(map(tuple, rows))
        assert list(map(tuple, s.rows)) == sorted(want)
        batch = rng.integers(-3, 5, size=(30, arity))
        new = s.add(batch)
        assert list(map(tuple, new)) == sorted(set(map(tuple, batch)) - want)
        want |= set(map(tuple, batch))
        gone = s.remove(np.concatenate([batch[:10], rows[:10]]))
        drop = set(map(tuple, batch[:10])) | set(map(tuple, rows[:10]))
        assert list(map(tuple, gone)) == sorted(drop & want)
        want -= drop
        assert list(map(tuple, s.rows)) == sorted(want)
        assert s.add(np.zeros((0, arity), int)).shape == (0, arity)
    with pytest.raises(ValueError, match="int32"):
        _RowSet(1, np.array([[1 << 40]]))


@pytest.mark.parametrize("mode", MODES)
def test_recompute_rungs_match_reference(mode):
    """apply_base (mirror and stored EDBs only, idempotent),
    recompute_strata over the changed closure, and reinitialize, as the
    reference's."""
    edbs = {"edge": np.random.default_rng(12).integers(0, 16, size=(30, 2))}
    ins = {"edge": np.array([[1, 2], [2, 3], [15, 0]])}
    dele = {"edge": edbs["edge"][:5]}
    engines = [
        JInc(j_compile(TC_SRC), JConfig(kernel_backend="jnp", mode=mode,
                                        **CAPS)),
        port_engine(TC_SRC, mode)]
    runs = []
    for inc in engines:
        inc.initialize({k: v.copy() for k, v in edbs.items()})
        changed = inc.apply_base(inserts=ins, deletes=dele)
        again = inc.apply_base(inserts=ins, deletes=dele)
        inc.recompute_strata(changed)
        snap = {k: np.asarray(v) for k, v in inc.snapshot().items()}
        iters = dict(inc._stats.iterations)
        out = {k: np.asarray(v) for k, v in inc.reinitialize().items()}
        runs.append((changed, again, snap, iters, out))
    (jc, ja, js, ji, jo), (tc, ta, ts, ti, to) = runs
    assert (tc, ta) == (jc, ja) == ({"edge"}, set())
    assert_same(ts, js, f"recompute_strata mode={mode}")
    assert ti == ji
    assert_same(to, jo, f"reinitialize mode={mode}")
