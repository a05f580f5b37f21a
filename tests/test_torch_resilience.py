"""The port's durability layer (``repro_torch.engine.resilience``)
against the JAX package's (``repro.engine.resilience``) on the CPU: the
non-slow cases of tests/test_resilience.py held against the reference
on the same seeded inputs (WAL-tail replay, mismatch refusals, the WAL's
round trip, compaction, torn tail and IO fault, the three ladder rungs,
the sampled sanitizer), snapshots and WALs cross-loaded in both
directions, ``program_hash`` equal across the packages, and the seeded
crash-replay differential over tests/test_update_streams.py's
CRASH_SITES: after every step byte-identical to the uninterrupted run,
iteration dicts included."""
from benchmarks.hostdevices import force_host_device_count

force_host_device_count()  # must precede the first jax device init

import functools
import itertools
import json
import shutil

import numpy as np
import pytest
import torch

from benchmarks import programs as P
from repro.core.datalog import ast as j_ast
from repro.core.optimizer import compile_program as j_compile
from repro.engine import EngineConfig as JConfig
from repro.engine import faults as JF
from repro.engine import resilience as JR
from repro.engine.incremental import IncrementalEngine as JInc
from repro.engine.observe import Observation as JObservation
from repro_torch.core.datalog import ast as t_ast
from repro_torch.core.optimizer import compile_program as t_compile
from repro_torch.engine import Engine, EngineConfig, Observation
from repro_torch.engine import faults as F
from repro_torch.engine import resilience as R
from repro_torch.engine.incremental import IncrementalEngine
from repro_torch.launch.incremental_serving import PROGRAM as SERVING

from test_update_streams import CRASH_SITES, _assert_states_equal, gen_stream


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's many small torch ops on one thread: the test
    workers share the cores, and torch's idle OpenMP threads spinning on
    an oversubscribed host make such ops tens of times slower."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

CAPS = dict(idb_cap=1 << 10, intermediate_cap=1 << 12)
MODES = ("host", "device")

TC_SRC = """
.input edge
.output tc
tc(x,y) :- edge(x,y).
tc(x,z) :- tc(x,y), edge(y,z).
"""

PATH_SRC = """
.input arc
.output path
path(x,y) :- arc(x,y).
path(x,z) :- path(x,y), arc(y,z).
"""


def _edges(seed=0, n=18, dom=11):
    return np.random.default_rng(seed).integers(0, dom, size=(n, 2))


def _tcfg(mode="host", **kw):
    return EngineConfig(**CAPS, device="cpu", mode=mode, **kw)


def _jcfg(**kw):
    return JConfig(**CAPS, kernel_backend="jnp", **kw)


def _serving_edbs(seed=2):
    rng = np.random.default_rng(seed)
    return {"link": rng.integers(0, 40, size=(90, 2)),
            "monitor": np.array([[0]]),
            "quarantined": np.array([[7], [23]])}


def _stream(edbs, name, seed, n_steps):
    """Insert 3 rows and delete 2 present ones a step, as the serving
    example does; the present rows come from a numpy mirror."""
    rng = np.random.default_rng(seed)
    cur = {tuple(r) for r in np.asarray(edbs[name])}
    dom = int(np.asarray(edbs[name]).max()) + 2
    steps = []
    for _ in range(n_steps):
        ins = rng.integers(0, dom, size=(3, 2))
        rows = np.array(sorted(cur))
        dele = rows[rng.permutation(len(rows))[:2]]
        cur |= {tuple(r) for r in ins}
        cur -= {tuple(r) for r in dele}
        steps.append(({name: ins}, {name: dele}))
    return steps


def _same(a: dict, b: dict, ctx=""):
    assert a.keys() == b.keys(), ctx
    for name in a:
        np.testing.assert_array_equal(np.asarray(a[name]),
                                      np.asarray(b[name]),
                                      err_msg=f"{name} {ctx}")


def _durable(pkg, src, d, mode="host", rcfg=None, **kw):
    if pkg == "ref":
        return JR.DurableIncrementalEngine(
            j_compile(src), _jcfg(**kw), directory=d,
            resilience=rcfg or JR.ResilienceConfig())
    return R.DurableIncrementalEngine(
        t_compile(src), _tcfg(mode, **kw), directory=d,
        resilience=rcfg or R.ResilienceConfig())


# -- durable snapshots: WAL-tail replay, refusals -----------------------------

def _recover_tail(pkg, d, mode="host"):
    """tests/test_resilience.py's WAL-tail case: snapshot 0 only, two
    logged updates, then a cold recover."""
    cp_src = TC_SRC
    dur = _durable(pkg, cp_src, d, mode,
                   rcfg=(JR if pkg == "ref" else R).ResilienceConfig(
                       snapshot_every=0))
    dur.initialize({"edge": _edges()})
    dur.apply(inserts={"edge": [[0, 9], [9, 7]]})
    out = dur.apply(deletes={"edge": [_edges()[0].tolist()]})
    dur.close()
    cold = _durable(pkg, cp_src, d, mode)
    rec = cold.recover()
    assert cold.applied_seq == 2
    _same(out, rec)
    return rec, dict(cold.inc._stats.iterations)


@functools.lru_cache(maxsize=None)
def _reference_tail():
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        return _recover_tail("ref", d)


@pytest.mark.parametrize("mode", MODES)
def test_recover_replays_wal_tail(mode, tmp_path):
    rec, iters = _recover_tail("port", tmp_path, mode)
    want, want_iters = _reference_tail()
    _same(rec, want)
    if mode == "host":
        assert iters == want_iters


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """TC snapshot 0 written by each package."""
    root = tmp_path_factory.mktemp("snapshots")
    inc = JInc(j_compile(TC_SRC), _jcfg())
    inc.initialize({"edge": _edges()})
    JR.save_snapshot(inc, root / "ref", seq=0)
    inc = IncrementalEngine(t_compile(TC_SRC), _tcfg())
    inc.initialize({"edge": _edges()})
    R.save_snapshot(inc, root / "port", seq=0)
    return root


def _refusing_engine(pkg, what):
    from repro.engine.semiring import COUNTING as J_COUNTING
    from repro_torch.engine.semiring import COUNTING as T_COUNTING
    src = PATH_SRC if what == "program" else TC_SRC
    if pkg == "ref":
        kw = {"semiring": J_COUNTING} if what == "semiring" else {}
        return JInc(j_compile(src), _jcfg(**kw))
    kw = {"semiring": T_COUNTING} if what == "semiring" else {}
    return IncrementalEngine(t_compile(src), _tcfg(**kw))


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("what,match", [
    ("program", "program"), ("semiring", "config fingerprint"),
    ("schema", "schema_version")])
def test_restore_refuses_mismatch(snapshots, writer, what, match,
                                  tmp_path):
    """A snapshot of either package is refused by both on a program,
    semiring or schema mismatch, with the same message."""
    d = tmp_path / "snap"
    shutil.copytree(snapshots / writer, d)
    if what == "schema":
        man_path = d / "step_00000000" / "manifest.json"
        man = json.loads(man_path.read_text())
        man["extra"]["schema_version"] = 999
        man_path.write_text(json.dumps(man))
    errors = []
    for pkg, mod in (("ref", JR), ("port", R)):
        with pytest.raises(mod.SnapshotMismatch, match=match) as err:
            mod.restore_snapshot(_refusing_engine(pkg, what), d)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_program_and_config_fingerprints():
    cp, other = t_compile(TC_SRC), t_compile(PATH_SRC)
    assert R.program_hash(cp) != R.program_hash(other)
    from repro_torch.engine.semiring import COUNTING
    assert R.config_fingerprint(_tcfg()) == {"semiring": "presence"}
    assert R.config_fingerprint(_tcfg(semiring=COUNTING)) != (
        R.config_fingerprint(_tcfg()))
    assert R.SCHEMA_VERSION == JR.SCHEMA_VERSION


def test_restore_refuses_edb_values_outside_int32(snapshots, tmp_path):
    """The port's EDB mirror holds int32 rows: a snapshot whose EDB rows
    do not fit is refused with a ValueError, and the engine keeps the
    state it had."""
    from repro.checkpoint.checkpoint import load_checkpoint, save_checkpoint
    man, arrays = load_checkpoint(snapshots / "ref")
    state = {R._leaf_name(k): v for k, v in arrays.items()}
    state["rows::edge"] = state["rows::edge"].astype(np.int64)
    state["rows::edge"][0, 0] = 1 << 40
    save_checkpoint(tmp_path, 0, state, extra=man["extra"])
    inc = IncrementalEngine(t_compile(TC_SRC), _tcfg())
    before = inc.initialize({"edge": _edges(seed=5)})
    with pytest.raises(ValueError, match="int32"):
        R.restore_snapshot(inc, tmp_path)
    _same(inc.snapshot(), before)


@pytest.mark.parametrize("program", ["TC", "serving"])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_cross_load(writer, program, tmp_path):
    """One package writes snapshots and a WAL tail (4 updates, a
    snapshot every 3); the other's recover() from that directory equals
    the writer's own recover(); then both apply one more batch
    identically (states and iteration dicts)."""
    src, name = (TC_SRC, "edge") if program == "TC" else (SERVING, "link")
    edbs = {"edge": _edges(seed=3, n=24)} if program == "TC" else (
        _serving_edbs())
    steps = _stream(edbs, name, seed=8, n_steps=5)
    pkgs = {"ref": JR, "port": R}
    dur = _durable(writer, src, tmp_path / "w",
                   rcfg=pkgs[writer].ResilienceConfig(snapshot_every=3))
    dur.initialize({k: v.copy() for k, v in edbs.items()})
    for ins, dele in steps[:4]:
        dur.apply(inserts=ins, deletes=dele)
    dur.close()
    recs, outs, iters = {}, {}, {}
    for pkg in ("ref", "port"):
        d = tmp_path / pkg
        shutil.copytree(tmp_path / "w", d)
        eng = _durable(pkg, src, d)
        recs[pkg] = eng.recover()
        assert eng.applied_seq == 4
        ins, dele = steps[4]
        outs[pkg] = eng.apply(inserts=ins, deletes=dele)
        iters[pkg] = dict(eng.inc._stats.iterations)
        eng.close()
    _same(recs["port"], recs["ref"], "recovered")
    _same(outs["port"], outs["ref"], "after one more batch")
    assert iters["port"] == iters["ref"]


@pytest.mark.parametrize("writer", ["ref", "port-sharded", "port"])
def test_sharded_cross_load(writer, tmp_path):
    """Snapshots cross shard counts and packages both ways: a 2-shard
    port engine's snapshot and WAL tail recover into the reference's and
    the port's unsharded engines, an unsharded engine's (either
    package's) into a 2-shard port engine; each restore across shard
    counts counts ``resilience.restore.rehomed``, and every reader gives
    the writer's view, then the same state after one more batch."""
    src, edbs = SERVING, _serving_edbs()
    steps = _stream(edbs, "link", seed=8, n_steps=5)
    pkg = "ref" if writer == "ref" else "port"
    writer_shards = 2 if writer == "port-sharded" else 0
    dur = _durable(pkg, src, tmp_path / "w",
                   rcfg=(JR if pkg == "ref" else R).ResilienceConfig(
                       snapshot_every=3),
                   **({"shards": 2} if writer_shards else {}))
    dur.initialize({k: v.copy() for k, v in edbs.items()})
    for ins, dele in steps[:4]:
        want = dur.apply(inserts=ins, deletes=dele)
    dur.close()
    readers = [("port", 2)] if not writer_shards else [("ref", 0),
                                                       ("port", 0)]
    outs = []
    for reader, shards in readers:
        d = tmp_path / f"{reader}{shards}"
        shutil.copytree(tmp_path / "w", d)
        obs = (JObservation if reader == "ref" else Observation)()
        kw = {"observe": obs, **({"shards": shards} if shards else {})}
        eng = _durable(reader, src, d, **kw)
        _same(eng.recover(), want, f"{reader} shards={shards} recovered")
        assert obs.registry.get("resilience.restore.rehomed") == 1
        ins, dele = steps[4]
        outs.append(eng.apply(inserts=ins, deletes=dele))
        eng.close()
    ref = _durable("ref", src, tmp_path / "x")
    ref.initialize({k: v.copy() for k, v in edbs.items()})
    for ins, dele in steps:
        last = ref.apply(inserts=ins, deletes=dele)
    ref.close()
    for out in outs:
        _same(out, last, "after one more batch")


@pytest.mark.parametrize("program", sorted(
    [n for n, t in vars(P).items()
     if n.isupper() and isinstance(t, str) and ".output" in t]
    + ["SERVING"]))
def test_program_hash_matches_reference(program, monkeypatch):
    """With both wildcard counters reset, the same text hashes alike in
    both packages (so a snapshot of one restores in the other)."""
    text = SERVING if program == "SERVING" else getattr(P, program)
    monkeypatch.setattr(j_ast, "_wildcard_counter", itertools.count())
    monkeypatch.setattr(t_ast, "_wildcard_counter", itertools.count())
    assert R.program_hash(t_compile(text)) == JR.program_hash(
        j_compile(text))


# -- write-ahead log ----------------------------------------------------------

def test_wal_roundtrip_and_compaction(tmp_path):
    log = R.UpdateLog(tmp_path / "u.log")
    log.append(1, {"edge": np.array([[1, 2]])}, None)
    log.append(2, None, {"edge": [[3, 4]]})
    log.append(3, {"edge": [[5, 6]]}, {"edge": []})
    assert [r["seq"] for r in log.records()] == [1, 2, 3]
    assert [r["seq"] for r in log.records(after_seq=1)] == [2, 3]
    assert log.records()[0]["ins"] == {"edge": [[1, 2]]}
    log.compact(2)
    assert [r["seq"] for r in log.records()] == [3]
    log.append(4, {"edge": [[7, 8]]}, None)   # append survives compact
    assert [r["seq"] for r in log.records()] == [3, 4]
    log.close()


def test_wal_bytes_match_reference(tmp_path):
    """The same appends and compaction give the same file in both."""
    for pkg, mod in (("ref", JR), ("port", R)):
        log = mod.UpdateLog(tmp_path / f"{pkg}.log")
        log.append(1, {"edge": np.array([[1, 2], [3, 4]])}, None)
        log.append(2, None, {"link": np.array([[-5, 6]], np.int32)})
        log.append(3, {"e": np.zeros((0, 2))}, {"e": [[7, 8]]})
        log.compact(1)
        log.close()
    assert (tmp_path / "ref.log").read_bytes() == (
        tmp_path / "port.log").read_bytes()
    assert [r["seq"] for r in JR.UpdateLog(tmp_path / "port.log").records()
            ] == [2, 3]


def test_wal_torn_tail_ignored(tmp_path):
    log = R.UpdateLog(tmp_path / "u.log")
    log.append(1, {"edge": [[1, 2]]}, None)
    log.append(2, {"edge": [[3, 4]]}, None)
    log.close()
    with open(tmp_path / "u.log", "a", encoding="utf-8") as fh:
        fh.write('{"seq": 3, "ins": {"edge": [[5,')   # torn
    assert [r["seq"] for r in log.records()] == [1, 2]
    assert [r["seq"] for r in JR.UpdateLog(tmp_path / "u.log").records()
            ] == [1, 2]


def test_wal_io_fault_surfaces(tmp_path):
    log = R.UpdateLog(tmp_path / "u.log")
    with F.install(F.FaultPlan([F.FaultSpec("wal.write", kind="io")])):
        with pytest.raises(F.FaultError):
            log.append(1, {"edge": [[1, 2]]}, None)
    log.append(1, {"edge": [[1, 2]]}, None)    # retry succeeds
    assert [r["seq"] for r in log.records()] == [1]
    log.close()


# -- graceful degradation ladder ----------------------------------------------

LADDER = {
    # rung: (fault site, hit, last, max_capacity_retries)
    "capacity_backoff": ("engine.rule_pass", 1, 2, 4),
    "stratum_recompute": ("engine.rule_pass", 1, -1, 2),
    "full_recompute": ("engine.stratum", 1, 4, 2),
}


def _run_ladder(pkg, rung, d, mode="host"):
    """tests/test_resilience.py's ladder cases: the fault plan of the
    rung, one apply under it, then a clean one."""
    site, hit, last, retries = LADDER[rung]
    mod, faults = (JR, JF) if pkg == "ref" else (R, F)
    obs = JObservation() if pkg == "ref" else Observation()
    dur = _durable(pkg, TC_SRC, d, mode, observe=obs,
                   rcfg=mod.ResilienceConfig(max_capacity_retries=retries))
    dur.initialize({"edge": _edges()})
    plan = faults.FaultPlan([faults.FaultSpec(site, kind="overflow",
                                              hit=hit, last=last)])
    with faults.install(plan):
        out = dur.apply(inserts={"edge": [[0, 10], [10, 4]]})
    out2 = dur.apply(inserts={"edge": [[4, 0]]})
    dur.close()
    return (out, out2, obs.registry.counters_snapshot("resilience."),
            dict(dur.inc._stats.iterations))


@functools.lru_cache(maxsize=None)
def _reference_ladder(rung):
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        return _run_ladder("ref", rung, d)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rung", sorted(LADDER))
def test_ladder_rungs_match_reference(rung, mode, tmp_path):
    """Transient overflow -> capacity backoff; growth exhausted ->
    stratum recompute; recompute overflowing too -> full recompute: the
    same rung counters as the reference, the same states, and a clean
    apply after it."""
    out, out2, counters, iters = _run_ladder("port", rung, tmp_path, mode)
    j_out, j_out2, j_counters, j_iters = _reference_ladder(rung)
    assert counters == j_counters
    assert counters.get(f"resilience.ladder.{rung}", 0) >= 1
    _same(out, j_out)
    _same(out2, j_out2)
    if mode == "host":
        assert iters == j_iters
    tc, _ = Engine(t_compile(TC_SRC), _tcfg()).run(
        {"edge": np.concatenate([_edges(), [[0, 10], [10, 4], [4, 0]]])})
    np.testing.assert_array_equal(out2["tc"], tc["tc"])


def _sanitized(pkg, d, mode="host"):
    """tests/test_resilience.py's sanitizer case: check_invariants=2 on
    the durable path, an apply, then a cold recover."""
    dur = _durable(pkg, TC_SRC, d, mode, check_invariants=2)
    dur.initialize({"edge": _edges()})
    out = dur.apply(inserts={"edge": [[0, 10], [10, 4]]})
    dur.close()
    cold = _durable(pkg, TC_SRC, d, mode, check_invariants=2)
    rec = cold.recover()
    _same(out, rec)
    return rec


@functools.lru_cache(maxsize=None)
def _reference_sanitized():
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        return _sanitized("ref", d)


@pytest.mark.parametrize("mode", MODES)
def test_durable_apply_with_sampled_sanitizer(mode, tmp_path):
    """check_invariants=N composes with the durable serving path."""
    _same(_sanitized("port", tmp_path, mode), _reference_sanitized())


# -- the seeded crash-replay differential -------------------------------------

STREAM_SEED, N_STEPS = 39, 6


def _tc_edbs():
    return {k: np.asarray(v) for k, v in
            P.equivalence_datasets()["TC"][1].items()}


@functools.lru_cache(maxsize=None)
def _trail(pkg: str, mode: str = "host"):
    """Per-step snapshots and iteration dicts of an uninterrupted
    IncrementalEngine over the stream."""
    edbs = _tc_edbs()
    inc = (JInc(j_compile(TC_SRC), _jcfg()) if pkg == "ref" else
           IncrementalEngine(t_compile(TC_SRC), _tcfg(mode)))
    outs = [inc.initialize({k: v.copy() for k, v in edbs.items()})]
    iters = [dict(inc._stats.iterations)]
    for ins, dele in gen_stream(STREAM_SEED, edbs, N_STEPS):
        outs.append({k: np.asarray(v) for k, v in inc.apply(
            inserts={k: v.copy() for k, v in ins.items()},
            deletes={k: v.copy() for k, v in dele.items()}).items()})
        iters.append(dict(inc._stats.iterations))
    return outs, iters


PLANS = ("seeded-31", "seeded-35") + CRASH_SITES


def _plan(name: str) -> F.FaultPlan:
    if name.startswith("seeded-"):
        return F.FaultPlan.seeded(int(name[7:]), CRASH_SITES, n_faults=4,
                                  max_hit=N_STEPS)
    return F.FaultPlan([F.FaultSpec(name, kind="crash", hit=2)])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("plan_name", PLANS)
def test_crash_replay_matches_uninterrupted(plan_name, mode, tmp_path):
    """Crashes at the fault sites, each followed by a cold restart
    (recover = snapshot restore + WAL replay, or initialize when no
    snapshot landed) and the in-flight batch re-submitted: after every
    step the state equals the port's uninterrupted run and the
    reference's trail byte for byte, iteration dicts included (the
    reference's where the mode is host's), and so does a cold recover
    after the stream."""
    _crash_replay(plan_name, mode, tmp_path)


@pytest.mark.parametrize("shards", (2, 8))
def test_sharded_crash_replay_matches_uninterrupted(shards, tmp_path):
    """The same differential over the sharded driver (the fault sites
    stay on the controlling thread, so one plan serves every shard
    count): each step equal to the unsharded trails, the reference's
    included."""
    _crash_replay("seeded-31", "host", tmp_path, shards)


def _crash_replay(plan_name, mode, tmp_path, shards=0):
    edbs = _tc_edbs()
    steps = gen_stream(STREAM_SEED, edbs, N_STEPS)
    outs, iters = _trail("port", mode)
    ref_outs, ref_iters = _trail("ref")
    plan = _plan(plan_name)
    rcfg = R.ResilienceConfig(snapshot_every=3)
    box, crashes = {}, []

    def fresh():
        return R.DurableIncrementalEngine(
            t_compile(TC_SRC), _tcfg(mode, shards=shards),
            directory=tmp_path, resilience=rcfg)

    def restart():
        while True:                 # recovery itself may crash again
            try:
                box["dur"].close()
                box["dur"] = fresh()
                if box["dur"].recoverable():
                    box["dur"].recover()
                else:               # died before snapshot 0 landed
                    box["dur"].initialize(
                        {k: v.copy() for k, v in edbs.items()})
                return
            except F.SimulatedCrash as e:
                crashes.append(e)

    def until_done(op):
        while True:
            try:
                return op()
            except F.SimulatedCrash as e:
                crashes.append(e)
                restart()

    box["dur"] = fresh()
    with F.install(plan):
        until_done(lambda: box["dur"].initialize(
            {k: v.copy() for k, v in edbs.items()}))
        for i, (ins, dele) in enumerate(steps):
            out = until_done(lambda: box["dur"].apply(
                inserts={k: v.copy() for k, v in ins.items()},
                deletes={k: v.copy() for k, v in dele.items()}))
            ctx = (f"plan={plan_name} mode={mode} shards={shards} "
                   f"step={i} {plan.fired}")
            _assert_states_equal(out, outs[i + 1], ctx)
            _assert_states_equal(out, ref_outs[i + 1], ctx)
            got = box["dur"].inc._stats.iterations
            assert got == iters[i + 1], ctx
            if mode == "host":
                assert got == ref_iters[i + 1], ctx
    assert crashes and plan.fired, f"{plan_name}: no crash fired"
    box["dur"].close()
    cold = fresh()
    _assert_states_equal(cold.recover(), outs[-1], f"cold {plan_name}")
    assert cold.inc._stats.iterations == iters[-1]
    cold.close()
