"""The graph memo of the port's device mode on the CPU, where an entry
keeps its static buffers and runs the iteration eagerly over them in
place of a replay: a second run hits and gives equal facts; results
returned earlier, and an IncrementalEngine's held environment, are
never changed by later loops over the same buffers; a structural key
seen at new capacities retraces and keeps one entry; ``jit=False``
bypasses the memo; an update stream in device mode equals batch runs
(and the reference's batch runs) at every step."""
import numpy as np
import pytest
import torch

from benchmarks.programs import CC, equivalence_datasets
from repro.core.optimizer import compile_program as j_compile
from repro.engine import Engine as JEngine
from repro.engine import EngineConfig as JConfig
from repro_torch.core.optimizer import compile_program
from repro_torch.engine import (
    Engine, EngineConfig, EngineStats, Observation, make_engine,
)
from repro_torch.engine.relation import force_multiword


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
PROGRAMS = ("TC", "Negation", "WideReach2", "CC", "SG", "Sum")


def _program(name: str):
    if name == "CC":
        rng = np.random.default_rng(3)
        return CC, {"edge": rng.integers(0, 40, size=(60, 2))}
    src, edbs = equivalence_datasets()[name]
    return src, {k: np.asarray(v) for k, v in edbs.items()}


def _shifted(edbs: dict) -> dict:
    """Other data at the same capacities: as many rows, other values."""
    return {k: (v + 1) % (int(v.max(initial=0)) + 2)
            for k, v in edbs.items()}


def _engine(src, obs=None, **cfg):
    kw = dict(CAPS, device="cpu", mode="device", observe=obs)
    kw.update(cfg)
    return Engine(compile_program(src), EngineConfig(**kw))


def _loops(stats) -> int:
    """Strata that ran the device loop (at least one iteration)."""
    return sum(1 for v in stats.iterations.values() if v > 0)


@pytest.mark.parametrize("program", PROGRAMS)
def test_second_run_hits_with_equal_facts(program):
    src, edbs = _program(program)
    obs = Observation()
    engine = _engine(src, obs)
    first, fst = engine.run(edbs)
    reg = obs.registry
    assert reg.get("memo_jit.miss") == _loops(fst)
    assert reg.get("memo_jit.hit") == 0
    second, sst = engine.run(edbs)
    assert reg.get("memo_jit.hit") == _loops(fst)
    assert reg.get("memo_jit.miss") == _loops(fst)
    assert reg.get("memo_jit.retrace") == 0
    assert sst.iterations == fst.iterations
    for name in first:
        np.testing.assert_array_equal(second[name], first[name])
    # the reference's batch run, facts and iterations
    j_out, j_stats = JEngine(j_compile(src), JConfig(
        **CAPS, mode="device", kernel_backend="jnp")).run(edbs)
    assert sst.iterations == j_stats.iterations
    for name in j_out:
        np.testing.assert_array_equal(second[name], np.asarray(j_out[name]))


@pytest.mark.parametrize("program", ["TC", "CC"])
def test_earlier_results_survive_later_loops(program):
    """The aliasing guard: a loop's state is cloned out of the static
    buffers, so the first run's arrays and environment, and what an
    IncrementalEngine holds, stay as they were while later runs and
    applies reuse the buffers."""
    src, edbs = _program(program)
    engine = _engine(src)
    first, _ = engine.run(edbs)
    kept = {k: v.copy() for k, v in first.items()}
    env = dict(engine.last_env)
    held = {k: (r.data.clone(), r.n.clone()) for k, r in env.items()}
    other, _ = engine.run(_shifted(edbs))
    assert any(not np.array_equal(other[k], kept[k]) for k in kept)
    for name in kept:
        np.testing.assert_array_equal(first[name], kept[name])
    for k, (data, n) in held.items():
        assert torch.equal(env[k].data, data) and torch.equal(env[k].n, n)

    inc = make_engine(compile_program(src), EngineConfig(
        **CAPS, device="cpu", mode="device"), incremental=True)
    snap0 = inc.initialize(edbs)
    env0 = dict(inc._env)
    held = {k: (r.data.clone(), r.n.clone()) for k, r in env0.items()}
    rows = np.asarray(edbs["edge"])
    inc.apply(inserts={"edge": rows[:6] + 1}, deletes={"edge": rows[6:9]})
    inc.apply(deletes={"edge": rows[:4]})
    for k, (data, n) in held.items():
        assert torch.equal(env0[k].data, data) and torch.equal(env0[k].n, n)
    again = inc.engine._export(env0, EngineStats())
    for name in snap0:
        np.testing.assert_array_equal(again[name], snap0[name])


def test_growth_retraces_and_keeps_one_entry_a_stratum():
    """Auto-grow captures again at the grown capacities: the structural
    key's old entry is dropped (a retrace), and run() coming back to
    its entry caps retraces again; the memo never holds two entries of
    one stratum."""
    src, edbs = _program("TC")
    obs = Observation()
    engine = _engine(src, obs, idb_cap=16, intermediate_cap=64)
    out, stats = engine.run(edbs)
    assert stats.grow_retries > 0
    reg = obs.registry
    assert reg.get("memo_jit.retrace") >= 1
    assert list(engine._graph_memo) == [("device", 0)]
    key, _ = engine._graph_memo[("device", 0)]
    assert key[2] == stats.effective_caps["idb_cap"]
    misses = reg.get("memo_jit.miss")
    engine.run(edbs)                      # from the entry caps again
    assert reg.get("memo_jit.miss") > misses
    assert len(engine._graph_memo) == 1
    want, _ = _engine(src).run(edbs)
    np.testing.assert_array_equal(out["tc"], want["tc"])


def test_carry_structure_and_multiword_are_in_the_key():
    """Other EDB capacities, or force_multiword(), change what a
    captured iteration computes with: a miss and a retrace, not a
    hit."""
    src, edbs = _program("TC")
    obs = Observation()
    engine = _engine(src, obs)
    base, _ = engine.run(edbs)
    engine.run({"edge": np.concatenate([edbs["edge"]] * 3)})
    assert obs.registry.get("memo_jit.retrace") == 1
    with force_multiword():
        wide, _ = engine.run(edbs)
    assert obs.registry.get("memo_jit.retrace") == 2
    assert obs.registry.get("memo_jit.hit") == 0
    np.testing.assert_array_equal(wide["tc"], base["tc"])


def test_jit_false_bypasses_the_memo():
    src, edbs = _program("CC")
    obs = Observation()
    engine = _engine(src, obs, jit=False)
    out, stats = engine.run(edbs)
    out2, _ = engine.run(edbs)
    assert engine._graph_memo == {}
    assert obs.registry.counters_snapshot("memo_jit") == {}
    want, wst = _engine(src).run(edbs)
    np.testing.assert_array_equal(out["cc"], want["cc"])
    np.testing.assert_array_equal(out2["cc"], want["cc"])
    assert stats.iterations == wst.iterations


def test_failed_warm_up_leaves_no_entry():
    """An exception inside the loop's first iteration leaves the memo
    without an entry; the same Engine then runs and memoizes."""
    src, edbs = _program("TC")
    engine = _engine(src)
    real = engine._stratum_iter

    def fails(*args):
        raise RuntimeError("injected")
    engine._stratum_iter = fails
    with pytest.raises(RuntimeError, match="injected"):
        engine.run(edbs)
    assert engine._graph_memo == {}
    engine._stratum_iter = real
    out, _ = engine.run(edbs)
    assert list(engine._graph_memo) == [("device", 0)]
    want, _ = _engine(src, mode="host").run(edbs)
    np.testing.assert_array_equal(out["tc"], want["tc"])


@pytest.mark.parametrize("program", ["TC", "Negation", "CC"])
def test_update_stream_in_device_mode_equals_batch_runs(program):
    """Applies replay the memo's entries, and the maintained state
    equals a batch run of the current EDBs at every step."""
    src, edbs = _program(program)
    obs = Observation()
    inc = make_engine(compile_program(src), EngineConfig(
        **CAPS, device="cpu", mode="device", observe=obs),
        incremental=True)
    batch = _engine(src)
    inc.initialize(edbs)
    rng = np.random.default_rng(11)
    name = sorted(edbs)[0]
    rows = np.asarray(edbs[name])
    dom = int(rows.max()) + 2
    for step in range(6):
        cur = inc.edbs[name]
        ins = rng.integers(0, dom, size=(3, rows.shape[1]))
        dele = cur[rng.permutation(len(cur))[:2]]
        snap = inc.apply(inserts={name: ins}, deletes={name: dele})
        want, _ = batch.run({**edbs, **{k: v for k, v in inc.edbs.items()}})
        for rel in want:
            np.testing.assert_array_equal(snap[rel], want[rel],
                                          err_msg=f"step {step} {rel}")
    assert obs.registry.get("memo_jit.hit") > 0
    assert len(inc.engine._graph_memo) <= len(inc.compiled.strata)
