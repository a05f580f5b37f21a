"""The port's sharded engine (``repro_torch.engine.shard``) on the CPU,
held against the JAX package.

In the full suite JAX has one CPU device before the reference's sharded
tests could force eight, so the port's ShardedEngine is held against the
reference's unsharded ``Engine``, which the reference's contract makes
byte-identical at every shard count: facts, dtypes and per-stratum
iteration counts and delta logs, over the corpus plus CC and SSSP, at
1, 2, 4 and 8 shards in host mode (device mode in
``tests/test_torch_shard_device.py``), and the reference's own sharded
cases (a monoid lattice, negation, skewed keys, empty shards, an empty
EDB). Hash placement is held against ``repro.engine.shard.shard_of``
(plain jnp, one device), and the per-shard live counts after every
stratum against the reference's ShardedEngine itself, in a subprocess
that forces eight host devices. Then the scatter/gather seam, the
sanitizer under shards, the shard group (an exception in one shard, the
same bytes every run, the all-to-all byte count against the buffers
exchanged), the factory and the mesh. Sizes are the reference corpus's
(tens of rows); torch runs on one thread."""
import functools
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks.programs import CC, TC
from repro.core.optimizer import compile_program as j_compile
from repro.engine import Engine as JEngine, EngineConfig as JConfig
from repro_torch.core.optimizer import compile_program as t_compile
from repro_torch.engine import Engine as TEngine, EngineConfig as TConfig
from repro_torch.engine import make_engine
from repro_torch.engine.observe import REGISTRY
from repro_torch.engine.relation import PAD, from_numpy
from repro_torch.engine.shard import (
    ShardGroup, ShardedEngine, ShardedRelation, shard_of,
)
from repro_torch.launch.mesh import make_shard_mesh

from test_torch_engine import CAPS, datasets, reference

ROOT = Path(__file__).resolve().parents[1]
SHARD_COUNTS = (1, 2, 4, 8)
PROGRAMS = sorted(datasets())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: under a parallel run the workers share the
    cores, and torch's idle OpenMP threads spinning on an oversubscribed
    host make such ops tens of times slower."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def sharded(src: str, shards: int, **cfg) -> ShardedEngine:
    """A ShardedEngine itself (not make_engine), so one shard runs the
    sharded driver too."""
    return ShardedEngine(t_compile(src), TConfig(
        device="cpu", shards=shards, **{**CAPS, **cfg}))


def assert_same(out: dict, stats, want: dict, want_iters: dict,
                want_log=None) -> None:
    assert out.keys() == want.keys()
    for name in want:
        assert out[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(out[name], want[name], err_msg=name)
    assert stats.iterations == want_iters
    if want_log is not None:
        assert stats.delta_sizes == want_log
    assert stats.grow_retries == 0


def run_sharded(src: str, edbs: dict, shards: int, **cfg):
    engine = sharded(src, shards, **cfg)
    try:
        return engine.run({k: np.asarray(v) for k, v in edbs.items()})
    finally:
        engine.close()


# -- hash placement ----------------------------------------------------------

@pytest.mark.parametrize("shards", (1, 2, 3, 4, 8))
@pytest.mark.parametrize("arity", range(1, 7))
def test_shard_of_matches_reference(arity, shards):
    """Row for row, over values spanning int32 (negatives included),
    dead rows (-> S) and key subsets."""
    import jax.numpy as jnp
    from repro.engine.shard import shard_of as j_shard_of
    rng = np.random.default_rng(100 * arity + shards)
    info = np.iinfo(np.int32)
    rows = rng.integers(info.min, info.max, size=(257, arity),
                        dtype=np.int64, endpoint=True).astype(np.int32)
    rows[:4] = np.array([info.min, -1, 0, info.max], np.int32)[:, None]
    live = rng.random(257) < 0.9
    for cols in {tuple(range(arity)), (arity - 1,), tuple(range(0, arity,
                                                                2))}:
        want = np.asarray(j_shard_of(jnp.asarray(rows), cols,
                                     jnp.asarray(live), shards))
        got = shard_of(torch.from_numpy(rows), cols,
                       torch.from_numpy(live), shards)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(cols))


# -- fixpoints against the reference ------------------------------------------

@pytest.mark.parametrize("shards", SHARD_COUNTS)
@pytest.mark.parametrize("program", PROGRAMS)
def test_sharded_fixpoint_matches_reference(program, shards):
    """Host mode: the reference's facts, iterations and delta logs."""
    want, want_iters = reference(program)
    src, edbs = datasets()[program]
    out, stats = run_sharded(src, edbs, shards)
    assert_same(out, stats, want, want_iters, delta_log(program))


@functools.lru_cache(maxsize=None)
def delta_log(program: str) -> dict:
    """The unsharded port's per-iteration delta sizes (the reference's
    are held in tests/test_torch_engine.py's neighbours)."""
    src, edbs = datasets()[program]
    engine = TEngine(t_compile(src), TConfig(device="cpu", **CAPS))
    return engine.run(dict(edbs))[1].delta_sizes


def _reference_on(src: str, edbs: dict):
    out, stats = JEngine(j_compile(src), JConfig(
        kernel_backend="jnp", **CAPS)).run(dict(edbs))
    return {k: np.asarray(v) for k, v in out.items()}, stats.iterations


# the reference's own sharded cases (tests/test_sharded.py)
CASES = {
    "lattice": (CC, lambda: {"edge": np.random.default_rng(3).integers(
        0, 30, size=(50, 2))}, (2, 8)),
    "skewed": (TC, lambda: {"edge": np.stack(
        [np.zeros(30, int), np.arange(30)], axis=1)}, (8,)),
    "empty-shards": (TC, lambda: {"edge": np.array([[1, 2], [2, 3]])},
                     (8,)),
    "empty-edb": (TC, lambda: {"edge": np.zeros((0, 2), int)}, (4,)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_reference_sharded_cases(case):
    """A MIN lattice combining across shards, every join key on one
    shard, fewer rows than shards, an empty EDB; negation is in the
    corpus above."""
    src, make, counts = CASES[case]
    want, want_iters = _reference_on(src, make())
    for shards in counts:
        out, stats = run_sharded(src, make(), shards)
        assert_same(out, stats, want, want_iters)


# -- placement against the reference's ShardedEngine --------------------------

_PLACEMENT = r"""
import json, sys
sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1], sys.argv[1] + "/tests"]
from benchmarks.hostdevices import force_host_device_count
force_host_device_count(8)
import numpy as np
from repro.core.optimizer import compile_program
from repro.engine import EngineConfig
from repro.engine.shard import ShardedEngine
from test_torch_shard import CAPS, placement_datasets

out = {}
for program, shards in json.loads(sys.argv[2]):
    src, edbs = placement_datasets()[program]
    eng = ShardedEngine(compile_program(src), EngineConfig(
        kernel_backend="jnp", shards=shards, **CAPS))
    counts = {}
    real = eng._run_stratum

    def record(sp, env_rels, stats, stratum_key, init_state=None):
        env = real(sp, env_rels, stats, stratum_key, init_state)
        for name in sorted(sp.idbs):
            counts[f"{stratum_key}/{name}"] = [
                int(x) for x in np.asarray(env[(name, "full")].n)]
        return env

    eng._run_stratum = record
    eng.run(dict(edbs))
    out[f"{program}/{shards}"] = counts
print(json.dumps(out))
"""

PLACEMENT_CASES = [("TC", 2), ("CC", 8), ("Negation", 2), ("WideJoin", 8),
                   ("TC-spread", 8), ("SSSP-spread", 2)]


def placement_datasets() -> dict:
    """The corpus, plus TC and SSSP over vertex ids spread across int32:
    the reference's placement (hash bits 33 and up, modulo S) sends every
    row keyed by one small value to one shard when S is a power of two,
    so spread ids are what put rows on several shards."""
    out = datasets()
    for name in ("TC", "SSSP"):
        src, edbs = out[name]
        spread = {}
        for rel, rows in edbs.items():
            rows = np.array(rows, np.int64)
            ids = rows[:, :2] if rows.shape[1] > 1 else rows
            ids[:] = (ids * 2654435761 % (1 << 31)) - (1 << 30)
            spread[rel] = rows
        out[f"{name}-spread"] = (src, spread)
    return out


def test_per_shard_counts_match_the_sharded_reference():
    """After every stratum, each IDB's live rows per shard equal the
    reference ShardedEngine's (8 forced host devices, a subprocess)."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    res = subprocess.run(
        [sys.executable, "-c", _PLACEMENT, str(ROOT),
         json.dumps(PLACEMENT_CASES)],
        capture_output=True, text=True, timeout=600, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    for program, shards in PLACEMENT_CASES:
        src, edbs = placement_datasets()[program]
        engine = sharded(src, shards)
        counts = {}
        real = engine._run_stratum

        def record(sp, env_rels, stats, stratum_key, init_state=None):
            env = real(sp, env_rels, stats, stratum_key, init_state)
            for name in sorted(sp.idbs):
                counts[f"{stratum_key}/{name}"] = [
                    int(x) for x in env[(name, "full")].n]
            return env

        engine._run_stratum = record
        engine.run(dict(edbs))
        engine.close()
        assert counts == want[f"{program}/{shards}"], (program, shards)
        assert sum(sum(v) for v in counts.values()) > 0
    spread = want["TC-spread/8"]["s0/tc"]
    assert sum(1 for n in spread if n) >= 4, spread


# -- the scatter/gather seam and the sanitizer --------------------------------

def _roundtrip_cases() -> dict:
    """Arbitrary arrangements: PAD tails, a relation full to capacity,
    empty, multi-word (5-column) keys, and payload values."""
    rng = np.random.default_rng(9)
    full_rows = np.unique(rng.integers(0, 99, size=(40, 2)), axis=0)[:16]
    val_rows = np.unique(rng.integers(0, 30, size=(25, 1)), axis=0)
    return {
        "sparse": from_numpy(rng.integers(0, 50, size=(20, 2)), 64,
                             device="cpu"),
        "full": from_numpy(full_rows, 16, device="cpu"),
        "empty": from_numpy(np.zeros((0, 3), int), 32, device="cpu"),
        "wide": from_numpy(rng.integers(0, 9, size=(30, 5)), 64,
                           device="cpu"),
        "valued": from_numpy(
            val_rows, 64, val=rng.integers(0, 100, size=(len(val_rows),)),
            val_identity=0, dedupe=False, device="cpu"),
    }


def _assert_roundtrip(engine: ShardedEngine, name: str, rel) -> None:
    sh = engine._scatter_env({name: rel})[name]
    assert isinstance(sh, ShardedRelation)
    assert sh.num_shards == engine.num_shards
    assert sh.capacity == rel.capacity
    back = engine._host_relation(sh)
    assert back.capacity == rel.capacity
    assert int(back.n) == int(rel.n)
    np.testing.assert_array_equal(back.data.numpy(), rel.data.numpy())
    if rel.val is not None:
        n = int(rel.n)
        np.testing.assert_array_equal(back.val[:n].numpy(),
                                      rel.val[:n].numpy())


@pytest.mark.parametrize("shards", SHARD_COUNTS)
def test_scatter_gather_roundtrip(shards):
    """``_host_relation`` after ``_scatter_env`` is the identity on
    arbitrary arrangements (every export and incremental seed crosses
    it), and on a MIN relation with its lattice payload."""
    engine = sharded(TC, shards)
    for case, rel in _roundtrip_cases().items():
        _assert_roundtrip(engine, case, rel)
    engine.close()
    engine = sharded(CC, shards)
    rng = np.random.default_rng(5)
    rows = np.unique(rng.integers(0, 40, size=(30, 1)), axis=0)
    _assert_roundtrip(engine, "cc", from_numpy(
        rows, 64, val=rng.integers(0, 40, size=(len(rows),)),
        val_identity=np.iinfo(np.int32).max, dedupe=False, device="cpu"))
    engine.close()


def test_host_relation_preserves_capacity():
    """A sparse relation gathered keeps its capacity (the reference once
    shrank it to the row count, and the next merge overflowed)."""
    from repro_torch.engine import relops as R
    from repro_torch.engine.semiring import PRESENCE
    engine = sharded(TC, 2)
    rng = np.random.default_rng(1)
    rel = from_numpy(rng.integers(0, 10, size=(3, 2)), 1024, device="cpu")
    back = engine._host_relation(engine._scatter_env({"r": rel})["r"])
    assert back.capacity == 1024
    delta = from_numpy(np.stack([np.arange(500), 1 + np.arange(500)],
                                axis=1), 1024, device="cpu")
    merged, ov = R.merge(back, delta, PRESENCE, 1024)
    assert not bool(ov) and int(merged.n) >= 500
    engine.close()


def test_sanitizer_finds_no_stray_row_and_reports_a_foreign_one():
    """check_invariants=True under shards: every block valid and homed;
    a block edited to hold another shard's row is reported."""
    from repro_torch.core.analysis.sanitize import SanitizerError
    src, edbs = datasets()["TC"]
    engine = sharded(src, 4, check_invariants=True)
    out, _ = engine.run(dict(edbs))
    np.testing.assert_array_equal(out["tc"], reference("TC")[0]["tc"])
    rel = engine.last_env[("tc", "full")]
    counts = [int(n) for n in rel.n]
    s = max(range(4), key=counts.__getitem__)
    t = (s + 1) % 4
    # shard t's block becomes one of shard s's rows: a valid arrangement
    # on its own, on the wrong shard
    data = torch.full_like(rel.blocks[t].data, PAD)
    data[0] = rel.blocks[s].data[0]
    blocks = list(rel.blocks)
    blocks[t] = type(blocks[t])(data, None, torch.tensor(1, dtype=torch.int32))
    with pytest.raises(SanitizerError,
                       match=f"homed to shard {s} but stored on shard {t}"):
        engine._sanitize_env({("tc", "full"): ShardedRelation(blocks)},
                             "test")
    engine.close()


# -- the group ----------------------------------------------------------------

def test_an_exception_in_one_shard_reaches_the_caller():
    """A shard's body that raises aborts the barrier the other shards
    wait at; the run raises it within seconds, no worker is left
    waiting, and the engine runs again; close() ends the workers."""
    from repro_torch.engine import shard as S
    src, edbs = datasets()["TC"]
    engine = sharded(src, 4)
    real = engine._stratum_iter

    def failing(*args):
        if S._rank() == 2:
            raise ValueError("shard 2 failed")
        return real(*args)

    engine._stratum_iter = failing
    box = {}

    def call():
        try:
            engine.run(dict(edbs))
        except ValueError as e:
            box["err"] = e

    t = threading.Thread(target=call, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "the run hangs after a shard failed"
    assert "shard 2 failed" in str(box.get("err"))
    assert engine.group._barrier.n_waiting == 0
    engine._stratum_iter = real
    out, stats = engine.run(dict(edbs))
    np.testing.assert_array_equal(out["tc"], reference("TC")[0]["tc"])
    engine.close()
    for w in engine.group.threads:
        w.join(timeout=10)
        assert not w.is_alive()


def test_repeated_runs_give_identical_bytes():
    """The same bytes run after run, also with the interpreter switching
    threads every microsecond (shards interleave at every bytecode)."""
    src, edbs = datasets()["SSSP"]
    engine = sharded(src, 8)
    first, s1 = engine.run(dict(edbs))
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(2):
            again, s2 = engine.run(dict(edbs))
            assert again.keys() == first.keys()
            for k in first:
                assert again[k].tobytes() == first[k].tobytes()
            assert s2.iterations == s1.iterations
    finally:
        sys.setswitchinterval(prev)
    np.testing.assert_array_equal(first["dist"], reference("SSSP")[0]["dist"])
    engine.close()


def test_launch_counts_lose_no_update():
    """The kernels' launch counters take every shard thread's increments:
    more threads than cores, a microsecond switch interval."""
    from repro_torch.kernels import _build
    counts = {"probe": 0}
    threads = [threading.Thread(target=lambda: [
        _build.count_launch(counts, "probe") for _ in range(2000)])
        for _ in range((os.cpu_count() or 4) + 4)]
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(prev)
    assert counts["probe"] == 2000 * len(threads)


def test_all_to_all_bytes_count_the_buffers_exchanged(monkeypatch):
    """``shard.all_to_all.bytes`` (the reference's formula, S * cap *
    planes * 4 a launch, one shard's) equals the bytes of the send
    buffers shard 0 handed the group; launches and slots likewise."""
    sent = {"bytes": 0, "launches": 0, "slots": 0}
    real = ShardGroup.all_to_all

    def counting(self, rank, sends):
        if rank == 0:
            sent["launches"] += 1
            sent["bytes"] += sum(t.numel() * t.element_size()
                                 for t in sends)
            sent["slots"] += sends[0].shape[0] * sends[0].shape[1]
        return real(self, rank, sends)

    monkeypatch.setattr(ShardGroup, "all_to_all", counting)
    src, edbs = datasets()["CC"]
    before = {k: REGISTRY.get(f"shard.all_to_all.{k}") for k in sent}
    out, _ = run_sharded(src, edbs, 4)
    np.testing.assert_array_equal(out["cc"], reference("CC")[0]["cc"])
    got = {k: REGISTRY.get(f"shard.all_to_all.{k}") - before[k]
           for k in sent}
    assert sent["launches"] > 0
    assert got == sent


# -- the factory and the mesh -------------------------------------------------

def test_make_engine_selects_the_sharded_driver(monkeypatch):
    cp = t_compile(TC)
    assert type(make_engine(cp, TConfig(device="cpu"))) is TEngine
    assert type(make_engine(cp, TConfig(device="cpu", shards=1))) is TEngine
    engine = make_engine(cp, TConfig(device="cpu", shards=2))
    assert isinstance(engine, ShardedEngine) and engine.num_shards == 2
    assert engine.mesh.devices == (torch.device("cpu"),) * 2
    engine.close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert TConfig(shards=2).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        make_engine(cp, TConfig(shards=2))


def test_shard_mesh_validation():
    with pytest.raises(ValueError):
        make_shard_mesh(0)
    with pytest.raises(ValueError):
        make_shard_mesh(2, ["cpu"] * 3)
    mesh = make_shard_mesh(3, "cpu")
    assert mesh.axis_names == ("shards",) and mesh.size == 3
    with pytest.raises(ValueError, match="config.shards"):
        sharded(TC, 2, shard_mesh=mesh)
    out, _ = run_sharded(TC, datasets()["TC"][1], 3, shard_mesh=mesh)
    np.testing.assert_array_equal(out["tc"], reference("TC")[0]["tc"])


def test_blocks_keep_the_partition_invariant():
    """After a run every block of every IDB is sorted, distinct,
    PAD-tailed and homed by its full-row hash."""
    src, edbs = datasets()["SG"]
    engine = sharded(src, 4)
    engine.run(dict(edbs))
    rel = engine.last_env[("sg", "full")]
    assert sum(int(n) for n in rel.n) > 0
    for s in range(rel.num_shards):
        block = rel.blocks[s].data.numpy()
        n = int(rel.n[s])
        assert np.all(block[n:] == PAD)
        live = block[:n]
        if n:
            order = np.lexsort(live.T[::-1])
            assert np.array_equal(order, np.arange(n))
            assert np.unique(live, axis=0).shape[0] == n
            dest = shard_of(torch.from_numpy(live), tuple(range(2)),
                            torch.ones(n, dtype=torch.bool), 4)
            assert bool(torch.all(dest == s))
    engine.close()
