"""The port's Engine (CPU, plain kernel versions) against the JAX
Engine on the narrow corpus plus CC and SSSP: byte-identical facts and
per-stratum iteration counts, with the arrangement layer on and off."""
import functools

import numpy as np
import pytest

from benchmarks.programs import CC, SSSP, equivalence_datasets
from repro.core.optimizer import compile_program as j_compile
from repro.engine import Engine as JEngine, EngineConfig as JConfig
from repro_torch.core.optimizer import compile_program as t_compile
from repro_torch.engine import Engine as TEngine, EngineConfig as TConfig

CAPS = dict(idb_cap=1 << 10, intermediate_cap=1 << 12)


def datasets() -> dict:
    """The shared equivalence corpus plus CC and SSSP (monoid programs)."""
    out = equivalence_datasets()
    rng = np.random.default_rng(5)
    out["CC"] = (CC, {"edge": rng.integers(0, 30, size=(40, 2))})
    out["SSSP"] = (SSSP, {
        "edge": np.concatenate([rng.integers(0, 30, size=(60, 2)),
                                rng.integers(1, 9, size=(60, 1))], 1),
        "source": np.array([[0]])})
    return out


@functools.lru_cache(maxsize=None)
def reference(program: str, multiword: bool = False):
    src, edbs = datasets()[program]
    engine = JEngine(j_compile(src), JConfig(kernel_backend="jnp", **CAPS))
    if multiword:
        from repro.engine.relation import force_multiword
        with force_multiword():
            out, stats = engine.run(dict(edbs))
    else:
        out, stats = engine.run(dict(edbs))
    return {k: np.asarray(v) for k, v in out.items()}, stats.iterations


def assert_port_matches(program: str, arrangements: bool = True,
                        multiword: bool = False):
    want, want_iters = reference(program, multiword)
    src, edbs = datasets()[program]
    engine = TEngine(t_compile(src), TConfig(
        device="cpu", arrangements=arrangements, **CAPS))
    if multiword:
        from repro_torch.engine.relation import force_multiword
        with force_multiword():
            out, stats = engine.run(dict(edbs))
    else:
        out, stats = engine.run(dict(edbs))
    assert out.keys() == want.keys()
    for name in want:
        assert out[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(out[name], want[name], err_msg=name)
    assert stats.iterations == want_iters
    assert stats.grow_retries == 0


NARROW = ["TC", "SG", "Reach", "Count", "Sum", "Negation", "CC", "SSSP"]


@pytest.mark.parametrize("arrangements", [True, False])
@pytest.mark.parametrize("program", NARROW)
def test_engine_matches_reference(program, arrangements):
    assert_port_matches(program, arrangements)


def test_stratum_seed_matches_reference():
    """The seeded continuation entry (the incremental engine's way in):
    each IDB's seed delta merged into its stored full, or an empty
    delta where no seed is given."""
    from repro.engine.lower import Evaluator as JEval, LowerConfig as JLow
    from repro.engine.relation import from_numpy as j_from_numpy
    from repro_torch.engine.lower import Evaluator as TEval
    from repro_torch.engine.lower import LowerConfig as TLow
    from repro_torch.engine.relation import from_arrays, to_arrays
    src, _ = datasets()["TC"]
    rng = np.random.default_rng(2)
    full = rng.integers(0, 12, size=(30, 2))
    seed = rng.integers(0, 12, size=(10, 2))
    jeng = JEngine(j_compile(src), JConfig(kernel_backend="jnp", **CAPS))
    teng = TEngine(t_compile(src), TConfig(device="cpu", **CAPS))
    cap = CAPS["idb_cap"]

    def port(j):
        return from_arrays(np.asarray(j.data), None, int(j.n),
                           device="cpu")
    for with_seed in (True, False):
        jf = j_from_numpy(full, cap)
        js = j_from_numpy(seed, cap) if with_seed else None
        jstate, jov = jeng._stratum_seed(
            {"tc": (jf, js)}, ["tc"], JEval(JLow(backend=jeng.backend)))
        tstate, tov = teng._stratum_seed(
            {"tc": (port(jf), port(js) if with_seed else None)}, ["tc"],
            TEval(TLow(backend=teng.backend)))
        assert bool(tov) == bool(jov)
        for t, j in zip(tstate["tc"], jstate["tc"]):
            data, _, n = to_arrays(t)
            np.testing.assert_array_equal(data, np.asarray(j.data))
            assert n == int(j.n)


def test_sanitizer_and_observation_leave_the_fixpoint_unchanged():
    """check_invariants validates every stored arrangement at stratum
    boundaries (on host copies), and an attached Observation records the
    span tree; neither changes facts or iteration counts."""
    from repro_torch.engine import Observation
    want, want_iters = reference("Negation")
    src, edbs = datasets()["Negation"]
    obs = Observation()
    out, stats = TEngine(t_compile(src), TConfig(
        device="cpu", check_invariants=True, observe=obs, **CAPS)).run(
        dict(edbs))
    for name in want:
        np.testing.assert_array_equal(out[name], want[name])
    assert stats.iterations == want_iters
    from repro_torch.engine.observe import _walk
    names = {s.name for root in obs.roots for s in _walk(root)}
    assert {"run", "stratum", "iteration", "rule"} <= names
    assert obs.to_dict()["span_count"] == sum(
        1 for root in obs.roots for _ in _walk(root))
