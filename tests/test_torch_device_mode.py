"""The port's device mode against the JAX Engine's ``mode="device"``
(``kernel_backend="jnp"``) on the CPU, where the port runs the same loop
as on the card without the CUDA graph: identical facts, per-stratum
iteration counts and delta logs on the narrow corpus plus CC and SSSP
and on a wide program under force_multiword(); the loop's contract (at
least one iteration, no per-iteration log, a quiet stop at max_iters);
an overflow that grows and matches; a carry whose structure changes,
which raises; and the sanitizer and observation, which change
nothing."""
import functools

import numpy as np
import pytest
import torch

from repro.core.optimizer import compile_program as j_compile
from repro.engine import Engine as JEngine, EngineConfig as JConfig
from repro_torch.core.optimizer import compile_program as t_compile
from repro_torch.engine import Engine as TEngine, EngineConfig as TConfig
from repro_torch.engine import Observation
from repro_torch.engine.observe import _walk
from repro_torch.engine.relation import Relation

from test_torch_engine import CAPS, NARROW, datasets

VARIANTS = {
    "plain": {},
    "empty": {"edbs": {"edge": np.zeros((0, 2), np.int64)}},
    "max_iters=2": {"cfg": {"max_iters": 2}},
}


def _case(program: str, variant: str):
    src, edbs = datasets()[program]
    v = VARIANTS[variant]
    return src, dict(v.get("edbs", edbs)), v.get("cfg", {})


@functools.lru_cache(maxsize=None)
def reference(program: str, variant: str = "plain",
              multiword: bool = False):
    src, edbs, extra = _case(program, variant)
    engine = JEngine(j_compile(src), JConfig(
        kernel_backend="jnp", mode="device", **CAPS, **extra))
    if multiword:
        from repro.engine.relation import force_multiword
        with force_multiword():
            out, stats = engine.run(edbs)
    else:
        out, stats = engine.run(edbs)
    return ({k: np.asarray(v) for k, v in out.items()}, stats.iterations,
            stats.delta_sizes)


def port(program: str, variant: str = "plain", multiword: bool = False,
         observe=None, **caps):
    src, edbs, extra = _case(program, variant)
    engine = TEngine(t_compile(src), TConfig(
        device="cpu", mode="device", observe=observe,
        **{**CAPS, **caps}, **extra))
    if multiword:
        from repro_torch.engine.relation import force_multiword
        with force_multiword():
            return engine.run(edbs)
    return engine.run(edbs)


def assert_matches(program: str, variant: str = "plain",
                   multiword: bool = False, **caps):
    want, want_iters, want_log = reference(program, variant, multiword)
    out, stats = port(program, variant, multiword, **caps)
    assert out.keys() == want.keys()
    for name in want:
        assert out[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(out[name], want[name], err_msg=name)
    assert stats.iterations == want_iters
    assert stats.delta_sizes == want_log
    return stats


@pytest.mark.parametrize("program", NARROW)
def test_device_mode_matches_reference(program):
    assert assert_matches(program).grow_retries == 0


def test_device_mode_force_multiword_matches_reference():
    assert_matches("WideReach", multiword=True)


def test_empty_edb_runs_one_iteration():
    """The carry starts with any_delta = True: one iteration on an
    empty EDB, where host mode runs none."""
    stats = assert_matches("TC", "empty")
    assert stats.iterations == {"s0": 1}


def test_no_per_iteration_log_and_one_post_hoc_span():
    obs = Observation()
    out, stats = port("TC", observe=obs)
    assert stats.delta_sizes == {"s0": []}
    assert stats.iterations == reference("TC")[1]
    names = [s.name for root in obs.roots for s in _walk(root)]
    assert "iteration" not in names
    loops = [s for root in obs.roots for s in _walk(root)
             if s.name == "fixpoint-loop"]
    assert [s.attrs["detail"] for s in loops] == ["post-hoc"]


def test_max_iters_stops_quietly_with_the_partial_fixpoint():
    stats = assert_matches("TC", "max_iters=2")
    assert stats.iterations == {"s0": 2}
    full = reference("TC")[0]["tc"]
    assert len(reference("TC", "max_iters=2")[0]["tc"]) < len(full)
    src, edbs, _ = _case("TC", "plain")
    with pytest.raises(RuntimeError, match="no fixpoint"):
        TEngine(t_compile(src), TConfig(device="cpu", max_iters=2,
                                        **CAPS)).run(edbs)


def test_overflow_grows_and_matches():
    """Caps far below the fixpoint's: the loop raises overflow, run()
    doubles the caps and runs again, and the result is the
    reference's."""
    stats = assert_matches("TC", idb_cap=1 << 6, intermediate_cap=1 << 7)
    assert stats.grow_retries >= 2
    assert stats.effective_caps["idb_cap"] > 1 << 6


def test_carry_that_changes_structure_raises(monkeypatch):
    """The loop carry keeps each relation's order witness, capacity,
    arity and val presence, as the reference's while_loop requires."""
    src, edbs = datasets()["TC"]
    engine = TEngine(t_compile(src), TConfig(device="cpu", mode="device",
                                             **CAPS))
    real = engine._stratum_iter

    def reordered(*args):
        state, ovf = real(*args)
        full, delta = state["tc"]
        state["tc"] = (full, Relation(delta.data, delta.val, delta.n,
                                      order=(1, 0)))
        return state, ovf
    monkeypatch.setattr(engine, "_stratum_iter", reordered)
    with pytest.raises(TypeError, match="tc delta changed"):
        engine.run(edbs)

    def shrunk(*args):
        state, ovf = real(*args)
        full, delta = state["tc"]
        state["tc"] = (Relation(full.data[:8], None, full.n), delta)
        return state, ovf
    monkeypatch.setattr(engine, "_stratum_iter", shrunk)
    with pytest.raises(TypeError, match="tc full changed"):
        engine.run(edbs)


def test_device_mode_on_cuda_refuses_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src, _ = datasets()["TC"]
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine(t_compile(src), TConfig(mode="device", **CAPS))


def test_sanitizer_and_observation_leave_device_mode_unchanged():
    """check_invariants validates every stored arrangement at stratum
    boundaries and an Observation records spans; in device mode neither
    changes facts, iterations or delta logs."""
    want, want_iters, want_log = reference("Negation")
    src, edbs, _ = _case("Negation", "plain")
    out, stats = TEngine(t_compile(src), TConfig(
        device="cpu", mode="device", check_invariants=True,
        observe=Observation(), **CAPS)).run(edbs)
    for name in want:
        np.testing.assert_array_equal(out[name], want[name])
    assert (stats.iterations, stats.delta_sizes) == (want_iters, want_log)
