"""The port's launchers of the reference examples
(``repro_torch.launch.{quickstart, program_analysis, train_lm,
gnn_relational}``) against ``examples/*.py`` on the CPU. Each reference
example is loaded from its path and driven through its own ``main``;
the test only wraps the names it calls (its ``Engine``, or its ``jax``
whose ``jit`` it steps through) to read what each run returns.

- quickstart: the batch run's and the updated relations equal the
  reference's, byte for byte.
- program_analysis (Andersen at 120 variables): both plans' ``pt`` equal
  the reference's, and a boolean-matrix fixpoint in numpy that uses no
  engine code (P <- A | Asg P | L P P | P^T S P until nothing changes).
- train_lm (``SMALL``, 3 steps) and gnn_relational (3 steps): with the
  reference's initial parameters carried across by ``params_from_numpy``,
  each step's loss within rtol 1e-5 of the reference's (the tolerance of
  ``tests/test_torch_train.py`` and ``tests/test_torch_gnn.py``); the
  sampler's subgraph for seeds 0 to 7 equal to the reference's."""
import importlib.util
import itertools
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.datalog import ast as j_ast
from repro.data import synthetic as JS
from repro.models import transformer as JT
from repro_torch.core.datalog import ast as t_ast
from repro_torch.launch import gnn_relational as PG
from repro_torch.launch import program_analysis as PA
from repro_torch.launch import quickstart as PQ
from repro_torch.launch import train_lm as PL
from repro_torch.models import transformer as T
from repro_torch.models.gnn import common as GC

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _fresh_wildcards(monkeypatch):
    """Both parsers name each ``_`` from a process-wide counter; start
    both at 0 so that the printed plans compare."""
    monkeypatch.setattr(j_ast, "_wildcard_counter", itertools.count())
    monkeypatch.setattr(t_ast, "_wildcard_counter", itertools.count())


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _sorted_rows(a) -> np.ndarray:
    a = np.asarray(a, np.int64)
    return a[np.lexsort(a.T[::-1])] if len(a) else a


def _assert_relations_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for rel in want:
        np.testing.assert_array_equal(_sorted_rows(got[rel]),
                                      _sorted_rows(want[rel]), err_msg=rel)


def _recording_engines(ex, monkeypatch) -> list:
    """Wraps the example's ``Engine`` and ``IncrementalEngine`` so that
    every ``run``/``apply`` result is appended to the returned list."""
    seen = []
    if hasattr(ex, "Engine"):
        class Engine(ex.Engine):
            def run(self, *a, **kw):
                out, stats = super().run(*a, **kw)
                seen.append({k: np.asarray(v) for k, v in out.items()})
                return out, stats
        monkeypatch.setattr(ex, "Engine", Engine)
    if hasattr(ex, "IncrementalEngine"):
        class Incremental(ex.IncrementalEngine):
            def apply(self, *a, **kw):
                out = super().apply(*a, **kw)
                seen.append({k: np.asarray(v) for k, v in out.items()})
                return out
        monkeypatch.setattr(ex, "IncrementalEngine", Incremental)
    return seen


class _JitRecorder:
    """Stands for ``jax`` in an example module: ``jit`` returns the jitted
    function wrapped to keep ``pick`` of each result; everything else is
    jax's."""

    def __init__(self, pick):
        self.losses = []
        self._pick = pick

    def jit(self, fn):
        jitted = jax.jit(fn)

        def step(*a):
            result = jitted(*a)
            self.losses.append(float(self._pick(result)))
            return result
        return step

    def __getattr__(self, name):
        return getattr(jax, name)


def test_quickstart_facts_equal_reference(monkeypatch, capsys):
    ex = _example("quickstart")
    seen = _recording_engines(ex, monkeypatch)
    ex.main()
    printed = capsys.readouterr().out
    got = PQ.main(["--device", "cpu"])
    ours = capsys.readouterr().out
    batch, updated = seen
    _assert_relations_equal(got["batch"], batch)
    _assert_relations_equal(got["updated"], updated)
    # the same plan printed, the same counts; only the wall time differs
    strip = [ln.split(", wall:")[0] for ln in printed.splitlines()]
    assert [ln.split(", wall:")[0] for ln in ours.splitlines()] == strip


def _dense_points_to(edbs: dict, n: int) -> np.ndarray:
    """Andersen's fixpoint over n x n boolean matrices, no engine code:
    P <- A | Asg P | L P P | P^T S P."""
    def matrix(rows):
        m = np.zeros((n, n), np.int64)
        m[rows[:, 0], rows[:, 1]] = 1
        return m
    a, asg, ld, st = (matrix(edbs[k]) for k in
                      ("addr", "assign", "load", "store"))
    p = a.copy()
    while True:
        nxt = ((a + asg @ p + ((ld @ p) > 0) @ p
                + ((p.T @ st) > 0) @ p) > 0).astype(np.int64)
        if np.array_equal(nxt, p):
            return np.argwhere(p)
        p = nxt


def test_program_analysis_facts_equal_reference(monkeypatch, capsys):
    ex = _example("program_analysis")
    seen = _recording_engines(ex, monkeypatch)
    ex.main()
    results = PA.main(["--device", "cpu"])
    assert "program_analysis OK" in capsys.readouterr().out
    edbs = ex.synthesize_program()
    for name in edbs:
        np.testing.assert_array_equal(PA.synthesize_program()[name],
                                      edbs[name])
    dense = _dense_points_to(edbs, 120)
    assert len(dense) == 3800
    assert len(seen) == len(results) == 2
    for want, (label, (pt, stats, _peak, _launches)) in zip(
            seen, results.items()):
        np.testing.assert_array_equal(_sorted_rows(pt), dense, err_msg=label)
        np.testing.assert_array_equal(_sorted_rows(want["pt"]), dense)
        assert stats.grow_retries == 0


def test_train_lm_small_losses_match_reference(monkeypatch, capsys):
    ex = _example("train_lm")
    steps = 3
    rec = _JitRecorder(lambda result: result[1])
    monkeypatch.setattr(ex, "jax", rec)
    monkeypatch.setattr(sys, "argv", ["train_lm.py", "--steps", str(steps)])
    ex.main()
    assert "train_lm OK" in capsys.readouterr().out
    # the example's initial parameters, carried across
    params = JT.init_params(jax.random.PRNGKey(0), ex.SMALL)
    params = T.params_from_numpy(jax.tree.map(np.asarray, params),
                                 PL.SMALL, device="cpu")
    for field in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab", "dtype", "remat"):
        assert getattr(PL.SMALL, field) == getattr(ex.SMALL, field), field
        assert getattr(PL.FULL_100M, field) == getattr(ex.FULL_100M, field)
    losses = PL.train(PL.SMALL, steps, 8, 128, torch.device("cpu"),
                      params=params)
    assert len(rec.losses) == steps
    np.testing.assert_allclose(losses, rec.losses, rtol=LOSS_RTOL)


def test_gnn_relational_losses_and_sampler_match_reference(monkeypatch,
                                                           capsys):
    from repro.configs import get_arch as jax_arch
    from repro.data.sampler import NeighborSampler
    ex = _example("gnn_relational")
    steps = 3
    rec = _JitRecorder(lambda result: result[1]["loss"])
    monkeypatch.setattr(ex, "jax", rec)
    monkeypatch.setattr(sys, "argv", ["gnn_relational.py", "--steps",
                                      str(steps)])
    ex.main()
    assert "gnn_relational OK" in capsys.readouterr().out
    params, _cfg = jax_arch("gat-cora").init_smoke(jax.random.PRNGKey(0))
    params = GC.params_from_numpy(jax.tree.map(np.asarray, params),
                                  device="cpu")
    losses = PG.train(steps, torch.device("cpu"), params=params)
    assert len(rec.losses) == steps
    np.testing.assert_allclose(losses, rec.losses, rtol=LOSS_RTOL)

    g = JS.random_graph(512, 2048, 24, n_classes=7, seed=3)
    ours = PG.graph()
    for k in g:
        if k != "labels":
            np.testing.assert_array_equal(ours[k], g[k], err_msg=k)
    want = NeighborSampler(g["senders"], g["receivers"], 512,
                           fanouts=(5, 3)).sample(np.arange(8))
    got = PG.sample_subgraph(ours)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
