"""The port's fixpoint profiler CLI (``python -m repro_torch.observe``)
against the reference's (``repro.observe.main``) on the CPU.

``--json`` on the ``tc`` and ``monitor`` demos at size 32 in host mode,
batch and with ``--updates 3``: the per-stratum iterations and delta
trajectories, the incremental counters and the ``update.delta_rows``
histogram equal the reference's, and so do the demo's output relations
(read off each engine as the CLI drives it). Left out, by name:

- every ``wall_s``, ``share`` and the ``update.latency_s`` histogram:
  timings;
- each rule's ``spans`` and ``counters``, and ``span_count``: the
  reference records a rule pass when it is traced, once a compilation;
  the port runs eagerly and records it once a call (ROADMAP,
  "Differences by design");
- the ``memo_jit.*`` counters: the reference counts its jit memo's
  compilations; the port's memo holds device mode's captured CUDA
  graphs only (the same section).

``--trace`` writes a file that both packages' ``validate_chrome_trace``
accept, with the required spans; ``--check`` passes it and fails a copy
with a broken event, in both CLIs."""
import contextlib
import io
import itertools
import json

import numpy as np
import pytest
import torch

import repro.engine as j_engine
import repro_torch.engine as p_engine
from repro import observe as J
from repro.core.datalog import ast as j_ast
from repro.engine.observe import validate_chrome_trace as j_validate
from repro_torch import observe as P
from repro_torch.core.datalog import ast as t_ast
from repro_torch.engine.observe import validate_chrome_trace as p_validate


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _fresh_wildcards(monkeypatch):
    monkeypatch.setattr(j_ast, "_wildcard_counter", itertools.count())
    monkeypatch.setattr(t_ast, "_wildcard_counter", itertools.count())


def _recording(package, monkeypatch) -> dict:
    """Patches ``package.make_engine`` (which both CLIs import when they
    run) so that the outputs of the engine it makes are kept: the last
    ``run``, ``initialize`` or ``apply``."""
    seen = {}
    make_engine = package.make_engine

    def keep(fn, pick):
        def wrapped(*a, **kw):
            result = fn(*a, **kw)
            seen["out"] = {k: np.asarray(v) for k, v in pick(result).items()}
            return result
        return wrapped

    def recording_make_engine(*a, **kw):
        eng = make_engine(*a, **kw)
        if hasattr(eng, "apply"):
            eng.initialize = keep(eng.initialize, lambda r: r)
            eng.apply = keep(eng.apply, lambda r: r)
        else:
            eng.run = keep(eng.run, lambda r: r[0])
        return eng
    monkeypatch.setattr(package, "make_engine", recording_make_engine)
    return seen


def _run(module, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = module.main(argv)
    return rc, out.getvalue()


TIMINGS = ("wall_s", "share")
PER_CALL = ("spans", "counters")


def _structure(d: dict) -> dict:
    """The dict minus the keys named in the module docstring."""
    metrics = d["metrics"]
    return {
        "schema_version": d["schema_version"],
        "label": d["label"],
        "strata": [{k: v for k, v in s.items() if k not in TIMINGS}
                   for s in d["strata"]],
        "rules": sorted(tuple(sorted(
            (k, v) for k, v in r.items() if k not in TIMINGS + PER_CALL))
            for r in d["rules"]),
        "counters": {k: v for k, v in metrics["counters"].items()
                     if not k.startswith("memo_jit.")},
        "gauges": metrics["gauges"],
        "histograms": {k: v for k, v in metrics["histograms"].items()
                       if k != "update.latency_s"},
    }


@pytest.mark.parametrize("updates", [0, 3], ids=["batch", "updates3"])
@pytest.mark.parametrize("demo", ["tc", "monitor"])
def test_json_structure_equals_reference(demo, updates, monkeypatch):
    argv = ["--demo", demo, "--size", "32", "--json",
            "--updates", str(updates)]
    j_seen = _recording(j_engine, monkeypatch)
    rc_j, out_j = _run(J, argv)
    p_seen = _recording(p_engine, monkeypatch)
    rc_p, out_p = _run(P, argv + ["--device", "cpu"])
    assert rc_j == rc_p == 0
    want, got = json.loads(out_j), json.loads(out_p)
    assert _structure(got) == _structure(want)
    assert [s["iterations"] for s in got["strata"]]
    if updates:
        assert got["metrics"]["histograms"]["update.delta_rows"][
            "count"] == updates
    assert set(p_seen["out"]) == set(j_seen["out"])
    for rel, rows in j_seen["out"].items():
        np.testing.assert_array_equal(p_seen["out"][rel], rows, err_msg=rel)


@pytest.mark.parametrize("mode", ["host", "device"])
def test_trace_valid_in_both_packages(mode, tmp_path):
    path = tmp_path / f"trace_{mode}.json"
    rc, out = _run(P, ["--demo", "monitor", "--size", "32", "--mode", mode,
                       "--device", "cpu", "--trace", str(path)])
    assert rc == 0 and "schema ok" in out
    trace = json.loads(path.read_text())
    assert j_validate(trace) == [] and p_validate(trace) == []
    names = {e["name"] for e in trace["traceEvents"]}
    assert P.REQUIRED_SPANS[mode] <= names
    assert P.trace_errors(trace, mode) == []
    want = {"run", "stratum"} | ({"iteration", "rule"} if mode == "host"
                                 else set())
    assert P.REQUIRED_SPANS[mode] == want

    broken = tmp_path / "broken.json"
    del trace["traceEvents"][1]["ts"]
    broken.write_text(json.dumps(trace))
    for module in (J, P):
        rc, out = _run(module, ["--check", str(path)])
        assert rc == 0 and "valid Chrome trace" in out
        rc, out = _run(module, ["--check", str(broken)])
        assert rc == 1 and "missing 'ts'" in out
