"""The port's IR lint CLI (``python -m repro_torch.analysis``) against the
reference's (``repro.analysis.main``) on the CPU: the same stdout, text
for text, and the same exit code over the shared corpus, over one
program file under the default, ``--no-planner`` and ``--no-sip``
options, for a program that fails to compile, and for a program whose
compiled IR breaks the verifier's contract (a rule root narrower than
its head, made after the compile as ``tests/test_analysis.py`` makes
its malformed corpus)."""
import contextlib
import io
import itertools

import pytest

from repro import analysis as J
from repro.core import ir as JI
from repro.core.datalog import ast as j_ast
from repro_torch import analysis as P
from repro_torch.core import ir as PI
from repro_torch.core.datalog import ast as t_ast

PROGRAM = """
.input edge
.input source
.input blocked
.output reach
reach(x) :- source(x).
reach(y) :- reach(x), edge(x, y), !blocked(y).
.output cc
cc(x, MIN(x)) :- edge(x, _).
cc(y, MIN(y)) :- edge(_, y).
cc(x, MIN(i)) :- edge(y, x), cc(y, i).
cc(x, MIN(i)) :- edge(x, y), cc(y, i).
.output tri
tri(x, z) :- edge(x, y), edge(y, z), edge(z, x).
"""

NOT_STRATIFIABLE = """
.input e
.output t
t(x, y) :- e(x, y), !t(y, x).
"""


@pytest.fixture(autouse=True)
def _fresh_wildcards(monkeypatch):
    """Both parsers name each ``_`` from a process-wide counter; start
    both at 0 so that the printed plans compare."""
    monkeypatch.setattr(j_ast, "_wildcard_counter", itertools.count())
    monkeypatch.setattr(t_ast, "_wildcard_counter", itertools.count())


def _run(module, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = module.main(argv)
    return rc, out.getvalue()


def _both(argv, monkeypatch):
    rc_j, out_j = _run(J, argv)
    monkeypatch.setattr(t_ast, "_wildcard_counter", itertools.count())
    rc_p, out_p = _run(P, argv)
    return (rc_j, out_j), (rc_p, out_p)


def test_corpus_text_equal(monkeypatch):
    want, got = _both(["--corpus"], monkeypatch)
    assert got == want
    assert got[0] == 0 and got[1].rstrip().endswith(
        "clean: 0 violation(s) total")
    assert got[1].count("== paper:") >= 5


@pytest.mark.parametrize("flags", [[], ["--no-planner"], ["--no-sip"]],
                         ids=["default", "no-planner", "no-sip"])
def test_program_file_text_equal(flags, tmp_path, monkeypatch):
    path = tmp_path / "program.dl"
    path.write_text(PROGRAM)
    want, got = _both([str(path)] + flags, monkeypatch)
    assert got == want
    assert got[0] == 0


def test_compile_failure_exits_nonzero(tmp_path, monkeypatch):
    path = tmp_path / "negcycle.dl"
    path.write_text(NOT_STRATIFIABLE)
    want, got = _both([str(path)], monkeypatch)
    assert got == want
    assert got[0] == 1 and "COMPILE FAILED" in got[1]


def _narrowing(module, ir):
    """``module.compile_program`` with every first rule root cut to one
    column, below its head's arity."""
    compile_program = module.compile_program

    def compile_narrowed(src, options=None):
        cp = compile_program(src, options)
        sp = cp.strata[0]
        p = sp.plans[0]
        sp.plans[0] = ir.RulePlan(p.head, ir.Map(p.root, p.root.schema[:1]),
                                  p.variant, p.source)
        return cp
    return compile_narrowed


def test_verifier_violation_exits_nonzero(tmp_path, monkeypatch):
    path = tmp_path / "program.dl"
    path.write_text(PROGRAM)
    monkeypatch.setattr(J, "compile_program", _narrowing(J, JI))
    monkeypatch.setattr(P, "compile_program", _narrowing(P, PI))
    want, got = _both([str(path)], monkeypatch)
    assert got == want
    assert got[0] == 1 and "VIOLATION" in got[1] and "head-arity" in got[1]
