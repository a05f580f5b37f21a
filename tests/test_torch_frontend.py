"""The port's copy of the front end (parser, stratifier, optimizer, IR,
analysis) produces the same plans as the JAX package's: identical
``CompiledProgram.pretty()`` for every corpus program, under the default
options and under the no-opt options of benchmarks/paper_programs.py."""
import dataclasses
import itertools

import pytest

from benchmarks import programs as P
from benchmarks.paper_programs import NOOPT, OPT
from repro.core.datalog import ast as j_ast
from repro.core.optimizer import compile_program as j_compile
from repro_torch.core.datalog import ast as t_ast
from repro_torch.core.optimizer import (
    CompileOptions as TOptions, compile_program as t_compile,
)
from repro_torch.core.optimizer import pipeline as t_pipeline

CORPUS = {name: text for name, text in vars(P).items()
          if name.isupper() and isinstance(text, str) and ".output" in text}


@pytest.fixture(autouse=True)
def _fresh_wildcard_names(monkeypatch):
    """Both parsers name each ``_`` from a process-wide counter, so a
    plan's printed names depend on what the process parsed before;
    start both counters at 0 so the plans compare."""
    monkeypatch.setattr(j_ast, "_wildcard_counter", itertools.count())
    monkeypatch.setattr(t_ast, "_wildcard_counter", itertools.count())


@pytest.fixture(autouse=True)
def _force_port_verify():
    """The port's IR verifier after every pass, as conftest.py forces
    the reference's."""
    prev = t_pipeline.FORCE_VERIFY
    t_pipeline.FORCE_VERIFY = True
    try:
        yield
    finally:
        t_pipeline.FORCE_VERIFY = prev


def test_corpus_is_complete():
    assert {"TC", "REACH", "CC", "SSSP", "WIDE_REACH2"} <= set(CORPUS)
    assert len(CORPUS) >= 15


@pytest.mark.parametrize("opts", ["opt", "noopt"])
@pytest.mark.parametrize("program", sorted(CORPUS))
def test_plans_identical(program, opts):
    j_opts = OPT if opts == "opt" else NOOPT
    t_opts = TOptions(**dataclasses.asdict(j_opts))
    want = j_compile(CORPUS[program], j_opts)
    got = t_compile(CORPUS[program], t_opts)
    assert got.pretty() == want.pretty()
    assert got.arities == want.arities
    assert got.monoid_idbs == want.monoid_idbs


def test_stored_arity_ceiling_rejected_by_both():
    """An IDB storing more than MAX_STORED_COLUMNS columns fails at
    compile time in both front ends."""
    cols = ", ".join(f"x{i}" for i in range(9))
    src = f".input e\n.output w\nw({cols}) :- e({cols}).\n"
    with pytest.raises(Exception) as j_err:
        j_compile(src)
    with pytest.raises(Exception) as t_err:
        t_compile(src)
    assert type(t_err.value).__name__ == type(j_err.value).__name__
