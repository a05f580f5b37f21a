"""``python -m repro_torch.analysis`` — static IR lint for Datalog programs,
after ``repro.analysis``.

Compiles a program (or the shared benchmark corpus) with the port's
front end, prints the ``core.analysis`` verifier report and per-rule
worst-case bounds, and exits nonzero on any verifier violation or
failed compile. The output is the reference CLI's, line for line.

Usage::

    python -m repro_torch.analysis path/to/program.dl     # one source file
    python -m repro_torch.analysis --corpus               # shared corpus
    python -m repro_torch.analysis --corpus --no-planner  # listing order

The corpus is ``benchmarks/programs.py`` at the repository root (its
equivalence datasets and the Table-1 programs at scale 0.25, sizes only):
a numpy-only file, loaded from its path so that the port imports no
module of the ``benchmarks`` package. Needs no card.
"""
from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path

from repro_torch.core.analysis import analyze_program, verify_program
from repro_torch.core.optimizer.pipeline import CompileOptions, compile_program

CORPUS = Path(__file__).resolve().parents[2] / "benchmarks" / "programs.py"


def _lint_one(name: str, src: str, sizes: dict[str, int] | None,
              options: CompileOptions) -> int:
    """Compile + verify + bound one program; returns violation count."""
    try:
        compiled = compile_program(src, options)
    except Exception as e:
        print(f"== {name}: COMPILE FAILED ==")
        print(f"  {e}")
        return 1
    diags = verify_program(compiled, pass_name="final")
    report = analyze_program(compiled, sizes)
    status = "FAIL" if diags else "ok"
    print(f"== {name}: {status} "
          f"({len(diags)} violation(s), "
          f"{len(report.rules)} rule plan(s), "
          f"peak bound 2^{report.log2_peak:.1f}) ==")
    for d in diags:
        print(f"  VIOLATION: {d}")
    print(report.pretty())
    return len(diags)


def _corpus_module():
    spec = importlib.util.spec_from_file_location("_flowlog_corpus", CORPUS)
    if spec is None or not CORPUS.is_file():
        raise FileNotFoundError(f"the corpus file {CORPUS} is missing")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _corpus():
    """The shared benchmark corpus: equivalence datasets + the Table-1
    paper programs (scale 0.25: only sizes matter here)."""
    programs = _corpus_module()
    for name, (src, edbs) in programs.equivalence_datasets().items():
        yield name, src, {k: len(v) for k, v in edbs.items()}
    for name, (src, edbs, _out) in programs.make_datasets(0.25).items():
        yield f"paper:{name}", src, {k: len(v) for k, v in edbs.items()}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static IR verifier + worst-case plan analyzer")
    ap.add_argument("program", nargs="?",
                    help="Datalog source file to lint")
    ap.add_argument("--corpus", action="store_true",
                    help="lint the shared benchmark corpus instead")
    ap.add_argument("--no-planner", action="store_true",
                    help="use listing order instead of the structural "
                         "planner")
    ap.add_argument("--no-sip", action="store_true",
                    help="disable sip semijoin reduction")
    ap.add_argument("--default-size", type=int, default=1000,
                    help="assumed row count for relations without data "
                         "(default 1000)")
    args = ap.parse_args(argv)

    options = CompileOptions(use_planner=not args.no_planner,
                             use_sip=not args.no_sip)
    # the final whole-program report below is THE check; per-pass
    # raising inside compile_program would hide the printed report
    options.verify = False

    violations = 0
    if args.corpus:
        for name, src, sizes in _corpus():
            violations += _lint_one(name, src, sizes, options)
    elif args.program:
        with open(args.program) as f:
            src = f.read()
        violations += _lint_one(args.program, src, None, options)
    else:
        ap.error("give a program file or --corpus")
    print(f"\n{'FAILED' if violations else 'clean'}: "
          f"{violations} violation(s) total")
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
