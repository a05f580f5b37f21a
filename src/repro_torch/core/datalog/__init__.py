from repro_torch.core.datalog.ast import (
    Var, Const, Wildcard, Atom, Comparison, Aggregate, Rule, Program,
)
from repro_torch.core.datalog.parser import parse_program, parse_rule
from repro_torch.core.datalog.stratify import stratify, Stratum

__all__ = [
    "Var", "Const", "Wildcard", "Atom", "Comparison", "Aggregate", "Rule",
    "Program", "parse_program", "parse_rule", "stratify", "Stratum",
]
