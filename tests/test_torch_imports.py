"""The port imports torch, numpy and the standard library only — never
JAX, the JAX package or the benchmarks — and its entry points refuse to
fall back to the CPU when they were asked for the card."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_every_module_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(len(names), bad)\n"
        "assert len(names) >= 25 and not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_forbidden_import_statement(path):
    """Lazy imports inside functions count too."""
    assert not _imported_roots(ROOT / path) & set(FORBIDDEN)


def test_default_config_refuses_cpu_fallback(monkeypatch):
    from repro_torch.core.optimizer import compile_program
    from repro_torch.engine import Engine, EngineConfig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert EngineConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(compile_program(".input e\n.output t\nt(x) :- e(x).\n"))


def test_device_mode_not_ported():
    from repro_torch.core.optimizer import compile_program
    from repro_torch.engine import EngineConfig, make_engine
    cp = compile_program(".input e\n.output t\nt(x) :- e(x).\n")
    with pytest.raises(NotImplementedError, match="host"):
        make_engine(cp, EngineConfig(mode="device", device="cpu"))


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No CUDA device: chip_smoke exits non-zero and prints no result,
    in the checkout and alone in an empty directory."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        out = subprocess.run([sys.executable, str(script)],
                             cwd=script.parent, capture_output=True,
                             text=True, timeout=120,
                             env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
