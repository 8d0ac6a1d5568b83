"""The port imports neither JAX, nor the reference package, nor the
reference's benchmark folder: an AST scan of every module of
``src/repro_torch`` and of ``chip_smoke.py``, and a fresh interpreter
that imports the whole port."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks")


def imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def is_forbidden(mod: str) -> bool:
    # "repro" or "repro.x" is the reference; "repro_torch" is the port
    return mod.split(".")[0] in FORBIDDEN


def test_forbidden_names_are_recognised():
    assert is_forbidden("repro.quant.hqq") and is_forbidden("repro")
    assert is_forbidden("jax.numpy")
    assert is_forbidden("benchmarks.common")
    assert not is_forbidden("repro_torch.quant.hqq")
    assert not is_forbidden("repro_torch.benchmarks.common")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_no_jax_or_reference(path):
    bad = [m for m in imported_modules(path) if is_forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax_or_reference():
    mods = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
            for p in PORT_FILES if p.name not in ("chip_smoke.py",)]
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              f"{FORBIDDEN!r})\n"
              "assert not bad, bad\nprint(len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
