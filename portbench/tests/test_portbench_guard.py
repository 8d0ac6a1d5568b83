"""Nothing the benchmark runs imports JAX, the JAX package or its suite,
and the plain reference imports nothing of the program.  Top-level names
are compared whole (the part before the first dot), so ``repro_torch`` is
not ``repro``."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def imported(path: Path):
    """Top-level names of every absolute import in ``path``."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


MODULES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not set(imported(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = set(imported(path))
    assert "repro_torch" not in names
    # and nothing of the benchmark that does
    for mod in ast.walk(ast.parse(path.read_text())):
        if isinstance(mod, ast.ImportFrom) and mod.module and mod.module.startswith("portbench"):
            for a in mod.names:
                dep = BENCH.parent / (mod.module.replace(".", "/") + f"/{a.name}.py")
                dep = dep if dep.exists() else BENCH.parent / (mod.module.replace(".", "/") + ".py")
                assert "repro_torch" not in set(imported(dep)), dep


def test_guard_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.core\nfrom jaxtyping import x\n")
    assert not set(imported(f)) & FORBIDDEN
    f.write_text("import repro.core\n")
    assert set(imported(f)) & FORBIDDEN
    f.write_text("from benchmarks import kernels_bench\n")
    assert set(imported(f)) & FORBIDDEN


def test_run_refuses_loaded_jax_modules():
    import sys

    from portbench import run as R
    assert R.forbidden_modules() == []
    sys.modules["repro.core"] = sys  # any module object under a forbidden name
    try:
        assert R.forbidden_modules() == ["repro"]
    finally:
        del sys.modules["repro.core"]
