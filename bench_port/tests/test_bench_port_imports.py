"""What the benchmark's files may import.

Nothing under ``bench_port/`` imports JAX or the JAX package ``repro``,
and the reference imports nothing of the program ``repro_torch``. Names
are compared by their top-level part, whole: ``repro_torch`` begins
with ``repro`` and is not ``repro``."""
import ast
from pathlib import Path

import pytest

from bench_port import harness

HERE = Path(__file__).resolve().parents[1]
FILES = sorted(HERE.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


def test_the_scan_compares_whole_top_level_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.models\nfrom repro.core import x\n"
                 "import jax.numpy as jnp\n")
    assert top_level_imports(f) == {"repro_torch", "repro", "jax"}
    assert not (top_level_imports(f) - {"repro", "jax"}) & harness.FORBIDDEN


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & harness.FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((HERE / "reference").rglob("*.py")):
        assert "repro_torch" not in top_level_imports(path), path
    # nor does what it is handed its weights by
    assert "repro_torch" not in top_level_imports(HERE / "weights.py")


def test_the_run_refuses_a_process_that_loaded_the_jax_package(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "repro_torch_probe", types.ModuleType("x"))
    assert harness.forbidden_modules() == sorted(
        {n.split(".")[0] for n in sys.modules} & harness.FORBIDDEN)
    assert "repro_torch_probe" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("y"))
    assert "repro" in harness.forbidden_modules()
