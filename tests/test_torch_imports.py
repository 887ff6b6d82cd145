"""The import rule of the port: ``repro_torch`` and ``chip_smoke.py``
import no JAX and no module of ``repro``, not even one that loads no
JAX; what the port needs from such a module it keeps as its own copy.
Nor do they import ``ml_dtypes``, which ships with JAX: the port reads
bfloat16 through torch."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__") for p in PORT.rglob("*.py"))


FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def _imports(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            yield node.args[0].value


def test_the_scan_sees_the_package():
    assert len(FILES) > 20 and "repro_torch.exec.torch_backend" in MODULES
    assert {"repro_torch.models.model", "repro_torch.serving.serve_loop",
            "repro_torch.launch.serve", "repro_torch.configs.base",
            "repro_torch.kernels.flash_attention.ops",
            "repro_torch.kernels.rglru.ops",
            "repro_torch.kernels.mlstm.ops", "repro_torch.kernels.mlstm.kernel",
            "repro_torch.models.xlstm", "repro_torch.models.moe",
            "repro_torch.configs.paper_pipeline",
            "repro_torch.data.pipeline", "repro_torch.data.synthetic",
            "repro_torch.data.tokenizer", "repro_torch.training.optimizer",
            "repro_torch.training.train_loop", "repro_torch.kernels.autograd",
            "repro_torch.distributed", "repro_torch.distributed.fault_tolerance",
            "repro_torch.launch.train",
            "repro_torch.examples.transactional_training",
            "repro_torch.examples.bf16_keys", "repro_torch.examples.entry",
            *(f"repro_torch.examples.{name}" for name in (
                "quickstart", "agent_branch_workflow", "incremental_reruns",
                "optimized_pipeline", "sql_queries", "traced_run",
                "concurrent_writers", "agent_swarm",
                "serve_pinned_commit"))} <= set(MODULES)


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_and_no_repro_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [name for name in _imports(tree) if _forbidden(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        f"             if k.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
