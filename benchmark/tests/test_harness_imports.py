"""The import check compares whole top-level names, and neither the
harness nor the reference loads JAX or the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run

BENCH = Path(run.__file__).resolve().parent


@pytest.mark.parametrize("names,bad", [
    (["jax"], ["jax"]),
    (["jax.numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["respmon_tpu"], ["respmon_tpu"]),
    (["respmon_tpu.ops.pyramid"], ["respmon_tpu"]),
    (["respmon_tpu_torch", "respmon_tpu_torch.ops.lk"], []),
    (["jaxtyping", "flaxen", "respmon_tpu2"], []),
])
def test_forbidden_modules(names, bad):
    assert run.forbidden_modules(names) == bad


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("respmon_tpu", "respmon_tpu_torch", "jax",
                           "jaxlib", "flax"), (path.name, name)


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax(path):
    for name in _imports(path):
        assert name.split(".")[0] not in ("jax", "jaxlib", "flax",
                                          "respmon_tpu"), (path, name)


def test_a_run_loads_no_jax():
    code = ("import sys, time; sys.path.insert(0, '.');"
            "import torch; torch.set_num_threads(1);"
            "from benchmark.tests.conftest import run_small;"
            "run_small('cam640.recover', seconds=0.5);"
            "from benchmark import run;"
            "print(run.forbidden_modules(sys.modules))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
