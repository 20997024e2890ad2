"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (the port `izpi_tpu_torch` begins with the
JAX package's name), and the reference imports nothing of the port."""

import ast
import os
import subprocess
import sys
from pathlib import Path

from h100bench import harness

HERE = harness.HERE
FORBIDDEN = {"jax", "jaxlib", "flax", "izpi_tpu"}


def imported(path: Path):
    """Top-level names of every module a source file imports."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        found = set(imported(path)) & FORBIDDEN
        assert not found, f"{path} imports {found}"


def test_reference_imports_nothing_of_the_port():
    for path in (HERE / "reference").rglob("*.py"):
        assert "izpi_tpu_torch" not in set(imported(path)), path


def test_whole_name_comparison():
    assert harness.forbidden_modules({"izpi_tpu_torch": 1,
                                      "izpi_tpu_torch.ops": 1}) == []
    assert harness.forbidden_modules({"izpi_tpu.ops": 1, "jax": 1,
                                      "jaxlib.xla": 1}) == [
        "izpi_tpu.ops", "jax", "jaxlib.xla"]


def run_py(code: str):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A whole run on the CPU at a tiny size (the port's plain versions),
    then the modules loaded in that process."""
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "from h100bench import harness\n"
        "from h100bench.tests.conftest import tiny\n"
        "import importlib.util as u\n"
        "s = u.spec_from_file_location('r', 'h100bench/run.py')\n"
        "r = u.module_from_spec(s); s.loader.exec_module(r)\n"
        "cell = tiny(harness.Cell('cornell.train', harness.benchmark()))\n"
        "r.execute(cell, 7, 0.1, False, device='cpu')\n"
        "print('FOUND', harness.forbidden_modules())\n")
    out = run_py(code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout


def test_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "h100bench/run.py", "--workload", "cornell.render",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
