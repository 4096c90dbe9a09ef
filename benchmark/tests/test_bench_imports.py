"""Nothing the benchmark runs imports JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the reference imports nothing of the port."""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys

from benchmark.harness.runner import FORBIDDEN, forbidden_modules
from benchmark.harness.spec import BENCH_DIR, ROOT

PORT = "gpbayestools_hic_tpu_torch"


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(BENCH_DIR.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not (_imports(f) & set(FORBIDDEN)), f


def test_the_reference_imports_nothing_of_the_port():
    for f in sorted((BENCH_DIR / "reference").rglob("*.py")):
        names = _imports(f)
        assert PORT not in names and "benchmark" not in names, f


def test_names_are_compared_whole():
    assert forbidden_modules([PORT, f"{PORT}.ops", "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["jax.numpy", "gpbayestools_hic_tpu.models", "flax"]) == [
        "flax", "gpbayestools_hic_tpu.models", "jax.numpy"]


def test_a_tiny_run_loads_no_jax():
    code = (
        "import sys, time, torch\n"
        "from benchmark.tests.conftest import tiny_spec\n"
        "from benchmark.harness.runner import run_cell, forbidden_modules\n"
        "for cell in ('bes-hmc', 'bes-ens-stitched'):\n"
        "    out = run_cell(tiny_spec(cell), 7, 0.2, False, torch.device('cpu'),\n"
        "                   time.perf_counter())\n"
        "    assert out is not None\n"
        "print('FOUND', forbidden_modules())\n"
    )
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "FOUND []" in r.stdout


def test_run_fails_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    files, a run exits non-zero and prints no result."""
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "bes-hmc",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert PORT in r.stderr


def test_run_exits_without_a_card():
    """Without the card the cell asks for, a run exits non-zero and prints
    no result."""
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "bes-ens-generic",
                        "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "CUDA device" in r.stderr
