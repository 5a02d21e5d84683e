"""What a run may load and where it may run."""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] in ("__future__", "math", "hashlib", "typing", "numpy",
                                          "torch", "benchmark"), (path, name)
            assert not name.startswith("benchmark.") or name.startswith("benchmark.reference")


def test_no_source_of_the_harness_imports_jax():
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "kokoro_tpu"), (path, name)


def _run(code: str, cwd: Path, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=300, env=env)


def test_a_run_loads_no_jax_and_no_jax_package():
    """A whole run of a small cell, then the top-level names of every loaded
    module compared whole: ``kokoro_tpu_torch`` is loaded, ``kokoro_tpu`` is
    not."""
    code = ("import sys\n"
            "from benchmark.tests.small import small_cell\n"
            "from benchmark.run import run, forbidden_modules\n"
            "r = run(small_cell('hp-ladder', 'float32'), 11, 0.2, False, device='cpu')\n"
            "top = {n.split('.')[0] for n in sys.modules}\n"
            "print(r['correct'], 'kokoro_tpu_torch' in top, forbidden_modules())\n")
    out = _run(code, REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True True []"


def test_a_run_with_no_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "hp-ladder",
                          "--seed", str(2 ** 35), "--seconds", "1", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout == ""


def test_a_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "hp-ladder",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    """One short run of each cell on the card prints a correct result."""
    import json

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for name in ("hp-ladder", "long-b48-t1408"):
        out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", name,
                              "--seed", str(2 ** 31 + 3), "--seconds", "5", "--trace", "0"],
                             cwd=REPO, capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
