"""Nothing under portbench/ imports jax, jaxlib, flax or the JAX package
`repro`, or reads benchmarks/; the references import nothing of the
program; and a run of the harness leaves none of those modules loaded."""
from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from portbench import bench

FILES = sorted(p for p in bench.HERE.rglob("*.py") if "tests" not in p.parts)


def top_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(bench.ROOT)))
def test_no_forbidden_import(path):
    assert not top_imports(path) & set(bench.FORBIDDEN)
    assert "benchmarks" not in top_imports(path)
    assert "benchmarks/" not in path.read_text()


@pytest.mark.parametrize("path", sorted((bench.HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not top_imports(path) & {"repro_torch", "repro", "portbench"} or \
        top_imports(path) <= {"torch", "math", "__future__", "portbench"}
    assert "repro_torch" not in path.read_text()


def test_a_run_loads_no_forbidden_module():
    code = (
        "import sys, time, torch\n"
        f"sys.path[:0] = [{str(bench.ROOT)!r}, {str(bench.ROOT / 'src')!r}]\n"
        "from portbench.tests.conftest import tiny_cell\n"
        "from portbench import bench\n"
        "for name in ('nerf.netchunk', 'phi3.chat'):\n"
        "    cell = tiny_cell(name)\n"
        "    bench.driver(cell.workload['driver']).run(cell, seed=3, seconds=0.3, traced=False,\n"
        "        device=torch.device('cpu'), process_start=time.time())\n"
        "print(bench.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=bench.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_the_program_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/, run.py
    exits non-zero and prints nothing on standard output."""
    import shutil
    shutil.copy(bench.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(bench.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "nerf.render",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    assert "src/repro_torch" in out.stderr


def test_run_without_program_or_card_prints_no_result(tmp_path):
    """run.py exits non-zero and prints nothing on standard output where
    it cannot measure: here, no card."""
    out = subprocess.run([sys.executable, str(bench.HERE / "run.py"), "--workload",
                          "nerf.render", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout == ""
