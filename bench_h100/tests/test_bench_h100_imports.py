"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level module names are
compared whole: the port's name, nbody_tpu_torch, begins with the JAX
package's, nbody_tpu."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench_h100 import harness

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "nbody_tpu"}
# The yardstick: none of these may import the program.
STANDALONE = ("reference.py", "ics.py", "roofline.py", "timing.py",
              "devtrace.py")


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module":
            names.add("<dynamic>")
    return names


def sources():
    return sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


def test_no_source_imports_jax_or_the_jax_package():
    for path in sources():
        assert not top_level_imports(path) & FORBIDDEN, path


def test_the_yardstick_imports_nothing_of_the_program():
    for name in STANDALONE:
        found = top_level_imports(HERE / name)
        assert "nbody_tpu_torch" not in found, name
        assert "<dynamic>" not in found, name


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "nbody_tpu_torch_lookalike",
                        sys.modules["json"])
    assert "nbody_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "nbody_tpu.config", sys.modules["json"])
    assert harness.forbidden_modules() == ["nbody_tpu"]


def test_a_run_loads_no_forbidden_module():
    """A whole run (on the CPU, at a tiny size) in a fresh process: after
    it, sys.modules holds neither JAX nor the JAX package."""
    code = (
        "import json, sys; from bench_h100 import harness\n"
        "line = harness.run_cell('disk2d-131k-int4', 3, 0, False, 'cpu',"
        " traffic_overrides={'n': 128, 'snapshot_interval': 2})\n"
        "print(json.dumps({'correct': line['correct'],"
        " 'forbidden': harness.forbidden_modules(),"
        " 'program': 'nbody_tpu_torch' in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "forbidden": [], "program": True}


def test_without_the_program_a_run_fails_and_prints_nothing(tmp_path):
    """In a directory that holds only BENCHMARK.json and bench_h100/, a
    run exits with another code than 0 and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "bench_h100/run.py", "--workload",
         "disk2d-131k-int4", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("argv", [
    ["--workload", "disk2d-131k-int4", "--seed", "1", "--seconds", "1"]])
def test_without_a_card_a_run_fails_and_prints_nothing(argv):
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is here: the run would measure")
    out = subprocess.run([sys.executable, "bench_h100/run.py", *argv],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr
