"""The benchmark measures the port alone: nothing it loads is JAX or the JAX
package (compared by whole top-level name, so ``repro_torch`` passes), the
reference takes nothing of the port, and without the cards or without the
program a run fails and prints no result."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench import common

BENCH_DIR = common.BENCH
SRC = common.ROOT / "src"


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module or "")
    return names


def test_everything_a_run_loads_is_free_of_jax_and_the_jax_package():
    metrics = [m["name"] for m in common.spec()["end_to_end"] + common.spec()["per_layer"]]
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(SRC)!r}, {str(common.ROOT)!r}]\n"
        "import port_bench.run, port_bench.calibrate, port_bench.faults\n"
        "from port_bench import common\n"
        "from port_bench.drivers import train, prefill\n"
        "import repro_torch.train.steps, repro_torch.launch.serve, repro_torch.optim.adamw\n"
        "import torch.profiler\n"
        f"for m in {metrics!r}:\n"
        "    common.reader(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'repro'))\n"
        "assert not bad, bad\n"
        "assert 'repro_torch' in sys.modules\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=180, env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", sorted(BENCH_DIR.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_file_imports_jax_or_the_jax_package(path):
    for name in _imports(path):
        assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "repro"), name


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_takes_nothing_of_the_port(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top in ("__future__", "dataclasses", "math", "torch", "port_bench"), name
        if top == "port_bench":
            assert name.startswith("port_bench.reference"), name


def test_without_the_cards_a_run_fails_and_prints_nothing():
    proc = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "mamba2-1.3b.train-8x2k",
         "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=common.ROOT, capture_output=True, text=True, timeout=180,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_the_benchmark_alone_fails_and_prints_nothing(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copy(common.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "zamba2-2.7b.prefill-8x4k",
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=180,
        env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "repro_torch" in proc.stderr
