"""What the benchmark loads: no JAX and no JAX package, compared by whole
top-level names (the port's name begins with the JAX package's); the
reference loads nothing of the program; nothing reads the JAX package's
benchmarks or the smoke script."""

import ast
import os
import subprocess
import sys
from pathlib import Path

from portbench import bench

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
PY = sorted(p for p in bench.PORTBENCH.rglob("*.py") if "tests" not in p.parts)


def _imports(path: Path) -> set[str]:
    found = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            found.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            found.add(node.module)
    return found


def test_no_file_imports_jax_or_the_jax_package():
    for p in PY:
        tops = {m.split(".")[0] for m in _imports(p)}
        assert not tops & FORBIDDEN, (p, tops & FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    for p in sorted((bench.PORTBENCH / "references").glob("*.py")):
        tops = {m.split(".")[0] for m in _imports(p)}
        assert tops <= {"__future__", "itertools", "math", "torch"}, (p, tops)


def test_nothing_reads_the_jax_packages_benchmarks():
    for p in PY:
        text = p.read_text()
        for word in ("benchmarks/", "BENCH_", "chip_smoke"):
            assert word not in text, (p, word)


def test_a_run_loads_no_forbidden_module():
    code = (
        "import sys\n"
        "from portbench import harness\n"
        "from portbench.tests.tiny import tiny_cell\n"
        "import portbench.run\n"
        "r = harness.run(tiny_cell('probe-b1k'), 3, 0.2, True, device='cpu')\n"
        "assert r['correct']\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(harness.forbidden_modules())\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(bench.ROOT / "src"), str(bench.ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=bench.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(eval(out.stdout.strip().splitlines()[-2]))
    assert "repro_torch" in tops and not tops & FORBIDDEN
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole():
    from portbench import harness

    names = ["repro_torch", "repro_torch.api", "jaxtyping", "torch", "reprolib"]
    assert harness.forbidden_modules(names) == []
    assert harness.forbidden_modules(names + ["repro.core", "jax", "flax.linen", "jaxlib"]) == [
        "flax.linen", "jax", "jaxlib", "repro.core"]
