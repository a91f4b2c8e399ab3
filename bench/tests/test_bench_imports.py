"""The benchmark measures the port alone: no file of it imports JAX or the
JAX package (top-level names compared whole, since ``repro_torch`` begins
with ``repro``), none reads the JAX benchmarks, and a run's process holds
none of them."""
import ast
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(p for p in BENCH.rglob("*.py") if ".cache" not in p.parts)


def _roots(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax_or_reads_the_jax_benchmarks(path):
    assert not set(_roots(path)) & FORBIDDEN
    text = path.read_text()
    if path.parent.name != "tests":
        assert "benchmarks/" not in text and "BENCH_" not in text


def test_a_run_loads_no_jax_module():
    code = (
        "import sys; sys.path[:0] = [{b!r}, {s!r}]\n"
        "import run\n"
        "c = run.cell('gat-rmat40k.b8')\n"
        "c.traffic = dict(c.traffic, batch=2, pool=4, stacks=1, "
        "check_graphs=2)\n"
        "r = run.run_cell(c, 3, 0.0, False, device='cpu', scale=0.01)\n"
        "assert r['correct']\n"
        "print(sorted({{m.split('.')[0] for m in sys.modules}}))\n"
    ).format(b=str(BENCH), s=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    loaded = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and not loaded & FORBIDDEN
