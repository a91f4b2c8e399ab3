"""The PyTorch port stands alone: it never imports JAX or the JAX package.

Every module under ``src/repro_torch/``, the root ``chip_smoke.py``, the
port's GPU scripts and its examples (``examples/torch_*.py``) are checked
by AST for ``jax``, ``jaxlib`` and ``repro`` imports (``repro_torch``
itself is fine), and a fresh interpreter that imports every port module
must end with none of those in ``sys.modules``.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}
FILES = sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "profile_query.py",
    ROOT / "scripts" / "phase2_kernels.py",
    ROOT / "scripts" / "frontier_reach.py"] + sorted(
    (ROOT / "examples").glob("torch_*.py"))
EXAMPLES = ("torch_quickstart.py", "torch_traffic_forecasting.py",
            "torch_distributed_fog_serving.py", "torch_llm_serving_iep.py")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            yield node.lineno, node.args[0].value.split(".")[0]


def _modules():
    """Every importable port module (``__main__`` runs a CLI when imported:
    its imports are checked by AST only)."""
    return sorted(".".join(p.relative_to(PORT.parent).with_suffix("").parts)
                  .removesuffix(".__init__")
                  for p in PORT.rglob("*.py") if p.stem != "__main__")


def test_port_has_the_slice_modules():
    mods = set(_modules())
    for m in ("api.registry", "api.plan", "api.engine", "api.session",
              "api.executors", "api.updates", "api.slo", "api.server",
              "api.traces", "api.fleet", "api.faults", "analysis",
              "analysis.diagnostics", "analysis.plan_checks",
              "analysis.frontier_checks", "analysis.fleet_checks",
              "analysis.fault_checks", "analysis.cache_audit",
              "analysis.kernel_lint", "analysis.cli", "core.incremental",
              "core.frontier", "gnn.graph", "gnn.datasets", "gnn.layers",
              "gnn.models", "core.profiler", "core.partition",
              "core.placement", "core.scheduler", "core.compression",
              "core.simulation", "kernels.gather_aggregate", "kernels.ref",
              "kernels.daq_dequant", "kernels.ops", "kernels.build",
              "kernels.flash_attention", "kernels.segment_sum",
              "kernels.recurrence", "models.moe", "models.ssm",
              "runtime.bsp", "models.config",
              "models.layers", "models.attention", "models.transformer",
              "configs.registry", "configs.qwen1_5_0_5b", "launch.serve",
              "runtime.serving", "api.demo"):
        assert f"repro_torch.{m}" in mods, m
    assert (PORT / "analysis" / "__main__.py").is_file()
    # the reference's hlo family reads XLA's compiled text: no counterpart
    assert "repro_torch.analysis.hlo" not in mods
    for src in ("block_spmm.cu", "flash_attention.cu", "segment_sum.cu",
                "recurrence.cu"):
        assert (PORT / "kernels" / "csrc" / src).is_file()
    for name in EXAMPLES:
        assert ROOT / "examples" / name in FILES, name


def test_gnn_models_has_training_and_the_case_study():
    from repro_torch.gnn import models
    for name in ("cross_entropy", "train_node_classifier", "astgcn_init",
                 "astgcn_apply", "astgcn_spatial_sum", "train_astgcn",
                 "forecast_errors"):
        assert callable(getattr(models, name)), name


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
