#!/usr/bin/env python3
"""Phase 2 of ``chip_smoke.py`` for the block-CSR products alone, for a
given tree, so that two trees can be timed in turns on one card.

    python3 scripts/phase2_kernels.py [TREE]

TREE (default: this repository) is the root of a checkout that holds
``chip_smoke.py`` and ``src/repro_torch`` (for example the parent commit
unpacked with ``git archive`` under the git-ignored ``build/``). Builds
that tree's kernels, runs its ``kernel_cases`` (``block_spmm(_batched)``)
and ``dequant_cases`` (``dequant_spmm(_batched)``) on full-scale SIoT and
the 6-fog mesh, with every check they hold, and prints the ``ptxas``
report of ``block_spmm.cu`` and, as the last line, one JSON object of the
per-case times and errors. Run ``parent, change, change, parent`` in one
call to compare two versions. Needs a CUDA card.
"""
import json
import sys
from pathlib import Path

root = Path(sys.argv[1] if len(sys.argv) > 1
            else Path(__file__).resolve().parents[1]).resolve()
sys.path.insert(0, str(root / "src"))
sys.path.insert(0, str(root))
import torch  # noqa: E402

KEYS = ("case", "F", "B", "codes", "ms", "library_ms", "plain_ms",
        "bound_ms", "max_abs_err")


def main() -> int:
    if not torch.cuda.is_available():
        print("phase2_kernels: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.api import Engine
    from repro_torch.gnn import datasets, models
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import daq_dequant as dq
    from repro_torch.kernels import gather_aggregate as ga
    from repro_torch.runtime import bsp

    if not Path(ga.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {ga.__file__}, not the tree {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"tree {root}: built {build.build()}", flush=True)
    report = Path(str(build.library_path("block_spmm")) + ".log")
    for line in report.read_text().splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill")):
            print("  ptxas", line.strip())
    g = datasets.load("siot", 1.0, seed=0)
    csr = ops.block_csr_for(g, device="cuda")
    plan, _ = cs.mesh_plan(Engine, models, g, "gcn")
    pg = plan.partitioned
    local, halo = bsp._folded_csrs(pg, plan.device)
    res = cs.kernel_cases(ga, ref, csr, g, local)
    res.update(cs.dequant_cases(ga, dq, ref, bsp, halo,
                                pg.n * pg.boundary_slots))
    print(json.dumps({
        "tree": str(root), "device": torch.cuda.get_device_name(0),
        "cases": {name: [{k: c[k] for k in KEYS if k in c}
                         for c in rec["cases"]]
                  for name, rec in res.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
