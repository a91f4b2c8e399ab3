#!/usr/bin/env python3
"""The check's control: the reference, computed in TF32, in the program's
place.

    python3 bench/control.py --workload CELL --seeds 11 12 13 [--scale X]

For each seed it draws a run's inputs exactly as ``run.py`` does (graph,
weights, snapshot pool, micro-batches), takes ``check_graphs`` of the
batches' graphs by the run's own sampler, and prints the widest excess gap
of the TF32 reference (``reference.forward(precision="tf32")``) against
the float64 reference: the reading the cell's limit must stay below.
Not part of a benchmark run. Needs a CUDA card unless ``--device cpu``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402

import reference  # noqa: E402
import run  # noqa: E402


def control_excess(c, seed: int, device: str = "cuda", scale=None,
                   precision: str = "tf32") -> float:
    """The widest excess gap of the reference in ``precision`` on the
    graphs a run of cell ``c`` with ``seed`` would check."""
    cfg = c.config
    dev = torch.device(device)
    g, params, stacks = run.draw(c, seed, dev, scale)
    sample = run.Sample(int(c.traffic["check_graphs"]), run.sample_rng(seed))
    for idx, feats in stacks:
        for j, f in zip(idx, feats):
            sample.offer((int(j), f))
    wire = run.wire_quantized(cfg["engine"])
    rg = reference.Graph(g, dev, run.fog_assignment(c, g) if wire else None)
    worst = 0.0
    for _, feats in sample.items:
        x = torch.as_tensor(feats, device=dev)
        want, slack = reference.forward(c.gnn, params, x, rg, wire=wire,
                                        with_slack=True)
        got = reference.forward(c.gnn, params, x, rg, wire=wire,
                                precision=precision)
        worst = max(worst, reference.excess(got, want, slack))
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=None)
    args = ap.parse_args(argv)
    c = run.cell(args.workload)
    limit = float(c.config["check"]["emb_excess_limit"])
    for seed in args.seeds:
        t = time.perf_counter()
        value = control_excess(c, seed, args.device, args.scale)
        print(json.dumps({"workload": c.name, "seed": seed,
                          "control_emb_excess": value, "limit": limit,
                          "fails": value > limit,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
