#!/usr/bin/env python3
"""Where a served query's time goes on a CUDA card (the port's main path).

    python3 scripts/profile_query.py [--executor sim|mesh-bsp] [--queries 10]
                                     [--out PATH]

Serves full-scale SIoT through ``repro_torch``'s
``Engine(..., executor=EXECUTOR, aggregation="pallas", device="cuda")``
(``--executor``: ``sim``, the default, or ``mesh-bsp``, the 6-fog mesh
with the DAQ halo wire) for GCN and SAGE [52, 64, 2] and reports, per
model, from a ``torch.profiler``
trace of ``--queries`` back-to-back ``execute`` calls and of one
``execute_many`` over 8 feature sets: device busy time (kernels, copies and
fills from the trace, as a union of intervals), the window's host-clock
length, the device's idle share, and device time by kernel name. The
host-clock split of a query into collect / execute / account is
``chip_smoke.py``'s.

Prints one JSON object per model and writes them all to ``--out``
(default ``results/profile_query.json``). Needs a CUDA card.
"""
import argparse
import json
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_intervals(prof):
    """(start_us, end_us, category, name) of every device event in a trace."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [(e["ts"], e["ts"] + e["dur"], e["cat"], e["name"])
            for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def busy_us(intervals) -> float:
    """Length of the union of the intervals."""
    total, end = 0.0, float("-inf")
    for s, e, *_ in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def profile_window(fn) -> dict:
    """Run ``fn`` under the profiler; device busy vs host-clock window."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    iv = device_intervals(prof)
    if not iv:
        raise RuntimeError("the profiler recorded no device event")
    busy = busy_us(iv)
    by_name = defaultdict(float)
    for s, e, cat, name in iv:
        by_name[f"{cat}:{name[:60]}"] += e - s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"window_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / wall_us,
            "device_ms_by_name": {k: v / 1e3 for k, v in top}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--executor", choices=("sim", "mesh-bsp"),
                    default="sim")
    ap.add_argument("--queries", type=int, default=10)
    ap.add_argument("--out", default=str(ROOT / "results" /
                                         "profile_query.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_query: no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.api import Engine
    from repro_torch.gnn import datasets, models

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = datasets.load("siot", 1.0, seed=0)
    report = {"device": torch.cuda.get_device_name(0),
              "executor": args.executor, "models": []}
    for kind in ("gcn", "sage"):
        params = models.gnn_init(torch.Generator(device="cuda").manual_seed(0),
                                 kind, [g.feature_dim, 64, 2])
        sess = Engine((params, kind), executor=args.executor,
                      aggregation="pallas", device="cuda").compile(g).session()
        sess.query()                                   # warm-up
        feats = sess.collect()
        stack = np.stack([feats] * 8)
        sess.execute_many(stack)                       # warm-up
        rec = {"kind": kind, "executor": args.executor,
               "execute": profile_window(lambda: [
                   sess.execute(feats) for _ in range(args.queries)]),
               "execute_many_8": profile_window(
                   lambda: sess.execute_many(stack))}
        rec["execute"]["per_query_ms"] = (rec["execute"]["window_ms"]
                                          / args.queries)
        report["models"].append(rec)
        print(json.dumps(rec), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
