"""Command line front end: ``python -m repro_torch.analysis``.

Modes:

  * ``python -m repro_torch.analysis plan.pkl`` — verify a pickled Plan.
  * ``python -m repro_torch.analysis --demo`` — compile a demo plan for
    every partitioner x compressor x executor registry combination on
    ``--device`` (default ``cuda``) and verify each, plus one structural
    ``apply_delta`` scenario, one pending frontier, one failover under a
    chaos schedule and the flash launches of the registered transformer
    configs. Nothing is launched: the checks read host state.
  * ``python -m repro_torch.analysis --list`` — print the check catalogue.

``--strict`` also fails (exit 1) on warnings; default fails on errors
only. ``--families plan,cache`` restricts the run.
"""
from __future__ import annotations

import argparse
import pickle
import sys
from typing import List, Optional, Sequence

from repro_torch.analysis.diagnostics import (AnalysisContext, CHECKS, Report,
                                              checks_for, run_checks)

#: demo graph scale: ~180 vertices — big enough for multi-shard layouts,
#: small enough that the full registry sweep stays quick.
DEMO_SCALE = 0.03


def _gcn(g, seed: int, device: str):
    import torch

    from repro_torch.gnn import models
    gen = torch.Generator(device=device).manual_seed(seed)
    return (models.gnn_init(gen, "gcn", [g.feature_dim, 16, 8]), "gcn")


def _demo_plans(device: str):
    """(label, plan) for every partitioner x compressor x executor combo."""
    from repro_torch.api.engine import Engine
    from repro_torch.api.registry import COMPRESSORS, EXECUTORS, PARTITIONERS
    from repro_torch.gnn import datasets

    g = datasets.load("siot", scale=DEMO_SCALE, seed=0)
    model = _gcn(g, 0, device)
    for partitioner in PARTITIONERS.keys():
        for compressor in COMPRESSORS.keys():
            for executor in EXECUTORS.keys():
                label = f"{partitioner}+{compressor}+{executor}"
                engine = Engine(model, "1A+3B", partitioner=partitioner,
                                compressor=compressor, executor=executor,
                                exchange="halo", aggregation="auto",
                                device=device)
                yield label, engine.compile(g)


def _demo_update_plan(device: str):
    """One structural apply_delta (the ``n=`` repair path)."""
    import numpy as np

    from repro_torch.api.engine import Engine
    from repro_torch.api.updates import GraphDelta
    from repro_torch.gnn import datasets

    g = datasets.load("siot", scale=DEMO_SCALE, seed=1)
    engine = Engine(_gcn(g, 1, device), "1A+3B", executor="mesh-bsp",
                    aggregation="pallas", device=device)
    plan = engine.compile(g)
    v = g.num_vertices
    delta = GraphDelta(
        add_features=np.ones((2, g.feature_dim), np.float32),
        add_edges=[(v, 0), (v + 1, 1)],
        remove_edges=[(int(g.senders[0]), int(g.receivers[0]))])
    return engine.apply_delta(plan, delta, force="incremental")


def _demo_frontier(device: str):
    """One frontier-bearing session: query, apply a delta, snapshot."""
    import numpy as np

    from repro_torch.api.engine import Engine
    from repro_torch.api.updates import GraphDelta
    from repro_torch.gnn import datasets

    g = datasets.load("siot", scale=DEMO_SCALE, seed=2)
    engine = Engine(_gcn(g, 2, device), "1A+3B", executor="sim",
                    aggregation="segment_sum", device=device)
    sess = engine.compile(g).session(activation_cache=True)
    sess.query()                                  # populate the cache
    v = g.num_vertices
    sess.update(GraphDelta(
        add_edges=[(0, v // 2), (v // 2, 0)],
        feature_ids=[1],
        feature_values=np.ones((1, g.feature_dim), np.float32)))
    return sess


def _demo_failover(device: str):
    """One post-failover plan + live fault-aware server for the fault
    family: compile on the full cluster, crash one node mid-trace via a
    chaos schedule, audit the degraded state the server is left in."""
    from repro_torch.api.engine import Engine
    from repro_torch.api.faults import FailoverAudit, Fault, FaultSchedule
    from repro_torch.api.server import Request
    from repro_torch.gnn import datasets

    g = datasets.load("siot", scale=DEMO_SCALE, seed=3)
    engine = Engine(_gcn(g, 3, device), "1A+3B", executor="sim",
                    exchange="halo_async", staleness_bound=2, device=device)
    plan = engine.compile(g)
    crashed = plan.cluster.nodes[-1].name
    sched = FaultSchedule([Fault(time=0.05, kind="crash", node=crashed)])
    server = plan.server(max_batch=4, faults=sched)
    for i in range(8):
        server.submit(Request(arrival_time=0.02 * i))
    server.drain()
    return FailoverAudit(plan=server.session.plan, base_plan=plan,
                         crashed=(crashed,), server=server, schedule=sched)


def _demo_attention():
    """The flash launches of a prefill (batch 2, 4096 tokens) of every
    registered dense transformer config, the family whose attention the
    port serves through ``flash_attention``."""
    from repro_torch.analysis.kernel_lint import flash_launches
    from repro_torch.configs import registry
    out = []
    for name in registry.list_archs():
        cfg = registry.get(name)
        if cfg.family == "dense":
            out.extend(flash_launches(cfg, 2, 4096))
    return out


def _families(arg: Optional[str]) -> Optional[Sequence[str]]:
    return None if not arg else tuple(s.strip() for s in arg.split(",")
                                      if s.strip())


def _print_catalogue() -> None:
    for fn in checks_for(None):
        print(f"{fn.check_id:32s} [{fn.family}/{fn.layer}] "
              f"{fn.description}")


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static plan/kernel/cache verifier of the PyTorch port")
    p.add_argument("plan", nargs="?", help="pickled Plan to verify")
    p.add_argument("--demo", action="store_true",
                   help="verify plans for every partitioner x compressor "
                        "x executor registry combination")
    p.add_argument("--device", default="cuda",
                   help="torch device the demo plans are compiled for "
                        "(default cuda; cpu runs the same checks)")
    p.add_argument("--strict", action="store_true",
                   help="exit nonzero on warnings too")
    p.add_argument("--families",
                   help="comma-separated analyzer families to run "
                        "(plan,frontier,fleet,fault,kernel,cache; "
                        "default all applicable)")
    p.add_argument("--list", action="store_true", dest="list_checks",
                   help="print the check catalogue and exit")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="also print info-level diagnostics")
    args = p.parse_args(argv)

    if args.list_checks:
        _print_catalogue()
        return 0
    if not args.demo and not args.plan:
        p.error("give a pickled plan path or --demo")

    families = _families(args.families)
    total = Report()
    failed = False

    def run(label: str, ctx: AnalysisContext, fams) -> None:
        nonlocal failed
        report = run_checks(ctx, families=fams)
        total.extend(report)
        bad = report.errors + (report.warnings if args.strict else [])
        status = "FAIL" if bad else "ok"
        if bad:
            failed = True
        print(f"[{status:4s}] {label}: {len(report.ran)} checks, "
              f"{len(report.errors)} errors, {len(report.warnings)} "
              f"warnings")
        for d in report.diagnostics:
            if d.severity != "info" or args.verbose:
                print("    " + d.format().replace("\n", "\n    "))

    if args.plan:
        with open(args.plan, "rb") as fh:
            plan = pickle.load(fh)
        run(args.plan, AnalysisContext(plan=plan),
            families or ("plan", "kernel", "cache"))
    if args.demo:
        dev = args.device
        for label, plan in _demo_plans(dev):
            run(label, AnalysisContext(plan=plan),
                families or ("plan", "kernel", "cache"))
        if families is None or "plan" in families:
            run("apply_delta[structural]",
                AnalysisContext(plan=_demo_update_plan(dev)),
                families or ("plan", "kernel", "cache"))
        if families is None or "frontier" in families:
            sess = _demo_frontier(dev)
            run("frontier[pending-delta]",
                AnalysisContext(plan=sess.plan,
                                frontier=sess.frontier_state()),
                families or ("plan", "frontier", "kernel", "cache"))
        if families is None or "fault" in families:
            audit = _demo_failover(dev)
            run("fault[post-failover]",
                AnalysisContext(plan=audit.plan, failover=audit),
                families or ("plan", "fault", "kernel", "cache"))
        if families is None or "kernel" in families:
            run("kernel[flash-prefill]",
                AnalysisContext(attention=_demo_attention()), ("kernel",))

    n_checks = len(list(CHECKS))
    print(f"{n_checks} registered checks; {len(total.ran)} runs, "
          f"{len(total.errors)} errors, {len(total.warnings)} warnings"
          + (" — FAIL" if failed else " — OK"))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
