"""Frontier invariant checks (the "frontier" analyzer family).

Audits a :class:`repro_torch.core.frontier.FrontierPlan` — the pending
dirty-frontier snapshot a cache-enabled
:class:`~repro_torch.api.session.Session` exposes via ``frontier_state()``
— against the plan it claims to describe.
The two invariants mirror what the incremental executor path relies on:

  plan.frontier.closure    the per-layer dirty sets really are the k-hop
                           balls of the seeds over the *union* adjacency
                           (graph edges plus the removed-edge survivor
                           pairs), monotone in depth and within bounds
  plan.frontier.revision   the snapshot was cut at the adjacency the plan
                           is currently serving (a cache/plan revision
                           split is exactly the staleness bug the cache
                           tag exists to prevent)

Checks require both ``ctx.plan`` and ``ctx.frontier`` and are skipped —
not failed — on contexts without a frontier, so plain plan sweeps are
unaffected.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np

from repro_torch.analysis.diagnostics import (AnalysisContext, Diagnostic,
                                              error, info, register_check)
from repro_torch.core.frontier import expand_frontier
from repro_torch.kernels import ops


@register_check(
    "plan.frontier.closure", family="frontier", layer="plan",
    requires=("plan", "frontier"),
    description="per-layer dirty rows are the exact k-hop closure of the "
                "seeds over the union adjacency")
def check_frontier_closure(ctx: AnalysisContext) -> Iterable[Diagnostic]:
    """Re-expand the frontier from its own seeds and demand agreement."""
    fp = ctx.frontier
    g = ctx.plan.graph
    v = g.num_vertices
    k = len(fp.rows)
    if fp.num_layers != k:
        yield error("plan.frontier.closure",
                    f"frontier claims {fp.num_layers} layers but carries "
                    f"{k} row sets", layer="plan", subject="rows",
                    fix_hint="rebuild the snapshot via "
                             "Session.frontier_state()")
        return
    for name, ids in [("seeds", fp.seeds)] + [
            (f"rows[{i}]", r) for i, r in enumerate(fp.rows)]:
        ids = np.asarray(ids)
        if len(ids) and (ids.min() < 0 or ids.max() >= v):
            yield error("plan.frontier.closure",
                        f"{name} contains out-of-range vertex ids "
                        f"(graph has {v} vertices)",
                        layer="plan", subject=name,
                        fix_hint="the cache was not remapped through the "
                                 "last delta's vertex map; clear it")
            return
    if len(fp.extra_edges):
        ee = np.asarray(fp.extra_edges)
        if ee.min() < 0 or ee.max() >= v:
            yield error("plan.frontier.closure",
                        "extra_edges reference out-of-range vertex ids",
                        layer="plan", subject="extra_edges",
                        fix_hint="remap or drop stale removed-edge pairs")
            return
    truth = expand_frontier(g, np.asarray(fp.seeds, np.int64),
                            np.asarray(fp.extra_edges, np.int64),
                            k)
    prev = np.asarray(fp.seeds, np.int64)
    for i, (got, want) in enumerate(zip(fp.rows, truth)):
        got = np.asarray(got, np.int64)
        missing = np.setdiff1d(want, got)
        if len(missing):
            yield error(
                "plan.frontier.closure",
                f"layer {i + 1} dirty set misses {len(missing)} vertices "
                f"of its {i + 1}-hop ball (e.g. {missing[:3].tolist()}) — "
                "an incremental pass would serve stale activations there",
                layer="plan", subject=f"rows[{i}]",
                fix_hint="expand_frontier must run over the union "
                         "adjacency (graph edges + extra_edges)")
            return
        if len(np.setdiff1d(prev, got)):
            yield error(
                "plan.frontier.closure",
                f"layer {i + 1} dirty set is not a superset of layer {i}'s "
                "— frontier depth must be monotone",
                layer="plan", subject=f"rows[{i}]",
                fix_hint="each BFS step must union, not replace, the "
                         "previous dirty set")
            return
        prev = got
    yield info("plan.frontier.closure",
               f"{k}-layer frontier of {len(fp.seeds)} seeds closed "
               f"correctly (|D_K| = {len(fp.rows[-1]) if k else 0} of {v})",
               layer="plan", subject="rows")


@register_check(
    "plan.frontier.revision", family="frontier", layer="plan",
    requires=("plan", "frontier"),
    description="frontier snapshot was cut at the adjacency the plan "
                "currently serves")
def check_frontier_revision(ctx: AnalysisContext) -> Iterable[Diagnostic]:
    """Cache-revision agreement: the snapshot's fingerprint must match."""
    fp = ctx.frontier
    g = ctx.plan.graph
    if fp.num_vertices != g.num_vertices:
        yield error(
            "plan.frontier.revision",
            f"frontier was cut over {fp.num_vertices} vertices but the "
            f"plan serves {g.num_vertices}",
            layer="plan", subject="num_vertices",
            fix_hint="apply_update must remap the cache through every "
                     "flushed delta before the next query")
        return
    rev = ops.graph_fingerprint(g)
    if fp.revision != rev:
        yield error(
            "plan.frontier.revision",
            "frontier revision disagrees with the plan's adjacency "
            f"fingerprint ({fp.revision[:12]}… vs {rev[:12]}…) — cached "
            "activations would be served against a different graph",
            layer="plan", subject="revision",
            fix_hint="clear the activation cache or rebase it with a "
                     "full capturing pass")
        return
    yield info("plan.frontier.revision",
               "frontier revision matches the serving adjacency",
               layer="plan", subject="revision")
