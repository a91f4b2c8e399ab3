"""Node-failure recovery checks (the "fault" analyzer family).

Audits the node-level fault-tolerance machinery
(``repro_torch.api.faults``) — pass a
:class:`~repro_torch.api.faults.FailoverAudit` as ``ctx.failover``.
Three invariants mirror what the recovery tiers rely on:

  fault.failover.coverage   a failover plan really evicted the crashed
                            nodes (they appear in no cluster/fog/
                            assignment slot), the surviving shards still
                            cover every vertex, and — the pricing bugfix
                            invariant — a failover plan carries
                            ``cluster_spec=None`` so later recompiles
                            and ``simulate_update`` pricing never
                            resurrect the crashed node
  fault.halo.consistency    the serving session's stale halo store
                            agrees with the graph it serves: recorded
                            tables from before a failover (partitioned
                            for the dead layout) must have been
                            invalidated, never replayed
  fault.retry.budget        the plan's exchange retry knobs can actually
                            recover something (at least one backoff
                            attempt fits the timeout), and the replayed
                            FaultSchedule is well-formed (time-sorted,
                            no double-crash without a recover between)

Checks require ``ctx.failover`` and are skipped — not failed — on
contexts without one, so plain plan sweeps are unaffected.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np

from repro_torch.analysis.diagnostics import (AnalysisContext, Diagnostic,
                                              error, info, register_check)
from repro_torch.api.registry import EXCHANGES


@register_check(
    "fault.failover.coverage", family="fault", layer="plan",
    requires=("failover",),
    description="failover plan evicts the crashed nodes, survivors cover "
                "every vertex, and cluster_spec is None")
def check_failover_coverage(ctx: AnalysisContext) -> Iterable[Diagnostic]:
    """The degraded plan must be a complete serving plan on exactly the
    survivors — anything still referencing the crashed node would price
    or route work to a dead machine."""
    audit = ctx.failover
    plan = audit.plan
    node_names = [n.name for n in plan.cluster.nodes]
    fog_names = [f.name for f in plan.fogs]
    crashed = set(audit.crashed)
    leaked = sorted(crashed & (set(node_names) | set(fog_names)))
    if leaked:
        yield error(
            "fault.failover.coverage",
            f"crashed node(s) {leaked} still appear in the failover "
            "plan's cluster/fog roster — work would be priced or routed "
            "to a dead machine",
            layer="plan", subject="cluster.nodes",
            fix_hint="derive the plan via Engine.fail_nodes, which "
                     "rebuilds the cluster from the survivors only")
        return
    a = np.asarray(plan.placement.assignment)
    n = len(plan.fogs)
    if a.shape[0] != plan.graph.num_vertices:
        yield error(
            "fault.failover.coverage",
            f"assignment covers {a.shape[0]} vertices but the graph has "
            f"{plan.graph.num_vertices} — the evicted shard was dropped, "
            "not re-placed",
            layer="plan", subject="placement.assignment",
            fix_hint="repair_assignment must re-place every evicted "
                     "vertex (evacuate_assignment marks them -1)")
        return
    if a.size and (a.min() < 0 or a.max() >= n):
        yield error(
            "fault.failover.coverage",
            f"assignment references partitions outside [0, {n}) "
            f"(min {int(a.min())}, max {int(a.max())}) — an evicted "
            "vertex was never re-placed",
            layer="plan", subject="placement.assignment",
            fix_hint="run repair_assignment on the evacuated assignment")
        return
    sizes = np.bincount(a, minlength=n)
    empty = [fog_names[j] for j in range(n) if sizes[j] == 0]
    if empty:
        yield error(
            "fault.failover.coverage",
            f"surviving fog(s) {empty} own zero vertices after failover "
            "— the re-placement collapsed a shard",
            layer="plan", subject="placement.assignment",
            fix_hint="repair_assignment with capacity balancing keeps "
                     "every survivor populated")
        return
    if plan.provenance == "failover" and plan.config.cluster_spec is not None:
        yield error(
            "fault.failover.coverage",
            f"failover plan still carries cluster_spec="
            f"{plan.config.cluster_spec!r} — Engine.from_plan prefers the "
            "spec over the surviving cluster, so a later recompile or "
            "update pricing would resurrect the crashed node",
            layer="plan", subject="config.cluster_spec",
            fix_hint="failover plans must set cluster_spec=None "
                     "(Engine.fail_nodes does)")
        return
    base = audit.base_plan
    if base is not None:
        if base.graph.num_vertices != plan.graph.num_vertices:
            yield error(
                "fault.failover.coverage",
                f"failover plan serves {plan.graph.num_vertices} vertices "
                f"but its base plan served {base.graph.num_vertices} — a "
                "failover must not change the graph",
                layer="plan", subject="graph",
                fix_hint="fail over first, then apply graph deltas")
            return
        expect = len(base.fogs) - len(crashed)
        if crashed and len(plan.fogs) != expect:
            yield error(
                "fault.failover.coverage",
                f"{len(crashed)} node(s) crashed off a {len(base.fogs)}-"
                f"fog base plan but the failover plan has "
                f"{len(plan.fogs)} fogs (expected {expect})",
                layer="plan", subject="fogs",
                fix_hint="every crashed node evicts exactly one fog")
            return
    yield info(
        "fault.failover.coverage",
        f"{len(crashed) or 'no'} crashed node(s) evicted; "
        f"{plan.graph.num_vertices} vertices covered by "
        f"{n} surviving shards (largest {int(sizes.max())})",
        layer="plan", subject="placement.assignment")


@register_check(
    "fault.halo.consistency", family="fault", layer="plan",
    requires=("failover",),
    description="no stale halo table recorded for a pre-failover layout "
                "survives onto the degraded plan")
def check_halo_consistency(ctx: AnalysisContext) -> Iterable[Diagnostic]:
    """Recorded halo tables are partitioned for one specific layout; a
    failover changes the layout, so tables recorded before it must have
    been invalidated (Session.rebind does) — replaying them would ship
    features to the wrong shards."""
    audit = ctx.failover
    server = audit.server
    sess = None
    if server is not None:
        sess = getattr(server, "session", None)
    if sess is None:
        yield info("fault.halo.consistency",
                   "no live server in the audit — nothing recorded to "
                   "check", layer="plan", subject="session")
        return
    store = getattr(sess, "_halo", None)
    if store is None or store.tables is None:
        yield info("fault.halo.consistency",
                   "halo store empty/absent — nothing stale to replay",
                   layer="plan", subject="session._halo")
        return
    from repro_torch.kernels import ops
    current = ops.graph_fingerprint(sess.plan.graph)
    if store.revision != current:
        yield error(
            "fault.halo.consistency",
            f"recorded halo tables carry revision "
            f"{str(store.revision)[:12]}… but the session serves "
            f"{current[:12]}… — a stale ride-through would replay tables "
            "partitioned for a dead layout",
            layer="plan", subject="session._halo",
            fix_hint="Session.rebind/failover must invalidate the halo "
                     "store; call session._halo.invalidate()")
        return
    yield info(
        "fault.halo.consistency",
        f"halo store revision matches the serving graph (age "
        f"{store.age}/{store.bound})",
        layer="plan", subject="session._halo")


@register_check(
    "fault.retry.budget", family="fault", layer="plan",
    requires=("failover",),
    description="exchange retry knobs admit at least one backoff attempt "
                "and the fault schedule is well-formed")
def check_retry_budget(ctx: AnalysisContext) -> Iterable[Diagnostic]:
    """Tier 1 must be reachable: a retryable exchange whose first backoff
    attempt already blows the timeout silently degrades every transient
    loss to tier 2/3. The schedule (when supplied) must be replayable:
    time-sorted with no node crashing twice without a recover between."""
    audit = ctx.failover
    plan = audit.plan
    exch = EXCHANGES.resolve(plan.config.exchange)
    if getattr(exch, "retryable", False):
        knobs = [("max_retries", exch.max_retries, exch.max_retries >= 1),
                 ("backoff_base_s", exch.backoff_base_s,
                  exch.backoff_base_s > 0),
                 ("backoff_mult", exch.backoff_mult,
                  exch.backoff_mult >= 1.0),
                 ("retry_timeout_s", exch.retry_timeout_s,
                  exch.retry_timeout_s > 0)]
        bad = [(k, v) for k, v, ok in knobs if not ok]
        if bad:
            yield error(
                "fault.retry.budget",
                f"exchange {exch.name!r} retry knobs out of range: "
                + ", ".join(f"{k}={v}" for k, v in bad),
                layer="plan", subject=f"EXCHANGES[{exch.name!r}]",
                fix_hint="max_retries >= 1, backoff_base_s > 0, "
                         "backoff_mult >= 1, retry_timeout_s > 0")
            return
        _, _, ok = exch.recovery_cost(1, plan.cluster.sync_cost)
        if not ok:
            yield error(
                "fault.retry.budget",
                f"exchange {exch.name!r} cannot recover even a single "
                f"lost round within retry_timeout_s="
                f"{exch.retry_timeout_s} at sync_cost="
                f"{plan.cluster.sync_cost} — tier-1 retry is unreachable "
                "and every transient loss degrades straight to stale/"
                "failover",
                layer="plan", subject=f"EXCHANGES[{exch.name!r}]",
                fix_hint="raise retry_timeout_s or lower backoff_base_s "
                         "so attempt 0 fits the budget")
            return
    sched = audit.schedule
    if sched is not None:
        times = [f.time for f in sched]
        if times != sorted(times):
            yield error(
                "fault.retry.budget",
                "fault schedule is not time-sorted — the injector fires "
                "events in list order and would replay the past",
                layer="plan", subject="schedule",
                fix_hint="construct via FaultSchedule(...), which sorts")
            return
        down: set = set()
        for f in sched:
            if f.kind == "crash":
                if f.node in down:
                    yield error(
                        "fault.retry.budget",
                        f"node {f.node!r} crashes twice (t={f.time}) "
                        "without a recover between — the second event "
                        "can never fire",
                        layer="plan", subject="schedule",
                        fix_hint="pair every crash with a recover (see "
                                 "FaultSchedule.random)")
                    return
                down.add(f.node)
            elif f.kind == "recover":
                down.discard(f.node)
    n_ev = 0 if sched is None else len(sched)
    yield info(
        "fault.retry.budget",
        f"exchange {exch.name!r} "
        + ("retry budget admits recovery"
           if getattr(exch, "retryable", False)
           else "is not retryable (tier 1 skipped by design)")
        + (f"; schedule of {n_ev} events well-formed" if sched is not None
           else ""),
        layer="plan", subject=f"EXCHANGES[{exch.name!r}]")
