"""Fleet invariant checks (the "fleet" analyzer family).

Audits the geo-distributed serving layer (``repro_torch.api.fleet``) — pass a
:class:`~repro_torch.api.fleet.FleetServer` (or a bare ``Fleet``) as
``ctx.fleet``. Three invariants mirror what the router and the
stale-tolerant exchange rely on:

  fleet.router.coverage       the routing table covers EVERY fleet site
                              with its true centroid — a site missing
                              from the table silently never receives
                              traffic (worse than being marked down,
                              which reroutes visibly)
  fleet.revision.agreement    every tier (each site plan + the cloud)
                              serves the same graph revision; after an
                              update fan-out a diverging tier would
                              answer queries against a different graph
  fleet.staleness.consistency the FleetServer's ``staleness_bound``
                              agrees with each site session's halo-store
                              bound, every bound > 0 rides a
                              stale-tolerant exchange entry, and the
                              cloud tier always serves fresh

Checks require ``ctx.fleet`` and are skipped — not failed — on contexts
without one, so plain plan sweeps are unaffected.
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple

from repro_torch.analysis.diagnostics import (AnalysisContext, Diagnostic,
                                              error, info, register_check)
from repro_torch.api.registry import EXCHANGES
from repro_torch.kernels import ops


def _unpack(obj) -> Tuple[object, Optional[object]]:
    """``ctx.fleet`` -> (Fleet, FleetServer-or-None)."""
    if hasattr(obj, "router"):          # FleetServer
        return obj.fleet, obj
    return obj, None                    # bare Fleet


def _tier_revision(g) -> str:
    """Full serving revision of one tier's graph: adjacency fingerprint
    extended with the feature table. ``ops.graph_fingerprint`` hashes
    adjacency only (all the operand caches need), but a feature-only
    delta applied to one tier still makes it answer differently — tier
    agreement must see it."""
    import hashlib

    import numpy as np
    d = hashlib.blake2b(digest_size=16)
    d.update(ops.graph_fingerprint(g).encode())
    d.update(np.ascontiguousarray(g.features, np.float32).tobytes())
    return d.hexdigest()


@register_check(
    "fleet.router.coverage", family="fleet", layer="fleet",
    requires=("fleet",),
    description="routing table covers every fleet site at its true "
                "centroid")
def check_router_coverage(ctx: AnalysisContext) -> Iterable[Diagnostic]:
    """Every site must be routable: table keys == fleet sites, centroids
    agree. (Down sites stay IN the table — the route policy skips them
    visibly; a missing entry is invisible starvation.)"""
    fleet, fs = _unpack(ctx.fleet)
    if fs is None:
        yield info("fleet.router.coverage",
                   "bare Fleet carries no router — nothing to cover yet",
                   layer="fleet", subject="router")
        return
    table = fs.router.table
    names = set(fleet.site_names)
    missing = sorted(names - set(table))
    if missing:
        yield error(
            "fleet.router.coverage",
            f"routing table misses site(s) {missing} — requests can "
            "never be routed there (silent starvation)",
            layer="fleet", subject="router.table",
            fix_hint="rebuild the Router from the Fleet; the table must "
                     "enumerate every Site, down or not")
        return
    extra = sorted(set(table) - names)
    if extra:
        yield error(
            "fleet.router.coverage",
            f"routing table lists unknown site(s) {extra} — requests "
            "routed there have no server",
            layer="fleet", subject="router.table",
            fix_hint="rebuild the Router from the Fleet")
        return
    for site in fleet.sites:
        if tuple(table[site.name]) != tuple(site.location):
            yield error(
                "fleet.router.coverage",
                f"site {site.name!r} centroid drifted: table says "
                f"{tuple(table[site.name])}, fleet says "
                f"{tuple(site.location)} — nearest-site ranking is wrong",
                layer="fleet", subject=f"table[{site.name!r}]",
                fix_hint="the table entry must be the Site.location")
            return
    yield info("fleet.router.coverage",
               f"routing table covers all {len(names)} sites "
               f"({len(fs.router.down_sites)} currently down)",
               layer="fleet", subject="router.table")


@register_check(
    "fleet.revision.agreement", family="fleet", layer="fleet",
    requires=("fleet",),
    description="every tier (sites + cloud) serves one graph revision")
def check_revision_agreement(ctx: AnalysisContext) -> Iterable[Diagnostic]:
    """After an update fan-out all tiers must fingerprint identically; a
    diverging tier answers queries against a different graph."""
    fleet, fs = _unpack(ctx.fleet)
    if fs is not None:
        graphs = [(name, fs.servers[name].session.plan.graph)
                  for name in fs.tier_names]
    else:
        graphs = [(s.name, s.plan.graph) for s in fleet.sites]
        graphs.append(("cloud", fleet.cloud_plan.graph))
    revs = {name: _tier_revision(g) for name, g in graphs}
    distinct = sorted(set(revs.values()))
    if len(distinct) > 1:
        by_rev = {r: sorted(n for n, v in revs.items() if v == r)
                  for r in distinct}
        yield error(
            "fleet.revision.agreement",
            f"{len(distinct)} graph revisions across tiers: "
            + "; ".join(f"{r[:12]}… -> {ns}" for r, ns in by_rev.items())
            + " — an update fan-out missed at least one tier",
            layer="fleet", subject="graph",
            fix_hint="apply every GraphDelta through FleetServer.update "
                     "so sites and cloud move together")
        return
    yield info("fleet.revision.agreement",
               f"all {len(revs)} tiers on revision {distinct[0][:12]}…",
               layer="fleet", subject="graph")


@register_check(
    "fleet.staleness.consistency", family="fleet", layer="fleet",
    requires=("fleet",),
    description="staleness_bound agrees between FleetServer config, "
                "per-site halo stores and the exchange entry")
def check_staleness_consistency(ctx: AnalysisContext
                                ) -> Iterable[Diagnostic]:
    """The bound the facade reports must be the bound the sessions
    enforce, and any bound > 0 must ride a stale-tolerant exchange."""
    fleet, fs = _unpack(ctx.fleet)
    if fs is None:
        bounds = {s.name: s.plan.config.staleness_bound
                  for s in fleet.sites}
        for name, bound in bounds.items():
            exch = EXCHANGES.resolve(
                fleet.site(name).plan.config.exchange)
            if bound > 0 and not getattr(exch, "stale_tolerant", False):
                yield error(
                    "fleet.staleness.consistency",
                    f"site {name!r} plan has staleness_bound={bound} on "
                    f"exchange {exch.name!r}, which is not stale-tolerant",
                    layer="fleet", subject=f"{name}.config",
                    fix_hint="compile with exchange='halo_async' or "
                             "staleness_bound=0")
                return
        yield info("fleet.staleness.consistency",
                   f"site plan bounds {sorted(set(bounds.values()))} all "
                   "ride stale-tolerant exchanges (or are 0)",
                   layer="fleet", subject="config")
        return
    declared = int(fs.staleness_bound)
    site_bounds = {}
    for name in fleet.site_names:
        sess = fs.servers[name].session
        store = getattr(sess, "_halo", None)
        site_bounds[name] = 0 if store is None else int(store.bound)
        exch = EXCHANGES.resolve(sess.plan.config.exchange)
        if site_bounds[name] > 0 and not getattr(exch, "stale_tolerant",
                                                 False):
            yield error(
                "fleet.staleness.consistency",
                f"site {name!r} serves with bound {site_bounds[name]} on "
                f"exchange {exch.name!r}, which is not stale-tolerant — "
                "its halo replay has no contract",
                layer="fleet", subject=f"{name}.session",
                fix_hint="only 'halo_async' (ExchangeSpec.stale_tolerant) "
                         "may serve stale halo tables")
            return
    effective = max(site_bounds.values()) if site_bounds else 0
    if declared != effective:
        yield error(
            "fleet.staleness.consistency",
            f"FleetServer declares staleness_bound={declared} but its "
            f"site sessions enforce {site_bounds} (effective {effective}) "
            "— reported response staleness would not match the contract",
            layer="fleet", subject="staleness_bound",
            fix_hint="thread one bound through FleetServer(staleness_"
                     "bound=...) instead of mutating sessions directly")
        return
    cloud_store = getattr(fs.servers["cloud"].session, "_halo", None)
    if cloud_store is not None:
        yield error(
            "fleet.staleness.consistency",
            "the cloud tier carries a halo store — the last-resort tier "
            "must always serve fresh (it holds the whole graph; there is "
            "no exchange to skip)",
            layer="fleet", subject="cloud.session",
            fix_hint="compile the cloud plan with staleness_bound=0")
        return
    yield info("fleet.staleness.consistency",
               f"bound {declared} consistent across facade, "
               f"{len(site_bounds)} site sessions and exchange entries "
               "(cloud fresh)",
               layer="fleet", subject="staleness_bound")
