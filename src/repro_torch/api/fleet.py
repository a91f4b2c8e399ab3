"""Geo-distributed fleet serving: ``Fleet`` / ``Router`` / ``FleetServer``.

A ``Server`` serves ONE fog cluster. The paper's millions-of-users story
is many geo-distributed fog *sites* plus a cloud tier, with each request
handled by the site nearest to it — the multi-edge-server deployment
shape. This module is that layer (routing and clocks are host code, a
copy of the JAX reference's; every site's numerics run on its plan's
device):

  * ``Site``        — one named fog site: a geo centroid plus the
    :class:`~repro_torch.api.plan.Plan` compiled for its cluster (every site
    serves the same profiled fog model; ``Engine.compile_fleet`` builds
    them with per-site profiling seeds).
  * ``Fleet``       — N sites + the cloud tier's plan (the existing
    ``"cloud"`` executor as last-resort).
  * ``Router``      — assigns each request to its nearest site from the
    per-request geo ``origin`` (nearest-broker discovery), with
    load-aware spillover to the next-nearest site when the admission
    queue exceeds the ``capacity`` knob, and failover to the cloud tier
    when every site is down or saturated. ``set_down`` is the
    fault-injection hook.
  * ``FleetServer`` — one facade over per-site ``Server`` instances
    (each with its OWN pipeline clock, so sites serve in parallel on the
    simulated timeline) plus a cloud ``Server``. Cross-site clock
    accounting: a routed request arrives at its serving site
    ``routing_delay`` (distance-proportional forwarding) after its true
    arrival, and its ``Response.latency`` is end-to-end from the true
    arrival. Graph updates fan out to every site session and the cloud,
    so all tiers stay on one graph revision.

The WAN speed lever is the stale-tolerant ``exchange="halo_async"``
registry entry (``runtime.bsp``): a site whose shards are WAN-separated
may serve up to ``staleness_bound`` consecutive requests from recorded
halo tables instead of stalling every superstep on the exchange, with
the served staleness recorded on each ``Response``. ``staleness_bound=0``
is bitwise the synchronous ``halo`` exchange (the fresh path IS the halo
exchange — see ``bsp._wire_exchange``). ``faults=`` gives named sites
chaos schedules of their own (``repro_torch.api.faults``): a node crash
fails shards over within its site.

    fleet = Engine(model, "1A+3B", exchange="halo_async",
                   staleness_bound=2).compile_fleet(
        graph, {"north": (59.3, 18.1), "south": (48.2, 16.4)})
    fs = fleet.server(capacity=16)
    out = fs.replay(traces.poisson(
        256, rate=8.0,
        origin_fn=traces.geo_origins(fleet.centroids())))
    print(fs.summarize(out)["sites"])
"""
from __future__ import annotations

import dataclasses
import math
from typing import (Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple, Union)

from repro_torch.api.server import Request, Response, Server
from repro_torch.api.slo import SLOPolicy
from repro_torch.api.updates import GraphDelta, UpdateReport, UpdateRequest

EARTH_RADIUS_KM = 6371.0
#: name of the last-resort tier (reserved; not a legal site name).
CLOUD = "cloud"
#: cross-site forwarding cost model: per-hop handoff overhead plus a
#: distance term at roughly fiber light-speed with routing detours.
ROUTING_BASE_S = 0.002
ROUTING_PER_KM_S = 1.5e-5
#: forwarding handoff into the cloud tier (the WAN feature upload itself
#: is priced by ``simulation.simulate_cloud``; this is just the redirect).
CLOUD_ROUTING_S = 0.004


def haversine_km(a: Tuple[float, float], b: Tuple[float, float]) -> float:
    """Great-circle distance in km between two (lat, lon) pairs (degrees)."""
    lat1, lon1 = math.radians(a[0]), math.radians(a[1])
    lat2, lon2 = math.radians(b[0]), math.radians(b[1])
    h = (math.sin((lat2 - lat1) / 2.0) ** 2
         + math.cos(lat1) * math.cos(lat2)
         * math.sin((lon2 - lon1) / 2.0) ** 2)
    return 2.0 * EARTH_RADIUS_KM * math.asin(min(1.0, math.sqrt(h)))


@dataclasses.dataclass(frozen=True)
class Site:
    """One named fog site: geo centroid + the Plan serving it."""
    name: str
    location: Tuple[float, float]
    plan: object

    def __post_init__(self):
        if not self.name or self.name == CLOUD:
            raise ValueError(f"illegal site name {self.name!r} "
                             f"({CLOUD!r} is the reserved last-resort tier)")
        loc = tuple(float(x) for x in self.location)
        if len(loc) != 2:
            raise ValueError(f"site {self.name!r} location must be "
                             f"(lat, lon), got {self.location!r}")
        object.__setattr__(self, "location", loc)


@dataclasses.dataclass(frozen=True)
class Fleet:
    """N geo-distributed fog sites plus the cloud tier, one shared model.

    Built by ``Engine.compile_fleet``; each site's ``Plan`` came from the
    same engine configuration (one profiled fog model) with a per-site
    profiling seed, and ``cloud_plan`` is the same model compiled for the
    ``"cloud"`` executor.
    """
    sites: Tuple[Site, ...]
    cloud_plan: object

    def __post_init__(self):
        if not self.sites:
            raise ValueError("a Fleet needs at least one site")
        names = [s.name for s in self.sites]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate site names: {names}")

    @property
    def site_names(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self.sites)

    def site(self, name: str) -> Site:
        for s in self.sites:
            if s.name == name:
                return s
        raise KeyError(f"unknown site {name!r}; "
                       f"available: {', '.join(self.site_names)}")

    def centroids(self) -> List[Tuple[float, float]]:
        """Site centroids in listed order (feed ``traces.geo_origins``)."""
        return [s.location for s in self.sites]

    def server(self, **kw) -> "FleetServer":
        """Open the fleet-wide serving facade (see :class:`FleetServer`)."""
        return FleetServer(self, **kw)

    def describe(self) -> dict:
        return {
            "sites": {s.name: {"location": s.location,
                               "fogs": [f.name for f in s.plan.fogs]}
                      for s in self.sites},
            "cloud": {"executor": self.cloud_plan.config.executor},
            "model": {"kind": self.cloud_plan.model.kind,
                      "layers": self.cloud_plan.model.num_layers},
        }


@dataclasses.dataclass(frozen=True)
class RouteDecision:
    """Where one request goes and why.

    ``route`` ∈ {"local", "spilled", "failed_over", "recovered"}:
    nearest site / load spillover to another site / rerouted off a down
    tier (or to the cloud because everything is down or saturated) /
    pulled back to its revived home site by ``set_down(name, False)``.
    """
    site: str
    route: str
    distance_km: float

    @property
    def routing_delay(self) -> float:
        if self.site == CLOUD:
            return CLOUD_ROUTING_S
        return ROUTING_BASE_S + self.distance_km * ROUTING_PER_KM_S


class Router:
    """Nearest-site router with load spillover and cloud failover.

    The routing table maps every site name to its centroid — the
    ``analysis.fleet_checks`` coverage check asserts it covers the whole
    fleet. ``set_down`` marks a site unroutable (fault injection);
    ``route`` never returns a down site, spilling first to the
    next-nearest site with admission-queue room and last to the cloud.
    """

    def __init__(self, fleet: Fleet, *, capacity: int = 16):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.fleet = fleet
        self.capacity = int(capacity)
        #: site name -> (lat, lon); must cover every fleet site.
        self.table: Dict[str, Tuple[float, float]] = {
            s.name: s.location for s in fleet.sites}
        self._down: set = set()

    def set_down(self, name: str, down: bool = True) -> None:
        self.fleet.site(name)   # reject unknown names
        if down:
            self._down.add(name)
        else:
            self._down.discard(name)

    def is_down(self, name: str) -> bool:
        return name in self._down

    @property
    def down_sites(self) -> Tuple[str, ...]:
        return tuple(sorted(self._down))

    def rank(self, origin: Optional[Tuple[float, float]]
             ) -> List[Tuple[str, float]]:
        """Every site (down ones included) by distance from ``origin``;
        an origin-less request keeps the fleet's listed site order at
        distance 0 (the first site is its de-facto home)."""
        if origin is None:
            return [(s.name, 0.0) for s in self.fleet.sites]
        o = (float(origin[0]), float(origin[1]))
        return sorted(
            ((name, haversine_km(o, loc)) for name, loc in
             self.table.items()),
            key=lambda nd: (nd[1], nd[0]))

    def route(self, origin: Optional[Tuple[float, float]],
              queue_depth: Callable[[str], int]) -> RouteDecision:
        """Pick the serving tier for one request.

        ``queue_depth(name)`` is the site's current admission-queue
        length; a site at or above ``capacity`` is skipped (spillover).
        """
        ranked = self.rank(origin)
        nearest = ranked[0][0]
        for name, dist in ranked:
            if name in self._down:
                continue
            if queue_depth(name) >= self.capacity:
                continue
            if name == nearest:
                route = "local"
            elif nearest in self._down:
                route = "failed_over"
            else:
                route = "spilled"
            return RouteDecision(name, route, dist)
        return RouteDecision(CLOUD, "failed_over", ranked[0][1])


@dataclasses.dataclass
class _RouteMeta:
    """Per-request routing bookkeeping (keyed by global request id)."""
    site: str
    route: str
    routing_delay: float
    arrival_time: Optional[float]   # TRUE arrival (pre-forwarding)
    origin: Optional[Tuple[float, float]]


class FleetServer:
    """One serving facade over per-site Servers plus the cloud tier.

    Args:
      fleet: the compiled :class:`Fleet`.
      capacity: per-site admission-queue depth; a submit that would push
        a site's pending queue past it spills to the next-nearest site
        (and ultimately to the cloud). This is the Router's load knob.
      staleness_bound: overrides every site plan's
        ``config.staleness_bound`` (the cloud tier always serves fresh —
        it holds the whole graph, there is no exchange to skip).
      slo: ``None`` / ``True`` / one :class:`~repro_torch.api.slo.SLOPolicy`
        for every tier, or a per-site table from
        :func:`repro_torch.api.slo.per_site` (``"default"`` covers unnamed
        sites, ``"cloud"`` the last-resort tier).
      faults: optional per-site chaos table ``{site_name:
        FaultSchedule}`` (``repro_torch.api.faults``) — each named site's
        Server replays its schedule on its own clock (node crashes fail
        shards over *within* the site; whole-site outages are
        ``set_down``). The cloud tier never takes node faults.
      max_batch / max_wait / pipelined / adaptive_batch / session kwargs:
        forwarded to each per-site ``Server``/``Session``.

    Every site Server keeps its own pipeline clock: two sites serve
    concurrently on the simulated timeline, and only requests routed to
    the same site queue behind each other. Responses are post-adjusted so
    ``latency`` runs from the TRUE arrival (forwarding delay included,
    ``deadline_met`` re-evaluated) and carry ``site`` / ``route`` /
    ``routing_delay``.
    """

    def __init__(self, fleet: Fleet, *, capacity: int = 16,
                 max_batch: int = 8, max_wait: float = 0.0,
                 pipelined: bool = True,
                 slo: Union[None, bool, SLOPolicy, Mapping[str, object]]
                 = None,
                 adaptive_batch=None,
                 staleness_bound: Optional[int] = None,
                 faults: Optional[Mapping[str, object]] = None,
                 **session_kw):
        self.fleet = fleet
        self.router = Router(fleet, capacity=capacity)
        if faults is not None:
            unknown = set(faults) - set(fleet.site_names)
            if unknown:
                raise ValueError(
                    f"fault schedules for unknown sites {sorted(unknown)}; "
                    f"available: {', '.join(fleet.site_names)}")
        if isinstance(slo, Mapping):
            unknown = (set(slo) - set(fleet.site_names)
                       - {CLOUD, "default"})
            if unknown:
                raise ValueError(
                    f"per-site slo names {sorted(unknown)} are not fleet "
                    f"sites; available: {', '.join(fleet.site_names)} "
                    f"(+ 'cloud', 'default')")
        self._slo_table = slo
        self.staleness_bound = (
            max(s.plan.config.staleness_bound for s in fleet.sites)
            if staleness_bound is None else int(staleness_bound))
        srv_kw = dict(max_batch=max_batch, max_wait=max_wait,
                      pipelined=pipelined, adaptive_batch=adaptive_batch)
        self.servers: Dict[str, Server] = {}
        for site in fleet.sites:
            kw = dict(session_kw)
            if staleness_bound is not None:
                kw["staleness_bound"] = int(staleness_bound)
            self.servers[site.name] = site.plan.server(
                slo=self._slo_for(site.name),
                faults=None if faults is None else faults.get(site.name),
                **srv_kw, **kw)
        # The cloud tier serves fresh: single-program numerics, no
        # cross-fog exchange, nothing to replay.
        self.servers[CLOUD] = fleet.cloud_plan.server(
            slo=self._slo_for(CLOUD), **srv_kw, **session_kw)
        self._next_id = 0
        self._routes: Dict[int, _RouteMeta] = {}
        #: per-fleet drop counter — stays 0 by construction (set_down
        #: reroutes pending work; the counter exists so benchmarks can
        #: assert it).
        self.dropped = 0

    def _slo_for(self, name: str):
        slo = self._slo_table
        if isinstance(slo, Mapping):
            return slo.get(name, slo.get("default"))
        return slo

    # -- routing ------------------------------------------------------------

    def queue_depth(self, name: str) -> int:
        return len(self.servers[name]._pending)

    @property
    def tier_names(self) -> Tuple[str, ...]:
        return self.fleet.site_names + (CLOUD,)

    def submit(self, request: Union[Request, "object", None] = None, *,
               arrival_time: Optional[float] = None,
               origin: Optional[Tuple[float, float]] = None,
               **kw) -> Request:
        """Route one request to a tier and enqueue it there.

        Accepts a ``Request``, a feature array, or None (re-serve stored
        features); ``origin`` overrides the request's coordinates. Graph
        updates don't route — they fan out to every tier; use
        :meth:`update` (a ``GraphDelta``/``UpdateRequest`` here raises).
        """
        if isinstance(request, (GraphDelta, UpdateRequest)):
            raise TypeError(
                "graph updates are not routable requests — they must "
                "reach every tier; use FleetServer.update(delta)")
        if not isinstance(request, Request):
            request = Request(features=request, arrival_time=arrival_time,
                              origin=origin, **kw)
        elif origin is not None:
            request = dataclasses.replace(request, origin=origin)
        if request.request_id is None:
            request = dataclasses.replace(request,
                                          request_id=self._next_id)
        self._next_id = max(self._next_id, request.request_id) + 1
        decision = self.router.route(request.origin, self.queue_depth)
        self._enqueue(request, decision, request.arrival_time,
                      decision.routing_delay)
        return request

    def _enqueue(self, request: Request, decision: RouteDecision,
                 true_arrival: Optional[float], delay: float) -> None:
        """Hand a routed request to its tier's Server: it arrives there
        ``delay`` after its true arrival (cross-site clock accounting);
        closed-loop requests (true arrival None) keep their closed-loop
        semantics and the delay is added to reported latency instead."""
        shifted = (None if true_arrival is None
                   else float(true_arrival) + delay)
        self.servers[decision.site].submit(
            dataclasses.replace(request, arrival_time=shifted))
        self._routes[request.request_id] = _RouteMeta(
            site=decision.site, route=decision.route, routing_delay=delay,
            arrival_time=true_arrival, origin=request.origin)

    # -- fault injection -----------------------------------------------------

    def set_down(self, name: str, down: bool = True) -> int:
        """Mark a site down (or back up). Going down reroutes the site's
        whole pending queue through the router — queued work is forwarded
        (one extra site-to-site hop on its routing delay), never dropped.
        Coming back up pulls still-pending requests that failed over off
        this site back to it (route ``"recovered"``, one return hop);
        fresh submits to the revived site simply route ``"local"``
        again. Returns how many pending requests were moved either way.
        """
        self.router.set_down(name, down)
        if not down:
            dst_loc = self.fleet.site(name).location
            moved = 0
            for other in self.tier_names:
                if other == name:
                    continue
                srv = self.servers[other]
                keep = []
                for req in srv._pending:
                    meta = (self._routes.get(req.request_id)
                            if isinstance(req, Request) else None)
                    if (meta is None or meta.route != "failed_over"
                            or self.router.rank(meta.origin)[0][0] != name):
                        keep.append(req)
                        continue
                    # Pull the refugee home: it pays one return hop from
                    # wherever it was parked back to its revived site.
                    hop = (CLOUD_ROUTING_S if other == CLOUD
                           else ROUTING_BASE_S
                           + ROUTING_PER_KM_S * haversine_km(
                               self.fleet.site(other).location, dst_loc))
                    home_dist = self.router.rank(meta.origin)[0][1]
                    self._enqueue(
                        dataclasses.replace(req,
                                            arrival_time=meta.arrival_time),
                        RouteDecision(name, "recovered", home_dist),
                        meta.arrival_time, meta.routing_delay + hop)
                    moved += 1
                srv._pending = keep
            return moved
        srv = self.servers[name]
        pending, srv._pending = srv._pending, []
        src_loc = self.fleet.site(name).location
        for req in pending:
            meta = self._routes[req.request_id]
            decision = self.router.route(meta.origin, self.queue_depth)
            hop = (CLOUD_ROUTING_S if decision.site == CLOUD
                   else ROUTING_BASE_S + ROUTING_PER_KM_S * haversine_km(
                       src_loc, self.fleet.site(decision.site).location))
            # The request already traveled to the down site; it pays one
            # more forwarding hop to wherever it lands now.
            self._enqueue(
                dataclasses.replace(req, arrival_time=meta.arrival_time),
                dataclasses.replace(decision, route="failed_over"),
                meta.arrival_time, meta.routing_delay + hop)
        return len(pending)

    # -- updates -------------------------------------------------------------

    def update(self, delta: GraphDelta) -> Dict[str, UpdateReport]:
        """Fan one graph mutation out to EVERY tier (sites + cloud), so
        all plans stay on one graph revision (asserted by
        ``analysis.fleet_checks``). Returns per-tier update reports."""
        out: Dict[str, UpdateReport] = {}
        for name in self.tier_names:
            srv = self.servers[name]
            out[name] = srv.session.update(delta)
            srv.last_update_report = out[name]
            srv._svc_cache.clear()
            srv._note_plan()   # re-track the fault-recovery restore target
        return out

    # -- serving -------------------------------------------------------------

    def drain(self) -> List[object]:
        """Drain every tier and merge the responses onto the fleet
        timeline (ordered by finish time). Each site drains on its own
        pipeline clock — the parallelism of geo-distributed serving.
        Responses are rewritten to fleet view: ``site``/``route``/
        ``routing_delay`` set, ``latency`` end-to-end from the TRUE
        arrival, ``deadline_met`` re-evaluated against it.
        """
        out: List[object] = []
        for name in self.tier_names:
            for r in self.servers[name].drain():
                meta = self._routes.pop(getattr(r, "request_id", -1), None)
                if meta is None or not isinstance(r, Response):
                    out.append(r)
                    continue
                latency = r.latency + meta.routing_delay
                true_arrival = (meta.arrival_time
                                if meta.arrival_time is not None
                                else r.arrival_time - meta.routing_delay)
                breakdown = dict(r.breakdown)
                breakdown["routing"] = meta.routing_delay
                breakdown["total"] = latency
                out.append(dataclasses.replace(
                    r, site=name, route=meta.route,
                    routing_delay=meta.routing_delay,
                    arrival_time=true_arrival, latency=latency,
                    breakdown=breakdown,
                    deadline_met=(None if r.deadline is None
                                  else bool(latency <= r.deadline + 1e-9))))
        out.sort(key=lambda r: (getattr(r, "finish_time", None)
                                or r.arrival_time))
        return out

    def serve(self, requests: Iterable[Request]) -> List[object]:
        """Submit then drain a whole arrival trace.

        Graph updates in the trace fan out fleet-wide at submission time
        (a consistency barrier: every tier moves to the new revision
        before any query in this call is served); their per-tier reports
        land via :meth:`update`, not in the returned list.
        """
        for r in requests:
            if isinstance(r, (GraphDelta, UpdateRequest)):
                self.update(r.delta if isinstance(r, UpdateRequest) else r)
            else:
                self.submit(r)
        return self.drain()

    replay = serve

    # -- reporting -----------------------------------------------------------

    def summarize(self, responses: Sequence[object]) -> Dict[str, object]:
        """Fleet-level metrics: the per-site breakdown of
        ``Server.summarize`` over ALL tiers (a down site with zero served
        requests still appears, its percentile None), plus routing
        counters and the zero-drop assertion input."""
        summary = Server.summarize(responses, sites=self.tier_names)
        resp = [r for r in responses if isinstance(r, Response)]
        summary["routes"] = {
            kind: sum(1 for r in resp if r.route == kind)
            for kind in ("local", "spilled", "failed_over", "recovered")}
        summary["down_sites"] = list(self.router.down_sites)
        summary["capacity"] = self.router.capacity
        summary["staleness_bound"] = self.staleness_bound
        dropped = self.dropped + len(self._routes)
        summary["dropped"] = dropped
        # Fleet view of availability: dropped requests (0 by
        # construction) count against the answered fraction too.
        rej = summary.get("rejected", 0)
        den = len(resp) + rej + dropped
        summary["availability"] = len(resp) / den if den else 1.0
        return summary

    def __repr__(self) -> str:
        return (f"FleetServer(sites={list(self.fleet.site_names)}, "
                f"capacity={self.router.capacity}, "
                f"staleness_bound={self.staleness_bound}, "
                f"down={list(self.router.down_sites)})")
