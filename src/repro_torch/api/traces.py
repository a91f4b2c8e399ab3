"""Arrival-trace generators for the request-level serving front-end.

Each generator returns a list of ``Request`` objects with nondecreasing
``arrival_time`` on the simulated clock — the input shape
``Server.replay`` consumes. Rates are requests/second.

  poisson(n, rate)            memoryless arrivals (exp inter-arrivals) —
                              the standard open-loop serving workload.
  constant(n, rate)           deterministic 1/rate spacing.
  bursty(n, rate, ...)        batched sensor wake-ups: bursts of
                              near-simultaneous queries separated by
                              idle gaps, at the same long-run rate.
  mixed(n, rate, ...)         interleaved update/query stream for mutating
                              IoT graphs: each Poisson arrival is a graph
                              update (``UpdateRequest``) with probability
                              ``update_fraction``, else a query.

``features_fn(i, rng)`` optionally attaches fresh per-request feature
uploads (e.g. noisy sensor readings); by default requests re-serve the
graph's stored features (``features=None``).

SLO annotations (read by the Server's control plane, ``repro_torch.api.slo``):
every generator takes ``deadline=`` / ``priority=`` to stamp the whole
trace with one latency budget and class rank, or ``slo_fn(i, rng) ->
(deadline, priority)`` for per-request annotations — e.g. the output of
``repro_torch.api.slo.slo_classes`` for a weighted mix of service classes.
``slo_fn`` wins over the scalar kwargs; in ``mixed`` traces it annotates
updates too.

Geo annotations (read by a fleet router, which the port does not have
yet: ROADMAP Queue 1 item 2, fleet and stale halos): every
generator takes ``origin_fn(i) -> (lat, lon)`` to stamp per-request geo
coordinates — :func:`geo_origins` builds one from site centroids with a
zipfian site-popularity mixer. ``origin_fn`` owns its own RNG stream, so
the default (None) keeps every existing trace byte-identical: the shared
generator's feature/SLO draws are never perturbed.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.api.server import Request
from repro_torch.api.updates import GraphDelta, UpdateRequest

FeaturesFn = Callable[[int, np.random.Generator], Optional[np.ndarray]]
DeltaFn = Callable[[int, np.random.Generator], GraphDelta]
#: (index, rng) -> (deadline seconds or None, priority)
SloFn = Callable[[int, np.random.Generator], Tuple[Optional[float], int]]
#: index -> (lat, lon); owns its own RNG stream (see geo_origins) so the
#: generators' shared feature/SLO draws stay untouched.
OriginFn = Callable[[int], Tuple[float, float]]


def geo_origins(centroids: Sequence[Tuple[float, float]], *,
                spread: float = 0.3, zipf_s: float = 1.0,
                seed: int = 0) -> OriginFn:
    """Build an ``origin_fn`` sampling request coordinates around site
    centroids with zipfian site popularity.

    ``centroids`` is a sequence of ``(lat, lon)`` site centers (e.g. the
    fleet's site locations, in listed order). Each request first draws a
    site with probability proportional to ``1 / rank^zipf_s`` (rank =
    1-based centroid position, so earlier sites are more popular;
    ``zipf_s=0`` is uniform), then scatters around that centroid with
    isotropic gaussian noise of ``spread`` degrees — the geo-skewed
    arrival mix a fleet router sees from real IoT deployments.

    The returned function owns a private RNG seeded from ``seed``:
    attaching origins to a trace never changes its arrivals, features or
    SLO annotations.
    """
    cents = [(float(lat), float(lon)) for lat, lon in centroids]
    if not cents:
        raise ValueError("centroids must be non-empty")
    if spread < 0:
        raise ValueError(f"spread must be >= 0, got {spread}")
    ranks = np.arange(1, len(cents) + 1, dtype=float)
    weights = ranks ** -float(zipf_s)
    probs = weights / weights.sum()
    rng = np.random.default_rng(seed)

    def origin_fn(i: int) -> Tuple[float, float]:
        j = int(rng.choice(len(cents), p=probs))
        lat, lon = cents[j]
        dlat, dlon = rng.normal(0.0, spread, size=2)
        return (lat + dlat, lon + dlon)

    return origin_fn


def _slo_of(i: int, rng: np.random.Generator, slo_fn: Optional[SloFn],
            deadline: Optional[float], priority: int
            ) -> Tuple[Optional[float], int]:
    if slo_fn is None:
        return deadline, priority
    d, p = slo_fn(i, rng)
    return (None if d is None else float(d)), int(p)


def _build(arrivals: np.ndarray, features_fn: Optional[FeaturesFn],
           rng: np.random.Generator, executor: Optional[str],
           deadline: Optional[float] = None, priority: int = 0,
           slo_fn: Optional[SloFn] = None,
           origin_fn: Optional[OriginFn] = None) -> List[Request]:
    out = []
    for i, t in enumerate(np.asarray(arrivals, float)):
        feats = None if features_fn is None else features_fn(i, rng)
        d, p = _slo_of(i, rng, slo_fn, deadline, priority)
        # origin_fn draws from its OWN rng (geo_origins), never from the
        # shared one: a trace with origins attached is the byte-identical
        # trace plus coordinates.
        origin = None if origin_fn is None else tuple(origin_fn(i))
        # request_id stays None: the Server assigns ids at submit() in
        # submission order, so they stay unique even when one server
        # replays several traces back to back.
        out.append(Request(features=feats, arrival_time=float(t),
                           executor=executor, deadline=d, priority=p,
                           origin=origin))
    return out


def poisson(n: int, rate: float, *, seed: int = 0,
            features_fn: Optional[FeaturesFn] = None,
            executor: Optional[str] = None,
            deadline: Optional[float] = None, priority: int = 0,
            slo_fn: Optional[SloFn] = None,
            origin_fn: Optional[OriginFn] = None,
            start: float = 0.0) -> List[Request]:
    """``n`` Poisson arrivals at ``rate`` req/s (exponential gaps)."""
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n)
    return _build(start + np.cumsum(gaps), features_fn, rng, executor,
                  deadline, priority, slo_fn, origin_fn)


def constant(n: int, rate: float, *, seed: int = 0,
             features_fn: Optional[FeaturesFn] = None,
             executor: Optional[str] = None,
             deadline: Optional[float] = None, priority: int = 0,
             slo_fn: Optional[SloFn] = None,
             origin_fn: Optional[OriginFn] = None,
             start: float = 0.0) -> List[Request]:
    """``n`` deterministic arrivals spaced exactly ``1/rate`` apart."""
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    rng = np.random.default_rng(seed)
    return _build(start + np.arange(1, n + 1) / rate, features_fn, rng,
                  executor, deadline, priority, slo_fn, origin_fn)


def bursty(n: int, rate: float, *, burst: int = 4, jitter: float = 0.01,
           seed: int = 0, features_fn: Optional[FeaturesFn] = None,
           executor: Optional[str] = None,
           deadline: Optional[float] = None, priority: int = 0,
           slo_fn: Optional[SloFn] = None,
           origin_fn: Optional[OriginFn] = None,
           start: float = 0.0) -> List[Request]:
    """``n`` arrivals in bursts of ~``burst`` near-simultaneous requests.

    Bursts fire every ``burst/rate`` seconds (so the long-run rate is
    ``rate``); within a burst, requests are spread by exponential jitter
    with mean ``jitter`` seconds — the correlated wake-up pattern of
    co-located IoT sensors.
    """
    if rate <= 0 or burst < 1:
        raise ValueError(f"need rate > 0 and burst >= 1, "
                         f"got rate={rate}, burst={burst}")
    rng = np.random.default_rng(seed)
    base = start + (np.arange(n) // burst + 1) * (burst / rate)
    arrivals = np.sort(base + rng.exponential(jitter, size=n))
    return _build(arrivals, features_fn, rng, executor, deadline, priority,
                  slo_fn, origin_fn)


def mixed(n: int, rate: float, *, delta_fn: DeltaFn,
          update_fraction: float = 0.2, seed: int = 0,
          features_fn: Optional[FeaturesFn] = None,
          executor: Optional[str] = None,
          deadline: Optional[float] = None, priority: int = 0,
          slo_fn: Optional[SloFn] = None,
          origin_fn: Optional[OriginFn] = None,
          start: float = 0.0) -> List[Union[Request, UpdateRequest]]:
    """``n`` Poisson arrivals; each is a graph update with probability
    ``update_fraction`` (its ``GraphDelta`` built by ``delta_fn(i, rng)``),
    else an inference query — the mutating-IoT-graph serving workload.

    Updates are applied in arrival order, so ``delta_fn`` must produce
    deltas valid against the *sequentially updated* graph (deltas that
    only touch edges/features of stable vertex ids are the easy case).
    SLO annotations land on updates too: the control plane prices an
    update's repair and can reject one whose deadline is unmeetable.
    """
    if not 0.0 <= update_fraction <= 1.0:
        raise ValueError(f"update_fraction must be in [0, 1], "
                         f"got {update_fraction}")
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    rng = np.random.default_rng(seed)
    arrivals = start + np.cumsum(rng.exponential(1.0 / rate, size=n))
    is_update = rng.random(n) < update_fraction
    out: List[Union[Request, UpdateRequest]] = []
    for i, t in enumerate(arrivals):
        d, p = _slo_of(i, rng, slo_fn, deadline, priority)
        if is_update[i]:
            out.append(UpdateRequest(delta=delta_fn(i, rng),
                                     arrival_time=float(t),
                                     deadline=d, priority=p))
        else:
            feats = None if features_fn is None else features_fn(i, rng)
            origin = None if origin_fn is None else tuple(origin_fn(i))
            out.append(Request(features=feats, arrival_time=float(t),
                               executor=executor, deadline=d, priority=p,
                               origin=origin))
    return out
