"""SLO-aware serving control plane: deadlines, priorities, degradation.

The paper's real-time story (5.39x latency, 6.84x throughput) only holds
if latency targets survive load; a ``Server`` that admits everything and
batches with a constant ``max_batch`` simply grows its queue under
overload. This module is the production half of the serving stack: the
*policy* layer the request-level ``Server`` consults before it spends
simulated-clock time on a request.

Four pieces, wired through ``Server(slo=..., adaptive_batch=...)``:

  * **Deadlines + priority classes** — ``Request``/``UpdateRequest`` carry
    ``deadline`` (a latency budget in simulated seconds from arrival) and
    ``priority`` (higher = more important). Every ``repro_torch.api.traces``
    generator annotates them; under overload the Server serves pending
    queries highest-priority-first (never reordering across a graph
    update, so mutation visibility stays FIFO-consistent).
  * **Admission control** — before serving a micro-batch the Server
    estimates its finish time on the simulated clock (current pipeline
    state + ``Session.account(batch_size=B)``). If a member's deadline
    would be blown it walks the :data:`degradation ladder
    <default_ladder>`; if even the last rung misses, the request is
    rejected (a :class:`Rejection`, not silently-late work) — or served
    late when ``reject_hopeless=False``.
  * **Degradation ladder** — an ordered tuple of
    :class:`DegradationLevel` rungs, each a *complete* knob set
    (``aggregation`` / ``compressor`` / ``num_layers``) built cumulatively:
    the strict kernel path (``aggregation="pallas"``) → ``segment_sum``,
    ``daq`` → ``uniform8``, then progressively fewer GNN layers. Each
    rung is served by a cached ``Session`` over
    ``plan.with_overrides(...)``, so a degraded response is **bitwise** a
    session configured with those knobs directly;
    ``Response.degradation`` records the rung.
  * **Adaptive batch sizing** — :class:`AdaptiveBatchController` closes
    the loop on the batched-latency curve: refined online from per-batch
    service observations and queried per drain for the batch size that
    maximizes efficiency ``B / service(B)`` subject to the head-of-line
    deadline slack. ``Server(adaptive_batch=True)`` starts it unseeded:
    the only curve on record, ``BENCH_serving.json``, holds CPU
    interpret-mode times of the JAX package, which say nothing of this
    port's card. ``load_bench_curve(path)`` seeds one from a file the
    caller names.

Updates are not free control-plane work anymore: with the control plane
active, a ``GraphDelta``'s repair is priced by
``core.simulation.simulate_update`` and occupies the execution stage of
the pipeline (an update whose repair cannot meet its deadline is
rejected *before* mutating the graph).
"""
from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

# ----------------------------------------------------------------------------
# Degradation ladder
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DegradationLevel:
    """One rung of the degradation ladder: a complete serving-knob set.

    ``None`` fields inherit the base session's knob. Rungs are complete
    (not diffs): rung k carries every override of rungs 1..k, so the
    Server can jump straight to any rung.
    """
    name: str
    aggregation: Optional[str] = None
    compressor: Optional[str] = None
    num_layers: Optional[int] = None

    def knobs(self) -> Dict[str, object]:
        return {k: v for k, v in (("aggregation", self.aggregation),
                                  ("compressor", self.compressor),
                                  ("num_layers", self.num_layers))
                if v is not None}


def default_ladder(session) -> Tuple[DegradationLevel, ...]:
    """Build the default ladder for a session's base configuration.

    Cumulative, cheapest-sacrifice first:

      1. ``aggregation="segment_sum"`` — only when the base session
         resolves to the block-CSR kernel path (frees the kernel lane; no
         effect on the analytic clock, real effect on hardware).
      2. ``compressor="uniform8"`` — only for DAQ-family plans (drops the
         degree-aware allocation + lossless stage; cheaper device-side
         packing at some wire-byte cost).
      3. ``num_layers=K-1 .. 1`` — truncate the GNN's layer stack, the
         big lever: per-layer matmuls, aggregation AND one K*delta sync
         round each disappear from the critical path.

    Rungs that would be no-ops for the base config are skipped. ``"auto"``
    resolves on the plan's device, so a CPU plan (where it means
    ``segment_sum``) has no segment-sum rung.

    On a failover plan (``plan.provenance == "failover"`` — the session
    serves a degraded-capacity surviving cluster) the non-depth
    sacrifices collapse into one leading **"survivor-degraded"** rung:
    lost capacity means the cheapest headroom (kernel lane + wire bytes)
    is taken in a single step before admission starts trading model
    depth.
    """
    from repro_torch.runtime import bsp   # lazy: keep module import light
    plan = session.plan
    kind = plan.model.kind
    rungs = []
    agg = None
    try:
        exchange = (session._exchange.name
                    if getattr(session._executor, "needs_block_shards",
                               False) else None)
        resolved = bsp.resolve_aggregation(session._aggregation, kind,
                                           exchange=exchange,
                                           device=plan.device)
    except ValueError:
        resolved = "segment_sum"
    if resolved == "pallas":
        agg = "segment_sum"
        rungs.append(DegradationLevel("segment_sum", aggregation=agg))
    comp = None
    if plan.config.compressor.startswith("daq"):
        comp = "uniform8"
        rungs.append(DegradationLevel("uniform8", aggregation=agg,
                                      compressor=comp))
    if getattr(plan, "provenance", "") == "failover" and rungs:
        # Survivor-degraded: on a degraded-capacity failover plan the
        # non-depth sacrifices are one rung, walked first.
        rungs = [DegradationLevel("survivor-degraded", aggregation=agg,
                                  compressor=comp)]
    for layers in range(plan.model.num_layers - 1, 0, -1):
        rungs.append(DegradationLevel(f"layers{layers}", aggregation=agg,
                                      compressor=comp, num_layers=layers))
    return tuple(rungs)


# ----------------------------------------------------------------------------
# Policy + decisions
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """Admission policy the ``Server`` consults per micro-batch.

    Attributes:
      default_deadline: budget (simulated seconds from arrival) applied to
        requests that carry none; ``None`` leaves them deadline-free
        (never degraded for their own sake, never rejected).
      degrade: walk the ladder before giving up. ``False`` = admit/reject
        only.
      reject_hopeless: reject requests that would miss their deadline even
        at the last rung. ``False`` serves them late (at the last rung)
        and lets ``Response.deadline_met`` record the miss.
      ladder: explicit ladder; ``None`` builds :func:`default_ladder`
        from the server's base session.
      update_deadline: default deadline for ``UpdateRequest`` entries that
        carry none (updates are priced, never degraded).
    """
    default_deadline: Optional[float] = None
    degrade: bool = True
    reject_hopeless: bool = True
    ladder: Optional[Tuple[DegradationLevel, ...]] = None
    update_deadline: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class Rejection:
    """An admission-controller reject: the request was never served.

    Takes the place of a ``Response`` in ``Server.drain`` output (service
    order preserved); ``estimated_latency`` is the finish-minus-arrival
    the controller predicted at the best (most degraded) rung it
    considered. A rejected update never mutated the graph.
    """
    request_id: int
    arrival_time: float
    priority: int = 0
    deadline: Optional[float] = None
    estimated_latency: float = 0.0
    kind: str = "query"          # "query" | "update"
    reason: str = "deadline"


# ----------------------------------------------------------------------------
# Adaptive batch sizing
# ----------------------------------------------------------------------------


class AdaptiveBatchController:
    """Pick the micro-batch size from the measured batched-latency curve.

    The controller maintains an EMA of observed per-batch service time
    ``s(B)`` (collect + execute on the serving clock), optionally seeded
    from a benchmark curve (batch size -> whole-batch seconds, e.g.
    :func:`load_bench_curve` of a file the caller names). Seed points
    are treated as a *shape prior*: once online observations exist, the
    seed curve is rescaled onto them (wall-clock benchmark seconds and
    simulated serving seconds differ in scale but share the amortization
    shape), and an online point always wins over a seed point at the
    same B.

    ``pick(backlog, slack=...)`` returns the B in ``[1, min(max_batch,
    backlog)]`` maximizing efficiency ``B / s(B)`` among sizes whose
    estimated service fits the head-of-line deadline slack; if nothing
    fits, 1 (serve the fastest thing we can); with no observations at
    all, the full backlog (optimistic: amortize everything queued).
    """

    def __init__(self, max_batch: int = 32, *,
                 seed_curve: Optional[Dict[int, float]] = None,
                 alpha: float = 0.4):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.max_batch = int(max_batch)
        self.alpha = float(alpha)
        self._seed = {int(b): float(s) for b, s in (seed_curve or {}).items()
                      if int(b) >= 1 and float(s) > 0.0}
        self._seed_scale = 1.0
        self._obs: Dict[int, float] = {}

    # -- learning ---------------------------------------------------------

    def observe(self, batch_size: int, service_s: float) -> None:
        """Fold one measured per-batch service time into the curve."""
        b, s = int(batch_size), float(service_s)
        if b < 1 or s <= 0.0 or not np.isfinite(s):
            return
        prev = self._obs.get(b)
        self._obs[b] = s if prev is None else (
            (1.0 - self.alpha) * prev + self.alpha * s)
        if self._seed:
            # Re-anchor the seed curve's scale on the online points.
            ratios = [self._obs[k] / self._raw_seed_estimate(k)
                      for k in self._obs]
            self._seed_scale = float(np.median(ratios))

    def _raw_seed_estimate(self, b: int) -> float:
        xs = sorted(self._seed)
        ys = [self._seed[x] for x in xs]
        return float(np.interp(b, xs, ys)) if len(xs) > 1 else ys[0]

    def _points(self) -> Dict[int, float]:
        pts = {b: s * self._seed_scale for b, s in self._seed.items()}
        pts.update(self._obs)
        return pts

    def estimate(self, batch_size: int) -> Optional[float]:
        """Estimated per-batch service seconds at ``batch_size``.

        Exact (EMA/seed) where observed; linear interpolation between
        observed sizes; affine extrapolation beyond them. ``None`` with no
        data at all.
        """
        pts = self._points()
        if not pts:
            return None
        b = int(batch_size)
        if b in pts:
            return pts[b]
        xs = np.array(sorted(pts), float)
        ys = np.array([pts[int(x)] for x in xs])
        if len(xs) == 1:
            return float(ys[0])
        if xs[0] <= b <= xs[-1]:
            return float(np.interp(b, xs, ys))
        slope, icept = np.polyfit(xs, ys, 1)
        return float(max(slope * b + icept, 1e-9))

    # -- decision ---------------------------------------------------------

    def pick(self, backlog: int, *, slack: Optional[float] = None) -> int:
        """Batch size for the next drain given ``backlog`` queued requests
        and the head-of-line request's deadline ``slack`` (seconds left
        before its collection must start finishing; None = unconstrained).
        """
        cap = max(1, min(self.max_batch, int(backlog)))
        if not self._points():
            return cap
        best_b, best_eff = None, -1.0
        for b in range(1, cap + 1):
            s = self.estimate(b)
            if slack is not None and s > slack:
                continue
            eff = b / max(s, 1e-12)
            if eff > best_eff:
                best_b, best_eff = b, eff
        return 1 if best_b is None else best_b

    def __repr__(self) -> str:
        return (f"AdaptiveBatchController(max_batch={self.max_batch}, "
                f"observed={sorted(self._obs)}, "
                f"seeded={sorted(self._seed)})")


def load_bench_curve(path: str, *, executor: str = "sim",
                     aggregation: str = "segment_sum") -> Dict[int, float]:
    """Seed curve for :class:`AdaptiveBatchController` from a serving sweep
    in the ``BENCH_serving.json`` layout at ``path``: batch size ->
    whole-batch seconds (``batched_s``), averaged over matching rows.
    Returns ``{}`` when the file is missing or malformed — the controller
    then starts cold.

    There is no default file: the repository's ``BENCH_serving.json``
    holds CPU interpret-mode times of the JAX package, and no such number
    stands for this port's card. Name a sweep measured on the card.

    When the file has rows but none match the requested (executor,
    aggregation) pair, a :class:`RuntimeWarning` is emitted and the
    closest available pair is used instead — same executor first, then
    same aggregation, then any — so a controller asked for an unswept
    combination is seeded with a related curve rather than silently
    starting cold.
    """
    try:
        with open(path) as f:
            payload = json.load(f)
        rows = payload["rows"]
    except (OSError, ValueError, KeyError, TypeError):
        return {}
    by_pair: Dict[Tuple[str, str], Dict[int, list]] = {}
    for row in rows:
        try:
            pair = (str(row["executor"]), str(row["aggregation"]))
            by_pair.setdefault(pair, {}).setdefault(
                int(row["batch"]), []).append(float(row["batched_s"]))
        except (ValueError, KeyError, TypeError):
            continue
    if not by_pair:
        return {}
    want = (executor, aggregation)
    if want not in by_pair:
        fallback = (
            [p for p in sorted(by_pair) if p[0] == executor]
            or [p for p in sorted(by_pair) if p[1] == aggregation]
            or sorted(by_pair))[0]
        warnings.warn(
            f"load_bench_curve: no rows for executor={executor!r} "
            f"aggregation={aggregation!r} in {path}; falling back to "
            f"executor={fallback[0]!r} aggregation={fallback[1]!r}",
            RuntimeWarning, stacklevel=2)
        want = fallback
    curve = by_pair[want]
    return {b: float(np.mean(v)) for b, v in curve.items() if v}


# ----------------------------------------------------------------------------
# Trace annotation helpers
# ----------------------------------------------------------------------------


def slo_classes(classes: Sequence[Tuple[float, int, Optional[float]]]):
    """Build a ``slo_fn`` for the ``repro_torch.api.traces`` generators from a
    mixed-criticality class spec: ``[(weight, priority, deadline), ...]``
    (weights need not sum to 1; deadline None = best-effort). Each request
    draws one class — e.g. 30% critical anomaly-detection traffic under a
    tight deadline over 70% background analytics::

        slo_fn = slo.slo_classes([(0.3, 2, 0.5), (0.7, 0, None)])
        trace = traces.poisson(256, rate=8.0, slo_fn=slo_fn)
    """
    if not classes:
        raise ValueError("classes must be non-empty")
    weights = np.array([c[0] for c in classes], float)
    if (weights <= 0).any():
        raise ValueError("class weights must be > 0")
    probs = weights / weights.sum()

    def slo_fn(i: int, rng: np.random.Generator):
        _, priority, deadline = classes[int(rng.choice(len(probs), p=probs))]
        return deadline, int(priority)

    return slo_fn


# ----------------------------------------------------------------------------
# Per-site policies (for a fleet front-end; the port has none yet: ROADMAP
# Queue 1 item 2, fleet and stale halos)
# ----------------------------------------------------------------------------


def per_site(default: Optional[SLOPolicy] = None,
             **overrides: Optional[SLOPolicy]) -> Dict[str, object]:
    """Build a per-site SLO policy table for ``FleetServer(slo=...)``.

    Keyword arguments map site names (including the ``"cloud"`` tier) to
    their :class:`SLOPolicy`; every other site serves under ``default``
    (None = that site runs without a control plane). Typical shape: a
    tight edge-side deadline with a laxer cloud fallback::

        slo.per_site(SLOPolicy(default_deadline=0.5),
                     cloud=SLOPolicy(default_deadline=2.0))

    The FleetServer validates the names against its site table at
    construction, so a typo'd site fails fast instead of silently serving
    policy-free.
    """
    for name, pol in overrides.items():
        if pol is not None and not isinstance(pol, SLOPolicy):
            raise TypeError(f"per-site policy {name!r} must be an SLOPolicy "
                            f"or None, got {type(pol).__name__}")
    if default is not None and not isinstance(default, SLOPolicy):
        raise TypeError(f"default must be an SLOPolicy or None, got "
                        f"{type(default).__name__}")
    table: Dict[str, object] = {"default": default}
    table.update(overrides)
    return table
