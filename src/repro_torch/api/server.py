"""Request-level serving front-end: ``Server`` / ``Request`` / ``Response``.

``Session.query`` is a strictly blocking, one-query-at-a-time call; the
paper's headline throughput numbers come from serving *streams* of
queries with feature collection pipelined against execution (§III-D).
This module adds the arrival-driven layer on top of the Session's
separately callable stages:

  * ``Request``   — one inference query: features (None = the graph's
    stored features), a simulated-clock arrival time (None = closed loop:
    the request is generated the moment the server can admit it, like the
    old serial ``Session.stream``), per-request knobs (executor backend
    override), and the SLO annotations ``deadline`` (latency budget in
    simulated seconds from arrival) and ``priority`` (class rank, higher
    = more important).
  * ``Response``  — extends ``QueryResult`` with queueing, batching and
    pipeline-overlap timings (``queue_delay``, ``batch_size``,
    ``collect_time`` / ``execute_time`` stage splits, ``overlap_saved``)
    plus the control-plane outcome (``deadline_met``, ``degradation``).
  * ``Server``    — admission queue + micro-batcher + two-stage pipeline.
    Compatible consecutive requests (same executor backend) coalesce into
    one micro-batch: one batched feature collect (priced by
    ``simulation.simulate(..., batch_size=B)``: coalesced long-tail, one
    packing overhead, one K*delta sync round) and one executor run over
    the batch. Batch k+1's collection overlaps batch k's execution
    (``simulation.pipeline_schedule``), so the steady-state period is
    max(collect, execute) instead of their sum.

With ``slo=`` (an :class:`repro_torch.api.slo.SLOPolicy`) the Server grows
the SLO control plane: pending queries are served highest-priority-first
(never reordered across a graph update), each micro-batch's finish time
is estimated on the simulated clock before serving, over-budget batches
walk the degradation ladder (segment_sum / uniform8 / fewer layers —
served by cached degraded Sessions over ``plan.with_overrides``, so
degraded responses stay bit-identical to directly-configured sessions),
hopeless requests are rejected as :class:`repro_torch.api.slo.Rejection`
entries, and graph updates are priced by ``simulation.simulate_update``
instead of being free control-plane work. ``adaptive_batch=`` replaces
the fixed ``max_batch`` with a closed-loop
:class:`repro_torch.api.slo.AdaptiveBatchController` pick per drain.

Numerics are exact: each request's embeddings are computed by the same
compressor round-trip + executor numerics as ``Session.query``, so batched
responses are bitwise serial ones. The micro-batch is stacked into one
[B, V, F] array and every backend's ``run_many`` serves it at once — one
``block_spmm_batched`` launch per layer on the single-program kernel path
(plus one ``dequant_spmm_batched`` on the mesh's DAQ halo wire); a batch
of one takes the serial path and launches ``block_spmm``.

With ``faults=`` (a :class:`repro_torch.api.faults.FaultSchedule`) the
server replays chaos events on its simulated clock and walks the recovery
tiers: retry with backoff, stale ride-through, shard failover
(``Engine.fail_nodes``) and restore; responses carry ``retries``,
``recovered`` and ``capacity``.

    server = plan.server(max_batch=8)
    responses = server.replay(traces.poisson(64, rate=4.0))
    for r in responses:
        print(r.request_id, r.queue_delay, r.latency)
    print(server.summarize(responses))
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.api.registry import EXECUTORS
from repro_torch.api.session import QueryResult, Session
from repro_torch.api.slo import (AdaptiveBatchController, Rejection,
                                 SLOPolicy, default_ladder)
from repro_torch.api.updates import GraphDelta, UpdateReport, UpdateRequest
from repro_torch.core import simulation
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class Request:
    """One inference request for the serving front-end.

    ``features`` of None re-serves the graph's stored features.
    ``arrival_time`` is on the simulated clock (seconds); None means
    closed-loop — the request becomes ready the moment the server can
    admit it. ``executor`` optionally overrides the session's backend for
    this request only (requests only batch with same-backend neighbours).
    ``deadline`` is a latency budget in simulated seconds from arrival
    (None = best-effort) and ``priority`` a class rank (higher = more
    important) — both are inert without the Server's SLO control plane,
    except that a deadline always closes an open micro-batch early enough
    to remain meetable (see ``Server.max_wait``).

    ``origin`` is the request's geo coordinates ``(lat, lon)`` — read by
    the fleet router (``repro_torch.api.fleet``) to pick the nearest fog
    site; inert on a single-cluster ``Server``.
    """
    features: Optional[np.ndarray] = None
    arrival_time: Optional[float] = None
    executor: Optional[str] = None
    deadline: Optional[float] = None
    priority: int = 0
    request_id: Optional[int] = None
    origin: Optional[Tuple[float, float]] = None


@dataclasses.dataclass(frozen=True)
class Response(QueryResult):
    """A ``QueryResult`` plus queueing / batching / pipeline timings.

    ``latency`` is end-to-end on the simulated clock: arrival ->
    execution finished (so it includes ``queue_delay``). Invariants
    (tested): ``queue_delay >= 0`` and
    ``latency >= max(collect_time, execute_time)``.

    Control-plane outcome: ``deadline_met`` is None for best-effort
    requests, else whether ``latency <= deadline``; ``degradation`` is
    the ladder rung this request was served at (0 = native knobs).

    Fleet outcome (``repro_torch.api.fleet``; inert on a single-cluster
    server): ``site`` names the fog site (or
    "cloud") that served the request, ``route`` how it got there
    ("local" = nearest site, "spilled" = load spillover to another site,
    "failed_over" = rerouted off a down/saturated tier, "recovered" =
    pulled back to its revived home site), ``routing_delay`` the
    cross-site forwarding time included in ``latency``. ``staleness`` is
    how many serves old the halo features this response read were (0 =
    fresh synchronous exchange; > 0 only under ``exchange="halo_async"``
    with a positive ``staleness_bound``).

    Fault outcome (``repro_torch.api.faults``; inert without an injector):
    ``retries`` counts tier-1 halo-exchange retry attempts charged to
    this response (``breakdown["recovery"]`` carries their backoff
    seconds), ``recovered`` names the strongest recovery tier that fired
    while this batch was forming (None / "retry" / "stale" / "failover"
    / "restored"), and ``capacity`` is "degraded" when the serving plan
    is a post-crash failover plan (``provenance="failover"``) — the
    explicit degradation tag the chaos property test keys on.
    """
    request_id: int = 0
    arrival_time: float = 0.0
    queue_delay: float = 0.0
    service_start: float = 0.0
    finish_time: float = 0.0
    batch_size: int = 1
    batch_index: int = 0
    collect_time: float = 0.0
    execute_time: float = 0.0
    overlap_saved: float = 0.0
    priority: int = 0
    deadline: Optional[float] = None
    deadline_met: Optional[bool] = None
    degradation: int = 0
    staleness: int = 0
    site: Optional[str] = None
    route: str = "local"
    routing_delay: float = 0.0
    retries: int = 0
    recovered: Optional[str] = None
    capacity: str = "full"


@dataclasses.dataclass(frozen=True)
class UpdateResponse:
    """Acknowledgement of one ``UpdateRequest`` in a mixed stream.

    ``applied`` is False when the session's "deferred" policy buffered the
    delta (it is coalesced into one repair at the end of the drain; the
    merged report lands on ``Server.last_update_report``).  Without the
    SLO control plane, updates are free control-plane work on the
    simulated serving clock (``service_time`` = ``finish_time`` = 0);
    with it, ``service_time`` is the repair price
    (``simulation.simulate_update``) and ``finish_time`` when the
    pipeline's execution stage is free again.
    """
    request_id: int
    arrival_time: float
    applied: bool
    pending: int = 0
    report: Optional[UpdateReport] = None
    service_time: float = 0.0
    finish_time: float = 0.0
    deadline: Optional[float] = None
    priority: int = 0


class Server:
    """Micro-batching, pipelining request server over one ``Session``.

    Args:
      session: the ``Session`` whose collect/execute/account stages serve
        every request (or a ``Plan``, from which a fresh session is made).
      max_batch: micro-batch size cap (1 disables coalescing).
      max_wait: how long (simulated seconds) an open batch waits for more
        compatible arrivals beyond its first request before launching.
        An open batch also closes as soon as waiting longer would blow
        its oldest member's deadline.
      pipelined: overlap batch k+1's collection with batch k's execution
        (§III-D). False reproduces the strictly serial loop — the
        ``Session.stream`` baseline.
      slo: an :class:`repro_torch.api.slo.SLOPolicy` (or True for the
        default policy) activating the control plane: priority-first
        service, deadline admission with the degradation ladder,
        rejections, and priced graph updates. None (default) is the
        admit-all server.
      adaptive_batch: an
        :class:`repro_torch.api.slo.AdaptiveBatchController` (or True for
        an unseeded one: no curve on record was measured on the card)
        that picks the micro-batch size per drain from the observed
        batched-latency curve; ``max_batch`` stays the hard cap.
      faults: a :class:`repro_torch.api.faults.FaultSchedule` (or
        ``FaultInjector``, or a list of ``Fault`` events) replayed against
        this server's simulated clock — node crashes walk the three
        recovery tiers (retry/backoff -> stale ride-through -> shard
        failover); see ``repro_torch.api.faults``. None (default) adds
        zero overhead: the fault path is never consulted.

    The server runs on a simulated clock: collection and execution free
    times persist across ``submit``/``drain`` calls, so one server can
    replay an arrival trace incrementally.
    """

    def __init__(self, session: Union[Session, "object"], *,
                 max_batch: int = 8, max_wait: float = 0.0,
                 pipelined: bool = True,
                 slo: Union[None, bool, SLOPolicy] = None,
                 adaptive_batch: Union[None, bool,
                                       AdaptiveBatchController] = None,
                 faults: Union[None, "FaultSchedule", "FaultInjector",
                               Sequence] = None):
        if not isinstance(session, Session):   # accept a Plan for brevity
            session = session.session()
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait < 0:
            raise ValueError(f"max_wait must be >= 0, got {max_wait}")
        self.session = session
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait)
        self.pipelined = bool(pipelined)
        if slo is True:
            slo = SLOPolicy()
        if slo is not None and not isinstance(slo, SLOPolicy):
            raise TypeError(f"slo must be an SLOPolicy (or True/None), got "
                            f"{type(slo).__name__}")
        self.slo = slo
        self.ladder = () if slo is None else (
            slo.ladder if slo.ladder is not None else default_ladder(session))
        if adaptive_batch is True:
            adaptive_batch = AdaptiveBatchController(max_batch=self.max_batch)
        self.batch_controller: Optional[AdaptiveBatchController] = (
            adaptive_batch or None)
        self._pending: List[Union[Request, UpdateRequest]] = []
        self._next_id = 0
        #: UpdateReport of the most recent applied (or flushed) update.
        self.last_update_report: Optional[UpdateReport] = None
        # (collect_free, execute_free, prev_execute_start) resource state
        # for simulation.pipeline_schedule, threaded batch-by-batch so the
        # overlap model lives in one place and the simulated clock
        # persists across drain() calls.
        self._pipe_state = (0.0, 0.0, 0.0)
        self.num_batches = 0
        # Degraded-session cache, one per ladder rung, keyed on the base
        # plan's identity so graph updates rebuild them lazily.
        self._degraded: Dict[int, Tuple[object, Session]] = {}
        # Per-drain cache of Session.account results, keyed (executor
        # key, batch size, ladder rung, stale serve): admission estimates
        # and the serving accounting share one pricing call.
        self._svc_cache: Dict[Tuple[str, int, int, bool],
                              simulation.ServingResult] = {}
        # -- node-level fault tolerance (repro_torch.api.faults) ------------
        self.injector = None
        if faults is not None:
            from repro_torch.api.faults import FaultInjector, FaultSchedule
            if isinstance(faults, FaultInjector):
                self.injector = faults
            elif isinstance(faults, FaultSchedule):
                self.injector = FaultInjector(faults)
            else:
                self.injector = FaultInjector(FaultSchedule(faults))
            known = {n.name for n in session.plan.cluster.nodes}
            bad = set(self.injector.schedule.node_names) - known
            if bad:
                raise ValueError(
                    f"fault schedule targets unknown nodes "
                    f"{sorted(bad)}; cluster has: {', '.join(sorted(known))}")
        #: most recent full-cluster plan — the restore target when every
        #: crashed node has recovered (re-tracked on graph updates).
        self._full_plan = session.plan
        #: names of currently crashed (failed-over) nodes.
        self._crashed: set = set()
        # live stragglers: node name -> (extra background load, expiry t).
        self._slow: Dict[str, Tuple[float, float]] = {}
        # recovery charge pending for the next served batch:
        # (tier tag, priced seconds, retry attempts).
        self._recovery: Optional[Tuple[str, float, int]] = None
        #: requests that were in flight across a failover and were served
        #: on the degraded plan instead of being dropped.
        self.replayed = 0

    # -- admission ----------------------------------------------------------

    def submit(self, request: Union[Request, UpdateRequest, "GraphDelta",
                                    np.ndarray, None] = None, *,
               arrival_time: Optional[float] = None,
               executor: Optional[str] = None,
               deadline: Optional[float] = None,
               priority: int = 0
               ) -> Union[Request, UpdateRequest]:
        """Admit one request (a ``Request``, a feature array, or None) or
        one graph update (an ``UpdateRequest`` or a bare ``GraphDelta``).
        Updates share the query id space and are served in arrival order;
        whether they apply immediately or buffer is the session's
        ``updates`` policy."""
        if isinstance(request, GraphDelta):
            request = UpdateRequest(delta=request, arrival_time=arrival_time,
                                    deadline=deadline, priority=priority)
        if isinstance(request, UpdateRequest):
            if not isinstance(request.delta, GraphDelta):
                raise TypeError("UpdateRequest.delta must be a GraphDelta, "
                                f"got {type(request.delta).__name__}")
        else:
            if not isinstance(request, Request):
                request = Request(features=request,
                                  arrival_time=arrival_time,
                                  executor=executor, deadline=deadline,
                                  priority=priority)
            if isinstance(request.executor, str):
                EXECUTORS.resolve(request.executor)   # reject bad keys early
        if request.request_id is None:
            request = dataclasses.replace(request, request_id=self._next_id)
        self._next_id = max(self._next_id, request.request_id) + 1
        self._pending.append(request)
        return request

    def _exec_key(self, req: Request) -> str:
        key = req.executor
        if key is None:
            key = self.session._executor_key
        if not isinstance(key, str):
            key = getattr(key, "name", key)
        return EXECUTORS.canonical(key)

    def _deadline_of(self, req: Union[Request, UpdateRequest]
                     ) -> Optional[float]:
        """The request's effective latency budget under the policy."""
        if req.deadline is not None:
            return float(req.deadline)
        if self.slo is None:
            return None
        if isinstance(req, UpdateRequest):
            return self.slo.update_deadline
        return self.slo.default_deadline

    # -- serving ------------------------------------------------------------

    def drain(self) -> List[Union[Response, UpdateResponse, Rejection]]:
        """Serve every pending request; responses in service order.

        Updates interleave with query batches at their arrival position:
        an update always closes the open micro-batch (FIFO), then either
        applies immediately ("sync" session policy — later queries see the
        mutated graph) or buffers ("deferred" — later queries in this
        drain read the stale graph, and the whole buffer coalesces into
        one repair when the drain finishes).

        With the control plane active, queries are served
        highest-priority-first *between* updates (reordering across an
        update would change which graph version a query sees), each batch
        passes deadline admission (degrade / reject), and the output may
        contain :class:`~repro_torch.api.slo.Rejection` entries in place of
        responses.

        On a mid-drain failure, unserved requests are requeued and the
        exception is re-raised with the responses already produced (served
        queries and applied-update acks, whose side effects persist)
        attached as ``exc.partial_responses``, so mixed streams stay
        recoverable.
        """
        reqs = self._pending
        self._pending = []
        self._svc_cache.clear()   # graph/load/placement may have moved
        # Stable order by arrival. A closed-loop request (arrival_time
        # None) is ready the moment it is admitted, i.e. no earlier than
        # anything submitted before it: it inherits the latest arrival
        # seen so far (0.0 when nothing timed precedes it), so untimed
        # submissions — in particular graph updates — keep their FIFO
        # position instead of sorting to the front of timed traffic.
        eff = []
        latest = 0.0
        for r in reqs:   # submission order
            if r.arrival_time is None:
                eff.append(latest)
            else:
                latest = max(latest, r.arrival_time)
                eff.append(r.arrival_time)
        order = sorted(range(len(reqs)), key=lambda i: eff[i])
        out: List[Union[Response, UpdateResponse, Rejection]] = []
        i = 0
        try:
            while i < len(order):
                if self.slo is not None:
                    order[i:] = self._reorder_ready(reqs, order[i:], eff)
                if self.injector is not None:
                    # Chaos events up to the next service instant fire
                    # before the batch forms: a crash here fails the node
                    # over and the remaining requests (still queued =
                    # in flight) are served on the degraded plan instead
                    # of being dropped.
                    self._advance_faults(
                        max(self._collect_floor(), eff[order[i]]),
                        in_flight=len(order) - i)
                req = reqs[order[i]]
                if isinstance(req, UpdateRequest):
                    # Consume the update *before* applying it: if the
                    # delta is rejected (bad ids for the current graph),
                    # the requeue handler below must not put it back at
                    # the head of the queue, or every later drain would
                    # re-trip on it and starve the requests behind it.
                    i += 1
                    out.append(self._handle_update(req))
                    continue
                batch, arrs = self._form_batch(reqs, order, i)
                if self.slo is None:
                    out.extend(self._serve_batch(
                        [reqs[k] for k in batch], max(arrs)))
                else:
                    survivors, s_arrs, level, rejections = self._admit(
                        [reqs[k] for k in batch], arrs)
                    out.extend(rejections)
                    if survivors:
                        out.extend(self._serve_batch(
                            survivors, max(s_arrs), level=level))
                i += len(batch)   # only after serving: a failed batch requeues
            if self.session.pending_updates:   # deferred: one coalesced repair
                self.last_update_report = self.session.flush_updates()
                self._note_plan()
        except BaseException as exc:
            # Don't lose work on a mid-drain failure (bad executor key,
            # wrong feature shape, rejected delta, ...): requeue
            # everything unserved, and hand the caller what was already
            # produced — applied updates mutated the session for good.
            self._pending = [reqs[k] for k in order[i:]] + self._pending
            exc.partial_responses = out
            raise
        return out

    def _reorder_ready(self, reqs: Sequence, rest: List[int],
                       eff: Sequence[float]) -> List[int]:
        """Clock-aware priority pick: move the highest class to the head.

        Only requests that have *arrived* by the next service instant
        compete — a future high-priority arrival never preempts work
        that is queued now (that would starve low classes even at
        sustainable load). Updates are a barrier in both directions:
        the ready set stops at the next update in arrival order, and an
        update at the head is served before any later query regardless
        of priority (reordering across it would change which graph
        version a query sees). Not-yet-arrived requests keep arrival
        order.
        """
        rest = sorted(rest, key=lambda k: (eff[k], k))
        if isinstance(reqs[rest[0]], UpdateRequest):
            return rest
        t = max(self._collect_floor(), eff[rest[0]])
        ready: List[int] = []
        for k in rest:
            if isinstance(reqs[k], UpdateRequest) or eff[k] > t + 1e-12:
                break
            ready.append(k)
        ready.sort(key=lambda k: (-reqs[k].priority, eff[k], k))
        return ready + rest[len(ready):]

    def _handle_update(self, req: UpdateRequest
                       ) -> Union[UpdateResponse, Rejection]:
        arrival = (self._collect_floor() if req.arrival_time is None
                   else req.arrival_time)
        if self.slo is None:
            # Legacy behavior: updates are free control-plane work.
            report = self.session.update(req.delta)
            if report is not None:
                self.last_update_report = report
            self._svc_cache.clear()   # pricing may have moved with the graph
            self._note_plan()
            return UpdateResponse(request_id=req.request_id,
                                  arrival_time=arrival,
                                  applied=report is not None,
                                  pending=self.session.pending_updates,
                                  report=report)
        # Update-aware admission: the repair occupies the execution stage
        # (the superstep must quiesce while the layout mutates), priced on
        # the same simulated clock as query batches.
        t_u = simulation.simulate_update(self.session.plan.cluster,
                                         req.delta)
        sched = simulation.pipeline_schedule(
            [(arrival, 0.0, t_u)], pipelined=self.pipelined,
            start=self._pipe_state)[-1]
        deadline = self._deadline_of(req)
        if (deadline is not None and self.slo.reject_hopeless
                and sched.execute_end > arrival + deadline + 1e-12):
            return Rejection(request_id=req.request_id, arrival_time=arrival,
                             priority=req.priority, deadline=deadline,
                             estimated_latency=sched.execute_end - arrival,
                             kind="update")
        report = self.session.update(req.delta)
        if report is not None:
            self.last_update_report = report
        self._pipe_state = simulation.schedule_state(sched)
        self._svc_cache.clear()   # pricing may have moved with the graph
        self._note_plan()
        return UpdateResponse(request_id=req.request_id,
                              arrival_time=arrival,
                              applied=report is not None,
                              pending=self.session.pending_updates,
                              report=report, service_time=t_u,
                              finish_time=sched.execute_end,
                              deadline=deadline, priority=req.priority)

    # -- fault tolerance (repro_torch.api.faults) ---------------------------

    def _advance_faults(self, t: float, in_flight: int = 0) -> None:
        """Replay every scheduled fault due by simulated time ``t``.

        Straggler expiries are undone first (their end time may precede
        the next injected event), then each due event walks the recovery
        machinery: stragglers mutate the live node's ``background_load``
        (pricing only — numerics are load-independent), halo losses walk
        the retry -> stale -> failover tier ladder, crashes fail the node
        over immediately, and recovers restore the full-cluster plan.
        """
        for name, (extra, end) in list(self._slow.items()):
            if end <= t + 1e-12:
                self._set_load(name, -extra)
                del self._slow[name]
        for f in self.injector.due(t):
            if f.kind == "straggler":
                if f.node in self._crashed:
                    continue   # a crashed node cannot also be slow
                old = self._slow.pop(f.node, None)
                if old is not None:
                    self._set_load(f.node, -old[0])
                extra = f.slowdown - 1.0
                if self._set_load(f.node, extra):
                    self._slow[f.node] = (extra, f.time + f.duration)
            elif f.kind == "halo_loss":
                self._handle_halo_loss(f, t, in_flight)
            elif f.kind == "crash":
                if f.node not in self._crashed:
                    self._crash(f.node, t, in_flight)
            elif f.kind == "recover":
                self._recover(f.node, t)

    def _handle_halo_loss(self, f, t: float, in_flight: int) -> None:
        """Walk the three recovery tiers for a lost halo exchange:
        (1) retry with exponential backoff within the exchange's timeout,
        (2) ride through on recorded stale halo tables (halo_async within
        ``staleness_bound``), (3) declare the peer dead and fail its
        shard over. The priced recovery seconds charge the next batch."""
        sess = self.session
        if getattr(sess._executor, "pipeline", "") != "multi":
            return   # no cross-fog exchange round to lose
        rec_s, attempts, ok = sess._exchange.recovery_cost(
            f.losses, sess.plan.cluster.sync_cost)
        if ok:
            self._add_recovery("retry", rec_s, attempts)
            return
        if sess.can_serve_stale():
            self._add_recovery("stale", rec_s, attempts)
            return
        names = {n.name for n in sess.plan.cluster.nodes}
        self._add_recovery("retry", rec_s, attempts)
        if f.node is not None and f.node in names and len(names) > 1:
            self._crash(f.node, t, in_flight)

    def _crash(self, name: str, t: float, in_flight: int) -> None:
        """Fail node ``name``'s shard over onto the surviving cluster.

        The session rebases onto ``Engine.fail_nodes`` output (a repair
        onto the survivors, or a fresh compile on them), the priced
        failover time — re-uploading the evicted shard's rows over the LAN
        plus the rebuild flops on the degraded capacity — occupies the
        execution stage on the simulated clock, and the ``in_flight``
        requests still queued are replayed on the new plan (zero drops).
        Crashing the last surviving node is ignored: there is nowhere to
        move the shard, so serving rides on (a real deployment would page
        here).
        """
        sess = self.session
        nodes = sess.plan.cluster.nodes
        names = [n.name for n in nodes]
        if name not in names or len(names) <= 1:
            return
        old = self._slow.pop(name, None)
        if old is not None:
            self._set_load(name, -old[0])
        j = names.index(name)
        moved = int((np.asarray(sess.state.placement.assignment) == j).sum())
        sess.failover([name])
        self._crashed.add(name)
        t_f = simulation.simulate_failover(
            sess.plan.cluster, moved, sess.plan.graph.feature_dim)
        self._occupy(t, t_f)
        self.replayed += in_flight
        self._add_recovery("failover", t_f, 0)

    def _recover(self, name: str, t: float) -> None:
        """Bring node ``name`` back: rebase onto the full-cluster restore
        target (recompiled first if graph updates landed while degraded),
        still minus any *other* nodes that remain crashed. Priced like a
        failover over the vertices that move back."""
        old = self._slow.pop(name, None)
        if old is not None:
            self._set_load(name, -old[0])
        if name not in self._crashed:
            return
        self._crashed.discard(name)
        sess = self.session
        g = sess.plan.graph
        full = self._full_plan
        same = g is full.graph
        if not same:
            same = (ops.graph_fingerprint(g) == ops.graph_fingerprint(
                full.graph) and np.array_equal(g.features,
                                               full.graph.features))
        from repro_torch.api.engine import Engine  # lazy: import cycle
        if not same:
            # Graph updates landed while degraded: the restore target is
            # a fresh full-cluster compile of the *current* graph (the JAX
            # reference imports a module that does not exist here, so it
            # has no output for this branch).
            full = Engine.from_plan(full)._recompile(g)
            self._full_plan = full
        if self._crashed:
            plan2 = Engine.from_plan(full).fail_nodes(
                full, sorted(self._crashed))
        else:
            plan2 = full
        # Vertices whose owning *node* changes move back over the wire.
        old_names = np.array([f.name for f in sess.plan.fogs])
        new_names = np.array([f.name for f in plan2.fogs])
        moved = int((old_names[np.asarray(sess.state.placement.assignment)]
                     != new_names[np.asarray(plan2.placement.assignment)]
                     ).sum())
        sess.rebind(plan2)
        t_r = simulation.simulate_failover(
            plan2.cluster, moved, plan2.graph.feature_dim)
        self._occupy(t, t_r)
        self._add_recovery("restored", t_r, 0)

    _TIER_RANK = {"retry": 0, "stale": 1, "restored": 2, "failover": 3}

    def _add_recovery(self, tag: str, seconds: float, retries: int) -> None:
        """Charge ``seconds`` of recovery work to the next served batch,
        merging with any charge already pending (strongest tag wins)."""
        if self._recovery is None:
            self._recovery = (tag, float(seconds), int(retries))
            return
        t0, s0, n0 = self._recovery
        rank = self._TIER_RANK
        self._recovery = (tag if rank.get(tag, 0) >= rank.get(t0, 0) else t0,
                          s0 + float(seconds), n0 + int(retries))

    def _occupy(self, t: float, seconds: float) -> None:
        """Occupy the execution stage with ``seconds`` of recovery work
        starting no earlier than ``t`` (same clock as update repairs)."""
        sched = simulation.pipeline_schedule(
            [(t, 0.0, seconds)], pipelined=self.pipelined,
            start=self._pipe_state)[-1]
        self._pipe_state = simulation.schedule_state(sched)
        self._svc_cache.clear()
        self._degraded.clear()
        self._rebuild_ladder()

    def _set_load(self, name: str, delta: float) -> bool:
        """Adjust a live node's background load by ``delta`` (straggler
        pricing); no-op (False) when the node is not in the current
        cluster — e.g. it crashed while slow."""
        for node in self.session.plan.cluster.nodes:
            if node.name == name:
                node.background_load = max(0.0,
                                           node.background_load + delta)
                self._svc_cache.clear()
                return True
        return False

    def _rebuild_ladder(self) -> None:
        """Re-derive the degradation ladder after a plan swap (a failover
        plan gets the single survivor-degraded rung; restore brings the
        full ladder back). Explicit ``SLOPolicy.ladder`` lists stick."""
        if self.slo is not None and self.slo.ladder is None:
            self.ladder = default_ladder(self.session)

    def _note_plan(self) -> None:
        """Re-track the full-cluster restore target after a graph update
        (only while no node is crashed: a degraded plan must never
        become the restore target)."""
        if not self._crashed:
            self._full_plan = self.session.plan

    def serve(self, requests: Iterable[Request]) -> List[Response]:
        """Submit then drain a whole arrival trace."""
        for r in requests:
            self.submit(r)
        return self.drain()

    def replay(self, queries: Union[int, Iterable], *,
               executor: Optional[str] = None) -> List[Response]:
        """Replay a query stream: an int (closed-loop re-serves of the
        stored features), an iterable of feature arrays (None entries use
        stored features), or an iterable of ``Request`` objects (e.g. from
        ``repro_torch.api.traces``). ``executor`` overrides the backend for
        every request that does not carry its own override.
        """
        if isinstance(queries, int):
            queries = (None for _ in range(queries))
        for q in queries:
            if isinstance(q, Request):
                if executor is not None and q.executor is None:
                    q = dataclasses.replace(q, executor=executor)
                self.submit(q)
            elif isinstance(q, (UpdateRequest, GraphDelta)):
                self.submit(q)
            else:
                self.submit(q, executor=executor)
        return self.drain()

    # -- control plane ------------------------------------------------------

    def _session_for(self, level: int) -> Session:
        """The session serving ladder rung ``level`` (0 = the base
        session); degraded sessions are cached per rung and rebuilt when
        a graph update rebases the base session onto a new plan."""
        if level == 0:
            return self.session
        base_plan = self.session.plan
        cached = self._degraded.get(level)
        if cached is not None and cached[0] is base_plan:
            return cached[1]
        rung = self.ladder[level - 1]
        sess = Session(
            base_plan, executor=self.session._executor_key,
            aggregation=(self.session._aggregation
                         if rung.aggregation is None else rung.aggregation),
            compressor=rung.compressor, num_layers=rung.num_layers,
            accuracy_fn=self.session.accuracy_fn)
        self._degraded[level] = (base_plan, sess)
        return sess

    def _account_for(self, key: str, batch_size: int, level: int,
                     staleness: int = 0) -> simulation.ServingResult:
        # Admission estimates price conservatively at staleness=0 (the
        # fresh synchronous exchange); only the serving path passes the
        # batch's actual staleness, which drops the K*delta sync term.
        ck = (key, batch_size, level, bool(staleness))
        res = self._svc_cache.get(ck)
        if res is None:
            res = self._session_for(level).account(key,
                                                   batch_size=batch_size,
                                                   staleness=staleness)
            self._svc_cache[ck] = res
        return res

    def _estimated_finish(self, key: str, batch_size: int, level: int,
                          ready: float) -> float:
        """Dry-run the batch through the pipeline from the current clock
        state: the admission controller's finish-time estimate."""
        res = self._account_for(key, batch_size, level)
        c_t = float(res.collect.max())
        e_t = res.total_latency - c_t
        sched = simulation.pipeline_schedule(
            [(ready, c_t, e_t)], pipelined=self.pipelined,
            start=self._pipe_state)[-1]
        return sched.execute_end

    def _admit(self, members: List[Request], arrs: List[float]
               ) -> Tuple[List[Request], List[float], int, List[Rejection]]:
        """Deadline admission for one formed batch: pick the lowest ladder
        rung meeting every member's deadline, else reject the hopeless
        members (shrinking the batch and retrying — a smaller batch is
        cheaper, so rejection can rescue the rest)."""
        policy = self.slo
        key = self._exec_key(members[0])
        max_level = len(self.ladder) if policy.degrade else 0
        cur, cur_arrs = list(members), list(arrs)
        rejections: List[Rejection] = []
        while cur:
            ready = max(cur_arrs)
            deadlines = [self._deadline_of(r) for r in cur]
            for level in range(max_level + 1):
                finish = self._estimated_finish(key, len(cur), level, ready)
                if all(d is None or finish <= a + d + 1e-12
                       for a, d in zip(cur_arrs, deadlines)):
                    return cur, cur_arrs, level, rejections
            finish = self._estimated_finish(key, len(cur), max_level, ready)
            hopeless = [j for j, (a, d) in enumerate(zip(cur_arrs, deadlines))
                        if d is not None and finish > a + d + 1e-12]
            if not policy.reject_hopeless or not hopeless:
                # Serve late at the last rung; deadline_met records it.
                return cur, cur_arrs, max_level, rejections
            for j in hopeless:
                r = cur[j]
                rejections.append(Rejection(
                    request_id=r.request_id, arrival_time=cur_arrs[j],
                    priority=r.priority, deadline=deadlines[j],
                    estimated_latency=finish - cur_arrs[j]))
            keep = [j for j in range(len(cur)) if j not in set(hopeless)]
            cur = [cur[j] for j in keep]
            cur_arrs = [cur_arrs[j] for j in keep]
        return cur, cur_arrs, 0, rejections

    # -- internals ----------------------------------------------------------

    def _collect_floor(self) -> float:
        """Earliest simulated time the next collection can start."""
        collect_free, execute_free, _ = self._pipe_state
        if self.pipelined:
            return collect_free
        return max(collect_free, execute_free)

    def _form_batch(self, reqs: Sequence[Request], order: Sequence[int],
                    start: int) -> Tuple[List[int], List[float]]:
        """Coalesce compatible consecutive requests into one micro-batch.

        Returns the member indices (into ``reqs``) and their effective
        arrival times. The batch closes at ``open_t + max_wait`` — or
        earlier, as soon as waiting for the next arrival would leave the
        oldest member's deadline unmeetable at the estimated service
        time; the adaptive batch controller (when installed) caps the
        size below ``max_batch`` from the measured latency curve.
        """
        floor = self._collect_floor()
        first = reqs[order[start]]
        key = self._exec_key(first)
        first_arr = floor if first.arrival_time is None else first.arrival_time
        open_t = max(first_arr, floor)
        cap = self.max_batch
        if self.batch_controller is not None:
            backlog = 0
            for j in range(start, len(order)):
                if isinstance(reqs[order[j]], UpdateRequest):
                    break   # an update closes the batch anyway
                backlog += 1
            dl = self._deadline_of(first)
            slack = (None if dl is None
                     else max(first_arr + dl - open_t, 0.0))
            cap = max(1, min(cap,
                             self.batch_controller.pick(backlog,
                                                        slack=slack)))
        close_t = open_t + self.max_wait
        batch = [order[start]]
        arrs = [first_arr]
        # Earliest member finish-by time: waiting past
        # (min_deadline_t - service estimate) would make that member's
        # deadline unmeetable no matter what the admission stage does.
        dl = self._deadline_of(first)
        min_dl_t = math.inf if dl is None else first_arr + dl
        for j in range(start + 1, len(order)):
            if len(batch) >= cap:
                break
            r = reqs[order[j]]
            if isinstance(r, UpdateRequest):
                break   # FIFO: a graph update closes the batch
            arr = open_t if r.arrival_time is None else r.arrival_time
            limit = close_t
            if min_dl_t < math.inf:
                svc_now = self._account_for(key, len(batch), 0).total_latency
                if open_t + svc_now <= min_dl_t + 1e-12:
                    # The oldest member is still meetable: only grow the
                    # batch while that stays true. (When it is already
                    # doomed, shrinking the batch saves nothing and slows
                    # everyone else — fall back to the max_wait close.)
                    svc_next = self._account_for(key, len(batch) + 1,
                                                 0).total_latency
                    limit = min(limit, min_dl_t - svc_next)
            if arr > limit or self._exec_key(r) != key:
                break   # FIFO: an incompatible/late request closes the batch
            batch.append(order[j])
            arrs.append(arr)
            dl = self._deadline_of(r)
            if dl is not None:
                min_dl_t = min(min_dl_t, arr + dl)
        return batch, arrs

    def _serve_batch(self, batch: List[Request], ready: float, *,
                     level: int = 0) -> List[Response]:
        sess = self._session_for(level)
        b = len(batch)
        key = self._exec_key(batch[0])
        backend = sess.resolve_executor(batch[0].executor)
        # Numerics first: per-request compressor round-trip, then ONE
        # stacked [B, V, F] array handed to the session's batched execute
        # (bitwise serial Session.query — held in
        # tests/test_torch_server.py and on the card by chip_smoke.py).
        # Routing through the session lets a cache-enabled session serve
        # the whole micro-batch with one stacked frontier pass, and
        # resolves this batch's staleness under the stale-tolerant halo
        # policy, which the accounting below depends on (a stale serve
        # skips the K*delta sync round and ships zero exchange bytes).
        collected = np.stack([np.asarray(sess.collect(r.features),
                                         np.float32) for r in batch])
        embs = sess.execute_many(collected, executor=backend)
        staleness = int(sess.last_staleness)
        xbytes = sess.exchange_bytes(backend)
        # Accounting: one batched collect + one batched executor run.
        res = self._account_for(key, b, level, staleness=staleness)
        c_t = float(res.collect.max())
        e_t = res.total_latency - c_t
        # Any pending recovery charge (halo retries, failover repair)
        # rides on this batch's execution stage and is consumed here.
        rec_tag, rec_s, rec_n = (self._recovery if self._recovery is not None
                                 else (None, 0.0, 0))
        self._recovery = None
        e_t += rec_s
        sched = simulation.pipeline_schedule(
            [(ready, c_t, e_t)], pipelined=self.pipelined,
            start=self._pipe_state)[-1]
        self._pipe_state = simulation.schedule_state(sched)
        if self.batch_controller is not None:
            self.batch_controller.observe(b, c_t + e_t)
        batch_index = self.num_batches
        self.num_batches += 1
        out = []
        for k, (req, emb) in enumerate(zip(batch, embs)):
            # Closed-loop requests are generated at admission: no queueing.
            arrival = (sched.collect_start if req.arrival_time is None
                       else req.arrival_time)
            queue_delay = sched.collect_start - arrival
            latency = sched.execute_end - arrival
            acc = None if sess.accuracy_fn is None else float(
                sess.accuracy_fn(emb))
            deadline = self._deadline_of(req)
            breakdown: Dict[str, float] = {
                "queue": queue_delay, "collect": c_t, "execute": e_t,
                "unpack": float(res.unpack.max()), "total": latency}
            if self.injector is not None:
                breakdown["recovery"] = rec_s
            out.append(Response(
                embeddings=emb, latency=latency, throughput=res.throughput,
                breakdown=breakdown, wire_bytes=res.wire_bytes / b,
                exchange_bytes=xbytes, backend=backend.name, accuracy=acc,
                request_id=req.request_id, arrival_time=arrival,
                queue_delay=queue_delay, service_start=sched.collect_start,
                finish_time=sched.execute_end, batch_size=b,
                batch_index=batch_index, collect_time=c_t, execute_time=e_t,
                overlap_saved=sched.overlap_saved, priority=req.priority,
                deadline=deadline,
                deadline_met=(None if deadline is None
                              else bool(latency <= deadline + 1e-9)),
                degradation=level, staleness=staleness,
                retries=rec_n, recovered=rec_tag,
                capacity=("degraded"
                          if sess.plan.provenance == "failover" else "full")))
            sess.tick()   # per-request adapt_every accounting (step 5)
        if sess.adapt_every:
            self._svc_cache.clear()   # adaptation may have moved placement
        return out

    # -- reporting ----------------------------------------------------------

    @staticmethod
    def summarize(responses: Sequence[Response],
                  sites: Optional[Sequence[str]] = None
                  ) -> Dict[str, object]:
        """Trace-level metrics for a batch of responses.

        Mixed traces are fine: ``UpdateResponse`` entries are counted as
        ``updates``, control-plane ``Rejection`` entries as ``rejected``,
        and both are excluded from the latency/throughput statistics.
        ``goodput_rps`` counts only in-deadline responses (best-effort
        responses count as met); ``deadline_miss_rate`` is misses plus
        rejections over deadline-carrying requests plus rejections; and
        ``priority_classes`` breaks requests / rejections / p95 / miss
        rate out per priority class. ``retried`` / ``recovered`` count
        fault-tolerance outcomes (requests whose batch paid a halo retry
        / requests served through any recovery tier) and
        ``availability`` is the answered fraction of admitted requests.

        When any response carries a fleet ``site`` (or ``sites`` lists
        names to always report, so a down site with zero served requests
        still appears), the summary grows a per-site breakdown —
        served/spilled/failed-over counts, per-site p95 (None for an
        empty site) and a staleness histogram — plus a fleet-wide
        ``staleness_histogram``.
        """
        rejected = [r for r in responses if isinstance(r, Rejection)]
        updates = [r for r in responses if isinstance(r, UpdateResponse)]
        responses = [r for r in responses if isinstance(r, Response)]
        if not responses:
            out = {"requests": 0, "updates": len(updates),
                   "rejected": len(rejected), "retried": 0, "recovered": 0,
                   "availability": 1.0 if not rejected else 0.0}
            if sites:
                out["sites"] = {s: {"served": 0, "spilled": 0,
                                    "failed_over": 0, "recovered": 0,
                                    "latency_p95_s": None,
                                    "staleness_histogram": {}}
                                for s in sites}
            return out
        lat = np.array([r.latency for r in responses])
        fin = max(r.finish_time for r in responses)
        t0 = min(r.arrival_time for r in responses)
        makespan = fin - t0
        with_dl = [r for r in responses if r.deadline is not None]
        missed = sum(1 for r in with_dl if not r.deadline_met)
        in_deadline = len(responses) - missed
        denom = len(with_dl) + len(rejected)

        def _class_stats(prio: int) -> Dict[str, object]:
            rs = [r for r in responses if r.priority == prio]
            rj = [r for r in rejected if r.priority == prio]
            wd = [r for r in rs if r.deadline is not None]
            miss = sum(1 for r in wd if not r.deadline_met)
            den = len(wd) + len(rj)
            return {
                "requests": len(rs),
                "rejected": len(rj),
                "degraded": sum(1 for r in rs if r.degradation > 0),
                "latency_p95_s": (float(np.percentile(
                    [r.latency for r in rs], 95)) if rs else None),
                "deadline_miss_rate": (miss + len(rj)) / den if den else 0.0,
                "goodput_rps": (len(rs) - miss) / max(makespan, 1e-12),
            }

        def _hist(rs: Sequence[Response]) -> Dict[str, int]:
            h: Dict[int, int] = {}
            for r in rs:
                h[r.staleness] = h.get(r.staleness, 0) + 1
            return {str(k): h[k] for k in sorted(h)}

        def _site_stats(name: str) -> Dict[str, object]:
            rs = [r for r in responses if r.site == name]
            return {
                "served": len(rs),
                "spilled": sum(1 for r in rs if r.route == "spilled"),
                "failed_over": sum(1 for r in rs
                                   if r.route == "failed_over"),
                "recovered": sum(1 for r in rs if r.route == "recovered"),
                # Guard: a site that served nothing (down the whole
                # trace) has no percentile to report.
                "latency_p95_s": (float(np.percentile(
                    [r.latency for r in rs], 95)) if rs else None),
                "staleness_histogram": _hist(rs),
            }

        site_names = sorted({r.site for r in responses
                             if r.site is not None}
                            | set(sites or ()))
        prios = sorted({r.priority for r in responses}
                       | {r.priority for r in rejected})
        fleet_extra: Dict[str, object] = {}
        if site_names:
            fleet_extra = {
                "sites": {s: _site_stats(s) for s in site_names},
                "staleness_histogram": _hist(responses),
                "routing_delay_mean_s": float(np.mean(
                    [r.routing_delay for r in responses])),
            }
        return {
            **fleet_extra,
            "requests": len(responses),
            "updates": len(updates),
            "rejected": len(rejected),
            "batches": len({r.batch_index for r in responses}),
            "mean_batch": len(responses)
            / len({r.batch_index for r in responses}),
            "makespan_s": makespan,
            "throughput_rps": len(responses) / max(makespan, 1e-12),
            "goodput_rps": in_deadline / max(makespan, 1e-12),
            "latency_mean_s": float(lat.mean()),
            "latency_p50_s": float(np.percentile(lat, 50)),
            "latency_p95_s": float(np.percentile(lat, 95)),
            "latency_p99_s": float(np.percentile(lat, 99)),
            "queue_delay_mean_s": float(np.mean(
                [r.queue_delay for r in responses])),
            "overlap_saved_s": float(sum(
                {r.batch_index: r.overlap_saved
                 for r in responses}.values())),
            "degraded": sum(1 for r in responses if r.degradation > 0),
            # Fault-tolerance outcomes: requests whose batch paid a halo
            # retry, requests served through any recovery tier, and the
            # answered fraction (admitted and answered / admitted).
            "retried": sum(1 for r in responses
                           if getattr(r, "retries", 0) > 0),
            "recovered": sum(1 for r in responses
                             if getattr(r, "recovered", None) is not None),
            "availability": len(responses) / (len(responses) + len(rejected)),
            "deadline_miss_rate": ((missed + len(rejected)) / denom
                                   if denom else 0.0),
            "priority_classes": {str(p): _class_stats(p) for p in prios},
        }

    def __repr__(self) -> str:
        return (f"Server(max_batch={self.max_batch}, "
                f"max_wait={self.max_wait}, pipelined={self.pipelined}, "
                f"slo={'on' if self.slo is not None else 'off'}, "
                f"adaptive_batch="
                f"{'on' if self.batch_controller is not None else 'off'}, "
                f"served_batches={self.num_batches})")
