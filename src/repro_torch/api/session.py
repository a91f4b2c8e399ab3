"""Serving sessions: repeated queries over a compiled Plan.

A ``Session`` owns the mutable runtime state of serving one plan:

  * the adaptive scheduler's ``SchedulerState`` (placement drift, mode
    history) — seeded from a *copy* of the plan's placement, so the plan
    itself stays frozen,
  * the partitioned-buffer cache (rebuilt only when adaptation migrates
    vertices),
  * query counters for the ``adapt_every`` tick.

The paper's per-query stages are separately callable — ``collect``
(compressed feature collection, step 3), ``execute`` (runtime numerics on
the plan's device, step 4) and ``account`` (simulated latency pricing) —
so the request-level ``Server`` front-end (``repro_torch.api.server``) can
micro-batch and pipeline them across queries; ``query`` composes them into
the single-shot blocking call. Every query returns a ``QueryResult`` with
one metrics schema across executor backends (sim / single / mesh-bsp /
cloud). ``update`` absorbs graph mutations (``Engine.apply_delta``).
``activation_cache=True`` serves queries after localized changes through
the incremental frontier path (``core.frontier``); ``staleness_bound``
with the ``halo_async`` exchange lets mesh serves replay recorded halo
tables (``runtime.bsp.bsp_infer_stale``).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, Iterable, Iterator, Optional, Union

import numpy as np

from repro_torch.api import executors as _executors  # noqa: F401  (registers backends)
from repro_torch.api.executors import ExecutorBackend
from repro_torch.api.registry import (COMPRESSORS, EXCHANGES, EXECUTORS,
                                      PARTITIONERS)
from repro_torch.api.updates import GraphDelta, UpdateReport
from repro_torch.core import frontier as _frontier
from repro_torch.core import simulation
from repro_torch.core.scheduler import SchedulerState, schedule_step
from repro_torch.gnn.graph import Graph
from repro_torch.kernels import ops
from repro_torch.runtime import bsp


@dataclasses.dataclass(frozen=True)
class QueryResult:
    """Unified per-query metrics, identical across executor backends.

    ``embeddings`` is float32 numpy [V, D]. ``breakdown`` keys: collect /
    execute / unpack / total (seconds, for the bottleneck fog).
    ``exchange_bytes`` is the per-BSP-sync collective payload under the
    plan's exchange strategy (0 for the single and cloud backends, which
    have no cross-fog sync). ``accuracy`` is filled by the session's
    ``accuracy_fn`` hook when one is installed.
    """
    embeddings: np.ndarray
    latency: float
    throughput: float
    breakdown: Dict[str, float]
    wire_bytes: float
    exchange_bytes: int
    backend: str
    accuracy: Optional[float] = None


class _HaloStore:
    """Recorded halo tables for stale-tolerant serving (halo_async).

    After a fresh serve the session records every layer's boundary-row
    table (``bsp.build_halo_tables``); up to ``bound`` subsequent serves
    may replay them instead of stalling the BSP superstep on the
    exchange. ``age`` counts serves since the recording pass;
    ``revision`` pins the graph fingerprint the tables were built under
    (any mismatch forces a fresh serve). ``tables`` is None (cold), a
    list of per-layer arrays (mesh backend), or the empty-tuple marker
    for single-program backends — which have no real exchange to skip,
    so only the version/staleness accounting applies.
    """
    __slots__ = ("bound", "tables", "age", "revision")

    def __init__(self, bound: int):
        self.bound = int(bound)
        self.tables = None
        self.age = 0
        self.revision = None

    def invalidate(self) -> None:
        self.tables = None
        self.age = 0
        self.revision = None


class Session:
    """Live serving handle for one Plan: ``query``, ``update``, ``adapt``.

    ``updates`` sets the dynamic-graph consistency policy: "sync" applies
    every ``update(delta)`` immediately (queries after the update always
    see the mutated graph), "deferred" buffers deltas and coalesces them
    into one repair at the next ``flush_updates()`` — queries served in
    between read the stale graph (bounded staleness, amortized repair).

    ``compressor`` and ``num_layers`` are degraded-serving overrides: the
    session serves ``plan.with_overrides(...)`` — same graph, placement
    and partitioned buffers, but a swapped upload codec and/or a
    truncated layer stack. These are the knobs the SLO control plane's
    degradation ladder turns (``repro_torch.api.slo``); a session
    configured with them directly is bitwise the server's degraded path.

    ``activation_cache=True`` turns on incremental queries: the session
    keeps every layer's activations from the last full pass, and a query
    whose collected features differ in a few rows (or that follows a
    localized graph update) recomputes only the k-hop dirty frontier
    (``core.frontier``), merging the recomputed rows into the cached
    tables — bitwise a full recompute. Queries fall back to a full pass
    (repriming the cache) when the frontier exceeds
    ``frontier_max_fraction`` of V, the model kind lacks frontier support
    (GAT re-weights edges per layer), the kernel path is disarmed after a
    structural update, or the cached revision / numerics tags disagree.

    ``staleness_bound`` (default: the plan's) with a stale-tolerant
    exchange (``"halo_async"``) lets up to that many serves after a fresh
    one replay its recorded halo tables instead of the per-layer exchange;
    ``last_staleness`` says how old the last execute's halo rows were.
    """

    def __init__(self, plan, *, executor: Optional[str] = None,
                 aggregation: Optional[str] = None,
                 compressor: Optional[str] = None,
                 num_layers: Optional[int] = None,
                 lam: float = 1.3, theta: float = 0.5,
                 adapt_every: int = 0,
                 accuracy_fn: Optional[Callable[[np.ndarray], float]] = None,
                 seed: Optional[int] = None,
                 updates: str = "sync",
                 activation_cache: bool = False,
                 frontier_max_fraction: float = 0.25,
                 staleness_bound: Optional[int] = None):
        if updates not in ("sync", "deferred"):
            raise ValueError(f"updates must be 'sync' or 'deferred', "
                             f"got {updates!r}")
        if compressor is not None or num_layers is not None:
            plan = plan.with_overrides(compressor=compressor,
                                       num_layers=num_layers)
        self.plan = plan
        self.update_policy = updates
        self._pending_deltas: list = []
        # (|V|, F) of the graph after every buffered delta: lets update()
        # reject out-of-range deltas at admission instead of poisoning a
        # deferred flush (deferred deltas address the projected graph).
        self._projected_shape = (plan.graph.num_vertices,
                                 plan.graph.feature_dim)
        cfg = plan.config
        self._executor_key = cfg.executor if executor is None else executor
        self._executor = EXECUTORS.resolve(self._executor_key)
        self._compressor = COMPRESSORS.resolve(cfg.compressor)
        self._exchange = EXCHANGES.resolve(cfg.exchange)
        # Aggregation path override (else the plan's knob), validated
        # eagerly so bad combinations fail at session creation.
        self._aggregation = (cfg.aggregation if aggregation is None
                             else aggregation)
        bsp.resolve_aggregation(
            self._aggregation, plan.model.kind,
            exchange=self._exchange.name
            if self._executor.needs_block_shards else None,
            device=plan.device)
        self.lam = lam
        self.theta = theta
        self.adapt_every = int(adapt_every)
        self.accuracy_fn = accuracy_fn
        self.seed = cfg.seed if seed is None else seed
        # Mutable scheduler state starts from a COPY of the frozen plan's
        # placement and latency models: adaptation must never write
        # through to the plan, or sibling sessions would see it.
        self.state = SchedulerState(placement=dataclasses.replace(
            plan.placement,
            assignment=np.array(plan.placement.assignment, copy=True)))
        self.fogs = [dataclasses.replace(
            f, latency_model=dataclasses.replace(
                f.latency_model, beta=np.array(f.latency_model.beta)))
            for f in plan.fogs]
        self.num_queries = 0
        self._partitioned = plan.partitioned  # valid for the initial layout
        # Stale-tolerant serving (exchange="halo_async"): the session may
        # replay recorded halo tables for up to staleness_bound serves
        # after a fresh pass. bound=0 (the default) keeps the store off
        # entirely — every serve runs the fresh path, which for halo_async
        # is the "halo" exchange (bitwise).
        bound = (cfg.staleness_bound if staleness_bound is None
                 else int(staleness_bound))
        if bound < 0:
            raise ValueError(f"staleness_bound must be >= 0, got {bound}")
        if bound > 0 and not self._exchange.stale_tolerant:
            raise ValueError(
                f"staleness_bound={bound} needs a stale-tolerant exchange "
                f"(e.g. 'halo_async'), got {self._exchange.name!r}")
        if bound > 0 and activation_cache:
            raise ValueError(
                "activation_cache and staleness_bound > 0 are mutually "
                "exclusive: the incremental frontier path assumes every "
                "serve's exchange is fresh")
        self._halo = _HaloStore(bound) if bound > 0 else None
        #: staleness (in serves since the last fresh exchange) of the most
        #: recent execute: 0 = fresh/synchronous. Recorded per response by
        #: the Server/FleetServer front-ends.
        self.last_staleness = 0
        self._acache = (_frontier.ActivationCache(frontier_max_fraction)
                        if activation_cache else None)
        #: QueryFrontier of the last query when it took the incremental
        #: path, else None (introspection for tests and benchmarks).
        self.last_frontier: Optional[_frontier.QueryFrontier] = None
        self._executor.check(plan)

    # -- runtime ------------------------------------------------------------

    @property
    def placement(self):
        """The session's *current* (possibly adapted) placement."""
        return self.state.placement

    def _needs_block_shards(self, backend: ExecutorBackend) -> bool:
        """Whether ``backend`` will read the per-shard block-CSR operands."""
        return (backend.needs_block_shards
                and bsp.resolve_aggregation(
                    self._aggregation, self.plan.model.kind,
                    exchange=self._exchange.name,
                    device=self.plan.device) == "pallas")

    def partitioned(self, backend: Optional[ExecutorBackend] = None
                    ) -> bsp.PartitionedGraph:
        """Static-shape buffers for the current assignment (cached).

        The block-CSR shards of the kernel aggregation path are built on
        demand: if the (given or session) backend needs them and the
        cached buffers lack them, the layout is rebuilt once with blocks.
        """
        backend = self._executor if backend is None else backend
        need = self._needs_block_shards(backend)
        pg = self._partitioned
        if pg is None or (need and pg.local_csr is None):
            self._partitioned = pg = bsp.build_partitioned(
                self.plan.graph, self.state.placement.assignment,
                build_blocks=need)
        return pg

    # -- separately callable query stages -----------------------------------

    def resolve_executor(self, executor=None) -> ExecutorBackend:
        """Per-query backend override -> checked ExecutorBackend."""
        if executor is None:
            return self._executor
        if isinstance(executor, ExecutorBackend):
            return executor   # already resolved (and checked) upstream
        backend = EXECUTORS.resolve(executor)
        if backend is not self._executor:
            backend.check(self.plan)
        return backend

    def collect(self, features: Optional[np.ndarray] = None) -> np.ndarray:
        """Stage 1 (paper step 3): compressed collection round-trip.

        ``features`` overrides the graph's stored features (fresh sensor
        uploads); the returned array carries the codec's true quantization
        error, exactly as the fogs would observe it after unpack.
        """
        g: Graph = self.plan.graph
        raw = g.features if features is None else np.asarray(features)
        return self._compressor.roundtrip(raw, g.degrees)

    def execute(self, feats: np.ndarray, *, executor=None) -> np.ndarray:
        """Stage 2 (paper step 4): the GNN forward on the plan's device;
        returns float32 numpy [V, D].

        With ``activation_cache=True`` the collected ``feats`` are diffed
        bitwise against the cached h^0, the dirty frontier is expanded,
        and the executor recomputes only the dirty rows — or runs a full
        capturing pass when the cache cannot serve (bitwise either way).
        With a staleness bound the serve may replay recorded halo tables.
        """
        backend = self.resolve_executor(executor)
        if self._acache is not None:
            return self._cached_execute(np.asarray(feats, np.float32),
                                        backend)
        if self._halo is not None:
            return self._stale_execute(np.asarray(feats, np.float32),
                                       backend, many=False)
        self.last_staleness = 0
        return backend.run(self.plan, feats, self.state.placement.assignment,
                           self.partitioned(backend), self._exchange.name,
                           aggregation=self._aggregation)

    def execute_many(self, feats, *, executor=None) -> list:
        """Batched stage 2 over a micro-batch ([B, V, F] stack or a
        sequence of [V, F] arrays) -> list of [V, D] embeddings, each
        bitwise equal to ``execute`` on the same features.

        The Server's micro-batcher calls this, so a cache-enabled session
        serves the whole batch through ONE stacked frontier pass (the
        per-example h^0 diffs union into one dirty set)."""
        backend = self.resolve_executor(executor)
        if not (isinstance(feats, np.ndarray) and feats.ndim == 3):
            feats = np.stack([np.asarray(f, np.float32) for f in feats])
        feats = np.asarray(feats, np.float32)
        if self._acache is None:
            if self._halo is not None:
                return self._stale_execute(feats, backend, many=True)
            self.last_staleness = 0
            return backend.run_many(
                self.plan, feats, self.state.placement.assignment,
                self.partitioned(backend), self._exchange.name,
                aggregation=self._aggregation)
        if feats.shape[0] == 1:
            return [self._cached_execute(feats[0], backend)]
        return self._cached_execute(feats, backend)

    def _stale_execute(self, feats: np.ndarray, backend: ExecutorBackend,
                       many: bool):
        """Serve one execute under the stale-tolerant halo policy.

        A serve is stale when tables are recorded for the current graph
        revision and the store is younger than the bound: the mesh
        backend then replays the recorded boundary rows with NO per-layer
        exchange (local rows still read the CURRENT query features),
        single-program backends serve plainly (they have no exchange to
        skip; the accounting is identical). Otherwise the serve is fresh:
        the mesh backend runs a capturing pass and the per-layer INPUT
        activations become the next tables.
        """
        store = self._halo
        plan = self.plan
        assign = self.state.placement.assignment
        pg = self.partitioned(backend)
        agg = self._aggregation
        revision = ops.graph_fingerprint(plan.graph)
        mesh = backend.supports_stale_halo(plan, agg)
        recorded = (store.tables is not None
                    and (store.tables != () if mesh
                         else store.tables == ()))
        if (recorded and store.revision == revision
                and store.age + 1 <= store.bound):
            store.age += 1
            self.last_staleness = store.age
            if not mesh:
                # Single-program numerics: no exchange, plain serve.
                if many:
                    return backend.run_many(plan, feats, assign, pg,
                                            self._exchange.name,
                                            aggregation=agg)
                return backend.run(plan, feats, assign, pg,
                                   self._exchange.name, aggregation=agg)
            if many:
                return backend.run_stale_many(plan, feats, assign, pg,
                                              store.tables,
                                              aggregation=agg)
            return backend.run_stale(plan, feats, assign, pg, store.tables,
                                     aggregation=agg)
        # Fresh serve: run synchronously and (re)record the tables.
        store.age = 0
        store.revision = revision
        self.last_staleness = 0
        if not mesh:
            store.tables = ()   # marker: accounting only, nothing to replay
            if many:
                return backend.run_many(plan, feats, assign, pg,
                                        self._exchange.name,
                                        aggregation=agg)
            return backend.run(plan, feats, assign, pg,
                               self._exchange.name, aggregation=agg)
        layers = backend.run_layers(plan, feats, assign, pg,
                                    self._exchange.name, aggregation=agg)
        # Layer l's halo table holds layer l's INPUT activations (the
        # features for l=0); a stacked batch records the LAST example,
        # matching the activation cache's merge convention.
        if many:
            inputs = [feats[-1]] + [a[-1] for a in layers[:-1]]
        else:
            inputs = [feats] + list(layers[:-1])
        store.tables = bsp.build_halo_tables(pg, inputs)
        if many:
            return list(layers[-1])
        return layers[-1]

    def _cached_execute(self, feats: np.ndarray, backend: ExecutorBackend):
        """Serve one execute through the activation cache.

        ``feats`` is [V, F] (returns [V, D]) or a stacked [B, V, F]
        micro-batch (returns a list of B [V, D] arrays). Decision order:
        tag agreement (graph revision + aggregation mode + executor
        family) -> h^0 diff + frontier expansion -> empty-frontier fast
        path / budgeted incremental pass / full capturing pass.
        """
        cache = self._acache
        plan = self.plan
        g: Graph = plan.graph
        k = plan.model.num_layers
        assign = self.state.placement.assignment
        pg = self.partitioned(backend)
        exch = self._exchange.name
        agg = self._aggregation
        stacked = feats.ndim == 3
        mode = bsp.resolve_aggregation(
            agg, plan.model.kind,
            exchange=exch if backend.needs_block_shards else None,
            device=plan.device)
        family = backend.frontier_family
        revision = ops.graph_fingerprint(g)
        self.last_frontier = None
        if cache.matches(revision, mode, family):
            qf = cache.plan_query(feats, g, k)
            if qf is not None and not len(qf.rows):
                # Nothing changed since the cached pass: serve the cached
                # final layer outright (sound for every kind, GAT too).
                if stacked:
                    return [np.array(cache.layers[-1], copy=True)
                            for _ in range(feats.shape[0])]
                return np.array(cache.layers[-1], copy=True)
            if (qf is not None
                    and backend.supports_frontier(plan, agg)
                    and (mode != "pallas" or cache.pallas_ok)):
                emb, merged = backend.run_frontier(
                    plan, feats, assign, pg, exch, agg, qf.rows,
                    cache.layers)
                # A stacked pass merges the LAST example's tables: its
                # h^0 becomes the diff baseline, and any member-specific
                # rows self-correct through the next query's diff.
                if stacked:
                    cache.merge(feats[-1], [m[-1] for m in merged])
                else:
                    cache.merge(feats, merged)
                self.last_frontier = qf
                return emb
        # Full pass, capturing every layer to (re)base the cache.
        layers = backend.run_layers(plan, feats, assign, pg, exch,
                                    aggregation=agg)
        if stacked:
            cache.populate(feats[-1], [a[-1] for a in layers],
                           revision, mode, family)
            return list(layers[-1])
        cache.populate(feats, layers, revision, mode, family)
        return layers[-1]

    def account(self, executor=None, *, batch_size: int = 1,
                staleness: Optional[int] = None) -> simulation.ServingResult:
        """Stage 3: simulated latency pricing for the current placement.

        ``batch_size`` prices a micro-batch of coalesced queries (1 = one
        query). ``staleness`` prices the serve's exchange mode: a stale
        halo_async serve (staleness > 0) never stalls a superstep on the
        exchange, so the K*delta sync term drops out of the multi-fog
        pipeline (``sync_scale=0``); None reads ``last_staleness``.
        """
        backend = self.resolve_executor(executor)
        if staleness is None:
            staleness = self.last_staleness
        scale = 0.0 if staleness else 1.0
        return simulation.simulate(backend.pipeline, self.plan.cluster,
                                   self.state.placement,
                                   compress=self._compressor.sim_key,
                                   batch_size=batch_size,
                                   sync_scale=scale)

    def exchange_bytes(self, executor=None, *,
                       staleness: Optional[int] = None) -> int:
        """Per-BSP-sync collective payload (0 off the multi-fog pipeline).

        A stale halo_async serve replays recorded tables and ships NOTHING
        over the wire (``staleness`` as in ``account``).
        """
        backend = self.resolve_executor(executor)
        if backend.pipeline != "multi":
            return 0
        if staleness is None:
            staleness = self.last_staleness
        if staleness:
            return 0
        dtype_bytes, row_overhead = backend.wire_format(
            self.plan, self._exchange.name, self._aggregation)
        return self._exchange.bytes_per_sync(self.partitioned(),
                                             self.plan.graph.feature_dim,
                                             dtype_bytes, row_overhead)

    def tick(self) -> None:
        """Count one served query and run the ``adapt_every`` schedule."""
        self.num_queries += 1
        if self.adapt_every and self.num_queries % self.adapt_every == 0:
            self.adapt()

    def query(self, features: Optional[np.ndarray] = None, *,
              executor: Optional[str] = None) -> QueryResult:
        """Serve one inference query (steps 3-4 of the paper's workflow).

        ``features`` overrides the graph's stored features for this query
        (fresh sensor uploads); ``executor`` overrides the backend for this
        query only.
        """
        backend = self.resolve_executor(executor)
        feats = self.collect(features)
        emb = self.execute(feats, executor=backend)
        res = self.account(backend)
        breakdown = dict(res.breakdown())
        breakdown["unpack"] = float(res.unpack.max())
        xbytes = self.exchange_bytes(backend)
        acc = None if self.accuracy_fn is None else float(
            self.accuracy_fn(emb))
        out = QueryResult(embeddings=emb, latency=res.total_latency,
                          throughput=res.throughput, breakdown=breakdown,
                          wire_bytes=res.wire_bytes, exchange_bytes=xbytes,
                          backend=backend.name, accuracy=acc)
        # step 5: adaptive scheduling tick, owned by the session.
        self.tick()
        return out

    def stream(self, queries: Union[int, Iterable], *,
               executor: Optional[str] = None) -> Iterator:
        """Deprecated: serve queries one at a time (use ``Server.replay``).

        ``queries`` is either a count (re-serve the stored features) or an
        iterable of feature arrays (None entries use stored features).
        ``executor`` overrides the backend for every query in the stream.
        Kept as a thin lazy shim over the request-level ``Server.replay``
        with batching and pipelining disabled: one query is served per
        ``next()``, and per-query latency/throughput/embeddings match
        ``query`` exactly (the Response ``breakdown`` reports the server's
        collect/execute *stage* split rather than the bottleneck-fog split
        of ``Session.query``).
        """
        warnings.warn(
            "Session.stream is deprecated; use repro_torch.api.Server — "
            "plan.server().replay(...) — for request-level serving with "
            "micro-batching and pipelined collect/execute",
            DeprecationWarning, stacklevel=2)
        from repro_torch.api.server import Server
        server = Server(self, max_batch=1, pipelined=False)
        if isinstance(queries, int):
            queries = (None for _ in range(queries))
        for q in queries:   # lazily: serve one request per next()
            yield server.replay([q], executor=executor)[0]

    # -- dynamic-graph updates ----------------------------------------------

    @property
    def pending_updates(self) -> int:
        """Buffered deltas awaiting a flush (always 0 under "sync")."""
        return len(self._pending_deltas)

    def update(self, delta: GraphDelta) -> Optional[UpdateReport]:
        """Absorb one graph mutation (the serving-time update stage).

        Under the "sync" policy the delta is applied immediately and the
        report returned; under "deferred" it is buffered (returns None)
        until ``flush_updates`` coalesces the whole buffer into a single
        repair. Deferred deltas address the graph produced by the
        previous delta in the buffer, not the session's current graph.
        """
        if not isinstance(delta, GraphDelta):
            raise TypeError("update() takes a GraphDelta, got "
                            f"{type(delta).__name__}")
        # Fail fast at admission: a delta whose ids cannot be valid
        # against the projected graph must not enter the buffer, or a
        # later deferred flush would keep tripping over it.
        v, f = self._projected_shape
        delta.validate(v, f)
        v_next = (v - delta.num_removed_vertices
                  + delta.num_added_vertices)
        if v_next < self.plan.num_fogs:
            raise ValueError(
                f"delta leaves {v_next} vertices for "
                f"{self.plan.num_fogs} fog partitions")
        self._pending_deltas.append(delta)
        self._projected_shape = (v_next, f)
        if self.update_policy != "sync":
            return None
        try:
            return self.flush_updates()
        except BaseException:
            # The rejected delta never happened: drop it (flush_updates
            # restored the buffer) so later updates aren't blocked.
            self._pending_deltas.pop()
            self._projected_shape = (v, f)
            raise

    def flush_updates(self) -> Optional[UpdateReport]:
        """Apply every buffered delta in one coalesced repair.

        Rebases the session onto the updated plan: the repair starts from
        the session's *current* (possibly adapted) assignment, the
        scheduler state keeps its history/eta but re-anchors on the
        repaired placement, and cached partition buffers swap for the
        incrementally rebuilt ones. Returns None when nothing is pending.
        """
        if not self._pending_deltas:
            return None
        from repro_torch.api.engine import Engine   # lazy: avoid import cycle
        deltas, self._pending_deltas = self._pending_deltas, []
        old_graph = self.plan.graph
        try:
            plan2 = Engine.from_plan(self.plan).apply_delta(
                self.plan, deltas,
                assignment=self.state.placement.assignment)
            self._executor.check(plan2)
        except BaseException:
            # Keep the buffer intact so a bad delta can be inspected or
            # dropped without losing its neighbours.
            self._pending_deltas = deltas + self._pending_deltas
            raise
        if self._acache is not None and self._acache.primed:
            # Remap the cached activations through the coalesced repair's
            # order-preserving compaction and record the dirty seeds; any
            # disagreement with the repaired plan drops the cache instead
            # of risking a stale serve.
            try:
                fu = _frontier.fold_delta_frontier(old_graph, deltas)
            except Exception:
                self._acache.clear()
            else:
                rev = ops.graph_fingerprint(plan2.graph)
                if ops.graph_fingerprint(fu.graph) == rev:
                    self._acache.apply_update(fu, revision=rev)
                else:
                    self._acache.clear()
        if self._halo is not None:
            # An applied update bumps the data version: recorded halo
            # tables predate it (and the repair may have changed the
            # partition layout), so the next serve must be fresh.
            self._halo.invalidate()
        self.plan = plan2
        self.state.placement = dataclasses.replace(
            plan2.placement,
            assignment=np.array(plan2.placement.assignment, copy=True))
        self._partitioned = plan2.partitioned
        self._projected_shape = (plan2.graph.num_vertices,
                                 plan2.graph.feature_dim)
        return plan2.update_report

    def can_serve_stale(self) -> bool:
        """Whether the NEXT execute could ride through on recorded halo
        tables: a store exists, tables are recorded for the current graph
        revision, and one more stale serve stays within the bound."""
        store = self._halo
        if store is None or store.tables is None:
            return False
        mesh = self._executor.supports_stale_halo(self.plan,
                                                  self._aggregation)
        recorded = (store.tables != () if mesh else store.tables == ())
        return (recorded
                and store.revision == ops.graph_fingerprint(self.plan.graph)
                and store.age + 1 <= store.bound)

    # -- node-level fault tolerance ------------------------------------------

    def rebind(self, plan2) -> None:
        """Rebase this session onto ``plan2`` (same graph, new layout).

        The failover/recovery rebase: scheduler state re-anchors on the
        new placement, profiled fog models swap for the new plan's, halo
        tables invalidate (they are laid out per the old partitioning),
        mesh-family activation caches clear (single-program numerics are
        assignment-independent, so those survive) and the session's
        layout becomes ``plan2.partitioned`` (whose device cache the next
        mesh execute fills). Mirrors the ``flush_updates`` rebase, minus
        the graph change. The executor checks ``plan2`` first: with one
        fog per ``torch.distributed`` rank, every rank makes the group of
        its fogs' ranks here, in step.
        """
        if plan2.graph.num_vertices != self.plan.graph.num_vertices:
            raise ValueError(
                "rebind() is a same-graph rebase; use update()/"
                "flush_updates() for graph mutations")
        self._executor.check(plan2)
        if self._halo is not None:
            self._halo.invalidate()
        if self._acache is not None and self._acache.family == "mesh":
            self._acache.clear()
        self.plan = plan2
        self.state.placement = dataclasses.replace(
            plan2.placement,
            assignment=np.array(plan2.placement.assignment, copy=True))
        self.fogs = [dataclasses.replace(
            f, latency_model=dataclasses.replace(
                f.latency_model, beta=np.array(f.latency_model.beta)))
            for f in plan2.fogs]
        self._partitioned = plan2.partitioned

    def failover(self, crashed, *, mode: Optional[str] = None):
        """Tier-3 recovery: evict ``crashed`` node(s), re-place their
        shards onto the survivors (``Engine.fail_nodes``) and rebase this
        session onto the degraded-capacity failover plan. Queries keep
        flowing — on single-program numerics they stay bitwise the
        pre-crash serves. Returns the new plan.
        """
        from repro_torch.api.engine import Engine   # lazy: avoid import cycle
        plan2 = Engine.from_plan(self.plan).fail_nodes(
            self.plan, crashed,
            assignment=self.state.placement.assignment, mode=mode)
        self.rebind(plan2)
        return plan2

    # -- adaptation ---------------------------------------------------------

    def adapt(self, *, lam: Optional[float] = None,
              theta: Optional[float] = None,
              seed: Optional[int] = None) -> str:
        """One adaptive-scheduler tick (Alg. 2); returns the action taken."""
        plan = self.plan
        t_real = simulation.measured_exec_times(plan.cluster,
                                                self.state.placement)
        before = self.state.placement.assignment
        self.state = schedule_step(
            plan.graph, self.state, self.fogs, t_real,
            lam=self.lam if lam is None else lam,
            theta=self.theta if theta is None else theta,
            k_layers=plan.model.num_layers,
            sync_cost=plan.cluster.sync_cost,
            bytes_per_vertex=plan.config.bytes_per_vertex,
            seed=self.seed if seed is None else seed,
            replan_strategy=plan.config.placement,
            replan_partitioner=PARTITIONERS.resolve(plan.config.partitioner))
        if not np.array_equal(before, self.state.placement.assignment):
            self._partitioned = None  # layout changed: invalidate buffers
            if self._halo is not None:
                # Recorded tables are laid out per the old partitioning.
                self._halo.invalidate()
            if self._acache is not None and self._acache.family == "mesh":
                # Mesh-family cached tables were produced under the old
                # partition's halo layout; single-program numerics are
                # assignment-independent so those caches survive.
                self._acache.clear()
        return self.state.mode_history[-1]

    # -- frontier introspection ---------------------------------------------

    def frontier_state(self) -> Optional["_frontier.FrontierPlan"]:
        """Snapshot of the pending dirty frontier (None when the session
        has no activation cache or a cold one)."""
        if self._acache is None:
            return None
        return self._acache.frontier_plan(self.plan.graph,
                                          self.plan.model.num_layers)
