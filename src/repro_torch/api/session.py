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
and ``query`` composes them into the single-shot blocking call. Every query
returns a ``QueryResult`` with one metrics schema across executor backends
(sim / single / mesh-bsp / cloud).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.api import executors as _executors  # noqa: F401  (registers backends)
from repro_torch.api.executors import ExecutorBackend
from repro_torch.api.registry import (COMPRESSORS, EXCHANGES, EXECUTORS,
                                      PARTITIONERS)
from repro_torch.core import simulation
from repro_torch.core.scheduler import SchedulerState, schedule_step
from repro_torch.gnn.graph import Graph
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


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet: ROADMAP Queue 1 "
                               f"item {item}")


class Session:
    """Live serving handle for one Plan: ``query``, ``execute``, ``adapt``.

    ``compressor`` and ``num_layers`` are degraded-serving overrides: the
    session serves ``plan.with_overrides(...)`` — same graph, placement
    and partitioned buffers, but a swapped upload codec and/or a
    truncated layer stack. ``activation_cache``, ``staleness_bound`` and
    a deferred ``updates`` policy belong to subsystems the port does not
    serve yet and raise unless left at their defaults.
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
                 staleness_bound: Optional[int] = None):
        if updates not in ("sync", "deferred"):
            raise ValueError(f"updates must be 'sync' or 'deferred', "
                             f"got {updates!r}")
        if updates != "sync":
            raise _not_ported("updates='deferred'", "8, dynamic graphs")
        if activation_cache:
            raise _not_ported("activation_cache=True",
                              "9, incremental frontier queries")
        if staleness_bound:
            raise _not_ported(f"staleness_bound={staleness_bound}",
                              "10, fleet and stale halos")
        if compressor is not None or num_layers is not None:
            plan = plan.with_overrides(compressor=compressor,
                                       num_layers=num_layers)
        self.plan = plan
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
        returns float32 numpy [V, D]."""
        backend = self.resolve_executor(executor)
        return backend.run(self.plan, feats, self.state.placement.assignment,
                           self.partitioned(backend), self._exchange.name,
                           aggregation=self._aggregation)

    def execute_many(self, feats, *, executor=None) -> list:
        """Batched stage 2 over a micro-batch ([B, V, F] stack or a
        sequence of [V, F] arrays) -> list of [V, D] embeddings, each
        bitwise equal to ``execute`` on the same features."""
        backend = self.resolve_executor(executor)
        if not (isinstance(feats, np.ndarray) and feats.ndim == 3):
            feats = np.stack([np.asarray(f, np.float32) for f in feats])
        feats = np.asarray(feats, np.float32)
        return backend.run_many(
            self.plan, feats, self.state.placement.assignment,
            self.partitioned(backend), self._exchange.name,
            aggregation=self._aggregation)

    def account(self, executor=None, *,
                batch_size: int = 1) -> simulation.ServingResult:
        """Stage 3: simulated latency pricing for the current placement.

        ``batch_size`` prices a micro-batch of coalesced queries (1 = one
        query). Every serve is fresh (stale halos are not ported), so the
        K*delta sync term is always priced.
        """
        backend = self.resolve_executor(executor)
        return simulation.simulate(backend.pipeline, self.plan.cluster,
                                   self.state.placement,
                                   compress=self._compressor.sim_key,
                                   batch_size=batch_size)

    def exchange_bytes(self, executor=None) -> int:
        """Per-BSP-sync collective payload (0 off the multi-fog pipeline)."""
        backend = self.resolve_executor(executor)
        if backend.pipeline != "multi":
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

    # -- subsystems not ported yet ------------------------------------------

    def stream(self, queries, *, executor=None):
        raise _not_ported("Session.stream (a shim over Server.replay)",
                          "7, request-level serving")

    def update(self, delta):
        raise _not_ported("Session.update", "8, dynamic graphs")

    def flush_updates(self):
        raise _not_ported("Session.flush_updates", "8, dynamic graphs")

    def failover(self, crashed, *, mode: Optional[str] = None):
        raise _not_ported("Session.failover", "11, fault tolerance")

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
        return self.state.mode_history[-1]
