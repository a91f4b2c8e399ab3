"""Engine: the single front door to the Fograph serving pipeline.

    Engine(model, cluster, device="cuda", **knobs).compile(graph) -> Plan
    Plan.session() -> Session -> Session.query() -> QueryResult
    Plan.server() -> Server -> Server.replay(trace) -> [Response, ...]
    Engine.apply_delta(plan, GraphDelta) -> Plan
    Engine.fail_nodes(plan, crashed) -> Plan

``Engine`` captures the pipeline *configuration* (every stage is a
string-keyed registry entry, plus the torch device the numerics run on);
``compile`` runs the paper's setup phase once — fog profiling/metadata
registration, IEP data placement, static-shape partition buffers — and
freezes the result, with the model's parameters moved to the device, into
an immutable ``Plan``. Swapping the executor backend between "sim",
"single", "mesh-bsp" and "cloud" (or the compressor/placement between
their registry keys) changes no other code.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.api import executors as _executors  # noqa: F401  (registers backends)
from repro_torch.api.registry import (COMPRESSORS, EXCHANGES, EXECUTORS,
                                      PARTITIONERS, PLACEMENTS)
from repro_torch.api.plan import EngineConfig, ModelSpec, Plan, as_model
from repro_torch.api.updates import GraphDelta, UpdateReport
from repro_torch.core import incremental, simulation
from repro_torch.gnn.graph import Graph
from repro_torch.gnn.layers import EdgeList
from repro_torch.kernels import ops
from repro_torch.runtime import bsp


def resolve_device(device) -> torch.device:
    """``device`` as a torch device; a CUDA device must exist.

    Nothing falls back to the CPU: asking for CUDA on a machine without
    it raises, and the CPU runs only when the caller names it.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run on the CPU")
    return dev


class Engine:
    """A configured-but-uncompiled serving pipeline.

    Args:
      model: ``ModelSpec``, a ``GNN`` module, or a ``(params, kind)`` pair
        whose params are per-layer dicts of tensors or arrays.
      cluster: a cluster-spec string like ``"1A+4B+1C"`` (paper Table II
        node types; built at compile time against the query graph) or a
        prebuilt ``simulation.FogCluster``.
      partitioner / placement / compressor / exchange / executor: registry
        keys for the five pluggable stages. Unknown keys raise immediately
        with the list of available options.
      aggregation: "segment_sum" (gather + the fixed-order segment sum of
        ``kernels.segment_sum``), "pallas" (the hand-written block-CSR
        SpMM kernels; strict — raises for GAT) or "auto" (the kernels on a
        CUDA device, else segment_sum).
      device: torch device of the numerics, "cuda" by default. Requesting
        CUDA where there is none raises; pass "cpu" to run on the CPU.
      network: collection-network profile ("wifi" / "4g" / "5g").
      hidden: hidden width used by the analytic workload model.
      sync_cost: one BSP synchronization (delta in Eq. 6/7).
      bytes_per_vertex: per-vertex upload size for planning (defaults to
        the graph's raw float64 feature bytes).
      seed: profiling/placement RNG seed.
      update_max_imbalance / update_max_cut_growth: repair-quality
        thresholds for ``apply_delta`` — when the incrementally repaired
        partitioning exceeds either, the delta triggers a full recompile
        instead (overridable per call).
      staleness_bound: with the stale-tolerant ``"halo_async"`` exchange,
        how many serves may replay recorded halo tables before the next
        fresh exchange is forced (0 = every serve syncs, bitwise
        ``exchange="halo"``). Rejected for exchanges without stale
        tolerance.
      validate: static plan verification mode — "off" (default), "warn"
        (emit ``PlanInvariantWarning`` per finding) or "strict" (raise
        ``repro_torch.analysis.PlanValidationError``). Runs the
        ``repro_torch.analysis`` plan invariant checks at ``compile`` /
        ``apply_delta`` / ``fail_nodes`` exit (host numpy; nothing is
        launched).
    """

    def __init__(self, model, cluster: Union[str, "simulation.FogCluster"]
                 = "1A+4B+1C", *, network: str = "wifi",
                 partitioner: str = "bgp", placement: str = "iep",
                 compressor: str = "daq", exchange: str = "halo",
                 executor: str = "sim", hidden: int = 64, seed: int = 0,
                 sync_cost: float = simulation.DEFAULT_SYNC_COST,
                 bytes_per_vertex: Optional[float] = None,
                 aggregation: str = "auto",
                 staleness_bound: int = 0,
                 update_max_imbalance: float = 2.0,
                 update_max_cut_growth: float = 1.5,
                 validate: str = "off",
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.model: ModelSpec = as_model(model).to(self.device)
        self.cluster = cluster
        # Resolve every stage eagerly so bad keys fail at construction.
        self._partitioner = PARTITIONERS.resolve(partitioner)
        self._placement = PLACEMENTS.resolve(placement)
        self._compressor = COMPRESSORS.resolve(
            "none" if compressor is None else compressor)
        self._exchange = EXCHANGES.resolve(exchange)
        self._executor = EXECUTORS.resolve(executor)
        # Validate the aggregation knob eagerly too: "pallas" is strict
        # about the model kind (and about the exchange on backends that
        # aggregate over the per-shard block-CSR operands).
        bsp.resolve_aggregation(
            aggregation, self.model.kind,
            exchange=exchange if self._executor.needs_block_shards else None,
            device=self.device)
        staleness_bound = int(staleness_bound)
        if staleness_bound < 0:
            raise ValueError(f"staleness_bound must be >= 0, "
                             f"got {staleness_bound}")
        if staleness_bound > 0 and not self._exchange.stale_tolerant:
            raise ValueError(
                f"staleness_bound={staleness_bound} needs a stale-tolerant "
                f"exchange (e.g. 'halo_async'), got "
                f"{EXCHANGES.canonical(exchange)!r}")
        if validate not in ("off", "warn", "strict"):
            raise ValueError(f"unknown validate mode {validate!r}; "
                             f"available: off, warn, strict")
        self.config = EngineConfig(
            partitioner=PARTITIONERS.canonical(partitioner),
            placement=PLACEMENTS.canonical(placement),
            compressor=COMPRESSORS.canonical(
                "none" if compressor is None else compressor),
            exchange=EXCHANGES.canonical(exchange),
            executor=EXECUTORS.canonical(executor),
            network=network,
            cluster_spec=cluster if isinstance(cluster, str) else None,
            hidden=hidden, seed=seed, sync_cost=sync_cost,
            bytes_per_vertex=bytes_per_vertex, aggregation=aggregation,
            device=str(self.device), staleness_bound=staleness_bound,
            update_max_imbalance=update_max_imbalance,
            update_max_cut_growth=update_max_cut_growth,
            validate=validate)
        # The world ranks of the fogs of the plans this engine compiles
        # (``Plan.fog_ranks``; an engine rebuilt from a failover plan
        # compiles on its survivors, on their ranks).
        self._fog_ranks = None

    def _validated(self, plan: Plan) -> Plan:
        """Run the static plan invariant checks per ``config.validate``."""
        if self.config.validate != "off":
            from repro_torch.analysis import verify_plan
            verify_plan(plan, mode=self.config.validate)
        return plan

    def compile(self, graph: Graph) -> Plan:
        """Setup phase (paper steps 1-2): profile, register, plan, freeze."""
        cfg = self.config
        if isinstance(self.cluster, str):
            cluster = simulation.make_cluster(
                self.cluster, cfg.network, graph, hidden=cfg.hidden,
                k_layers=self.model.num_layers, seed=cfg.seed,
                sync_cost=cfg.sync_cost)
        else:
            cluster = self.cluster
        # step 1: metadata registration — profile every fog node.
        fogs = tuple(cluster.fog_specs(seed=cfg.seed))
        # step 2: execution planning — partition + partition->fog mapping.
        placement = self._placement.place(
            graph, fogs, k_layers=self.model.num_layers,
            sync_cost=cluster.sync_cost, seed=cfg.seed,
            bytes_per_vertex=cfg.bytes_per_vertex,
            partitioner=self._partitioner)
        # Freeze the static-shape per-partition buffers once. The block-CSR
        # shards are only built when this engine's own backend would read
        # them (sessions that override to a kernel path rebuild lazily).
        needs_shards = self._executor.needs_block_shards
        mode = bsp.resolve_aggregation(
            cfg.aggregation, self.model.kind,
            exchange=cfg.exchange if needs_shards else None,
            device=self.device)
        partitioned = bsp.build_partitioned(
            graph, placement.assignment,
            build_blocks=needs_shards and mode == "pallas")
        return self._validated(
            Plan(model=self.model, graph=graph, cluster=cluster, fogs=fogs,
                 placement=placement, partitioned=partitioned, config=cfg,
                 edges=EdgeList.from_graph(graph, device=self.device),
                 fog_ranks=self._fog_ranks))

    @classmethod
    def from_plan(cls, plan: Plan) -> "Engine":
        """Reconstruct the Engine a plan was compiled with (same knobs,
        same device, and the plan's fogs on the same world ranks)."""
        cfg = plan.config
        eng = cls(plan.model,
                   cfg.cluster_spec if cfg.cluster_spec else plan.cluster,
                   network=cfg.network, partitioner=cfg.partitioner,
                   placement=cfg.placement, compressor=cfg.compressor,
                   exchange=cfg.exchange, executor=cfg.executor,
                   hidden=cfg.hidden, seed=cfg.seed,
                   sync_cost=cfg.sync_cost,
                   bytes_per_vertex=cfg.bytes_per_vertex,
                   aggregation=cfg.aggregation, device=cfg.device,
                   staleness_bound=cfg.staleness_bound,
                   update_max_imbalance=cfg.update_max_imbalance,
                   update_max_cut_growth=cfg.update_max_cut_growth,
                   validate=cfg.validate)
        eng._fog_ranks = plan.fog_ranks
        return eng

    def compile_fleet(self, graph: Graph, sites) -> "Fleet":
        """Compile a geo-distributed fleet: one Plan per named fog site
        plus the ``"cloud"`` executor as last-resort tier.

        ``sites`` maps site name -> ``(lat, lon)`` centroid (dict, or a
        sequence of ``(name, (lat, lon))`` / ``(name, lat, lon)``
        entries). Every site serves THIS engine's model with THIS
        engine's pipeline knobs and device; each runs its own setup phase
        with a per-site profiling seed (``seed + index``). The cloud plan
        is the same model compiled for ``executor="cloud"`` (always fresh:
        no cross-fog exchange, so ``staleness_bound`` does not apply).

        Returns a :class:`repro_torch.api.fleet.Fleet`; open the serving
        facade with ``fleet.server(...)``.
        """
        from repro_torch.api.fleet import Fleet, Site
        if isinstance(sites, dict):
            items = list(sites.items())
        else:
            items = []
            for entry in sites:
                entry = tuple(entry)
                if len(entry) == 3:          # (name, lat, lon)
                    items.append((entry[0], (entry[1], entry[2])))
                elif len(entry) == 2:        # (name, (lat, lon))
                    items.append((entry[0], tuple(entry[1])))
                else:
                    raise ValueError(
                        f"site entry must be (name, (lat, lon)) or "
                        f"(name, lat, lon), got {entry!r}")
        if not items:
            raise ValueError("compile_fleet needs at least one site")
        cfg = self.config
        cluster = cfg.cluster_spec if cfg.cluster_spec else self.cluster

        def _engine(**over) -> "Engine":
            kw = dict(network=cfg.network, partitioner=cfg.partitioner,
                      placement=cfg.placement, compressor=cfg.compressor,
                      exchange=cfg.exchange, executor=cfg.executor,
                      hidden=cfg.hidden, seed=cfg.seed,
                      sync_cost=cfg.sync_cost,
                      bytes_per_vertex=cfg.bytes_per_vertex,
                      aggregation=cfg.aggregation, device=cfg.device,
                      staleness_bound=cfg.staleness_bound,
                      update_max_imbalance=cfg.update_max_imbalance,
                      update_max_cut_growth=cfg.update_max_cut_growth,
                      validate=cfg.validate)
            kw.update(over)
            return Engine(self.model, cluster, **kw)

        site_objs = tuple(
            Site(name=name, location=loc,
                 plan=_engine(seed=cfg.seed + i).compile(graph))
            for i, (name, loc) in enumerate(items))
        cloud_plan = _engine(executor="cloud", staleness_bound=0
                             ).compile(graph)
        return Fleet(sites=site_objs, cloud_plan=cloud_plan)

    # -- node-level fault tolerance ------------------------------------------

    def fail_nodes(self, plan: Plan, crashed, *,
                   assignment: Optional[np.ndarray] = None,
                   mode: Optional[str] = None) -> Plan:
        """Shard failover: evict crashed nodes, re-place their shards.

        ``crashed`` is one node name / index or a sequence of them
        (``SimNode.name`` entries of ``plan.cluster.nodes``). The default
        repair path keeps the survivors' profiled fog metadata:
        ``evacuate_assignment`` marks the crashed shards' vertices
        unassigned, ``repair_assignment`` greedily re-places them onto the
        survivors (min-cut-aware, capacity-bounded), ``refresh_placement``
        re-prices, and ``build_partitioned`` lays the survivors' shards out
        anew — falling back to a full compile on the surviving cluster when
        the repaired partitioning degrades past
        ``config.update_max_imbalance``. ``mode`` forces "repair" or
        "recompile" ("recompile" IS a fresh ``Engine.compile`` on the
        surviving cluster, re-tagged).

        The returned Plan has ``provenance="failover"``, a
        degraded-capacity ``cluster`` holding only the survivors, and
        ``config.cluster_spec=None``: a failover plan carrying the original
        spec string would resurrect the crashed node on the next
        ``from_plan`` recompile and price update repairs against capacity
        that no longer exists. Its layout is new, so its ``device_cache``
        starts empty: the first execute folds and compacts the survivors'
        shards on the device. The graph is unchanged, so a repair plan
        shares ``plan.edges``. Its ``fog_ranks`` are the survivors' ranks in
        ``plan`` (in both modes): with one fog per ``torch.distributed``
        rank, each survivor keeps its process and a crashed fog's rank
        holds no shard.
        """
        if mode not in (None, "repair", "recompile"):
            raise ValueError(f"mode must be None, 'repair' or 'recompile', "
                             f"got {mode!r}")
        nodes = plan.cluster.nodes
        names = [n.name for n in nodes]
        if isinstance(crashed, (str, int, np.integer)):
            crashed = [crashed]
        evicted = set()
        for c in crashed:
            if isinstance(c, (int, np.integer)):
                j = int(c)
                if not 0 <= j < len(nodes):
                    raise ValueError(f"node index {j} out of range for "
                                     f"{len(nodes)} nodes")
            else:
                if c not in names:
                    raise KeyError(f"unknown node {c!r}; cluster has: "
                                   f"{', '.join(names)}")
                j = names.index(c)
            evicted.add(j)
        if not evicted:
            raise ValueError("fail_nodes needs at least one crashed node")
        keep = [j for j in range(len(nodes)) if j not in evicted]
        if not keep:
            raise ValueError(
                f"cannot fail every node ({sorted(names[j] for j in evicted)}"
                f" is the whole cluster); at least one must survive")
        cfg = plan.config
        survivors = dataclasses.replace(
            plan.cluster, nodes=[nodes[j] for j in keep])
        ranks = (range(len(nodes)) if plan.fog_ranks is None
                 else plan.fog_ranks)
        fog_ranks = tuple(ranks[j] for j in keep)
        if mode != "recompile":
            base = (plan.placement.assignment if assignment is None
                    else np.asarray(assignment, np.int64))
            evacuated = incremental.evacuate_assignment(base, keep,
                                                        len(nodes))
            repaired = incremental.repair_assignment(plan.graph, evacuated,
                                                     len(keep))
            imb_before = incremental.imbalance_of(base, len(nodes))
            imb = incremental.imbalance_of(repaired, len(keep))
            if (mode == "repair"
                    or imb <= cfg.update_max_imbalance
                    * max(1.0, imb_before)):
                fogs = tuple(plan.fogs[j] for j in keep)
                placement = incremental.refresh_placement(
                    plan.graph, repaired, np.arange(len(keep)), fogs,
                    bytes_per_vertex=cfg.bytes_per_vertex,
                    k_layers=self.model.num_layers,
                    sync_cost=plan.cluster.sync_cost)
                needs_shards = self._executor.needs_block_shards
                agg = bsp.resolve_aggregation(
                    cfg.aggregation, self.model.kind,
                    exchange=cfg.exchange if needs_shards else None,
                    device=self.device)
                build_blocks = ((needs_shards and agg == "pallas")
                                or plan.partitioned.local_csr is not None)
                partitioned = bsp.build_partitioned(
                    plan.graph, repaired, build_blocks=build_blocks,
                    n=len(keep))
                return self._validated(Plan(
                    model=self.model, graph=plan.graph, cluster=survivors,
                    fogs=fogs, placement=placement, partitioned=partitioned,
                    config=cfg.with_overrides(cluster_spec=None),
                    edges=plan.edges, provenance="failover",
                    fog_ranks=fog_ranks))
        # Recompile: the full setup phase on the surviving cluster (fresh
        # per-node profiling seeds at the survivors' new indices) — the
        # result IS a fresh Engine.compile of that cluster, re-tagged.
        eng = Engine(self.model, survivors, network=cfg.network,
                     partitioner=cfg.partitioner, placement=cfg.placement,
                     compressor=cfg.compressor, exchange=cfg.exchange,
                     executor=cfg.executor, hidden=cfg.hidden,
                     seed=cfg.seed, sync_cost=cfg.sync_cost,
                     bytes_per_vertex=cfg.bytes_per_vertex,
                     aggregation=cfg.aggregation, device=cfg.device,
                     staleness_bound=cfg.staleness_bound,
                     update_max_imbalance=cfg.update_max_imbalance,
                     update_max_cut_growth=cfg.update_max_cut_growth,
                     validate=cfg.validate)
        eng._fog_ranks = fog_ranks
        return dataclasses.replace(eng.compile(plan.graph),
                                   provenance="failover")

    # -- dynamic-graph updates ----------------------------------------------

    def _recompile(self, graph: Graph) -> Plan:
        """Full setup phase against a mutated graph (the fallback path)."""
        if isinstance(self.cluster, str):
            return self.compile(graph)
        # A prebuilt FogCluster was profiled against the old graph; rebind
        # it to the mutated one so wire bytes / ground truth stay honest.
        old = self.cluster
        self.cluster = dataclasses.replace(old, graph=graph,
                                           feature_dim=graph.feature_dim)
        try:
            return self.compile(graph)
        finally:
            self.cluster = old

    def apply_delta(self, plan: Plan,
                    delta: Union[GraphDelta, Sequence[GraphDelta]], *,
                    assignment: Optional[np.ndarray] = None,
                    max_imbalance: Optional[float] = None,
                    max_cut_growth: Optional[float] = None,
                    force: Optional[str] = None) -> Plan:
        """Absorb a graph mutation into ``plan`` without recomputing the
        world (paper §III-E workload adaptation).

        The repair path keeps the plan's profiled fog metadata and
        partition -> fog mapping, greedily assigns new vertices into the
        existing partitions (min-cut-aware, capacity-bounded), rebuilds
        only the *dirty* shards' block-CSR operands and halo exchange
        maps, and re-prices the placement estimates for the mutated
        topology. When the repaired partitioning degrades past the
        thresholds — imbalance above ``max_imbalance`` x the pre-update
        imbalance (floored at a balanced baseline) or edge-cut fraction
        above ``max_cut_growth`` x the pre-update cut — the full compile
        pipeline runs instead.

        On the device side a structural delta retires the old graph's
        cached whole-graph block-CSR operands (``ops.invalidate_block_csr``)
        and rebuilds ``Plan.edges`` from the mutated graph; a rebuilt
        layout starts with an empty ``device_cache``, so its first mesh
        execute uploads and compacts the operands again. Feature-only
        deltas on the plan's own assignment keep ``Plan.edges`` and share
        the layout's device copies (``PartitionedGraph.with_features``).

        Args:
          plan: the plan to update (left untouched; a new Plan returns).
          delta: one ``GraphDelta`` or a sequence applied in order (each
            delta addresses the graph produced by the previous one).
          assignment: base vertex -> fog assignment to repair (defaults to
            ``plan.placement.assignment``; sessions pass their adapted
            assignment).
          force: "incremental" skips the threshold check, "recompile"
            skips the repair.

        Returns a Plan with ``provenance`` of "incremental" or "recompile"
        and an ``update_report`` describing what happened; empty deltas
        return an equivalent plan with mode "noop".
        """
        cfg = plan.config
        deltas = [delta] if isinstance(delta, GraphDelta) else list(delta)
        if force not in (None, "incremental", "recompile"):
            raise ValueError(f"force must be None, 'incremental' or "
                             f"'recompile', got {force!r}")
        max_imbalance = (cfg.update_max_imbalance if max_imbalance is None
                         else max_imbalance)
        max_cut_growth = (cfg.update_max_cut_growth if max_cut_growth is None
                          else max_cut_growth)
        base = (plan.placement.assignment if assignment is None
                else np.asarray(assignment, np.int64))
        n = plan.num_fogs
        dp = incremental.plan_delta(plan.graph, base, deltas, n)
        report_kw = dict(num_deltas=len(deltas), num_partitions=n,
                         imbalance_before=dp.imbalance_before,
                         imbalance=dp.imbalance,
                         cut_fraction_before=dp.cut_fraction_before,
                         cut_fraction_after=dp.cut_fraction_after,
                         **dp.counts)

        if (not dp.structural and dp.counts["feature_upserts"] == 0
                and np.array_equal(base, plan.placement.assignment)
                and force != "recompile"):
            report = UpdateReport(mode="noop", **report_kw)
            return self._validated(
                dataclasses.replace(plan, provenance="incremental",
                                    update_report=report))

        recompile_reason = ""
        if force != "incremental" and dp.structural:
            # Both thresholds bound *degradation* relative to the plan
            # being repaired (floored at a perfectly balanced baseline):
            # IEP sizes partitions to heterogeneous capability, so a
            # skewed-but-intended layout must not trip the knob by itself.
            imbalance_limit = max_imbalance * max(1.0, dp.imbalance_before)
            if dp.imbalance > imbalance_limit:
                recompile_reason = (f"imbalance {dp.imbalance:.2f} > "
                                    f"{max_imbalance:.2f} x "
                                    f"{max(1.0, dp.imbalance_before):.2f}")
            elif dp.cut_fraction_after > max_cut_growth * max(
                    dp.cut_fraction_before, 1e-9):
                recompile_reason = (
                    f"cut fraction {dp.cut_fraction_after:.3f} > "
                    f"{max_cut_growth:.2f} x {dp.cut_fraction_before:.3f}")
        if force == "recompile":
            recompile_reason = "forced"
        if dp.structural:
            # The adjacency changed: retire the old graph's cached
            # whole-graph block-CSR operands. The mutated graph
            # fingerprints differently, so stale operands are never
            # served; without this each would pin its dense tiles in the
            # card's memory (kernels/ops.py) until LRU eviction.
            ops.invalidate_block_csr(plan.graph)
        if recompile_reason:
            plan2 = self._recompile(dp.graph)
            report = UpdateReport(mode="recompile", reason=recompile_reason,
                                  **report_kw)
            return dataclasses.replace(plan2, provenance="recompile",
                                       update_report=report)

        # plan.partitioned was laid out for plan.placement.assignment; it
        # is only a valid reuse source (for clean-shard tiles, or for the
        # feature-only with_features fast path) when the repair started
        # from that same assignment. A session that adapted migrates
        # vertices without touching plan.partitioned, so its repairs must
        # rebuild from scratch for the adapted assignment.
        base_is_plan = np.array_equal(base, plan.placement.assignment)
        needs_shards = self._executor.needs_block_shards
        mode = bsp.resolve_aggregation(
            cfg.aggregation, self.model.kind,
            exchange=cfg.exchange if needs_shards else None,
            device=self.device)
        build_blocks = (needs_shards and mode == "pallas"
                        ) or plan.partitioned.local_csr is not None
        if not dp.structural and base_is_plan:
            # Feature-only: same topology, same layout, same block shards
            # (and their device copies) — only the feature table changes.
            partitioned = plan.partitioned.with_features(dp.graph.features)
            dirty_l = dirty_h = ()
        elif not dp.structural:
            # Feature-only delta on an adapted assignment: the delta
            # dirtied nothing, but the layout must match the adapted
            # assignment, which plan.partitioned does not.
            partitioned = bsp.build_partitioned(
                dp.graph, dp.assignment, build_blocks=build_blocks, n=n)
            dirty_l = dirty_h = ()
        else:
            partitioned = bsp.build_partitioned(
                dp.graph, dp.assignment, build_blocks=build_blocks, n=n,
                prev=plan.partitioned if base_is_plan else None,
                dirty_local=dp.dirty_local, dirty_halo=dp.dirty_halo)
            dirty_l = tuple(int(p) for p in dp.dirty_local)
            dirty_h = tuple(int(p) for p in dp.dirty_halo)
        placement = incremental.refresh_placement(
            dp.graph, dp.assignment, plan.placement.mapping, plan.fogs,
            bytes_per_vertex=cfg.bytes_per_vertex,
            k_layers=self.model.num_layers,
            sync_cost=plan.cluster.sync_cost)
        cluster = dataclasses.replace(plan.cluster, graph=dp.graph,
                                      feature_dim=dp.graph.feature_dim)
        # The edge list caches its receiver order, gather index, degrees
        # and long segments: a stale one would sum the old topology.
        edges = (EdgeList.from_graph(dp.graph, device=self.device)
                 if dp.structural else plan.edges)
        report = UpdateReport(
            mode="features" if not dp.structural else "incremental",
            dirty_local=dirty_l, dirty_halo=dirty_h, **report_kw)
        return self._validated(
            Plan(model=self.model, graph=dp.graph, cluster=cluster,
                 fogs=plan.fogs, placement=placement,
                 partitioned=partitioned, config=cfg, edges=edges,
                 provenance="incremental", update_report=report,
                 fog_ranks=plan.fog_ranks))

    def __repr__(self) -> str:
        c = self.config
        return (f"Engine(kind={self.model.kind!r}, "
                f"cluster={c.cluster_spec or 'custom'}, "
                f"placement={c.placement!r}, compressor={c.compressor!r}, "
                f"exchange={c.exchange!r}, executor={c.executor!r}, "
                f"aggregation={c.aggregation!r}, device={c.device!r})")
