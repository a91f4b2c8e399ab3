"""Engine: the single front door to the Fograph serving pipeline.

    Engine(model, cluster, device="cuda", **knobs).compile(graph) -> Plan
    Plan.session() -> Session -> Session.query() -> QueryResult

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

from typing import Optional, Union

import torch

from repro_torch.api import executors as _executors  # noqa: F401  (registers backends)
from repro_torch.api.registry import (COMPRESSORS, EXCHANGES, EXECUTORS,
                                      PARTITIONERS, PLACEMENTS)
from repro_torch.api.plan import EngineConfig, ModelSpec, Plan, as_model
from repro_torch.core import simulation
from repro_torch.gnn.graph import Graph
from repro_torch.gnn.layers import EdgeList
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


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet: ROADMAP Queue 1 "
                               f"item {item}")


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
      staleness_bound / validate: knobs of subsystems not ported yet;
        anything but their inert defaults (0 / "off") raises.
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
        if int(staleness_bound) != 0:
            raise _not_ported(f"staleness_bound={staleness_bound}",
                              "10, fleet and stale halos")
        if validate != "off":
            raise _not_ported(f"validate={validate!r}",
                              "12, static verifier")
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
            device=str(self.device))

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
        return Plan(model=self.model, graph=graph, cluster=cluster,
                    fogs=fogs, placement=placement, partitioned=partitioned,
                    config=cfg,
                    edges=EdgeList.from_graph(graph, device=self.device))

    @classmethod
    def from_plan(cls, plan: Plan) -> "Engine":
        """Reconstruct the Engine a plan was compiled with (same knobs,
        same device)."""
        cfg = plan.config
        return cls(plan.model,
                   cfg.cluster_spec if cfg.cluster_spec else plan.cluster,
                   network=cfg.network, partitioner=cfg.partitioner,
                   placement=cfg.placement, compressor=cfg.compressor,
                   exchange=cfg.exchange, executor=cfg.executor,
                   hidden=cfg.hidden, seed=cfg.seed,
                   sync_cost=cfg.sync_cost,
                   bytes_per_vertex=cfg.bytes_per_vertex,
                   aggregation=cfg.aggregation, device=cfg.device)

    def compile_fleet(self, graph: Graph, sites):
        raise _not_ported("Engine.compile_fleet", "10, fleet and stale halos")

    def apply_delta(self, plan: Plan, delta, **kwargs):
        raise _not_ported("Engine.apply_delta", "8, dynamic graphs")

    def fail_nodes(self, plan: Plan, crashed, **kwargs):
        raise _not_ported("Engine.fail_nodes", "11, fault tolerance")

    def __repr__(self) -> str:
        c = self.config
        return (f"Engine(kind={self.model.kind!r}, "
                f"cluster={c.cluster_spec or 'custom'}, "
                f"placement={c.placement!r}, compressor={c.compressor!r}, "
                f"exchange={c.exchange!r}, executor={c.executor!r}, "
                f"aggregation={c.aggregation!r}, device={c.device!r})")
