"""Compiled execution plans (the frozen output of ``Engine.compile``).

A ``Plan`` is the paper's "execution plan" artifact: profiling + IEP
placement have already run, the per-partition static-shape buffers are
frozen, the model's parameters sit on the plan's device, and every
pipeline component is resolved to a registry entry. Plans are immutable —
serving state (adaptive-scheduler migrations, query counters) lives in
``Session`` objects spawned from the plan, so one plan can back many
sessions without interference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.placement import FogSpec, Placement
from repro_torch.core.simulation import FogCluster
from repro_torch.gnn.graph import Graph
from repro_torch.gnn.layers import LAYER_FNS, EdgeList
from repro_torch.gnn.models import GNN
from repro_torch.runtime.bsp import PartitionedGraph


def _as_f32(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32)
    return torch.tensor(np.asarray(v, np.float32))


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """The GNN being served: per-layer params + layer kind (Table I).

    ``params`` is a sequence of per-layer dicts; their values may be
    tensors or arrays and are held as float32 tensors.
    """
    params: tuple
    kind: str

    def __post_init__(self):
        if self.kind not in LAYER_FNS:
            raise ValueError(f"unknown GNN kind {self.kind!r}; "
                             f"available: {', '.join(sorted(LAYER_FNS))}")
        object.__setattr__(self, "params", tuple(
            {k: _as_f32(v) for k, v in p.items()} for p in self.params))

    @property
    def num_layers(self) -> int:
        return len(self.params)

    def to(self, device) -> "ModelSpec":
        """The same model with every parameter on ``device``."""
        return ModelSpec(params=tuple({k: v.to(device) for k, v in p.items()}
                                      for p in self.params), kind=self.kind)


def as_model(model) -> ModelSpec:
    """Coerce ``(params, kind)`` / ``(kind, params)`` / ``GNN`` / ModelSpec.

    ``params`` may itself be a ``GNN`` module.
    """
    if isinstance(model, ModelSpec):
        return model
    if isinstance(model, GNN):
        return ModelSpec(params=tuple(model.params), kind=model.kind)
    if isinstance(model, (tuple, list)) and len(model) == 2:
        a, b = model
        if isinstance(a, str):
            a, b = b, a
        if isinstance(a, GNN):
            a = a.params
        return ModelSpec(params=tuple(a), kind=b)
    raise TypeError("model must be a ModelSpec, a GNN or a (params, kind) "
                    f"pair, got {type(model).__name__}")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Resolved registry keys + knobs an Engine compiled with."""
    partitioner: str
    placement: str
    compressor: str
    exchange: str
    executor: str
    network: str
    cluster_spec: Optional[str]
    hidden: int
    seed: int
    sync_cost: float
    bytes_per_vertex: Optional[float] = None
    # Aggregation path: "segment_sum" | "pallas" | "auto" (auto = the
    # block-CSR kernels wherever supported on a CUDA device, segment_sum
    # elsewhere). See runtime.bsp.resolve_aggregation.
    aggregation: str = "auto"
    # torch device the plan's numerics run on ("cuda", "cuda:1", "cpu").
    device: str = "cuda"
    # Stale-tolerant serving bound for the "halo_async" exchange: a serve
    # may replay recorded halo tables up to this many versions old before
    # the next fresh exchange is forced. 0 (the default) means every serve
    # syncs — bitwise exchange="halo". Only legal with a stale-tolerant
    # exchange entry (Engine validates eagerly).
    staleness_bound: int = 0
    # Dynamic-update repair thresholds (Engine.apply_delta): fall back to a
    # full recompile when the repaired partitioning's imbalance (max size /
    # uniform share) exceeds update_max_imbalance x the pre-update
    # imbalance (floored at 1.0, so heterogeneity-sized plans aren't
    # penalized for their intended skew), or its cut fraction exceeds
    # update_max_cut_growth x the pre-update cut fraction.
    update_max_imbalance: float = 2.0
    update_max_cut_growth: float = 1.5
    # Static plan verification (repro_torch.analysis): "off" | "warn" |
    # "strict". strict runs the plan invariant checks at Engine.compile /
    # apply_delta / fail_nodes exit and raises PlanValidationError on any
    # violation; warn emits PlanInvariantWarning instead. Never changes
    # what is compiled.
    validate: str = "off"

    def with_overrides(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Plan:
    """An immutable compiled serving plan: Engine.compile(graph) -> Plan.

    ``provenance`` records how the plan was produced: "compile" (the full
    setup phase), "incremental" (``Engine.apply_delta`` repaired an
    existing plan), "recompile" (a delta tripped a repair threshold and
    the full pipeline re-ran) or "failover" (``Engine.fail_nodes``
    re-placed a crashed node's shards onto the surviving,
    degraded-capacity cluster; such plans carry ``cluster_spec=None`` so
    later recompiles and pricing never resurrect the crashed node);
    ``update_report`` is the
    :class:`~repro_torch.api.updates.UpdateReport` of the delta that
    produced an updated plan (None for fresh compiles). ``edges`` is built
    from ``graph`` and is rebuilt whenever a delta changes the topology.
    ``fog_ranks`` says which ``torch.distributed`` world rank holds each
    fog when the ``mesh-bsp`` executor serves one fog per rank: None
    means fog ``p`` on rank ``p`` (a compile, whose fogs are the world); a
    failover plan keeps its survivors' ranks, increasing, and the crashed
    fogs' ranks hold no shard. It is not compared.
    """
    model: ModelSpec
    graph: Graph
    cluster: FogCluster
    fogs: Tuple[FogSpec, ...]
    placement: Placement
    partitioned: PartitionedGraph
    config: EngineConfig
    # The graph's COO edges on the plan's device, shared by every query.
    edges: EdgeList = dataclasses.field(compare=False, repr=False)
    provenance: str = "compile"
    update_report: Optional[object] = None
    fog_ranks: Optional[Tuple[int, ...]] = dataclasses.field(
        default=None, compare=False)

    @property
    def num_fogs(self) -> int:
        return len(self.fogs)

    @property
    def est_makespan(self) -> float:
        return self.placement.est_makespan

    @property
    def device(self) -> torch.device:
        return torch.device(self.config.device)

    def vertices_per_fog(self) -> np.ndarray:
        return np.bincount(self.placement.assignment,
                           minlength=self.num_fogs)

    def with_overrides(self, *, compressor: Optional[str] = None,
                       num_layers: Optional[int] = None) -> "Plan":
        """Derive a plan with degraded serving knobs, sharing every frozen
        buffer of this one.

        ``compressor`` swaps the upload codec; ``num_layers`` truncates the
        GNN to its first ``L`` layers (the truncated last layer serves
        logits) and re-prices the cluster's per-query workload at ``L``
        layers. The graph, placement and partitioned buffers are shared —
        this is a cheap view, not a recompile.
        """
        changes = {}
        if compressor is not None:
            from repro_torch.api.registry import COMPRESSORS
            COMPRESSORS.resolve(compressor)   # fail fast on bad keys
            key = COMPRESSORS.canonical(compressor)
            if key != self.config.compressor:
                changes["config"] = self.config.with_overrides(
                    compressor=key)
        if num_layers is not None:
            k = self.model.num_layers
            if not 1 <= num_layers <= k:
                raise ValueError(f"num_layers must be in [1, {k}], "
                                 f"got {num_layers}")
            if num_layers < k:
                changes["model"] = ModelSpec(
                    params=self.model.params[:num_layers],
                    kind=self.model.kind)
                changes["cluster"] = dataclasses.replace(
                    self.cluster, k_layers=num_layers)
        return dataclasses.replace(self, **changes) if changes else self

    def session(self, **kw) -> "Session":
        """Open a serving session (owns all mutable runtime state)."""
        from repro_torch.api.session import Session
        return Session(self, **kw)

    def server(self, *, max_batch: int = 8, max_wait: float = 0.0,
               pipelined: bool = True, slo=None, adaptive_batch=None,
               faults=None, **session_kw) -> "Server":
        """Open a request-level server (micro-batching + pipelined
        collect/execute) over a fresh session; ``slo``/``adaptive_batch``
        activate the SLO control plane (``repro_torch.api.slo``); ``faults``
        installs a chaos schedule (``repro_torch.api.faults``); extra
        kwargs go to ``session()``."""
        from repro_torch.api.server import Server
        return Server(self.session(**session_kw), max_batch=max_batch,
                      max_wait=max_wait, pipelined=pipelined, slo=slo,
                      adaptive_batch=adaptive_batch, faults=faults)

    def describe(self) -> dict:
        """Plain-dict summary (for logs / dashboards)."""
        return {
            "model": {"kind": self.model.kind,
                      "layers": self.model.num_layers},
            "graph": {"vertices": self.graph.num_vertices,
                      "edges": self.graph.num_edges,
                      "feature_dim": self.graph.feature_dim},
            "fogs": [f.name for f in self.fogs],
            "vertices_per_fog": self.vertices_per_fog().tolist(),
            "est_makespan": self.est_makespan,
            "pipeline": dataclasses.asdict(self.config),
            "provenance": self.provenance,
        }
