"""Fog/cloud serving latency simulation (paper §II-C methodology).

The reproduction has no LAN/WAN or heterogeneous machines, so the measurement
study and all latency/throughput benchmarks run on an analytic simulator
whose constants are calibrated to reproduce the paper's *reported ratios*
(Fig. 3: 64/67/61% collection reduction fog vs cloud; ~1.65/1.73/1.40x
single-fog speedups; cloud execution <2% of its pipeline; straw-man
multi-fog exec ~= 67% of single-fog).

Node types A/B/C follow Table II (A is ~37.8% slower than B per §IV-A;
C is the most powerful). Network constants model effective *collection*
bandwidth; NSA 5G uplink is the weakest (hence the paper's largest fog
speedup on 5G), WiFi the strongest.

Everything downstream (IEP, scheduler, benchmarks) consumes this module via
``FogSpec`` latency models, and the *ground truth* execution cost uses the
same analytic workload formula with the true capability — so planner error
vs. reality stays representative.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import compression
from repro_torch.core.placement import FogSpec, Placement
from repro_torch.core.profiler import (LatencyModel, analytic_measurer,
                                 cardinality_of, profile_node_analytic)
from repro_torch.gnn.graph import Graph

# ----------------------------------------------------------------------------
# Hardware / network constants (calibrated to paper ratios)
# ----------------------------------------------------------------------------

# Effective sustained GNN throughput (flop/s) per node type. Table II gives
# i7-6700 (A: 4GB, memory-bound; B: 8GB) and Xeon W-2145 (C).
NODE_CAPABILITY = {
    "A": 1.20e8,
    "B": 1.90e8,   # A is ~37% slower than B (paper §IV-A: 37.8%)
    "C": 3.20e8,
    "cloud": 5.0e10,  # Tesla V100 instance
}

# Effective aggregate data-collection bandwidth, bytes/s.
#   wan: devices -> remote cloud (Internet);  lan: devices -> local fogs.
NETWORKS = {
    "4g":   dict(wan=2.40e6, lan=5.00e6),   # fog collect ~36% of cloud
    "5g":   dict(wan=1.92e6, lan=4.36e6),   # ~33% (67% cut)
    "wifi": dict(wan=4.80e6, lan=9.23e6),   # ~39% (61% cut)
}

# Long-tail collection (paper SSVI "long-tail distribution of data
# collection time", SSII-C "GNN execution is obliged to wait until all
# correlated data points arrive"): the slowest of V device uploads grows
# ~ln(V); WAN tails are an order of magnitude heavier than LAN.
WAN_TAIL_S = 0.12
LAN_TAIL_S = 0.015

# Uncompressible per-vertex transport overhead (headers, ids, timestamps).
PROTOCOL_BYTES_PER_VERTEX = 24.0

DECOMPRESS_BYTES_PER_S = 200e6   # zlib inflate on fog CPU
QUANTIZE_OVERHEAD_S = 2e-3       # device-side packing (parallelized, §III-D)
DEFAULT_SYNC_COST = 0.10         # delta: one BSP synchronization (LAN round)
CLOUD_RTT = 0.05


# Per-fog allocated-bandwidth diversity (paper SSII: "their available
# bandwidth allocated for serving also vary"): weak gateways sit on slower
# uplinks than cloudlets. Factors are relative to the per-fog fair share.
BANDWIDTH_FACTOR = {"A": 0.6, "B": 1.0, "C": 1.5}


@dataclasses.dataclass
class SimNode:
    name: str
    node_type: str
    capability: float          # true flop/s (ground truth)
    background_load: float = 0.0   # >=0; effective = capability/(1+load)

    @property
    def effective_capability(self) -> float:
        return self.capability / (1.0 + self.background_load)

    @property
    def bandwidth_factor(self) -> float:
        return BANDWIDTH_FACTOR.get(self.node_type, 1.0)


def parse_cluster_spec(spec: str) -> List[str]:
    """"1A+4B+1C" -> ['A','B','B','B','B','C']."""
    out = []
    for term in spec.split("+"):
        term = term.strip()
        count, t = int(term[:-1]), term[-1].upper()
        out.extend([t] * count)
    return out


def multi_access_bandwidth(lan: float, n: int) -> float:
    """Per-fog collection bandwidth with n access points: more fogs widen
    total bandwidth sub-linearly (paper §II-C: 'widens the bandwidth and
    relieves the networking contention')."""
    total = lan * (1.0 + 0.25 * (n - 1))
    return total / n


def exec_flops(card, feature_dim: int, hidden: int, k_layers: int) -> float:
    """Workload model shared by profiler and ground truth: per layer,
    update matmuls ~ 2 V F H, aggregation ~ 8 |N_V| F."""
    v, nv = card
    return k_layers * (2.0 * v * feature_dim * hidden + 8.0 * nv * feature_dim)


@dataclasses.dataclass
class FogCluster:
    nodes: List[SimNode]
    network: str
    graph: Graph
    feature_dim: int
    hidden: int
    k_layers: int
    sync_cost: float = DEFAULT_SYNC_COST
    profile_noise: float = 0.03

    def lan_bandwidth_per_fog(self) -> float:
        return multi_access_bandwidth(NETWORKS[self.network]["lan"],
                                      len(self.nodes))

    def ground_truth_exec(self, node: SimNode, vertex_ids: np.ndarray) -> float:
        card = cardinality_of(self.graph, vertex_ids)
        return (exec_flops(card, self.feature_dim, self.hidden, self.k_layers)
                / node.effective_capability + 1e-4)

    def node_bandwidth(self, node: SimNode) -> float:
        """Per-fog allocated bandwidth (fair share x type diversity,
        renormalized so the cluster total is unchanged)."""
        base = self.lan_bandwidth_per_fog()
        mean_f = np.mean([n.bandwidth_factor for n in self.nodes])
        return base * node.bandwidth_factor / mean_f

    def fog_specs(self, seed: int = 0) -> List[FogSpec]:
        """Profile every node (offline phase) and register metadata."""
        specs = []
        for j, node in enumerate(self.nodes):
            rng = np.random.default_rng(seed + 1000 + j)

            def measure_c(c, _cap=node.capability, _rng=rng):
                t = (exec_flops(c, self.feature_dim, self.hidden,
                                self.k_layers) / _cap + 1e-4)
                if self.profile_noise:
                    t *= float(1.0 + _rng.normal(scale=self.profile_noise))
                return max(t, 1e-9)

            model = profile_node_analytic(self.graph, measure_c, seed=seed + j)
            specs.append(FogSpec(name=node.name,
                                 bandwidth_bytes_per_s=self.node_bandwidth(
                                     node),
                                 latency_model=model))
        return specs


def make_cluster(spec: str, network: str, graph: Graph, *, hidden: int = 64,
                 k_layers: int = 2, seed: int = 0,
                 sync_cost: float = DEFAULT_SYNC_COST) -> FogCluster:
    types = parse_cluster_spec(spec)
    nodes = [SimNode(name=f"fog{j}({t})", node_type=t,
                     capability=NODE_CAPABILITY[t])
             for j, t in enumerate(types)]
    return FogCluster(nodes=nodes, network=network, graph=graph,
                      feature_dim=graph.feature_dim, hidden=hidden,
                      k_layers=k_layers, sync_cost=sync_cost)


# ----------------------------------------------------------------------------
# Serving pipelines (latency + throughput accounting)
# ----------------------------------------------------------------------------

def _norm_compress(compress: Optional[str]) -> Optional[str]:
    """The registry's explicit "none" key means the same as None here."""
    return None if compress in (None, "none") else compress


def _partition_wire_bytes(g: Graph, vertex_ids: np.ndarray,
                          compress: Optional[str]) -> float:
    overhead = len(vertex_ids) * PROTOCOL_BYTES_PER_VERTEX
    raw = len(vertex_ids) * g.feature_dim * 8.0 + overhead
    if compress is None or len(vertex_ids) == 0:
        return raw
    feats = g.features[vertex_ids].astype(np.float64)
    degs = g.degrees[vertex_ids]
    if compress == "daq":
        return overhead + float(compression.daq_pack(feats, degs).nbytes(True))
    if compress == "daq_lz4":    # DAQ with the paper's LZ4 lossless stage
        return overhead + float(
            compression.daq_pack(feats, degs, codec="lz4").nbytes(True))
    if compress == "daq_noll":   # DAQ without the lossless stage
        return overhead + float(compression.daq_pack(feats, degs, lossless=False)
                                .nbytes(False))
    if compress == "uniform8":
        return overhead + float(compression.uniform_pack(feats, 8).nbytes(True))
    raise ValueError(compress)


@dataclasses.dataclass
class ServingResult:
    collect: np.ndarray      # per fog
    execute: np.ndarray      # per fog (incl. sync)
    unpack: np.ndarray       # per fog (pipelined; reported separately)
    total_latency: float
    throughput: float        # pipelined steady-state inferences/s
    wire_bytes: float

    def breakdown(self) -> Dict[str, float]:
        per_fog = self.collect + self.execute
        j = int(np.argmax(per_fog))
        return {"collect": float(self.collect[j]),
                "execute": float(self.execute[j]),
                "total": self.total_latency}


def simulate_cloud(cluster: FogCluster, *, compress: Optional[str] = None,
                   congestion: float = 1.0,
                   batch_size: int = 1) -> ServingResult:
    """De-facto cloud serving: full upload over WAN, fast datacenter GPU.

    ``batch_size`` > 1 prices a micro-batch of B coalesced queries: B full
    uploads share one WAN round-trip and one coalesced long-tail window
    (slowest of B*V uploads ~ ln(B*V)), and the GPU runs B inferences
    back-to-back with one launch overhead.
    """
    compress = _norm_compress(compress)
    b = int(batch_size)
    g = cluster.graph
    wan = NETWORKS[cluster.network]["wan"]
    all_v = np.arange(g.num_vertices)
    wire = _partition_wire_bytes(g, all_v, compress) * b
    tail = WAN_TAIL_S * np.log(max(b * g.num_vertices, 2))
    collect = wire / wan * congestion + CLOUD_RTT + tail
    cloud = SimNode("cloud", "cloud", NODE_CAPABILITY["cloud"])
    exec_t = (b * exec_flops((g.num_vertices, 0), cluster.feature_dim,
                             cluster.hidden, cluster.k_layers)
              / cloud.effective_capability + 5e-3)
    unpack = wire / DECOMPRESS_BYTES_PER_S if compress else 0.0
    total = collect + exec_t + unpack
    return ServingResult(np.array([collect]), np.array([exec_t]),
                         np.array([unpack]), total,
                         b / max(collect, exec_t + unpack), wire)


def simulate_single_fog(cluster: FogCluster, *,
                        compress: Optional[str] = None,
                        batch_size: int = 1) -> ServingResult:
    """Single most-powerful fog node executes everything (paper §II-C)."""
    compress = _norm_compress(compress)
    b = int(batch_size)
    g = cluster.graph
    lan = NETWORKS[cluster.network]["lan"]
    best = max(cluster.nodes, key=lambda nd: nd.effective_capability)
    all_v = np.arange(g.num_vertices)
    wire = _partition_wire_bytes(g, all_v, compress) * b
    collect = wire / lan + LAN_TAIL_S * np.log(max(b * g.num_vertices, 2))
    exec_t = b * cluster.ground_truth_exec(best, all_v)
    unpack = wire / DECOMPRESS_BYTES_PER_S if compress else 0.0
    total = collect + exec_t + unpack
    return ServingResult(np.array([collect]), np.array([exec_t]),
                         np.array([unpack]), total,
                         b / max(collect, exec_t + unpack), wire)


def simulate_multi_fog(cluster: FogCluster, placement: Placement, *,
                       compress: Optional[str] = None,
                       batch_size: int = 1,
                       sync_scale: float = 1.0) -> ServingResult:
    """Distributed BSP serving under a data placement (straw-man or IEP).

    Latency = max_j (collect_j + exec_j) + K*delta sync (Eq. 6/7); unpack is
    pipelined on a separate thread (§III-D) and overlaps execution, so only
    its non-overlapped remainder counts.

    ``batch_size`` > 1 prices a micro-batch of B coalesced queries (§III-D
    micro-batching): each fog collects B feature uploads in one window —
    paying the device-side packing overhead once and one coalesced
    long-tail (slowest of B*|V_j| uploads ~ ln(B*|V_j|)) — then runs one
    batched BSP superstep whose per-layer synchronizations carry all B
    feature sets, so the K*delta sync cost is paid once per batch instead
    of once per query.

    ``sync_scale`` scales the K*delta per-layer synchronization term: a
    stale-tolerant ``halo_async`` serve that replays recorded halo tables
    never stalls a superstep on the exchange, so it is priced at
    ``sync_scale=0.0`` (the whole point of the mode on WAN-separated
    sites); 1.0 is the synchronous exchange.
    """
    if not 0.0 <= sync_scale <= 1.0:
        raise ValueError(f"sync_scale must be in [0, 1], got {sync_scale}")
    compress = _norm_compress(compress)
    b = int(batch_size)
    g = cluster.graph
    n = len(cluster.nodes)
    collect = np.zeros(n)
    exec_t = np.zeros(n)
    unpack = np.zeros(n)
    wire_total = 0.0
    for j, node in enumerate(cluster.nodes):
        mine = np.flatnonzero(placement.assignment == j)
        if mine.size == 0:
            continue
        wire = _partition_wire_bytes(g, mine, compress) * b
        wire_total += wire
        bw = cluster.node_bandwidth(node)
        collect[j] = (wire / bw + (QUANTIZE_OVERHEAD_S if compress else 0.0)
                      + LAN_TAIL_S * np.log(max(b * len(mine), 2)))
        exec_t[j] = (b * cluster.ground_truth_exec(node, mine)
                     + sync_scale * cluster.k_layers * cluster.sync_cost)
        unpack[j] = wire / DECOMPRESS_BYTES_PER_S if compress else 0.0
        # Pipelined unpack: only the part not hidden by execution adds.
        exec_t[j] += max(0.0, unpack[j] - exec_t[j]) * 0.0
    per_fog = collect + exec_t
    total = float(per_fog.max())
    throughput = b / max(collect.max(), exec_t.max())
    return ServingResult(collect, exec_t, unpack, total, throughput,
                         wire_total)


def simulate(pipeline: str, cluster: FogCluster,
             placement: Optional[Placement] = None, *,
             compress: Optional[str] = None,
             batch_size: int = 1,
             sync_scale: float = 1.0) -> ServingResult:
    """Dispatch the latency accounting for one serving pipeline.

    ``pipeline``: "cloud", "single" (most powerful fog) or "multi"
    (distributed BSP under ``placement``). Executor backends resolve their
    accounting through this single entry point. ``batch_size`` prices a
    micro-batch of coalesced queries (B=1 is one query and reproduces the
    unbatched numbers exactly). ``sync_scale`` scales the multi-fog
    pipeline's K*delta sync term (0.0 for a stale ``halo_async`` serve —
    no superstep stalls on the exchange); the single/cloud pipelines have
    no BSP sync and ignore it.
    """
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    if pipeline == "cloud":
        return simulate_cloud(cluster, compress=compress,
                              batch_size=batch_size)
    if pipeline == "single":
        return simulate_single_fog(cluster, compress=compress,
                                   batch_size=batch_size)
    if pipeline == "multi":
        if placement is None:
            raise ValueError("pipeline 'multi' needs a placement")
        return simulate_multi_fog(cluster, placement, compress=compress,
                                  batch_size=batch_size,
                                  sync_scale=sync_scale)
    raise ValueError(f"unknown pipeline {pipeline!r}; "
                     "available: cloud, multi, single")


# ----------------------------------------------------------------------------
# Two-stage collect/execute pipeline (paper §III-D "parallelized
# data collection": query i+1's compressed collection overlaps query i's
# execution on the fogs)
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BatchSchedule:
    """Timeline of one micro-batch through the two-stage pipeline.

    The collection stage (shared uplink + unpack threads) and the
    execution stage (fog CPUs + BSP syncs) are each serially reusable, so
    batch k's collection may overlap batch k-1's execution but two batches
    never collect (or execute) concurrently. ``overlap_saved`` is the time
    this batch's collection ran concurrently with the previous batch's
    execution — the §III-D pipelining win.
    """
    ready: float
    collect_start: float
    collect_end: float
    execute_start: float
    execute_end: float
    overlap_saved: float = 0.0

    @property
    def queue_delay(self) -> float:
        return self.collect_start - self.ready

    @property
    def span(self) -> float:
        return self.execute_end - self.collect_start


def pipeline_schedule(batches: Sequence[Tuple[float, float, float]],
                      *, pipelined: bool = True,
                      start: Tuple[float, float, float] = (0.0, 0.0, 0.0)
                      ) -> List[BatchSchedule]:
    """Schedule ``(ready, collect, execute)`` stage times through the
    two-stage pipeline; returns one :class:`BatchSchedule` per batch.

    ``pipelined=False`` reproduces the strictly serial loop (batch k's
    collection waits for batch k-1's execution to finish) — the
    ``Session.stream`` baseline the pipelined server is measured against.

    ``start`` is ``(collect_free, execute_free, prev_execute_start)``
    resource state, so callers (the ``Server``) can schedule batches
    incrementally in O(1) each: feed ``schedule_state(sched[-1])`` of one
    call as the ``start`` of the next.
    """
    out: List[BatchSchedule] = []
    collect_free, execute_free, prev_e_start = start
    for ready, c_t, e_t in batches:
        floor = collect_free if pipelined else max(collect_free, execute_free)
        c_start = max(ready, floor)
        c_end = c_start + c_t
        e_start = max(c_end, execute_free)
        e_end = e_start + e_t
        # Intersection of this collect window with the previous execute
        # window: the collection time hidden behind execution.
        overlap = max(0.0, min(c_end, execute_free) - max(c_start,
                                                          prev_e_start))
        out.append(BatchSchedule(ready, c_start, c_end, e_start, e_end,
                                 overlap))
        collect_free, execute_free, prev_e_start = c_end, e_end, e_start
    return out


def schedule_state(sched: BatchSchedule) -> Tuple[float, float, float]:
    """Resource state after ``sched``, for ``pipeline_schedule(start=...)``."""
    return (sched.collect_end, sched.execute_end, sched.execute_start)


# ----------------------------------------------------------------------------
# Dynamic-graph update pricing (the serving control plane's admission input)
# ----------------------------------------------------------------------------

# Fixed control overhead of one repair: delta folding, placement bookkeeping,
# and the repartitioner's greedy pass — independent of delta size.
UPDATE_BASE_S = 0.02
# Rebuild work per touched vertex/edge, in flop-equivalents priced against
# the cluster's mean capability: dirty-shard block-CSR re-packing reads each
# touched vertex's feature row and each touched edge's adjacency entry a
# small constant number of times.
UPDATE_VERTEX_FLOPS = 64.0
UPDATE_EDGE_FLOPS = 16.0


def simulate_update(cluster: FogCluster, delta) -> float:
    """Price one graph-delta repair on the simulated serving clock.

    ``delta`` is any object with the graph-delta shape accessors
    (``num_added_vertices``, ``remove_vertices``, ``add_edges``,
    ``remove_edges``, ``feature_ids``, ``is_structural``) — duck-typed so
    this core module stays import-free of ``repro_torch.api``.

    The price mirrors the incremental-repair stages: (a) fixed control
    overhead, (b) uploading new/updated feature rows over the LAN,
    (c) dirty-shard rebuild compute on the cluster's mean-capability fog,
    and (d) one BSP synchronization round when the delta is structural
    (repartition + halo table swap must quiesce the superstep). Updates
    serialize with execution in the ``Server``'s pipeline, so this is the
    time the execution stage is blocked.

    ``cluster`` must be the cluster the repair actually runs on: after a
    node failover the caller threads the SURVIVING ``FogCluster``
    (``plan.cluster`` of the failover plan) through, so the
    mean-capability term reflects degraded capacity rather than the
    original fleet.
    """
    g = cluster.graph
    touched_v = (delta.num_added_vertices + delta.num_removed_vertices
                 + len(delta.feature_ids))
    touched_e = len(delta.add_edges) + len(delta.remove_edges)
    uploads = delta.num_added_vertices + len(delta.feature_ids)
    wire = uploads * (g.feature_dim * 8.0 + PROTOCOL_BYTES_PER_VERTEX)
    collect = wire / NETWORKS[cluster.network]["lan"]
    mean_cap = float(np.mean([n.effective_capability
                              for n in cluster.nodes]))
    rebuild = (UPDATE_VERTEX_FLOPS * touched_v * g.feature_dim
               + UPDATE_EDGE_FLOPS * touched_e) / mean_cap
    sync = cluster.sync_cost if delta.is_structural else 0.0
    return UPDATE_BASE_S + collect + rebuild + sync


# ----------------------------------------------------------------------------
# Fault-recovery pricing (the node-level fault-tolerance tiers)
# ----------------------------------------------------------------------------

# Tier 1 — transient halo-exchange loss: every failed sync round costs the
# wasted round itself (one delta) plus an exponentially growing backoff
# before the retry, truncated by the attempt budget and the hard timeout.
RETRY_BACKOFF_BASE_S = 0.02
RETRY_BACKOFF_MULT = 2.0
RETRY_MAX_ATTEMPTS = 4
RETRY_TIMEOUT_S = 1.0

# Tier 3 — shard failover: fixed control overhead of the replan (evict +
# greedy re-place + placement re-pricing) plus re-uploading each moved
# vertex's feature row to its new fog over the LAN, plus the rebuild on the
# SURVIVING cluster's mean capability (degraded-capacity pricing), plus one
# quiescing sync round while the layout swaps.
FAILOVER_BASE_S = 0.05


def simulate_retry(losses: int, *, sync_cost: float = DEFAULT_SYNC_COST,
                   base: float = RETRY_BACKOFF_BASE_S,
                   mult: float = RETRY_BACKOFF_MULT,
                   max_attempts: int = RETRY_MAX_ATTEMPTS,
                   timeout: float = RETRY_TIMEOUT_S
                   ) -> Tuple[float, int, bool]:
    """Price recovering ``losses`` consecutive transient exchange losses.

    Attempt ``k`` (0-based) fails, costing the wasted sync round plus a
    ``base * mult**k`` backoff; after ``losses`` failed attempts the next
    retry succeeds (its cost is the normal sync already in the serving
    account). Returns ``(recovery_seconds, attempts_made, succeeded)`` —
    ``succeeded`` is False when the attempt budget or the timeout would be
    exceeded first (the caller escalates to the next recovery tier, paying
    the time spent so far). Fully deterministic.
    """
    losses = int(losses)
    if losses < 0:
        raise ValueError(f"losses must be >= 0, got {losses}")
    t = 0.0
    for k in range(losses):
        if k >= max_attempts:
            return t, k, False
        step = sync_cost + base * mult ** k
        if t + step > timeout + 1e-12:
            return t, k, False
        t += step
    return t, losses, True


def simulate_failover(cluster: FogCluster, moved_vertices: int,
                      feature_dim: Optional[int] = None) -> float:
    """Price one shard failover on the simulated serving clock.

    ``cluster`` is the SURVIVING cluster (the failover plan's — degraded
    capacity prices the rebuild, same threading rule as
    :func:`simulate_update`); ``moved_vertices`` how many vertices the
    crashed node held (each re-uploads one feature row and re-packs its
    shard entries). Occupies the Server pipeline's execution stage, like
    an update repair.
    """
    if feature_dim is None:
        feature_dim = cluster.feature_dim
    wire = moved_vertices * (feature_dim * 8.0 + PROTOCOL_BYTES_PER_VERTEX)
    collect = wire / NETWORKS[cluster.network]["lan"]
    mean_cap = float(np.mean([n.effective_capability
                              for n in cluster.nodes]))
    rebuild = UPDATE_VERTEX_FLOPS * moved_vertices * feature_dim / mean_cap
    return FAILOVER_BASE_S + collect + rebuild + cluster.sync_cost


def apply_load_trace(cluster: FogCluster, loads: Sequence[float]) -> None:
    for node, load in zip(cluster.nodes, loads):
        node.background_load = float(load)


def measured_exec_times(cluster: FogCluster, placement: Placement) -> np.ndarray:
    """T_real per fog under current background loads (online profiler input)."""
    out = np.zeros(len(cluster.nodes))
    for j, node in enumerate(cluster.nodes):
        mine = np.flatnonzero(placement.assignment == j)
        if mine.size:
            out[j] = (cluster.ground_truth_exec(node, mine)
                      + cluster.k_layers * cluster.sync_cost)
    return out
