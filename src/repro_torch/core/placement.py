"""Inference Execution Planner (IEP) — paper §III-C, Alg. 1.

Two-step heuristic for the NP-hard min-max placement problem P (Eq. 7):

  step 1  BGP min-cut partitioning (repro_torch.core.partition, METIS stand-in)
  step 2  partition->fog mapping as a Linear Bottleneck Assignment Problem
          (LBAP), solved exactly by threshold search + perfect-matching
          checks; binary search over the O(n^2) candidate thresholds gives
          the paper's O(n^3 log n).

Also implements the paper's comparison baselines: METIS+Random and
METIS+Greedy (§III-C "Discussion"), and the straw-man fog placement
(DistDGL-style: partitions mapped stochastically, §IV-A).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.api.registry import PLACEMENTS
from repro_torch.core.partition import bgp
from repro_torch.core.profiler import LatencyModel, cardinality_of
from repro_torch.gnn.graph import Graph


# ----------------------------------------------------------------------------
# Assignment solvers
# ----------------------------------------------------------------------------

def hungarian(cost: np.ndarray) -> np.ndarray:
    """Exact min-sum assignment (Munkres / Jonker-Volgenant shortest
    augmenting path, O(n^3)). Returns col[j] assigned to each row j... i.e.
    result[i] = column assigned to row i."""
    cost = np.asarray(cost, np.float64)
    n, m = cost.shape
    assert n == m, "square cost matrix required"
    INF = float("inf")
    u = np.zeros(n + 1)
    v = np.zeros(n + 1)
    p = np.zeros(n + 1, dtype=np.int64)   # p[j] = row matched to column j
    way = np.zeros(n + 1, dtype=np.int64)
    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = np.full(n + 1, INF)
        used = np.zeros(n + 1, dtype=bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            delta = INF
            j1 = -1
            for j in range(1, n + 1):
                if not used[j]:
                    cur = cost[i0 - 1, j - 1] - u[i0] - v[j]
                    if cur < minv[j]:
                        minv[j] = cur
                        way[j] = j0
                    if minv[j] < delta:
                        delta = minv[j]
                        j1 = j
            for j in range(n + 1):
                if used[j]:
                    u[p[j]] += delta
                    v[j] -= delta
                else:
                    minv[j] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    result = np.zeros(n, dtype=np.int64)
    for j in range(1, n + 1):
        result[p[j] - 1] = j - 1
    return result


def _kuhn_perfect_matching(adj: List[np.ndarray], n: int) -> Optional[np.ndarray]:
    """Kuhn's augmenting-path bipartite matching. adj[i] = candidate columns
    for row i. Returns match row->col or None if no perfect matching."""
    match_col = -np.ones(n, dtype=np.int64)

    def try_row(i: int, seen: np.ndarray) -> bool:
        for j in adj[i]:
            if not seen[j]:
                seen[j] = True
                if match_col[j] < 0 or try_row(int(match_col[j]), seen):
                    match_col[j] = i
                    return True
        return False

    for i in range(n):
        if not try_row(i, np.zeros(n, dtype=bool)):
            return None
    result = -np.ones(n, dtype=np.int64)
    for j in range(n):
        result[match_col[j]] = j
    return result


def lbap(cost: np.ndarray) -> np.ndarray:
    """Linear Bottleneck Assignment: minimize max_{i} cost[i, sigma(i)].

    Binary search over sorted unique costs for the smallest threshold tau
    admitting a perfect matching among edges with cost <= tau (paper's
    binary-search acceleration of Alg. 1 lines 7-16).
    """
    cost = np.asarray(cost, np.float64)
    n = cost.shape[0]
    thresholds = np.unique(cost)
    lo, hi = 0, len(thresholds) - 1
    best = None
    while lo <= hi:
        mid = (lo + hi) // 2
        tau = thresholds[mid]
        adj = [np.flatnonzero(cost[i] <= tau) for i in range(n)]
        m = _kuhn_perfect_matching(adj, n)
        if m is not None:
            best = m
            hi = mid - 1
        else:
            lo = mid + 1
    assert best is not None, "complete bipartite graph always matches"
    return best


def lbap_threshold_descending(cost: np.ndarray) -> np.ndarray:
    """Literal Alg. 1 (priority queue of descending thresholds + Hungarian
    feasibility) — kept for fidelity tests against the binary-search path."""
    cost = np.asarray(cost, np.float64)
    n = cost.shape[0]
    thresholds = np.unique(cost)[::-1]  # descending
    best = None
    for tau in thresholds:
        adj = [np.flatnonzero(cost[i] <= tau) for i in range(n)]
        m = _kuhn_perfect_matching(adj, n)
        if m is None:
            break
        best = m
    assert best is not None
    return best


# ----------------------------------------------------------------------------
# IEP
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class FogSpec:
    """Static per-fog serving configuration (metadata registration)."""
    name: str
    bandwidth_bytes_per_s: float          # b_j, allocated collection bandwidth
    latency_model: LatencyModel           # omega_j


@dataclasses.dataclass
class Placement:
    """pi: vertex -> fog assignment plus planning diagnostics."""
    assignment: np.ndarray                # int64[|V|] fog index per vertex
    partition_of: np.ndarray              # int64[|V|] partition index (pre-map)
    mapping: np.ndarray                   # partition k -> fog mapping[k]
    est_collect: np.ndarray               # t_colle per fog (Eq. 5)
    est_exec: np.ndarray                  # t_exec per fog (Eq. 6)

    @property
    def est_total(self) -> np.ndarray:
        return self.est_collect + self.est_exec

    @property
    def est_makespan(self) -> float:
        return float(self.est_total.max())


def pair_cost(g: Graph, part_vertices: np.ndarray, fog: FogSpec,
              bytes_per_vertex: float, k_layers: int,
              sync_cost: float) -> float:
    """Eq. (8): <P_k, f_j> = |P_k| phi / b_j + omega_j(P_k) + K delta."""
    t_colle = len(part_vertices) * bytes_per_vertex / fog.bandwidth_bytes_per_s
    card = cardinality_of(g, part_vertices)
    return t_colle + fog.latency_model.predict(card) + k_layers * sync_cost


def _build_cost_matrix(g: Graph, parts: List[np.ndarray],
                       fogs: Sequence[FogSpec], bytes_per_vertex: float,
                       k_layers: int, sync_cost: float) -> np.ndarray:
    n = len(fogs)
    cost = np.zeros((n, n))
    cards = [cardinality_of(g, p) for p in parts]
    for k in range(n):
        for j, fog in enumerate(fogs):
            t_colle = (len(parts[k]) * bytes_per_vertex
                       / fog.bandwidth_bytes_per_s)
            cost[k, j] = (t_colle + fog.latency_model.predict(cards[k])
                          + k_layers * sync_cost)
    return cost


def _finish(g: Graph, parts: List[np.ndarray], mapping: np.ndarray,
            fogs: Sequence[FogSpec], bytes_per_vertex: float,
            k_layers: int, sync_cost: float,
            partition_assignment: np.ndarray) -> Placement:
    n = len(fogs)
    assignment = np.zeros(g.num_vertices, dtype=np.int64)
    est_collect = np.zeros(n)
    est_exec = np.zeros(n)
    for k, part in enumerate(parts):
        j = int(mapping[k])
        assignment[part] = j
        est_collect[j] = (len(part) * bytes_per_vertex
                          / fogs[j].bandwidth_bytes_per_s)
        est_exec[j] = (fogs[j].latency_model.predict(cardinality_of(g, part))
                       + k_layers * sync_cost)
    return Placement(assignment=assignment,
                     partition_of=partition_assignment,
                     mapping=np.asarray(mapping, np.int64),
                     est_collect=est_collect, est_exec=est_exec)


def match_bottleneck(cost: np.ndarray, seed: int = 0) -> np.ndarray:
    """IEP's partition->fog matcher: exact LBAP bottleneck assignment."""
    return lbap(cost)


def match_greedy(cost: np.ndarray, seed: int = 0) -> np.ndarray:
    """METIS+Greedy baseline: rows pick their cheapest unused fog in order."""
    n = cost.shape[0]
    mapping = -np.ones(n, dtype=np.int64)
    used = np.zeros(n, dtype=bool)
    for k in range(n):
        order = np.argsort(cost[k])
        j = next(int(jj) for jj in order if not used[jj])
        mapping[k] = j
        used[j] = True
    return mapping


def match_random(cost: np.ndarray, seed: int = 0) -> np.ndarray:
    """METIS+Random / straw-man: stochastic partition->fog mapping."""
    return np.random.default_rng(seed).permutation(cost.shape[0])


# canonical registry key -> (matcher, heterogeneity-aware partition sizing)
_STRATEGIES = {
    "iep": (match_bottleneck, True),
    "metis+greedy": (match_greedy, False),
    "random": (match_random, False),
}


def iep_place(g: Graph, fogs: Sequence[FogSpec], *,
              bytes_per_vertex: Optional[float] = None,
              k_layers: int = 2, sync_cost: float = 5e-3,
              seed: int = 0, strategy: str = "iep",
              capacity_weights: Optional[np.ndarray] = None,
              partitioner: Optional[Callable] = None) -> Placement:
    """Full IEP data placement (Alg. 1) and its baselines.

    strategy:
      "iep"           BGP + LBAP bottleneck mapping    (the paper's algorithm)
      "metis+greedy"  BGP + greedy min-cost mapping    (METIS+Greedy baseline;
                      "greedy" is accepted as an alias)
      "random"        BGP + stochastic mapping         (METIS+Random/straw-man)

    ``partitioner`` overrides the BGP solver (same signature as
    ``partition.bgp``); any ``PARTITIONERS`` registry entry qualifies.
    """
    n = len(fogs)
    strategy = PLACEMENTS.canonical(strategy)  # aliases live in the registry
    if strategy not in _STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; "
                         f"available: {', '.join(sorted(_STRATEGIES))}")
    matcher, het_sizing = _STRATEGIES[strategy]
    if partitioner is None:
        partitioner = bgp
    if bytes_per_vertex is None:
        bytes_per_vertex = g.feature_dim * 8.0  # float64 features, Q=64
    if capacity_weights is None and het_sizing:
        # Heterogeneity-aware partition sizing (paper Fig. 13b: the type-C
        # fog holds the most vertices): equal-size partitions cannot
        # balance a heterogeneous cluster no matter how they are mapped,
        # so IEP sizes partitions by profiled total per-vertex cost. The
        # baselines (METIS+Random / METIS+Greedy) keep straw-man sizing.
        capacity_weights = capability_weights(fogs, g, bytes_per_vertex)
    part_assign = partitioner(g, n, weights=capacity_weights, seed=seed)
    parts = [np.flatnonzero(part_assign == k) for k in range(n)]
    cost = _build_cost_matrix(g, parts, fogs, bytes_per_vertex,
                              k_layers, sync_cost)
    mapping = matcher(cost, seed=seed)
    return _finish(g, parts, mapping, fogs, bytes_per_vertex, k_layers,
                   sync_cost, part_assign)


@dataclasses.dataclass(frozen=True)
class PlacementStrategy:
    """A PLACEMENTS registry entry: one partition->fog mapping policy.

    ``place`` runs the full vertex placement (step 2 of the paper's
    workflow); ``match`` exposes the bare cost-matrix matcher so non-graph
    substrates (e.g. the transformer pod scheduler in ``launch.serve``)
    reuse the same policy on their own cost models.
    """
    name: str
    matcher: Callable[..., np.ndarray]

    def place(self, g: Graph, fogs: Sequence[FogSpec], **kw) -> Placement:
        return iep_place(g, fogs, strategy=self.name, **kw)

    def match(self, cost: np.ndarray, seed: int = 0) -> np.ndarray:
        return self.matcher(np.asarray(cost, np.float64), seed=seed)


for _name, (_matcher, _) in _STRATEGIES.items():
    PLACEMENTS.register(_name, PlacementStrategy(_name, _matcher))


def capability_weights(fogs: Sequence[FogSpec], g: Graph,
                       bytes_per_vertex: float = 0.0) -> np.ndarray:
    """Capacity fractions inversely proportional to each fog's *total*
    per-vertex serving cost (collection + execution, Eq. 8's two terms).

    This sizes partitions so that collect_j + exec_j equalizes across the
    heterogeneous cluster (paper Fig. 13b shows the type-C fog holding the
    most vertices). Sizing by compute speed alone would overload a fast
    fog's uplink when collection is not compressed."""
    n = len(fogs)
    probe_v = max(2, g.num_vertices // n)
    probe = (probe_v, max(2, g.num_edges // n))
    cost = []
    for f in fogs:
        exec_pv = f.latency_model.predict(probe) / probe_v
        coll_pv = bytes_per_vertex / f.bandwidth_bytes_per_s
        cost.append(exec_pv + coll_pv)
    speed = 1.0 / np.maximum(np.asarray(cost), 1e-12)
    return speed / speed.sum()
