"""Which fog holds each vertex: a frozen copy of the port's planner.

On the 8-bit halo wire a message is rounded only where its source and its
receiver sit on different fogs, so the reference has to know the
vertex -> fog assignment, and it works it out again rather than read the
program's. This is a copy of the path ``Engine.compile`` takes for
``partitioner="bgp"``, ``placement="iep"`` and a cluster-spec string:
``simulation.make_cluster`` / ``FogCluster.fog_specs`` (the analytic
profiler of ``core.profiler``), ``placement.capability_weights``,
``partition.bgp`` and the LBAP matcher of ``placement.iep_place``.
``bench/tests`` holds it equal to the port's ``Plan.placement.assignment``.

The byte counts of the kernel rooflines read the same assignment.
"""
from __future__ import annotations

from typing import List

import numpy as np

NODE_CAPABILITY = {"A": 1.20e8, "B": 1.90e8, "C": 3.20e8}
NETWORK_LAN = {"4g": 5.00e6, "5g": 4.36e6, "wifi": 9.23e6}
BANDWIDTH_FACTOR = {"A": 0.6, "B": 1.0, "C": 1.5}
DEFAULT_SYNC_COST = 0.10
PROFILE_NOISE = 0.03


class _G:
    """The few graph properties the planner reads."""

    def __init__(self, g: dict):
        self.num_vertices = int(g["num_vertices"])
        self.senders = g["senders"]
        self.receivers = g["receivers"]
        self.indptr = g["indptr"]
        self.indices = g["indices"]
        self.num_edges = int(self.senders.shape[0])
        self.degrees = np.diff(self.indptr).astype(np.int32)
        self.feature_dim = int(g["features"].shape[1])


def parse_cluster_spec(spec: str) -> List[str]:
    out = []
    for term in spec.split("+"):
        term = term.strip()
        out.extend([term[-1].upper()] * int(term[:-1]))
    return out


def _neighbor_count(g: _G, vertex_ids: np.ndarray) -> int:
    in_set = np.zeros(g.num_vertices, dtype=bool)
    in_set[vertex_ids] = True
    nbrs = np.unique(g.senders[in_set[g.receivers]])
    return int(np.sum(~in_set[nbrs]))


def _cardinality(g: _G, vertex_ids) -> tuple:
    return (int(len(vertex_ids)), _neighbor_count(g, vertex_ids))


def _calibration_set(g: _G, seed: int, num_sizes=6, samples_per_size=20):
    rng = np.random.default_rng(seed)
    sizes = np.unique(np.linspace(
        max(1, g.num_vertices // (num_sizes * 4)),
        max(2, int(g.num_vertices * 0.9)), num_sizes).astype(np.int64))
    return [rng.choice(g.num_vertices, size=int(s), replace=False)
            for s in sizes for _ in range(samples_per_size)]


class _Model:
    def __init__(self, beta, eps):
        self.beta, self.eps = beta, eps

    def predict(self, c) -> float:
        return max(float(self.beta @ np.asarray(c, np.float64) + self.eps),
                   1e-9)


def _fit(cards, lats) -> _Model:
    x = np.asarray(cards, np.float64)
    design = np.concatenate([x, np.ones((len(x), 1))], axis=1)
    coef, *_ = np.linalg.lstsq(design, np.asarray(lats, np.float64),
                               rcond=None)
    return _Model(np.maximum(coef[:2], 0.0), max(float(coef[2]), 0.0))


def _exec_flops(card, f, hidden, k):
    v, nv = card
    return k * (2.0 * v * f * hidden + 8.0 * nv * f)


def fog_specs(g: _G, spec: str, network: str, hidden: int, k_layers: int,
              seed: int):
    """[(bandwidth, latency model)] of each fog, as ``fog_specs`` profiles
    them."""
    types = parse_cluster_spec(spec)
    n = len(types)
    base = NETWORK_LAN[network] * (1.0 + 0.25 * (n - 1)) / n
    mean_f = np.mean([BANDWIDTH_FACTOR[t] for t in types])
    f = g.feature_dim
    out = []
    for j, t in enumerate(types):
        rng = np.random.default_rng(seed + 1000 + j)
        cards = [_cardinality(g, ids) for ids in _calibration_set(g, seed + j)]
        lats = []
        for c in cards:
            tt = (_exec_flops(c, f, hidden, k_layers) / NODE_CAPABILITY[t]
                  + 1e-4)
            tt *= float(1.0 + rng.normal(scale=PROFILE_NOISE))
            lats.append(max(tt, 1e-9))
        out.append((base * BANDWIDTH_FACTOR[t] / mean_f, _fit(cards, lats)))
    return out


# -- partitioning (partition.bgp) -------------------------------------------

def _spread_seeds(g: _G, n: int) -> np.ndarray:
    deg = g.degrees
    seeds = [int(np.argmax(deg))]
    indptr, indices = g.indptr, g.indices
    big = np.iinfo(np.int32).max
    dist = np.full(g.num_vertices, big, np.int64)
    for _ in range(1, n):
        dist[:] = big
        frontier = np.array(seeds, dtype=np.int64)
        dist[frontier] = 0
        d = 0
        while frontier.size:
            d += 1
            nxt = []
            for v in frontier:
                nbrs = indices[indptr[v]:indptr[v + 1]]
                new = nbrs[dist[nbrs] > d]
                dist[new] = d
                nxt.append(new)
            frontier = (np.unique(np.concatenate(nxt)) if nxt
                        else np.array([], np.int64))
        unreached = dist == big
        if unreached.any():
            cand = np.flatnonzero(unreached)
            seeds.append(int(cand[np.argmax(deg[cand])]))
        else:
            seeds.append(int(np.argmax(np.where(np.isin(
                np.arange(g.num_vertices), seeds), -1, dist))))
    return np.array(seeds, dtype=np.int64)


def _region_grow(g: _G, n: int, capacity: np.ndarray) -> np.ndarray:
    indptr, indices = g.indptr, g.indices
    assignment = -np.ones(g.num_vertices, dtype=np.int64)
    sizes = np.zeros(n, dtype=np.int64)
    frontiers = []
    for p, s in enumerate(_spread_seeds(g, n)):
        if assignment[s] == -1:
            assignment[s] = p
            sizes[p] = 1
        frontiers.append(list(indices[indptr[s]:indptr[s + 1]]))
    active = set(range(n))
    while active:
        p = min(active, key=lambda q: sizes[q])
        fr = frontiers[p]
        grown = False
        while fr:
            v = fr.pop()
            if assignment[v] == -1 and sizes[p] < capacity[p]:
                assignment[v] = p
                sizes[p] += 1
                fr.extend(int(u) for u in indices[indptr[v]:indptr[v + 1]]
                          if assignment[u] == -1)
                grown = True
                break
        if not grown or sizes[p] >= capacity[p]:
            active.discard(p)
    for v in np.flatnonzero(assignment == -1):
        p = int(np.argmin(sizes / np.maximum(capacity, 1)))
        assignment[v] = p
        sizes[p] += 1
    return assignment


def _refine(g: _G, assignment, capacity, passes=4, tol=0.05):
    n = int(capacity.shape[0])
    indptr, indices = g.indptr, g.indices
    assignment = assignment.copy()
    sizes = np.bincount(assignment, minlength=n)
    hi = np.ceil(capacity * (1 + tol)).astype(np.int64)
    lo = np.floor(capacity * (1 - tol)).astype(np.int64)
    for _ in range(passes):
        boundary = np.unique(g.receivers[
            assignment[g.senders] != assignment[g.receivers]])
        moved = 0
        for v in boundary:
            pv = assignment[v]
            if sizes[pv] <= max(1, lo[pv]):
                continue
            nbrs = indices[indptr[v]:indptr[v + 1]]
            if nbrs.size == 0:
                continue
            counts = np.bincount(assignment[nbrs], minlength=n)
            internal = counts[pv]
            counts[pv] = -1
            best = int(np.argmax(counts))
            if counts[best] - internal > 0 and sizes[best] < hi[best]:
                assignment[v] = best
                sizes[pv] -= 1
                sizes[best] += 1
                moved += 1
        if moved == 0:
            break
    return assignment


def _bgp(g: _G, n: int, weights: np.ndarray) -> np.ndarray:
    weights = np.asarray(weights, np.float64)
    weights = weights / weights.sum()
    capacity = np.maximum(1, np.ceil(weights * g.num_vertices)
                          ).astype(np.int64)
    return _refine(g, _region_grow(g, n, capacity), capacity)


# -- partition -> fog matching (placement.lbap) ------------------------------

def _perfect_matching(adj, n):
    match_col = -np.ones(n, dtype=np.int64)

    def try_row(i, seen):
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


def _lbap(cost: np.ndarray) -> np.ndarray:
    n = cost.shape[0]
    thresholds = np.unique(cost)
    lo, hi, best = 0, len(thresholds) - 1, None
    while lo <= hi:
        mid = (lo + hi) // 2
        m = _perfect_matching(
            [np.flatnonzero(cost[i] <= thresholds[mid]) for i in range(n)], n)
        if m is not None:
            best, hi = m, mid - 1
        else:
            lo = mid + 1
    return best


def assignment(g: dict, cluster: str, network: str = "wifi",
               hidden: int = 64, k_layers: int = 2, seed: int = 0,
               sync_cost: float = DEFAULT_SYNC_COST) -> np.ndarray:
    """int64[V]: the fog of every vertex of graph ``g`` (``graphgen``'s
    arrays) under ``Engine(cluster=cluster, network=network,
    hidden=hidden, seed=seed)`` with the default planner, for a model of
    ``k_layers`` layers."""
    gg = _G(g)
    fogs = fog_specs(gg, cluster, network, hidden, k_layers, seed)
    n = len(fogs)
    bpv = gg.feature_dim * 8.0
    probe_v = max(2, gg.num_vertices // n)
    probe = (probe_v, max(2, gg.num_edges // n))
    cost = [m.predict(probe) / probe_v + bpv / bw for bw, m in fogs]
    speed = 1.0 / np.maximum(np.asarray(cost), 1e-12)
    part = _bgp(gg, n, speed / speed.sum())
    parts = [np.flatnonzero(part == k) for k in range(n)]
    cards = [_cardinality(gg, p) for p in parts]
    table = np.zeros((n, n))
    for k in range(n):
        for j, (bw, m) in enumerate(fogs):
            table[k, j] = (len(parts[k]) * bpv / bw + m.predict(cards[k])
                           + k_layers * sync_cost)
    mapping = _lbap(table)
    out = np.zeros(gg.num_vertices, dtype=np.int64)
    for k, p in enumerate(parts):
        out[p] = int(mapping[k])
    return out
