"""Balanced Graph Partitioning (BGP) — the METIS stand-in of IEP step 1.

The paper (Alg. 1 line 2) delegates min-cut balanced partitioning to a
pluggable BGP solver ("Fograph allows for altering appropriate solvers") and
uses METIS in its implementation. METIS is not available offline, so we
implement the classic two-phase recipe METIS itself uses at a single level:

  1. *Region growing*: seed n partitions from spread high-degree vertices and
     grow them breadth-first under a capacity bound — yields connected,
     vertex-balanced partitions.
  2. *Fiduccia–Mattheyses-style refinement*: passes of single-vertex moves
     with positive cut gain, subject to a balance tolerance.

The output contract matches the paper: n partitions, balanced in |V| (the
*statistical* balance the paper notes is insufficient on its own — IEP step 2
then maps partitions to heterogeneous fogs).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.api.registry import PARTITIONERS
from repro_torch.gnn.graph import Graph, edge_cut


def _adjacency(g: Graph):
    """CSR (indptr, indices) with row = vertex, cols = neighbors."""
    return g.indptr, g.indices


def _spread_seeds(g: Graph, n: int, rng: np.random.Generator) -> np.ndarray:
    """Pick n seeds: first = max degree, rest = BFS-farthest from chosen."""
    deg = g.degrees
    seeds = [int(np.argmax(deg))]
    indptr, indices = _adjacency(g)
    dist = np.full(g.num_vertices, np.iinfo(np.int32).max, np.int64)
    for _ in range(1, n):
        # Multi-source BFS from current seeds, take the farthest vertex.
        dist[:] = np.iinfo(np.int32).max
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
            frontier = np.unique(np.concatenate(nxt)) if nxt else np.array([], np.int64)
        unreached = dist == np.iinfo(np.int32).max
        if unreached.any():
            cand = np.flatnonzero(unreached)
            seeds.append(int(cand[np.argmax(deg[cand])]))
        else:
            seeds.append(int(np.argmax(np.where(np.isin(
                np.arange(g.num_vertices), seeds), -1, dist))))
    return np.array(seeds, dtype=np.int64)


def _region_grow(g: Graph, n: int, capacity: np.ndarray,
                 rng: np.random.Generator) -> np.ndarray:
    indptr, indices = _adjacency(g)
    assignment = -np.ones(g.num_vertices, dtype=np.int64)
    sizes = np.zeros(n, dtype=np.int64)
    seeds = _spread_seeds(g, n, rng)
    frontiers = []
    for p, s in enumerate(seeds):
        if assignment[s] == -1:
            assignment[s] = p
            sizes[p] = 1
        frontiers.append(list(indices[indptr[s]:indptr[s + 1]]))
    # Round-robin growth: smallest partition grows first.
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
    # Unassigned leftovers (disconnected components): fill smallest parts.
    for v in np.flatnonzero(assignment == -1):
        p = int(np.argmin(sizes / np.maximum(capacity, 1)))
        assignment[v] = p
        sizes[p] += 1
    return assignment


def _refine(g: Graph, assignment: np.ndarray, capacity: np.ndarray,
            passes: int = 4, tol: float = 0.05) -> np.ndarray:
    """FM-style boundary moves with positive gain under balance tolerance."""
    n = int(capacity.shape[0])
    indptr, indices = _adjacency(g)
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
            gain = counts[best] - internal
            if gain > 0 and sizes[best] < hi[best]:
                assignment[v] = best
                sizes[pv] -= 1
                sizes[best] += 1
                moved += 1
        if moved == 0:
            break
    return assignment


def bgp(g: Graph, n: int, weights: Optional[np.ndarray] = None,
        seed: int = 0, refine_passes: int = 4) -> np.ndarray:
    """Partition ``g`` into ``n`` parts; returns int64[|V|] assignment.

    ``weights`` (optional, len n, sums to ~1) sets per-partition capacity
    fractions — used by IEP re-planning when partitions should be sized to
    heterogeneous capability rather than uniformly.
    """
    if n <= 1:
        return np.zeros(g.num_vertices, dtype=np.int64)
    if n > g.num_vertices:
        raise ValueError(f"n={n} > |V|={g.num_vertices}")
    rng = np.random.default_rng(seed)
    if weights is None:
        weights = np.full(n, 1.0 / n)
    weights = np.asarray(weights, np.float64)
    weights = weights / weights.sum()
    capacity = np.maximum(1, np.ceil(weights * g.num_vertices)).astype(np.int64)
    assignment = _region_grow(g, n, capacity, rng)
    assignment = _refine(g, assignment, capacity, passes=refine_passes)
    return assignment


PARTITIONERS.register("bgp", bgp)


try:
    import pymetis as _pymetis
except ImportError:   # optional dependency; the registry entry is gated
    _pymetis = None


def metis(g: Graph, n: int, weights: Optional[np.ndarray] = None,
          seed: int = 0, **_ignored) -> np.ndarray:
    """Real METIS k-way partitioning via ``pymetis`` (optional dep).

    The paper's own implementation delegates BGP to METIS; this entry is
    registered only when ``pymetis`` is importable, so offline containers
    keep the pure-numpy ``bgp`` stand-in as the default.  ``weights``
    (heterogeneity-aware capacity fractions) are forwarded as METIS target
    partition weights when the installed pymetis supports ``tpwgts``;
    otherwise METIS balances uniformly and IEP's LBAP mapping still
    absorbs fog heterogeneity.  ``seed`` is accepted for signature parity
    but METIS's own randomization is not reseeded.
    """
    if _pymetis is None:
        raise ImportError("partitioner 'metis' needs the optional pymetis "
                          "package; pip install pymetis or use 'bgp'")
    if n <= 1:
        return np.zeros(g.num_vertices, dtype=np.int64)
    if n > g.num_vertices:
        raise ValueError(f"n={n} > |V|={g.num_vertices}")
    xadj = np.asarray(g.indptr, np.int64)
    adjncy = np.asarray(g.indices, np.int64)
    kw = {}
    if weights is not None:
        w = np.asarray(weights, np.float64)
        kw["tpwgts"] = list(w / w.sum())
    try:
        _, membership = _pymetis.part_graph(n, xadj=xadj, adjncy=adjncy,
                                            **kw)
    except TypeError:   # older pymetis without tpwgts support
        _, membership = _pymetis.part_graph(n, xadj=xadj, adjncy=adjncy)
    return np.asarray(membership, dtype=np.int64)


if _pymetis is not None:
    PARTITIONERS.register("metis", metis)


def partition_stats(g: Graph, assignment: np.ndarray) -> dict:
    n = int(assignment.max()) + 1
    sizes = np.bincount(assignment, minlength=n)
    return {
        "sizes": sizes,
        "edge_cut": edge_cut(g, assignment),
        "cut_fraction": edge_cut(g, assignment) / max(1, g.num_edges),
        "imbalance": float(sizes.max() / max(1.0, g.num_vertices / n)),
    }
