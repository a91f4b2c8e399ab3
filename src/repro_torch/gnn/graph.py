"""Graph containers and structural utilities.

Host-side representation is numpy (partitioning, placement, compression all
operate on the host, as in the paper's metadata server); device-side compute
uses COO edge lists (a fixed-order segment sum) or the block-CSR SpMM
kernels built from them.

Terminology follows the paper: *vertex* = graph vertex, *node* = fog server.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Graph:
    """An undirected graph stored as COO + CSR, with per-vertex features.

    Attributes:
      num_vertices: |V|.
      senders / receivers: int32[E] directed edge endpoints. For undirected
        graphs both (u,v) and (v,u) appear, so E = 2 * |undirected edges|.
      indptr / indices: CSR over the same directed edges (row = receiver,
        columns = its in-neighbors), used by the block-CSR aggregation kernel
        and by host-side partitioning.
      features: float32[|V|, F] vertex features (h^(0)).
      labels: optional int32[|V|] class labels.
      positions: optional float32[|V|, 2] spatial coordinates (PeMS case study).
    """

    num_vertices: int
    senders: np.ndarray
    receivers: np.ndarray
    indptr: np.ndarray
    indices: np.ndarray
    features: np.ndarray
    labels: Optional[np.ndarray] = None
    positions: Optional[np.ndarray] = None

    @property
    def num_edges(self) -> int:
        return int(self.senders.shape[0])

    @property
    def feature_dim(self) -> int:
        return int(self.features.shape[-1])

    @property
    def degrees(self) -> np.ndarray:
        """In-degree per vertex (== out-degree for undirected graphs)."""
        return np.diff(self.indptr).astype(np.int32)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    def validate(self) -> None:
        assert self.senders.shape == self.receivers.shape
        assert self.indptr.shape == (self.num_vertices + 1,)
        assert self.indptr[-1] == self.num_edges
        assert self.features.shape[0] == self.num_vertices
        if self.num_edges:
            assert int(self.senders.max()) < self.num_vertices
            assert int(self.receivers.max()) < self.num_vertices


def from_edge_list(num_vertices: int,
                   edges: np.ndarray,
                   features: np.ndarray,
                   labels: Optional[np.ndarray] = None,
                   positions: Optional[np.ndarray] = None,
                   undirected: bool = True) -> Graph:
    """Build a Graph from an [E0, 2] array of (u, v) pairs.

    Self loops and duplicate edges are removed; if ``undirected`` both
    directions are materialized.
    """
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    # Drop self loops.
    edges = edges[edges[:, 0] != edges[:, 1]]
    if undirected:
        edges = np.concatenate([edges, edges[:, ::-1]], axis=0)
    # Dedup.
    if edges.shape[0]:
        key = edges[:, 0] * num_vertices + edges[:, 1]
        _, uniq = np.unique(key, return_index=True)
        edges = edges[np.sort(uniq)]
    senders = edges[:, 0].astype(np.int32)
    receivers = edges[:, 1].astype(np.int32)
    indptr, indices = _coo_to_csr(num_vertices, receivers, senders)
    g = Graph(
        num_vertices=num_vertices,
        senders=senders,
        receivers=receivers,
        indptr=indptr,
        indices=indices,
        features=np.asarray(features, dtype=np.float32),
        labels=None if labels is None else np.asarray(labels, dtype=np.int32),
        positions=positions,
    )
    g.validate()
    return g


def _coo_to_csr(num_vertices: int, rows: np.ndarray, cols: np.ndarray):
    """CSR where row r lists the senders of edges received by r (in-neighbors)."""
    order = np.argsort(rows, kind="stable")
    sorted_rows = rows[order]
    sorted_cols = cols[order].astype(np.int32)
    counts = np.bincount(sorted_rows, minlength=num_vertices)
    indptr = np.zeros(num_vertices + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, sorted_cols


def subgraph(g: Graph, vertex_ids: np.ndarray) -> Graph:
    """Induced subgraph on ``vertex_ids`` (relabeled 0..len-1)."""
    vertex_ids = np.asarray(vertex_ids, dtype=np.int64)
    remap = -np.ones(g.num_vertices, dtype=np.int64)
    remap[vertex_ids] = np.arange(len(vertex_ids))
    keep = (remap[g.senders] >= 0) & (remap[g.receivers] >= 0)
    edges = np.stack(
        [remap[g.senders[keep]], remap[g.receivers[keep]]], axis=1)
    return from_edge_list(
        len(vertex_ids), edges,
        g.features[vertex_ids],
        None if g.labels is None else g.labels[vertex_ids],
        None if g.positions is None else g.positions[vertex_ids],
        undirected=False)  # both directions already present


def neighbor_count(g: Graph, vertex_ids: np.ndarray) -> int:
    """|N_V|: number of distinct one-hop neighbors of a vertex set (the
    cardinality's second axis in the paper's profiler, §III-B)."""
    vertex_ids = np.asarray(vertex_ids)
    in_set = np.zeros(g.num_vertices, dtype=bool)
    in_set[vertex_ids] = True
    touching = in_set[g.receivers]  # edges arriving at the set
    nbrs = np.unique(g.senders[touching])
    return int(np.sum(~in_set[nbrs]))


def edge_cut(g: Graph, assignment: np.ndarray) -> int:
    """Number of directed edges crossing partitions under ``assignment``."""
    return int(np.sum(assignment[g.senders] != assignment[g.receivers]))


def partition_boundary(g: Graph, assignment: np.ndarray, part: int) -> np.ndarray:
    """Vertices in ``part`` that have at least one neighbor outside it."""
    mine = assignment == part
    cross = mine[g.receivers] & ~mine[g.senders]
    return np.unique(g.receivers[cross])


def halo_vertices(g: Graph, assignment: np.ndarray, part: int) -> np.ndarray:
    """Remote vertices whose features ``part`` must pull each BSP layer."""
    mine = assignment == part
    incoming = mine[g.receivers] & ~mine[g.senders]
    return np.unique(g.senders[incoming])


def degree_histogram(g: Graph) -> np.ndarray:
    return np.bincount(g.degrees)


def degree_cdf(g: Graph):
    """Empirical CDF F_D(d) of the degree distribution (Thm 2)."""
    hist = degree_histogram(g).astype(np.float64)
    cdf = np.cumsum(hist) / max(1.0, hist.sum())

    def F(d):
        d = np.asarray(d, dtype=np.int64)
        return np.where(d < 0, 0.0,
                        cdf[np.minimum(d, len(cdf) - 1)])

    return F


def pad_edges(senders: np.ndarray, receivers: np.ndarray, target: int,
              pad_vertex: int):
    """Pad COO edge lists to ``target`` edges pointing at a sink vertex.

    Padding edges use sender==receiver==pad_vertex with mask 0 so that
    segment-sum aggregation ignores them (pad_vertex row is discarded).
    """
    e = senders.shape[0]
    assert e <= target, (e, target)
    pad = target - e
    mask = np.concatenate([np.ones(e, np.float32), np.zeros(pad, np.float32)])
    s = np.concatenate([senders, np.full(pad, pad_vertex, senders.dtype)])
    r = np.concatenate([receivers, np.full(pad, pad_vertex, receivers.dtype)])
    return s, r, mask
