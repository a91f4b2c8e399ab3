"""Dataset builders mirroring the paper's Table III.

Datasets are never downloaded, so we synthesize structurally faithful
stand-ins for the three real-world datasets (SIoT, Yelp, PeMS) and implement
the RMAT series exactly as the paper describes (Appendix D): R-MAT topology
at SIoT's density (0.11%), Node2Vec-like 32-d features (we use spectral-ish
random projections of the adjacency), community-derived 8-class labels.

Every builder accepts ``scale`` to shrink |V| proportionally for CI-speed
tests while preserving degree-distribution shape.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.gnn.graph import Graph, from_edge_list

# Paper Table III statistics.
TABLE_III = {
    "siot": dict(vertices=16216, edges=146117, feature=52, labels=2, duration=1),
    "yelp": dict(vertices=10000, edges=15683, feature=100, labels=2, duration=1),
    "pems": dict(vertices=307, edges=340, feature=3, labels=0, duration=12),
    "rmat-20k": dict(vertices=20_000, edges=199_000, feature=32, labels=8, duration=1),
    "rmat-40k": dict(vertices=40_000, edges=799_000, feature=32, labels=8, duration=1),
    "rmat-60k": dict(vertices=60_000, edges=1_790_000, feature=32, labels=8, duration=1),
    "rmat-80k": dict(vertices=80_000, edges=3_190_000, feature=32, labels=8, duration=1),
    "rmat-100k": dict(vertices=100_000, edges=4_990_000, feature=32, labels=8, duration=1),
}


def rmat_edges(num_vertices: int, num_edges: int, rng: np.random.Generator,
               a: float = 0.57, b: float = 0.19, c: float = 0.19) -> np.ndarray:
    """R-MAT recursive generator [Chakrabarti et al., SDM'04]."""
    scale = int(np.ceil(np.log2(max(2, num_vertices))))
    n = num_edges
    # Vectorized: for each of `scale` levels draw a quadrant per edge.
    probs = np.array([a, b, c, 1.0 - a - b - c])
    rows = np.zeros(n, dtype=np.int64)
    cols = np.zeros(n, dtype=np.int64)
    for level in range(scale):
        q = rng.choice(4, size=n, p=probs)
        half = 1 << (scale - level - 1)
        rows += np.where((q == 2) | (q == 3), half, 0)
        cols += np.where((q == 1) | (q == 3), half, 0)
    keep = (rows < num_vertices) & (cols < num_vertices) & (rows != cols)
    return np.stack([rows[keep], cols[keep]], axis=1)


def _community_labels(num_vertices: int, edges: np.ndarray, num_classes: int,
                      rng: np.random.Generator, iters: int = 8) -> np.ndarray:
    """Cheap label propagation to derive community-structured labels."""
    labels = rng.integers(0, num_classes, size=num_vertices)
    if edges.shape[0] == 0 or num_classes <= 1:
        return labels.astype(np.int32)
    s, r = edges[:, 0], edges[:, 1]
    for _ in range(iters):
        votes = np.zeros((num_vertices, num_classes), dtype=np.int64)
        np.add.at(votes, r, np.eye(num_classes, dtype=np.int64)[labels[s]])
        np.add.at(votes, s, np.eye(num_classes, dtype=np.int64)[labels[r]])
        # Keep own vote to stabilise.
        votes[np.arange(num_vertices), labels] += 1
        labels = votes.argmax(axis=1)
    return labels.astype(np.int32)


def _structural_features(num_vertices: int, edges: np.ndarray, dim: int,
                         rng: np.random.Generator, sparse_onehot: bool,
                         labels: Optional[np.ndarray] = None) -> np.ndarray:
    """Features with real signal: a few propagation rounds of random
    projections (Node2Vec stand-in) or sparse one-hot attribute blocks
    (SIoT-style: device type/brand/mobility one-hots)."""
    if sparse_onehot:
        # SIoT: categorical one-hot blocks -> very sparse, highly compressible.
        blocks = max(2, dim // 13)
        feats = np.zeros((num_vertices, dim), dtype=np.float32)
        base = 0
        per = dim // blocks
        cat = None
        for b in range(blocks):
            width = per if b < blocks - 1 else dim - base
            if labels is not None and b == 0:
                # First block correlates with the label so GNNs can learn.
                cat = (labels * width // max(1, labels.max() + 1)) % width
                noise = rng.integers(0, width, size=num_vertices)
                flip = rng.random(num_vertices) < 0.15
                cat = np.where(flip, noise, cat)
            else:
                cat = rng.integers(0, width, size=num_vertices)
            feats[np.arange(num_vertices), base + cat] = 1.0
            base += width
        return feats
    # Dense embedding-ish features (Yelp word2vec / RMAT node2vec stand-in):
    x = rng.normal(size=(num_vertices, dim)).astype(np.float32)
    if labels is not None:
        centers = rng.normal(size=(int(labels.max()) + 1, dim)).astype(np.float32)
        x = 0.7 * centers[labels] + 0.5 * x
    if edges.shape[0]:
        s, r = edges[:, 0], edges[:, 1]
        deg = np.bincount(r, minlength=num_vertices) + 1.0
        for _ in range(2):  # smooth over the graph -> structure-aware
            agg = np.zeros_like(x)
            np.add.at(agg, r, x[s])
            x = (x + agg / deg[:, None]).astype(np.float32) * 0.5
    return x


def _build(name: str, stats: dict, scale: float, seed: int,
           sparse_onehot: bool) -> Graph:
    rng = np.random.default_rng(seed)
    n = max(8, int(stats["vertices"] * scale))
    e = max(n, int(stats["edges"] * scale))
    edges = rmat_edges(n, int(e * 1.35), rng)[:e]
    nc = max(1, stats["labels"])
    labels = _community_labels(n, edges, nc, rng) if stats["labels"] else None
    feats = _structural_features(n, edges, stats["feature"], rng,
                                 sparse_onehot, labels)
    positions = rng.uniform(0, 100, size=(n, 2)).astype(np.float32)
    return from_edge_list(n, edges, feats, labels, positions)


def load(name: str, scale: float = 1.0, seed: int = 0) -> Graph:
    """Load a dataset by Table III name; ``scale`` shrinks it for tests."""
    name = name.lower()
    if name not in TABLE_III:
        raise KeyError(f"unknown dataset {name!r}; options: {sorted(TABLE_III)}")
    stats = TABLE_III[name]
    sparse_onehot = name == "siot"
    return _build(name, stats, scale, seed, sparse_onehot)


@dataclasses.dataclass
class TemporalGraph:
    """PeMS-style spatial-temporal data: a static sensor graph plus a
    [T_in, |V|, F] window of recent measurements and a [T_out, |V|] target
    (flow forecasting for the next hour at 5-min steps, §IV-C)."""
    graph: Graph
    history: np.ndarray  # [T_in, V, F]
    target: np.ndarray   # [T_out, V]


def load_pems_window(scale: float = 1.0, seed: int = 0, t_in: int = 12,
                     t_out: int = 12) -> TemporalGraph:
    g = load("pems", scale=scale, seed=seed)
    rng = np.random.default_rng(seed + 1)
    n = g.num_vertices
    t = np.arange(t_in + t_out)[:, None]
    phase = rng.uniform(0, 2 * np.pi, size=(1, n))
    daily = 60 + 40 * np.sin(2 * np.pi * t / 24 + phase)
    noise = rng.normal(scale=4.0, size=(t_in + t_out, n))
    flow = (daily + noise).astype(np.float32)           # total flow
    speed = (65 - 0.2 * flow + rng.normal(scale=2, size=flow.shape)).astype(np.float32)
    occ = (flow / 120.0).astype(np.float32)             # occupancy
    hist = np.stack([flow[:t_in], speed[:t_in], occ[:t_in]], axis=-1)
    return TemporalGraph(graph=g, history=hist, target=flow[t_in:])
