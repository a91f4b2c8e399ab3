"""The benchmark's graphs: a frozen copy of the Table III generator.

A copy of ``repro_torch.gnn.datasets.load`` (and of ``gnn.graph``'s edge
list clean-up), kept here so that the yardstick does not move when the
program's dataset code does. ``bench/tests`` holds it equal to the port's
``load`` at small scale. Returns plain numpy arrays; ``run.py`` wraps them
in the port's ``Graph``, the reference reads them directly.

A graph is cached as ``.npz`` under the benchmark's cache directory (inside
the checkout), so only the first run of a cell in a checkout generates it.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np

# Paper Table III statistics (a copy of the port's ``datasets.TABLE_III``).
TABLE_III = {
    "siot": dict(vertices=16216, edges=146117, feature=52, labels=2),
    "yelp": dict(vertices=10000, edges=15683, feature=100, labels=2),
    "pems": dict(vertices=307, edges=340, feature=3, labels=0),
    "rmat-20k": dict(vertices=20_000, edges=199_000, feature=32, labels=8),
    "rmat-40k": dict(vertices=40_000, edges=799_000, feature=32, labels=8),
    "rmat-60k": dict(vertices=60_000, edges=1_790_000, feature=32, labels=8),
    "rmat-80k": dict(vertices=80_000, edges=3_190_000, feature=32, labels=8),
    "rmat-100k": dict(vertices=100_000, edges=4_990_000, feature=32,
                      labels=8),
}

KEYS = ("senders", "receivers", "indptr", "indices", "features", "labels",
        "positions")


def rmat_edges(num_vertices, num_edges, rng, a=0.57, b=0.19, c=0.19):
    scale = int(np.ceil(np.log2(max(2, num_vertices))))
    probs = np.array([a, b, c, 1.0 - a - b - c])
    rows = np.zeros(num_edges, dtype=np.int64)
    cols = np.zeros(num_edges, dtype=np.int64)
    for level in range(scale):
        q = rng.choice(4, size=num_edges, p=probs)
        half = 1 << (scale - level - 1)
        rows += np.where((q == 2) | (q == 3), half, 0)
        cols += np.where((q == 1) | (q == 3), half, 0)
    keep = (rows < num_vertices) & (cols < num_vertices) & (rows != cols)
    return np.stack([rows[keep], cols[keep]], axis=1)


def _community_labels(num_vertices, edges, num_classes, rng, iters=8):
    labels = rng.integers(0, num_classes, size=num_vertices)
    if edges.shape[0] == 0 or num_classes <= 1:
        return labels.astype(np.int32)
    s, r = edges[:, 0], edges[:, 1]
    for _ in range(iters):
        votes = np.zeros((num_vertices, num_classes), dtype=np.int64)
        np.add.at(votes, r, np.eye(num_classes, dtype=np.int64)[labels[s]])
        np.add.at(votes, s, np.eye(num_classes, dtype=np.int64)[labels[r]])
        votes[np.arange(num_vertices), labels] += 1
        labels = votes.argmax(axis=1)
    return labels.astype(np.int32)


def _structural_features(num_vertices, edges, dim, rng, sparse_onehot,
                         labels=None):
    if sparse_onehot:
        blocks = max(2, dim // 13)
        feats = np.zeros((num_vertices, dim), dtype=np.float32)
        base = 0
        per = dim // blocks
        for b in range(blocks):
            width = per if b < blocks - 1 else dim - base
            if labels is not None and b == 0:
                cat = (labels * width // max(1, labels.max() + 1)) % width
                noise = rng.integers(0, width, size=num_vertices)
                flip = rng.random(num_vertices) < 0.15
                cat = np.where(flip, noise, cat)
            else:
                cat = rng.integers(0, width, size=num_vertices)
            feats[np.arange(num_vertices), base + cat] = 1.0
            base += width
        return feats
    x = rng.normal(size=(num_vertices, dim)).astype(np.float32)
    if labels is not None:
        centers = rng.normal(size=(int(labels.max()) + 1, dim)
                             ).astype(np.float32)
        x = 0.7 * centers[labels] + 0.5 * x
    if edges.shape[0]:
        s, r = edges[:, 0], edges[:, 1]
        deg = np.bincount(r, minlength=num_vertices) + 1.0
        for _ in range(2):
            agg = np.zeros_like(x)
            np.add.at(agg, r, x[s])
            x = (x + agg / deg[:, None]).astype(np.float32) * 0.5
    return x


def _edge_list(num_vertices, edges):
    """Self loops dropped, both directions, duplicates removed (first
    occurrence kept, in order); CSR over receivers."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    edges = edges[edges[:, 0] != edges[:, 1]]
    edges = np.concatenate([edges, edges[:, ::-1]], axis=0)
    if edges.shape[0]:
        key = edges[:, 0] * num_vertices + edges[:, 1]
        _, uniq = np.unique(key, return_index=True)
        edges = edges[np.sort(uniq)]
    senders = edges[:, 0].astype(np.int32)
    receivers = edges[:, 1].astype(np.int32)
    order = np.argsort(receivers, kind="stable")
    counts = np.bincount(receivers[order], minlength=num_vertices)
    indptr = np.zeros(num_vertices + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return senders, receivers, indptr, senders[order].astype(np.int32)


def generate(name: str, scale: float = 1.0, seed: int = 0) -> dict:
    """Table III graph ``name`` at ``scale`` -> dict of numpy arrays
    (``num_vertices`` and ``KEYS``)."""
    stats = TABLE_III[name]
    rng = np.random.default_rng(seed)
    n = max(8, int(stats["vertices"] * scale))
    e = max(n, int(stats["edges"] * scale))
    edges = rmat_edges(n, int(e * 1.35), rng)[:e]
    nc = max(1, stats["labels"])
    labels = _community_labels(n, edges, nc, rng) if stats["labels"] else None
    feats = _structural_features(n, edges, stats["feature"], rng,
                                 name == "siot", labels)
    positions = rng.uniform(0, 100, size=(n, 2)).astype(np.float32)
    senders, receivers, indptr, indices = _edge_list(n, edges)
    return {"num_vertices": n, "senders": senders, "receivers": receivers,
            "indptr": indptr, "indices": indices,
            "features": np.asarray(feats, np.float32),
            "labels": (None if labels is None
                       else np.asarray(labels, np.int32)),
            "positions": positions}


def load(name: str, scale: float, seed: int, cache_dir: Path) -> dict:
    """``generate`` through an ``.npz`` cache in ``cache_dir``."""
    path = Path(cache_dir) / f"{name}-x{scale:g}-s{seed}.npz"
    if path.exists():
        with np.load(path) as z:
            out = {k: (z[k] if k in z.files else None) for k in KEYS}
            out["num_vertices"] = int(z["num_vertices"])
        return out
    g = generate(name, scale, seed)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp.npz")
    np.savez(tmp, num_vertices=g["num_vertices"],
             **{k: g[k] for k in KEYS if g[k] is not None})
    os.replace(tmp, path)
    return g
