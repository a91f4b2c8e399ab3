"""Incremental repartitioning for mutating graphs (ROADMAP "Dynamic graphs").

Full ``Engine.compile`` re-runs the whole setup phase — fog profiling, BGP
partitioning, IEP mapping, and (on the kernel path) pre-blocking every
shard's adjacency — for any topology change.  This module implements the
repair path instead:

  1. ``mutate_graph``        apply a ``GraphDelta``
                             (``repro_torch.api.updates``) to a Graph,
                             producing the mutated graph and an old-id ->
                             new-id map.
  2. ``repair_assignment``   greedy min-cut-aware placement of new vertices
                             into the *existing* partitions: each new vertex
                             joins the partition holding the plurality of
                             its already-placed neighbors, subject to a
                             per-partition capacity bound (survivors never
                             move, so clean shards stay bit-identical).
  3. ``dirty_partitions``    conservative dirty-shard tracking: which
                             partitions' local / halo block-CSR operands the
                             delta invalidated.  Everything cheap (padded
                             COO buffers, masks, boundary packing) is always
                             recomputed; only the expensive per-shard
                             pre-blocking consults these sets (see
                             ``bsp.build_partitioned(prev=...)``).
  4. ``plan_delta``          fold a sequence of deltas over (graph,
                             assignment), unioning dirty sets — the
                             coalescing primitive behind the Session's
                             deferred-update policy.
  5. ``refresh_placement``   re-price the repaired placement with the
                             plan's already-profiled fog latency models, so
                             simulation / scheduler see honest numbers
                             without re-profiling.

The decision to *not* repair — imbalance or edge-cut degradation beyond a
threshold — is taken by ``Engine.apply_delta``, which falls back to the
full compile pipeline.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.api.updates import GraphDelta
from repro_torch.core.placement import FogSpec, Placement, _finish
from repro_torch.gnn.graph import Graph, edge_cut, from_edge_list


# ----------------------------------------------------------------------------
# Graph mutation
# ----------------------------------------------------------------------------

def mutate_graph(g: Graph, delta: GraphDelta) -> Tuple[Graph, np.ndarray]:
    """Apply ``delta`` to ``g``; returns ``(new_graph, vmap)``.

    ``vmap`` has ``g.num_vertices + delta.num_added_vertices`` entries
    mapping old ids (and the ``V+i`` aliases of new vertices) to new ids;
    removed vertices map to ``-1``.  Survivors keep their relative order
    and new vertices are appended, so untouched partitions keep identical
    slot layouts — the property dirty-shard reuse rests on.
    """
    delta.validate(g.num_vertices, g.feature_dim)
    v_old, k = g.num_vertices, delta.num_added_vertices
    keep = np.ones(v_old, bool)
    keep[delta.remove_vertices] = False
    n_kept = int(keep.sum())

    vmap = -np.ones(v_old + k, np.int64)
    vmap[:v_old][keep] = np.arange(n_kept)
    vmap[v_old:] = n_kept + np.arange(k)
    v_new = n_kept + k

    # Old directed edges, minus removals. Keeping the original order (old
    # edges first, additions appended) keeps untouched shards' edge
    # subsequences — hence their block-CSR operands — bit-identical.
    s, r = g.senders.astype(np.int64), g.receivers.astype(np.int64)
    alive = keep[s] & keep[r]
    if len(delta.remove_edges):
        eid = s * v_old + r
        rem = delta.remove_edges
        rem_keys = np.concatenate([rem[:, 0] * v_old + rem[:, 1],
                                   rem[:, 1] * v_old + rem[:, 0]])
        alive &= ~np.isin(eid, rem_keys)
    edges = np.stack([vmap[s[alive]], vmap[r[alive]]], axis=1)
    if len(delta.add_edges):
        add = vmap[delta.add_edges]
        # Vertex removal wins over edge addition within one delta: an
        # added edge touching a removed vertex is dropped, like every
        # other edge incident to it.
        add = add[(add >= 0).all(axis=1)]
        add = np.concatenate([add, add[:, ::-1]], axis=0)  # both directions
        edges = np.concatenate([edges, add], axis=0)

    feats = g.features[keep]
    if k:
        feats = np.concatenate([feats, delta.add_features], axis=0)
    if len(delta.feature_ids):
        feats = feats.copy()
        feats[vmap[delta.feature_ids]] = delta.feature_values

    labels = positions = None
    if g.labels is not None:
        new_l = (np.zeros(k, g.labels.dtype) if delta.add_labels is None
                 else np.asarray(delta.add_labels, g.labels.dtype))
        labels = np.concatenate([g.labels[keep], new_l])
    if g.positions is not None:
        new_p = (np.zeros((k,) + g.positions.shape[1:], g.positions.dtype)
                 if delta.add_positions is None
                 else np.asarray(delta.add_positions, g.positions.dtype))
        positions = np.concatenate([g.positions[keep], new_p], axis=0)

    # from_edge_list dedups with first-occurrence order and drops self
    # loops; both directions are already present, so undirected=False.
    g_new = from_edge_list(v_new, edges, feats, labels, positions,
                           undirected=False)
    return g_new, vmap


# ----------------------------------------------------------------------------
# Localized partition repair
# ----------------------------------------------------------------------------

def repair_assignment(g_new: Graph, assignment: np.ndarray, n: int, *,
                      capacity: Optional[np.ndarray] = None,
                      tol: float = 0.10) -> np.ndarray:
    """Greedy min-cut-aware placement of unassigned vertices.

    ``assignment`` is int64[|V_new|] with ``-1`` marking new vertices;
    survivors keep their partition.  Each new vertex (in id order — new
    vertices may neighbor each other) joins the partition that already
    holds most of its neighbors, provided that partition is below
    ``capacity * (1 + tol)``; vertices with no placed neighbors, or whose
    plurality partition is full, go to the least-loaded partition relative
    to capacity.  ``capacity`` defaults to the current partition sizes
    scaled to the new vertex count (preserving IEP's heterogeneity-aware
    sizing), with a uniform floor for empty partitions.
    """
    assignment = np.asarray(assignment, np.int64).copy()
    new_ids = np.flatnonzero(assignment < 0)
    if new_ids.size == 0:
        return assignment
    sizes = np.bincount(assignment[assignment >= 0], minlength=n).astype(
        np.float64)
    if capacity is None:
        frac = (sizes + 1.0) / (sizes + 1.0).sum()
        capacity = frac * g_new.num_vertices
    cap_hi = np.maximum(np.asarray(capacity, np.float64) * (1.0 + tol), 1.0)
    indptr, indices = g_new.indptr, g_new.indices
    for v in new_ids:
        nbr_parts = assignment[indices[indptr[v]:indptr[v + 1]]]
        nbr_parts = nbr_parts[nbr_parts >= 0]
        p = -1
        if nbr_parts.size:
            counts = np.bincount(nbr_parts, minlength=n).astype(np.float64)
            counts[sizes >= cap_hi] = -1.0   # full partitions ineligible
            if counts.max() > 0:
                p = int(np.argmax(counts))
        if p < 0:
            p = int(np.argmin(sizes / np.maximum(cap_hi, 1e-12)))
        assignment[v] = p
        sizes[p] += 1
    return assignment


def imbalance_of(assignment: np.ndarray, n: int) -> float:
    """max partition size over the uniform share (1.0 = perfectly even)."""
    sizes = np.bincount(assignment, minlength=n)
    return float(sizes.max() / max(1.0, len(assignment) / n))


def evacuate_assignment(assignment: np.ndarray, keep: Sequence[int],
                        n_old: int) -> np.ndarray:
    """Renumber an assignment onto the surviving partitions.

    ``keep`` lists the surviving old partition indices in their new
    order; every vertex on a surviving partition maps to that
    partition's new index (``0 .. len(keep)-1``), every vertex on an
    evicted partition becomes ``-1`` — exactly the shape
    :func:`repair_assignment` re-places. This is the shard-failover
    front half: evacuate, then repair onto the survivors.
    """
    keep = np.asarray(list(keep), np.int64)
    if keep.size == 0:
        raise ValueError("evacuate_assignment needs >= 1 survivor")
    if keep.size != np.unique(keep).size:
        raise ValueError(f"duplicate survivor indices in {keep.tolist()}")
    if keep.min() < 0 or keep.max() >= n_old:
        raise ValueError(f"survivor indices {keep.tolist()} out of range "
                         f"for {n_old} partitions")
    newidx = -np.ones(n_old, np.int64)
    newidx[keep] = np.arange(keep.size)
    assignment = np.asarray(assignment, np.int64)
    if assignment.size and (assignment.min() < 0
                            or assignment.max() >= n_old):
        raise ValueError("assignment references partitions outside "
                         f"[0, {n_old})")
    return newidx[assignment]


# ----------------------------------------------------------------------------
# Dirty-shard tracking
# ----------------------------------------------------------------------------

def dirty_partitions(g_old: Graph, a_old: np.ndarray, g_new: Graph,
                     a_new: np.ndarray, vmap: np.ndarray,
                     delta: GraphDelta, n: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Which partitions' (local, halo) block-CSR operands ``delta`` dirtied.

    Conservative (a clean verdict is a guarantee, a dirty one merely
    skips reuse):

      * partitions that gained/lost members are dirty on both operands and
        boundary-suspect (their slot layout shifted);
      * an added/removed edge (including edges that died with a removed
        vertex) dirties the *receiver's* partition — its local operand for
        intra-partition edges, its halo operand for cross edges; the
        sender's partition only becomes boundary-suspect (its own operands
        don't list the edge, but its boundary row set may change);
      * every boundary-suspect partition dirties the halo operand of every
        partition that still reads rows from it — the gathered halo
        table's row positions shifted for those readers.
    """
    member_dirty = set(int(p) for p in np.unique(a_old[delta.remove_vertices])
                       ) if len(delta.remove_vertices) else set()
    if delta.num_added_vertices:
        member_dirty |= set(
            int(p) for p in np.unique(a_new[vmap[g_old.num_vertices:]]))

    dirty_local = set(member_dirty)
    dirty_halo = set(member_dirty)
    boundary_suspect = set(member_dirty)

    def touch_edges(sp: np.ndarray, rp: np.ndarray) -> None:
        same = sp == rp
        dirty_local.update(int(p) for p in np.unique(rp[same]))
        dirty_halo.update(int(p) for p in np.unique(rp[~same]))
        boundary_suspect.update(int(p) for p in np.unique(sp[~same]))

    # Edges that died with removed vertices (both stored directions of an
    # undirected edge appear, so each surviving endpoint is seen as the
    # receiver of one of them).
    if len(delta.remove_vertices):
        gone = np.zeros(g_old.num_vertices, bool)
        gone[delta.remove_vertices] = True
        hit = gone[g_old.senders] | gone[g_old.receivers]
        touch_edges(a_old[g_old.senders[hit]], a_old[g_old.receivers[hit]])
    # Explicit edge removals (old-id space) and additions (mapped); both
    # directions of each undirected pair.
    if len(delta.remove_edges):
        u, v = delta.remove_edges[:, 0], delta.remove_edges[:, 1]
        touch_edges(a_old[np.concatenate([u, v])],
                    a_old[np.concatenate([v, u])])
    if len(delta.add_edges):
        add = vmap[delta.add_edges]
        add = add[(add >= 0).all(axis=1)]   # removal wins (see mutate_graph)
        if len(add):
            u, v = add[:, 0], add[:, 1]
            touch_edges(a_new[np.concatenate([u, v])],
                        a_new[np.concatenate([v, u])])

    # Halo propagation: readers of any boundary-suspect partition.
    cross = a_new[g_new.senders] != a_new[g_new.receivers]
    pairs = np.unique(
        a_new[g_new.senders[cross]] * n + a_new[g_new.receivers[cross]])
    for key in pairs:
        q, p = int(key // n), int(key % n)
        if q in boundary_suspect:
            dirty_halo.add(p)
    return (np.array(sorted(dirty_local), np.int64),
            np.array(sorted(dirty_halo), np.int64))


# ----------------------------------------------------------------------------
# Folding deltas + re-pricing
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class DeltaPlan:
    """Everything ``Engine.apply_delta`` needs to decide and rebuild."""
    graph: Graph
    assignment: np.ndarray
    dirty_local: np.ndarray
    dirty_halo: np.ndarray
    structural: bool
    counts: dict
    cut_fraction_before: float
    cut_fraction_after: float
    imbalance_before: float
    imbalance: float


def plan_delta(graph: Graph, assignment: np.ndarray,
               deltas: Sequence[GraphDelta], n: int, *,
               repair_tol: float = 0.10) -> DeltaPlan:
    """Fold ``deltas`` in order over (graph, assignment).

    Each delta addresses the graph produced by the previous one (the
    deferred-update contract).  Dirty sets are unioned, so one rebuild at
    the end covers the whole burst — the coalescing win of deferred mode.
    """
    assignment = np.asarray(assignment, np.int64)
    e0 = max(1, graph.num_edges)
    cut_before = edge_cut(graph, assignment) / e0
    g_cur, a_cur = graph, assignment
    dirty_l: set = set()
    dirty_h: set = set()
    counts = dict(added_vertices=0, removed_vertices=0, added_edges=0,
                  removed_edges=0, feature_upserts=0)
    structural = False
    for delta in deltas:
        if delta.is_empty:
            continue
        g_next, vmap = mutate_graph(g_cur, delta)
        if g_next.num_vertices < n:
            raise ValueError(
                f"delta leaves {g_next.num_vertices} vertices for {n} fog "
                f"partitions — cannot repair or recompile")
        mapped = -np.ones(g_next.num_vertices, np.int64)
        alive = vmap[:g_cur.num_vertices] >= 0
        mapped[vmap[:g_cur.num_vertices][alive]] = a_cur[alive]
        a_next = repair_assignment(g_next, mapped, n, tol=repair_tol)
        if delta.is_structural:
            structural = True
            dl, dh = dirty_partitions(g_cur, a_cur, g_next, a_next, vmap,
                                      delta, n)
            dirty_l |= set(int(p) for p in dl)
            dirty_h |= set(int(p) for p in dh)
        d = delta.describe()
        for key in counts:
            counts[key] += d[key]
        g_cur, a_cur = g_next, a_next
    cut_after = edge_cut(g_cur, a_cur) / max(1, g_cur.num_edges)
    return DeltaPlan(graph=g_cur, assignment=a_cur,
                     dirty_local=np.array(sorted(dirty_l), np.int64),
                     dirty_halo=np.array(sorted(dirty_h), np.int64),
                     structural=structural, counts=counts,
                     cut_fraction_before=float(cut_before),
                     cut_fraction_after=float(cut_after),
                     imbalance_before=imbalance_of(assignment, n),
                     imbalance=imbalance_of(a_cur, n))


def refresh_placement(g: Graph, assignment: np.ndarray,
                      mapping: np.ndarray, fogs: Sequence[FogSpec], *,
                      bytes_per_vertex: Optional[float] = None,
                      k_layers: int = 2, sync_cost: float = 5e-3
                      ) -> Placement:
    """Re-price a repaired assignment with already-profiled fog models.

    Rebuilds the ``Placement`` diagnostics (est_collect / est_exec per fog,
    Eq. 5/6) for the new graph without re-running BGP or LBAP — the
    partition -> fog ``mapping`` is inherited from the plan being repaired,
    so the simulator and the adaptive scheduler see costs that match the
    mutated topology.
    """
    if bytes_per_vertex is None:
        bytes_per_vertex = g.feature_dim * 8.0  # matches iep_place default
    mapping = np.asarray(mapping, np.int64)
    inv = np.zeros(len(mapping), np.int64)
    inv[mapping] = np.arange(len(mapping))
    partition_of = inv[assignment]
    parts = [np.flatnonzero(partition_of == k) for k in range(len(mapping))]
    return _finish(g, parts, mapping, fogs, bytes_per_vertex, k_layers,
                   sync_cost, partition_of)
