"""k-hop dirty frontiers and per-layer activation caching (ROADMAP
"Dynamic graphs", incremental *queries*).

``Engine.apply_delta`` repairs the plan incrementally, but until this
module a query after an update still recomputed all V vertices. The
observation: a K-layer GNN output row u changes only when some input
within K hops of u changed. This module computes that reach exactly:

  1. ``fold_delta_frontier``  replay a ``GraphDelta`` sequence through
                              ``mutate_graph`` and extract the *seed*
                              set (touched vertices / edge endpoints in
                              the post-mutation id space), the composed
                              old->new vertex map, and the union-
                              adjacency extras — removed edges between
                              survivors, which no longer exist in the
                              new graph but still propagate dirt (the
                              endpoints lost a neighbor).
  2. ``expand_frontier``      per-layer dirty sets: D_l = all vertices
                              within l hops of a seed over the union of
                              pre- and post-mutation adjacency.
  3. ``ActivationCache``      retains the last full pass's per-layer
                              [V, F_l] activations plus the collected
                              h^0 it was computed from; remaps rows
                              through the order-preserving compaction
                              on update; decides per query whether the
                              frontier path applies (and is cheap
                              enough) or a full recompute must run.

Feature changes are caught *by value*: at query time the freshly
collected h^0 is compared bitwise against the cached h^0 and every
differing row joins the seeds. This subsumes feature upserts, per-query
feature overrides, and the DAQ codec's global degree-quantile coupling
(a structural delta can shift quantization thresholds and thereby
change h^0 rows whose raw features never moved).

Everything here is host-side numpy, a copy of the JAX reference's
bookkeeping (every number it gives equals the reference's); the executors
own the device side: row-subset kernel launches or dirty-receiver edge
lists, and ``torch.where`` merges into the cached tables.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.api.updates import GraphDelta
from repro_torch.core.incremental import mutate_graph
from repro_torch.gnn.graph import Graph

__all__ = ["FrontierUpdate", "QueryFrontier", "FrontierPlan",
           "ActivationCache", "fold_delta_frontier", "expand_frontier",
           "frontier_plan"]


_EMPTY_IDS = np.empty(0, np.int64)
_EMPTY_EDGES = np.empty((0, 2), np.int64)


@dataclasses.dataclass(frozen=True)
class FrontierUpdate:
    """What one (folded) delta sequence means for cached activations."""
    graph: Graph              # post-mutation graph (replayed)
    vmap: np.ndarray          # int64[v_old] old id -> new id, -1 if removed
    seeds: np.ndarray         # int64, sorted unique, new-id space
    extra_edges: np.ndarray   # int64[m, 2], new-id space, both directions
    removed_vertices: bool    # any vertex removal anywhere in the sequence
    structural: bool          # any vertex/edge add or remove (vs feature-only)


@dataclasses.dataclass(frozen=True)
class QueryFrontier:
    """Per-layer dirty rows for one incremental query."""
    seeds: np.ndarray         # int64, sorted unique
    rows: List[np.ndarray]    # one int64 array per layer, D_1 .. D_K
    fraction: float           # |D_K| / V


@dataclasses.dataclass(frozen=True)
class FrontierPlan:
    """Frontier snapshot for the ``plan.frontier`` analysis checks."""
    seeds: np.ndarray
    rows: List[np.ndarray]    # D_1 .. D_K
    extra_edges: np.ndarray
    num_vertices: int
    num_layers: int
    revision: str             # adjacency fingerprint the frontier was cut at


def _unique(ids) -> np.ndarray:
    if len(ids) == 0:
        return _EMPTY_IDS
    return np.unique(np.asarray(ids, np.int64))


def _delta_seeds(g: Graph, delta: GraphDelta, vmap: np.ndarray):
    """(seeds, extra_edges) of one delta, in the post-mutation id space."""
    v_old = g.num_vertices
    seeds: List[np.ndarray] = []
    extras: List[np.ndarray] = []
    # Added vertices (appended after the survivors).
    if delta.num_added_vertices:
        seeds.append(vmap[v_old:])
    # Added edges touch both (surviving) endpoints.
    if len(delta.add_edges):
        add = vmap[np.asarray(delta.add_edges, np.int64)]
        seeds.append(add[add >= 0])
    # Removed edges: both former endpoints lose a neighbor. Pairs whose
    # endpoints both survive also enter the union adjacency — the edge is
    # gone from the new graph but dirt still propagates across it.
    if len(delta.remove_edges):
        rem = vmap[np.asarray(delta.remove_edges, np.int64)]
        seeds.append(rem[rem >= 0])
        both = rem[(rem >= 0).all(axis=1)]
        if len(both):
            extras.append(np.concatenate([both, both[:, ::-1]], axis=0))
    # Removed vertices dirty every surviving former neighbor (the removed
    # row itself no longer exists; propagation *through* it is covered by
    # seeding its whole former neighborhood).
    if len(delta.remove_vertices):
        nbrs = []
        for x in np.asarray(delta.remove_vertices, np.int64):
            nbrs.append(g.indices[g.indptr[x]:g.indptr[x + 1]])
        if nbrs:
            nb = vmap[np.concatenate(nbrs).astype(np.int64)]
            seeds.append(nb[nb >= 0])
    # Feature upserts touch their target rows. (The h^0 value diff at
    # query time would catch them too; seeding keeps the frontier exact
    # even for callers that skip the diff.)
    if len(delta.feature_ids):
        upd = vmap[np.asarray(delta.feature_ids, np.int64)]
        seeds.append(upd[upd >= 0])
    seed_ids = (_unique(np.concatenate(seeds)) if seeds else _EMPTY_IDS)
    extra = (np.concatenate(extras, axis=0) if extras else _EMPTY_EDGES)
    return seed_ids, extra


def fold_delta_frontier(g: Graph,
                        deltas: Sequence[GraphDelta]) -> FrontierUpdate:
    """Replay ``deltas`` over ``g`` and fold their frontier bookkeeping.

    The replay is the same deterministic ``mutate_graph`` chain
    ``core.incremental.plan_delta`` runs, so the returned graph is
    bit-identical to the plan the Engine rebased onto (callers may
    assert via ``kernels.ops.graph_fingerprint``). Seeds and extras
    from earlier deltas are carried through each later delta's vertex
    map; an extra edge losing an endpoint drops out (its invalidation
    then flows through the vertex-removal seeding of that delta).
    """
    if isinstance(deltas, GraphDelta):
        deltas = [deltas]
    v0 = g.num_vertices
    vmap_total = np.arange(v0, dtype=np.int64)
    seeds = _EMPTY_IDS
    extras = _EMPTY_EDGES
    removed_any = False
    structural_any = False
    cur = g
    for delta in deltas:
        prev = cur
        cur, vmap = mutate_graph(cur, delta)
        removed_any = removed_any or len(delta.remove_vertices) > 0
        structural_any = structural_any or bool(
            delta.num_added_vertices or len(delta.remove_vertices)
            or len(delta.add_edges) or len(delta.remove_edges))
        # Carry earlier bookkeeping into the new id space.
        if len(seeds):
            seeds = seeds[vmap[seeds] >= 0]
            seeds = vmap[seeds] if len(seeds) else _EMPTY_IDS
        if len(extras):
            m = vmap[extras]
            extras = m[(m >= 0).all(axis=1)]
        d_seeds, d_extras = _delta_seeds(prev, delta, vmap)
        seeds = _unique(np.concatenate([seeds, d_seeds]))
        if len(d_extras):
            extras = np.concatenate([extras, d_extras], axis=0)
        # Compose the total old->new map.
        alive = vmap_total >= 0
        nxt = np.full(v0, -1, np.int64)
        nxt[alive] = vmap[vmap_total[alive]]
        vmap_total = nxt
    if len(extras):
        extras = np.unique(extras, axis=0)
    return FrontierUpdate(graph=cur, vmap=vmap_total, seeds=seeds,
                          extra_edges=extras, removed_vertices=removed_any,
                          structural=structural_any)


def expand_frontier(graph: Graph, seeds: np.ndarray,
                    extra_edges: np.ndarray,
                    num_layers: int) -> List[np.ndarray]:
    """Per-layer dirty sets ``[D_1, ..., D_K]``: D_l is the l-hop ball of
    ``seeds`` over the union adjacency (the graph's own edges — both
    directions are stored — plus ``extra_edges``, the removed-but-
    invalidating pairs)."""
    v = graph.num_vertices
    send = np.asarray(graph.senders, np.int64)
    recv = np.asarray(graph.receivers, np.int64)
    if len(extra_edges):
        send = np.concatenate([send, np.asarray(extra_edges[:, 0], np.int64)])
        recv = np.concatenate([recv, np.asarray(extra_edges[:, 1], np.int64)])
    dirty = np.zeros(v, bool)
    seeds = np.asarray(seeds, np.int64)
    dirty[seeds] = True
    out: List[np.ndarray] = []
    for _ in range(int(num_layers)):
        nxt = dirty.copy()
        nxt[recv[dirty[send]]] = True
        dirty = nxt
        out.append(np.flatnonzero(dirty).astype(np.int64))
    return out


def frontier_plan(graph: Graph, seeds: np.ndarray, extra_edges: np.ndarray,
                  num_layers: int, revision: str) -> FrontierPlan:
    """Bundle an expanded frontier for the ``plan.frontier`` checks."""
    rows = expand_frontier(graph, seeds, extra_edges, num_layers)
    return FrontierPlan(seeds=np.asarray(seeds, np.int64), rows=rows,
                        extra_edges=np.asarray(extra_edges, np.int64),
                        num_vertices=graph.num_vertices,
                        num_layers=int(num_layers), revision=revision)


class ActivationCache:
    """Per-layer activations of the last full pass, plus the pending dirt.

    Lifecycle (driven by ``api.session.Session``):

      * ``populate`` after a full pass: store the collected h^0 and every
        layer output, tagged with the (aggregation mode, executor family)
        that produced them and the graph's adjacency fingerprint.
      * ``apply_update`` at flush time: remap all rows through the
        delta's order-preserving compaction (survivors keep their values,
        new rows zero), accumulate seeds / union-adjacency extras, and
        note structural changes — block regrouping makes the kernel
        path's accumulation order layout-sensitive, so ``pallas_ok``
        gates it off until the next full pass rebases the cache
        (feature-only streams keep it armed).
      * ``plan_query`` per query: revision/tag agreement, the bitwise
        h^0 diff, frontier expansion, and the ``max_fraction`` budget.
      * ``merge`` after an incremental query: the scatter-merged layer
        tables become the new cache state and the pending dirt clears.

    Numerics contract: a value served from (or merged into) the cache is
    bit-identical to what a from-scratch pass under the same (mode,
    family) would produce — callers must re-populate, not merge, when
    either tag changes.
    """

    def __init__(self, max_fraction: float = 0.25):
        if not 0.0 < float(max_fraction) <= 1.0:
            raise ValueError("frontier_max_fraction must be in (0, 1], "
                             f"got {max_fraction}")
        self.max_fraction = float(max_fraction)
        self.h0: Optional[np.ndarray] = None
        self.layers: Optional[List[np.ndarray]] = None
        self.revision: Optional[str] = None
        self.mode: Optional[str] = None
        self.family: Optional[str] = None
        self.seeds = _EMPTY_IDS
        self.extra_edges = _EMPTY_EDGES
        self.pallas_ok = True

    # -- state ---------------------------------------------------------------

    @property
    def primed(self) -> bool:
        return self.layers is not None

    def clear(self) -> None:
        self.h0 = None
        self.layers = None
        self.revision = None
        self.mode = None
        self.family = None
        self.seeds = _EMPTY_IDS
        self.extra_edges = _EMPTY_EDGES
        self.pallas_ok = True

    def matches(self, revision: str, mode: str, family: str) -> bool:
        return (self.primed and self.revision == revision
                and self.mode == mode and self.family == family)

    # -- lifecycle -----------------------------------------------------------

    def populate(self, h0: np.ndarray, layers: Sequence[np.ndarray],
                 revision: str, mode: str, family: str) -> None:
        self.h0 = np.asarray(h0, np.float32)
        self.layers = [np.asarray(a, np.float32) for a in layers]
        self.revision = revision
        self.mode = mode
        self.family = family
        self.seeds = _EMPTY_IDS
        self.extra_edges = _EMPTY_EDGES
        self.pallas_ok = True

    def apply_update(self, fu: FrontierUpdate, revision: str) -> None:
        """Rebase cached rows onto the mutated graph's id space."""
        if not self.primed:
            return
        v_new = fu.graph.num_vertices
        # src[new_id] = old row feeding it, -1 for brand-new vertices.
        src = np.full(v_new, -1, np.int64)
        alive = np.flatnonzero(fu.vmap >= 0)
        src[fu.vmap[alive]] = alive

        def remap(arr: np.ndarray) -> np.ndarray:
            out = np.zeros((v_new,) + arr.shape[1:], arr.dtype)
            m = src >= 0
            out[m] = arr[src[m]]
            return out

        self.h0 = remap(self.h0)
        self.layers = [remap(a) for a in self.layers]
        # Pending dirt from an earlier un-queried flush rides along.
        if len(self.seeds):
            s = self.seeds[fu.vmap[self.seeds] >= 0]
            self.seeds = fu.vmap[s] if len(s) else _EMPTY_IDS
        if len(self.extra_edges):
            m = fu.vmap[self.extra_edges]
            self.extra_edges = m[(m >= 0).all(axis=1)]
        self.seeds = _unique(np.concatenate([self.seeds, fu.seeds]))
        if len(fu.extra_edges):
            self.extra_edges = np.unique(np.concatenate(
                [self.extra_edges, fu.extra_edges], axis=0), axis=0)
        # Structural deltas poison the kernel path until the next full
        # pass: removals renumber ids (tiles regroup), mesh halo layout
        # is globally coupled, and even a pure edge add can insert an
        # all-zero tile into a clean row-block's accumulation, where
        # IEEE ``-0.0 + 0.0 == +0.0`` flips bits. Feature-only deltas
        # (the common sensor-refresh stream) keep it armed.
        self.pallas_ok = self.pallas_ok and not fu.structural
        self.revision = revision

    def plan_query(self, feats, graph: Graph,
                   num_layers: int) -> Optional[QueryFrontier]:
        """Frontier for one query whose collected input is ``feats``
        ([V, F] or a stacked [B, V, F] micro-batch — the batch unions its
        members' h^0 diffs into one stacked frontier). ``None`` means the
        frontier path does not apply (unprimed cache, shape drift, or a
        frontier above the ``max_fraction`` budget) and the caller must
        run a full pass."""
        if not self.primed:
            return None
        feats = np.asarray(feats, np.float32)
        stacked = feats.ndim == 3
        if feats.shape[-2:] != self.h0.shape:
            return None
        # Bitwise diff: NaN != NaN is True, so NaN rows always recompute.
        diff = feats != self.h0
        changed = np.flatnonzero(
            diff.any(axis=(0, 2)) if stacked else diff.any(axis=1))
        seeds = _unique(np.concatenate([self.seeds, changed]))
        if len(seeds) == 0:
            return QueryFrontier(seeds=_EMPTY_IDS, rows=[], fraction=0.0)
        rows = expand_frontier(graph, seeds, self.extra_edges, num_layers)
        fraction = len(rows[-1]) / max(graph.num_vertices, 1)
        if fraction > self.max_fraction:
            return None
        return QueryFrontier(seeds=seeds, rows=rows, fraction=fraction)

    def merge(self, h0: np.ndarray,
              layers: Sequence[np.ndarray]) -> None:
        """Adopt the scatter-merged tables of an incremental query."""
        self.h0 = np.asarray(h0, np.float32)
        self.layers = [np.asarray(a, np.float32) for a in layers]
        self.seeds = _EMPTY_IDS
        self.extra_edges = _EMPTY_EDGES
        self.pallas_ok = True

    def frontier_plan(self, graph: Graph,
                      num_layers: int) -> Optional[FrontierPlan]:
        """Snapshot the *pending* frontier for the analysis checks."""
        if not self.primed or self.revision is None:
            return None
        return frontier_plan(graph, self.seeds, self.extra_edges,
                             num_layers, self.revision)
