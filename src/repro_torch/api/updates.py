"""Typed graph updates for mutating IoT deployments.

Fograph's target workload is geo-distributed sensors whose graph is not
static: vertices and edges appear, disappear, and change features between
queries.  This module defines the *wire types* of the dynamic-graph
subsystem; the repair algorithms live in ``repro_torch.core.incremental``
and the entry points are ``Engine.apply_delta(plan, delta) -> Plan`` and
``Session.update(delta)``.

Id convention — every id in a :class:`GraphDelta` refers to the id space of
the graph the delta is applied *to* (the "old" graph):

  * surviving vertices keep their old ids ``0 .. V-1``;
  * the ``k`` new vertices are addressed as ``V .. V+k-1`` (so new edges may
    connect new vertices to old ones, or to each other);
  * after application, the mutated graph is compacted: survivors are
    renumbered in order, new vertices appended at the end.  The ``vmap``
    returned by ``incremental.mutate_graph`` translates old ids (including
    the ``V+i`` aliases of new vertices) to new ids, with ``-1`` for
    removed vertices.

Deltas applied in sequence (the ``Session``'s deferred-update buffer)
therefore each address the graph produced by the previous delta.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


def _as_ids(a, name: str) -> np.ndarray:
    out = np.asarray([] if a is None else a, dtype=np.int64).reshape(-1)
    return out


def _as_edges(a, name: str) -> np.ndarray:
    if a is None:
        return np.zeros((0, 2), np.int64)
    out = np.asarray(a, dtype=np.int64)
    if out.size == 0:
        return np.zeros((0, 2), np.int64)
    if out.ndim != 2 or out.shape[1] != 2:
        raise ValueError(f"{name} must be an [m, 2] array of (u, v) pairs, "
                         f"got shape {out.shape}")
    return out


@dataclasses.dataclass(frozen=True)
class GraphDelta:
    """One batch of graph mutations (see module docstring for id rules).

    Attributes:
      add_features: float[k, F] features of the ``k`` new vertices (their
        ids are ``V .. V+k-1``); ``None``/empty adds no vertices.
      remove_vertices: ids of vertices to drop (with all incident edges).
      add_edges / remove_edges: [m, 2] undirected (u, v) pairs — both
        directions are added/removed, mirroring ``graph.from_edge_list``.
        Adding an existing edge or removing a missing one is a no-op.
      feature_ids / feature_values: feature upserts — row ``i`` of
        ``feature_values`` replaces the features of vertex
        ``feature_ids[i]`` (new-vertex aliases ``V+i`` are legal targets).
      add_labels / add_positions: optional per-new-vertex labels/positions;
        when the graph carries labels/positions and these are omitted, new
        vertices get zeros.
    """
    add_features: Optional[np.ndarray] = None
    remove_vertices: Optional[np.ndarray] = None
    add_edges: Optional[np.ndarray] = None
    remove_edges: Optional[np.ndarray] = None
    feature_ids: Optional[np.ndarray] = None
    feature_values: Optional[np.ndarray] = None
    add_labels: Optional[np.ndarray] = None
    add_positions: Optional[np.ndarray] = None

    def __post_init__(self):
        set_ = object.__setattr__
        if self.add_features is not None:
            f = np.asarray(self.add_features, np.float32)
            if f.size and f.ndim != 2:
                raise ValueError("add_features must be a [k, F] array, got "
                                 f"shape {f.shape}")
            set_(self, "add_features", None if f.size == 0 else f)
        set_(self, "remove_vertices",
             np.unique(_as_ids(self.remove_vertices, "remove_vertices")))
        set_(self, "add_edges", _as_edges(self.add_edges, "add_edges"))
        set_(self, "remove_edges", _as_edges(self.remove_edges,
                                             "remove_edges"))
        set_(self, "feature_ids", _as_ids(self.feature_ids, "feature_ids"))
        k_upd = len(self.feature_ids)
        if self.feature_values is None:
            if k_upd:
                raise ValueError("feature_ids and feature_values must be "
                                 "given together")
        else:
            v = np.asarray(self.feature_values, np.float32)
            if v.ndim == 1 and k_upd == 1:
                v = v[None, :]
            if k_upd == 0 and v.size == 0:     # empty upsert set: a no-op
                set_(self, "feature_values", None)
            elif v.ndim != 2 or v.shape[0] != k_upd:
                raise ValueError(
                    f"feature_values must be a [{k_upd}, F] array (one row "
                    f"per feature_ids entry), got shape "
                    f"{np.shape(self.feature_values)}")
            else:
                set_(self, "feature_values", v)
        for name in ("add_labels", "add_positions"):
            a = getattr(self, name)
            if a is not None:
                a = np.asarray(a)
                if a.shape[0] != self.num_added_vertices:
                    raise ValueError(
                        f"{name} must have one row per added vertex "
                        f"({self.num_added_vertices}), got {a.shape[0]}")
                set_(self, name, a)

    # -- shape -----------------------------------------------------------

    @property
    def num_added_vertices(self) -> int:
        return 0 if self.add_features is None else int(
            self.add_features.shape[0])

    @property
    def num_removed_vertices(self) -> int:
        return int(len(self.remove_vertices))

    @property
    def is_empty(self) -> bool:
        return (self.num_added_vertices == 0
                and self.num_removed_vertices == 0
                and len(self.add_edges) == 0
                and len(self.remove_edges) == 0
                and len(self.feature_ids) == 0)

    @property
    def is_structural(self) -> bool:
        """True if the delta changes topology (not just feature values)."""
        return (self.num_added_vertices > 0
                or self.num_removed_vertices > 0
                or len(self.add_edges) > 0
                or len(self.remove_edges) > 0)

    def validate(self, num_vertices: int, feature_dim: int) -> None:
        """Check ids/shapes against the graph the delta applies to."""
        v, k = num_vertices, self.num_added_vertices
        if self.add_features is not None \
                and self.add_features.shape[1] != feature_dim:
            raise ValueError(
                f"add_features has {self.add_features.shape[1]} columns; the "
                f"graph's feature_dim is {feature_dim}")
        if len(self.remove_vertices):
            lo, hi = int(self.remove_vertices.min()), int(
                self.remove_vertices.max())
            if lo < 0 or hi >= v:
                raise ValueError(
                    f"remove_vertices ids must be existing vertices in "
                    f"[0, {v}), got range [{lo}, {hi}] — new vertices cannot "
                    f"be removed by the delta that adds them")
        for name, edges in (("add_edges", self.add_edges),
                            ("remove_edges", self.remove_edges)):
            if len(edges) == 0:
                continue
            hi = v + k if name == "add_edges" else v
            if int(edges.min()) < 0 or int(edges.max()) >= hi:
                raise ValueError(
                    f"{name} endpoints must lie in [0, {hi}) "
                    f"(|V|={v}, {k} added), got range "
                    f"[{int(edges.min())}, {int(edges.max())}]")
        if len(self.feature_ids):
            lo, hi = int(self.feature_ids.min()), int(self.feature_ids.max())
            if lo < 0 or hi >= v + k:
                raise ValueError(f"feature_ids must lie in [0, {v + k}), "
                                 f"got range [{lo}, {hi}]")
            if np.isin(self.feature_ids, self.remove_vertices).any():
                raise ValueError("feature_ids targets a vertex the same "
                                 "delta removes")
            if self.feature_values.shape[1] != feature_dim:
                raise ValueError(
                    f"feature_values has {self.feature_values.shape[1]} "
                    f"columns; the graph's feature_dim is {feature_dim}")

    def describe(self) -> dict:
        return {
            "added_vertices": self.num_added_vertices,
            "removed_vertices": self.num_removed_vertices,
            "added_edges": int(len(self.add_edges)),
            "removed_edges": int(len(self.remove_edges)),
            "feature_upserts": int(len(self.feature_ids)),
        }

    def __repr__(self) -> str:
        d = self.describe()
        body = ", ".join(f"{k}={v}" for k, v in d.items() if v)
        return f"GraphDelta({body or 'empty'})"


@dataclasses.dataclass(frozen=True)
class UpdateRequest:
    """One graph update in an arrival stream (the Server's control plane).

    Mirrors ``server.Request``: ``arrival_time`` is on the simulated clock
    (None = ready at admission); ids are assigned at ``submit`` from the
    same counter as query requests, so a mixed trace has one id space.
    ``deadline`` is a latency budget in simulated seconds from arrival and
    ``priority`` a class rank (higher = more important) — both read by the
    SLO control plane (``repro_torch.api.slo``), which prices the delta's
    repair time on the serving clock and may reject an update whose
    repair cannot finish inside its deadline. Updates are never degraded
    (a partial repair has no meaning) and never reordered across queries.
    """
    delta: GraphDelta
    arrival_time: Optional[float] = None
    deadline: Optional[float] = None
    priority: int = 0
    request_id: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class UpdateReport:
    """What one ``apply_delta`` (or one deferred flush) actually did.

    ``mode``:
      "noop"         every delta was empty — the plan is unchanged.
      "features"     feature-only deltas: partition layout and block shards
                     reused verbatim, only the feature table refreshed.
      "incremental"  localized repair + dirty-shard rebuild.
      "recompile"    repair quality tripped a threshold (see ``reason``) —
                     the full Engine.compile pipeline ran instead.
    """
    mode: str
    num_deltas: int
    added_vertices: int
    removed_vertices: int
    added_edges: int
    removed_edges: int
    feature_upserts: int
    dirty_local: Tuple[int, ...] = ()
    dirty_halo: Tuple[int, ...] = ()
    num_partitions: int = 0
    imbalance_before: float = 0.0
    imbalance: float = 0.0
    cut_fraction_before: float = 0.0
    cut_fraction_after: float = 0.0
    reason: str = ""

    @property
    def shards_rebuilt(self) -> int:
        return len(set(self.dirty_local) | set(self.dirty_halo))
