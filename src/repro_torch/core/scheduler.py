"""Adaptive workload scheduler (paper §III-F, Alg. 2).

Dual-mode regulation:
  * load-balance indicator  mu_j = T_j_real / mean_k(T_k_real)   (Eq. 9)
  * slackness lambda (>1) tolerated imbalance; skew threshold theta (default .5)
  * if any mu_j > lambda:  n+/n <= theta -> lightweight *diffusion* vertex
    migration; otherwise -> global IEP re-plan.

Diffusion (Fig. 10): repeatedly pick the (highest, lowest) estimated-time
partitions and migrate boundary vertices that share the most neighbors with
the underloaded side, until the estimated balance satisfies lambda.
All moves are virtual (on the placement) and applied atomically, as in the
paper ("operated virtually ... executed physically when ... idle").
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.api.registry import PLACEMENTS
from repro_torch.core.placement import FogSpec, Placement
from repro_torch.core.profiler import cardinality_of
from repro_torch.gnn.graph import Graph


def load_indicators(t_real: np.ndarray) -> np.ndarray:
    """mu_j (Eq. 9)."""
    t_real = np.asarray(t_real, np.float64)
    return t_real / max(t_real.mean(), 1e-12)


def _estimated_exec(g: Graph, assignment: np.ndarray,
                    fogs: Sequence[FogSpec]) -> np.ndarray:
    out = np.zeros(len(fogs))
    for j, f in enumerate(fogs):
        mine = np.flatnonzero(assignment == j)
        if mine.size:
            out[j] = f.latency_model.predict(cardinality_of(g, mine))
    return out


def _boundary_candidates(g: Graph, assignment: np.ndarray, src: int,
                         dst: int) -> np.ndarray:
    """Vertices in src ranked by #neighbors already in dst (descending)."""
    in_src = assignment == src
    cross = in_src[g.receivers] & (assignment[g.senders] == dst)
    if not cross.any():
        return np.array([], np.int64)
    verts, counts = np.unique(g.receivers[cross], return_counts=True)
    return verts[np.argsort(-counts)]


def diffusion_adjust(g: Graph, assignment: np.ndarray,
                     fogs: Sequence[FogSpec], lam: float,
                     max_migrations: int = 256) -> np.ndarray:
    """Pairwise overloaded->underloaded vertex diffusion (paper Fig. 10).

    ``fogs`` latency models must carry the *updated* load factors (the
    online profiler's eta), so estimates reflect current background load.
    """
    assignment = assignment.copy()
    for _ in range(max_migrations):
        est = _estimated_exec(g, assignment, fogs)
        mu = load_indicators(est)
        if mu.max() <= lam:
            break
        src = int(np.argmax(est))
        dst = int(np.argmin(est))
        cands = _boundary_candidates(g, assignment, src, dst)
        if cands.size == 0:  # no shared boundary: take any src vertex
            cands = np.flatnonzero(assignment == src)
            if cands.size <= 1:
                break
        moved = False
        for v in cands[:8]:
            trial = assignment.copy()
            trial[v] = dst
            t_est = _estimated_exec(g, trial, fogs)
            if t_est.max() < est.max() - 1e-12:
                assignment = trial
                moved = True
                break
        if not moved:
            break
    return assignment


@dataclasses.dataclass
class SchedulerState:
    placement: Placement
    mode_history: list = dataclasses.field(default_factory=list)
    migrations: int = 0
    replans: int = 0


def schedule_step(g: Graph, state: SchedulerState, fogs: Sequence[FogSpec],
                  t_real: np.ndarray, *, lam: float = 1.3,
                  theta: float = 0.5, bytes_per_vertex: Optional[float] = None,
                  k_layers: int = 2, sync_cost: float = 5e-3,
                  seed: int = 0,
                  replan_strategy: str = "iep",
                  replan_partitioner=None) -> SchedulerState:
    """One Alg. 2 invocation: update timings -> skew check -> dual-mode.

    ``replan_strategy`` names a PLACEMENTS registry entry used for the
    global re-plan branch (the paper uses IEP; baselines are pluggable);
    ``replan_partitioner`` overrides the BGP solver the re-plan uses, so a
    plan compiled with a custom partitioner keeps it across re-plans.
    """
    t_real = np.asarray(t_real, np.float64)
    # Step 1: update performance estimates (online profiler eta per node).
    for j, f in enumerate(fogs):
        mine = np.flatnonzero(state.placement.assignment == j)
        if mine.size:
            f.latency_model.observe(cardinality_of(g, mine), float(t_real[j]))
    # Step 2: skew indicators.
    mu = load_indicators(t_real)
    if mu.max() <= lam:
        state.mode_history.append("none")
        return state
    n_over = int(np.sum(mu > lam))
    if n_over / len(fogs) <= theta:
        new_assign = diffusion_adjust(g, state.placement.assignment, fogs, lam)
        moved = int(np.sum(new_assign != state.placement.assignment))
        state.placement = dataclasses.replace(
            state.placement, assignment=new_assign)
        state.migrations += moved
        state.mode_history.append(f"diffusion({moved})")
    else:
        state.placement = PLACEMENTS.resolve(replan_strategy).place(
            g, fogs, bytes_per_vertex=bytes_per_vertex, k_layers=k_layers,
            sync_cost=sync_cost, seed=seed, partitioner=replan_partitioner)
        state.replans += 1
        state.mode_history.append("replan")
    return state
