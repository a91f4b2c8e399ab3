"""Proxy-guided GNN latency profiler (paper §III-B).

Offline: sample a calibration set of subgraphs with varying *cardinality*
⟨|V|, |N_V|⟩ (20 samples per cardinality axis, preserving the degree
distribution), measure per-fog execution latency, and fit the linear
regression of Eq. (3):   latency = beta . <|V|, |N_V|> + eps.

Online: two-step estimation — measure T_real for the local cardinality c,
compute the load factor eta = T_real / omega(c), and predict any other
cardinality c' as eta * omega(c').

Measurement sources are pluggable: real wall-clock timing of the GNN
forward on a torch device (``time_gnn_measurer``) or the fog-cluster capability simulator
(``repro_torch.core.simulation``) for heterogeneous-node experiments.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Sequence, Tuple

import numpy as np

from repro_torch.gnn.graph import Graph, neighbor_count, subgraph

Cardinality = Tuple[int, int]  # (|V|, |N_V|)


def sample_calibration_set(g: Graph, num_sizes: int = 6,
                           samples_per_size: int = 20,
                           seed: int = 0) -> List[np.ndarray]:
    """Uniformly sample vertex subsets of varying cardinality.

    Per the paper, for each cardinality axis we draw a group of samples so
    the natural degree distribution is preserved.
    """
    rng = np.random.default_rng(seed)
    sizes = np.unique(np.linspace(
        max(1, g.num_vertices // (num_sizes * 4)),
        max(2, int(g.num_vertices * 0.9)),
        num_sizes).astype(np.int64))
    out = []
    for s in sizes:
        for _ in range(samples_per_size):
            out.append(rng.choice(g.num_vertices, size=int(s), replace=False))
    return out


def cardinality_of(g: Graph, vertex_ids: np.ndarray) -> Cardinality:
    return (int(len(vertex_ids)), neighbor_count(g, vertex_ids))


@dataclasses.dataclass
class LatencyModel:
    """omega(<c>) = beta . <|V|, |N_V|> + eps (Eq. 3), per fog node."""
    beta: np.ndarray   # float64[2]
    eps: float
    load_factor: float = 1.0  # eta, updated online

    def predict(self, c: Cardinality) -> float:
        base = float(self.beta @ np.asarray(c, np.float64) + self.eps)
        return self.load_factor * max(base, 1e-9)

    def observe(self, c: Cardinality, t_real: float) -> float:
        """Online two-step estimation: update eta from one real measurement."""
        base = float(self.beta @ np.asarray(c, np.float64) + self.eps)
        self.load_factor = t_real / max(base, 1e-9)
        return self.load_factor


def fit_latency_model(cards: Sequence[Cardinality],
                      latencies: Sequence[float]) -> LatencyModel:
    """Least-squares fit of Eq. (3). Guards against degenerate designs."""
    x = np.asarray(cards, np.float64)
    y = np.asarray(latencies, np.float64)
    design = np.concatenate([x, np.ones((len(x), 1))], axis=1)
    coef, *_ = np.linalg.lstsq(design, y, rcond=None)
    beta, eps = coef[:2], float(coef[2])
    # Latency must be non-decreasing in workload: clamp negative slopes that
    # arise from noisy tiny calibration sets.
    beta = np.maximum(beta, 0.0)
    return LatencyModel(beta=beta, eps=max(eps, 0.0))


def profile_node(g: Graph, measure: Callable[[np.ndarray], float],
                 num_sizes: int = 6, samples_per_size: int = 20,
                 seed: int = 0) -> LatencyModel:
    """Offline profiling of one fog node.

    ``measure(vertex_ids) -> seconds`` abstracts the node: real timing or
    simulated capability.
    """
    cal = sample_calibration_set(g, num_sizes, samples_per_size, seed)
    cards = [cardinality_of(g, ids) for ids in cal]
    lats = [measure(ids) for ids in cal]
    # Average within identical |V| groups as the paper does per-cardinality.
    return fit_latency_model(cards, lats)


def time_gnn_measurer(g: Graph, kind: str, params, repeats: int = 3,
                      device: str = "cuda") -> Callable[[np.ndarray], float]:
    """Wall-clock measurer: times the GNN forward on ``device``.

    ``params`` is the port's per-layer list of tensor dicts (see
    ``gnn.models.params_from_numpy``). One untimed forward warms the
    device up; on CUDA the clock stops only after ``synchronize``.
    """
    import torch
    from repro_torch.gnn.layers import EdgeList
    from repro_torch.gnn.models import gnn_apply

    dev = torch.device(device)
    sync = (torch.cuda.synchronize if dev.type == "cuda"
            else (lambda: None))

    def measure(vertex_ids: np.ndarray) -> float:
        sg = subgraph(g, vertex_ids)
        edges = EdgeList.from_graph(sg, device=dev)
        h = torch.as_tensor(sg.features, dtype=torch.float32, device=dev)
        with torch.no_grad():
            gnn_apply(params, kind, h, edges)
            sync()
            t0 = time.perf_counter()
            for _ in range(repeats):
                gnn_apply(params, kind, h, edges)
            sync()
        return (time.perf_counter() - t0) / repeats

    return measure


def analytic_measurer(capability_flops: float, feature_dim: int,
                      hidden: int, noise: float = 0.0, seed: int = 0,
                      overhead: float = 1e-4) -> Callable[[np.ndarray], float]:
    """Closed-form workload model for simulated heterogeneous nodes.

    GNN layer cost ~ |V|·F·H (update matmuls) + |N_V|·F (aggregation reads);
    capability_flops scales node speed (types A/B/C in Table II).
    """
    rng = np.random.default_rng(seed)

    def measure_cardinality(c: Cardinality) -> float:
        v, nv = c
        flops = 2.0 * v * feature_dim * hidden + 8.0 * nv * feature_dim
        t = flops / capability_flops + overhead
        if noise:
            t *= float(1.0 + rng.normal(scale=noise))
        return max(t, 1e-9)

    return measure_cardinality


def profile_node_analytic(g: Graph, measure_c: Callable[[Cardinality], float],
                          num_sizes: int = 6, samples_per_size: int = 20,
                          seed: int = 0) -> LatencyModel:
    """Like profile_node but for measurers taking cardinalities directly."""
    cal = sample_calibration_set(g, num_sizes, samples_per_size, seed)
    cards = [cardinality_of(g, ids) for ids in cal]
    lats = [measure_c(c) for c in cards]
    return fit_latency_model(cards, lats)
