"""Full GNN models: K-layer stacks of Table-I layers + ASTGCN-lite.

Parameters are a list of per-layer dicts of float32 tensors, the layout of
the JAX reference's parameter pytrees; ``GNN`` wraps such a list in an
``nn.Module``. ``params_from_numpy`` carries weights across from numpy.

Includes a tiny full-batch trainer so accuracy experiments (paper Tables
IV/V) run against *trained* models rather than random weights, and the
ASTGCN-lite forecaster of the case study (§IV-C) with its trainer. Both
train by autograd through the fixed-order segment sum
(``kernels.segment_sum``), whose backward is the same kernel over the
transposed order, on the device of the generator they are given.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.gnn.layers import (EdgeList, LAYER_FNS, aggregate_sum,
                                    apply_layer, masked_degree)


def gnn_init(generator: torch.Generator, kind: str,
             dims: Sequence[int],
             heads: Optional[Sequence[int]] = None) -> List[dict]:
    """dims = [in, hidden..., out]; returns the per-layer param list, on
    the generator's device, drawn from ``generator`` in layer order.
    ``heads`` (GAT kinds): each layer's head count, the hidden layers'
    heads concatenated into their width, the last layer's averaged;
    ``gat_heads`` needs it."""
    init_fn, _ = LAYER_FNS[kind]
    n = len(dims) - 1
    if heads is None and kind == "gat_heads":
        raise ValueError("gat_heads weights need heads: each layer's head "
                         "count")
    if heads is None:
        return [init_fn(generator, dims[i], dims[i + 1]) for i in range(n)]
    if len(heads) != n:
        raise ValueError(f"{len(heads)} head counts for {n} layers")
    return [init_fn(generator, dims[i], dims[i + 1], heads[i],
                    concat=i < n - 1) for i in range(n)]


def _f32_copy(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to(device=device, dtype=torch.float32,
                             copy=True)
    return torch.tensor(np.asarray(v, np.float32), device=device)


def params_from_numpy(params, device="cpu") -> List[dict]:
    """Per-layer dicts of arrays (numpy, anything ``np.asarray`` takes, or
    tensors) -> the port's per-layer dicts of float32 tensors on
    ``device``, each a copy of its own."""
    return [{k: _f32_copy(v, device) for k, v in p.items()} for p in params]


def gnn_apply_layers(params: List[dict], kind: str, h: torch.Tensor,
                     edges: EdgeList, *, aggregate=None
                     ) -> List[torch.Tensor]:
    """K-layer forward returning every layer's output, h^1 .. h^K.
    ``aggregate`` replaces the aggregation of the GCN and SAGE layers."""
    kwargs = {}
    if aggregate is not None and kind in ("gcn", "sage"):
        kwargs["aggregate"] = aggregate
    outs = []
    for i, p in enumerate(params):
        h = apply_layer(kind, p, h, edges, last=i == len(params) - 1,
                        **kwargs)
        outs.append(h)
    return outs


def gnn_apply(params: List[dict], kind: str, h: torch.Tensor,
              edges: EdgeList, *, aggregate=None) -> torch.Tensor:
    """K-layer forward; last layer has no activation (logits)."""
    return gnn_apply_layers(params, kind, h, edges, aggregate=aggregate)[-1]


def num_layers(params) -> int:
    return len(params)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).to(torch.float32).mean()


def _sgd(params, loss_fn, steps: int, lr: float):
    """``steps`` full-batch SGD steps ``w - lr * g`` on every tensor of
    ``params`` (a list of dicts or a dict, updated in place); returns the
    last step's loss (before its update) as a 0-d tensor."""
    flat = [v.requires_grad_() for p in
            (params if isinstance(params, list) else [params])
            for v in p.values()]
    loss = None
    for _ in range(steps):
        loss = loss_fn()
        grads = torch.autograd.grad(loss, flat)
        with torch.no_grad():
            for v, g in zip(flat, grads):
                v.sub_(lr * g)
    for v in flat:
        v.requires_grad_(False)
    return loss.detach()


def train_node_classifier(generator: torch.Generator, kind: str, graph,
                          hidden: int = 64, steps: int = 120,
                          lr: float = 5e-3, num_layers_: int = 2, *,
                          init: Optional[Sequence[dict]] = None):
    """Full-batch training of a K-layer GNN node classifier. Small graphs
    only (used to produce trained weights for the accuracy benchmarks).

    Starts from ``gnn_init(generator, ...)``, or from ``init`` (per-layer
    dicts of arrays or tensors, copied: e.g. the JAX package's init), and
    runs on the generator's device. Returns ``(params, final_loss)``:
    detached float32 tensors that ``Engine((params, kind))`` takes, and
    the last step's loss."""
    if graph.labels is None:
        raise ValueError("train_node_classifier needs a labelled graph")
    device = generator.device
    nc = int(graph.labels.max()) + 1
    dims = [graph.feature_dim] + [hidden] * (num_layers_ - 1) + [nc]
    params = (gnn_init(generator, kind, dims) if init is None
              else params_from_numpy(init, device))
    edges = EdgeList.from_graph(graph, device=device)
    h0 = torch.as_tensor(graph.features, dtype=torch.float32, device=device)
    y = torch.as_tensor(graph.labels, dtype=torch.int64, device=device)
    loss = _sgd(params, lambda: cross_entropy(
        gnn_apply(params, kind, h0, edges), y), steps, lr)
    return params, float(loss)


# ----------------------------------------------------------------------------
# ASTGCN-lite: spatial-temporal forecasting model (case study §IV-C).
#
# Faithful skeleton of Guo et al. AAAI'19: temporal attention + spatial
# attention + graph convolution + temporal convolution, predicting
# T_out=12 future flow values per sensor. Chebyshev convolution is
# approximated by the first-order GCN aggregation (K=1), which is the
# standard simplification (Kipf & Welling).
# ----------------------------------------------------------------------------

def astgcn_init(generator: torch.Generator, num_features: int, t_in: int,
                t_out: int, hidden: int = 32) -> Dict[str, torch.Tensor]:
    """Weights drawn from ``generator`` (normals scaled by
    sqrt(2 / (fan_in + fan_out)), the reference's scale), biases 0, on the
    generator's device."""
    device = generator.device

    def glorot(shape):
        return torch.randn(shape, generator=generator, device=device) * (
            2.0 / sum(shape[-2:])) ** 0.5

    def zeros(n):
        return torch.zeros((n,), device=device)
    return {
        # temporal attention over the T_in axis
        "ta_q": glorot((num_features, hidden)),
        "ta_k": glorot((num_features, hidden)),
        # spatial gcn
        "gc_w": glorot((num_features, hidden)),
        "gc_b": zeros(hidden),
        # temporal conv (kernel 3, same padding) over time
        "tc_w": glorot((3 * hidden, hidden)),
        "tc_b": zeros(hidden),
        # output head: all T_in x hidden -> t_out
        "out_w": glorot((t_in * hidden, t_out)),
        "out_b": zeros(t_out),
    }


def astgcn_spatial_sum(x: torch.Tensor, edges: EdgeList) -> torch.Tensor:
    """[T, V, F] -> [T, V, F]: every timestep's neighbour sum in one
    gather-and-sum over the [V, T * F] table. Each column is summed in the
    edge list's fixed order, so this is bitwise T sums of width F."""
    t, v, f = x.shape
    a = aggregate_sum(x.permute(1, 0, 2).reshape(v, t * f), edges)
    return a.reshape(v, t, f).permute(1, 0, 2)


def astgcn_apply(params, history, edges: EdgeList) -> torch.Tensor:
    """history: [T_in, V, F] (a tensor, or an array; taken to the params'
    dtype and device) -> forecast [T_out, V]."""
    w = params["gc_w"]
    x = torch.as_tensor(history, dtype=w.dtype, device=w.device)
    t_in, v, f = x.shape
    # Temporal attention: weight timesteps per vertex.
    q = torch.einsum("tvf,fh->tvh", x, params["ta_q"])
    k = torch.einsum("tvf,fh->tvh", x, params["ta_k"])
    att = torch.einsum("tvh,svh->vts", q, k) / math.sqrt(q.shape[-1])
    att = torch.softmax(att, dim=-1)                      # [V, T, T]
    x = torch.einsum("vts,svf->tvf", att, x)
    # Spatial graph convolution, every timestep in one sum.
    a = astgcn_spatial_sum(x, edges)
    z = (a + x) / (masked_degree(edges) + 1.0)[:, None]
    x = torch.relu(z @ params["gc_w"] + params["gc_b"])  # [T, V, H]
    # Temporal convolution (kernel=3, same) via unfold.
    xp = F.pad(x, (0, 0, 0, 0, 1, 1))
    stacked = torch.cat([xp[:-2], xp[1:-1], xp[2:]], dim=-1)  # [T,V,3H]
    x = torch.relu(stacked @ params["tc_w"] + params["tc_b"])  # [T,V,H]
    # Head: flatten time, predict T_out flows.
    flat = x.permute(1, 0, 2).reshape(v, -1)              # [V, T*H]
    out = flat @ params["out_w"] + params["out_b"]        # [V, T_out]
    return out.T                                          # [T_out, V]


def train_astgcn(generator: torch.Generator, tg, steps: int = 200,
                 lr: float = 1e-3, hidden: int = 32, *,
                 init: Optional[dict] = None):
    """Train ASTGCN-lite on a PeMS-style window (z-scored targets) on the
    generator's device, from ``astgcn_init(generator, ...)`` or from
    ``init`` (a dict of arrays or tensors, copied). Returns ``(params,
    (mu, sd), final_loss)``."""
    device = generator.device
    g = tg.graph
    edges = EdgeList.from_graph(g, device=device)
    hist = torch.as_tensor(tg.history, dtype=torch.float32, device=device)
    mu, sd = float(tg.target.mean()), float(tg.target.std() + 1e-6)
    y = torch.as_tensor((tg.target - mu) / sd, dtype=torch.float32,
                        device=device)
    if init is None:
        params = astgcn_init(generator, hist.shape[-1], hist.shape[0],
                             y.shape[0], hidden)
    else:
        params = params_from_numpy([init], device)[0]
    loss = _sgd(params, lambda: torch.mean(
        (astgcn_apply(params, hist, edges) - y) ** 2), steps, lr)
    return params, (mu, sd), float(loss)


def forecast_errors(pred: np.ndarray, target: np.ndarray) -> Dict[str, float]:
    """MAE / RMSE / MAPE as in paper Table V."""
    pred = np.asarray(pred, np.float64)
    target = np.asarray(target, np.float64)
    err = pred - target
    mae = float(np.abs(err).mean())
    rmse = float(np.sqrt((err ** 2).mean()))
    mape = float((np.abs(err) / np.maximum(np.abs(target), 1e-6)).mean() * 100)
    return {"mae": mae, "rmse": rmse, "mape": mape}


class GNN(nn.Module):
    """A K-layer GNN holding its per-layer parameters.

    ``GNN(kind, dims, generator)`` draws fresh weights with ``gnn_init``;
    ``GNN.from_params(params, kind)`` wraps an existing parameter list.
    ``params`` returns the plain per-layer dict list the layer functions
    and ``ModelSpec`` take.
    """

    def __init__(self, kind: str, dims: Optional[Sequence[int]] = None,
                 generator: Optional[torch.Generator] = None, *,
                 params: Optional[List[dict]] = None):
        super().__init__()
        if kind not in LAYER_FNS:
            raise ValueError(f"unknown GNN kind {kind!r}; "
                             f"available: {', '.join(sorted(LAYER_FNS))}")
        if params is None:
            if dims is None or generator is None:
                raise ValueError("GNN needs dims and a generator, or params")
            params = gnn_init(generator, kind, dims)
        self.kind = kind
        self.layers = nn.ModuleList(
            nn.ParameterDict({
                k: nn.Parameter(torch.as_tensor(v, dtype=torch.float32),
                                requires_grad=False)
                for k, v in p.items()}) for p in params)

    @classmethod
    def from_params(cls, params: List[dict], kind: str) -> "GNN":
        return cls(kind, params=params)

    @property
    def params(self) -> List[dict]:
        return [{k: v.detach() for k, v in layer.items()}
                for layer in self.layers]

    def forward(self, h: torch.Tensor, edges: EdgeList, *,
                aggregate=None) -> torch.Tensor:
        return gnn_apply(self.params, self.kind, h, edges,
                         aggregate=aggregate)
