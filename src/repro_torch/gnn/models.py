"""Full GNN models: K-layer stacks of Table-I layers.

Parameters are a list of per-layer dicts of float32 tensors, the layout of
the JAX reference's parameter pytrees; ``GNN`` wraps such a list in an
``nn.Module``. ``params_from_numpy`` carries weights across from numpy.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.gnn.layers import EdgeList, LAYER_FNS


def gnn_init(generator: torch.Generator, kind: str,
             dims: Sequence[int]) -> List[dict]:
    """dims = [in, hidden..., out]; returns the per-layer param list, on
    the generator's device, drawn from ``generator`` in layer order."""
    init_fn, _ = LAYER_FNS[kind]
    return [init_fn(generator, dims[i], dims[i + 1])
            for i in range(len(dims) - 1)]


def params_from_numpy(params, device="cpu") -> List[dict]:
    """Per-layer dicts of arrays (numpy, or anything ``np.asarray`` takes)
    -> the port's per-layer dicts of float32 tensors on ``device``."""
    return [{k: torch.tensor(np.asarray(v, np.float32), device=device)
             for k, v in p.items()} for p in params]


def gnn_apply_layers(params: List[dict], kind: str, h: torch.Tensor,
                     edges: EdgeList, *, aggregate=None
                     ) -> List[torch.Tensor]:
    """K-layer forward returning every layer's output, h^1 .. h^K."""
    _, layer_fn = LAYER_FNS[kind]
    n = len(params)
    outs = []
    for i, p in enumerate(params):
        kwargs = {}
        if aggregate is not None and kind in ("gcn", "sage"):
            kwargs["aggregate"] = aggregate
        if i == n - 1:
            h = layer_fn(p, h, edges, activation=None, **kwargs)
        else:
            h = layer_fn(p, h, edges, **kwargs)
        outs.append(h)
    return outs


def gnn_apply(params: List[dict], kind: str, h: torch.Tensor,
              edges: EdgeList, *, aggregate=None) -> torch.Tensor:
    """K-layer forward; last layer has no activation (logits)."""
    return gnn_apply_layers(params, kind, h, edges, aggregate=aggregate)[-1]


def num_layers(params) -> int:
    return len(params)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).to(torch.float32).mean()


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
