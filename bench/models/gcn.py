"""GCN, as the port states it (``gnn/layers.py``, Table I of the paper):

  a_v = sum_{u in N(v)} h_u;
  h_v' = relu(((a_v + h_v) / (|N(v)| + 1)) W + b)

with no activation after the last layer. Weights a layer: ``w`` [Fi, Fo]
(Glorot) and ``b`` [Fo] (zero). The 8-bit halo wire is modelled: a message
whose source and receiver sit on different fogs carries the source row as
the wire delivers it (``reference.wire_roundtrip``), and the last layer,
linear in its messages, bounds what codes on a rounding edge can move
(``wire_slack``).
"""
from __future__ import annotations

import math

import torch

import reference


def weight_shapes(model: dict):
    """[(layer, name, shape, glorot limit)] in draw order."""
    dims = model["dims"]
    out = []
    for li, (fi, fo) in enumerate(zip(dims[:-1], dims[1:])):
        out.append((li, "w", (fi, fo), math.sqrt(6.0 / (fi + fo))))
        out.append((li, "b", (fo,), 0.0))
    return out


def layer(p, h, g: reference.Graph, *, last: bool, wire: bool, tf32: bool):
    msg = h[g.s]
    if wire:
        msg = torch.where(g.cross[:, None], reference.wire_roundtrip(h)[g.s],
                          msg)
    a = torch.zeros_like(h).index_add_(0, g.r, msg)
    z = (a + h) / (g.deg.to(h.dtype) + 1.0)[:, None]
    out = reference.mm(z, p["w"], tf32) + p["b"]
    return out if last else torch.relu(out)


def wire_slack(p, h, g: reference.Graph) -> torch.Tensor:
    """The last layer's ``reference.wire_slack`` through its weight."""
    return reference.wire_slack(h, p["w"], g)


def forward_flops(model: dict, vertices: int, edges: int) -> float:
    """Operations of one full-graph forward (f32), counted from the edges
    and the widths, a layer: the neighbour sum (one add an edge a feature),
    the self add and the division (two a vertex a feature), the product
    (2 V Fi Fo) and the bias."""
    dims = model["dims"]
    total = 0.0
    for fi, fo in zip(dims[:-1], dims[1:]):
        total += edges * fi + 2.0 * vertices * fi \
            + 2.0 * vertices * fi * fo + vertices * fo
    return total
