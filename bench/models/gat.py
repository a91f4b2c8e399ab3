"""GAT with one attention head, as the port states it (``gnn/layers.py``,
Table I of the paper):

  e_vu = leaky_relu(a_src . W h_u + a_dst . W h_v, 0.2) over N(v) u {v},
  alpha = softmax_u(e_vu);  h_v' = elu(sum_u alpha_vu W h_u)

with no activation after the last layer. Weights a layer: ``w`` [Fi, Fo]
and ``att_src``, ``att_dst`` [1, Fo] (Glorot). The halo rows cross in
float32: the 8-bit wire is not modelled.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

import reference


def weight_shapes(model: dict):
    """[(layer, name, shape, glorot limit)] in draw order."""
    if model.get("heads", 1) != 1:
        raise ValueError(f"this GAT has one head, not {model['heads']}: a "
                         f"multi-head model brings a file of its own")
    dims = model["dims"]
    out = []
    for li, (fi, fo) in enumerate(zip(dims[:-1], dims[1:])):
        out.append((li, "w", (fi, fo), math.sqrt(6.0 / (fi + fo))))
        lim = math.sqrt(6.0 / (1 + fo))
        out.append((li, "att_src", (1, fo), lim))
        out.append((li, "att_dst", (1, fo), lim))
    return out


def layer(p, h, g: reference.Graph, *, last: bool, wire: bool, tf32: bool):
    wh = reference.mm(h, p["w"], tf32)
    a_src = reference.mm(wh, p["att_src"].T, tf32)[:, 0]
    a_dst = reference.mm(wh, p["att_dst"].T, tf32)[:, 0]
    s, r = g.s_loop, g.r_loop
    logits = F.leaky_relu(a_src[s] + a_dst[r], 0.2)
    top = torch.full((g.v,), -torch.inf, dtype=h.dtype, device=h.device)
    top = top.scatter_reduce(0, r, logits, "amax", include_self=False)
    ex = torch.exp(logits - top[r])
    den = torch.zeros(g.v, dtype=h.dtype, device=h.device).index_add_(0, r,
                                                                       ex)
    coef = ex / den[r]
    out = torch.zeros((g.v, wh.shape[1]), dtype=h.dtype, device=h.device)
    out.index_add_(0, r, wh[s] * coef[:, None])
    return out if last else F.elu(out)


def forward_flops(model: dict, vertices: int, edges: int) -> float:
    """Operations of one full-graph forward (f32), counted from the edges
    and the widths, a layer: the product (2 V Fi Fo), the two attention
    scores (2 V Fo each), then over the E + V edges with self loops the
    score, leaky ReLU, max, subtraction, exponent, sum and division (7 an
    edge) and the weighted messages (2 Fo an edge)."""
    dims = model["dims"]
    total = 0.0
    for fi, fo in zip(dims[:-1], dims[1:]):
        e = edges + vertices
        total += 2.0 * vertices * fi * fo + 4.0 * vertices * fo \
            + 7.0 * e + 2.0 * e * fo
    return total
