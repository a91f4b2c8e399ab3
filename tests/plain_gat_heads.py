"""The plain reference of the multi-head GAT (``gat_heads``): the model of
Velickovic et al., Graph Attention Networks (ICLR 2018, arXiv 1710.10903,
Section 3.3), as the port states it, in plain torch and float64 with
``index_add_``. It imports neither JAX nor any module of the port.

A layer with weights ``w`` [Fi, H * D] and ``att_src``, ``att_dst`` [H, D]:

    z^k    = h W^k                                 (W = w viewed [Fi, H, D])
    e^k_vu = leaky_relu(a^k_src . z^k_u + a^k_dst . z^k_v, 0.2)
             over u in N(v) u {v}
    alpha^k_vu = softmax_u(e^k_vu)
    s^k_v  = sum_u alpha^k_vu z^k_u
    hidden layer: h'_v = elu(s^0_v || .. || s^{H-1}_v  [+ h_v where Fi = H D])
    last layer:   h'_v = (s^0_v + .. + s^{H-1}_v) / H

The last layer returns logits: the paper's sigmoid is left to the caller.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


def layer(p: dict, h: torch.Tensor, senders, receivers, num_vertices: int,
          *, last: bool) -> torch.Tensor:
    """One layer in float64 over the directed edges (senders -> receivers),
    with one self edge a vertex appended."""
    h = h.double()
    w, a_src, a_dst = (p[k].double() for k in ("w", "att_src", "att_dst"))
    heads, d = a_src.shape
    v = num_vertices
    loop = torch.arange(v)
    s = torch.cat([torch.as_tensor(np.asarray(senders)).long(), loop])
    r = torch.cat([torch.as_tensor(np.asarray(receivers)).long(), loop])
    z = (h @ w).view(v, heads, d)
    score_src = (z * a_src).sum(-1)                 # [V, H]
    score_dst = (z * a_dst).sum(-1)
    logits = F.leaky_relu(score_src[s] + score_dst[r], 0.2)
    top = torch.full((v, heads), -torch.inf, dtype=torch.float64)
    top = top.scatter_reduce(0, r[:, None].expand(-1, heads), logits,
                             "amax", include_self=False)
    ex = torch.exp(logits - top[r])
    den = torch.zeros((v, heads), dtype=torch.float64).index_add_(0, r, ex)
    coef = ex / den[r]
    out = torch.zeros((v, heads, d), dtype=torch.float64)
    out.index_add_(0, r, z[s] * coef[:, :, None])
    if last:
        total = out[:, 0]
        for k in range(1, heads):
            total = total + out[:, k]
        return total / heads
    out = out.reshape(v, heads * d)
    if h.shape[1] == heads * d:
        out = out + h
    return F.elu(out)


def forward(params: Sequence[dict], x, senders, receivers,
            num_vertices: int) -> torch.Tensor:
    """[V, F] features -> [V, D] averaged logits of the last layer."""
    h = torch.as_tensor(np.asarray(x)).double()
    for i, p in enumerate(params):
        h = layer(p, h, senders, receivers, num_vertices,
                  last=i == len(params) - 1)
    return h
