"""GAT with several heads a layer, the inductive PPI model of Velickovic
et al. (ICLR 2018, arXiv 1710.10903, Section 3.3), as the port states it
(``gnn/layers.py``, kind ``gat_heads``). A layer of H heads of width D:

  z^k = h W^k;  e^k_vu = leaky_relu(a^k_src . z^k_u + a^k_dst . z^k_v, 0.2)
  over N(v) u {v};  alpha^k = softmax_u(e^k);  s^k_v = sum_u alpha^k_vu z^k_u

A hidden layer returns elu(s^0 || .. || s^{H-1} [+ h where h is H * D
wide: the identity skip]), the last layer the mean of its heads (added in
head order, then one division), logits with no sigmoid. The model's
``dims`` give each layer's input width and the output width, ``heads``
each layer's head count: a hidden layer's width is its heads times D.
Weights a layer: ``w`` [Fi, H * D] (Glorot), ``att_src``, ``att_dst``
[H, D] (Glorot over each head's [1, D]). The halo rows cross in float32:
the 8-bit wire is not modelled.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

import reference

#: float64 elements of one block of messages (512 MB): a layer's edges are
#: weighted and added in blocks of this many values, in edge order.
BLOCK = 1 << 26


def layer_shapes(model: dict):
    """[(Fi, H, D)] of each layer."""
    dims, heads = model["dims"], model["heads"]
    n = len(dims) - 1
    if len(heads) != n:
        raise ValueError(f"{len(heads)} head counts for {n} layers")
    out = []
    for li in range(n):
        h = heads[li]
        if li < n - 1 and dims[li + 1] % h:
            raise ValueError(f"layer {li}: {h} concatenated heads do not "
                             f"divide the width {dims[li + 1]}")
        out.append((dims[li], h, dims[li + 1] // h if li < n - 1
                    else dims[li + 1]))
    return out


def weight_shapes(model: dict):
    """[(layer, name, shape, glorot limit)] in draw order."""
    out = []
    for li, (fi, h, d) in enumerate(layer_shapes(model)):
        out.append((li, "w", (fi, h * d), math.sqrt(6.0 / (fi + h * d))))
        lim = math.sqrt(6.0 / (1 + d))
        out.append((li, "att_src", (h, d), lim))
        out.append((li, "att_dst", (h, d), lim))
    return out


def layer(p, h, g: reference.Graph, *, last: bool, wire: bool, tf32: bool):
    heads, d = p["att_src"].shape
    z = reference.mm(h, p["w"], tf32)                      # [V, H*D]
    zh = z.view(g.v, heads, d)
    a_src = torch.stack([reference.mm(zh[:, k], p["att_src"][k, :, None],
                                      tf32)[:, 0] for k in range(heads)], 1)
    a_dst = torch.stack([reference.mm(zh[:, k], p["att_dst"][k, :, None],
                                      tf32)[:, 0] for k in range(heads)], 1)
    s, r = g.s_loop, g.r_loop
    logits = F.leaky_relu(a_src[s] + a_dst[r], 0.2)        # [E, H]
    top = torch.full((g.v, heads), -torch.inf, dtype=h.dtype,
                     device=h.device)
    top = top.scatter_reduce(0, r[:, None].expand(-1, heads), logits,
                             "amax", include_self=False)
    ex = torch.exp(logits - top[r])
    den = torch.zeros((g.v, heads), dtype=h.dtype,
                      device=h.device).index_add_(0, r, ex)
    coef = ex / den[r]
    out = torch.zeros((g.v, heads, d), dtype=h.dtype, device=h.device)
    step = max(1, BLOCK // (heads * d))
    for e0 in range(0, s.shape[0], step):
        blk = slice(e0, e0 + step)
        out.index_add_(0, r[blk], zh[s[blk]] * coef[blk, :, None])
    if last:
        total = out[:, 0]
        for k in range(1, heads):
            total = total + out[:, k]
        return total / heads
    out = out.view(g.v, heads * d)
    if h.shape[1] == heads * d:
        out = out + h
    return F.elu(out)


def forward_flops(model: dict, vertices: int, edges: int) -> float:
    """Operations of one full-graph forward (f32), counted from the edges
    and the widths, a layer of H heads of width D: the product (2 V Fi H
    D), the two attention scores (2 V H D each), over the E + V edges
    with self loops the score, leaky ReLU, max, subtraction, exponent,
    sum and division (7 an edge a head) and the weighted messages (2 H D
    an edge), then the skip's add (V H D, where the input is H * D wide)
    or the last layer's mean (H - 1 adds and a division: V H D)."""
    total = 0.0
    shapes = layer_shapes(model)
    for li, (fi, h, d) in enumerate(shapes):
        e = edges + vertices
        total += 2.0 * vertices * fi * h * d + 4.0 * vertices * h * d \
            + 7.0 * e * h + 2.0 * e * h * d
        if li == len(shapes) - 1 or fi == h * d:
            total += vertices * h * d
    return total
