"""GNN layers in PyTorch, matching the paper's Table I inference functions.

All layers consume COO edge lists (senders, receivers) plus an edge mask
(0 for padding edges) and aggregate with ``index_add_``. Aggregation can be
routed through the block-CSR SpMM kernels (see repro_torch.kernels.ops) by
the executor, which then runs only the dense tail here
(``apply_layer_with_sum``).

  GCN       a_v = sum_{u in N(v)} h_u
            h_v = sigma(W . (a_v + h_v) / (|N(v)| + 1))
  GAT       a_v = sum_{u in N(v) u {v}} alpha_vu W h_u ;  h_v = sigma(a_v)
  GraphSAGE a_v = mean_{u in N(v)} h_u ; h_v = sigma(W . [a_v, h_v])

Layers take one [V, F] table; ``apply_layer_with_sum`` also takes a
stacked [B, V, F] micro-batch and runs the dense tail example by example.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F


def _glorot(generator: torch.Generator, shape) -> torch.Tensor:
    fan_in, fan_out = shape[-2], shape[-1]
    lim = float(np.sqrt(6.0 / (fan_in + fan_out)))
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=generator.device)
    return u * (2.0 * lim) - lim


class EdgeList(NamedTuple):
    """COO connectivity on one device."""
    senders: torch.Tensor    # int32[E]
    receivers: torch.Tensor  # int32[E]
    mask: torch.Tensor       # float32[E] — 0 for padding edges
    num_vertices: int

    @classmethod
    def from_graph(cls, g, pad_to: Optional[int] = None,
                   device="cpu") -> "EdgeList":
        s, r = g.senders, g.receivers
        mask = np.ones(len(s), np.float32)
        if pad_to is not None and pad_to > len(s):
            pad = pad_to - len(s)
            sink = g.num_vertices - 1
            s = np.concatenate([s, np.full(pad, sink, s.dtype)])
            r = np.concatenate([r, np.full(pad, sink, r.dtype)])
            mask = np.concatenate([mask, np.zeros(pad, np.float32)])
        return cls(torch.as_tensor(s, dtype=torch.int32, device=device),
                   torch.as_tensor(r, dtype=torch.int32, device=device),
                   torch.as_tensor(mask, device=device), g.num_vertices)


def _segment_sum(x: torch.Tensor, segments: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    out = x.new_zeros((num_segments,) + tuple(x.shape[1:]))
    return out.index_add_(0, segments, x)


def masked_degree(edges: EdgeList) -> torch.Tensor:
    """float32[V] in-degree under the edge mask."""
    return _segment_sum(edges.mask, edges.receivers, edges.num_vertices)


def aggregate_sum(h: torch.Tensor, edges: EdgeList,
                  h_src: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a_v = sum_{u in N(v)} h_u via gather + ``index_add_``.

    ``h_src`` (defaults to ``h``) is the table senders index into.
    """
    src = h if h_src is None else h_src
    msgs = src[edges.senders] * edges.mask[:, None]
    return _segment_sum(msgs, edges.receivers, edges.num_vertices)


def aggregate_mean(h: torch.Tensor, edges: EdgeList,
                   h_src: Optional[torch.Tensor] = None) -> torch.Tensor:
    deg = masked_degree(edges)
    return aggregate_sum(h, edges, h_src) / torch.clamp_min(deg, 1.0)[:, None]


# ----------------------------------------------------------------------------
# GCN
# ----------------------------------------------------------------------------

def gcn_init(generator: torch.Generator, in_dim: int, out_dim: int):
    return {"w": _glorot(generator, (in_dim, out_dim)),
            "b": torch.zeros((out_dim,), dtype=torch.float32,
                             device=generator.device)}


def gcn_layer(params, h, edges: EdgeList, *, activation=torch.relu,
              aggregate=aggregate_sum, h_src=None):
    """Paper Table I GCN row (sum aggregate, mean-with-self update)."""
    a = aggregate(h, edges, h_src)
    deg = masked_degree(edges)
    z = (a + h) / (deg + 1.0)[:, None]
    out = z @ params["w"] + params["b"]
    return activation(out) if activation is not None else out


# ----------------------------------------------------------------------------
# GAT (single head per layer)
# ----------------------------------------------------------------------------

def gat_init(generator: torch.Generator, in_dim: int, out_dim: int):
    return {"w": _glorot(generator, (in_dim, out_dim)),
            "att_src": _glorot(generator, (1, out_dim)),
            "att_dst": _glorot(generator, (1, out_dim))}


def gat_layer(params, h, edges: EdgeList, *, activation=F.elu, h_src=None):
    wh = h @ params["w"]                                # [P, D] (local)
    wh_src = wh if h_src is None else h_src @ params["w"]
    alpha_src = (wh_src * params["att_src"]).sum(-1)    # [M]
    alpha_dst = (wh * params["att_dst"]).sum(-1)        # [P]
    v = edges.num_vertices
    # Self loops: include v in its own neighborhood (Table I: N_v u {v}),
    # unless the caller indexes a different source table.
    if h_src is None:
        v_ids = torch.arange(v, dtype=edges.senders.dtype,
                             device=edges.senders.device)
        s = torch.cat([edges.senders, v_ids])
        r = torch.cat([edges.receivers, v_ids])
        m = torch.cat([edges.mask, torch.ones(v, dtype=torch.float32,
                                              device=edges.mask.device)])
    else:
        s, r, m = edges.senders, edges.receivers, edges.mask
    logits = F.leaky_relu(alpha_src[s] + alpha_dst[r], 0.2)
    logits = torch.where(m > 0, logits, -torch.inf)
    # Segment softmax over each receiver's incoming edges; receivers with
    # no edge keep -inf and are zeroed by the isfinite guard.
    seg_max = torch.full((v,), -torch.inf, dtype=logits.dtype,
                         device=logits.device)
    seg_max = seg_max.scatter_reduce(0, r.long(), logits, "amax",
                                     include_self=False)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    ex = torch.where(m > 0, torch.exp(logits - seg_max[r]), 0.0)
    denom = _segment_sum(ex, r, v)
    coef = ex / torch.clamp_min(denom[r], 1e-16)
    msgs = wh_src[s] * coef[:, None]
    a = _segment_sum(msgs, r, v)
    return activation(a) if activation is not None else a


# ----------------------------------------------------------------------------
# GraphSAGE (mean aggregate version, Table I)
# ----------------------------------------------------------------------------

def sage_init(generator: torch.Generator, in_dim: int, out_dim: int):
    return {"w": _glorot(generator, (2 * in_dim, out_dim)),
            "b": torch.zeros((out_dim,), dtype=torch.float32,
                             device=generator.device)}


def sage_layer(params, h, edges: EdgeList, *, activation=torch.relu,
               aggregate=aggregate_mean, h_src=None):
    a = aggregate(h, edges, h_src)
    # The [a | h] @ W update as two explicit matmuls, one reduction order
    # for every caller.
    f = h.shape[-1]
    out = a @ params["w"][:f] + h @ params["w"][f:] + params["b"]
    if activation is not None:
        out = activation(out)
    # L2 normalize as in GraphSAGE inference.
    norm = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
    return out / torch.clamp_min(norm, 1e-12)


LAYER_FNS = {"gcn": (gcn_init, gcn_layer),
             "gat": (gat_init, gat_layer),
             "sage": (sage_init, sage_layer)}


def apply_layer_with_sum(kind: str, p, h, edges: EdgeList, a_sum, *,
                         last: bool):
    """Apply one GCN/SAGE layer given its precomputed neighbor SUM.

    The dense tail of the kernel path: the neighbor sum ``a_sum`` has
    already been computed by one (possibly batched) SpMM launch, and only
    the cheap dense update remains. ``h``/``a_sum`` are one [V, F] table
    or a stacked [B, V, F] micro-batch; the stacked case runs the update
    example by example, which keeps every example's matmuls the serial
    ones (a batched product may pick another algorithm and differ in the
    last bits) and so keeps batched == serial bitwise. SAGE's mean
    normalization is applied here, from the masked degree.
    """
    _, layer_fn = LAYER_FNS[kind]
    kwargs = {"activation": None} if last else {}

    def apply_one(hh, aa):
        if kind == "sage":               # SAGE aggregates the mean
            def hook(h_, edges_, h_src_=None, _aa=aa):
                deg = masked_degree(edges_)
                return _aa / torch.clamp_min(deg, 1.0)[:, None]
        else:
            def hook(h_, edges_, h_src_=None, _aa=aa):
                return _aa
        return layer_fn(p, hh, edges, aggregate=hook, **kwargs)

    if h.ndim == 3:
        return torch.stack([apply_one(hh, aa) for hh, aa in zip(h, a_sum)])
    return apply_one(h, a_sum)
