"""GNN layers in PyTorch, matching the paper's Table I inference functions.

All layers consume COO edge lists (senders, receivers) plus an edge mask
(0 for padding edges) and aggregate with a fixed-order gather-and-sum:
each receiver's source rows, gathered straight from the source table, in
edge order, from 0, with no atomics and no message tensor
(``kernels.segment_sum``), so a sum is the same on every run, and on the
CPU it is the serial ``index_add_`` of the messages. Aggregation can be
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

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.segment_sum import (LongSegments, Transposed,
                                             cached_long_segments,
                                             receiver_order, segment_sum)


def _glorot(generator: torch.Generator, shape) -> torch.Tensor:
    fan_in, fan_out = shape[-2], shape[-1]
    lim = float(np.sqrt(6.0 / (fan_in + fan_out)))
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=generator.device)
    return u * (2.0 * lim) - lim


class _Edges(NamedTuple):
    senders: torch.Tensor    # int32[E]
    receivers: torch.Tensor  # int32[E]
    mask: torch.Tensor       # float32[E] — 0 for padding edges
    num_vertices: int
    order: torch.Tensor      # int32: unmasked edges sorted by receiver
    offsets: torch.Tensor    # int32[V + 1]: receiver v's slice of order


class EdgeList(_Edges):
    """COO connectivity on one device, with the receivers' summation order
    (``kernels.segment_sum.receiver_order`` over the unmasked edges),
    computed once where the edge list is built unless given; the gather
    index, the long segments, the degrees and the transposed orders of a
    backward are derived from it once, on first use. Masked edges carry no
    message: they are left out of every sum and every gradient, so an inf
    or NaN in a masked edge's source row does not reach its receiver (the
    reference's ``segment_sum`` of ``src * 0`` would add NaN). The mask
    holds only 0 and 1 (checked here)."""

    def __new__(cls, senders, receivers, mask, num_vertices: int,
                order=None, offsets=None):
        if not bool(((mask == 0) | (mask == 1)).all()):
            raise ValueError("EdgeList: the edge mask must hold only 0 and 1")
        if order is None:
            order, offsets = receiver_order(receivers, num_vertices, mask)
        return super().__new__(cls, senders, receivers, mask, num_vertices,
                               order, offsets)

    @functools.cached_property
    def gather(self) -> torch.Tensor:
        """int32[E']: the source row of each entry of the order,
        ``senders[order]``."""
        return self.senders[self.order.long()].int()

    @functools.cached_property
    def _long(self) -> dict:
        return {}

    def long_segments(self, features: int) -> LongSegments:
        """The receivers whose sums of rows of ``features`` floats get a
        CTA of their own on the card (``kernels.segment_sum.LongSegments``
        of these offsets), built once per threshold."""
        return cached_long_segments(self._long, self.offsets, features)

    @functools.cached_property
    def _transposed(self) -> dict:
        return {}

    def transposed(self, rows: int, per_edge: bool = False) -> Transposed:
        """The transposed order of this list's sums over a table of
        ``rows`` rows gathered by ``gather`` (``per_edge``: over one row per
        edge, gathered by the order): what a sum's backward sums over
        (``kernels.segment_sum.Transposed``), built once per table on the
        first backward."""
        key = (rows, per_edge)
        if key not in self._transposed:
            self._transposed[key] = Transposed(
                self.order, self.offsets,
                self.order if per_edge else self.gather, rows)
        return self._transposed[key]

    @functools.cached_property
    def degree(self) -> torch.Tensor:
        """float32[V]: each receiver's count of unmasked edges, read from
        the offsets of the order. Counts are integers below 2^24, so this
        is bitwise the float sum of the 0/1 mask in any order."""
        return (self.offsets[1:] - self.offsets[:-1]).float()

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

    def into(self, dirty: torch.Tensor) -> "EdgeList":
        """These edges with every edge into a receiver where ``dirty``
        (bool[V]) is False masked out, in an edge list of its own (its own
        order and degrees): a dirty receiver keeps its whole incoming edge
        sequence, so its sums and its degree are this list's, bit for
        bit (a frontier layer's edges)."""
        return EdgeList(self.senders, self.receivers,
                        self.mask * dirty[self.receivers.long()],
                        self.num_vertices)

    @functools.cached_property
    def self_looped(self) -> "EdgeList":
        """These edges, then one self edge per vertex (GAT's N(v) u {v}),
        with their own order; built once per edge list."""
        v_ids = torch.arange(self.num_vertices, dtype=self.senders.dtype,
                             device=self.senders.device)
        ones = torch.ones(self.num_vertices, dtype=torch.float32,
                          device=self.mask.device)
        return EdgeList(torch.cat([self.senders, v_ids]),
                        torch.cat([self.receivers, v_ids]),
                        torch.cat([self.mask, ones]), self.num_vertices)


def _segment_sum(x: torch.Tensor, edges: EdgeList,
                 idx: Optional[torch.Tensor] = None,
                 w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each receiver's terms ``(w[e] *) x[idx[k]]`` (e the edge of entry k
    of the order; ``idx`` defaults to the order, one row of ``x`` per
    edge) summed in edge order; differentiable, its backward summing over
    the edge list's cached transposed order."""
    feats = 1 if x.ndim == 1 else x.shape[1]
    return segment_sum(x, edges.order, edges.offsets, idx=idx, w=w,
                       long=edges.long_segments(feats),
                       transposed=functools.partial(
                           edges.transposed, x.shape[0], idx is None))


def masked_degree(edges: EdgeList) -> torch.Tensor:
    """float32[V] in-degree under the edge mask: ``edges.degree``, the
    counts of the order, computed once per edge list. The mask holds only
    0 and 1 (``EdgeList`` checks it), so these are the floats of the
    reference's sum of the mask."""
    return edges.degree


def aggregate_sum(h: torch.Tensor, edges: EdgeList,
                  h_src: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a_v = sum_{u in N(v)} h_u by the fixed-order gather-and-sum over the
    source table (no message rows are built).

    ``h_src`` (defaults to ``h``) is the table senders index into. Only
    unmasked edges are summed (see ``EdgeList``).
    """
    src = h if h_src is None else h_src
    return _segment_sum(src, edges, idx=edges.gather)


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
        edges = edges.self_looped
    s, r, m = edges.senders, edges.receivers, edges.mask
    logits = F.leaky_relu(alpha_src[s] + alpha_dst[r], 0.2)
    logits = torch.where(m > 0, logits, -torch.inf)
    # Segment softmax over each receiver's incoming edges; receivers with
    # no edge keep -inf and are zeroed by the isfinite guard. The max is
    # exact in any order.
    seg_max = torch.full((v,), -torch.inf, dtype=logits.dtype,
                         device=logits.device)
    seg_max = seg_max.scatter_reduce(0, r.long(), logits, "amax",
                                     include_self=False)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    ex = torch.where(m > 0, torch.exp(logits - seg_max[r]), 0.0)
    denom = _segment_sum(ex, edges)
    coef = ex / torch.clamp_min(denom[r], 1e-16)
    # The messages wh_src[s] * coef, gathered and weighted inside the sum.
    a = _segment_sum(wh_src, edges, idx=edges.gather, w=coef)
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
