"""GNN layers in PyTorch, matching the paper's Table I inference functions.

All layers consume COO edge lists (senders, receivers) plus an edge mask
(0 for padding edges) and aggregate with a fixed-order gather-and-sum:
each receiver's source rows, gathered straight from the source table, in
edge order, from 0, with no atomics and no message tensor
(``kernels.segment_sum``), so a sum is the same on every run, and on the
CPU it is the serial ``index_add_`` of the messages. Aggregation can be
routed through the block-CSR SpMM kernels (see repro_torch.kernels.ops) by
the executor, which then hands the layer its neighbour sum
(``apply_layer``'s ``a_sum``).

  GCN       a_v = sum_{u in N(v)} h_u
            h_v = sigma(W . (a_v + h_v) / (|N(v)| + 1))
  GAT       a_v = sum_{u in N(v) u {v}} alpha_vu W h_u ;  h_v = sigma(a_v)
  GraphSAGE a_v = mean_{u in N(v)} h_u ; h_v = sigma(W . [a_v, h_v])

GAT's softmax, scores to coefficients, is one call of
``kernels.edge_softmax`` over the receiver order (one launch on the card;
on the CPU its plain version, a chain of PyTorch ops), whose coefficients
weight the messages inside the sum. GAT's layer has H attention heads (H
= 1 in the ``gat`` kind's models);
``gat_heads`` is the multi-head model of Velickovic et al. (ICLR 2018,
arXiv 1710.10903, Section 3.3): its hidden layers concatenate their heads
and add an identity skip where the widths allow, its last layer averages
its heads.

Layers take one [V, F] table; ``apply_layer``, the one layer step of
every program, also takes a stacked [B, V, F] micro-batch and runs it
example by example.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.edge_softmax import edge_softmax
from repro_torch.kernels.segment_sum import (LongSegments, Transposed,
                                             cached_long_segments,
                                             receiver_order, segment_sum)
from repro_torch.runtime.trace import span


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


def _mean_of(a_sum: torch.Tensor, edges: EdgeList) -> torch.Tensor:
    """A neighbour sum as the mean over the receivers' masked degrees."""
    return a_sum / torch.clamp_min(masked_degree(edges), 1.0)[:, None]


def aggregate_mean(h: torch.Tensor, edges: EdgeList,
                   h_src: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _mean_of(aggregate_sum(h, edges, h_src), edges)


# ----------------------------------------------------------------------------
# GCN
# ----------------------------------------------------------------------------

def gcn_init(generator: torch.Generator, in_dim: int, out_dim: int):
    return {"w": _glorot(generator, (in_dim, out_dim)),
            "b": torch.zeros((out_dim,), dtype=torch.float32,
                             device=generator.device)}


def gcn_layer(params, h, edges: EdgeList, *, activation=torch.relu,
              aggregate=aggregate_sum, h_src=None, a_sum=None):
    """Paper Table I GCN row (sum aggregate, mean-with-self update);
    ``a_sum``, a neighbour sum already computed, is the aggregate."""
    a = aggregate(h, edges, h_src) if a_sum is None else a_sum
    deg = masked_degree(edges)
    z = (a + h) / (deg + 1.0)[:, None]
    out = z @ params["w"] + params["b"]
    return activation(out) if activation is not None else out


# ----------------------------------------------------------------------------
# GAT (H heads a layer)
# ----------------------------------------------------------------------------

#: kinds whose layers attend over N(v) u {v}: their edge lists carry one
#: self edge a vertex.
SELF_LOOP_KINDS = ("gat", "gat_heads")


def gat_init(generator: torch.Generator, in_dim: int, out_dim: int,
             heads: int = 1, concat: bool = True):
    """One GAT layer of ``heads`` heads: ``w`` [in, H * D] and each head's
    attention vectors ``att_src``, ``att_dst`` [H, D] (Glorot over each
    head's [1, D]), D = out / H where the heads are concatenated
    (``concat``: a hidden layer) and D = out where they are averaged (the
    last layer). At one head this is the draw of a [1, out] vector."""
    d = out_dim // heads if concat else out_dim
    if concat and d * heads != out_dim:
        raise ValueError(f"{heads} concatenated heads do not divide the "
                         f"width {out_dim}")
    return {"w": _glorot(generator, (in_dim, heads * d)),
            "att_src": _glorot(generator, (heads, 1, d)).reshape(heads, d),
            "att_dst": _glorot(generator, (heads, 1, d)).reshape(heads, d)}


def _scores(z: torch.Tensor, att: torch.Tensor) -> torch.Tensor:
    """Every head's score a^k . z^k of the rows of z [N, H * D], row-major
    [N, H], or [N] at one head."""
    heads = att.shape[0]
    scores = (z.view(z.shape[0], heads, -1) * att).sum(-1)
    return scores[:, 0] if heads == 1 else scores


def _mean_heads(a: torch.Tensor, heads: int) -> torch.Tensor:
    """[V, H * D] -> [V, D]: the heads added in order k = 0 .. H - 1, then
    one division (nothing at one head)."""
    if heads == 1:
        return a
    parts = a.view(a.shape[0], heads, -1).unbind(1)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total / heads


def gat_layer(params, h, edges: EdgeList, *, activation=F.elu, h_src=None,
              skip: bool = False):
    """One GAT layer with H heads (H and D read from ``att_src`` [H, D]):
    per head k, z^k = h W^k, e^k_vu = leaky_relu(a^k_src . z^k_u + a^k_dst
    . z^k_v, 0.2) over N(v) u {v}, alpha^k = softmax_u(e^k) and s^k_v =
    sum_u alpha^k_vu z^k_u. A hidden layer returns activation(s^0 || ..
    || s^{H-1} [+ h, with ``skip`` where h is as wide]); the last layer
    (``activation=None``) the mean of its heads. ``h_src`` is the table
    the senders index into (then ``edges`` carries the self edges)."""
    heads = params["att_src"].shape[0]
    wh = h @ params["w"]                                # [P, H*D] (local)
    wh_src = wh if h_src is None else h_src @ params["w"]
    # Self loops: include v in its own neighborhood (Table I: N_v u {v}),
    # unless the caller indexes a different source table.
    if h_src is None:
        edges = edges.self_looped
    with span("attention"):
        alpha_src = _scores(wh_src, params["att_src"])  # [M, H]
        alpha_dst = _scores(wh, params["att_dst"])      # [P, H]
        # Segment softmax over each receiver's incoming edges, per head
        # (``kernels.edge_softmax``: one pass over the receiver order).
        coef = edge_softmax(alpha_src, alpha_dst, edges)  # [E, H]
    # The messages wh_src[s] * coef, gathered and weighted per head inside
    # the sum.
    a = _segment_sum(wh_src, edges, idx=edges.gather, w=coef)
    if activation is None:
        return _mean_heads(a, heads)
    if skip and h.shape[-1] == a.shape[-1]:
        a = a + h
    return activation(a)


# ----------------------------------------------------------------------------
# GraphSAGE (mean aggregate version, Table I)
# ----------------------------------------------------------------------------

def sage_init(generator: torch.Generator, in_dim: int, out_dim: int):
    return {"w": _glorot(generator, (2 * in_dim, out_dim)),
            "b": torch.zeros((out_dim,), dtype=torch.float32,
                             device=generator.device)}


def sage_layer(params, h, edges: EdgeList, *, activation=torch.relu,
               aggregate=aggregate_mean, h_src=None, a_sum=None):
    """Table I GraphSAGE row; ``a_sum``, a neighbour sum already
    computed, becomes the mean aggregate over the masked degrees."""
    a = aggregate(h, edges, h_src) if a_sum is None else _mean_of(a_sum,
                                                                  edges)
    # The [a | h] @ W update as two explicit matmuls, one reduction order
    # for every caller.
    f = h.shape[-1]
    out = a @ params["w"][:f] + h @ params["w"][f:] + params["b"]
    if activation is not None:
        out = activation(out)
    # L2 normalize as in GraphSAGE inference.
    norm = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
    return out / torch.clamp_min(norm, 1e-12)


#: ``gat`` and ``gat_heads`` share the layer: both run whatever heads the
#: weights hold (``gat``'s drawn models have one), and only ``gat_heads``
#: adds the skip.
LAYER_FNS = {"gcn": (gcn_init, gcn_layer),
             "gat": (gat_init, gat_layer),
             "gat_heads": (gat_init, functools.partial(gat_layer, skip=True)),
             "sage": (sage_init, sage_layer)}


def apply_layer(kind: str, p, h, edges: EdgeList, *, last: bool,
                h_src=None, a_sum=None, **kw):
    """Layer ``kind`` with params ``p`` over ``edges`` on ``h``, one
    [V, F] table or a stacked [B, V, F] micro-batch: the one layer step of
    the single program, the mesh and ``gnn_apply_layers``.

    The layer aggregates for itself (``h_src``: the table the senders
    index into, one per example of a stack; ``kw``: the layer's own
    keywords, such as ``aggregate``), or takes ``a_sum``, a neighbour sum
    a kernel launch already computed (one per example of a stack). The
    ``last`` layer has no activation. A stack runs example by example,
    each the serial op sequence at the serial shapes (a batched product
    may pick another algorithm and differ in the last bits), so a batched
    result is its serial one bit for bit.
    """
    if h.ndim == 3:
        none = [None] * len(h)
        return torch.stack([
            apply_layer(kind, p, hh, edges, last=last, h_src=src, a_sum=a,
                        **kw)
            for hh, src, a in zip(h, none if h_src is None else h_src,
                                  none if a_sum is None else a_sum)])
    if a_sum is not None:
        kw["a_sum"] = a_sum
    if last:
        kw["activation"] = None
    return LAYER_FNS[kind][1](p, h, edges, h_src=h_src, **kw)


def apply_layer_with_sum(kind: str, p, h, edges: EdgeList, a_sum, *,
                         last: bool):
    """One GCN/SAGE layer given its neighbour SUM ``a_sum`` (the dense tail
    of the kernel path; see ``apply_layer``)."""
    return apply_layer(kind, p, h, edges, last=last, a_sum=a_sum)
