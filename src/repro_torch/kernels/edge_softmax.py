"""GAT's edge softmax over the receiver order, in one launch on the card.

``edge_softmax(a_src, a_dst, edges)`` turns a GAT layer's scores into its
attention coefficients, per head, over the edge list's unmasked edges::

    l_e        = leaky_relu(a_src[s_e, h] + a_dst[r_e, h], 0.2)
    m_v        = max of l_e over v's edges, or 0 where that is not finite
    d_v        = +0 + exp(l_e0 - m_v) + exp(l_e1 - m_v) + ...
    coef[e, h] = exp(l_e - m_v) / clamp_min(d_v, 1e-16)

with v = r_e, the denominators summed left to right over v's segment of
the receiver order, as ``segment_sum`` sums them. ``a_src`` [M, H] and
``a_dst`` [V, H] are row-major score tables ([M] and [V] at one head); the
coefficients come out [E, H] (or [E]), edge-major, which is what
``segment_sum``'s ``w`` reads.

On a CUDA tensor it launches ``edge_softmax_kernel`` of
``csrc/segment_sum.cu``: one pass over the order (``EdgeList.order``,
``gather``, ``offsets``), no atomics and no fill, and masked edges neither
read nor written (their coefficients are whatever the output held; the sum
reads only the order's). On a CPU tensor it runs the plain version
(``kernels.ref.edge_softmax_ref``), the PyTorch chain, in which masked
edges get 0. The two give the same floats on the order's entries.

The call is differentiable (``torch.autograd.Function``): its backward
recomputes the plain chain on the tensors' device, its denominators through
the differentiable ``segment_sum``, and differentiates that, so the
gradients are those of the chain. The kernel counts its launches in
``edge_softmax.launches``, raised by one at every launch and nowhere else.
While a profiler records, each call (launch or plain version) is the span
``fog.kernel.edge_softmax`` (``runtime.trace``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.segment_sum import segment_sum
from repro_torch.runtime.trace import span

_P, _I = ctypes.c_void_p, ctypes.c_int
#: C signature of edge_softmax_launch: a_src, a_dst, order, gather,
#: offsets, long_segs, n_long, long_threshold, coef, num_segments, entries,
#: heads, stream.
_SIGNATURE = [_P] * 6 + [_I] * 2 + [_P] + [_I] * 3 + [_P]
#: The kernel's heads a call (a template parameter of each).
MAX_HEADS = 8
#: Segments past ``LongSegments(offsets, LONG_FEATURES)``'s threshold get a
#: CTA of their own on the card (the long list of a one-float sum).
LONG_FEATURES = 1


def _kernel():
    fn = build.load("segment_sum").edge_softmax_launch
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
    return fn


def _total(edges):
    """The denominators' sum of the backward's recomputed chain: the
    layer's ``segment_sum`` over the order, with the list's long segments
    and transposed order (``gnn.layers._segment_sum`` without ``idx``)."""
    def total(x):
        feats = 1 if x.ndim == 1 else x.shape[1]
        return segment_sum(x, edges.order, edges.offsets,
                           long=edges.long_segments(feats),
                           transposed=functools.partial(
                               edges.transposed, x.shape[0], True))
    return total


def _plain(a_src, a_dst, edges, total=None):
    return ref.edge_softmax_ref(a_src, a_dst, edges.senders, edges.receivers,
                                edges.mask, edges.order, edges.offsets,
                                total)


def _softmax(a_src: torch.Tensor, a_dst: torch.Tensor, edges):
    """The checked call on the scores' device: the plain version on the
    CPU, the kernel (counted) on CUDA."""
    with span("kernel.edge_softmax"):
        if a_src.device.type == "cpu":
            return _plain(a_src, a_dst, edges)
        if a_src.device.type != "cuda":
            raise ValueError(f"edge_softmax runs on cuda or cpu, not "
                             f"{a_src.device}")
        if a_src.dtype != torch.float32:
            raise TypeError(f"edge_softmax on cuda takes float32, got "
                            f"{a_src.dtype}")
        heads = 1 if a_src.ndim == 1 else a_src.shape[1]
        if heads > MAX_HEADS:
            raise ValueError(f"edge_softmax on cuda takes at most "
                             f"{MAX_HEADS} heads, got {heads}")
        longs = edges.long_segments(LONG_FEATURES)
        v = edges.offsets.shape[0] - 1
        entries = edges.senders.shape[0]
        src, dst, order, gather, offsets, long_ids = (
            t.contiguous() for t in (a_src, a_dst, edges.order,
                                     edges.gather, edges.offsets, longs.ids))
        coef = torch.empty((entries,) + tuple(a_src.shape[1:]),
                           dtype=torch.float32, device=a_src.device)
        with torch.cuda.device(a_src.device):
            stream = torch.cuda.current_stream(a_src.device).cuda_stream
            err = _kernel()(
                _P(src.data_ptr()), _P(dst.data_ptr()), _P(order.data_ptr()),
                _P(gather.data_ptr()), _P(offsets.data_ptr()),
                _P(long_ids.data_ptr()), long_ids.shape[0], longs.threshold,
                _P(coef.data_ptr()), v, entries, heads, _P(stream))
            edge_softmax.launches += 1
        if err != 0:
            raise RuntimeError(f"edge_softmax launch failed: cudaError {err}")
        return coef


class _EdgeSoftmax(torch.autograd.Function):
    """``edge_softmax`` with the gradients of the plain chain: the backward
    recomputes it on the scores' device (its denominators one
    ``segment_sum`` launch on the card, and one more for their gradient)
    and differentiates it."""

    @staticmethod
    def forward(ctx, a_src, a_dst, edges):
        ctx.save_for_backward(a_src, a_dst)
        ctx.edges = edges
        return _softmax(a_src, a_dst, edges)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a_src, a_dst = ctx.saved_tensors
        with torch.enable_grad():
            src = a_src.detach().requires_grad_()
            dst = a_dst.detach().requires_grad_()
            coef = _plain(src, dst, ctx.edges, _total(ctx.edges))
            g_src, g_dst = torch.autograd.grad(coef, (src, dst), g)
        return (g_src if ctx.needs_input_grad[0] else None,
                g_dst if ctx.needs_input_grad[1] else None, None)


def _check(a_src: torch.Tensor, a_dst: torch.Tensor, edges) -> None:
    if a_src.ndim not in (1, 2) or a_dst.ndim != a_src.ndim or \
            a_src.shape[1:] != a_dst.shape[1:]:
        raise ValueError(f"edge_softmax takes a_src [M] and a_dst [V], or "
                         f"[M, H] and [V, H], got {tuple(a_src.shape)} and "
                         f"{tuple(a_dst.shape)}")
    if a_dst.shape[0] != edges.offsets.shape[0] - 1:
        raise ValueError(f"edge_softmax: a_dst has {a_dst.shape[0]} rows "
                         f"for {edges.offsets.shape[0] - 1} receivers")
    if a_src.dtype != a_dst.dtype or a_src.device != a_dst.device:
        raise ValueError(f"edge_softmax: a_src {a_src.dtype} on "
                         f"{a_src.device} and a_dst {a_dst.dtype} on "
                         f"{a_dst.device} differ")
    for name in ("order", "offsets", "gather", "senders", "receivers"):
        t = getattr(edges, name)
        if t.device != a_src.device or t.dtype != torch.int32 or t.ndim != 1:
            raise ValueError(f"edge_softmax: {name} must be 1-d int32 on "
                             f"{a_src.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if edges.gather.shape != edges.order.shape:
        raise ValueError(f"edge_softmax: gather {tuple(edges.gather.shape)} "
                         f"and order {tuple(edges.order.shape)} differ")


def edge_softmax(a_src: torch.Tensor, a_dst: torch.Tensor,
                 edges) -> torch.Tensor:
    """a_src [M] or [M, H], a_dst [V] or [V, H] (V = ``edges``' receivers)
    -> coef [E] or [E, H] over the E edges of ``edges``, a ``gnn.layers.
    EdgeList`` (its senders index a_src's rows; its order, gather, offsets
    and long segments drive the kernel; its transposed orders the
    backward). On the CPU any float dtype runs the plain version; the
    kernel takes float32 and at most MAX_HEADS heads. Where autograd wants
    a gradient of a score table the call goes through ``_EdgeSoftmax``."""
    _check(a_src, a_dst, edges)
    if torch.is_grad_enabled() and (a_src.requires_grad
                                    or a_dst.requires_grad):
        return _EdgeSoftmax.apply(a_src, a_dst, edges)
    return _softmax(a_src, a_dst, edges)


edge_softmax.launches = 0
