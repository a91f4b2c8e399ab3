"""Fixed-order gather-and-sum on Hopper: the port's ``"segment_sum"``
aggregation (and GAT's only path) without atomics and without a message
tensor.

``receiver_order`` sorts a COO edge list's edges stably by receiver once
per layout and device (``gnn.layers.EdgeList`` calls it where an edge list
is built, leaving out the masked padding edges), and ``LongSegments``
lists, from those offsets, the receivers whose segments are long enough
for a CTA of their own at a row width. ``segment_sum`` then sums each receiver's terms in that order,
starting from +0::

    out[v] = +0 + w[order[k0]] * x[idx[k0]] + w[order[k1]] * x[idx[k1]] ...

over ``k = offsets[v] .. offsets[v + 1] - 1``, each product rounded on its
own and each add in f32. ``idx`` (default ``order``) indexes the rows of
``x``, so a layer passes its source table with ``idx = senders[order]``
and no message rows are built; without ``w`` the row itself is added. On
a CUDA tensor it launches the kernel of ``csrc/segment_sum.cu``; on a CPU
tensor it runs the plain version (``kernels.ref.gather_segment_sum_ref``).
Both give the floats of a serial ``index_add_`` of the messages ``x[idx]
(* w)`` into zeros in edge order, so the result is the same on every run
and for every example of a batch.

The sum is differentiable (``torch.autograd.Function``). The transpose of
a gather-and-sum is the same gather-and-sum over the transposed order
(``Transposed``: the entries sorted stably by gather index, each entry's
segment as the gather index, ``w`` carried along), so the gradient for
``x`` is one more call of the same kernel on the card (the plain version on
the CPU); the gradient for ``w`` is a per-entry dot in plain PyTorch.

With ``w`` of shape [E, H] over rows of H * D floats the sum is per head
(a multi-head GAT layer's messages): head k's columns k*D .. k*D + D - 1
take the weight ``w[order[k], head]``, in the same order and rounding, in
one launch of ``headed_sum_kernel`` (plain version ``kernels.ref.
headed_segment_sum_ref``); at H = 1 the call is the weighted sum above.

The kernels count their launches in ``segment_sum.launches``, raised by
one at every launch and nowhere else; a launch for a gradient also raises
``segment_sum.backward_launches``, and a per-head launch
``segment_sum.headed_launches``. While a profiler records, each sum
(launch or plain version) is the span ``fog.kernel.segment_sum``, a
per-head one ``fog.kernel.headed_sum`` (``runtime.trace``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.runtime.trace import span

_P, _I = ctypes.c_void_p, ctypes.c_int
#: C signature of segment_sum_launch: x, idx, w, order, offsets,
#: long_segs, n_long, long_threshold, out, num_segments, features, stream.
_SIGNATURE = [_P] * 6 + [_I] * 2 + [_P] + [_I] * 2 + [_P]
#: C signature of headed_sum_launch: the same, then heads before stream.
_HEADED_SIGNATURE = [_P] * 6 + [_I] * 2 + [_P] + [_I] * 3 + [_P]

#: Segments of more entries than this get a CTA of their own on the card
#: when a row is one vector (F = 1, 2 or 4; SIoT: 470 of 16,216 receivers,
#: half of the edges; its hub has 2,631).
LONG_SEGMENT = 128
#: The same for wider rows: a long-segment CTA then costs more a row (a
#: shared-memory load an add) than the short path's lane group, so only
#: longer segments take one.
WIDE_LONG_SEGMENT = 256


def long_threshold(features: int) -> int:
    """The length past which a segment of rows of ``features`` floats
    gets a CTA of its own on the card."""
    return LONG_SEGMENT if features in (1, 2, 4) else WIDE_LONG_SEGMENT


def _kernel(name: str = "segment_sum_launch", signature=_SIGNATURE):
    fn = getattr(build.load("segment_sum"), name)
    if fn.argtypes is None:
        fn.argtypes = signature
        fn.restype = ctypes.c_int
    return fn


def receiver_order(receivers: torch.Tensor, num_segments: int,
                   mask: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order int32[E'], offsets int32[V + 1]): the edges stably sorted by
    receiver (edge order kept within a receiver) and each receiver's
    segment ``order[offsets[v]:offsets[v + 1]]``. With ``mask``, edges
    whose mask is 0 are left out, since a padded layout can route
    thousands of them to one receiver. Their messages are ``src * 0``:
    ±0 for a finite source row, and adding ±0 to a sum that starts at +0
    changes no bit. A masked edge whose source row holds inf or NaN
    contributes NaN to the reference's sum and nothing here: masked edges
    carry no message. Integer work only, so it is exact on any device."""
    r = receivers.long()
    kept = None if mask is None else torch.nonzero(mask).squeeze(1)
    if kept is not None:
        r = r[kept]
    order = torch.argsort(r, stable=True)
    if kept is not None:
        order = kept[order]
    counts = torch.bincount(r, minlength=num_segments)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return order.int(), offsets.int()


class LongSegments:
    """The receivers whose segments hold more than ``threshold`` entries
    (``long_threshold(features)``), longest first (ties by receiver), so
    that the longest chain starts first on the card, built from the
    ``offsets`` they belong to and bound to them: ``segment_sum`` takes it
    only with those offsets, since the kernel's lane groups skip every
    segment over the threshold and count on a CTA for each. Integer work
    only; built once per layout and threshold."""

    __slots__ = ("offsets", "threshold", "ids")

    def __init__(self, offsets: torch.Tensor, features: int):
        counts = offsets[1:].long() - offsets[:-1].long()
        self.offsets = offsets
        self.threshold = long_threshold(features)
        ids = torch.nonzero(counts > self.threshold).squeeze(1)
        self.ids = ids[torch.argsort(-counts[ids], stable=True)].int()


def cached_long_segments(cache: dict, offsets: torch.Tensor,
                         features: int) -> LongSegments:
    """``LongSegments(offsets, features)`` from ``cache`` (a dict kept
    beside those offsets, keyed by threshold), built on first use."""
    t = long_threshold(features)
    if t not in cache:
        cache[t] = LongSegments(offsets, features)
    return cache[t]


def _check_index(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device or t.dtype != torch.int32 or t.ndim != 1:
        raise ValueError(f"segment_sum: {name} must be 1-d int32 on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


class Transposed:
    """The transposed order of a gather-and-sum over a table of ``rows``
    rows: the entries of ``order`` sorted stably by their gather index
    ``idx`` (``order``), with offsets over the rows of the table
    (``offsets``), each entry's segment as its gather index (``idx``) and
    its order entry kept, so a weight ``w[order[k]]`` goes with it. The
    sum over it sends every segment's value back to the rows it gathered:
    row j gets ``(w[order[k]] *) g[v]`` summed over the entries k that
    gathered j, v the segment of k, in forward entry order. ``segment``
    holds each forward entry's segment (the w-gradient's gather index).
    Integer work only; built once per layout and table (``gnn.layers.
    EdgeList.transposed``), its ``LongSegments`` once per threshold: a
    row that many entries gather (a hub that sends) gets CTAs of its own
    on the card like a long forward segment."""

    __slots__ = ("order", "offsets", "idx", "segment", "_long")

    def __init__(self, order: torch.Tensor, offsets: torch.Tensor,
                 idx: torch.Tensor, rows: int):
        counts = offsets[1:].long() - offsets[:-1].long()
        segment = torch.repeat_interleave(
            torch.arange(counts.shape[0], device=counts.device), counts)
        by_row = torch.argsort(idx.long(), stable=True)
        self.order = order[by_row].contiguous()
        self.idx = segment[by_row].int()
        per_row = torch.bincount(idx.long(), minlength=rows)
        self.offsets = torch.cat([per_row.new_zeros(1),
                                  torch.cumsum(per_row, 0)]).int()
        self.segment = segment.int()
        self._long = {}

    def long_segments(self, features: int) -> LongSegments:
        return cached_long_segments(self._long, self.offsets, features)


def _sum(x, order, offsets, idx, w, long, backward: bool = False):
    """The checked sum on x's device: the plain version on the CPU, the
    kernel (counted) on CUDA; per head where ``w`` is [E, H]."""
    headed = w is not None and w.ndim == 2
    with span("kernel.headed_sum" if headed else "kernel.segment_sum"):
        if x.device.type == "cpu":
            if headed:
                return ref.headed_segment_sum_ref(x, idx, offsets, order, w)
            return ref.gather_segment_sum_ref(x, idx, offsets, order=order,
                                              w=w)
        if x.device.type != "cuda":
            raise ValueError(f"segment_sum runs on cuda or cpu, not "
                             f"{x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"segment_sum on cuda takes float32, got "
                            f"{x.dtype}")
        long_ids = offsets.new_zeros(0) if long is None else long.ids
        threshold = 0 if long is None else long.threshold
        v = offsets.shape[0] - 1
        feats = 1 if x.ndim == 1 else x.shape[1]
        xc, ic, oc, fc, lc = (t.contiguous() for t in (x, idx, order, offsets,
                                                       long_ids))
        wc = None if w is None else w.contiguous()
        out = torch.empty((v,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        args = [_P(xc.data_ptr()), _P(ic.data_ptr()),
                _P(None if wc is None else wc.data_ptr()),
                _P(oc.data_ptr()), _P(fc.data_ptr()), _P(lc.data_ptr()),
                lc.shape[0], threshold, _P(out.data_ptr()), v, feats]
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            if headed:
                err = _kernel("headed_sum_launch", _HEADED_SIGNATURE)(
                    *args, w.shape[1], _P(stream))
                segment_sum.headed_launches += 1
            else:
                err = _kernel()(*args, _P(stream))
            segment_sum.launches += 1
            if backward:
                segment_sum.backward_launches += 1
        if err != 0:
            raise RuntimeError(f"segment_sum launch failed: cudaError {err}")
        return out


class _SegmentSum(torch.autograd.Function):
    """``segment_sum`` with its gradients: for ``x`` the same sum over the
    transposed order (one launch on the card, the plain version on the
    CPU), for ``w`` the per-entry dot ``<x[idx[k]], g[v]>`` (plain
    PyTorch: a gather and a row sum; not a TPU kernel, the reference's
    gradient is XLA's). Entries outside the order (masked edges) get a
    zero gradient, and their source rows are never read, so an inf or NaN
    there reaches no gradient. Only inputs in ``needs_input_grad`` cost
    work."""

    @staticmethod
    def forward(ctx, x, w, order, offsets, idx, long, transposed):
        ctx.save_for_backward(x, w, order, offsets, idx)
        ctx.transposed = transposed
        return _sum(x, order, offsets, idx, w, long)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, w, order, offsets, idx = ctx.saved_tensors
        t = ctx.transposed()
        gx = gw = None
        if ctx.needs_input_grad[0]:
            feats = 1 if g.ndim == 1 else g.shape[1]
            gx = _sum(g, t.order, t.offsets, t.idx, w,
                      t.long_segments(feats), backward=True)
        if w is not None and ctx.needs_input_grad[1]:
            dots = (x.index_select(0, idx.long())
                    * g.index_select(0, t.segment.long()))
            if w.ndim == 2:      # per head: the dot over the head's columns
                dots = dots.view(dots.shape[0], w.shape[1], -1)
            if dots.ndim > w.ndim:
                dots = dots.sum(-1)
            gw = torch.zeros_like(w).index_copy_(0, order.long(), dots)
        return gx, gw, None, None, None, None, None


def segment_sum(x: torch.Tensor, order: torch.Tensor, offsets: torch.Tensor,
                *, idx: Optional[torch.Tensor] = None,
                w: Optional[torch.Tensor] = None,
                long: Optional[LongSegments] = None,
                transposed=None, backward: bool = False) -> torch.Tensor:
    """x [N] or [N, F] -> [V] or [V, F], V = len(offsets) - 1: each
    segment's terms ``(w[order[k]] *) x[idx[k]]`` over ``k = offsets[v] ..
    offsets[v + 1] - 1`` summed left to right from +0. ``idx`` defaults to
    ``order`` (x then holds one row per edge); every entry of ``idx`` must
    be below ``len(x)`` and, with ``w``, every entry of ``order`` below
    ``len(w)``; ``w`` [E, H] weighs head k's columns k*D .. k*D + D - 1 of
    rows of F = H * D floats (at H = 1 the call is the 1-d one). ``long``
    is ``LongSegments(offsets, F)`` of these very
    offsets (the CTAs of the long segments on the card; without it every
    segment is summed by a lane group, right but slow for a hub). On the
    CPU any float dtype runs the plain version; the kernel takes
    float32. Where autograd wants a gradient of ``x`` or ``w`` the call
    goes through ``_SegmentSum``, and then ``transposed`` is required: a
    callable that returns its ``Transposed`` (of these order, offsets, idx
    and ``len(x)``, built once and kept, as ``gnn.layers.EdgeList.
    transposed`` does) when a backward needs it. ``backward=True`` marks a
    call made for some other function's gradient (the embedding's): its
    launch also counts in ``backward_launches``."""
    if x.ndim not in (1, 2):
        raise ValueError(f"segment_sum takes x [E] or [E, F] (a source "
                         f"table's rows with idx), got {tuple(x.shape)}")
    idx = order if idx is None else idx
    for name, t in (("order", order), ("offsets", offsets), ("idx", idx)):
        _check_index(name, t, x.device)
    if idx.shape != order.shape:
        raise ValueError(f"segment_sum: idx {tuple(idx.shape)} and order "
                         f"{tuple(order.shape)} differ")
    if idx is order and order.shape[0] > x.shape[0]:
        raise ValueError(f"segment_sum: {order.shape[0]} entries in order "
                         f"for {x.shape[0]} rows of x")
    if w is not None and w.ndim == 2 and w.shape[1] == 1:
        w = w.reshape(-1)
    if w is not None and (w.ndim not in (1, x.ndim) or w.dtype != x.dtype
                          or w.device != x.device
                          or (w.ndim == 2 and x.shape[1] % w.shape[1])):
        raise ValueError(f"segment_sum: w must be 1-d, or [E, H] with H "
                         f"dividing the {tuple(x.shape[1:])} row, "
                         f"{x.dtype} on {x.device}, got {w.dtype} "
                         f"{tuple(w.shape)} on {w.device}")
    if long is not None and long.offsets is not offsets:
        raise ValueError("segment_sum: long was built for other offsets; "
                         "pass LongSegments(offsets, features) of these")
    if torch.is_grad_enabled() and (
            x.requires_grad or (w is not None and w.requires_grad)):
        if transposed is None:
            raise ValueError("segment_sum: a gradient is wanted, so pass "
                             "transposed= (e.g. functools.partial("
                             "EdgeList.transposed, len(x), idx is None))")
        return _SegmentSum.apply(x, w, order, offsets, idx, long, transposed)
    return _sum(x, order, offsets, idx, w, long, backward=backward)


segment_sum.launches = 0
segment_sum.backward_launches = 0
segment_sum.headed_launches = 0
