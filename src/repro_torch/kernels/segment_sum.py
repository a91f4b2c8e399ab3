"""Fixed-order segment sum on Hopper: the port's ``"segment_sum"``
aggregation (and GAT's only path) without atomics.

``receiver_order`` sorts a COO edge list's edges stably by receiver once
per layout and device (``gnn.layers.EdgeList`` calls it where an edge list
is built, leaving out the masked padding edges); ``segment_sum`` then sums
each receiver's messages in that order, starting from 0. ``order`` indexes
the rows of ``x``; each of its entries must be below ``len(x)``. On a CUDA tensor it launches the kernel of
``csrc/segment_sum.cu`` (one warp per receiver, lanes over features, f32
adds left to right); on a CPU tensor it runs the plain version
(``kernels.ref.segment_sum_ref``). Both give the floats of a serial
``index_add_`` into zeros in edge order, so the result is the same on
every run and for every example of a batch.

The kernel counts its launches in ``segment_sum.launches``, raised by one
at every launch and nowhere else.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref

_P, _I = ctypes.c_void_p, ctypes.c_int
#: C signature of segment_sum_launch: x, order, offsets, out,
#: num_segments, features, stream.
_SIGNATURE = [_P] * 4 + [_I] * 2 + [_P]


def _kernel():
    fn = build.load("segment_sum").segment_sum_launch
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURE
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


def segment_sum(x: torch.Tensor, order: torch.Tensor,
                offsets: torch.Tensor) -> torch.Tensor:
    """x [E] or [E, F] -> [V] or [V, F], V = len(offsets) - 1: each
    segment's rows ``x[order[offsets[v]:offsets[v + 1]]]`` summed left to
    right from 0. On the CPU any float dtype runs the plain version; the
    kernel takes float32."""
    if x.ndim not in (1, 2):
        raise ValueError(f"segment_sum takes x [E] or [E, F], got "
                         f"{tuple(x.shape)}")
    if order.ndim == 1 and order.shape[0] > x.shape[0]:
        raise ValueError(f"segment_sum: {order.shape[0]} entries in order "
                         f"for {x.shape[0]} rows of x")
    for name, t in (("order", order), ("offsets", offsets)):
        if t.device != x.device or t.dtype != torch.int32 or t.ndim != 1:
            raise ValueError(f"segment_sum: {name} must be 1-d int32 on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if x.device.type == "cpu":
        return ref.segment_sum_ref(x, order, offsets)
    if x.device.type != "cuda":
        raise ValueError(f"segment_sum runs on cuda or cpu, not {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"segment_sum on cuda takes float32, got {x.dtype}")
    v = offsets.shape[0] - 1
    feats = 1 if x.ndim == 1 else x.shape[1]
    xc, oc, fc = x.contiguous(), order.contiguous(), offsets.contiguous()
    out = torch.empty((v,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(_P(xc.data_ptr()), _P(oc.data_ptr()),
                        _P(fc.data_ptr()), _P(out.data_ptr()), v, feats,
                        _P(stream))
        segment_sum.launches += 1
    if err != 0:
        raise RuntimeError(f"segment_sum launch failed: cudaError {err}")
    return out


segment_sum.launches = 0
