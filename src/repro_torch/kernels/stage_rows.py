"""The row gather that stages a micro-batch on the card.

``stage_rows(x, row_src)`` builds the folded [B, R, F] table that the
mesh's batched path runs on (``runtime.bsp._local_stack``) from the
caller's [B, S, F] stack as it was uploaded::

    out[b, r, :] = x[b, row_src[r], :]   where row_src[r] >= 0
    out[b, r, :] = +0.0                  where row_src[r] == -1 (padding)

``row_src`` is the layout's map from each folded row to the held vertex
it holds (``bsp._Layout.row_src``, built once per layout and device).
Pure data movement: the floats are the caller's, bit for bit, and a
padded slot holds +0.0, as the host scatter's zero fill
(``PartitionedGraph.feature_stack``) gave it.

On a CUDA tensor it launches the kernel of ``csrc/stage_rows.cu``, which
writes every output float once (no fill, no atomics); on a CPU tensor it
runs the plain version (``kernels.ref.stage_rows_ref``). The kernel counts
its launches in ``stage_rows.launches``, raised by one at every launch and
nowhere else. While a profiler records, each call (launch or plain
version) is the span ``fog.kernel.stage_rows`` (``runtime.trace``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.runtime.trace import span

_P, _I = ctypes.c_void_p, ctypes.c_int
#: C signature of stage_rows_launch: x, row_src, out, batch, rows,
#: src_rows, features, stream.
_SIGNATURE = [_P] * 3 + [_I] * 4 + [_P]
#: The kernel's indices are 32-bit: each table holds fewer floats.
_MAX_ELEMS = 2 ** 31


def _kernel():
    fn = build.load("stage_rows").stage_rows_launch
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, row_src: torch.Tensor) -> None:
    if x.ndim != 3:
        raise ValueError(f"stage_rows takes x [B, S, F], got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"stage_rows takes float32 x, got {x.dtype}")
    if (row_src.ndim != 1 or row_src.dtype != torch.int32
            or row_src.device != x.device):
        raise ValueError(f"stage_rows: row_src must be 1-d int32 on "
                         f"{x.device}, got {row_src.dtype} "
                         f"{tuple(row_src.shape)} on {row_src.device}")
    if not (x.is_contiguous() and row_src.is_contiguous()):
        raise ValueError("stage_rows: x and row_src must be contiguous")


def stage_rows(x: torch.Tensor, row_src: torch.Tensor) -> torch.Tensor:
    """x f32[B, S, F], row_src int32[R] (entries in -1 .. S - 1) ->
    f32[B, R, F]: row r of every example is source row ``row_src[r]``,
    or +0.0 where that is -1."""
    with span("kernel.stage_rows"):
        _check(x, row_src)
        if x.device.type == "cpu":
            return ref.stage_rows_ref(x, row_src)
        if x.device.type != "cuda":
            raise ValueError(f"stage_rows runs on cuda or cpu, not "
                             f"{x.device}")
        b, s, f = x.shape
        r = row_src.shape[0]
        if max(b * r * f, b * s * f) >= _MAX_ELEMS:
            raise ValueError(f"stage_rows: [{b}, {max(r, s)}, {f}] holds "
                             f"2^31 floats or more (32-bit indices)")
        out = torch.empty((b, r, f), dtype=torch.float32, device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _kernel()(_P(x.data_ptr()), _P(row_src.data_ptr()),
                            _P(out.data_ptr()), b, r, s, f, _P(stream))
            stage_rows.launches += 1
        if err != 0:
            raise RuntimeError(f"stage_rows launch failed: cudaError {err}")
        return out


stage_rows.launches = 0
