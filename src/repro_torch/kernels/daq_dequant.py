"""DAQ dequantization on Hopper: standalone, and fused into block-CSR
aggregation.

The mesh executor's halo rows cross the wire as 8-bit codes plus one f32
(scale, min) pair per row (paper §III-D's degree-aware quantization,
applied to the BSP exchange). ``dequant_spmm`` aggregates straight from
those codes. Its CUDA kernel (``csrc/block_spmm.cu``, the block-CSR row
walker with a dequantizing row loader) reads no tiles: it walks the
operand's row-compacted nonzeros (``rows``, a
``gather_aggregate.TileRows``), gathers each entry's codes and its source
row's (scale, min), and builds ``codes * scale[row] + min[row]`` in
registers, so the dense f32 table never exists in device memory. Its
floats are ``block_spmm`` over the plain dequantized table, bit for bit.
``dequant_spmm_batched`` does the same over a [B, S, F] stack of codes in
one launch, each ``out[b]`` bitwise ``dequant_spmm`` on example ``b``.
``dequant`` writes the dense f32 table itself (``ops.dequantize_features``),
with the same two roundings.

CUDA tensors launch the kernel on the current stream, and the fused
products need ``rows`` there; CPU tensors take the dense plain versions
(``kernels.ref``). Each wrapper counts its launches in a plain integer
attribute (``dequant_spmm.launches``), raised by one at every launch and
nowhere else; the fused products also count their launches over a
``RowSubset`` in ``subset_launches``. While a profiler records, each call
is the span ``fog.kernel.<wrapper>`` (``runtime.trace``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.gather_aggregate import (_NEEDS_ROWS, RowSubset,
                                                  TileRows, _check_operands,
                                                  _check_rows, _check_tensor,
                                                  _count, _kernel, _launch,
                                                  _out, _ptr, _raise_on)
from repro_torch.runtime.trace import span

#: code dtypes the kernels take -> bytes per code.
CODE_BYTES = {torch.uint8: 1, torch.uint16: 2, torch.uint32: 4}


def _check(blocks, block_cols, block_mask, codes, scales, mins,
           batched: bool, max_col: Optional[int],
           rows: Union[None, TileRows, RowSubset]) -> None:
    _check_operands(blocks, block_cols, block_mask, codes, batched, max_col,
                    h_name="codes", h_dtypes=tuple(CODE_BYTES))
    for name, t in (("scales", scales), ("mins", mins)):
        _check_tensor(name, t, (torch.float32,), codes.device)
        if tuple(t.shape) != tuple(codes.shape[:-1]):
            raise ValueError(f"{name} must be {tuple(codes.shape[:-1])} "
                             f"(one per source row), got {tuple(t.shape)}")
    if rows is not None:
        _check_rows(rows, blocks, codes)


def dequant_spmm(blocks: torch.Tensor, block_cols: torch.Tensor,
                 block_mask: torch.Tensor, codes: torch.Tensor,
                 scales: torch.Tensor, mins: torch.Tensor, *,
                 rows: Union[None, TileRows, RowSubset] = None,
                 max_col: Optional[int] = None) -> torch.Tensor:
    """out = A @ (codes * scales[:, None] + mins[:, None]), fused.

    Same block layout as ``gather_aggregate.block_spmm``, rectangular
    sources included: ``codes`` uint{8,16,32}[S, F] is the source table (S
    a multiple of 128 covering every ``block_cols`` entry) and
    ``scales``/``mins`` are its f32[S] row parameters. Zero-padded rows
    (code 0, scale 0, min 0) contribute exactly 0. ``max_col`` is the
    largest entry of ``block_cols`` when the caller knows it. CUDA tensors
    launch the kernel over ``rows``, the operand's ``compact_block_csr``
    (required there, built once per layout); CPU tensors take the dense
    plain version. A ``RowSubset`` computes only its rows, as in
    ``block_spmm``.
    """
    with span("kernel.dequant_spmm"):
        _check(blocks, block_cols, block_mask, codes, scales, mins, False,
               max_col, rows)
        if codes.device.type == "cpu":
            if isinstance(rows, RowSubset):
                return ref.dequant_spmm_subset_ref(blocks, block_cols,
                                                   block_mask, codes, scales,
                                                   mins, rows.blocks)
            return ref.dequant_spmm_ref(blocks, block_cols, block_mask, codes,
                                        scales, mins)
        if codes.device.type != "cuda":
            raise ValueError(f"dequant_spmm runs on cuda or cpu, not "
                             f"{codes.device}")
        if rows is None:
            raise ValueError(_NEEDS_ROWS.format("dequant_spmm"))
        out = _out(rows, (rows.n_rows, codes.shape[1]), codes.device)
        err = _launch("dequant_spmm_launch", rows, (codes, scales, mins), out,
                      last=(CODE_BYTES[codes.dtype],))
        _count(dequant_spmm, rows)
        _raise_on(err, "dequant_spmm")
        return out


def dequant_spmm_batched(blocks: torch.Tensor, block_cols: torch.Tensor,
                         block_mask: torch.Tensor, codes: torch.Tensor,
                         scales: torch.Tensor, mins: torch.Tensor, *,
                         rows: Union[None, TileRows, RowSubset] = None,
                         max_col: Optional[int] = None) -> torch.Tensor:
    """out[b] = A @ dequant(codes[b]) for codes [B, S, F] and f32[B, S]
    row parameters, one launch. Each ``out[b]`` is bitwise
    ``dequant_spmm(..., codes[b], scales[b], mins[b])``. ``rows`` as for
    ``dequant_spmm`` (a row subset included)."""
    with span("kernel.dequant_spmm_batched"):
        _check(blocks, block_cols, block_mask, codes, scales, mins, True,
               max_col, rows)
        if codes.device.type == "cpu":
            if isinstance(rows, RowSubset):
                return ref.dequant_spmm_batched_subset_ref(
                    blocks, block_cols, block_mask, codes, scales, mins,
                    rows.blocks)
            return ref.dequant_spmm_batched_ref(blocks, block_cols, block_mask,
                                                codes, scales, mins)
        if codes.device.type != "cuda":
            raise ValueError(f"dequant_spmm_batched runs on cuda or cpu, not "
                             f"{codes.device}")
        if rows is None:
            raise ValueError(_NEEDS_ROWS.format("dequant_spmm_batched"))
        b, _, f = codes.shape
        out = _out(rows, (b, rows.n_rows, f), codes.device)
        err = _launch("dequant_spmm_batched_launch", rows,
                      (codes, scales, mins), out, b,
                      last=(CODE_BYTES[codes.dtype],))
        _count(dequant_spmm_batched, rows)
        _raise_on(err, "dequant_spmm_batched")
        return out


def dequant(codes: torch.Tensor, scales: torch.Tensor, mins: torch.Tensor, *,
            v_tile: int = 256, f_tile: int = 128) -> torch.Tensor:
    """Row-wise linear dequantization: out[v, f] = codes[v, f] * scales[v]
    + mins[v], f32[V, F], for codes uint{8,16,32}[V, F] and f32[V] row
    parameters.

    ``v_tile``/``f_tile`` are the reference's tile sizes: V and F must be
    multiples of them (after ``min`` with V and F), as there; the CUDA
    kernel itself takes any shape of fewer than 2^31 elements (pass
    ``v_tile=V, f_tile=F`` to send a table untiled).
    """
    with span("kernel.dequant"):
        _check_tensor("codes", codes, tuple(CODE_BYTES), codes.device)
        if codes.ndim != 2:
            raise ValueError(f"codes must be [V, F], got {tuple(codes.shape)}")
        v, f = codes.shape
        for name, t in (("scales", scales), ("mins", mins)):
            _check_tensor(name, t, (torch.float32,), codes.device)
            if tuple(t.shape) != (v,):
                raise ValueError(f"{name} must be ({v},) (one per row), got "
                                 f"{tuple(t.shape)}")
        v_tile, f_tile = min(v_tile, v), min(f_tile, f)
        if v_tile < 1 or f_tile < 1 or v % v_tile or f % f_tile:
            raise ValueError(f"codes {tuple(codes.shape)} must tile by "
                             f"({v_tile}, {f_tile})")
        if codes.device.type == "cpu":
            return ref.dequant_ref(codes, scales, mins)
        if codes.device.type != "cuda":
            raise ValueError(f"dequant runs on cuda or cpu, not "
                             f"{codes.device}")
        if v * f >= 2 ** 31:
            raise ValueError(f"dequant on cuda takes fewer than 2^31 codes, "
                             f"got {tuple(codes.shape)}")
        out = torch.empty((v, f), dtype=torch.float32, device=codes.device)
        with torch.cuda.device(codes.device):
            stream = torch.cuda.current_stream(codes.device).cuda_stream
            err = _kernel("dequant_launch")(
                _ptr(codes), _ptr(scales), _ptr(mins), _ptr(out), v, f,
                CODE_BYTES[codes.dtype], ctypes.c_void_p(stream))
            dequant.launches += 1
        _raise_on(err, "dequant")
        return out


dequant_spmm.launches = 0
dequant_spmm.subset_launches = 0
dequant_spmm_batched.launches = 0
dequant_spmm_batched.subset_launches = 0
dequant.launches = 0
