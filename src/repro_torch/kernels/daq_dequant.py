"""Block-CSR aggregation over DAQ-quantized features, on Hopper.

The mesh executor's halo rows cross the wire as 8-bit codes plus one f32
(scale, min) pair per row (paper §III-D's degree-aware quantization,
applied to the BSP exchange). ``dequant_spmm`` aggregates straight from
those codes: the CUDA kernel (``csrc/block_spmm.cu``, the block-CSR CTA
with a dequantizing panel loader) builds each source panel as
``codes * scale[row] + min[row]`` while staging it into shared memory, so
the dense f32 table never exists in device memory. ``dequant_spmm_batched``
does the same over a [B, S, F] stack of codes in one launch, each
``out[b]`` bitwise ``dequant_spmm`` on example ``b``.

CUDA tensors launch the kernel on the current stream; CPU tensors take the
plain versions (``kernels.ref``). Each wrapper counts its launches in a
plain integer attribute (``dequant_spmm.launches``), raised by one at
every launch and nowhere else.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.gather_aggregate import (BLOCK, _check_operands,
                                                  _check_tensor, _kernel,
                                                  _ptr, _raise_on)

#: code dtypes the kernels take -> bytes per code.
CODE_BYTES = {torch.uint8: 1, torch.uint16: 2, torch.uint32: 4}


def _check(blocks, block_cols, block_mask, codes, scales, mins,
           batched: bool, max_col: Optional[int]) -> None:
    _check_operands(blocks, block_cols, block_mask, codes, batched, max_col,
                    h_name="codes", h_dtypes=tuple(CODE_BYTES))
    for name, t in (("scales", scales), ("mins", mins)):
        _check_tensor(name, t, (torch.float32,), codes.device)
        if tuple(t.shape) != tuple(codes.shape[:-1]):
            raise ValueError(f"{name} must be {tuple(codes.shape[:-1])} "
                             f"(one per source row), got {tuple(t.shape)}")


def dequant_spmm(blocks: torch.Tensor, block_cols: torch.Tensor,
                 block_mask: torch.Tensor, codes: torch.Tensor,
                 scales: torch.Tensor, mins: torch.Tensor, *,
                 max_col: Optional[int] = None) -> torch.Tensor:
    """out = A @ (codes * scales[:, None] + mins[:, None]), fused.

    Same block layout as ``gather_aggregate.block_spmm``, rectangular
    sources included: ``codes`` uint{8,16,32}[S, F] is the source table (S
    a multiple of 128 covering every ``block_cols`` entry) and
    ``scales``/``mins`` are its f32[S] row parameters. Zero-padded rows
    (code 0, scale 0, min 0) contribute exactly 0. ``max_col`` is the
    largest entry of ``block_cols`` when the caller knows it.
    """
    _check(blocks, block_cols, block_mask, codes, scales, mins, False,
           max_col)
    if codes.device.type == "cpu":
        return ref.dequant_spmm_ref(blocks, block_cols, block_mask, codes,
                                    scales, mins)
    if codes.device.type != "cuda":
        raise ValueError(f"dequant_spmm runs on cuda or cpu, not "
                         f"{codes.device}")
    vb, m = blocks.shape[:2]
    src_rows, f = codes.shape
    out = torch.empty((vb * BLOCK, f), dtype=torch.float32,
                      device=codes.device)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        err = _kernel("dequant_spmm_launch")(
            _ptr(blocks), _ptr(block_cols), _ptr(block_mask), _ptr(codes),
            _ptr(scales), _ptr(mins), _ptr(out), vb, m, f, src_rows,
            CODE_BYTES[codes.dtype], ctypes.c_void_p(stream))
        dequant_spmm.launches += 1
    _raise_on(err, "dequant_spmm")
    return out


def dequant_spmm_batched(blocks: torch.Tensor, block_cols: torch.Tensor,
                         block_mask: torch.Tensor, codes: torch.Tensor,
                         scales: torch.Tensor, mins: torch.Tensor, *,
                         max_col: Optional[int] = None) -> torch.Tensor:
    """out[b] = A @ dequant(codes[b]) for codes [B, S, F] and f32[B, S]
    row parameters, one launch. Each ``out[b]`` is bitwise
    ``dequant_spmm(..., codes[b], scales[b], mins[b])``."""
    _check(blocks, block_cols, block_mask, codes, scales, mins, True,
           max_col)
    if codes.device.type == "cpu":
        return ref.dequant_spmm_batched_ref(blocks, block_cols, block_mask,
                                            codes, scales, mins)
    if codes.device.type != "cuda":
        raise ValueError(f"dequant_spmm_batched runs on cuda or cpu, not "
                         f"{codes.device}")
    vb, m = blocks.shape[:2]
    b, src_rows, f = codes.shape
    out = torch.empty((b, vb * BLOCK, f), dtype=torch.float32,
                      device=codes.device)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        err = _kernel("dequant_spmm_batched_launch")(
            _ptr(blocks), _ptr(block_cols), _ptr(block_mask), _ptr(codes),
            _ptr(scales), _ptr(mins), _ptr(out), b, vb, m, f, src_rows,
            CODE_BYTES[codes.dtype], ctypes.c_void_p(stream))
        dequant_spmm_batched.launches += 1
    _raise_on(err, "dequant_spmm_batched")
    return out


dequant_spmm.launches = 0
dequant_spmm_batched.launches = 0
