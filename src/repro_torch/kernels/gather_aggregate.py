"""Blocked CSR neighbour aggregation (the GNN hot spot) on Hopper.

The adjacency is laid out as block-CSR: dense ``B x B`` tiles (B = 128)
listed per row-block and ELL-padded to ``M`` tiles per row-block, so the
aggregation ``out = A @ H`` becomes a sequence of tile x panel products
``acc += tile[m] @ H[cols[m]]``. ``build_block_csr`` builds that layout on
the host; ``block_spmm`` and ``block_spmm_batched`` run the products in
hand-written CUDA kernels (``csrc/block_spmm.cu``, built by
``kernels.build``) for tensors on a CUDA device and in their plain PyTorch
versions (``kernels.ref``) for tensors on the CPU.

Each wrapper counts its kernel launches in a plain integer attribute
(``block_spmm.launches``), raised by one at every launch and nowhere else,
so a caller can show that a run really went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build, ref

BLOCK = 128  # adjacency tile edge

_MAX_ROW_BLOCKS = 65535   # grid.z limit of the launch geometry


def padded_feature_dim(f: int) -> int:
    """Feature count the block-CSR layout pads ``f`` columns to.

    Tables of up to 128 columns stay unpadded; wider ones are padded to a
    multiple of the 128-wide feature tile. The CUDA kernels mask the
    ragged feature edge themselves and accept any ``f``.
    """
    return f if f <= 128 else -(-f // 128) * 128


def build_block_csr(senders: np.ndarray, receivers: np.ndarray,
                    num_vertices: int, block: int = BLOCK,
                    weights: np.ndarray = None):
    """Host-side: COO edges -> ELL-over-blocks block-CSR.

    Layout contract (shared by every block-CSR SpMM):

      * The output-row space is ``receivers`` (``num_vertices`` rows,
        padded up to ``VB = ceil(num_vertices / block)`` row-blocks).
      * The source-column space is ``senders`` and may be a *different*
        index space (e.g. a gathered halo table): column-block ids are
        ``senders // block``, unbounded by ``num_vertices``. The feature
        table handed to the SpMM must cover ``(max(senders)//block + 1)
        * block`` rows (zero-pad to a multiple of ``block``).
      * Each row-block lists exactly ``M`` tiles (ELL padding): real tiles
        carry ``block_mask == 1``, padding tiles are all-zero with
        ``block_mask == 0`` and ``block_cols == 0``.
      * Duplicate edges accumulate (tile entries count multiplicity), and
        ``weights`` (f32[E], default 1) scales each edge's contribution —
        e.g. 1/deg(receiver) bakes mean-aggregation into the adjacency.

    Returns ``(blocks f32[VB, M, B, B], block_cols i32[VB, M],
    block_mask f32[VB, M], padded_v = VB * block)``. Zero edges are legal
    and yield a single all-padding tile per row-block (M == 1).
    """
    vb = -(-num_vertices // block)
    padded_v = vb * block
    if weights is None:
        weights = np.ones(len(senders), np.float32)
    rb = receivers // block
    cb = senders // block
    # Unique (row-block, col-block) pairs. The column-block count follows
    # the senders' index space, which may be wider than the row space.
    ncb = int(cb.max()) + 1 if len(cb) else 1
    key = rb.astype(np.int64) * ncb + cb
    uniq, inv = np.unique(key, return_inverse=True)
    nb = len(uniq)
    tiles = np.zeros((nb, block, block), np.float32)
    np.add.at(tiles, (inv, receivers % block, senders % block), weights)
    tile_rb = (uniq // ncb).astype(np.int64)
    tile_cb = (uniq % ncb).astype(np.int32)
    counts = np.bincount(tile_rb, minlength=vb)
    m = max(1, int(counts.max()))
    blocks = np.zeros((vb, m, block, block), np.float32)
    block_cols = np.zeros((vb, m), np.int32)
    block_mask = np.zeros((vb, m), np.float32)
    slot = np.zeros(vb, np.int64)
    for t in range(nb):
        i = tile_rb[t]
        j = slot[i]
        blocks[i, j] = tiles[t]
        block_cols[i, j] = tile_cb[t]
        block_mask[i, j] = 1.0
        slot[i] += 1
    return blocks, block_cols, block_mask, padded_v


def _check_tensor(name: str, t: torch.Tensor, dtypes, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the source table on "
                         f"{device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be "
                        f"{' or '.join(map(str, dtypes))}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_operands(blocks, block_cols, block_mask, h, batched: bool,
                    max_col: Optional[int], h_name: str = "h",
                    h_dtypes=(torch.float32,)) -> None:
    """Raise on anything the kernels do not take (they check nothing).

    ``h`` is the source table: f32 for ``block_spmm``, the codes for the
    dequant kernels (``h_name``/``h_dtypes`` say which).
    """
    dev = h.device
    for name, t, dtypes in (("blocks", blocks, (torch.float32,)),
                            ("block_cols", block_cols, (torch.int32,)),
                            ("block_mask", block_mask, (torch.float32,)),
                            (h_name, h, h_dtypes)):
        _check_tensor(name, t, dtypes, dev)
    if blocks.ndim != 4 or blocks.shape[2:] != (BLOCK, BLOCK):
        raise ValueError(f"blocks must be [VB, M, {BLOCK}, {BLOCK}], "
                         f"got {tuple(blocks.shape)}")
    vb, m = blocks.shape[:2]
    if tuple(block_cols.shape) != (vb, m) or \
            tuple(block_mask.shape) != (vb, m):
        raise ValueError(f"block_cols/block_mask must be [{vb}, {m}], got "
                         f"{tuple(block_cols.shape)} / "
                         f"{tuple(block_mask.shape)}")
    if h.ndim != (3 if batched else 2):
        raise ValueError(f"{h_name} must be "
                         f"{'[B, S, F]' if batched else '[S, F]'}, got "
                         f"{tuple(h.shape)}")
    src_rows, f = h.shape[-2:]
    if src_rows % BLOCK or f < 1 or (batched and h.shape[0] < 1):
        raise ValueError(f"{h_name} rows must be a multiple of {BLOCK} and "
                         f"F, B >= 1, got {tuple(h.shape)}")
    if vb > _MAX_ROW_BLOCKS:
        raise ValueError(f"{vb} row-blocks exceed the launch limit "
                         f"{_MAX_ROW_BLOCKS}")
    # The kernels read source rows cols*B .. +B with no bounds check.
    if max_col is None:
        lo, hi = torch.aminmax(block_cols)
        if int(lo) < 0:
            raise ValueError("block_cols holds a negative column block")
        max_col = int(hi)
    if (max_col + 1) * BLOCK > src_rows:
        raise ValueError(f"source table has {src_rows} rows but block_cols "
                         f"reaches block {max_col} (needs "
                         f"{(max_col + 1) * BLOCK})")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


_P, _I = ctypes.c_void_p, ctypes.c_int

#: C signatures of csrc/block_spmm.cu: (blocks, cols, mask, source
#: pointers..., out, ints..., stream). Every pointer and the stream must be
#: c_void_p, or ctypes would pass them as 32-bit ints and cut them. The
#: dequant entries (used by ``kernels.daq_dequant``) take codes, scales and
#: mins as their source; ``dequant_launch`` takes only those.
_SIGNATURES = {
    "block_spmm_launch": [_P] * 5 + [_I] * 3 + [_P],
    "block_spmm_batched_launch": [_P] * 5 + [_I] * 5 + [_P],
    "dequant_spmm_launch": [_P] * 7 + [_I] * 5 + [_P],
    "dequant_spmm_batched_launch": [_P] * 7 + [_I] * 6 + [_P],
    "dequant_launch": [_P] * 4 + [_I] * 3 + [_P],
}


def _kernel(name: str):
    fn = getattr(build.load("block_spmm"), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fn


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def block_spmm(blocks: torch.Tensor, block_cols: torch.Tensor,
               block_mask: torch.Tensor, h: torch.Tensor, *,
               max_col: Optional[int] = None) -> torch.Tensor:
    """out = A @ h with A in ELL-block-CSR layout (see build_block_csr).

    ``A`` may be rectangular: ``h`` f32[S, F] is the *source* table (S a
    multiple of 128 covering every ``block_cols`` entry) while the output
    f32[VB*128, F] has the row space of ``blocks``. ``max_col`` is the
    largest entry of ``block_cols`` when the caller knows it (saves a
    device-to-host read for the bounds check). CUDA tensors launch the
    CUDA kernel on the current stream; CPU tensors take the plain version.
    """
    _check_operands(blocks, block_cols, block_mask, h, False, max_col)
    if h.device.type == "cpu":
        return ref.block_spmm_ref(blocks, block_cols, block_mask, h)
    if h.device.type != "cuda":
        raise ValueError(f"block_spmm runs on cuda or cpu, not {h.device}")
    vb, m = blocks.shape[:2]
    f = h.shape[1]
    out = torch.empty((vb * BLOCK, f), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = _kernel("block_spmm_launch")(
            _ptr(blocks), _ptr(block_cols), _ptr(block_mask), _ptr(h),
            _ptr(out), vb, m, f, ctypes.c_void_p(stream))
        block_spmm.launches += 1
    _raise_on(err, "block_spmm")
    return out


def block_spmm_batched(blocks: torch.Tensor, block_cols: torch.Tensor,
                       block_mask: torch.Tensor, h: torch.Tensor, *,
                       max_col: Optional[int] = None) -> torch.Tensor:
    """out[b] = A @ h[b] for a [B, S, F] feature stack, one launch.

    Each ``out[b]`` is bitwise equal to ``block_spmm(..., h[b])``: the
    batched kernel runs the serial kernel's per-example code.
    """
    _check_operands(blocks, block_cols, block_mask, h, True, max_col)
    if h.device.type == "cpu":
        return ref.block_spmm_batched_ref(blocks, block_cols, block_mask, h)
    if h.device.type != "cuda":
        raise ValueError(f"block_spmm_batched runs on cuda or cpu, not "
                         f"{h.device}")
    vb, m = blocks.shape[:2]
    b, src_rows, f = h.shape
    out = torch.empty((b, vb * BLOCK, f), dtype=torch.float32,
                      device=h.device)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = _kernel("block_spmm_batched_launch")(
            _ptr(blocks), _ptr(block_cols), _ptr(block_mask), _ptr(h),
            _ptr(out), b, vb, m, f, src_rows, ctypes.c_void_p(stream))
        block_spmm_batched.launches += 1
    _raise_on(err, "block_spmm_batched")
    return out


block_spmm.launches = 0
block_spmm_batched.launches = 0
