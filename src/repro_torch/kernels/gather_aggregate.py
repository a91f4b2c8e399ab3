"""Blocked CSR neighbour aggregation (the GNN hot spot) on Hopper.

The adjacency is laid out as block-CSR: dense ``B x B`` tiles (B = 128)
listed per row-block and ELL-padded to ``M`` tiles per row-block, so the
aggregation ``out = A @ H`` becomes a sequence of tile x panel products
``acc += tile[m] @ H[cols[m]]``. ``build_block_csr`` builds that layout on
the host. The graph fills well under 1 % of the tiles' entries, so the
CUDA kernels (``csrc/block_spmm.cu``, built by ``kernels.build``) read no
tiles: ``compact_block_csr`` lists the tiles' nonzeros per output row
once per layout (a :class:`TileRows`), and ``block_spmm`` /
``block_spmm_batched`` walk only those, in the dense product's order, so
their floats are the dense product's. Tensors on the CPU take the plain
PyTorch versions (``kernels.ref``) over the dense tiles.

Each wrapper counts its kernel launches in a plain integer attribute
(``block_spmm.launches``), raised by one at every launch and nowhere else,
so a caller can show that a run really went through the kernel. A launch
over a :class:`RowSubset` (``row_subset``: the rows of some 128-row
blocks, for a frontier query) counts there too, and also in
``block_spmm.subset_launches``. While a profiler records, each call is
the span ``fog.kernel.<wrapper>`` (``runtime.trace``).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build, ref
from repro_torch.runtime.trace import span

BLOCK = 128  # adjacency tile edge


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


#: Rows of more than this many entries are launched first, longest first.
_LONG_ROW = 32
#: Rows of more than this many entries are walked by a whole CTA.
_SPLIT_ROW = 512


@dataclasses.dataclass(frozen=True)
class TileRows:
    """The nonzeros of a block-CSR operand, listed per output row.

    A segment is one (output row, real tile slot) whose tile row holds at
    least one nonzero; a row's segments go in slot order, a segment's
    entries in k order: the order in which the dense tile product sums
    them. Built by :func:`compact_block_csr`, on the tiles' device, and
    checked once here (the kernel wrappers check only how it fits their
    operands).
    """
    row_ptr: torch.Tensor    # i32[n_rows + 1]: each row's segments
    seg_ptr: torch.Tensor    # i32[n_seg + 1]: each segment's entries
    seg_w: torch.Tensor      # f32[n_seg]: the slot's block_mask value
    src: torch.Tensor        # i32[nnz]: global source row cols*128 + k
    val: torch.Tensor        # f32[nnz]: the tile entry
    #: i32[n, 4], the rows one warp walks in launch order, each as (row,
    #: first segment, first entry, end entry); 16-byte aligned.
    warp_rows: torch.Tensor
    split: torch.Tensor      # i32[n_split]: the rows one CTA walks
    tiles: Tuple[int, int]   # (VB, M) of the tiles it lists
    max_src: int             # largest entry of src (-1 when nnz == 0)
    nnz: int
    n_seg: int
    split_segs: int          # most segments of a split row (0 if none)

    def __post_init__(self):
        n_rows = self.tiles[0] * BLOCK
        for name, dtype, shape in (
                ("row_ptr", torch.int32, (n_rows + 1,)),
                ("seg_ptr", torch.int32, (self.n_seg + 1,)),
                ("seg_w", torch.float32, (self.n_seg,)),
                ("src", torch.int32, (self.nnz,)),
                ("val", torch.float32, (self.nnz,)),
                ("warp_rows", torch.int32, (len(self.warp_rows), 4)),
                ("split", torch.int32, (len(self.split),))):
            t = getattr(self, name)
            _check_tensor(f"TileRows.{name}", t, (dtype,), self.device)
            if tuple(t.shape) != shape:
                raise ValueError(f"TileRows.{name} must be {shape}, got "
                                 f"{tuple(t.shape)}")
        if len(self.warp_rows) + len(self.split) != n_rows:
            raise ValueError(f"TileRows.warp_rows and .split must list the "
                             f"{n_rows} rows between them")
        if self.warp_rows.data_ptr() % 16:
            raise ValueError("TileRows.warp_rows must be 16-byte aligned")

    @property
    def n_rows(self) -> int:
        return self.row_ptr.numel() - 1

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device


@dataclasses.dataclass(frozen=True)
class RowSubset:
    """The rows of some 128-row blocks of a :class:`TileRows`.

    ``warp_rows`` and ``split`` list only the rows of the row blocks
    ``blocks``, in the full operand's launch order; every other tensor is
    the full operand's (``rows``). A kernel launched over it walks a listed
    row with exactly the code of a full launch, so the row comes out
    bitwise the full launch's; it writes no other row, and the wrappers
    return those as zeros. Built by :func:`row_subset`, on the operand's
    device.
    """
    rows: TileRows           # the full operand
    blocks: torch.Tensor     # i64[k]: the selected row blocks, ascending
    warp_rows: torch.Tensor  # i32[n, 4]: rows.warp_rows of those blocks
    split: torch.Tensor      # i32[n_split]: rows.split of those blocks

    def __post_init__(self):
        full = self.rows
        for name, like in (("warp_rows", full.warp_rows),
                           ("split", full.split)):
            t = getattr(self, name)
            _check_tensor(f"RowSubset.{name}", t, (torch.int32,),
                          full.device)
            if t.shape[1:] != like.shape[1:] or len(t) > len(like):
                raise ValueError(f"RowSubset.{name} must be at most "
                                 f"{tuple(like.shape)}, got {tuple(t.shape)}")
        if self.warp_rows.data_ptr() % 16:
            raise ValueError("RowSubset.warp_rows must be 16-byte aligned")

    @property
    def tiles(self) -> Tuple[int, int]:
        return self.rows.tiles

    @property
    def n_rows(self) -> int:
        return self.rows.n_rows

    @property
    def device(self) -> torch.device:
        return self.rows.device

    @property
    def max_src(self) -> int:
        return self.rows.max_src

    def row_mask(self) -> torch.Tensor:
        """bool[n_rows]: True on the rows of the selected blocks."""
        keep = torch.zeros(self.rows.tiles[0], dtype=torch.bool,
                           device=self.device)
        keep[self.blocks] = True
        return keep.repeat_interleave(BLOCK)


def row_subset(rows: TileRows, blocks) -> RowSubset:
    """The :class:`RowSubset` of ``rows`` over the row blocks ``blocks``
    (ids in ``[0, VB)``, each at most once; any integer sequence, array or
    tensor). The ids are checked on the host; the subset is cut on the
    card: the rows of ``warp_rows`` and ``split`` whose block is selected,
    in their order."""
    ids = np.asarray(blocks.cpu() if isinstance(blocks, torch.Tensor)
                     else blocks, np.int64).reshape(-1)
    vb = rows.tiles[0]
    if len(ids) and (ids.min() < 0 or ids.max() >= vb):
        raise ValueError(f"row blocks must lie in [0, {vb}), got "
                         f"{ids.min()} .. {ids.max()}")
    if len(np.unique(ids)) != len(ids):
        raise ValueError("row blocks must be unique")
    sel = torch.as_tensor(np.sort(ids), device=rows.device)
    keep = torch.zeros(vb, dtype=torch.bool, device=rows.device)
    keep[sel] = True
    warp = rows.warp_rows[keep[rows.warp_rows[:, 0].long() // BLOCK]]
    split = rows.split[keep[rows.split.long() // BLOCK]]
    return RowSubset(rows=rows, blocks=sel, warp_rows=warp.contiguous(),
                     split=split.contiguous())


def compact_block_csr(blocks: torch.Tensor, block_cols: torch.Tensor,
                      block_mask: torch.Tensor) -> TileRows:
    """The :class:`TileRows` of an ELL-block-CSR operand, on its device.

    Its entries are exactly the values the dense product reads: the
    nonzero entries of the real tiles (``block_mask != 0``), ordered by
    (row-block, row, slot, k). The kernels walk rows of more than 512
    entries with a whole CTA (``split``, longest first) and the others
    with one warp (``warp_rows``: rows of more than 32 entries first,
    longest first, then the rest in row order).
    """
    vb, m = blocks.shape[:2]
    n_rows = vb * BLOCK
    real = (block_mask != 0)[:, :, None, None] & (blocks != 0)
    i, r, t, k = real.permute(0, 2, 1, 3).nonzero(as_tuple=True)
    nnz = i.numel()
    if nnz >= 2 ** 31 - 64:
        raise ValueError(f"{nnz} nonzeros exceed the kernels' int32 offsets")
    val = blocks[i, t, r, k]
    src = block_cols[i, t].long() * BLOCK + k
    row = i * BLOCK + r
    key = row * m + t
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    starts = first.nonzero().squeeze(1)
    n_seg = starts.numel()
    seg_ptr = torch.cat([starts, starts.new_tensor([nnz])])
    seg_rows = torch.bincount(row[starts], minlength=n_rows)
    row_ptr = torch.cat([seg_rows.new_zeros(1), seg_rows.cumsum(0)])
    entries = seg_ptr[row_ptr[1:]] - seg_ptr[row_ptr[:-1]]
    lead = torch.sort(torch.where(entries > _LONG_ROW, -entries, 0),
                      stable=True).indices
    long_ = entries[lead] > _SPLIT_ROW
    split, order = lead[long_], lead[~long_]
    seg0 = row_ptr[order]
    warp_rows = torch.stack([order, seg0, seg_ptr[seg0],
                             seg_ptr[row_ptr[order + 1]]], dim=1)
    i32 = torch.int32
    return TileRows(row_ptr=row_ptr.to(i32), seg_ptr=seg_ptr.to(i32),
                    seg_w=block_mask[i[starts], t[starts]].contiguous(),
                    src=src.to(i32), val=val.contiguous(),
                    warp_rows=warp_rows.to(i32), split=split.to(i32),
                    tiles=(vb, m),
                    max_src=int(src.max()) if nnz else -1, nnz=nnz,
                    n_seg=n_seg,
                    split_segs=int(seg_rows[split].max()) if len(split)
                    else 0)


def _check_tensor(name: str, t: torch.Tensor, dtypes, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the other operands on "
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


def _check_rows(rows, blocks: torch.Tensor, h: torch.Tensor) -> None:
    """Raise unless ``rows`` (a TileRows or a RowSubset of one) lists
    ``blocks`` and fits the table ``h``."""
    if not isinstance(rows, (TileRows, RowSubset)):
        raise TypeError(f"rows must be a TileRows (compact_block_csr) or a "
                        f"RowSubset (row_subset), got {type(rows).__name__}")
    vb, m = blocks.shape[:2]
    if rows.tiles != (vb, m):
        raise ValueError(f"rows lists {rows.n_rows} rows of [VB, M] = "
                         f"{list(rows.tiles)} tiles, blocks are [{vb}, {m}]:"
                         f" compacted from other tiles")
    if rows.device != h.device:
        raise ValueError(f"rows is on {rows.device}, the source table on "
                         f"{h.device}")
    # The kernels read source rows src[e] with no bounds check.
    if rows.max_src >= h.shape[-2]:
        raise ValueError(f"source table has {h.shape[-2]} rows but rows "
                         f"reads row {rows.max_src}")


_NEEDS_ROWS = ("{} on CUDA reads the row-compacted operand: pass "
               "rows=compact_block_csr(blocks, block_cols, block_mask), "
               "built once per layout")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


_P, _I = ctypes.c_void_p, ctypes.c_int

#: C signatures of csrc/block_spmm.cu. Every pointer and the stream must
#: be c_void_p, or ctypes would pass them as 32-bit ints and cut them. The
#: product entries take the TileRows tensors (row_ptr, seg_ptr, seg_w, src,
#: val, warp_rows, split), the source table (h; or codes, scales, mins for
#: the dequant entries, used by ``kernels.daq_dequant``), out, ints (the
#: dequant entries end them with code_bytes), stream; ``dequant_launch``
#: takes only the codes' part.
_SIGNATURES = {
    "block_spmm_launch": [_P] * 9 + [_I] * 7 + [_P],
    "block_spmm_batched_launch": [_P] * 9 + [_I] * 8 + [_P],
    "dequant_spmm_launch": [_P] * 11 + [_I] * 8 + [_P],
    "dequant_spmm_batched_launch": [_P] * 11 + [_I] * 9 + [_P],
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


def _out(rows, shape, device) -> torch.Tensor:
    """The output of a launch over ``rows``: a full launch writes every
    row; a row subset writes only its rows, so the others start at 0."""
    alloc = torch.zeros if isinstance(rows, RowSubset) else torch.empty
    return alloc(shape, dtype=torch.float32, device=device)


def _launch(name: str, rows, tables: Sequence[torch.Tensor],
            out: torch.Tensor, *batch: int, last: Tuple[int, ...] = ()
            ) -> int:
    """Launch a row-compacted entry point over ``rows`` (a TileRows, or a
    RowSubset: the full operand with its own warp and split rows), the
    source ``tables`` (h, or codes, scales, mins: the first gives the
    table's shape) and the trailing ints ``last``; returns its
    cudaError."""
    full = rows.rows if isinstance(rows, RowSubset) else rows
    h = tables[0]
    src_rows, f = h.shape[-2:]
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        return _kernel(name)(
            _ptr(full.row_ptr), _ptr(full.seg_ptr), _ptr(full.seg_w),
            _ptr(full.src), _ptr(full.val), _ptr(rows.warp_rows),
            _ptr(rows.split), *map(_ptr, tables), _ptr(out), *batch,
            full.n_rows, full.n_seg, len(rows.warp_rows), len(rows.split),
            full.split_segs, f, src_rows, *last, ctypes.c_void_p(stream))


def _count(wrapper, rows) -> None:
    """One launch of ``wrapper``'s kernel: ``launches`` counts every
    launch, ``subset_launches`` those over a row subset."""
    wrapper.launches += 1
    if isinstance(rows, RowSubset):
        wrapper.subset_launches += 1


def block_spmm(blocks: torch.Tensor, block_cols: torch.Tensor,
               block_mask: torch.Tensor, h: torch.Tensor, *,
               rows: Optional[TileRows] = None,
               max_col: Optional[int] = None) -> torch.Tensor:
    """out = A @ h with A in ELL-block-CSR layout (see build_block_csr).

    ``A`` may be rectangular: ``h`` f32[S, F] is the *source* table (S a
    multiple of 128 covering every ``block_cols`` entry) while the output
    f32[VB*128, F] has the row space of ``blocks``. ``max_col`` is the
    largest entry of ``block_cols`` when the caller knows it (saves a
    device-to-host read for the bounds check). CUDA tensors launch the
    CUDA kernel on the current stream over ``rows``, the operand's
    :func:`compact_block_csr` (required there, built once per layout); CPU
    tensors take the plain version over the tiles. A :class:`RowSubset`
    as ``rows`` computes only its rows (each bitwise the full product's)
    and returns the others as zeros, on either device.
    """
    with span("kernel.block_spmm"):
        _check_operands(blocks, block_cols, block_mask, h, False, max_col)
        if rows is not None:
            _check_rows(rows, blocks, h)
        if h.device.type == "cpu":
            if isinstance(rows, RowSubset):
                return ref.block_spmm_subset_ref(blocks, block_cols,
                                                 block_mask, h, rows.blocks)
            return ref.block_spmm_ref(blocks, block_cols, block_mask, h)
        if h.device.type != "cuda":
            raise ValueError(f"block_spmm runs on cuda or cpu, not {h.device}")
        if rows is None:
            raise ValueError(_NEEDS_ROWS.format("block_spmm"))
        out = _out(rows, (rows.n_rows, h.shape[1]), h.device)
        err = _launch("block_spmm_launch", rows, (h,), out)
        _count(block_spmm, rows)
        _raise_on(err, "block_spmm")
        return out


def block_spmm_batched(blocks: torch.Tensor, block_cols: torch.Tensor,
                       block_mask: torch.Tensor, h: torch.Tensor, *,
                       rows: Optional[TileRows] = None,
                       max_col: Optional[int] = None) -> torch.Tensor:
    """out[b] = A @ h[b] for a [B, S, F] feature stack, one launch.

    Each ``out[b]`` is bitwise equal to ``block_spmm(..., h[b])``: the
    batched kernel runs the serial kernel's per-example code. ``rows`` as
    for ``block_spmm`` (a row subset included).
    """
    with span("kernel.block_spmm_batched"):
        _check_operands(blocks, block_cols, block_mask, h, True, max_col)
        if rows is not None:
            _check_rows(rows, blocks, h)
        if h.device.type == "cpu":
            if isinstance(rows, RowSubset):
                return ref.block_spmm_batched_subset_ref(
                    blocks, block_cols, block_mask, h, rows.blocks)
            return ref.block_spmm_batched_ref(blocks, block_cols, block_mask,
                                              h)
        if h.device.type != "cuda":
            raise ValueError(f"block_spmm_batched runs on cuda or cpu, not "
                             f"{h.device}")
        if rows is None:
            raise ValueError(_NEEDS_ROWS.format("block_spmm_batched"))
        b, _, f = h.shape
        out = _out(rows, (b, rows.n_rows, f), h.device)
        err = _launch("block_spmm_batched_launch", rows, (h,), out, b)
        _count(block_spmm_batched, rows)
        _raise_on(err, "block_spmm_batched")
        return out


block_spmm.launches = 0
block_spmm.subset_launches = 0
block_spmm_batched.launches = 0
block_spmm_batched.subset_launches = 0
