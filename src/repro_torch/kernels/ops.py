"""Entry points the rest of the port uses for kernel aggregation.

They handle host layout conversion (COO -> block-CSR), row padding and
un-padding, and keep prepared operands in a keyed cache. Dispatch follows
the tensors' device: operands prepared for a CUDA device run the CUDA
kernels, operands prepared for the CPU run the kernels' plain versions.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.gnn.graph import Graph
from repro_torch.kernels.daq_dequant import dequant, dequant_spmm
from repro_torch.kernels.gather_aggregate import (BLOCK, RowSubset,
                                                  block_spmm,
                                                  block_spmm_batched,
                                                  build_block_csr,
                                                  compact_block_csr)


class BlockCsr:
    """Prepared adjacency for repeated kernel aggregations on one device."""

    def __init__(self, g: Graph, block: int = BLOCK,
                 normalize: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda"):
        weights = None
        if normalize == "mean":
            deg = np.maximum(g.degrees[g.receivers], 1)
            weights = (1.0 / deg).astype(np.float32)
        blocks, cols, mask, padded_v = build_block_csr(
            g.senders, g.receivers, g.num_vertices, block, weights)
        self.block = block
        self.num_vertices = g.num_vertices
        self.padded_v = padded_v
        self.device = torch.device(device)
        #: largest column block, known on the host: spares the kernel
        #: wrappers a device read for their bounds check.
        self.max_col = int(cols.max())
        self.blocks = torch.as_tensor(blocks, device=self.device)
        self.cols = torch.as_tensor(cols, device=self.device)
        self.mask = torch.as_tensor(mask, device=self.device)
        #: the tiles' nonzeros per output row, what the CUDA kernels read
        self.rows = compact_block_csr(self.blocks, self.cols, self.mask)

    def aggregate_traced(self, h: torch.Tensor,
                         subset: Optional[RowSubset] = None) -> torch.Tensor:
        """sum-aggregate, tensor in / tensor out on the prepared device.

        Zero-pads rows to the prepared block grid. ``h`` may be a single
        [V, F] feature table or a stacked [B, V, F] micro-batch — the
        stacked form runs ``block_spmm_batched`` (one launch for the whole
        batch) and returns [B, V, F], with each ``out[b]`` bitwise equal
        to the single-query call on ``h[b]``. With ``subset`` (a
        ``gather_aggregate.row_subset`` of ``rows``) only the rows of its
        blocks are summed, each
        bitwise the full call's; the other rows are 0.
        """
        v, f = h.shape[-2:]
        hp = h.new_zeros(h.shape[:-2] + (self.padded_v, f),
                         dtype=torch.float32)
        hp[..., :v, :] = h
        op = block_spmm_batched if h.ndim == 3 else block_spmm
        out = op(self.blocks, self.cols, self.mask, hp,
                 rows=self.rows if subset is None else subset,
                 max_col=self.max_col)
        return out[..., :v, :]

    def aggregate(self, h: np.ndarray) -> np.ndarray:
        """sum-aggregate: numpy [V, F] (or [B, V, F]) in and out."""
        ht = torch.tensor(np.asarray(h, np.float32), device=self.device)
        return self.aggregate_traced(ht).cpu().numpy()

    def aggregate_quantized(self, codes: np.ndarray, scales: np.ndarray,
                            mins: np.ndarray) -> np.ndarray:
        """Fused dequant + sum-aggregate over quantized features: numpy
        uint{8,16,32} codes [V, F] with f32[V] scales and mins in, f32
        [V, F] out. Padded rows dequantize to exactly 0."""
        v = codes.shape[0]

        def padded(a):   # zero rows appended up to the block grid
            t = torch.as_tensor(a, device=self.device)
            return torch.cat([t, t.new_zeros((self.padded_v - v,)
                                             + t.shape[1:])])
        out = dequant_spmm(self.blocks, self.cols, self.mask, padded(codes),
                           padded(np.asarray(scales, np.float32)),
                           padded(np.asarray(mins, np.float32)),
                           rows=self.rows, max_col=self.max_col)
        return out[:v].cpu().numpy()


# ----------------------------------------------------------------------------
# Keyed BlockCsr cache (shared by every single-program executor backend)
# ----------------------------------------------------------------------------

#: LRU of prepared block-CSR operands, keyed by (graph adjacency
#: fingerprint, aggregation normalization, block shape, device). Keying on
#: content (not Graph identity) means a Session aggregation override, a
#: fresh Graph copy, or two plans over the same topology all share one
#: prepared operand instead of re-blocking per query.
_BLOCK_CSR_CACHE: "OrderedDict[tuple, BlockCsr]" = OrderedDict()
_BLOCK_CSR_CACHE_MAX = 16

#: Field names of the _BLOCK_CSR_CACHE key tuple, in order.
BLOCK_CSR_KEY_FIELDS = ("adjacency_fingerprint", "normalize", "block",
                        "device")


def graph_fingerprint(g: Graph) -> str:
    """Content hash of a graph's *adjacency* (features excluded).

    Vertex count and edge endpoints feed the digest; that covers
    everything the block-CSR operands depend on (mean-normalization
    degrees are the receiver counts of those same edges), so a mutated
    graph can never alias a stale cache entry.

    The digest is O(E) to compute, so it is memoized on the Graph
    instance — adjacency arrays are treated as immutable everywhere.
    """
    fp = getattr(g, "_adjacency_fingerprint", None)
    if fp is None:
        d = hashlib.blake2b(digest_size=16)
        d.update(np.int64(g.num_vertices).tobytes())
        d.update(np.ascontiguousarray(g.senders, np.int64).tobytes())
        d.update(np.ascontiguousarray(g.receivers, np.int64).tobytes())
        fp = d.hexdigest()
        g._adjacency_fingerprint = fp
    return fp


def block_csr_for(g: Graph, block: int = BLOCK,
                  normalize: Optional[str] = None,
                  device: Union[str, torch.device] = "cuda") -> BlockCsr:
    """Cached :class:`BlockCsr` for ``g`` on ``device`` (built once per
    adjacency and device)."""
    dev = torch.device(device)
    key = (graph_fingerprint(g), normalize, block, str(dev))
    csr = _BLOCK_CSR_CACHE.get(key)
    if csr is None:
        csr = BlockCsr(g, block=block, normalize=normalize, device=dev)
        _BLOCK_CSR_CACHE[key] = csr
        while len(_BLOCK_CSR_CACHE) > _BLOCK_CSR_CACHE_MAX:
            _BLOCK_CSR_CACHE.popitem(last=False)
    else:
        _BLOCK_CSR_CACHE.move_to_end(key)
    return csr


def invalidate_block_csr(g: Graph) -> int:
    """Drop every cached BlockCsr built for ``g``'s adjacency (any
    device); returns the number of entries removed."""
    fp = graph_fingerprint(g)
    stale = [k for k in _BLOCK_CSR_CACHE if k[0] == fp]
    for k in stale:
        del _BLOCK_CSR_CACHE[k]
    return len(stale)


def dequantize_features(codes: np.ndarray, scales: np.ndarray,
                        mins: np.ndarray, *,
                        device: Union[str, torch.device] = "cuda"
                        ) -> np.ndarray:
    """Kernel-backed row-wise dequantization: numpy codes uint{8,16,32}[V,
    F] and f32[V] scales and mins in, numpy f32[V, F] out, dequantized by
    ``daq_dequant.dequant`` on ``device`` (the CUDA kernel on a CUDA
    device, its plain version on the CPU). The table goes unpadded, in one
    tile: the kernel takes any shape, so padding to the reference's
    256 x 128 tiling would only move bytes that are cut off again."""
    # Imported here: api.engine imports this module.
    from repro_torch.api.engine import resolve_device
    dev = resolve_device(device)
    v, f = codes.shape
    out = dequant(torch.as_tensor(np.ascontiguousarray(codes), device=dev),
                  torch.as_tensor(scales, dtype=torch.float32, device=dev),
                  torch.as_tensor(mins, dtype=torch.float32, device=dev),
                  v_tile=v, f_tile=f)
    return out.cpu().numpy()
