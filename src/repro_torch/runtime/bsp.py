"""Distributed BSP runtime (paper §III-E), the fog mesh on one device.

The paper's runtime: each fog holds a vertex partition; every GNN layer runs
Aggregate/Update over local vertices, pulling neighbor activations from
other fogs in a Bulk-Synchronous-Parallel step (K syncs for K layers). The
per-layer cross-fog exchange is one of:

  * ``"allgather"``  — gather the full [P, F] partition activations
    (straw-man exchange; O(n·P·F) bytes per device per layer).
  * ``"halo"``       — gather only the *boundary rows* (vertices that any
    other partition reads), packed into a [B, F] buffer (B = max boundary
    size): the paper's "exchange vertices data when needed".
  * ``"halo_async"`` — the stale-tolerant variant whose fresh serves are
    the ``"halo"`` exchange.

The host part lays the graph out per partition with static padded shapes
(``build_partitioned``, with the pre-blocked per-shard block-CSR operands
of the kernel path) and prices the exchange (``exchange_bytes``,
``ExchangeSpec``). The device part (``bsp_apply`` / ``bsp_apply_many``,
``bsp_infer`` / ``bsp_infer_many``) runs the n shards on ONE torch device:
the shard axis is folded into the row axis, so shard ``p``'s slot ``i`` is
row ``p*P + i`` of one [n*P, F] table, and the all_gather of the boundary
rows is a gather of those rows into one [n*B, F] halo table that every
shard reads. A layer is one program over all shards instead of n
programs.

Shard-local aggregation runs on one of two numerically equivalent paths,
selected by the ``aggregation`` knob:

  * ``"segment_sum"`` — gather + the fixed-order segment sum
    (``kernels.segment_sum``) over the COO edge list.
  * ``"pallas"``      — the hand-written block-CSR SpMM kernels (the knob
    keeps the reference's name for the kernel path): per layer one
    ``block_spmm`` over every shard's local rows plus one over the shared
    halo table. With ``halo_quant`` (DAQ plans) the halo rows cross the
    wire as uint8 codes plus one f32 (scale, min) pair per row and the
    halo product is the fused ``dequant_spmm`` kernel.
  * ``"auto"``        — ``"pallas"`` wherever it is supported *and* the
    run's device is a CUDA device (on the CPU the kernels' plain versions
    would run, which is only useful for correctness); otherwise
    ``"segment_sum"``.

The kernel path supports the sum/mean aggregations of GCN and GraphSAGE
under the ``"halo"`` exchange; GAT's attention-weighted aggregation and the
``"allgather"`` straw-man stay on ``segment_sum`` (requesting ``"pallas"``
for those raises, ``"auto"`` silently falls back).

Buffer conventions: all feature math is float32; padded vertex rows, edge
slots, boundary rows and ELL tiles are zero-filled and masked (``*_mask``
arrays, 1.0 = real), so every code path may blindly multiply-accumulate.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.api.registry import EXCHANGES
from repro_torch.gnn.graph import Graph
from repro_torch.gnn.layers import EdgeList, LAYER_FNS, apply_layer_with_sum
from repro_torch.kernels.daq_dequant import (dequant_spmm,
                                             dequant_spmm_batched)
from repro_torch.kernels.gather_aggregate import (BLOCK, TileRows,
                                                  block_spmm,
                                                  block_spmm_batched,
                                                  build_block_csr,
                                                  compact_block_csr)

#: legal values of the Engine/Session ``aggregation`` knob.
AGGREGATIONS = ("segment_sum", "pallas", "auto")

#: GNN kinds whose neighborhood aggregation is a static (weighted) sum and
#: can therefore be pre-blocked into an SpMM. GAT re-weights edges per layer
#: with attention, so its aggregation stays on segment_sum.
KERNEL_KINDS = ("gcn", "sage")


def resolve_aggregation(mode: str, kind: str, *,
                        exchange: Optional[str] = None,
                        device=None) -> str:
    """Resolve the ``aggregation`` knob to a concrete path for one run.

    ``exchange=None`` means "no cross-fog exchange involved" (the
    single-program executors). ``"pallas"`` is strict — unsupported
    combinations raise; ``"auto"`` picks the kernels only when ``device``
    (the run's torch device) is a CUDA device and the kernels apply, and
    ``"segment_sum"`` otherwise.
    """
    if mode not in AGGREGATIONS:
        raise ValueError(f"unknown aggregation {mode!r}; available: "
                         f"{', '.join(AGGREGATIONS)}")
    # halo_async serves (fresh or stale) read the same halo-table row space
    # the block-CSR shards are built over, so the kernel path applies.
    supported = (kind in KERNEL_KINDS
                 and exchange in (None, "halo", "halo_async"))
    if mode == "pallas":
        if kind not in KERNEL_KINDS:
            raise ValueError(
                f"aggregation='pallas' supports kinds {KERNEL_KINDS} "
                f"(static-sum aggregation); {kind!r} re-weights edges per "
                f"layer — use aggregation='segment_sum' or 'auto'")
        if exchange is not None and exchange not in ("halo", "halo_async"):
            raise ValueError(
                "aggregation='pallas' requires the 'halo' exchange (the "
                f"block-CSR shards are built over the halo table), got "
                f"exchange={exchange!r}")
        return "pallas"
    if mode == "segment_sum":
        return "segment_sum"
    on_cuda = device is not None and torch.device(device).type == "cuda"
    return "pallas" if (supported and on_cuda) else "segment_sum"


def _wire_exchange(exchange: str) -> str:
    """The synchronous exchange behind an exchange mode: ``halo_async``'s
    fresh path IS the ``halo`` exchange, so its wire bytes are the same."""
    return "halo" if exchange == "halo_async" else exchange


@dataclasses.dataclass
class BlockShardCsr:
    """Per-shard ELL-block-CSR adjacency, stacked over all partitions.

    One entry per sender index space: tile ``[p, i, m]`` scatters source
    rows ``cols[p, i, m]*B .. +B`` of that space into local output rows
    ``i*B .. +B`` of partition ``p``. ``mask`` is 1.0 for real tiles, 0.0
    for ELL padding (all-zero tiles pointing at source block 0). All
    partitions share one ``M`` (max tiles per row-block across shards).
    """
    blocks: np.ndarray   # f32[n, VB, M, B, B]
    cols: np.ndarray     # i32[n, VB, M]
    mask: np.ndarray     # f32[n, VB, M]
    src_rows: int        # padded source-table rows (multiple of B)
    out_rows: int        # VB * B (>= slots; slice back to slots)


def _stack_block_shards(edge_sets, out_size: int, src_size: int,
                        block: int = BLOCK,
                        prev: Optional[BlockShardCsr] = None,
                        clean: Optional[np.ndarray] = None) -> BlockShardCsr:
    """Build one block-CSR per partition and ELL-pad them to a common M.

    ``prev``/``clean`` enable the dirty-shard rebuild: for partitions with
    ``clean[p]`` True, the (expensive) ``build_block_csr`` call is skipped
    and shard ``p``'s tiles are sliced out of ``prev`` instead.  Reuse is
    only legal when the stacked layout is compatible (same partition count,
    padded output rows and padded source rows); otherwise everything is
    rebuilt.  Real tiles are packed first per row-block, so slicing the
    first ``M_p`` tile slots of a clean shard carries them all.
    """
    vb = -(-out_size // block)
    n = len(edge_sets)
    src_rows = int(-(-src_size // block) * block)
    reuse = (prev is not None and clean is not None
             and prev.blocks.shape[0] == n
             and prev.out_rows == vb * block and prev.src_rows == src_rows)
    built = {}
    per_shard_m = np.zeros(n, np.int64)
    for p, (s, r) in enumerate(edge_sets):
        if reuse and clean[p]:
            per_shard_m[p] = max(1, int(prev.mask[p].sum(axis=1).max()))
        else:
            built[p] = build_block_csr(s, r, out_size, block)
            per_shard_m[p] = built[p][0].shape[1]
    m = int(per_shard_m.max())
    blocks = np.zeros((n, vb, m, block, block), np.float32)
    cols = np.zeros((n, vb, m), np.int32)
    mask = np.zeros((n, vb, m), np.float32)
    for p in range(n):
        mp = int(per_shard_m[p])
        if p in built:
            b, c, k, _ = built[p]
        else:
            b, c, k = (prev.blocks[p, :, :mp], prev.cols[p, :, :mp],
                       prev.mask[p, :, :mp])
        blocks[p, :, :mp] = b
        cols[p, :, :mp] = c
        mask[p, :, :mp] = k
    # The SpMM kernels index the source table by block with no bounds
    # check — guarantee here (where cols are concrete) that a table padded
    # to src_rows covers every referenced column block.
    assert int(cols.max()) < src_rows // block, (cols.max(), src_rows)
    return BlockShardCsr(blocks=blocks, cols=cols, mask=mask,
                         src_rows=src_rows, out_rows=vb * block)


@dataclasses.dataclass
class PartitionedGraph:
    """Static-shape per-partition buffers for multi-fog execution."""
    n: int                      # number of partitions (mesh size)
    slots: int                  # P: padded vertices per partition
    edges_per_part: int         # E: padded edges per partition
    boundary_slots: int         # B: padded boundary rows per partition
    feats: np.ndarray           # [n, P, F] local features (padded rows = 0)
    vertex_mask: np.ndarray     # [n, P] 1 for real vertices
    # Edge connectivity, partitioned by the *receiver*'s owner:
    senders_global: np.ndarray  # [n, E] index into flattened [n*P] table
    senders_halo: np.ndarray    # [n, E] index into flattened [n*B] boundary table
    receivers_local: np.ndarray # [n, E] 0..P-1
    edge_mask: np.ndarray       # [n, E]
    # Boundary packing: rows each partition contributes to the halo table.
    boundary_rows: np.ndarray   # [n, B] local slot ids (padded w/ 0)
    boundary_mask: np.ndarray   # [n, B]
    # Self-edges for GAT (senders point at own row in the gathered table).
    self_senders_global: np.ndarray  # [n, P]
    self_senders_halo: np.ndarray    # [n, P]
    # Inverse permutation: result row for global vertex v lives at
    # (part[v], slot[v]).
    part_of: np.ndarray         # [V]
    slot_of: np.ndarray         # [V]
    # Pre-blocked shard-local adjacency for the kernel aggregation path:
    # sum-aggregate = local_csr @ h_local + halo_csr @ gathered_halo.
    # None when build_partitioned ran with build_blocks=False.
    local_csr: Optional[BlockShardCsr] = None
    halo_csr: Optional[BlockShardCsr] = None
    # Device copies of the layout's buffers, keyed (device, what) and built
    # once at first use (see _on_device). ``with_features`` shares this
    # dict, so a query re-uploads only its features; a layout built anew
    # (after a migration) starts empty.
    device_cache: dict = dataclasses.field(default_factory=dict,
                                           compare=False, repr=False)

    def unpermute(self, out: np.ndarray) -> np.ndarray:
        """[n, P, D] stacked partition outputs -> [V, D] original order."""
        return out[self.part_of, self.slot_of]

    def unpermute_stack(self, out: np.ndarray) -> np.ndarray:
        """[n, B, P, D] batched partition outputs -> [B, V, D]."""
        return np.moveaxis(out[self.part_of, :, self.slot_of], 0, 1)

    def feature_stack(self, features: np.ndarray) -> np.ndarray:
        """[B, V, F] micro-batch -> [n, B, P, F] per-partition tables.

        The batched counterpart of ``with_features``: every example is
        scattered into the same padded slot layout (padded rows zero), so
        one multi-fog launch can serve the whole batch.
        """
        features = np.asarray(features, np.float32)
        b, v, f = features.shape
        feats = np.zeros((self.n, b, self.slots, f), np.float32)
        feats[self.part_of, :, self.slot_of] = np.moveaxis(features, 0, 1)
        return feats

    def with_features(self, features: np.ndarray) -> "PartitionedGraph":
        """Same layout (and block-CSR shards), fresh per-vertex features.

        Serving calls this once per query — the partition structure is
        feature-independent, so only the [n, P, F] table is rebuilt.
        """
        features = np.asarray(features, np.float32)
        feats = np.zeros((self.n, self.slots, features.shape[1]), np.float32)
        feats[self.part_of, self.slot_of] = features
        return dataclasses.replace(self, feats=feats)


def build_partitioned(g: Graph, assignment: np.ndarray,
                      pad_multiple: int = 8,
                      build_blocks: bool = True,
                      n: Optional[int] = None,
                      prev: Optional["PartitionedGraph"] = None,
                      dirty_local: Optional[np.ndarray] = None,
                      dirty_halo: Optional[np.ndarray] = None
                      ) -> PartitionedGraph:
    """Lay the graph out per-partition with static padded shapes.

    Padding conventions: every partition shares one slot count P (max
    partition size rounded up to ``pad_multiple``), one edge capacity E
    and one boundary capacity B; padded rows/edges carry zeroed features
    and 0.0 masks. Empty partitions (``assignment`` skipping a part id)
    and single-vertex shards are legal — they simply pad everywhere.
    ``n`` pins the partition count (needed when trailing partitions may be
    empty, e.g. after a graph update empties a shard).

    ``build_blocks=True`` additionally pre-blocks each shard's adjacency
    into the two ELL-block-CSR operands of the kernel aggregation path
    (``local_csr`` over the P local slots, ``halo_csr`` over the [n*B]
    gathered halo table); pass False to skip that host-side work when only
    the segment-sum path will run.

    Dirty-shard rebuild: ``prev`` (a layout for the *previous* revision of
    the graph) plus ``dirty_local`` / ``dirty_halo`` (partition ids whose
    operands a graph delta invalidated — see
    ``core.incremental.dirty_partitions``) reuse every clean shard's
    pre-blocked operands instead of re-blocking them.  The cheap padded COO
    buffers are always recomputed, so the result is bit-identical to a
    from-scratch build; reuse silently degrades to a full re-block when the
    padded layout is incompatible (slot/boundary capacity changed).
    """
    assignment = np.asarray(assignment, np.int64)
    n = (int(assignment.max()) + 1) if n is None else int(n)
    parts: List[np.ndarray] = [np.flatnonzero(assignment == p) for p in range(n)]
    sizes = np.array([len(p) for p in parts])
    slots = int(-(-sizes.max() // pad_multiple) * pad_multiple)

    part_of = assignment
    slot_of = np.zeros(g.num_vertices, np.int64)
    for p, vs in enumerate(parts):
        slot_of[vs] = np.arange(len(vs))

    f = g.feature_dim
    feats = np.zeros((n, slots, f), np.float32)
    vmask = np.zeros((n, slots), np.float32)
    for p, vs in enumerate(parts):
        feats[p, :len(vs)] = g.features[vs]
        vmask[p, :len(vs)] = 1.0

    # Edges grouped by receiver's partition.
    recv_part = part_of[g.receivers]
    edge_lists = [np.flatnonzero(recv_part == p) for p in range(n)]
    e_max = max(1, max(len(e) for e in edge_lists))
    e_pad = int(-(-e_max // pad_multiple) * pad_multiple)

    # Boundary rows: vertices read by any foreign partition.
    boundary_ids = []
    for p in range(n):
        cross = (part_of[g.senders] == p) & (recv_part != p)
        boundary_ids.append(np.unique(g.senders[cross]))
    b_max = max(1, max(len(b) for b in boundary_ids))
    b_pad = int(-(-b_max // pad_multiple) * pad_multiple)

    # halo index of vertex v (valid only if v is in its owner's boundary set)
    halo_slot = np.zeros(g.num_vertices, np.int64)
    for p, bs in enumerate(boundary_ids):
        halo_slot[bs] = np.arange(len(bs))

    senders_global = np.zeros((n, e_pad), np.int32)
    senders_halo = np.zeros((n, e_pad), np.int32)
    receivers_local = np.zeros((n, e_pad), np.int32)
    edge_mask = np.zeros((n, e_pad), np.float32)
    boundary_rows = np.zeros((n, b_pad), np.int32)
    boundary_mask = np.zeros((n, b_pad), np.float32)
    local_edges, halo_edges = [], []
    for p in range(n):
        eids = edge_lists[p]
        s, r = g.senders[eids], g.receivers[eids]
        k = len(eids)
        senders_global[p, :k] = part_of[s] * slots + slot_of[s]
        # local senders also appear in the halo table? no — local senders are
        # read from the local shard directly in halo mode: point them at the
        # *own* boundary copy when they are boundary rows, else we route local
        # edges through the local table. To keep a single gather, halo mode
        # uses a combined table [local P rows | n*B halo rows]; local senders
        # use their local slot, remote senders use P + their halo position.
        local = part_of[s] == p
        senders_halo[p, :k] = np.where(
            local, slot_of[s],
            slots + part_of[s] * b_pad + halo_slot[s]).astype(np.int32)
        receivers_local[p, :k] = slot_of[r]
        edge_mask[p, :k] = 1.0
        bs = boundary_ids[p]
        boundary_rows[p, :len(bs)] = slot_of[bs]
        boundary_mask[p, :len(bs)] = 1.0
        # Unpadded per-shard edge splits for the block-CSR (kernel) path:
        # local senders read the shard's own rows, remote senders read the
        # gathered [n*B] halo table.
        local_edges.append((slot_of[s[local]], slot_of[r[local]]))
        halo_edges.append((part_of[s[~local]] * b_pad + halo_slot[s[~local]],
                           slot_of[r[~local]]))

    self_g = np.zeros((n, slots), np.int32)
    self_h = np.zeros((n, slots), np.int32)
    for p in range(n):
        self_g[p] = p * slots + np.arange(slots)
        self_h[p] = np.arange(slots)  # local rows in combined halo table

    local_csr = halo_csr = None
    if build_blocks:
        # Clean masks for shard reuse: with no prev layout (or no dirty
        # information) everything is rebuilt; shard-level compatibility
        # guards live in _stack_block_shards.
        prev_l = prev_h = clean_l = clean_h = None
        if (prev is not None and prev.n == n and prev.slots == slots
                and dirty_local is not None and dirty_halo is not None):
            if prev.local_csr is not None:
                prev_l = prev.local_csr
                clean_l = np.ones(n, bool)
                clean_l[np.asarray(dirty_local, np.int64)] = False
            if prev.halo_csr is not None and prev.boundary_slots == b_pad:
                prev_h = prev.halo_csr
                clean_h = np.ones(n, bool)
                clean_h[np.asarray(dirty_halo, np.int64)] = False
        local_csr = _stack_block_shards(local_edges, slots, slots,
                                        prev=prev_l, clean=clean_l)
        halo_csr = _stack_block_shards(halo_edges, slots, n * b_pad,
                                       prev=prev_h, clean=clean_h)

    return PartitionedGraph(
        n=n, slots=slots, edges_per_part=e_pad, boundary_slots=b_pad,
        feats=feats, vertex_mask=vmask,
        senders_global=senders_global, senders_halo=senders_halo,
        receivers_local=receivers_local, edge_mask=edge_mask,
        boundary_rows=boundary_rows, boundary_mask=boundary_mask,
        self_senders_global=self_g, self_senders_halo=self_h,
        part_of=part_of, slot_of=slot_of,
        local_csr=local_csr, halo_csr=halo_csr)


# ----------------------------------------------------------------------------
# Device programs: the n shards folded into the row axis of one device
# ----------------------------------------------------------------------------

def _layer_edges(slots: int, senders: torch.Tensor, kind: str,
                 self_senders: torch.Tensor, receivers: torch.Tensor,
                 emask: torch.Tensor, vmask: torch.Tensor) -> EdgeList:
    """One layer's EdgeList over the folded [n*P] receiver rows.

    ``senders`` [n, E] already index the folded source table;
    ``receivers`` [n, E] are shard-local slots, moved here to shard p's
    rows ``p*P ..``. GAT gets explicit self-edges (``self_senders``
    [n, P], masked by ``vmask``) after each shard's own edges, as the
    reference appends them per shard.
    """
    n = receivers.shape[0]
    if kind == "gat":
        own = torch.arange(slots, dtype=receivers.dtype,
                           device=receivers.device).expand(n, slots)
        senders = torch.cat([senders, self_senders], 1)
        receivers = torch.cat([receivers, own], 1)
        emask = torch.cat([emask, vmask], 1)
    offset = torch.arange(n, dtype=receivers.dtype,
                          device=receivers.device)[:, None] * slots
    return EdgeList(senders.reshape(-1), (receivers + offset).reshape(-1),
                    emask.reshape(-1), n * slots)


def _wire_quantize(h: torch.Tensor, levels: float = 255.0):
    """Per-row linear quantization of the halo wire payload.

    Mirrors ``compression._quantize_rows`` at 8 bits: uint8 codes plus one
    f32 (scale, min) pair per row, rounding half to even. All-zero
    (masked padding) rows get code 0 / scale ~0 / min 0 and dequantize to
    exactly 0. ``h`` may carry leading batch axes: the reductions run over
    the feature (last) axis, so batched quantization is bitwise the
    single-query call per row.
    """
    mins = h.amin(dim=-1)
    scales = torch.clamp_min(h.amax(dim=-1) - mins, 1e-12) / levels
    codes = torch.clamp(torch.round((h - mins[..., None]) / scales[..., None]),
                        0, levels).to(torch.uint8)
    return codes, scales, mins


def _kernel_pad(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Zero-pad the row axis (second to last) of a source table to the
    kernel grid's ``rows``. The kernels mask the ragged feature edge
    themselves, so features stay unpadded."""
    return F.pad(x, (0, 0, 0, rows - x.shape[-2]))


def _gathered_stack(x: torch.Tensor) -> torch.Tensor:
    """[n, B, R, F] per-shard stack -> [B, n*R, F] per-example tables
    (pure data movement; rows land in the order the serial path's
    ``.reshape(-1, f)`` gives them)."""
    n, b = x.shape[:2]
    return x.movedim(0, 1).reshape((b, n * x.shape[2]) + x.shape[3:])


def _on_device(pg: PartitionedGraph, device: torch.device, what, build):
    """``build()`` for this layout and device, built once and kept in
    ``pg.device_cache`` (shared by ``with_features`` copies)."""
    key = (str(device), what)
    if key not in pg.device_cache:
        pg.device_cache[key] = build()
    return pg.device_cache[key]


@dataclasses.dataclass(frozen=True)
class _Layout:
    """The layout's row bookkeeping on one device, folded over shards."""
    vertex_mask: torch.Tensor     # f32[n*P, 1]
    boundary_index: torch.Tensor  # i64[n*B]: folded row of each halo row
    boundary_mask: torch.Tensor   # f32[n*B, 1]
    result_index: torch.Tensor    # i64[V]: folded row of each vertex


def _layout(pg: PartitionedGraph, device: torch.device) -> _Layout:
    def build():
        shard_rows = np.arange(pg.n)[:, None] * pg.slots
        return _Layout(
            vertex_mask=torch.as_tensor(pg.vertex_mask.reshape(-1, 1),
                                        device=device),
            boundary_index=torch.as_tensor(
                (shard_rows + pg.boundary_rows).reshape(-1), device=device),
            boundary_mask=torch.as_tensor(pg.boundary_mask.reshape(-1, 1),
                                          device=device),
            result_index=torch.as_tensor(pg.part_of * pg.slots + pg.slot_of,
                                         device=device))
    return _on_device(pg, device, "layout", build)


def _edges(pg: PartitionedGraph, device: torch.device, exchange: str,
           kind: str) -> EdgeList:
    """The folded EdgeList of ``exchange``: over the [n*P | n*B] table
    (local rows, then the halo table) for ``halo``, over the [n*P] table
    for ``allgather``."""
    def build():
        put = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        if exchange == "allgather":
            senders = put(pg.senders_global)
            self_senders = put(pg.self_senders_global)
        else:
            # Shard p's combined table is [its P rows | the n*B halo
            # rows]: local slot s is folded row p*P + s, halo row s - P
            # is row n*P + s - P.
            n, slots = pg.n, pg.slots
            shard = np.arange(n, dtype=np.int32)[:, None] * slots
            halo = pg.senders_halo
            senders = put(halo + np.where(halo < slots, shard,
                                          np.int32((n - 1) * slots)))
            self_senders = put(pg.self_senders_halo + shard)
        return _layer_edges(pg.slots, senders, kind, self_senders,
                            put(pg.receivers_local), put(pg.edge_mask),
                            put(pg.vertex_mask))
    return _on_device(pg, device, ("edges", exchange, kind == "gat"), build)


@dataclasses.dataclass(frozen=True)
class _FoldedCsr:
    """A BlockShardCsr on one device with its shard axis folded into the
    row-block axis: one launch aggregates every shard."""
    blocks: torch.Tensor   # f32[n*VB, M, B, B]
    cols: torch.Tensor     # i32[n*VB, M]
    mask: torch.Tensor     # f32[n*VB, M]
    rows: TileRows         # the tiles' nonzeros per row (CUDA kernels)
    max_col: int           # largest entry of cols (host bounds check)
    src_rows: int          # rows of the source table the launch reads
    out_rows: int          # output rows per shard (VB * B)


def _fold(csr: BlockShardCsr, device: torch.device,
          per_shard_source: bool) -> _FoldedCsr:
    """``per_shard_source``: shard p reads its own block of a stacked
    [n * src_rows] table (local operand), so its column blocks move by
    ``p * src_rows / B``; otherwise every shard reads one shared table
    (the halo operand)."""
    n, vb, m = csr.cols.shape
    cols, src_rows = csr.cols, csr.src_rows
    if per_shard_source:
        cols = cols + (np.arange(n, dtype=np.int32)
                       * (src_rows // BLOCK))[:, None, None]
        src_rows *= n

    def put(a):
        return torch.as_tensor(a.reshape((n * vb,) + a.shape[2:]),
                               device=device)
    blocks, cols_t, mask = put(csr.blocks), put(cols), put(csr.mask)
    return _FoldedCsr(blocks, cols_t, mask,
                      compact_block_csr(blocks, cols_t, mask),
                      int(cols.max()), src_rows, csr.out_rows)


def _folded_csrs(pg: PartitionedGraph, device: torch.device):
    return _on_device(pg, device, "csr", lambda: (
        _fold(pg.local_csr, device, True), _fold(pg.halo_csr, device, False)))


def _kernel_sum(pg: PartitionedGraph, h: torch.Tensor, lay: _Layout,
                local: _FoldedCsr, halo: _FoldedCsr,
                halo_quant: bool) -> torch.Tensor:
    """Every shard's neighbor SUM = local SpMM + halo SpMM, one launch
    each for all shards. ``h`` is the folded [n*P, F] table or a
    [B, n*P, F] stack (then the batched kernels run)."""
    n, slots = pg.n, pg.slots
    lead, f = h.shape[:-2], h.shape[-1]
    batched = h.ndim == 3
    spmm = block_spmm_batched if batched else block_spmm
    loc = _kernel_pad(h.reshape(lead + (n, slots, f)), local.src_rows // n)
    out = spmm(local.blocks, local.cols, local.mask,
               loc.reshape(lead + (local.src_rows, f)), rows=local.rows,
               max_col=local.max_col)
    hb = h[..., lay.boundary_index, :] * lay.boundary_mask   # [.., n*B, F]
    if halo_quant:
        codes, sc, mn = _wire_quantize(hb)
        pad = (0, halo.src_rows - sc.shape[-1])
        dq = dequant_spmm_batched if batched else dequant_spmm
        out_h = dq(halo.blocks, halo.cols, halo.mask,
                   _kernel_pad(codes, halo.src_rows), F.pad(sc, pad),
                   F.pad(mn, pad), rows=halo.rows, max_col=halo.max_col)
    else:
        out_h = spmm(halo.blocks, halo.cols, halo.mask,
                     _kernel_pad(hb, halo.src_rows), rows=halo.rows,
                     max_col=halo.max_col)

    def shard_rows(o):
        o = o.reshape(lead + (n, local.out_rows, f))[..., :slots, :]
        return o.reshape(lead + (n * slots, f))
    return shard_rows(out) + shard_rows(out_h)


def _resolve(kind: str, pg: PartitionedGraph, exchange: str,
             aggregation: str, halo_quant: bool, device) -> Tuple[str, bool]:
    """(wire exchange, kernel path?) of one run; raises on what the
    layout or the knobs cannot serve."""
    mode = resolve_aggregation(aggregation, kind, exchange=exchange,
                               device=device)
    use_kernels = mode == "pallas"
    if use_kernels and (pg.local_csr is None or pg.halo_csr is None):
        raise ValueError(
            "aggregation='pallas' needs the block-CSR shards; rebuild the "
            "PartitionedGraph with build_partitioned(..., build_blocks=True)")
    if halo_quant and not use_kernels:
        raise ValueError("halo_quant requires the 'pallas' aggregation path")
    return _wire_exchange(exchange), use_kernels


def _run(params, kind: str, pg: PartitionedGraph, h: torch.Tensor,
         exchange: str, aggregation: str, halo_quant: bool) -> torch.Tensor:
    """K-layer BSP forward on the folded table ``h`` ([n*P, F], or a
    [B, n*P, F] stack) -> the folded output, on ``h``'s device.

    The kernel path runs one local and one halo launch per layer for the
    whole stack, then the dense tail example by example; the segment-sum
    path runs a stack example by example. Either way every example is
    bitwise its serial run.
    """
    device = h.device
    exchange, use_kernels = _resolve(kind, pg, exchange, aggregation,
                                     halo_quant, device)
    if exchange not in ("halo", "allgather"):
        raise ValueError(exchange)
    if h.ndim == 3 and not use_kernels:
        return torch.stack([_run(params, kind, pg, hh, exchange,
                                 aggregation, halo_quant) for hh in h])
    lay = _layout(pg, device)
    edges = _edges(pg, device, exchange, kind)
    if use_kernels:
        local, halo = _folded_csrs(pg, device)
    _, layer_fn = LAYER_FNS[kind]
    for li, p in enumerate(params):
        last = li == len(params) - 1
        if use_kernels:
            a_sum = _kernel_sum(pg, h, lay, local, halo, halo_quant)
            h = apply_layer_with_sum(kind, p, h, edges, a_sum, last=last)
        else:
            h_src = h if exchange == "allgather" else torch.cat(
                [h, h[lay.boundary_index] * lay.boundary_mask])
            kwargs = {"activation": None} if last else {}
            h = layer_fn(p, h, edges, h_src=h_src, **kwargs)
        h = h * lay.vertex_mask   # keep padded rows at zero
    return h


def bsp_apply(params, kind: str, pg: PartitionedGraph,
              exchange: str = "halo", aggregation: str = "segment_sum",
              halo_quant: bool = False,
              device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """Distributed K-layer GNN inference; returns [n, P, D] on ``device``.

    ``aggregation`` selects the shard-local aggregation path (see module
    docstring); ``halo_quant=True`` (kernel path only) quantizes the halo
    rows to uint8 before the exchange and dequantizes them inside the
    fused ``dequant_spmm`` kernel — the wire carries 1 byte/feature plus
    8 bytes/row instead of 4 bytes/feature.
    """
    h = torch.as_tensor(pg.feats, device=torch.device(device))
    out = _run(params, kind, pg, h.reshape(pg.n * pg.slots, -1), exchange,
               aggregation, halo_quant)
    return out.reshape(pg.n, pg.slots, -1)


def bsp_apply_many(params, kind: str, pg: PartitionedGraph,
                   feat_stack: np.ndarray, exchange: str = "halo",
                   aggregation: str = "segment_sum", halo_quant: bool = False,
                   device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """Distributed inference over a whole micro-batch.

    ``feat_stack`` is the [n, B, P, F] table from
    ``PartitionedGraph.feature_stack``; returns [n, B, P, D]. On the
    kernel path each layer's exchange ships every example's boundary rows
    at once and the batched kernels aggregate the whole stack in one local
    and one halo launch. Every example is bitwise the serial
    ``bsp_apply``.
    """
    h = _gathered_stack(torch.as_tensor(feat_stack,
                                        device=torch.device(device)))
    out = _run(params, kind, pg, h, exchange, aggregation, halo_quant)
    return out.reshape(h.shape[0], pg.n, pg.slots, -1).movedim(0, 1)


def bsp_infer(params, kind: str, g: Graph, assignment: np.ndarray,
              device: Union[str, torch.device] = "cuda",
              exchange: str = "halo", aggregation: str = "segment_sum",
              halo_quant: bool = False,
              pg: Optional[PartitionedGraph] = None) -> np.ndarray:
    """End-to-end distributed inference -> [V, D] numpy in original
    vertex order.

    ``pg`` reuses prebuilt partition buffers (the features are refreshed
    from ``g``, the device copies of the layout are kept), which is what
    the serving path does per query.
    """
    device = torch.device(device)
    if pg is None:
        mode = resolve_aggregation(aggregation, kind, exchange=exchange,
                                   device=device)
        pg = build_partitioned(g, assignment, build_blocks=mode == "pallas")
    else:
        pg = pg.with_features(g.features)
    out = bsp_apply(params, kind, pg, exchange, aggregation, halo_quant,
                    device)
    rows = out.reshape(pg.n * pg.slots, -1)
    return rows[_layout(pg, device).result_index].cpu().numpy()


def bsp_infer_many(params, kind: str, feats: np.ndarray,
                   pg: PartitionedGraph,
                   device: Union[str, torch.device] = "cuda",
                   exchange: str = "halo", aggregation: str = "segment_sum",
                   halo_quant: bool = False) -> np.ndarray:
    """Batched end-to-end distributed inference -> [B, V, D] numpy.

    ``feats`` is a [B, V, F] stacked micro-batch; the prebuilt ``pg``
    supplies the layout (and block-CSR shards for the kernel path).
    """
    feats = np.asarray(feats, np.float32)
    if feats.ndim != 3:
        raise ValueError(f"bsp_infer_many takes a [B, V, F] stack, got "
                         f"shape {feats.shape}")
    device = torch.device(device)
    h = _gathered_stack(torch.as_tensor(pg.feature_stack(feats),
                                        device=device))
    out = _run(params, kind, pg, h, exchange, aggregation, halo_quant)
    return out[:, _layout(pg, device).result_index].cpu().numpy()


def _not_ported(name: str, item: str):
    def entry(*args, **kwargs):
        raise NotImplementedError(f"bsp.{name} is not ported yet: ROADMAP "
                                  f"Queue 1 item {item}")
    entry.__name__ = name
    return entry


bsp_infer_capture = _not_ported("bsp_infer_capture",
                                "1, incremental frontier queries")
bsp_infer_capture_many = _not_ported("bsp_infer_capture_many",
                                     "1, incremental frontier queries")
bsp_infer_frontier = _not_ported("bsp_infer_frontier",
                                 "1, incremental frontier queries")
bsp_infer_frontier_many = _not_ported("bsp_infer_frontier_many",
                                      "1, incremental frontier queries")
bsp_infer_stale = _not_ported("bsp_infer_stale", "2, fleet and stale halos")
bsp_infer_stale_many = _not_ported("bsp_infer_stale_many",
                                   "2, fleet and stale halos")
build_halo_tables = _not_ported("build_halo_tables",
                                "2, fleet and stale halos")


def exchange_bytes(pg: PartitionedGraph, feature_dim: int,
                   exchange: str, dtype_bytes: int = 4,
                   row_overhead_bytes: int = 0) -> int:
    """Collective payload per BSP sync (for the communication roofline).

    ``dtype_bytes``/``row_overhead_bytes`` describe the wire format: the
    float32 exchange is (4, 0); the DAQ-fused kernel path ships uint8
    codes plus one f32 (scale, min) pair per row, i.e. (1, 8).
    """
    per_row = feature_dim * dtype_bytes + row_overhead_bytes
    if exchange == "allgather":
        return pg.n * pg.slots * per_row
    return pg.n * pg.boundary_slots * per_row


@dataclasses.dataclass(frozen=True)
class ExchangeSpec:
    """An EXCHANGES registry entry: one per-layer cross-fog exchange.

    ``stale_tolerant`` marks modes whose serves may replay recorded halo
    tables up to a staleness bound instead of running the collective
    (``EngineConfig.staleness_bound`` only applies to those entries).

    ``retryable`` + the retry knobs are the tier-1 fault-recovery hook:
    a transient loss of this exchange is retried with exponential
    backoff (``backoff_base_s * backoff_mult**k`` after failed attempt
    ``k``), bounded by ``max_retries`` attempts and a ``retry_timeout_s``
    hard deadline; :meth:`recovery_cost` prices the walk on the
    simulated clock. Exhausting the budget escalates to the next tier
    (stale ride-through, then shard failover).
    """
    name: str
    stale_tolerant: bool = False
    retryable: bool = False
    max_retries: int = 4
    backoff_base_s: float = 0.02
    backoff_mult: float = 2.0
    retry_timeout_s: float = 1.0

    def bytes_per_sync(self, pg: PartitionedGraph, feature_dim: int,
                       dtype_bytes: int = 4,
                       row_overhead_bytes: int = 0) -> int:
        """Wire bytes of one FRESH sync (a stale halo_async serve ships
        zero bytes — it replays recorded tables)."""
        return exchange_bytes(pg, feature_dim, _wire_exchange(self.name),
                              dtype_bytes, row_overhead_bytes)

    def recovery_cost(self, losses: int, sync_cost: float
                      ) -> "Tuple[float, int, bool]":
        """Price recovering ``losses`` consecutive transient losses of
        this exchange: ``(seconds, attempts, succeeded)``. A
        non-retryable exchange fails immediately at zero cost (the
        caller escalates straight past tier 1)."""
        if not self.retryable:
            return 0.0, 0, False
        from repro_torch.core import simulation   # lazy: keep module load light
        return simulation.simulate_retry(
            losses, sync_cost=sync_cost, base=self.backoff_base_s,
            mult=self.backoff_mult, max_attempts=self.max_retries,
            timeout=self.retry_timeout_s)


EXCHANGES.register("halo", ExchangeSpec("halo", retryable=True))
EXCHANGES.register("allgather", ExchangeSpec("allgather", retryable=True))
EXCHANGES.register("halo_async", ExchangeSpec("halo_async",
                                              stale_tolerant=True,
                                              retryable=True))
