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
``bsp_infer`` / ``bsp_infer_many`` and the capture, stale and frontier
entry points) runs the shards one of two ways:

  * ``group=None`` folds the n shards onto ONE torch device: the shard
    axis is folded into the row axis, so shard ``p``'s slot ``i`` is row
    ``p*P + i`` of one [n*P, F] table, and the all_gather of the boundary
    rows is a gather of those rows into one [n*B, F] halo table that every
    shard reads. A layer is one program over all shards.
  * a ``torch.distributed`` process group of n ranks (the reference's
    ``mesh``) runs shard ``r`` alone on rank ``r``, on the ``device`` it
    was given: the same program over one shard, [P, F] rows. Its exchange
    is an ``all_gather`` of its boundary rows (or their DAQ codes, scales
    and mins) into the same [n*B, F] halo table (``runtime.dist``); every
    rank returns the whole result, in original vertex order. Per row, the
    sums run in the folded path's order, and the dense tail runs on the
    rank's rows placed in a zero [n*P, F] table (``_Fogs.spread``), so its
    products have the folded shapes: a rank's rows are bitwise the folded
    ones for every kind. A plan's group (``runtime.dist.FogGroup``) may be
    a part of the world, as after a failover: shard ``r`` then runs on the
    group's ``r``-th rank, and a rank outside it holds no shard, launches
    nothing, enters no sync and receives the result from the group.

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
from repro_torch.gnn.layers import (EdgeList, LAYER_FNS, SELF_LOOP_KINDS,
                                    apply_layer_with_sum)
from repro_torch.kernels.daq_dequant import (dequant_spmm,
                                             dequant_spmm_batched)
from repro_torch.kernels.gather_aggregate import (BLOCK, RowSubset, TileRows,
                                                  block_spmm,
                                                  block_spmm_batched,
                                                  build_block_csr,
                                                  compact_block_csr,
                                                  row_subset)
from repro_torch.kernels.stage_rows import stage_rows
from repro_torch.runtime import dist as fog_dist
from repro_torch.runtime.trace import span

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
# Device programs: the shards a process holds, folded into the row axis of
# its device (all n with no process group, its rank's one with a group)
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Fogs:
    """The shards this process runs: all ``n`` folded onto its device
    (``group`` None), or shard ``rank`` of the ``n`` fogs of ``group`` (a
    ``runtime.dist.FogGroup``), none with ``rank`` -1 (outside it)."""
    n: int
    group: object = None
    rank: int = 0

    @property
    def m(self) -> int:
        """Shards held, folded into the row axis of the local tables."""
        if self.group is None:
            return self.n
        return 1 if self.rank >= 0 else 0

    def key(self, what):
        """``what``'s device-cache key: the folded path keeps its plain
        names; a rank's operands carry its shard."""
        return what if self.group is None else (what, self.rank)

    def pick(self, a: np.ndarray) -> np.ndarray:
        """The held shards' entries of a per-shard [n, ...] host array."""
        return a if self.group is None else a[self.rank:self.rank + self.m]

    def spread(self, x: torch.Tensor, slots: int,
               dim: int = -2) -> torch.Tensor:
        """The held shards' rows of ``x`` (along ``dim``) at their place in
        the folded [.., n*P, ..] table, zeros elsewhere. A rank's dense
        tail runs on this table: its products then have the folded shapes
        (a product's reduction order may depend on its shape), so its rows
        come out bitwise the folded ones."""
        if self.group is None:
            return x
        shape = list(x.shape)
        shape[dim] = self.n * slots
        out = x.new_zeros(shape)
        out.narrow(dim, self.rank * slots, slots).copy_(x)
        return out

    def own(self, x: torch.Tensor, slots: int) -> torch.Tensor:
        """The held shards' rows of a [.., n*P, F] table from ``spread``."""
        if self.group is None:
            return x
        return x.narrow(-2, self.rank * slots, slots)


def _fogs(pg: PartitionedGraph, group, device: torch.device) -> _Fogs:
    """The shards of this process for ``group`` (a ``runtime.dist.FogGroup``
    or a process group, one fog a rank); with a group, its fogs must be
    ``pg.n``, and before the first run on this layout every rank the
    result reaches checks that all of them hold the same assignment."""
    if group is None:
        return _Fogs(pg.n)
    group = fog_dist.as_fog_group(group)
    if len(group.ranks) != pg.n:
        raise ValueError(f"need {pg.n} ranks for {pg.n} partitions, the "
                         f"process group has {len(group.ranks)}")
    fogs = _Fogs(pg.n, group, group.shard)

    def agree():
        fog_dist.check_same(fog_dist.digest(
            pg.part_of, np.array([pg.n, pg.slots, pg.boundary_slots]),
            np.array(group.ranks)), group.over, device,
            "the partition assignment")
        return True
    _on_device(pg, device, fogs.key("agreed"), agree)
    return fogs


def _layer_edges(slots: int, senders: torch.Tensor, kind: str,
                 self_senders: torch.Tensor, receivers: torch.Tensor,
                 emask: torch.Tensor, vmask: torch.Tensor,
                 fogs: _Fogs) -> EdgeList:
    """One layer's EdgeList of the held shards over the folded [n*P]
    receiver rows.

    ``senders`` [m, E] already index the folded source table;
    ``receivers`` [m, E] are shard-local slots, moved here to shard p's
    rows ``p*P ..``. GAT (``SELF_LOOP_KINDS``) gets explicit self-edges
    (``self_senders`` [m, P], masked by ``vmask``) after each shard's own
    edges, as the reference appends them per shard.
    """
    m = receivers.shape[0]
    if kind in SELF_LOOP_KINDS:
        slot = torch.arange(slots, dtype=receivers.dtype,
                            device=receivers.device).expand(m, slots)
        senders = torch.cat([senders, self_senders], 1)
        receivers = torch.cat([receivers, slot], 1)
        emask = torch.cat([emask, vmask], 1)
    offset = (fogs.rank + torch.arange(m, dtype=receivers.dtype,
                                       device=receivers.device))[:, None]
    return EdgeList(senders.reshape(-1),
                    (receivers + offset * slots).reshape(-1),
                    emask.reshape(-1), fogs.n * slots)


def _wire_quantize(h: torch.Tensor, levels: float = 255.0):
    """Per-row linear quantization of the halo wire payload.

    Mirrors ``compression._quantize_rows`` at 8 bits: uint8 codes plus one
    f32 (scale, min) pair per row, rounding half to even. All-zero
    (masked padding) rows get code 0 / scale ~0 / min 0 and dequantize to
    exactly 0. ``h`` may carry leading batch axes: the reductions run over
    the feature (last) axis, so batched quantization is bitwise the
    single-query call per row (and a rank's rows are bitwise the same rows
    quantized in the folded table).
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
    """The layout's row bookkeeping on one device, folded over the held
    shards."""
    vertex_mask: torch.Tensor     # f32[m*P, 1]
    boundary_index: torch.Tensor  # i64[m*B]: folded row of each halo row
    boundary_mask: torch.Tensor   # f32[m*B, 1]
    result_index: torch.Tensor    # i64[V]: row of each vertex in [n*P]
    # i32[m*P]: the held vertex (its index among ``held``, or among all V
    # when folded) that each folded row stages, -1 for a padded slot
    row_src: torch.Tensor
    held: Optional[np.ndarray]    # a rank's vertices in vertex order


def _staging(pg: PartitionedGraph, fogs: _Fogs):
    """(row_src, held) of the held shards: folded, row ``p*P + s`` stages
    vertex v where (part_of[v], slot_of[v]) = (p, s); on a rank, its
    vertices ``held`` (in vertex order) are staged at their slots."""
    row_src = np.full(fogs.m * pg.slots, -1, np.int32)
    if fogs.group is None:
        held = None
        rows = pg.part_of * pg.slots + pg.slot_of
    else:
        held = np.flatnonzero(pg.part_of == fogs.rank)   # none off-group
        rows = pg.slot_of[held]
    row_src[rows] = np.arange(len(rows), dtype=np.int32)
    return row_src, held


def _layout(pg: PartitionedGraph, device: torch.device,
            fogs: Optional[_Fogs] = None) -> _Layout:
    fogs = fogs or _Fogs(pg.n)

    def build():
        shard_rows = np.arange(fogs.m)[:, None] * pg.slots
        row_src, held = _staging(pg, fogs)
        return _Layout(
            vertex_mask=torch.as_tensor(
                fogs.pick(pg.vertex_mask).reshape(-1, 1), device=device),
            boundary_index=torch.as_tensor(
                (shard_rows + fogs.pick(pg.boundary_rows)).reshape(-1),
                device=device),
            boundary_mask=torch.as_tensor(
                fogs.pick(pg.boundary_mask).reshape(-1, 1), device=device),
            result_index=torch.as_tensor(pg.part_of * pg.slots + pg.slot_of,
                                         device=device),
            row_src=torch.as_tensor(row_src, device=device), held=held)
    return _on_device(pg, device, fogs.key("layout"), build)


def _edges(pg: PartitionedGraph, device: torch.device, exchange: str,
           kind: str, fogs: Optional[_Fogs] = None) -> EdgeList:
    """The EdgeList of ``exchange`` of the held shards' edges, in the
    folded coordinates (on a rank, its rows of the ``_Fogs.spread``
    table): over the [n*P | n*B] table (every shard's rows, then the halo
    table) for ``halo``, over the [n*P] table of every shard for
    ``allgather`` (``h`` itself when folded, the gathered rows on a
    rank)."""
    fogs = fogs or _Fogs(pg.n)

    def build():
        put = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        if exchange == "allgather":
            senders = put(fogs.pick(pg.senders_global))
            self_senders = put(fogs.pick(pg.self_senders_global))
        else:
            # Shard p's combined table is [its P rows | the n*B halo
            # rows]: local slot s is folded row p*P + s, halo row s - P
            # is row n*P + s - P.
            slots = pg.slots
            shard = (fogs.rank + np.arange(fogs.m, dtype=np.int32)
                     )[:, None] * slots
            halo = fogs.pick(pg.senders_halo)
            senders = put(halo + np.where(halo < slots, shard,
                                          np.int32((pg.n - 1) * slots)))
            self_senders = put(fogs.pick(pg.self_senders_halo) + shard)
        return _layer_edges(pg.slots, senders, kind, self_senders,
                            put(fogs.pick(pg.receivers_local)),
                            put(fogs.pick(pg.edge_mask)),
                            put(fogs.pick(pg.vertex_mask)), fogs)
    return _on_device(pg, device,
                      fogs.key(("edges", exchange,
                                kind in SELF_LOOP_KINDS)), build)


@dataclasses.dataclass(frozen=True)
class _FoldedCsr:
    """A BlockShardCsr on one device with its shard axis folded into the
    row-block axis: one launch aggregates every held shard."""
    blocks: torch.Tensor   # f32[m*VB, M, B, B]
    cols: torch.Tensor     # i32[m*VB, M]
    mask: torch.Tensor     # f32[m*VB, M]
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


def _folded_csrs(pg: PartitionedGraph, device: torch.device,
                 fogs: Optional[_Fogs] = None):
    """The local and halo operands of the held shards on ``device``."""
    fogs = fogs or _Fogs(pg.n)

    def held(csr: BlockShardCsr) -> BlockShardCsr:
        return dataclasses.replace(csr, blocks=fogs.pick(csr.blocks),
                                   cols=fogs.pick(csr.cols),
                                   mask=fogs.pick(csr.mask))
    return _on_device(pg, device, fogs.key("csr"), lambda: (
        _fold(held(pg.local_csr), device, True),
        _fold(held(pg.halo_csr), device, False)))


def _exchange(h: torch.Tensor, lay: _Layout, fogs: _Fogs,
              quant: bool) -> Tuple[torch.Tensor, ...]:
    """One layer's BSP sync: every shard's boundary rows (times their
    mask) as the [.., n*B, F] halo table, or with ``quant`` its uint8
    codes and its [.., n*B] scales and mins. Folded, a gather of rows of
    ``h``; on a rank, its own [.., B, F] rows (or their codes, scales and
    mins) cross the wire in one ``all_gather`` each."""
    with span("exchange"):
        hb = h[..., lay.boundary_index, :] * lay.boundary_mask  # [.., m*B, F]
        if fogs.group is None:
            return _wire_quantize(hb) if quant else (hb,)
        if quant:   # codes [.., B, F]; scales and mins [.., B]
            return tuple(fog_dist.gather_rows(
                _wire_quantize(hb), (-2, -1, -1), fogs.group.group))
        return tuple(fog_dist.gather_rows((hb,), (-2,), fogs.group.group))


def _kernel_sum(pg: PartitionedGraph, h: torch.Tensor, lay: _Layout,
                local: _FoldedCsr, halo: _FoldedCsr, halo_quant: bool,
                subsets: Optional[Tuple[RowSubset, RowSubset]] = None,
                stale: Optional[torch.Tensor] = None,
                fogs: Optional[_Fogs] = None) -> torch.Tensor:
    """Every held shard's neighbor SUM = local SpMM + halo SpMM, one
    launch each for all held shards. ``h`` is the folded [m*P, F] table or
    a [B, m*P, F] stack (then the batched kernels run). ``subsets`` (the
    local and halo operands' row subsets of a frontier layer) restricts
    both launches to their rows; ``stale`` is a recorded [n*B, F] halo
    table read instead of the exchange (no wire)."""
    fogs = fogs or _Fogs(pg.n)
    m, slots = fogs.m, pg.slots
    lead, f = h.shape[:-2], h.shape[-1]
    batched = h.ndim == 3
    spmm = block_spmm_batched if batched else block_spmm
    l_rows, h_rows = (local.rows, halo.rows) if subsets is None else subsets
    loc = _kernel_pad(h.reshape(lead + (m, slots, f)), local.src_rows // m)
    out = spmm(local.blocks, local.cols, local.mask,
               loc.reshape(lead + (local.src_rows, f)), rows=l_rows,
               max_col=local.max_col)
    if stale is not None:
        with span("exchange"):
            hb = stale.expand(lead + stale.shape)
            wire = _wire_quantize(hb) if halo_quant else (hb,)
    else:
        wire = _exchange(h, lay, fogs, halo_quant)
    if halo_quant:
        codes, sc, mn = wire
        pad = (0, halo.src_rows - sc.shape[-1])
        dq = dequant_spmm_batched if batched else dequant_spmm
        out_h = dq(halo.blocks, halo.cols, halo.mask,
                   _kernel_pad(codes, halo.src_rows), F.pad(sc, pad),
                   F.pad(mn, pad), rows=h_rows, max_col=halo.max_col)
    else:
        out_h = spmm(halo.blocks, halo.cols, halo.mask,
                     _kernel_pad(wire[0], halo.src_rows).contiguous(),
                     rows=h_rows, max_col=halo.max_col)

    def shard_rows(o):
        o = o.reshape(lead + (m, local.out_rows, f))[..., :slots, :]
        return o.reshape(lead + (m * slots, f))
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


def _run_layers(params, kind: str, pg: PartitionedGraph, h: torch.Tensor,
                exchange: str, aggregation: str, halo_quant: bool,
                dirty: Optional[List[np.ndarray]] = None,
                cached: Optional[List[torch.Tensor]] = None,
                stale: Optional[List[torch.Tensor]] = None,
                fogs: Optional[_Fogs] = None) -> List[torch.Tensor]:
    """K-layer BSP forward on the folded table ``h`` of the held shards
    ([m*P, F], or a [B, m*P, F] stack) -> every layer's folded output
    over the same rows, on ``h``'s device.

    The kernel path runs one local and one halo launch per layer for the
    whole stack, then the dense tail example by example; the segment-sum
    path runs a stack example by example. Either way every example is
    bitwise its serial run. On a rank the dense tail (all of a GAT layer
    past the exchange) runs on ``fogs.spread`` tables of the folded shape.

    Frontier pass (``dirty``: per layer a host bool [m*P] mask of the
    folded rows to recompute; ``cached``: the last full pass's K folded
    tables): the kernel path launches both operands over the row subset of the
    dirty rows' 128-row blocks (the edge mask stays full: degrees must be
    exact) and merges every row of those blocks; the segment path masks
    out the edges into clean rows, in an edge list of its own, and merges
    the dirty rows. The dense tail runs at the full shape and the merge
    is a ``torch.where`` select, so clean rows keep the cached bits and
    the next layer's exchange reads the merged table: bitwise a full pass
    by induction, given a sound frontier and tables of this revision.

    Stale serve (``stale``: K recorded [n*B, F_l] halo tables): every
    layer reads its halo rows from the table instead of the exchange;
    local rows read the current ``h``. Nothing crosses a wire, so
    ``halo_quant`` does not apply.
    """
    fogs = fogs or _Fogs(pg.n)
    device = h.device
    exchange, use_kernels = _resolve(kind, pg, exchange, aggregation,
                                     halo_quant, device)
    if exchange not in ("halo", "allgather"):
        raise ValueError(exchange)
    frontier = dirty is not None
    if frontier and kind not in KERNEL_KINDS:
        raise ValueError(
            f"frontier execution supports kinds {KERNEL_KINDS} (static-sum "
            f"aggregation); {kind!r} re-weights edges per layer")
    if stale is not None and len(stale) != len(params):
        raise ValueError(
            f"stale serve needs one halo table per layer: got "
            f"{len(stale)} tables for {len(params)} layers")
    if h.ndim == 3 and not use_kernels:
        per = [_run_layers(params, kind, pg, hh, exchange, aggregation,
                           halo_quant, dirty, cached, stale, fogs)
               for hh in h]
        return [torch.stack(layer) for layer in zip(*per)]
    lay = _layout(pg, device, fogs)
    edges = _edges(pg, device, exchange, kind, fogs)
    if use_kernels:
        local, halo = _folded_csrs(pg, device, fogs)
    _, layer_fn = LAYER_FNS[kind]
    slots = pg.slots
    outs = []
    for li, p in enumerate(params):
        with span("layer"):
            last = li == len(params) - 1
            halo_l = None if stale is None else stale[li]
            if use_kernels:
                subsets = merge = None
                if frontier:
                    blocks = _dirty_blocks(pg, local, dirty[li])
                    subsets = (row_subset(local.rows, blocks),
                               row_subset(halo.rows, blocks))
                    merge = _block_rows(pg, fogs, local, subsets[0])
                a_sum = _kernel_sum(pg, h, lay, local, halo, halo_quant,
                                    subsets, halo_l, fogs)
                h_new = apply_layer_with_sum(
                    kind, p, fogs.spread(h, slots), edges,
                    fogs.spread(a_sum, slots), last=last)
            else:
                edges_l, merge = edges, None
                if frontier:
                    merge = torch.as_tensor(dirty[li], device=device)
                    edges_l = edges.into(fogs.spread(merge, slots, -1))
                if exchange == "allgather":
                    with span("exchange"):
                        h_src = (h if fogs.group is None
                                 else fog_dist.gather_rows(
                                     (h,), (-2,), fogs.group.group)[0])
                else:
                    if halo_l is None:
                        hb = _exchange(h, lay, fogs, False)[0]
                    else:
                        with span("exchange"):   # the stale table's read
                            hb = halo_l
                    h_src = torch.cat([fogs.spread(h, slots), hb])
                kwargs = {"activation": None} if last else {}
                h_new = layer_fn(p, fogs.spread(h, slots), edges_l,
                                 h_src=h_src, **kwargs)
            # keep padded rows at zero
            h_new = fogs.own(h_new, slots) * lay.vertex_mask
            h = (h_new if merge is None
                 else torch.where(merge[:, None], h_new, cached[li]))
        outs.append(h)
    return outs


def _dirty_blocks(pg: PartitionedGraph, local: _FoldedCsr,
                  dirty: np.ndarray) -> np.ndarray:
    """The folded kernel-output row blocks holding a dirty row: held shard
    p's slot s is output row p*out_rows + s of the local and halo
    launches."""
    rows = np.flatnonzero(dirty)
    p, s = rows // pg.slots, rows % pg.slots
    return np.unique((p * local.out_rows + s) // BLOCK)


def _block_rows(pg: PartitionedGraph, fogs: _Fogs, local: _FoldedCsr,
                subset: RowSubset) -> torch.Tensor:
    """bool[m*P]: the folded rows whose kernel-output block is in
    ``subset`` (every row a frontier launch recomputed)."""
    mask = subset.row_mask().reshape(fogs.m, local.out_rows)[:, :pg.slots]
    return mask.reshape(-1)


def _with_features(pg: PartitionedGraph, feats: np.ndarray
                   ) -> PartitionedGraph:
    """``pg`` with a query's [V, F] features scattered into its slots:
    the host half of a query's staging (``_local_feats`` the device
    half)."""
    with span("stage"), span("scatter"):
        return pg.with_features(feats)


def _local_feats(pg: PartitionedGraph, fogs: _Fogs,
                 device: torch.device) -> torch.Tensor:
    """The held shards' features as one folded [m*P, F] table."""
    with span("stage"), span("h2d"):
        h = torch.as_tensor(fogs.pick(pg.feats), device=device)
        return h.reshape(fogs.m * pg.slots, -1)


def _device_stack(stack: np.ndarray, fogs: _Fogs,
                  device: torch.device) -> torch.Tensor:
    """A host [n, B, P, F] table as the held shards' [B, m*P, F] stack on
    ``device``."""
    with span("h2d"):
        return _gathered_stack(torch.as_tensor(fogs.pick(stack),
                                               device=device))


def _local_stack(pg: PartitionedGraph, feats: np.ndarray, fogs: _Fogs,
                 device: torch.device) -> torch.Tensor:
    """A [B, V, F] micro-batch as the held shards' [B, m*P, F] stack: the
    caller's rows (a rank's own, taken on the host) go to ``device`` as
    they are, and one ``stage_rows`` gather lays them out in the folded
    slots there, padded slots +0.0: the floats of ``feature_stack``'s
    table, which is never built. The stack must hold the layout's V
    vertices: the gather reads the rows ``row_src`` names unchecked."""
    shape, v = np.shape(feats), len(pg.part_of)
    if len(shape) != 3 or shape[1] != v:
        raise ValueError(f"a micro-batch of this layout is a [B, {v}, F] "
                         f"stack, got shape {shape}")
    lay = _layout(pg, device, fogs)
    with span("stage"):
        with span("h2d"):
            feats = np.asarray(feats, np.float32)
            if lay.held is not None:
                feats = np.take(feats, lay.held, axis=1)
            x = torch.as_tensor(feats, device=device)
        with span("scatter"):
            return stage_rows(x.contiguous(), lay.row_src)


def _all_rows(fogs: _Fogs, device: torch.device, run
              ) -> List[torch.Tensor]:
    """``run()`` -> the held shards' tables [.., m*P, F_l] -> every shard's
    [.., n*P, F_l] on every rank: on a rank, the gather of the results
    over its group, and for a group that is not the whole world the
    group's broadcast to it (neither is a BSP sync). A rank outside the
    group never calls ``run``: it holds no shard and only receives."""
    if fogs.group is None:
        return run()
    outs = None
    if fogs.m:
        outs = run()
        outs = fog_dist.gather_rows(outs, [-2] * len(outs),
                                    fogs.group.group, sync=False)
    return fog_dist.share(outs, fogs.group, device)


def bsp_apply(params, kind: str, pg: PartitionedGraph,
              exchange: str = "halo", aggregation: str = "segment_sum",
              halo_quant: bool = False,
              device: Union[str, torch.device] = "cuda",
              group=None) -> torch.Tensor:
    """Distributed K-layer GNN inference; returns [n, P, D] on ``device``.

    ``aggregation`` selects the shard-local aggregation path (see module
    docstring); ``halo_quant=True`` (kernel path only) quantizes the halo
    rows to uint8 before the exchange and dequantizes them inside the
    fused ``dequant_spmm`` kernel — the wire carries 1 byte/feature plus
    8 bytes/row instead of 4 bytes/feature. ``group`` (a process group of
    ``pg.n`` ranks, or the ``runtime.dist.FogGroup`` of ``pg.n`` fogs)
    runs this rank's shard only; every rank returns the whole [n, P, D].
    """
    device = torch.device(device)
    fogs = _fogs(pg, group, device)
    out = _all_rows(fogs, device, lambda: _run_layers(
        params, kind, pg, _local_feats(pg, fogs, device), exchange,
        aggregation, halo_quant, fogs=fogs)[-1:])[0]
    return out.reshape(pg.n, pg.slots, -1)


def bsp_apply_many(params, kind: str, pg: PartitionedGraph,
                   feat_stack: np.ndarray, exchange: str = "halo",
                   aggregation: str = "segment_sum", halo_quant: bool = False,
                   device: Union[str, torch.device] = "cuda",
                   group=None) -> torch.Tensor:
    """Distributed inference over a whole micro-batch.

    ``feat_stack`` is the [n, B, P, F] table from
    ``PartitionedGraph.feature_stack``; returns [n, B, P, D]. On the
    kernel path each layer's exchange ships every example's boundary rows
    at once and the batched kernels aggregate the whole stack in one local
    and one halo launch. Every example is bitwise the serial
    ``bsp_apply``.
    """
    device = torch.device(device)
    fogs = _fogs(pg, group, device)
    feat_stack = np.asarray(feat_stack)

    def run():
        with span("stage"):
            h = _device_stack(feat_stack, fogs, device)
        return _run_layers(params, kind, pg, h, exchange, aggregation,
                           halo_quant, fogs=fogs)[-1:]
    out = _all_rows(fogs, device, run)[0]
    return out.reshape(feat_stack.shape[1], pg.n, pg.slots, -1).movedim(0, 1)


def _partitioned(g: Graph, assignment: np.ndarray, kind: str, exchange: str,
                 aggregation: str, device: torch.device,
                 pg: Optional[PartitionedGraph]) -> PartitionedGraph:
    """``pg`` with ``g``'s features, or a layout built from
    ``assignment``."""
    if pg is not None:
        return _with_features(pg, g.features)
    mode = resolve_aggregation(aggregation, kind, exchange=exchange,
                               device=device)
    return build_partitioned(g, assignment, build_blocks=mode == "pallas")


def bsp_infer(params, kind: str, g: Graph, assignment: np.ndarray,
              device: Union[str, torch.device] = "cuda",
              exchange: str = "halo", aggregation: str = "segment_sum",
              halo_quant: bool = False,
              pg: Optional[PartitionedGraph] = None,
              group=None) -> np.ndarray:
    """End-to-end distributed inference -> [V, D] numpy in original
    vertex order.

    ``pg`` reuses prebuilt partition buffers (the features are refreshed
    from ``g``, the device copies of the layout are kept), which is what
    the serving path does per query. ``group``: see ``bsp_apply``.
    """
    device = torch.device(device)
    pg = _partitioned(g, assignment, kind, exchange, aggregation, device, pg)
    fogs = _fogs(pg, group, device)
    return _unfold(pg, fogs, device, lambda: _run_layers(
        params, kind, pg, _local_feats(pg, fogs, device), exchange,
        aggregation, halo_quant, fogs=fogs)[-1:])[0]


def bsp_infer_many(params, kind: str, feats: np.ndarray,
                   pg: PartitionedGraph,
                   device: Union[str, torch.device] = "cuda",
                   exchange: str = "halo", aggregation: str = "segment_sum",
                   halo_quant: bool = False, group=None) -> np.ndarray:
    """Batched end-to-end distributed inference -> [B, V, D] numpy.

    ``feats`` is a [B, V, F] stacked micro-batch; the prebuilt ``pg``
    supplies the layout (and block-CSR shards for the kernel path).
    """
    feats = np.asarray(feats, np.float32)
    if feats.ndim != 3:
        raise ValueError(f"bsp_infer_many takes a [B, V, F] stack, got "
                         f"shape {feats.shape}")
    device = torch.device(device)
    fogs = _fogs(pg, group, device)
    return _unfold(pg, fogs, device, lambda: _run_layers(
        params, kind, pg, _local_stack(pg, feats, fogs, device), exchange,
        aggregation, halo_quant, fogs=fogs)[-1:])[0]


def _unfold(pg: PartitionedGraph, fogs: _Fogs, device: torch.device, run
            ) -> List[np.ndarray]:
    """``run()``'s held-shard tables [.., m*P, F_l] -> numpy in original
    vertex order (on a rank, the whole result; see ``_all_rows``)."""
    outs = _all_rows(fogs, device, run)
    with span("unfold"):
        idx = _layout(pg, device, fogs).result_index
        return [o[..., idx, :].cpu().numpy() for o in outs]


def bsp_infer_capture(params, kind: str, g: Graph, assignment: np.ndarray,
                      device: Union[str, torch.device] = "cuda",
                      exchange: str = "halo",
                      aggregation: str = "segment_sum",
                      halo_quant: bool = False,
                      pg: Optional[PartitionedGraph] = None,
                      group=None) -> List[np.ndarray]:
    """``bsp_infer`` returning every layer: K arrays [V, F_l] in original
    vertex order (the last is the plain ``bsp_infer`` output, bit for
    bit). Feeds the Session's activation cache."""
    device = torch.device(device)
    pg = _partitioned(g, assignment, kind, exchange, aggregation, device, pg)
    fogs = _fogs(pg, group, device)
    return _unfold(pg, fogs, device, lambda: _run_layers(
        params, kind, pg, _local_feats(pg, fogs, device), exchange,
        aggregation, halo_quant, fogs=fogs))


def bsp_infer_capture_many(params, kind: str, feats: np.ndarray,
                           pg: PartitionedGraph,
                           device: Union[str, torch.device] = "cuda",
                           exchange: str = "halo",
                           aggregation: str = "segment_sum",
                           halo_quant: bool = False,
                           group=None) -> List[np.ndarray]:
    """Batched capture: [B, V, F] micro-batch -> K arrays [B, V, F_l]."""
    device = torch.device(device)
    fogs = _fogs(pg, group, device)
    return _unfold(pg, fogs, device, lambda: _run_layers(
        params, kind, pg, _local_stack(pg, feats, fogs, device), exchange,
        aggregation, halo_quant, fogs=fogs))


def build_halo_tables(pg: PartitionedGraph, layer_inputs) -> List[np.ndarray]:
    """Pre-gathered per-layer halo tables for the stale-serve path.

    ``layer_inputs[l]`` is the [V, F_l] table of layer ``l``'s INPUT
    activations in original vertex order — layer 0's input is the raw
    feature matrix, layer ``l>0``'s input is layer ``l-1``'s output (e.g.
    from ``bsp_infer_capture``). Returns K ``[n*B, F_l]`` tables laid out
    exactly like the exchange's halo table: row ``p*B + i`` carries
    partition ``p``'s i-th boundary row times its mask, padded rows zero.
    Pure data movement through part_of/slot_of (no arithmetic beyond the
    mask the exchange applies too), so replaying a table built from the
    same activations the fresh exchange shipped reproduces that exchange
    bit for bit.
    """
    tables = []
    brows = pg.boundary_rows.astype(np.int64)
    for act in layer_inputs:
        act = np.asarray(act, np.float32)
        f = act.shape[-1]
        shard = np.zeros((pg.n, pg.slots, f), np.float32)
        shard[pg.part_of, pg.slot_of] = act
        rows = np.take_along_axis(shard, brows[:, :, None], axis=1)
        rows = rows * pg.boundary_mask[:, :, None]
        tables.append(np.ascontiguousarray(
            rows.reshape(pg.n * pg.boundary_slots, f)))
    return tables


def _stale_run(params, kind: str, pg: PartitionedGraph, h: torch.Tensor,
               halo_tables, aggregation: str, fogs: _Fogs) -> torch.Tensor:
    """The ``halo_async`` stale serve on the folded ``h``: cross-partition
    reads come from the recorded per-layer ``halo_tables`` instead of an
    exchange (``_run_layers``' ``stale``)."""
    tables = [torch.as_tensor(np.asarray(t, np.float32), device=h.device)
              for t in halo_tables]
    return _run_layers(params, kind, pg, h, "halo_async", aggregation,
                       False, stale=tables, fogs=fogs)[-1]


def bsp_infer_stale(params, kind: str, feats: np.ndarray,
                    pg: PartitionedGraph, halo_tables,
                    device: Union[str, torch.device] = "cuda",
                    aggregation: str = "segment_sum",
                    group=None) -> np.ndarray:
    """Stale-halo distributed inference -> [V, D] in original vertex order.

    ``feats`` are the CURRENT [V, F] features (local reads stay fresh);
    ``halo_tables`` the recorded per-layer exchange payloads
    (``build_halo_tables``) a bounded-staleness serve may replay. On a
    rank the tables are read whole and nothing crosses the wire but the
    gather of the results.
    """
    device = torch.device(device)
    pg = _with_features(pg, np.asarray(feats, np.float32))
    fogs = _fogs(pg, group, device)
    return _unfold(pg, fogs, device, lambda: [_stale_run(
        params, kind, pg, _local_feats(pg, fogs, device), halo_tables,
        aggregation, fogs)])[0]


def bsp_infer_stale_many(params, kind: str, feats: np.ndarray,
                         pg: PartitionedGraph, halo_tables,
                         device: Union[str, torch.device] = "cuda",
                         aggregation: str = "segment_sum",
                         group=None) -> np.ndarray:
    """Batched stale-halo inference: [B, V, F] micro-batch -> [B, V, D];
    every example shares the same recorded halo tables (graph state, not
    per-request state)."""
    device = torch.device(device)
    fogs = _fogs(pg, group, device)
    return _unfold(pg, fogs, device, lambda: [_stale_run(
        params, kind, pg, _local_stack(pg, feats, fogs, device),
        halo_tables, aggregation, fogs)])[0]


def _scatter_frontier(pg: PartitionedGraph, rows_per_layer, cached_layers,
                      device: torch.device, fogs: _Fogs):
    """Global frontier/cache state -> the held shards' folded operands:
    per layer a host bool [m*P] dirty mask, and the cached [V, F_l] tables
    as folded [m*P, F_l] tables on ``device``. Pure data movement through
    part_of/slot_of, so the folded tables carry exactly the cached bits."""
    dirty = []
    for rows in rows_per_layer:
        rows = np.asarray(rows, np.int64)
        d = np.zeros((pg.n, pg.slots), bool)
        d[pg.part_of[rows], pg.slot_of[rows]] = True
        dirty.append(fogs.pick(d).reshape(-1))
    idx = _layout(pg, device, fogs).result_index
    cached = []
    for cl in cached_layers:
        cl = torch.as_tensor(np.asarray(cl, np.float32), device=device)
        t = cl.new_zeros(cl.shape[:-2] + (pg.n * pg.slots, cl.shape[-1]))
        t[..., idx, :] = cl
        t = t.reshape(cl.shape[:-2] + (pg.n, pg.slots, cl.shape[-1]))
        if fogs.group is not None:
            t = t[..., fogs.rank:fogs.rank + 1, :, :]
        cached.append(t.reshape(cl.shape[:-2] + (fogs.m * pg.slots,
                                                 cl.shape[-1])))
    return dirty, cached


def bsp_infer_frontier(params, kind: str, feats: np.ndarray,
                       pg: PartitionedGraph, rows_per_layer, cached_layers,
                       device: Union[str, torch.device] = "cuda",
                       exchange: str = "halo",
                       aggregation: str = "segment_sum",
                       halo_quant: bool = False,
                       group=None) -> List[np.ndarray]:
    """Frontier-restricted distributed inference.

    ``rows_per_layer[l]`` are the global vertex ids layer ``l`` must
    recompute (a sound closure from ``core.frontier``), ``cached_layers``
    the last full pass's K [V, F_l] tables for THIS graph revision.
    Returns the K merged tables in original vertex order; the last one is
    bitwise a full ``bsp_infer`` pass. On a rank the host dirty masks and
    cached tables are cut to its rows.
    """
    device = torch.device(device)
    pg = _with_features(pg, np.asarray(feats, np.float32))
    fogs = _fogs(pg, group, device)

    def run():
        dirty, cached = _scatter_frontier(pg, rows_per_layer, cached_layers,
                                          device, fogs)
        return _run_layers(params, kind, pg, _local_feats(pg, fogs, device),
                           exchange, aggregation, halo_quant, dirty, cached,
                           fogs=fogs)
    return _unfold(pg, fogs, device, run)


def bsp_infer_frontier_many(params, kind: str, feats: np.ndarray,
                            pg: PartitionedGraph, rows_per_layer,
                            cached_layers,
                            device: Union[str, torch.device] = "cuda",
                            exchange: str = "halo",
                            aggregation: str = "segment_sum",
                            halo_quant: bool = False,
                            group=None) -> List[np.ndarray]:
    """Batched frontier pass over a stacked [B, V, F] micro-batch sharing
    one (unioned) dirty frontier; returns K merged [B, V, F_l] stacks."""
    device = torch.device(device)
    fogs = _fogs(pg, group, device)

    def run():
        dirty, cached = _scatter_frontier(pg, rows_per_layer, cached_layers,
                                          device, fogs)
        return _run_layers(params, kind, pg,
                           _local_stack(pg, feats, fogs, device), exchange,
                           aggregation, halo_quant, dirty, cached, fogs=fogs)
    return _unfold(pg, fogs, device, run)


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
