"""Plan invariant checks (the "plan" analyzer family).

Every check re-derives ground truth from the plan's own ``Graph`` +
assignment and compares it against the frozen serving buffers — partition
coverage, halo layout, ELL-block-CSR padding, capacity balance, and the
cross-field agreement that ``Engine.apply_delta`` must preserve.  Nothing
here executes a query: a corrupted plan is caught before it serves. The
checks read the port's host layout (``runtime.bsp.PartitionedGraph`` and
its ``BlockShardCsr`` operands, numpy), never the device copies.
"""
from __future__ import annotations

from typing import Iterable, List

import numpy as np

from repro_torch.analysis.diagnostics import (AnalysisContext, Diagnostic,
                                              VALIDATE_MODES, error, info,
                                              register_check, warning)
from repro_torch.api.registry import ALL_REGISTRIES

#: a predicted makespan this far above the mean per-fog total means the
#: profiled fog model expects one fog to dominate the BSP superstep.
CAPACITY_SKEW_THRESHOLD = 2.5


def _binary(arr: np.ndarray) -> bool:
    return bool(np.isin(arr, (0.0, 1.0)).all())


def _expected_layout(g, part_of: np.ndarray, n: int, b_pad: int):
    """Re-derive the halo layout of ``build_partitioned`` from scratch:
    per-partition boundary sets and each vertex's halo slot."""
    recv_part = part_of[g.receivers]
    boundary_ids: List[np.ndarray] = []
    for p in range(n):
        cross = (part_of[g.senders] == p) & (recv_part != p)
        boundary_ids.append(np.unique(g.senders[cross]))
    halo_slot = np.zeros(g.num_vertices, np.int64)
    for bs in boundary_ids:
        halo_slot[bs] = np.arange(len(bs))
    return recv_part, boundary_ids, halo_slot


def _decode_shard(csr, p: int, block: int):
    """The real (src_row, dst_row) entries of one stacked shard, as
    (sorted unique int64 keys ``src * 2^32 + dst``, multiplicities)."""
    real = csr.mask[p] != 0.0
    tiles = csr.blocks[p][real]                      # [T, B, B]
    t, r, c = np.nonzero(tiles)
    i = np.nonzero(real)[0][t]
    src = csr.cols[p][real][t].astype(np.int64) * block + c
    dst = i.astype(np.int64) * block + r
    mult = np.rint(tiles[t, r, c]).astype(np.int64)
    return _multiset(src, dst, mult)


def _multiset(src, dst, mult=None):
    """(sorted unique keys, total multiplicity) of (src, dst) pairs."""
    keys = (np.asarray(src, np.int64) << 32) | np.asarray(dst, np.int64)
    if mult is None:
        mult = np.ones(len(keys), np.int64)
    uniq, inv = np.unique(keys, return_inverse=True)
    counts = np.bincount(inv.reshape(-1), weights=mult,
                         minlength=len(uniq)).astype(np.int64)
    keep = counts != 0
    return uniq[keep], counts[keep]


def _difference(want, got):
    """(missing, spurious) entry counts between two multisets."""
    keys = np.union1d(want[0], got[0])
    w = np.zeros(len(keys), np.int64)
    g = np.zeros(len(keys), np.int64)
    w[np.searchsorted(keys, want[0])] = want[1]
    g[np.searchsorted(keys, got[0])] = got[1]
    return int(np.maximum(w - g, 0).sum()), int(np.maximum(g - w, 0).sum())


def _tile_nonzero(csr) -> np.ndarray:
    """bool[n, VB, M]: whether each tile holds a nonzero entry (one pass
    over the tiles, no copy of them)."""
    n, vb, m = csr.mask.shape
    b = csr.blocks.shape[-1]
    return csr.blocks.reshape(n * vb * m, b * b).any(axis=1).reshape(
        n, vb, m)


@register_check(
    "plan.partition.coverage", family="plan", layer="plan",
    description="every vertex occupies exactly one live (partition, slot)")
def check_partition_coverage(ctx: AnalysisContext) -> Iterable[Diagnostic]:
    plan = ctx.plan
    g, pg = plan.graph, plan.partitioned
    out = []
    cid = "plan.partition.coverage"
    hint = ("rebuild the layout with bsp.build_partitioned — a partial "
            "apply_delta left the inverse permutation stale")
    if len(pg.part_of) != g.num_vertices or len(pg.slot_of) != g.num_vertices:
        out.append(error(cid, f"inverse permutation covers "
                              f"{len(pg.part_of)} vertices, graph has "
                              f"{g.num_vertices}", layer="plan",
                         subject="part_of/slot_of", fix_hint=hint))
        return out
    if g.num_vertices == 0:
        return out
    if pg.part_of.min() < 0 or pg.part_of.max() >= pg.n:
        out.append(error(cid, f"part_of values outside [0, {pg.n})",
                         layer="plan", subject="part_of", fix_hint=hint))
        return out
    if pg.slot_of.min() < 0 or pg.slot_of.max() >= pg.slots:
        out.append(error(cid, f"slot_of values outside [0, {pg.slots})",
                         layer="plan", subject="slot_of", fix_hint=hint))
        return out
    occupied = pg.vertex_mask[pg.part_of, pg.slot_of]
    if not np.all(occupied == 1.0):
        bad = int(np.sum(occupied != 1.0))
        out.append(error(cid, f"{bad} vertices map to slots whose "
                              f"vertex_mask is 0 (dead slots)",
                         layer="plan", subject="vertex_mask", fix_hint=hint))
    live = int(pg.vertex_mask.sum())
    if live != g.num_vertices:
        out.append(error(cid, f"vertex_mask marks {live} live slots for "
                              f"{g.num_vertices} vertices", layer="plan",
                         subject="vertex_mask", fix_hint=hint))
    return out


@register_check(
    "plan.partition.disjoint", family="plan", layer="plan",
    description="the vertex -> (partition, slot) map is injective")
def check_partition_disjoint(ctx: AnalysisContext) -> Iterable[Diagnostic]:
    pg = ctx.plan.partitioned
    flat = pg.part_of * pg.slots + pg.slot_of
    dup = len(flat) - len(np.unique(flat))
    if dup:
        return [error(
            "plan.partition.disjoint",
            f"{dup} vertex pairs share a (partition, slot) — their "
            f"embeddings would overwrite each other", layer="plan",
            subject="part_of/slot_of",
            fix_hint="rebuild the layout; two vertices were assigned the "
                     "same slot (corrupt repair_assignment output)")]
    return []


@register_check(
    "plan.layout.masks", family="plan", layer="plan",
    description="masks are binary, padded rows zeroed, indices in range")
def check_layout_masks(ctx: AnalysisContext) -> Iterable[Diagnostic]:
    plan = ctx.plan
    g, pg = plan.graph, plan.partitioned
    out = []
    cid = "plan.layout.masks"
    for name in ("vertex_mask", "edge_mask", "boundary_mask"):
        if not _binary(getattr(pg, name)):
            out.append(error(cid, f"{name} contains values outside "
                                  "{0, 1}; masked multiply-accumulate "
                                  "would scale real data", layer="plan",
                             subject=name,
                             fix_hint="masks must be exactly 0.0/1.0"))
    live_edges = int(pg.edge_mask.sum())
    if live_edges != g.num_edges:
        out.append(error(cid, f"edge_mask marks {live_edges} live edges, "
                              f"graph has {g.num_edges}", layer="plan",
                         subject="edge_mask",
                         fix_hint="rebuild the layout — the per-partition "
                                  "edge split lost or duplicated edges"))
    padded = pg.feats * (1.0 - pg.vertex_mask[..., None])
    if padded.any():
        out.append(error(cid, "padded feature rows are non-zero; kernels "
                              "blindly multiply-accumulate padding",
                         layer="plan", subject="feats",
                         fix_hint="zero rows where vertex_mask == 0"))
    bounds = ((pg.senders_global, pg.n * pg.slots, "senders_global"),
              (pg.senders_halo, pg.slots + pg.n * pg.boundary_slots,
               "senders_halo"),
              (pg.receivers_local, pg.slots, "receivers_local"),
              (pg.boundary_rows, pg.slots, "boundary_rows"))
    for arr, limit, name in bounds:
        if arr.size and (arr.min() < 0 or arr.max() >= limit):
            out.append(error(cid, f"{name} indexes outside [0, {limit})",
                             layer="plan", subject=name,
                             fix_hint="gather would read out of the padded "
                                      "table — rebuild the layout"))
    return out


@register_check(
    "plan.halo.consistency", family="plan", layer="plan",
    description="halo tables/tiles carry exactly the cross-partition edges")
def check_halo_consistency(ctx: AnalysisContext) -> Iterable[Diagnostic]:
    plan = ctx.plan
    g, pg = plan.graph, plan.partitioned
    out = []
    cid = "plan.halo.consistency"
    n, b_pad, slots = pg.n, pg.boundary_slots, pg.slots
    part_of, slot_of = pg.part_of, pg.slot_of
    recv_part, boundary_ids, halo_slot = _expected_layout(
        g, part_of, n, b_pad)
    # 1) Boundary table: partition p must export exactly its boundary set.
    for p in range(n):
        bs = boundary_ids[p]
        if len(bs) > b_pad:
            out.append(error(
                cid, f"partition {p} has {len(bs)} boundary vertices but "
                     f"only {b_pad} boundary slots", layer="plan",
                subject=f"boundary_rows[{p}]",
                fix_hint="boundary capacity under-sized — rebuild layout"))
            continue
        want_rows = slot_of[bs]
        got_rows = pg.boundary_rows[p, :len(bs)]
        got_live = int(pg.boundary_mask[p].sum())
        if got_live != len(bs) or not np.array_equal(got_rows, want_rows):
            out.append(error(
                cid, f"partition {p} exports {got_live} boundary rows, "
                     f"expected {len(bs)} (the vertices foreign partitions "
                     f"actually read)", layer="plan",
                subject=f"boundary_rows[{p}]",
                fix_hint="a halo row was dropped/added without rebuilding "
                         "the exchange map — run a dirty-shard rebuild "
                         "covering this partition"))
    # 2) COO halo senders: every cross-partition edge must address the
    #    combined [local slots | n*b_pad halo] table correctly.
    for p in range(n):
        eids = np.flatnonzero(recv_part == p)
        s, r = g.senders[eids], g.receivers[eids]
        local = part_of[s] == p
        want = np.where(local, slot_of[s],
                        slots + part_of[s] * b_pad + halo_slot[s])
        got = pg.senders_halo[p, :len(eids)]
        if not np.array_equal(got, want):
            bad = int(np.sum(got != want))
            out.append(error(
                cid, f"partition {p}: {bad} edges address the wrong row of "
                     f"the combined halo table", layer="plan",
                subject=f"senders_halo[{p}]",
                fix_hint="halo slot assignment drifted from the boundary "
                         "sets — rebuild the exchange map"))
        want_recv = slot_of[r]
        if not np.array_equal(pg.receivers_local[p, :len(eids)], want_recv):
            out.append(error(
                cid, f"partition {p}: receiver slots disagree with the "
                     f"graph's edges", layer="plan",
                subject=f"receivers_local[{p}]",
                fix_hint="rebuild the layout"))
    # 3) Block-CSR shards (kernel path): decoded tiles must equal the
    #    local/remote edge multisets — every halo column a real remote
    #    neighbor, and nothing else.
    if pg.halo_csr is not None:
        block = pg.halo_csr.blocks.shape[-1]
        for p in range(n):
            eids = np.flatnonzero(recv_part == p)
            s, r = g.senders[eids], g.receivers[eids]
            remote = part_of[s] != p
            want = _multiset(
                part_of[s[remote]] * b_pad + halo_slot[s[remote]],
                slot_of[r[remote]])
            got = _decode_shard(pg.halo_csr, p, block)
            missing, extra = _difference(want, got)
            if missing or extra:
                out.append(error(
                    cid, f"partition {p}: halo block-CSR disagrees with the "
                         f"graph's cross-partition edges ({missing} "
                         f"missing, {extra} spurious)", layer="plan",
                    subject=f"halo_csr[{p}]",
                    fix_hint="a stale/corrupt tile survived a dirty-shard "
                             "rebuild — invalidate and re-block this shard"))
    if pg.local_csr is not None:
        block = pg.local_csr.blocks.shape[-1]
        for p in range(n):
            eids = np.flatnonzero(recv_part == p)
            s, r = g.senders[eids], g.receivers[eids]
            local = part_of[s] == p
            want = _multiset(slot_of[s[local]], slot_of[r[local]])
            got = _decode_shard(pg.local_csr, p, block)
            missing, extra = _difference(want, got)
            if missing or extra:
                out.append(error(
                    cid, f"partition {p}: local block-CSR disagrees with "
                         f"the shard's own edges ({missing} missing, "
                         f"{extra} spurious)", layer="plan",
                    subject=f"local_csr[{p}]",
                    fix_hint="re-block this shard"))
    return out


@register_check(
    "plan.blocks.ell", family="plan", layer="plan",
    description="ELL padding discipline and block-CSR geometry")
def check_blocks_ell(ctx: AnalysisContext) -> Iterable[Diagnostic]:
    pg = ctx.plan.partitioned
    out = []
    cid = "plan.blocks.ell"
    for name, csr in (("local_csr", pg.local_csr),
                      ("halo_csr", pg.halo_csr)):
        if csr is None:
            continue
        n, vb, m, b, b2 = csr.blocks.shape
        if b != b2:
            out.append(error(cid, f"{name}: tiles are {b}x{b2}, expected "
                                  "square tiles", layer="plan",
                             subject=name, fix_hint="rebuild the shards"))
        if csr.blocks.dtype != np.float32 or csr.mask.dtype != np.float32:
            out.append(error(cid, f"{name}: tiles/mask must be float32, got "
                                  f"{csr.blocks.dtype}/{csr.mask.dtype}",
                             layer="plan", subject=name,
                             fix_hint="the kernels accumulate in f32"))
        if not np.issubdtype(csr.cols.dtype, np.integer):
            out.append(error(cid, f"{name}: cols must be integer, got "
                                  f"{csr.cols.dtype}", layer="plan",
                             subject=name,
                             fix_hint="the kernels read i32 column "
                                      "blocks"))
        if csr.cols.shape != (n, vb, m) or csr.mask.shape != (n, vb, m):
            out.append(error(cid, f"{name}: cols/mask shapes "
                                  f"{csr.cols.shape}/{csr.mask.shape} do "
                                  f"not match tiles {(n, vb, m)}",
                             layer="plan", subject=name,
                             fix_hint="rebuild the shards"))
            continue
        if not _binary(csr.mask):
            out.append(error(cid, f"{name}: block_mask values outside "
                                  "{0, 1}", layer="plan", subject=name,
                             fix_hint="ELL tile masks are exactly 0/1"))
        if csr.out_rows != vb * b:
            out.append(error(cid, f"{name}: out_rows {csr.out_rows} != "
                                  f"VB*B = {vb * b}", layer="plan",
                             subject=name, fix_hint="rebuild the shards"))
        if csr.out_rows < pg.slots:
            out.append(error(cid, f"{name}: out_rows {csr.out_rows} cannot "
                                  f"cover the {pg.slots} partition slots",
                             layer="plan", subject=name,
                             fix_hint="rebuild the shards"))
        if csr.src_rows % b != 0:
            out.append(error(cid, f"{name}: src_rows {csr.src_rows} is not "
                                  f"a multiple of the {b} tile edge",
                             layer="plan", subject=name,
                             fix_hint="pad the source table to the tile "
                                      "grid"))
        src_tables = {"local_csr": pg.slots,
                      "halo_csr": pg.n * pg.boundary_slots}
        want_src = int(-(-src_tables[name] // b) * b)
        if csr.src_rows != want_src:
            out.append(error(cid, f"{name}: src_rows {csr.src_rows} != "
                                  f"{want_src} (padded source-table rows)",
                             layer="plan", subject=name,
                             fix_hint="the executors pad the source table "
                                      "to src_rows at launch; a mismatch "
                                      "reads garbage rows"))
        pad = csr.mask == 0.0
        if np.any(csr.cols[pad] != 0):
            out.append(error(cid, f"{name}: ELL padding tiles must point "
                                  f"at source block 0 (got non-zero cols "
                                  f"under mask==0)", layer="plan",
                             subject=name,
                             fix_hint="padding tiles index block 0 so the "
                                      "masked product stays in bounds"))
        if np.any(_tile_nonzero(csr) & pad):
            out.append(error(cid, f"{name}: ELL padding tiles carry "
                                  f"non-zero weights", layer="plan",
                             subject=name,
                             fix_hint="zero the padding tiles — the mask "
                                      "multiplies the matmul result, not "
                                      "the operand load"))
    return out


@register_check(
    "plan.capacity.imbalance", family="plan", layer="plan",
    description="profiled fog model predicts a balanced BSP superstep")
def check_capacity_imbalance(ctx: AnalysisContext) -> Iterable[Diagnostic]:
    plan = ctx.plan
    pl = plan.placement
    out = []
    cid = "plan.capacity.imbalance"
    tot = np.asarray(pl.est_total, float)
    if len(tot) > 1 and tot.mean() > 0:
        skew = float(tot.max() / tot.mean())
        if skew > CAPACITY_SKEW_THRESHOLD:
            worst = int(tot.argmax())
            out.append(warning(
                cid, f"fog {plan.fogs[worst].name!r} is predicted to take "
                     f"{skew:.1f}x the mean per-fog total "
                     f"({tot.max():.4f}s vs {tot.mean():.4f}s mean) — the "
                     f"BSP superstep stalls on it every layer",
                layer="plan", subject=f"est_total[{worst}]",
                fix_hint="repartition (apply_delta crossed a capacity "
                         "cliff) or re-run placement against fresh fog "
                         "profiles"))
        mk = float(pl.est_makespan)
        if not np.isclose(mk, tot.max(), rtol=1e-9, atol=1e-12):
            out.append(error(
                cid, f"est_makespan {mk:.6f} disagrees with "
                     f"max(est_total) {tot.max():.6f}", layer="plan",
                subject="placement",
                fix_hint="the placement estimates were mutated "
                         "inconsistently — re-price via "
                         "incremental.refresh_placement"))
    return out


@register_check(
    "plan.update.consistency", family="plan", layer="plan",
    description="assignment, layout, cluster and features agree post-update")
def check_update_consistency(ctx: AnalysisContext) -> Iterable[Diagnostic]:
    plan = ctx.plan
    g, pg, pl = plan.graph, plan.partitioned, plan.placement
    out = []
    cid = "plan.update.consistency"
    hint = ("Engine.apply_delta must hand every derived structure the same "
            "graph revision — recompile the plan")
    if pg.n != plan.num_fogs:
        out.append(error(cid, f"layout has {pg.n} partitions for "
                              f"{plan.num_fogs} fogs", layer="plan",
                         subject="partitioned.n", fix_hint=hint))
    if len(pl.assignment) != g.num_vertices:
        out.append(error(cid, f"assignment covers {len(pl.assignment)} "
                              f"vertices, graph has {g.num_vertices}",
                         layer="plan", subject="placement.assignment",
                         fix_hint=hint))
    elif not np.array_equal(pg.part_of, pl.assignment):
        moved = int(np.sum(pg.part_of != pl.assignment))
        out.append(error(cid, f"{moved} vertices live in a different "
                              f"partition than the placement assigns — "
                              f"the layout was built for another "
                              f"assignment", layer="plan",
                         subject="part_of vs assignment", fix_hint=hint))
    mapping = np.asarray(pl.mapping)
    if sorted(mapping.tolist()) != list(range(plan.num_fogs)):
        out.append(error(cid, "partition -> fog mapping is not a "
                              "permutation", layer="plan",
                         subject="placement.mapping", fix_hint=hint))
    if plan.cluster.graph is not None:
        cg = plan.cluster.graph
        if (cg.num_vertices != g.num_vertices
                or cg.num_edges != g.num_edges):
            out.append(error(
                cid, f"cluster was profiled against a "
                     f"{cg.num_vertices}v/{cg.num_edges}e graph; the plan "
                     f"serves {g.num_vertices}v/{g.num_edges}e", layer="plan",
                subject="cluster.graph", fix_hint=hint))
    if plan.cluster.feature_dim != g.feature_dim:
        out.append(error(cid, f"cluster prices {plan.cluster.feature_dim}-d "
                              f"features, graph has {g.feature_dim}-d",
                         layer="plan", subject="cluster.feature_dim",
                         fix_hint=hint))
    if plan.cluster.k_layers != plan.model.num_layers:
        out.append(error(cid, f"cluster prices {plan.cluster.k_layers} "
                              f"layers, model has {plan.model.num_layers}",
                         layer="plan", subject="cluster.k_layers",
                         fix_hint=hint))
    if (len(pg.part_of) == g.num_vertices and g.num_vertices
            and pg.part_of.max() < pg.n and pg.slot_of.max() < pg.slots):
        frozen = pg.feats[pg.part_of, pg.slot_of]
        if not np.array_equal(frozen, g.features.astype(np.float32)):
            stale = int(np.sum(np.any(
                frozen != g.features.astype(np.float32), axis=-1)))
            out.append(error(
                cid, f"{stale} vertices' frozen feature rows disagree with "
                     f"the plan's graph — the partition table is serving a "
                     f"retired revision", layer="plan", subject="feats",
                fix_hint="refresh via PartitionedGraph.with_features or "
                         "rebuild the layout"))
    return out


@register_check(
    "plan.config.keys", family="plan", layer="plan",
    description="every pipeline knob resolves in its registry")
def check_config_keys(ctx: AnalysisContext) -> Iterable[Diagnostic]:
    import torch

    from repro_torch.runtime.bsp import AGGREGATIONS
    cfg = ctx.plan.config
    out = []
    cid = "plan.config.keys"
    for field, registry in (("partitioner", "partitioner"),
                            ("placement", "placement"),
                            ("compressor", "compressor"),
                            ("exchange", "exchange"),
                            ("executor", "executor")):
        key = getattr(cfg, field)
        if key not in ALL_REGISTRIES[registry]:
            out.append(error(
                cid, f"config.{field} = {key!r} does not resolve "
                     f"(available: {', '.join(ALL_REGISTRIES[registry])})",
                layer="plan", subject=f"config.{field}",
                fix_hint="the plan was built against a registry state that "
                         "no longer exists — recompile"))
    if cfg.aggregation not in AGGREGATIONS:
        out.append(error(cid, f"config.aggregation = {cfg.aggregation!r} "
                              f"not in {AGGREGATIONS}", layer="plan",
                         subject="config.aggregation",
                         fix_hint="use segment_sum | pallas | auto"))
    validate = getattr(cfg, "validate", "off")
    if validate not in VALIDATE_MODES:
        out.append(error(cid, f"config.validate = {validate!r} not in "
                              f"{VALIDATE_MODES}", layer="plan",
                         subject="config.validate",
                         fix_hint="use off | warn | strict"))
    try:
        dev = torch.device(cfg.device)
    except (RuntimeError, TypeError) as e:
        out.append(error(cid, f"config.device = {cfg.device!r} is not a "
                              f"torch device ({e})", layer="plan",
                         subject="config.device",
                         fix_hint="use 'cuda', 'cuda:N' or 'cpu'"))
    else:
        if dev.type not in ("cuda", "cpu"):
            out.append(error(cid, f"config.device = {cfg.device!r}: the "
                                  f"port runs on a cuda or cpu device",
                             layer="plan", subject="config.device",
                             fix_hint="use 'cuda', 'cuda:N' or 'cpu'"))
    if not out:
        out.append(info(cid, "all pipeline knobs resolve", layer="plan",
                        subject="config"))
    return out
