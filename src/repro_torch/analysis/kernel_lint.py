"""Launch lint of the hand-written kernels (the "kernel" analyzer family).

Derives every launch of the row kernels that one ``execute`` and one
``execute_many`` of ``batch_probe`` imply for a plan — the mesh executor's
local and halo products per layer (``block_spmm`` / ``dequant_spmm`` on
the DAQ halo wire, and their batched forms) and the single-program
executors' whole-graph ``block_spmm`` per layer — from the plan alone,
launching nothing, and lints them against what ``kernels/csrc`` accepts:

  kernel.grid.limit       a row-kernel launch stays below 2^31 CTAs
                          (``rows_spmm`` / ``dequant_rows`` refuse more)
  kernel.smem.split       the split CTA's staging plus its partials fit
                          the 48 KB a launch takes without opting in
                          (``part_slots<Rows>()``)
  kernel.rows.max_src     ``TileRows.max_src`` lies inside the source
                          table the launch reads (the kernels read
                          ``src[e]`` with no bounds check)
  kernel.prefetch.bounds  every real tile's column block lies inside its
                          shard's padded source table
  kernel.wire.dtype       the DAQ halo wire's codes are unsigned integers
                          the dequantizing loader takes, its row
                          parameters f32, and the executor's declared
                          wire format matches what it ships
  kernel.flash.smem       a flash-attention launch's dynamic shared memory
                          (``Geo<D>::SMEM`` in bf16, ``smem_bytes_f32<D>``
                          in f32) fits the card's opt-in limit, and its
                          grid the launch limits

The geometry below mirrors ``kernels/csrc/block_spmm.cu`` (``row_grid``,
``part_slots``) and ``kernels/csrc/flash_attention.cu`` (``Geo``); the JAX
reference's Pallas lint traces its kernels with ``jax.eval_shape``
instead.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.diagnostics import (AnalysisContext, Diagnostic,
                                              error, info, register_check)
from repro_torch.api.registry import EXECUTORS
from repro_torch.kernels.daq_dequant import CODE_BYTES
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.kernels.gather_aggregate import BLOCK, TileRows

#: warps per CTA of the row kernels (``kRowWarps``).
ROW_WARPS = 8
#: ``sizeof(Rows::Stage)`` a warp: 32 int4 entries, plus 32 float2 (scale,
#: min) pairs for the dequantizing loader.
STAGE_BYTES = {"f32": 32 * 16, "dequant": 32 * 16 + 32 * 8}
#: shared memory a launch may take without opting in.
SPLIT_SMEM_LIMIT = 48 * 1024
#: the feature chunks the row kernels instantiate (``ROWS_SPMM(1..8)``).
MAX_NF = 8
#: ``rows_spmm`` / ``dequant_rows`` refuse a grid of more CTAs.
MAX_CTAS = 0x7FFFFFFF
#: dynamic shared memory a CTA may opt into on sm_90 (227 KB).
FLASH_SMEM_LIMIT = 227 * 1024
#: grid.y limit of a launch.
MAX_GRID_Y = 65535


@dataclasses.dataclass(frozen=True)
class RowGrid:
    """The grid of one row-kernel launch (``row_grid`` in block_spmm.cu)."""
    chunks: int
    nf: int
    round_segs: int
    ctas: int
    smem: int          # dynamic bytes
    static_smem: int   # the warps' staging


def part_slots(stage_bytes: int) -> int:
    """``part_slots<Rows>()``: partial slots a split CTA keeps per NF."""
    return (SPLIT_SMEM_LIMIT - ROW_WARPS * stage_bytes) // (33 * 4)


def row_grid(batch: int, n_warp_rows: int, n_split: int, split_segs: int,
             f: int, loader: str = "f32") -> RowGrid:
    """The launch geometry ``rows_spmm`` / ``dequant_rows`` compute."""
    chunks = (f + 255) // 256
    nf = ((f + chunks - 1) // chunks + 31) // 32
    n_split_ctas = n_split * chunks * batch
    n_warps = n_warp_rows * chunks * batch
    ctas = n_split_ctas + (n_warps + ROW_WARPS - 1) // ROW_WARPS
    stage = STAGE_BYTES[loader]
    round_segs = (min(split_segs, part_slots(stage) // nf - 1)
                  if n_split else 1)
    smem = (round_segs + 1) * (nf * 32 + 1) * 4 if n_split else 0
    return RowGrid(chunks=chunks, nf=nf, round_segs=round_segs, ctas=ctas,
                   smem=smem, static_smem=ROW_WARPS * stage)


@dataclasses.dataclass(frozen=True)
class RowStats:
    """What a launch's grid and bounds depend on, from its operand's
    TileRows."""
    n_warp_rows: int
    n_split: int
    split_segs: int
    max_src: int

    @classmethod
    def of(cls, rows: TileRows) -> "RowStats":
        return cls(n_warp_rows=len(rows.warp_rows), n_split=len(rows.split),
                   split_segs=rows.split_segs, max_src=rows.max_src)


class _Operand:
    """One block-CSR operand a plan's launches read, as the executor
    folds it: host tiles, column blocks, the source table's rows. Its
    TileRows statistics come from the copy a run already compacted on
    the device (``device_cache`` / the BlockCsr LRU) when there is one,
    else from a compaction of the host tiles on the CPU."""

    def __init__(self, name: str, blocks: np.ndarray, cols: np.ndarray,
                 mask: np.ndarray, src_rows: int,
                 cached: Optional[TileRows] = None):
        self.name = name
        self.blocks, self.cols, self.mask = blocks, cols, mask
        self.src_rows = src_rows
        self._cached = cached

    @functools.cached_property
    def stats(self) -> RowStats:
        if self._cached is not None:
            return RowStats.of(self._cached)
        from repro_torch.kernels.gather_aggregate import compact_block_csr
        with torch.no_grad():
            rows = compact_block_csr(torch.from_numpy(self.blocks),
                                     torch.from_numpy(self.cols),
                                     torch.from_numpy(self.mask))
        return RowStats.of(rows)


@dataclasses.dataclass(frozen=True)
class LaunchSpec:
    """One row-kernel launch a plan implies.

    ``kernel`` names the wrapper whose counter the launch raises;
    ``operand`` the block-CSR operand ("graph", "local" or "halo");
    ``batch`` is None for a single launch; ``code_dtype`` the wire's code
    dtype for a dequantizing launch (None: an f32 table). ``grid`` is the
    geometry the kernel computes, ``stats`` its operand's rows, and
    ``src_rows`` the rows of the source table the launch reads.
    """
    label: str
    kernel: str
    operand: str
    f: int
    batch: Optional[int]
    code_dtype: Optional[torch.dtype]
    src_rows: int
    stats: RowStats
    grid: RowGrid


def _layer_widths(plan) -> List[int]:
    """The width each layer's aggregation reads: its input width (the
    first dim of its first 2-D weight), in layer order."""
    widths = []
    for p in plan.model.params:
        mats = [p[k] for k in sorted(p) if getattr(p[k], "ndim", 0) == 2]
        widths.append(int(mats[0].shape[0]) if mats
                      else plan.graph.feature_dim)
    return widths


def wire_probe(f: int):
    """The DAQ wire's (codes, scales, mins) for a 2-row table of width
    ``f``, through ``bsp._wire_quantize`` on the CPU."""
    from repro_torch.runtime import bsp
    return bsp._wire_quantize(torch.zeros((2, f), dtype=torch.float32))


def _cached(cache: dict, what, device):
    """The entry of ``cache`` keyed ``(device, what)`` (a layout's device
    cache) or ``what + (device,)`` (the BlockCsr LRU) for ``device``, or
    None; devices compare by ``bsp.device_key``."""
    from repro_torch.runtime.bsp import device_key
    want = device_key(device)
    for key, value in cache.items():
        if not isinstance(key, tuple) or len(key) < 2:
            continue
        if isinstance(what, tuple):
            dev, rest = key[-1], key[:-1]
        else:
            dev, rest = key[0], key[1]
        if rest == what and device_key(dev) == want:
            return value
    return None


def _mesh_operands(plan) -> Tuple[_Operand, _Operand]:
    """The mesh's local and halo operands, folded as ``bsp._fold`` folds
    them (the local one reads a stacked per-shard table)."""
    pg = plan.partitioned
    cached = _cached(pg.device_cache, "csr", plan.device)
    out = []
    for i, (name, csr) in enumerate((("local", pg.local_csr),
                                     ("halo", pg.halo_csr))):
        n, vb, m = csr.cols.shape
        cols, src_rows = csr.cols, csr.src_rows
        if name == "local":
            cols = cols + (np.arange(n, dtype=np.int32)
                           * (src_rows // BLOCK))[:, None, None]
            src_rows *= n
        fold = lambda a: a.reshape((n * vb,) + a.shape[2:])  # noqa: E731
        out.append(_Operand(
            name, fold(csr.blocks), fold(np.ascontiguousarray(cols)),
            fold(csr.mask), src_rows,
            None if cached is None else cached[i].rows))
    return out[0], out[1]


def _graph_operand(plan) -> _Operand:
    """The single-program path's whole-graph operand
    (``ops.block_csr_for(plan.graph)``), read from the BlockCsr LRU when a
    run prepared it, else built on the host."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.gather_aggregate import build_block_csr
    csr = _cached(ops._BLOCK_CSR_CACHE,
                  (ops.graph_fingerprint(plan.graph), None, BLOCK),
                  plan.device)
    g = plan.graph
    if csr is not None:
        return _Operand("graph", None, None, None, csr.padded_v, csr.rows)
    blocks, cols, mask, padded_v = build_block_csr(
        g.senders, g.receivers, g.num_vertices, BLOCK)
    return _Operand("graph", blocks, cols, mask, padded_v)


def kernel_path_active(plan) -> bool:
    """Whether a plan's executes launch the row kernels (its aggregation
    resolves to the kernel path on its device and executor)."""
    from repro_torch.runtime import bsp
    backend = EXECUTORS.resolve(plan.config.executor)
    exch = plan.config.exchange if backend.needs_block_shards else None
    try:
        mode = bsp.resolve_aggregation(plan.config.aggregation,
                                       plan.model.kind, exchange=exch,
                                       device=plan.device)
    except ValueError:
        return False
    return mode == "pallas"


def launches_for_plan(plan, batch_probe: int = 8) -> List[LaunchSpec]:
    """Every row-kernel launch of one ``execute`` and one ``execute_many``
    of ``batch_probe`` on ``plan`` (fresh serves), in launch order."""
    if not kernel_path_active(plan):
        return []
    backend = EXECUTORS.resolve(plan.config.executor)
    widths = _layer_widths(plan)
    specs: List[LaunchSpec] = []
    if backend.needs_block_shards:
        if plan.partitioned.local_csr is None:
            return []
        local, halo = _mesh_operands(plan)
        quant = backend.wire_format(plan, plan.config.exchange,
                                    plan.config.aggregation) != (4, 0)
        for batch in (None, batch_probe):
            suffix = "" if batch is None else "_batched"
            for f in widths:
                for op in (local, halo):
                    dq = quant and op is halo
                    code = wire_probe(f)[0].dtype if dq else None
                    kern = ("dequant_spmm" if dq else "block_spmm") + suffix
                    specs.append(_spec(op, kern, f, batch, code))
        return specs
    graph = _graph_operand(plan)
    for batch in (None, batch_probe):
        suffix = "" if batch is None else "_batched"
        for f in widths:
            specs.append(_spec(graph, "block_spmm" + suffix, f, batch, None))
    return specs


def _spec(op: _Operand, kernel: str, f: int, batch: Optional[int],
          code: Optional[torch.dtype]) -> LaunchSpec:
    st = op.stats
    grid = row_grid(batch or 1, st.n_warp_rows, st.n_split, st.split_segs,
                    f, "dequant" if code is not None else "f32")
    return LaunchSpec(
        label=f"{op.name}/{kernel}/f{f}", kernel=kernel, operand=op.name,
        f=f, batch=batch, code_dtype=code, src_rows=op.src_rows, stats=st,
        grid=grid)


def launch_counts(specs: Iterable[LaunchSpec]) -> Dict[str, int]:
    """kernel wrapper -> launches, as the wrappers' counters add them."""
    out: Dict[str, int] = {}
    for s in specs:
        out[s.kernel] = out.get(s.kernel, 0) + 1
    return out


def _specs(ctx: AnalysisContext) -> List[LaunchSpec]:
    """The context's launches, derived once per context."""
    memo = ctx.__dict__.setdefault("_kernel_lint_specs", {})
    key = (id(ctx.plan), ctx.batch_probe)
    if key not in memo:
        memo[key] = launches_for_plan(ctx.plan, ctx.batch_probe)
    return memo[key]


def check_launches(specs: Iterable[LaunchSpec]) -> List[Diagnostic]:
    """``kernel.grid.limit``, ``kernel.smem.split`` and
    ``kernel.rows.max_src`` over ``specs`` (plan-derived or synthetic)."""
    out = []
    for spec in specs:
        g = spec.grid
        if g.ctas > MAX_CTAS or not 1 <= g.nf <= MAX_NF:
            out.append(error(
                "kernel.grid.limit",
                f"{spec.label}: {g.ctas} CTAs at NF = {g.nf} — the launch "
                f"takes at most {MAX_CTAS} CTAs and NF 1..{MAX_NF}; "
                f"rows_spmm would refuse it (cudaErrorInvalidValue)",
                layer="kernel", subject=spec.label,
                fix_hint="split the batch or the operand's rows over "
                         "several launches"))
        if spec.stats.n_split and g.smem + g.static_smem > SPLIT_SMEM_LIMIT:
            out.append(error(
                "kernel.smem.split",
                f"{spec.label}: the split CTA takes {g.static_smem} B of "
                f"staging + {g.smem} B of partials ({g.round_segs} segments "
                f"a round at NF = {g.nf}), over the {SPLIT_SMEM_LIMIT} B a "
                f"launch takes without opting in", layer="kernel",
                subject=spec.label,
                fix_hint="round_segs must stay within part_slots<Rows>() "
                         "/ NF - 1"))
        if spec.stats.max_src >= spec.src_rows:
            out.append(error(
                "kernel.rows.max_src",
                f"{spec.label}: the operand's rows read source row "
                f"{spec.stats.max_src} but the table has {spec.src_rows} "
                f"rows — the kernel reads src[e] with no bounds check",
                layer="kernel", subject=spec.label,
                fix_hint="recompact the operand (compact_block_csr) from "
                         "tiles that fit the table"))
    return out


@register_check(
    "kernel.grid.limit", family="kernel", layer="kernel",
    description="every implied row-kernel launch stays below 2^31 CTAs")
def check_grid_limit(ctx: AnalysisContext) -> Iterable[Diagnostic]:
    specs = _specs(ctx)
    out = [d for d in check_launches(specs)
           if d.check_id == "kernel.grid.limit"]
    if not out:
        most = max((s.grid.ctas for s in specs), default=0)
        out.append(info("kernel.grid.limit",
                        f"{len(specs)} launches, at most {most} CTAs",
                        layer="kernel", subject="launches"))
    return out


@register_check(
    "kernel.smem.split", family="kernel", layer="kernel",
    description="the split CTA's shared memory fits 48 KB")
def check_smem_split(ctx: AnalysisContext) -> Iterable[Diagnostic]:
    return [d for d in check_launches(_specs(ctx))
            if d.check_id == "kernel.smem.split"]


@register_check(
    "kernel.rows.max_src", family="kernel", layer="kernel",
    description="TileRows.max_src lies inside each launch's source table")
def check_rows_max_src(ctx: AnalysisContext) -> Iterable[Diagnostic]:
    return [d for d in check_launches(_specs(ctx))
            if d.check_id == "kernel.rows.max_src"]


@register_check(
    "kernel.prefetch.bounds", family="kernel", layer="kernel",
    description="every real tile's column block lies inside its shard's "
                "padded source table")
def check_prefetch_bounds(ctx: AnalysisContext) -> Iterable[Diagnostic]:
    plan = ctx.plan
    if not kernel_path_active(plan):
        return []
    pg = plan.partitioned
    out = []
    cid = "kernel.prefetch.bounds"
    if EXECUTORS.resolve(plan.config.executor).needs_block_shards:
        tables = [(f"mesh/{name}", csr) for name, csr in
                  (("local", pg.local_csr), ("halo", pg.halo_csr))
                  if csr is not None]
    else:
        tables = []   # the whole-graph operand is built here, in bounds
    for label, csr in tables:
        limit = csr.src_rows // BLOCK
        real = csr.mask != 0.0
        if not real.any():
            continue
        cols = csr.cols[real]
        lo, hi = int(cols.min()), int(cols.max())
        if lo < 0 or hi >= limit:
            out.append(error(
                cid, f"{label}: block_cols span [{lo}, {hi}] but a shard's "
                     f"padded source table has only {limit} column blocks "
                     f"({csr.src_rows} rows / {BLOCK}) — the kernel indexes "
                     f"with no bounds check and would read out of the "
                     f"table (or another shard's rows)", layer="kernel",
                subject=label,
                fix_hint="rebuild the block-CSR shards; a dirty-shard "
                         "reuse kept tiles whose source space shrank"))
    return out


@register_check(
    "kernel.wire.dtype", family="kernel", layer="kernel",
    description="the quantized halo wire's dtypes match the kernel "
                "contract and the declared wire format")
def check_wire_dtype(ctx: AnalysisContext) -> Iterable[Diagnostic]:
    plan = ctx.plan
    pg = plan.partitioned
    out = []
    cid = "kernel.wire.dtype"
    if pg.halo_csr is None or plan.config.executor != "mesh-bsp":
        return out
    backend = EXECUTORS.resolve(plan.config.executor)
    try:
        declared = backend.wire_format(plan, plan.config.exchange,
                                       plan.config.aggregation)
    except Exception:
        declared = None
    codes, scales, mins = wire_probe(plan.graph.feature_dim)
    quantized = (kernel_path_active(plan)
                 and plan.config.compressor.startswith("daq"))
    if quantized:
        if codes.dtype not in CODE_BYTES:
            out.append(error(
                cid, f"the quantized halo wire carries {codes.dtype} codes "
                     f"— dequant_spmm takes uint8/16/32 codes and refuses "
                     f"anything else", layer="kernel",
                subject="_wire_quantize",
                fix_hint="quantize to uint8 (or another unsigned width) "
                         "before the exchange"))
        for name, t in (("scales", scales), ("mins", mins)):
            if t.dtype != torch.float32:
                out.append(error(
                    cid, f"halo wire {name} are {t.dtype}, kernel contract "
                         f"is float32", layer="kernel",
                    subject="_wire_quantize",
                    fix_hint="keep the per-row (scale, min) pair f32"))
        actual = (codes.element_size(),
                  scales.element_size() + mins.element_size())
        if declared is not None and declared != actual:
            out.append(error(
                cid, f"executor declares wire format {declared} "
                     f"(bytes/feature, bytes/row) but the quantized path "
                     f"ships {actual} — the exchange-bytes accounting is "
                     f"lying", layer="kernel", subject="wire_format",
                fix_hint="keep _MeshBsp.wire_format in sync with "
                         "bsp._wire_quantize"))
    elif declared is not None and declared != (4, 0):
        out.append(error(
            cid, f"float halo wire declared as {declared}, expected (4, 0)",
            layer="kernel", subject="wire_format",
            fix_hint="non-DAQ plans ship raw float32 boundary rows"))
    return out


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FlashLaunch:
    """One flash-attention launch: head dim, dtype and grid extent."""
    head_dim: int
    dtype: torch.dtype
    batch: int
    heads: int
    s_len: int

    @property
    def smem(self) -> int:
        """Dynamic shared memory the launch sets (bytes)."""
        d = self.head_dim
        if self.dtype == torch.bfloat16:
            wg = 2 if d == 128 else 3
            bm, ch = 64 * wg, min(d, 64)
            nch, row = d // ch, ch * 2
            return 1024 + nch * bm * row + 3 * 2 * nch * 64 * row
        rows = cols = 64
        return 4 * (rows * (d + 4) + d * (cols + 1) + cols * d
                    + rows * (cols + 4))

    @property
    def grid(self) -> Tuple[int, int]:
        """(grid.x, grid.y) of the launch."""
        if self.dtype == torch.bfloat16:
            bm = 64 * (2 if self.head_dim == 128 else 3)
            return (self.batch * self.heads, -(-self.s_len // bm))
        return (-(-self.s_len // 64), self.batch * self.heads)


def flash_launches(config, batch: int, s_len: int) -> List[FlashLaunch]:
    """The flash launch of one attention layer of a transformer config
    (``models.config.ModelConfig``) at ``batch`` x ``s_len``, in the
    config's activation dtype."""
    dtype = getattr(torch, getattr(config, "activation_dtype", "bfloat16"))
    return [FlashLaunch(head_dim=config.head_dim, dtype=dtype, batch=batch,
                        heads=config.num_heads, s_len=s_len)]


@register_check(
    "kernel.flash.smem", family="kernel", layer="kernel",
    requires=("attention",),
    description="flash-attention launches fit the card's opt-in shared "
                "memory and the grid limits")
def check_flash_smem(ctx: AnalysisContext) -> Iterable[Diagnostic]:
    out = []
    cid = "kernel.flash.smem"
    for fl in ctx.attention:
        label = f"flash/{str(fl.dtype).split('.')[-1]}/dh{fl.head_dim}"
        if fl.head_dim not in HEAD_DIMS:
            out.append(error(
                cid, f"{label}: head dim {fl.head_dim} has no instance "
                     f"(the kernels take {HEAD_DIMS}); it would need "
                     f"{fl.smem} B of shared memory", layer="kernel",
                subject=label,
                fix_hint="serve a head dim the kernels instantiate"))
        if fl.smem > FLASH_SMEM_LIMIT:
            out.append(error(
                cid, f"{label}: {fl.smem} B of dynamic shared memory, over "
                     f"the {FLASH_SMEM_LIMIT} B a CTA may opt into — "
                     f"cudaFuncSetAttribute fails", layer="kernel",
                subject=label,
                fix_hint="fewer K/V stages or a narrower query tile"))
        gx, gy = fl.grid
        if gx > MAX_CTAS or gy > MAX_GRID_Y:
            out.append(error(
                cid, f"{label}: grid ({gx}, {gy}) over the launch limits "
                     f"({MAX_CTAS}, {MAX_GRID_Y})", layer="kernel",
                subject=label,
                fix_hint="split the batch x heads axis over launches"))
    if not out:
        most = max((f.smem for f in ctx.attention), default=0)
        out.append(info(cid, f"{len(ctx.attention)} flash launches fit "
                             f"(largest {most} B)", layer="kernel",
                        subject="attention"))
    return out
