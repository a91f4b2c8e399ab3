"""Cache-key and staleness audit (the "cache" analyzer family).

Two caches keep device state keyed by *some* of what produced it:

  * ``kernels.ops._BLOCK_CSR_CACHE`` — the LRU of prepared whole-graph
    block-CSR operands of the single-program kernel path, keyed
    ``ops.BLOCK_CSR_KEY_FIELDS`` (adjacency fingerprint, normalization,
    tile edge, device). A field missing from a key lets operands of two
    adjacencies (or two devices) collide.
  * ``PartitionedGraph.device_cache`` — the device copies of one mesh
    layout (``runtime.bsp._on_device``), keyed ``(device, what)`` by
    ``bsp.device_key`` ("cuda" and "cuda:0" one key) and shared by the
    layout's ``with_features`` copies. A key must name its device and
    what it holds, and every entry must describe the layout it
    hangs on: a graph revision or a failover rebind builds a new layout
    with an empty cache, so an entry whose geometry disagrees with its
    layout is a stale copy that would be served.

The JAX reference audits its compiled-program cache here instead
(``cache.program.key_fields``, ``cache.program.closure_pins``); the port
compiles no programs, and ``cache.device.layout`` takes their place.
"""
from __future__ import annotations

from typing import Iterable, List

import torch

from repro_torch.analysis.diagnostics import (AnalysisContext, Diagnostic,
                                              error, info, register_check)

#: the ``what`` entries ``runtime.bsp`` keys a layout's device copies by.
DEVICE_CACHE_KINDS = ("layout", "csr", "edges")


def _is_device(name) -> bool:
    if not isinstance(name, str):
        return False
    try:
        torch.device(name)
    except (RuntimeError, TypeError):
        return False
    return True


@register_check(
    "cache.blockcsr.key_fields", family="cache", layer="cache",
    requires=(),
    description="BlockCsr cache keys carry fingerprint + normalize + block "
                "+ device")
def check_blockcsr_key_fields(ctx: AnalysisContext) -> Iterable[Diagnostic]:
    from repro_torch.kernels import ops
    out = []
    cid = "cache.blockcsr.key_fields"
    key_fields = ops.BLOCK_CSR_KEY_FIELDS
    cache = ctx.resolved_block_csr_cache()
    for key in cache:
        if not isinstance(key, tuple) or len(key) != len(key_fields):
            got = len(key) if isinstance(key, tuple) else type(key).__name__
            out.append(error(
                cid, f"BlockCsr cache key {key!r} has {got} fields, "
                     f"registered key has {len(key_fields)} "
                     f"({', '.join(key_fields)}) — operands for different "
                     f"adjacencies/normalizations/devices would collide",
                layer="cache", subject="_BLOCK_CSR_CACHE",
                fix_hint="key entries as (graph_fingerprint(g), normalize, "
                         "block, str(device))"))
            continue
        fp, normalize, block, device = key
        if not (isinstance(fp, str) and len(fp) == 32):
            out.append(error(
                cid, f"BlockCsr key fingerprint {fp!r} is not a 32-hex "
                     f"adjacency digest — content keying is broken and a "
                     f"mutated graph can alias a stale operand",
                layer="cache", subject="key.fingerprint",
                fix_hint="use ops.graph_fingerprint(g)"))
        if normalize not in (None, "mean"):
            out.append(error(
                cid, f"BlockCsr key normalize={normalize!r} is not a known "
                     f"normalization", layer="cache",
                subject="key.normalize", fix_hint="use None or 'mean'"))
        if not isinstance(block, int) or block <= 0:
            out.append(error(
                cid, f"BlockCsr key block={block!r} is not a positive "
                     f"tile edge", layer="cache", subject="key.block",
                fix_hint="use the BLOCK tile size"))
        if not _is_device(device):
            out.append(error(
                cid, f"BlockCsr key device={device!r} is not a torch "
                     f"device name — operands prepared on two devices "
                     f"would collide", layer="cache", subject="key.device",
                fix_hint="key on str(torch.device(...))"))
    if not out:
        out.append(info(cid, f"{len(cache)} cached BlockCsr operands, keys "
                             f"well-formed", layer="cache",
                        subject="_BLOCK_CSR_CACHE"))
    return out


def _entry_problems(pg, what, value) -> List[str]:
    """Why a device-cache entry does not describe layout ``pg`` (empty
    when it does)."""
    n, slots, b = pg.n, pg.slots, pg.boundary_slots
    if what == "layout":
        got = (tuple(value.vertex_mask.shape), value.boundary_index.numel(),
               value.result_index.numel())
        want = ((n * slots, 1), n * b, len(pg.part_of))
        return [] if got == want else [
            f"layout rows (vertex_mask, halo, vertices) {got}, the layout "
            f"has {want}"]
    if what == "csr":
        out = []
        for name, folded, csr in (("local", value[0], pg.local_csr),
                                  ("halo", value[1], pg.halo_csr)):
            if csr is None:
                out.append(f"{name} operand cached but the layout has none")
                continue
            cn, vb, m = csr.cols.shape
            want_src = csr.src_rows * (cn if name == "local" else 1)
            got = (tuple(folded.cols.shape), folded.src_rows,
                   folded.rows.tiles)
            want = ((cn * vb, m), want_src, (cn * vb, m))
            if got != want:
                out.append(f"{name} operand (cols, src rows, rows tiles) "
                           f"{got}, the layout has {want}")
        return out
    if what[0] == "edges":
        got = value.num_vertices
        return [] if got == n * slots else [
            f"edge list over {got} receiver rows, the layout has "
            f"{n * slots}"]
    return [f"unknown entry kind {what!r}"]


@register_check(
    "cache.device.layout", family="cache", layer="cache",
    requires=("plan",),
    description="every device-cache key names its device and its layout "
                "entry, and every entry describes the layout it hangs on")
def check_device_layout(ctx: AnalysisContext) -> Iterable[Diagnostic]:
    from repro_torch.runtime.bsp import device_key
    plan = ctx.plan
    pg = plan.partitioned
    cache = pg.device_cache
    out = []
    cid = "cache.device.layout"
    for key, value in cache.items():
        if (not isinstance(key, tuple) or len(key) != 2
                or not _is_device(key[0])):
            out.append(error(
                cid, f"device-cache key {key!r} does not name a device and "
                     f"an entry — copies for two devices would collide",
                layer="cache", subject="device_cache",
                fix_hint="key entries through bsp._on_device: "
                         "(bsp.device_key(device), what)"))
            continue
        device, what = key
        kind = what[0] if isinstance(what, tuple) else what
        if kind not in DEVICE_CACHE_KINDS:
            out.append(error(
                cid, f"device-cache key {key!r} names no known entry "
                     f"({', '.join(DEVICE_CACHE_KINDS)})", layer="cache",
                subject=f"device_cache[{key!r}]",
                fix_hint="key entries through bsp._on_device"))
            continue
        if device != device_key(plan.device):
            out.append(error(
                cid, f"device-cache entry {what!r} is held on {device} but "
                     f"the plan runs on {plan.device} — dead weight no "
                     f"execute reads", layer="cache",
                subject=f"device_cache[{key!r}]",
                fix_hint="a layout serves one plan's device; rebuild it"))
            continue
        for problem in _entry_problems(pg, what, value):
            out.append(error(
                cid, f"device-cache entry {what!r} is stale: {problem} — "
                     f"an execute would read another revision's layout",
                layer="cache", subject=f"device_cache[{key!r}]",
                fix_hint="a new layout (graph update, failover) must start "
                         "with an empty device_cache"))
    if not out:
        out.append(info(cid, f"{len(cache)} device-cache entries, each "
                             f"keyed by device and entry and describing "
                             f"its layout", layer="cache",
                        subject="device_cache"))
    return out
