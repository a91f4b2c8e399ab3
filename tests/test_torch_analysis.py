"""The port's static verifier (``repro_torch.analysis``) == the JAX package's.

On the same healthy plans both packages are silent. Each mutation of
tests/test_analysis.py (corrupt ``part_of``, duplicate slot, non-binary
mask, non-zero padding, dropped halo row, zeroed halo tile, perturbed
``block_cols``, widened wire dtype, a frontier snapshot cut short, a fleet
tier diverging, ...) is applied to both plans' host innards, and the same
check fires in the port with the same severity, subject and count. The
reference's Pallas lint and program-cache audit have port counterparts
of their own (row-kernel grid, the split CTA's shared memory, TileRows
bounds, flash shared memory, the layouts' device caches): each has a test
with a synthetic case that breaks it and a healthy plan that does not.
The port runs on the CPU (``device="cpu"``); nothing here launches a
kernel.
"""
import copy
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import repro.analysis as janalysis
from repro.api import Engine as JEngine
from repro.api import GraphDelta as JDelta
from repro.gnn import datasets as jdata
from repro.gnn import models as jmodels
import repro_torch.analysis as analysis
from repro_torch.analysis import (AnalysisContext, PlanInvariantWarning,
                                  PlanValidationError, kernel_lint,
                                  run_checks, verify_plan)
from repro_torch.api import Engine, GraphDelta
from repro_torch.gnn import datasets as tdata
from repro_torch.gnn import models as tmodels

from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

PLAN_FAMILIES = ("plan", "kernel", "cache")
SITES = {"north": (59.33, 18.07), "south": (48.21, 16.37),
         "west": (51.51, -0.13)}


@functools.lru_cache(maxsize=None)
def _setup(scale=0.03, seed=0):
    g = jdata.load("siot", scale=scale, seed=seed)
    gt = tdata.load("siot", scale=scale, seed=seed)
    jparams = jmodels.gnn_init(jax.random.PRNGKey(seed), "gcn",
                               [g.feature_dim, 16, 8])
    nparams = [{k: np.asarray(v) for k, v in p.items()} for p in jparams]
    return g, gt, jparams, tmodels.params_from_numpy(nparams)


def _engines(cluster="1A+3B", scale=0.03, seed=0, **knobs):
    _, _, jparams, tparams = _setup(scale, seed)
    return (JEngine((jparams, "gcn"), cluster, **knobs),
            Engine((tparams, "gcn"), cluster, device="cpu", **knobs))


def _make_plans(executor="mesh-bsp", compressor="daq", aggregation="pallas",
                scale=0.03, seed=0, **knobs):
    je, te = _engines(executor=executor, compressor=compressor,
                      aggregation=aggregation, scale=scale, seed=seed,
                      **knobs)
    g, gt = _setup(scale, seed)[:2]
    return je.compile(g), te.compile(gt)


@functools.lru_cache(maxsize=None)
def _mesh_plans():
    return _make_plans()


@pytest.fixture()
def corrupt():
    """Deep copies (reference, port) whose innards a test may mutate."""
    return tuple(copy.deepcopy(p) for p in _mesh_plans())


def _hits(report, check_id):
    return [(d.severity, d.subject) for d in report.by_check(check_id)
            if d.severity != "info"]


def _same_fires(jctx, tctx, check_id, families=PLAN_FAMILIES,
                subjects=True):
    """Run both packages; the check fires in both, alike: the same
    severities and count, and the same subjects unless the check names
    launches (the port's launches carry labels of their own). Returns the
    port's report."""
    jr = janalysis.run_checks(jctx, families=families)
    tr = run_checks(tctx, families=families)
    want, got = _hits(jr, check_id), _hits(tr, check_id)
    assert want, jr.format()
    if not subjects:
        want, got = [w for w, _ in want], [g for g, _ in got]
    assert got == want, (tr.format(), jr.format())
    return tr


# ---------------------------------------------------------------- healthy


@pytest.mark.parametrize("executor,compressor,aggregation", [
    ("sim", "none", "auto"), ("single", "daq", "pallas"),
    ("mesh-bsp", "daq", "pallas"), ("cloud", "uniform8", "auto"),
    ("mesh-bsp", "none", "segment_sum")])
def test_silent_on_healthy_plans(executor, compressor, aggregation):
    jp, tp = _make_plans(executor, compressor, aggregation)
    tr = run_checks(tp, families=PLAN_FAMILIES)
    assert tr.ok and not tr.warnings, tr.format()
    jr = janalysis.run_checks(jp, families=("plan",))
    assert jr.ok and not jr.warnings
    plan_ids = [c for c in tr.ran if c.startswith("plan.")]
    assert plan_ids == [c for c in jr.ran if c.startswith("plan.")]
    assert len(tr.ran) >= 14


def test_healthy_plan_all_plan_checks_ran():
    tp = _mesh_plans()[1]
    report = run_checks(tp, families=("plan",))
    assert set(report.ran) == {fn.check_id
                               for fn in analysis.checks_for(("plan",))}
    assert len(report.ran) == 8
    assert report.ok and not report.warnings, report.format()


# ----------------------------------------------------------- plan family


def test_corrupt_part_of_fires_coverage_and_update(corrupt):
    for plan in corrupt:
        pg = plan.partitioned
        pg.part_of[0] = (pg.part_of[0] + 1) % pg.n
    jr = janalysis.run_checks(corrupt[0], families=("plan",))
    tr = run_checks(corrupt[1], families=("plan",))
    assert not tr.ok
    assert tr.check_ids() == jr.check_ids()
    assert "plan.update.consistency" in tr.check_ids()
    for cid in tr.check_ids():
        assert _hits(tr, cid) == _hits(jr, cid), cid


def _mutate(corrupt, fn):
    for plan in corrupt:
        fn(plan)
    return corrupt


def test_duplicate_slot_fires_disjoint(corrupt):
    def dup(plan):
        pg = plan.partitioned
        pg.part_of[1] = pg.part_of[0]
        pg.slot_of[1] = pg.slot_of[0]
    jp, tp = _mutate(corrupt, dup)
    _same_fires(jp, tp, "plan.partition.disjoint", ("plan",))


def test_nonbinary_mask_fires_layout_masks(corrupt):
    def half(plan):
        plan.partitioned.vertex_mask[0, 0] = 0.5
    jp, tp = _mutate(corrupt, half)
    _same_fires(jp, tp, "plan.layout.masks", ("plan",))


def test_nonzero_padded_feature_row_fires_layout_masks(corrupt):
    dead = np.argwhere(corrupt[1].partitioned.vertex_mask == 0.0)
    assert len(dead), "layout has no padded slots at this scale"
    p, s = dead[0]

    def seven(plan):
        plan.partitioned.feats[p, s, 0] = 7.0
    jp, tp = _mutate(corrupt, seven)
    tr = _same_fires(jp, tp, "plan.layout.masks", ("plan",))
    assert any("padded feature rows" in d.message
               for d in tr.by_check("plan.layout.masks"))


def test_dropped_halo_row_fires_halo_consistency(corrupt):
    p = int(np.argmax(corrupt[1].partitioned.boundary_mask.sum(axis=1)))

    def drop(plan):
        plan.partitioned.boundary_mask[p, 0] = 0.0
    jp, tp = _mutate(corrupt, drop)
    tr = _same_fires(jp, tp, "plan.halo.consistency", ("plan",))
    assert f"[{p}]" in tr.by_check("plan.halo.consistency")[0].subject
    with pytest.raises(PlanValidationError, match="plan.halo.consistency"):
        verify_plan(tp, mode="strict")


def test_zeroed_halo_tile_fires_halo_consistency(corrupt):
    live = np.argwhere(corrupt[1].partitioned.halo_csr.mask == 1.0)
    p, i, k = live[0]

    def zero(plan):
        csr = plan.partitioned.halo_csr
        csr.mask[p, i, k] = 0.0
        csr.blocks[p, i, k] = 0.0
        csr.cols[p, i, k] = 0
    jp, tp = _mutate(corrupt, zero)
    jr = janalysis.run_checks(jp, families=("plan",))
    tr = _same_fires(jp, tp, "plan.halo.consistency", ("plan",))
    assert [d.message for d in tr.by_check("plan.halo.consistency")] == \
        [d.message for d in jr.by_check("plan.halo.consistency")]
    assert any("missing" in d.message
               for d in tr.by_check("plan.halo.consistency"))


def test_nonzero_padding_tile_fires_blocks_ell(corrupt):
    pad = np.argwhere(corrupt[1].partitioned.local_csr.mask == 0.0)
    assert len(pad), "local shards have no ELL padding at this scale"
    p, i, k = pad[0]

    def one(plan):
        plan.partitioned.local_csr.blocks[p, i, k, 0, 0] = 1.0
    jp, tp = _mutate(corrupt, one)
    tr = _same_fires(jp, tp, "plan.blocks.ell", ("plan",))
    assert any("padding tiles carry" in d.message
               for d in tr.by_check("plan.blocks.ell"))


@pytest.mark.parametrize("extra", [1, 128 * 40000])
def test_bad_src_rows_fire_blocks_ell(corrupt, extra):
    """The reference's ragged-source-table and inflated-panel mutations
    (its grid-divisibility and VMEM lints); both packages' ELL geometry
    check names the mismatch."""
    def grow(plan):
        csr = plan.partitioned.halo_csr
        object.__setattr__(csr, "src_rows", csr.src_rows + extra)
    jp, tp = _mutate(corrupt, grow)
    _same_fires(jp, tp, "plan.blocks.ell", ("plan",))


def test_skewed_estimates_fire_capacity_warning(corrupt):
    def skew(plan):
        pl = plan.placement
        pl.est_exec[0] = 1000.0 * (pl.est_total.mean() + 1e-6)
    jp, tp = _mutate(corrupt, skew)
    tr = _same_fires(jp, tp, "plan.capacity.imbalance", ("plan",))
    assert tr.by_check("plan.capacity.imbalance")[0].severity == "warning"


def test_stale_frozen_features_fire_update_consistency(corrupt):
    def stale(plan):
        pg = plan.partitioned
        pg.feats[int(pg.part_of[0]), int(pg.slot_of[0])] += 1.0
    jp, tp = _mutate(corrupt, stale)
    tr = _same_fires(jp, tp, "plan.update.consistency", ("plan",))
    assert any("frozen feature rows" in d.message
               for d in tr.by_check("plan.update.consistency"))


def test_unknown_registry_key_fires_config_keys(corrupt):
    def bad(plan):
        object.__setattr__(plan.config, "compressor", "definitely-not-real")
    jp, tp = _mutate(corrupt, bad)
    tr = _same_fires(jp, tp, "plan.config.keys", ("plan",))
    assert "compressor" in tr.by_check("plan.config.keys")[0].message
    object.__setattr__(tp.config, "compressor", "daq")
    object.__setattr__(tp.config, "device", "tpu")
    hits = run_checks(tp, families=("plan",)).by_check("plan.config.keys")
    assert hits and "device" in hits[0].message


# --------------------------------------------------------- kernel family


def test_perturbed_block_cols_fire_prefetch_bounds(corrupt):
    csr = corrupt[1].partitioned.halo_csr
    p, i, k = np.argwhere(csr.mask == 1.0)[0]

    def perturb(plan):
        c = plan.partitioned.halo_csr
        c.cols[p, i, k] = c.src_rows // 128 + 3   # past the source table
    jp, tp = _mutate(corrupt, perturb)
    tr = _same_fires(jp, tp, "kernel.prefetch.bounds", ("kernel",),
                     subjects=False)
    assert "bounds check" in tr.by_check("kernel.prefetch.bounds")[0].message


def test_widened_wire_dtype_fires_wire_dtype(monkeypatch):
    import jax.numpy as jnp

    from repro.runtime import bsp as jbsp
    from repro_torch.runtime import bsp

    def jfloat_wire(x):
        return (x.astype(jnp.float32),
                jnp.zeros((x.shape[0],), jnp.float32),
                jnp.zeros((x.shape[0],), jnp.float32))

    def float_wire(x):   # regression: ship f32 "codes" on the DAQ wire
        return (x.float(), x.new_zeros(x.shape[:-1]),
                x.new_zeros(x.shape[:-1]))

    monkeypatch.setattr(jbsp, "_wire_quantize", jfloat_wire)
    monkeypatch.setattr(bsp, "_wire_quantize", float_wire)
    jp, tp = _mesh_plans()
    tr = _same_fires(jp, tp, "kernel.wire.dtype", ("kernel",),
                     subjects=False)
    msgs = [d.message for d in tr.by_check("kernel.wire.dtype")]
    assert any("codes" in m for m in msgs)
    assert any("wire format" in m for m in msgs)


def test_wire_dtype_silent_on_healthy():
    report = run_checks(_mesh_plans()[1], families=("kernel",))
    assert not report.by_check("kernel.wire.dtype")
    assert report.ok and not report.warnings, report.format()


@pytest.mark.parametrize("executor,compressor,aggregation,want", [
    ("mesh-bsp", "daq", "pallas",
     {"block_spmm": 2, "dequant_spmm": 2, "block_spmm_batched": 2,
      "dequant_spmm_batched": 2}),
    ("mesh-bsp", "none", "pallas",
     {"block_spmm": 4, "block_spmm_batched": 4}),
    ("sim", "daq", "pallas", {"block_spmm": 2, "block_spmm_batched": 2}),
    ("sim", "daq", "auto", {}),
    ("mesh-bsp", "daq", "segment_sum", {})])
def test_launches_for_plan(executor, compressor, aggregation, want):
    """One execute and one execute_many imply one launch per layer and
    operand; on the CPU "auto" means the segment sum, which launches no
    row kernel. The operand statistics are those of the compacted rows
    an execute builds."""
    tp = _make_plans(executor, compressor, aggregation)[1]
    specs = kernel_lint.launches_for_plan(tp, batch_probe=8)
    assert kernel_lint.launch_counts(specs) == want
    widths = [tp.graph.feature_dim, 16]      # each layer's input width
    per = 2 if executor == "mesh-bsp" else 1
    assert [s.f for s in specs] == [f for f in widths for _ in range(per)
                                    ] * 2 if specs else True
    for s in specs:
        assert (s.batch is None) == (not s.kernel.endswith("_batched"))
        assert (s.code_dtype == torch.uint8) == s.kernel.startswith(
            "dequant")
    if specs and executor == "mesh-bsp":
        tp.session().query()      # fills the device cache (CPU)
        local, halo = tp.partitioned.device_cache["cpu", "csr"]
        again = kernel_lint.launches_for_plan(tp, batch_probe=8)
        assert [s.stats for s in again] == [s.stats for s in specs]
        assert again[0].stats == kernel_lint.RowStats.of(local.rows)


def _synthetic(**over):
    stats = kernel_lint.RowStats(n_warp_rows=250, n_split=2, split_segs=40,
                                 max_src=500)
    stats = dataclasses.replace(stats, **over.pop("stats", {}))
    kw = dict(batch=1, f=64)
    kw.update(over)
    grid = kw.pop("grid", None) or kernel_lint.row_grid(
        kw["batch"], stats.n_warp_rows, stats.n_split, stats.split_segs,
        kw["f"])
    return kernel_lint.LaunchSpec(
        label="synthetic", kernel="block_spmm", operand="graph", f=kw["f"],
        batch=kw["batch"], code_dtype=None, src_rows=512, stats=stats,
        grid=grid)


def test_grid_limit_lint():
    assert not kernel_lint.check_launches([_synthetic()])
    big = _synthetic(batch=2 ** 20, stats=dict(n_warp_rows=2 ** 16))
    assert big.grid.ctas > kernel_lint.MAX_CTAS
    hits = kernel_lint.check_launches([big])
    assert [d.check_id for d in hits] == ["kernel.grid.limit"]
    report = run_checks(_mesh_plans()[1], checks=["kernel.grid.limit"])
    assert report.ok and report.by_check("kernel.grid.limit")[0].severity \
        == "info"


def test_split_smem_lint():
    # the kernel's clamp keeps every real launch inside 48 KB
    for f in (8, 52, 64, 200, 2048):
        for loader in ("f32", "dequant"):
            g = kernel_lint.row_grid(1, 10, 3, 10 ** 6, f, loader)
            assert g.smem + g.static_smem <= kernel_lint.SPLIT_SMEM_LIMIT
    unclamped = kernel_lint.RowGrid(chunks=1, nf=2, round_segs=400,
                                    ctas=10, smem=401 * 65 * 4,
                                    static_smem=4096)
    hits = kernel_lint.check_launches([_synthetic(grid=unclamped)])
    assert [d.check_id for d in hits] == ["kernel.smem.split"]
    assert not run_checks(_mesh_plans()[1],
                          checks=["kernel.smem.split"]).diagnostics


def test_rows_max_src_lint():
    hits = kernel_lint.check_launches([_synthetic(stats=dict(max_src=512))])
    assert [d.check_id for d in hits] == ["kernel.rows.max_src"]
    assert not run_checks(_mesh_plans()[1],
                          checks=["kernel.rows.max_src"]).diagnostics


def test_flash_smem_lint():
    from repro_torch.configs import registry
    cfg = registry.get("qwen1.5-0.5b")
    fl = kernel_lint.flash_launches(cfg, 2, 4096)
    assert fl[0].smem == 74752                      # Geo<64>::SMEM
    ok = run_checks(AnalysisContext(attention=fl), families=("kernel",))
    assert ok.ran == ("kernel.flash.smem",) and ok.ok
    sizes = {(d, dt): kernel_lint.FlashLaunch(d, dt, 1, 1, 64).smem
             for d in (32, 64, 128) for dt in (torch.bfloat16,
                                               torch.float32)}
    assert sizes[128, torch.bfloat16] == 132096     # 129 KB
    assert sizes[128, torch.float32] == 117248
    assert max(sizes.values()) <= kernel_lint.FLASH_SMEM_LIMIT
    wide = kernel_lint.FlashLaunch(256, torch.bfloat16, 1, 16, 4096)
    bad = run_checks(AnalysisContext(attention=[wide]), families=("kernel",))
    assert {d.check_id for d in bad.errors} == {"kernel.flash.smem"}
    assert any("opt into" in d.message for d in bad.errors)
    many = kernel_lint.FlashLaunch(64, torch.float32, 4096, 32, 64)
    assert not run_checks(AnalysisContext(attention=[many]),
                          families=("kernel",)).ok   # grid.y > 65535


# ---------------------------------------------------------- cache family


def test_malformed_blockcsr_key_fires_key_fields():
    bad = {("deadbeef", None, 128, "cpu"): object(),
           ("x" * 32, "median", 128, "cpu"): object(),
           ("x" * 32, None, 128): object(),
           ("x" * 32, None, 128, "warp-drive"): object()}
    report = run_checks(AnalysisContext(block_csr_cache=bad),
                        families=("cache",))
    msgs = [d.message for d in report.by_check("cache.blockcsr.key_fields")]
    assert any("digest" in m for m in msgs)
    assert any("normalization" in m for m in msgs)
    assert any("collide" in m for m in msgs)
    assert any("device name" in m for m in msgs)
    jbad = {k[:3]: v for k, v in list(bad.items())[:2]}
    jr = janalysis.run_checks(janalysis.AnalysisContext(
        block_csr_cache=jbad, program_cache={}), families=("cache",))
    assert len(jr.by_check("cache.blockcsr.key_fields")) == 2
    assert len(report.by_check("cache.blockcsr.key_fields")) == 4


def _served_mesh():
    tp = copy.deepcopy(_mesh_plans()[1])
    tp.session().query()
    assert tp.partitioned.device_cache
    return tp


def test_device_cache_keys_fire_layout():
    tp = _served_mesh()
    ok = run_checks(tp, checks=["cache.device.layout"])
    assert ok.ok and "device-cache entries" in ok.diagnostics[0].message
    cache = tp.partitioned.device_cache
    cache[("layout",)] = object()                      # stripped key
    cache[("cuda:3", "layout")] = cache["cpu", "layout"]   # foreign device
    cache[("cpu", "programs")] = object()              # unknown entry
    hits = run_checks(tp, checks=["cache.device.layout"]).errors
    assert len(hits) == 3
    assert any("collide" in d.message for d in hits)
    assert any("held on cuda:3" in d.message for d in hits)
    assert any("no known entry" in d.message for d in hits)


def test_device_cache_entry_of_another_layout_is_stale():
    """A layout whose device cache holds another layout's copies (a
    rebuilt layout that kept the old dict) fails the audit."""
    tp = _served_mesh()
    eng = _engines(executor="mesh-bsp", compressor="daq",
                   aggregation="pallas")[1]
    plan2 = eng.fail_nodes(tp, tp.cluster.nodes[-1].name)
    assert not plan2.partitioned.device_cache          # starts empty
    stale = dataclasses.replace(plan2, partitioned=dataclasses.replace(
        plan2.partitioned, device_cache=tp.partitioned.device_cache))
    hits = run_checks(stale, checks=["cache.device.layout"]).errors
    assert {d.subject for d in hits} >= {
        "device_cache[('cpu', 'layout')]", "device_cache[('cpu', 'csr')]"}
    assert all("stale" in d.message for d in hits)
    plan2.session().query()
    assert run_checks(plan2, checks=["cache.device.layout"]).ok


def test_cuda_and_its_index_key_one_device_cache_entry(monkeypatch):
    """"cuda" names the current card: ``bsp._on_device`` builds one entry
    for "cuda" and "cuda:0", and the audits find a card's entries for a
    plan that names its device either way."""
    from repro_torch.runtime import bsp
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    tp = _served_mesh()
    cache = tp.partitioned.device_cache
    built = []
    for dev in ("cuda", "cuda:0", torch.device("cuda"),
                torch.device("cuda", 0)):
        bsp._on_device(tp.partitioned, dev, "probe",
                       lambda: built.append(dev) or len(built))
    assert built == ["cuda"] and cache.pop(("cuda:0", "probe")) == 1
    # the entries a run on the card leaves, whichever name it was given
    for key in list(cache):
        cache["cuda:0", key[1]] = cache.pop(key)
    for name in ("cuda", "cuda:0"):
        on_card = dataclasses.replace(tp, config=dataclasses.replace(
            tp.config, device=name))
        assert run_checks(on_card, checks=["cache.device.layout"]).ok
        assert kernel_lint._cached(cache, "csr", name) is cache[
            "cuda:0", "csr"]
    assert kernel_lint._cached(cache, "csr", "cuda:1") is None


def test_live_caches_are_clean_after_serving():
    tp = _make_plans("single", "daq", "pallas")[1]
    tp.session().query()
    from repro_torch.kernels import ops
    assert len(ops._BLOCK_CSR_CACHE) > 0
    report = run_checks(AnalysisContext(plan=_served_mesh()),
                        families=("cache",))
    assert report.ok, report.format()
    assert set(report.ran) == {"cache.blockcsr.key_fields",
                               "cache.device.layout"}


# ------------------------------------------------- verify_plan + Engine


def _moved(corrupt):
    tp = corrupt[1]
    tp.partitioned.part_of[0] = (tp.partitioned.part_of[0] + 1
                                 ) % tp.partitioned.n
    return tp


def test_verify_plan_strict_raises(corrupt):
    with pytest.raises(PlanValidationError) as ei:
        verify_plan(_moved(corrupt), mode="strict")
    assert "plan." in str(ei.value) and ei.value.report.errors


def test_verify_plan_warn_warns(corrupt):
    with pytest.warns(PlanInvariantWarning):
        verify_plan(_moved(corrupt), mode="warn")


def test_verify_plan_off_is_noop(corrupt):
    assert verify_plan(_moved(corrupt), mode="off").diagnostics == []


def test_verify_plan_rejects_unknown_mode():
    with pytest.raises(ValueError, match="validate mode"):
        verify_plan(_mesh_plans()[1], mode="loud")


def test_engine_validate_strict_passes_healthy_plan():
    te = _engines(executor="mesh-bsp", aggregation="pallas", seed=2,
                  validate="strict")[1]
    plan = te.compile(_setup(0.03, 2)[1])
    assert plan.config.validate == "strict"
    assert Engine.from_plan(plan).config.validate == "strict"
    plan2 = te.fail_nodes(plan, plan.cluster.nodes[-1].name)
    assert plan2.config.validate == "strict"


def test_engine_validate_strict_covers_apply_delta(monkeypatch):
    gt = _setup(0.03, 3)[1]
    te = _engines(executor="mesh-bsp", aggregation="pallas", seed=3,
                  validate="strict")[1]
    plan = te.compile(gt)
    v = gt.num_vertices
    delta = GraphDelta(add_features=np.ones((1, gt.feature_dim), np.float32),
                       add_edges=[(v, 0)])
    updated = te.apply_delta(plan, delta, force="incremental")
    assert updated.provenance == "incremental"
    # a repair that corrupts the layout is caught at apply_delta's exit
    from repro_torch.runtime import bsp
    build = bsp.build_partitioned

    def broken(*a, **kw):
        pg = build(*a, **kw)
        pg.boundary_mask[int(np.argmax(pg.boundary_mask.sum(1))), 0] = 0.0
        return pg
    monkeypatch.setattr(bsp, "build_partitioned", broken)
    with pytest.raises(PlanValidationError, match="halo"):
        te.apply_delta(plan, delta, force="incremental")
    with pytest.raises(PlanValidationError, match="halo"):
        te.fail_nodes(plan, plan.cluster.nodes[-1].name)
    warn = _engines(executor="mesh-bsp", aggregation="pallas", seed=3,
                    validate="warn")[1]
    with pytest.warns(PlanInvariantWarning):
        warn.compile(gt)


def test_engine_rejects_unknown_validate():
    with pytest.raises(ValueError, match="validate"):
        Engine((_setup()[3], "gcn"), "1A+3B", validate="shout", device="cpu")


def test_run_checks_reports_crashing_check(monkeypatch):
    from repro_torch.analysis import CHECKS

    def boom(ctx):
        raise RuntimeError("verifier bug")

    boom.check_id = "plan.partition.coverage"
    boom.family, boom.layer, boom.requires = "plan", "plan", ("plan",)
    monkeypatch.setitem(CHECKS._entries, "plan.partition.coverage", boom)
    report = run_checks(_mesh_plans()[1], families=("plan",),
                        checks=["plan.partition.coverage"])
    assert any("check crashed" in d.message
               for d in report.by_check("plan.partition.coverage"))


def test_cli_list_and_demo(capsys):
    from repro_torch.analysis.cli import main
    assert main(["--list"]) == 0
    listed = capsys.readouterr().out
    assert "cache.device.layout" in listed and "hlo" not in listed
    assert main(["--demo", "--strict", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "fault[post-failover]" in out and "kernel[flash-prefill]" in out
    assert out.strip().endswith("— OK")


# --------------------------------------- shipped-stack regression probes


def test_empty_trailing_shard_update_passes_checks():
    je, te = _engines(executor="mesh-bsp", compressor="daq",
                      aggregation="pallas", seed=4)
    g, gt = _setup(0.03, 4)[:2]
    jp, tp = je.compile(g), te.compile(gt)
    last = tp.partitioned.n - 1
    victims = np.flatnonzero(tp.placement.assignment == last)
    tu = te.apply_delta(tp, GraphDelta(remove_vertices=victims),
                        force="incremental")
    ju = je.apply_delta(jp, JDelta(remove_vertices=victims),
                        force="incremental")
    assert tu.partitioned.n == tp.partitioned.n
    assert np.array_equal(tu.partitioned.part_of, ju.partitioned.part_of)
    report = run_checks(tu, families=("plan", "kernel"))
    assert report.ok and not report.warnings, report.format()


def test_slo_rung_sessions_rebased_after_structural_update():
    gt = _setup(0.03, 5)[1]
    plan = _engines(executor="sim", compressor="daq", seed=5)[1].compile(gt)
    server = plan.server(slo=True)
    for lvl in range(len(server.ladder) + 1):
        server._session_for(lvl)
    old = server.session.plan.partitioned
    v = gt.num_vertices
    server.submit(GraphDelta(
        add_features=np.ones((2, gt.feature_dim), np.float32),
        add_edges=[(v, 0), (v + 1, 1)],
        remove_edges=[(int(gt.senders[0]), int(gt.receivers[0]))]))
    (ack,) = server.drain()
    assert ack.applied
    for lvl in range(len(server.ladder) + 1):
        rung = server._session_for(lvl).plan
        assert rung.partitioned is not old
        assert rung.graph.num_vertices == v + 2
        report = run_checks(rung, families=("plan",))
        assert report.ok and not report.warnings, report.format()


# ------------------------------------------------------- frontier family


@functools.lru_cache(maxsize=None)
def _frontier_pair():
    """(reference, port) sessions with a pending dirty frontier."""
    from repro.gnn.graph import from_edge_list as jfrom
    from repro_torch.gnn.graph import from_edge_list as tfrom
    rng = np.random.default_rng(11)
    v = 40
    edges = np.array([(i, i + 1) for i in range(v - 1)], np.int64)
    x = rng.normal(size=(v, 4)).astype(np.float32)
    jparams = jmodels.gnn_init(jax.random.PRNGKey(11), "gcn", [4, 8, 4])
    tparams = tmodels.params_from_numpy(
        [{k: np.asarray(a) for k, a in p.items()} for p in jparams])
    out = []
    for eng, g, delta in (
            (JEngine((jparams, "gcn"), "1A+2B", executor="sim",
                     aggregation="segment_sum"), jfrom(v, edges, x), JDelta),
            (Engine((tparams, "gcn"), "1A+2B", executor="sim",
                    aggregation="segment_sum", device="cpu"),
             tfrom(v, edges, x), GraphDelta)):
        sess = eng.compile(g).session(activation_cache=True,
                                      frontier_max_fraction=1.0)
        sess.query()
        sess.update(delta(feature_ids=[3], feature_values=np.ones(
            (1, 4), np.float32)))
        assert sess.frontier_state() is not None
        out.append(sess)
    return tuple(out)


def _frontier_ctxs(mutate=None):
    js, ts = _frontier_pair()
    jf, tf = js.frontier_state(), ts.frontier_state()
    if mutate is not None:
        jf, tf = mutate(jf), mutate(tf)
    return (janalysis.AnalysisContext(plan=js.plan, frontier=jf),
            AnalysisContext(plan=ts.plan, frontier=tf))


def test_frontier_checks_silent_on_healthy_pending_delta():
    jctx, tctx = _frontier_ctxs()
    report = run_checks(tctx, families=("frontier",))
    assert report.ok and not report.warnings, report.format()
    assert set(report.ran) == {"plan.frontier.closure",
                               "plan.frontier.revision"}
    assert [d.message for d in report.diagnostics] == [
        d.message for d in janalysis.run_checks(
            jctx, families=("frontier",)).diagnostics]


def test_frontier_checks_skip_without_frontier():
    report = run_checks(AnalysisContext(plan=_mesh_plans()[1]),
                        families=("frontier",))
    assert report.ok and not report.ran


@pytest.mark.parametrize("case", ["truncated", "undercovered",
                                  "out_of_range", "stale_revision",
                                  "vertex_count"])
def test_frontier_mutations_fire_like_reference(case):
    check, mutate = {
        "truncated": ("plan.frontier.closure",
                      lambda f: dataclasses.replace(f, rows=f.rows[:-1])),
        "undercovered": ("plan.frontier.closure",
                         lambda f: dataclasses.replace(
                             f, rows=f.rows[:-1] + [f.rows[-1][:-1]])),
        "out_of_range": ("plan.frontier.closure",
                         lambda f: dataclasses.replace(
                             f, seeds=np.concatenate(
                                 [f.seeds, [f.num_vertices + 5]]))),
        "stale_revision": ("plan.frontier.revision",
                           lambda f: dataclasses.replace(
                               f, revision="deadbeef")),
        "vertex_count": ("plan.frontier.revision",
                         lambda f: dataclasses.replace(
                             f, num_vertices=f.num_vertices + 1)),
    }[case]
    jctx, tctx = _frontier_ctxs(mutate)
    report = _same_fires(jctx, tctx, check, ("frontier",))
    assert not report.ok


# ---------------------------------------------------------- fleet family


@functools.lru_cache(maxsize=None)
def _fleets():
    je, te = _engines("1A+2B", scale=0.06, exchange="halo_async",
                      staleness_bound=2)
    return (je.compile_fleet(_setup(0.06)[0], SITES),
            te.compile_fleet(_setup(0.06)[1], SITES))


@pytest.mark.parametrize("case", ["healthy", "router", "centroid",
                                  "revision", "staleness", "cloud_store"])
def test_fleet_checks_equal_reference(case):
    from repro.api.session import _HaloStore as JStore
    from repro_torch.api.session import _HaloStore
    jfleet, tfleet = _fleets()
    js, ts = jfleet.server(), tfleet.server()
    g = _setup(0.06)[1]
    for fs, delta, store in ((js, JDelta, JStore), (ts, GraphDelta,
                                                    _HaloStore)):
        if case == "router":
            fs.router.table.pop("south")
        elif case == "centroid":
            fs.router.table["south"] = (0.0, 0.0)
        elif case == "revision":
            fs.servers["west"].session.update(delta(
                feature_ids=np.array([1]),
                feature_values=np.zeros((1, g.feature_dim), np.float32)))
        elif case == "staleness":
            fs.staleness_bound = 9
        elif case == "cloud_store":
            fs.servers["cloud"].session._halo = store(1)
    jr = janalysis.run_checks(janalysis.AnalysisContext(fleet=js),
                              families=("fleet",))
    tr = run_checks(AnalysisContext(fleet=ts), families=("fleet",))
    assert tr.ran == jr.ran
    got = [(d.check_id, d.severity, d.subject) for d in tr.diagnostics]
    assert got == [(d.check_id, d.severity, d.subject)
                   for d in jr.diagnostics]
    assert tr.ok == (case == "healthy")
    bare = run_checks(AnalysisContext(fleet=tfleet), families=("fleet",))
    assert bare.ok
