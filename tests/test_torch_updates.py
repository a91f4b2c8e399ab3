"""The port's dynamic-graph updates == the JAX package's.

Host code is held exactly: ``GraphDelta`` validation, every function of
``core.incremental``, ``simulate_update``, the repaired assignments and
``apply_delta``'s ``UpdateReport`` are ``==`` / ``np.array_equal`` to the
reference's on seeded random deltas. Device numerics: a query on the
repaired plan matches the JAX package's within rtol 1e-4 / atol 1e-5 (the
bar of tests/test_aggregation.py), with simulated latency, throughput and
bytes exactly equal; inside the port, a repaired plan is bitwise a fresh
port compile of the mutated graph (single-program executors) or a layout
built from scratch at the same assignment (``mesh-bsp``). The port runs on
the CPU (``device="cpu"``); the JAX kernel path runs its Pallas kernels in
interpret mode.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest

from repro.api import Engine as JEngine
from repro.api import GraphDelta as JDelta
from repro.core import incremental as jinc
from repro.core import simulation as jsim
from repro.gnn import datasets as jdata
from repro.gnn import models as jmodels
from repro_torch.api import Engine, GraphDelta
from repro_torch.core import incremental as tinc
from repro_torch.core import simulation as tsim
from repro_torch.gnn import datasets as tdata
from repro_torch.gnn import models as tmodels
from repro_torch.kernels import ops
from repro_torch.runtime import bsp

from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-4, 1e-5


@functools.lru_cache(maxsize=None)
def _setup(kind):
    g = jdata.load("siot", scale=0.05, seed=0)
    gt = tdata.load("siot", scale=0.05, seed=0)
    jparams = jmodels.gnn_init(jax.random.PRNGKey(0), kind,
                               [g.feature_dim, 16, 8])
    nparams = [{k: np.asarray(v) for k, v in p.items()} for p in jparams]
    return g, gt, jparams, tmodels.params_from_numpy(nparams)


def _delta_arrays(g, rng, frac=0.02, structural=True):
    """The keyword arrays of one seeded random delta (the reference's
    tests/test_updates.py generator): new vertices with edges, removed
    vertices, removed edge pairs and feature upserts."""
    v = g.num_vertices
    k = max(1, int(frac * v))
    feats = rng.normal(size=(k, g.feature_dim)).astype(np.float32)
    fanout = rng.integers(1, 4, size=k)
    add_edges = np.stack([np.repeat(v + np.arange(k), fanout),
                          rng.integers(0, v, int(fanout.sum()))], axis=1)
    removed = rng.choice(v, size=max(1, k // 2), replace=False)
    eidx = rng.integers(0, g.num_edges, size=k)
    rem_edges = np.stack([g.senders[eidx], g.receivers[eidx]], axis=1)
    upd = np.setdiff1d(rng.choice(v, size=k, replace=False), removed)
    values = rng.normal(size=(len(upd), g.feature_dim))
    if not structural:
        return dict(feature_ids=upd, feature_values=values)
    return dict(add_features=feats, add_edges=add_edges,
                remove_vertices=removed, remove_edges=rem_edges,
                feature_ids=upd, feature_values=values)


def _deltas(kw):
    return JDelta(**kw), GraphDelta(**kw)


def _named_delta(name, g, plan_assignment=None):
    """(JAX delta, port delta) of one named case."""
    rng = np.random.default_rng(5)
    if name == "empty":
        kw = {}
    elif name == "features":
        kw = _delta_arrays(g, rng, structural=False)
    elif name == "structural":
        kw = _delta_arrays(g, rng)
    elif name == "remove_edges":
        eidx = rng.integers(0, g.num_edges, size=12)
        kw = dict(remove_edges=np.stack([g.senders[eidx],
                                         g.receivers[eidx]], axis=1))
    elif name == "remove_last_vertex":
        # Empty a whole partition: every vertex of the smallest shard.
        sizes = np.bincount(plan_assignment)
        doomed = np.flatnonzero(plan_assignment == int(np.argmin(sizes)))
        kw = dict(remove_vertices=doomed)
    else:
        raise KeyError(name)
    return _deltas(kw)


def _graphs_equal(a, b):
    assert a.num_vertices == b.num_vertices
    for f in ("senders", "receivers", "indptr", "indices", "features",
              "labels", "positions"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y), f


def _report(r):
    return dataclasses.asdict(r)


# ----------------------------------------------------------------------------
# GraphDelta
# ----------------------------------------------------------------------------

def _bad_deltas(v, f):
    return [
        ("add_features", dict(add_features=np.ones((2, f + 1)))),
        ("remove_vertices", dict(remove_vertices=[v + 5])),
        ("add_edges", dict(add_edges=[[0, v]])),
        ("feature_ids", dict(feature_ids=[v],
                             feature_values=np.ones((1, f)))),
        ("same delta removes", dict(remove_vertices=[3], feature_ids=[3],
                                    feature_values=np.ones((1, f)))),
        ("feature_values", dict(feature_ids=[1],
                                feature_values=np.ones((1, f + 2)))),
        ("remove_edges", dict(remove_edges=[[0, v]])),
    ]


@pytest.mark.parametrize("case", range(7))
def test_graphdelta_validation_matches_reference(case):
    g, _, _, _ = _setup("gcn")
    v, f = g.num_vertices, g.feature_dim
    match, kw = _bad_deltas(v, f)[case]
    errors = []
    for cls in (JDelta, GraphDelta):
        with pytest.raises(ValueError, match=match) as ei:
            cls(**kw).validate(v, f)
        errors.append(str(ei.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("kw,match", [
    (dict(feature_ids=[1]), "together"),
    (dict(add_edges=np.ones((2, 3))), "m, 2"),
    (dict(feature_ids=[1, 2], feature_values=np.zeros((1, 4))),
     "feature_values"),
    (dict(add_features=np.ones((2, 3)), add_labels=[1]), "add_labels"),
])
def test_graphdelta_construction_errors_match_reference(kw, match):
    errors = []
    for cls in (JDelta, GraphDelta):
        with pytest.raises(ValueError, match=match) as ei:
            cls(**kw)
        errors.append(str(ei.value))
    assert errors[0] == errors[1]


def test_graphdelta_shape_accessors_match_reference():
    g, _, _, _ = _setup("gcn")
    rng = np.random.default_rng(0)
    for kw in (_delta_arrays(g, rng), _delta_arrays(g, rng, structural=False),
               {}, dict(feature_ids=np.array([]),
                        feature_values=np.zeros((0, g.feature_dim))),
               dict(feature_ids=[2], feature_values=np.zeros(g.feature_dim))):
        jd, td = _deltas(kw)
        for attr in ("num_added_vertices", "num_removed_vertices",
                     "is_empty", "is_structural"):
            assert getattr(jd, attr) == getattr(td, attr), attr
        assert jd.describe() == td.describe() and repr(jd) == repr(td)
        for attr in ("add_features", "remove_vertices", "add_edges",
                     "remove_edges", "feature_ids", "feature_values"):
            a, b = getattr(jd, attr), getattr(td, attr)
            assert (a is None) == (b is None), attr
            if a is not None:
                assert a.dtype == b.dtype and np.array_equal(a, b), attr


# ----------------------------------------------------------------------------
# core.incremental, function by function
# ----------------------------------------------------------------------------

CASES = ["empty", "features", "structural", "remove_edges",
         "remove_last_vertex"]


@functools.lru_cache(maxsize=None)
def _plans():
    """The JAX and port sim plans of GCN (host state only is compared)."""
    g, gt, jparams, tparams = _setup("gcn")
    jplan = JEngine((jparams, "gcn"), cluster="1A+2B+1C",
                    aggregation="segment_sum").compile(g)
    tplan = Engine((tparams, "gcn"), cluster="1A+2B+1C", device="cpu",
                   aggregation="segment_sum").compile(gt)
    return jplan, tplan


@pytest.mark.parametrize("name", CASES)
def test_mutate_graph_and_dirty_partitions_match_reference(name):
    jplan, tplan = _plans()
    a = jplan.placement.assignment
    assert np.array_equal(a, tplan.placement.assignment)
    jd, td = _named_delta(name, jplan.graph, a)
    jg, jmap = jinc.mutate_graph(jplan.graph, jd)
    tg, tmap = tinc.mutate_graph(tplan.graph, td)
    _graphs_equal(jg, tg)
    assert np.array_equal(jmap, tmap)
    n = jplan.num_fogs
    mapped = -np.ones(tg.num_vertices, np.int64)
    alive = tmap[:tplan.graph.num_vertices] >= 0
    mapped[tmap[:tplan.graph.num_vertices][alive]] = a[alive]
    ja = jinc.repair_assignment(jg, mapped, n)
    ta = tinc.repair_assignment(tg, mapped, n)
    assert np.array_equal(ja, ta) and ta.dtype == ja.dtype
    assert jinc.imbalance_of(ja, n) == tinc.imbalance_of(ta, n)
    jl, jh = jinc.dirty_partitions(jplan.graph, a, jg, ja, jmap, jd, n)
    tl, th = tinc.dirty_partitions(tplan.graph, a, tg, ta, tmap, td, n)
    assert np.array_equal(jl, tl) and np.array_equal(jh, th)


@pytest.mark.parametrize("name", CASES)
def test_plan_delta_and_refresh_placement_match_reference(name):
    jplan, tplan = _plans()
    a = jplan.placement.assignment
    jd, td = _named_delta(name, jplan.graph, a)
    chain = [jd, jd] if name == "features" else [jd]
    tchain = [td, td] if name == "features" else [td]
    jp = jinc.plan_delta(jplan.graph, a, chain, jplan.num_fogs)
    tp = tinc.plan_delta(tplan.graph, a, tchain, tplan.num_fogs)
    _graphs_equal(jp.graph, tp.graph)
    for f in ("assignment", "dirty_local", "dirty_halo"):
        assert np.array_equal(getattr(jp, f), getattr(tp, f)), f
    for f in ("structural", "counts", "cut_fraction_before",
              "cut_fraction_after", "imbalance_before", "imbalance"):
        assert getattr(jp, f) == getattr(tp, f), f
    kw = dict(k_layers=2, sync_cost=jplan.cluster.sync_cost)
    jpl = jinc.refresh_placement(jp.graph, jp.assignment,
                                 jplan.placement.mapping, jplan.fogs, **kw)
    tpl = tinc.refresh_placement(tp.graph, tp.assignment,
                                 tplan.placement.mapping, tplan.fogs, **kw)
    for f in dataclasses.fields(jpl):
        x, y = getattr(jpl, f.name), getattr(tpl, f.name)
        if isinstance(x, np.ndarray):
            assert np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("keep", [[0, 2, 3], [3, 1], [2]])
def test_evacuate_assignment_matches_reference(keep):
    jplan, _ = _plans()
    a = jplan.placement.assignment
    n = jplan.num_fogs
    ja = jinc.evacuate_assignment(a, keep, n)
    ta = tinc.evacuate_assignment(a, keep, n)
    assert np.array_equal(ja, ta)
    g = jplan.graph
    assert np.array_equal(jinc.repair_assignment(g, ja, len(keep)),
                          tinc.repair_assignment(g, ta, len(keep)))
    for bad in ([], [0, 0], [n]):
        with pytest.raises(ValueError):
            tinc.evacuate_assignment(a, bad, n)


@pytest.mark.parametrize("name", CASES)
def test_simulate_update_matches_reference(name):
    jplan, tplan = _plans()
    jd, td = _named_delta(name, jplan.graph, jplan.placement.assignment)
    assert (jsim.simulate_update(jplan.cluster, jd)
            == tsim.simulate_update(tplan.cluster, td))


# ----------------------------------------------------------------------------
# Engine.apply_delta on the single-program executors
# ----------------------------------------------------------------------------

APPLY = [(ex, kind, agg) for ex in ("sim", "single", "cloud")
         for kind in ("gcn", "sage") for agg in ("pallas", "segment_sum")]
APPLY += [(ex, "gat", "segment_sum") for ex in ("sim", "single", "cloud")]


def _query_matches(tr, jr):
    np.testing.assert_allclose(tr.embeddings, jr.embeddings, rtol=RTOL,
                               atol=ATOL)
    for f in ("latency", "throughput", "wire_bytes", "exchange_bytes",
              "breakdown", "backend"):
        assert getattr(tr, f) == getattr(jr, f), f


@pytest.mark.parametrize("executor,kind,aggregation", APPLY)
def test_apply_delta_matches_reference_and_a_fresh_compile(executor, kind,
                                                           aggregation):
    g, gt, jparams, tparams = _setup(kind)
    knobs = dict(cluster="1A+2B+1C", executor=executor,
                 aggregation=aggregation, compressor="daq")
    jeng = JEngine((jparams, kind), **knobs)
    teng = Engine((tparams, kind), device="cpu", **knobs)
    jplan, tplan = jeng.compile(g), teng.compile(gt)
    jd, td = _deltas(_delta_arrays(g, np.random.default_rng(7)))
    jplan2, tplan2 = jeng.apply_delta(jplan, jd), teng.apply_delta(tplan, td)
    assert tplan2.provenance == jplan2.provenance == "incremental"
    assert _report(tplan2.update_report) == _report(jplan2.update_report)
    assert np.array_equal(tplan2.placement.assignment,
                          jplan2.placement.assignment)
    assert tplan2.est_makespan == jplan2.est_makespan
    _query_matches(tplan2.session().query(), jplan2.session().query())
    # Inside the port: bitwise a fresh compile of the mutated graph.
    fresh = teng.compile(tinc.mutate_graph(gt, td)[0])
    assert np.array_equal(tplan2.session().query().embeddings,
                          fresh.session().query().embeddings)
    assert tplan2.cluster.graph is tplan2.graph


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_delta_chain_matches_reference(seed):
    """A chain of deltas (each addressing the graph the previous one
    produced), applied at once: report and repair equal the reference's,
    and the port's plan is bitwise a fresh compile."""
    g, gt, jparams, tparams = _setup("gcn")
    jeng = JEngine((jparams, "gcn"), cluster="1A+2B+1C",
                   aggregation="pallas")
    teng = Engine((tparams, "gcn"), cluster="1A+2B+1C", device="cpu",
                  aggregation="pallas")
    jplan, tplan = jeng.compile(g), teng.compile(gt)
    rng = np.random.default_rng(seed)
    jds, tds, g_ref = [], [], gt
    for j in range(3):
        jd, td = _deltas(_delta_arrays(
            g_ref, rng, frac=0.01, structural=(seed % 2 == 0) or j > 0))
        jds.append(jd)
        tds.append(td)
        g_ref, _ = tinc.mutate_graph(g_ref, td)
    jplan2, tplan2 = jeng.apply_delta(jplan, jds), teng.apply_delta(tplan,
                                                                    tds)
    assert _report(tplan2.update_report) == _report(jplan2.update_report)
    assert np.array_equal(tplan2.placement.assignment,
                          jplan2.placement.assignment)
    assert np.array_equal(tplan2.session().query().embeddings,
                          teng.compile(g_ref).session().query().embeddings)


def test_noop_features_and_recompile_modes_match_reference():
    g, gt, jparams, tparams = _setup("gcn")
    jeng = JEngine((jparams, "gcn"), cluster="1A+2B+1C",
                   aggregation="pallas")
    teng = Engine((tparams, "gcn"), cluster="1A+2B+1C", device="cpu",
                  aggregation="pallas")
    jplan, tplan = jeng.compile(g), teng.compile(gt)
    rng = np.random.default_rng(0)
    structural = _delta_arrays(g, rng, frac=0.02)
    features = _delta_arrays(g, rng, structural=False)
    calls = [({}, {}), ({}, dict(force="recompile")),
             (features, {}), (structural, dict(max_imbalance=0.25)),
             (structural, dict(force="recompile")),
             (structural, dict(force="incremental", max_imbalance=0.25)),
             (structural, dict(max_cut_growth=0.5))]
    for kw, opts in calls:
        jd, td = _deltas(kw)
        jp, tp = jeng.apply_delta(jplan, jd, **opts), teng.apply_delta(
            tplan, td, **opts)
        assert tp.provenance == jp.provenance, opts
        assert _report(tp.update_report) == _report(jp.update_report), opts
        assert np.array_equal(tp.placement.assignment,
                              jp.placement.assignment)
        fresh = teng.compile(tinc.mutate_graph(gt, td)[0])
        assert np.array_equal(tp.session().query().embeddings,
                              fresh.session().query().embeddings)
    noop = teng.apply_delta(tplan, GraphDelta())
    assert noop.update_report.mode == "noop"
    assert noop.partitioned is tplan.partitioned and noop.edges is tplan.edges
    with pytest.raises(ValueError, match="force"):
        teng.apply_delta(tplan, GraphDelta(), force="maybe")
    assert tplan.config.update_max_imbalance == 2.0
    assert tplan.config.update_max_cut_growth == 1.5


def test_structural_delta_rebuilds_edges_and_retires_block_csr():
    _, gt, _, tparams = _setup("sage")
    eng = Engine((tparams, "sage"), cluster="1A+2B+1C", device="cpu",
                 aggregation="pallas")
    plan = eng.compile(gt)
    plan.session().query()          # caches the whole-graph BlockCsr
    old_fp = ops.graph_fingerprint(plan.graph)
    assert any(k[0] == old_fp for k in ops._BLOCK_CSR_CACHE)
    rng = np.random.default_rng(2)
    feat = eng.apply_delta(plan, GraphDelta(
        **_delta_arrays(gt, rng, structural=False)))
    # Feature-only: same topology, same edge list, same device copies.
    assert feat.edges is plan.edges
    assert feat.partitioned.device_cache is plan.partitioned.device_cache
    assert any(k[0] == old_fp for k in ops._BLOCK_CSR_CACHE)
    plan2 = eng.apply_delta(plan, GraphDelta(**_delta_arrays(gt, rng)))
    assert not any(k[0] == old_fp for k in ops._BLOCK_CSR_CACHE)
    assert plan2.edges is not plan.edges
    assert plan2.edges.num_vertices == plan2.graph.num_vertices
    assert np.array_equal(plan2.edges.senders.numpy(), plan2.graph.senders)
    assert np.array_equal(plan2.edges.receivers.numpy(),
                          plan2.graph.receivers)
    # A degraded view of the repaired plan shares its (new) edge list.
    assert plan2.with_overrides(num_layers=1).edges is plan2.edges


# ----------------------------------------------------------------------------
# mesh-bsp: the dirty-shard rebuild
# ----------------------------------------------------------------------------

PG_FIELDS = ("feats", "vertex_mask", "senders_global", "senders_halo",
             "receivers_local", "edge_mask", "boundary_rows",
             "boundary_mask", "self_senders_global", "self_senders_halo",
             "part_of", "slot_of")


def _layouts_equal(a, b):
    assert (a.n, a.slots, a.edges_per_part, a.boundary_slots) == (
        b.n, b.slots, b.edges_per_part, b.boundary_slots)
    for f in PG_FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    for attr in ("local_csr", "halo_csr"):
        x, y = getattr(a, attr), getattr(b, attr)
        assert (x is None) == (y is None), attr
        if x is not None:
            for f in ("blocks", "cols", "mask"):
                assert np.array_equal(getattr(x, f), getattr(y, f)), (attr,
                                                                      f)
            assert (x.src_rows, x.out_rows) == (y.src_rows, y.out_rows)


MESH = [("sage", "pallas", "daq"), ("sage", "pallas", "none"),
        ("gcn", "segment_sum", "daq"), ("gcn", "pallas", "daq")]


@pytest.mark.parametrize("kind,aggregation,compressor", MESH)
def test_mesh_dirty_shard_rebuild_is_a_fresh_layout(kind, aggregation,
                                                    compressor):
    g, gt, jparams, tparams = _setup(kind)
    knobs = dict(cluster="4B", executor="mesh-bsp", aggregation=aggregation,
                 compressor=compressor)
    jeng = JEngine((jparams, kind), **knobs)
    teng = Engine((tparams, kind), device="cpu", **knobs)
    jplan, tplan = jeng.compile(g), teng.compile(gt)
    before = tplan.session().query()   # fills the old layout's device cache
    assert before.exchange_bytes > 0
    rng = np.random.default_rng(3)
    v = g.num_vertices
    kw = dict(add_features=rng.normal(size=(6, g.feature_dim)),
              add_edges=np.stack([v + rng.integers(0, 6, 12),
                                  rng.integers(0, v, 12)], 1),
              remove_vertices=rng.choice(v, 4, replace=False))
    jd, td = _deltas(kw)
    jplan2, tplan2 = jeng.apply_delta(jplan, jd), teng.apply_delta(tplan, td)
    assert tplan2.update_report.mode == "incremental"
    assert _report(tplan2.update_report) == _report(jplan2.update_report)
    assert tplan2.update_report.dirty_local     # some shards were rebuilt
    # Host arrays equal the JAX package's layout (its build_partitioned
    # and plan_delta are host numpy; no shard_map runs here).
    _layouts_equal(tplan2.partitioned, jplan2.partitioned)
    assert not tplan2.partitioned.device_cache
    pallas = aggregation == "pallas"
    scratch = bsp.build_partitioned(tplan2.graph,
                                    tplan2.placement.assignment,
                                    n=tplan2.num_fogs, build_blocks=pallas)
    _layouts_equal(tplan2.partitioned, scratch)
    r_inc = tplan2.session().query()
    r_full = dataclasses.replace(tplan2, partitioned=scratch
                                 ).session().query()
    assert np.array_equal(r_inc.embeddings, r_full.embeddings)
    assert r_inc.exchange_bytes == r_full.exchange_bytes > 0
    assert r_inc.latency == r_full.latency
    assert tplan2.edges is not tplan.edges
    # Held against the reference's numerics through its single-program
    # forward of the mutated graph (the JAX mesh needs four devices).
    jr = jplan2.session(executor="sim").query()
    if compressor == "none":
        np.testing.assert_allclose(r_inc.embeddings, jr.embeddings,
                                   rtol=RTOL, atol=ATOL)
    else:
        bar = 5e-2 * max(float(np.abs(jr.embeddings).max()), 1.0)
        assert float(np.abs(r_inc.embeddings - jr.embeddings).max()) <= bar


def test_mesh_feature_only_delta_shares_the_device_cache():
    _, gt, _, tparams = _setup("gcn")
    eng = Engine((tparams, "gcn"), cluster="4B", executor="mesh-bsp",
                 aggregation="pallas", device="cpu")
    plan = eng.compile(gt)
    plan.session().query()
    cache = plan.partitioned.device_cache
    assert cache
    delta = GraphDelta(**_delta_arrays(gt, np.random.default_rng(1),
                                       structural=False))
    plan2 = eng.apply_delta(plan, delta)
    assert plan2.update_report.mode == "features"
    assert plan2.partitioned.device_cache is cache
    g2 = tinc.mutate_graph(gt, delta)[0]
    scratch = bsp.build_partitioned(g2, plan2.placement.assignment,
                                    n=plan2.num_fogs, build_blocks=True)
    _layouts_equal(plan2.partitioned, scratch)
    assert np.array_equal(
        plan2.session().query().embeddings,
        dataclasses.replace(plan2, partitioned=scratch).session().query()
        .embeddings)


# ----------------------------------------------------------------------------
# Session: consistency policies
# ----------------------------------------------------------------------------

def test_session_sync_and_deferred_match_reference():
    g, gt, jparams, tparams = _setup("gcn")
    jplan = JEngine((jparams, "gcn"), cluster="1A+2B+1C",
                    aggregation="pallas").compile(g)
    tplan = Engine((tparams, "gcn"), cluster="1A+2B+1C", device="cpu",
                   aggregation="pallas").compile(gt)
    rng = np.random.default_rng(4)
    chain, g_ref = [], gt
    for j in range(3):
        kw = _delta_arrays(g_ref, rng, frac=0.01, structural=j != 1)
        chain.append(kw)
        g_ref, _ = tinc.mutate_graph(g_ref, GraphDelta(**kw))
    for policy in ("sync", "deferred"):
        js, ts = jplan.session(updates=policy), tplan.session(updates=policy)
        for kw in chain:
            jr, tr = js.update(JDelta(**kw)), ts.update(GraphDelta(**kw))
            assert (jr is None) == (tr is None) == (policy == "deferred")
            if tr is not None:
                assert _report(tr) == _report(jr)
            assert ts.pending_updates == js.pending_updates
        jr, tr = js.flush_updates(), ts.flush_updates()
        assert (jr is None) == (tr is None)
        if tr is not None:
            assert _report(tr) == _report(jr) and tr.num_deltas == 3
        assert ts.pending_updates == 0 and ts.flush_updates() is None
        assert np.array_equal(ts.placement.assignment,
                              js.placement.assignment)
        _query_matches(ts.query(), js.query())
        assert np.array_equal(
            ts.query().embeddings,
            Engine.from_plan(tplan).compile(g_ref).session().query()
            .embeddings)


def test_session_rejected_delta_is_dropped_from_the_buffer():
    _, gt, _, tparams = _setup("gcn")
    plan = Engine((tparams, "gcn"), cluster="1A+2B+1C",
                  device="cpu").compile(gt)
    s = plan.session()
    with pytest.raises(ValueError, match="remove_vertices"):
        s.update(GraphDelta(remove_vertices=[10 ** 9]))
    assert s.pending_updates == 0
    assert s.update(GraphDelta(add_edges=[[0, 9]])) is not None
    with pytest.raises(TypeError, match="GraphDelta"):
        s.update("oops")
    with pytest.raises(ValueError, match="fog partitions"):
        s.update(GraphDelta(remove_vertices=np.arange(
            s.plan.graph.num_vertices - 2)))
    s2 = plan.session(updates="deferred")
    v = s2.plan.graph.num_vertices
    s2.update(GraphDelta(remove_vertices=[v - 1]))
    with pytest.raises(ValueError, match="remove_vertices"):
        s2.update(GraphDelta(remove_vertices=[v - 1]))  # gone after the 1st
    assert s2.pending_updates == 1
    assert s2.flush_updates().mode == "incremental"
    with pytest.raises(ValueError, match="updates"):
        plan.session(updates="lazy")


def test_session_update_after_adapt_keeps_block_shards():
    """A mesh session's repair starts from its adapted assignment and the
    rebuilt layout still carries the kernel path's block shards."""
    _, gt, _, tparams = _setup("gcn")
    plan = Engine((tparams, "gcn"), cluster="1A+2B+1C", executor="mesh-bsp",
                  aggregation="pallas", device="cpu").compile(gt)
    s = plan.session()
    s.state.placement = dataclasses.replace(
        s.state.placement, assignment=np.where(
            np.arange(gt.num_vertices) < 5, 1, plan.placement.assignment))
    s._partitioned = None
    rep = s.update(GraphDelta(**_delta_arrays(gt, np.random.default_rng(9),
                                              frac=0.01)))
    assert rep.mode == "incremental"
    assert s.partitioned().local_csr is not None
    scratch = bsp.build_partitioned(s.plan.graph, s.placement.assignment,
                                    n=plan.num_fogs, build_blocks=True)
    _layouts_equal(s.partitioned(), scratch)
    res = s.query()
    assert np.array_equal(
        res.embeddings,
        dataclasses.replace(s.plan, partitioned=scratch).session().query()
        .embeddings)


def test_session_update_force_through_the_engine():
    _, gt, _, tparams = _setup("gcn")
    eng = Engine((tparams, "gcn"), cluster="1A+2B+1C", device="cpu")
    plan = eng.compile(gt)
    delta = GraphDelta(**_delta_arrays(gt, np.random.default_rng(1)))
    forced = eng.apply_delta(plan, delta, force="recompile")
    assert forced.provenance == "recompile"
    assert forced.update_report.reason == "forced"
    assert forced.partitioned is not plan.partitioned
    assert np.array_equal(forced.placement.assignment,
                          eng.compile(forced.graph).placement.assignment)
