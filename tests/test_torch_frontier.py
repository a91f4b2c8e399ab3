"""The port's incremental frontier queries == the JAX package's.

Host code is held exactly: ``core.frontier`` (the hand-computed oracles of
tests/test_incremental_query.py, ``fold_delta_frontier`` over seeded delta
streams, ``ActivationCache`` remaps, dirty rows per layer, the
``max_fraction`` budget and ``pallas_ok``) is ``==`` the reference's.
Embeddings of a cached session's frontier queries match the JAX package's
own frontier pass within rtol 1e-4 / atol 1e-5 (its Pallas kernels in
interpret mode), with the same frontier taken. Inside the port every
frontier result is bitwise a fresh full compile (single program) or a
cache-less session on the same plan (``mesh-bsp``), batched == serial, and
the row-subset launches' plain versions are the full launches' rows. The
port runs on the CPU (``device="cpu"``).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.api import Engine as JEngine
from repro.api import GraphDelta as JDelta
from repro.core import frontier as jfr
from repro.gnn import models as jmodels
from repro.gnn.graph import from_edge_list as jfrom_edge_list
from repro_torch.api import Engine, GraphDelta
from repro_torch.api.registry import EXECUTORS
from repro_torch.core import frontier as tfr
from repro_torch.gnn import models as tmodels
from repro_torch.gnn.graph import from_edge_list
from repro_torch.kernels import daq_dequant as dq
from repro_torch.kernels import gather_aggregate as ga
from repro_torch.kernels import ref
from repro_torch.runtime import bsp

from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-4, 1e-5
CLUSTER = "1A+2B+1C"


# ----------------------------------------------------------------------------
# core.frontier: the reference's oracles, both packages, ==
# ----------------------------------------------------------------------------

def _graphs(v, edge_pairs):
    pairs = np.array(edge_pairs, np.int64).reshape(-1, 2)
    feats = np.zeros((v, 2), np.float32)
    return (jfrom_edge_list(v, pairs, feats), from_edge_list(v, pairs, feats))


def _expand(mod, graph, seeds, layers, extra):
    extra = (np.empty((0, 2), np.int64) if extra is None
             else np.asarray(extra, np.int64))
    return [set(r.tolist()) for r in mod.expand_frontier(
        graph, np.asarray(seeds, np.int64), extra, layers)]


#: (name, vertices, edges, seeds, layers, extra edges, expected balls)
ORACLES = [
    ("path", 6, [(i, i + 1) for i in range(5)], [2], 2, None,
     [{1, 2, 3}, {0, 1, 2, 3, 4}]),
    ("star", 6, [(0, i) for i in range(1, 6)], [1], 2, None,
     [{0, 1}, {0, 1, 2, 3, 4, 5}]),
    ("star-hub", 6, [(0, i) for i in range(1, 6)], [0], 1, None,
     [{0, 1, 2, 3, 4, 5}]),
    ("disconnected", 6, [(0, 1), (1, 2), (2, 0), (3, 4), (4, 5), (5, 3)],
     [0], 3, None, [{0, 1, 2}] * 3),
    ("self-loop", 3, [(0, 0), (0, 1), (1, 2)], [0], 2, None,
     [{0, 1}, {0, 1, 2}]),
    ("extra-edges", 4, [(0, 1), (2, 3)], [1], 2, [(1, 2), (2, 1)],
     [{0, 1, 2}, {0, 1, 2, 3}]),
]


@pytest.mark.parametrize("case", ORACLES, ids=[c[0] for c in ORACLES])
def test_expand_frontier_oracles_equal_reference(case):
    _, v, edges, seeds, layers, extra, want = case
    jg, tg = _graphs(v, edges)
    got = _expand(tfr, tg, seeds, layers, extra)
    assert got == want
    assert got == _expand(jfr, jg, seeds, layers, extra)


def _fold_both(v, edges, jdeltas, tdeltas):
    jg, tg = _graphs(v, edges)
    return (jfr.fold_delta_frontier(jg, jdeltas),
            tfr.fold_delta_frontier(tg, tdeltas))


def _assert_fold_equal(jfu, tfu):
    for name in ("vmap", "seeds", "extra_edges"):
        assert np.array_equal(getattr(tfu, name), getattr(jfu, name)), name
    assert tfu.removed_vertices == jfu.removed_vertices
    assert tfu.structural == jfu.structural
    for name in ("senders", "receivers", "features"):
        assert np.array_equal(getattr(tfu.graph, name),
                              getattr(jfu.graph, name)), name


def test_removed_edge_dirties_both_former_endpoints():
    kw = dict(remove_edges=[(1, 2), (2, 1)])
    jfu, tfu = _fold_both(4, [(0, 1), (1, 2), (2, 3)], [JDelta(**kw)],
                          [GraphDelta(**kw)])
    _assert_fold_equal(jfu, tfu)
    assert set(tfu.seeds.tolist()) == {1, 2}
    assert tfu.structural and not tfu.removed_vertices
    rows = [set(r.tolist()) for r in tfr.expand_frontier(
        tfu.graph, tfu.seeds, tfu.extra_edges, 2)]
    assert rows == [{0, 1, 2, 3}, {0, 1, 2, 3}]


def test_removed_vertex_dirties_former_neighbors():
    jfu, tfu = _fold_both(4, [(0, 1), (0, 2), (0, 3)],
                          [JDelta(remove_vertices=[0])],
                          [GraphDelta(remove_vertices=[0])])
    _assert_fold_equal(jfu, tfu)
    assert tfu.removed_vertices and tfu.structural
    assert set(tfu.seeds.tolist()) == {0, 1, 2}


def test_fold_composes_vertex_maps_across_deltas():
    ones = np.ones((1, 2), np.float32)
    jfu, tfu = _fold_both(
        5, [(i, i + 1) for i in range(4)],
        [JDelta(feature_ids=[4], feature_values=ones),
         JDelta(remove_vertices=[0])],
        [GraphDelta(feature_ids=[4], feature_values=ones),
         GraphDelta(remove_vertices=[0])])
    _assert_fold_equal(jfu, tfu)
    assert {0, 3} <= set(tfu.seeds.tolist())
    assert tfu.vmap[0] == -1 and tfu.vmap[4] == 3


def _random_graph(rng):
    """Sparse connected graph (the reference fuzzer's generator): random
    spanning tree + a few chords, F = 4."""
    v = int(rng.integers(24, 72))
    parents = [int(rng.integers(0, i)) for i in range(1, v)]
    edges = [(i, p) for i, p in enumerate(parents, start=1)]
    for _ in range(int(rng.integers(0, v // 3))):
        a, b = (int(x) for x in rng.integers(0, v, size=2))
        if a != b:
            edges.append((a, b))
    feats = rng.normal(size=(v, 4)).astype(np.float32)
    pairs = np.array(edges, np.int64)
    return jfrom_edge_list(v, pairs, feats), from_edge_list(v, pairs, feats)


def _random_delta_kw(g, rng):
    """Keyword arrays of a random delta (the reference fuzzer's mix:
    vertex and edge churn, feature upserts, ~10 % empty)."""
    v, f = g.num_vertices, g.feature_dim
    if rng.random() < 0.1:
        return {}
    kw = {}
    removed = np.empty(0, np.int64)
    if rng.random() < 0.25:
        removed = rng.choice(v, size=int(rng.integers(1, 3)), replace=False)
        kw["remove_vertices"] = removed
    if rng.random() < 0.55:
        pool = np.setdiff1d(np.arange(v), removed)
        k = min(int(rng.integers(1, max(2, v // 8))), len(pool))
        if k:
            kw["feature_ids"] = rng.choice(pool, size=k, replace=False)
            kw["feature_values"] = rng.normal(size=(k, f)).astype(
                np.float32)
    if rng.random() < 0.4:
        n_new = int(rng.integers(1, 3))
        kw["add_features"] = rng.normal(size=(n_new, f)).astype(np.float32)
        kw["add_edges"] = [(v + i, int(t)) for i, t in
                           enumerate(rng.choice(v, size=n_new))]
    if rng.random() < 0.4:
        a, b = (int(x) for x in rng.integers(0, v, size=2))
        if a != b:
            kw["add_edges"] = list(kw.get("add_edges", [])) + [(a, b),
                                                               (b, a)]
    if rng.random() < 0.3 and g.num_edges:
        e = int(rng.integers(0, g.num_edges))
        s, r = int(g.senders[e]), int(g.receivers[e])
        kw["remove_edges"] = [(s, r), (r, s)]
    return kw


@pytest.mark.parametrize("seed", range(6))
def test_activation_cache_bookkeeping_equals_reference(seed):
    """A seeded delta stream through both packages' ``ActivationCache``:
    the folded update, the remapped tables, the pending seeds and extras,
    ``pallas_ok``, the dirty rows per layer and the budget decision of
    each query are ``==``."""
    rng = np.random.default_rng(seed)
    jg, tg = _random_graph(rng)
    layers = [rng.normal(size=(jg.num_vertices, d)).astype(np.float32)
              for d in (8, 4)]
    fraction = (0.1, 0.25, 1.0)[seed % 3]
    jc, tc = jfr.ActivationCache(fraction), tfr.ActivationCache(fraction)
    for c in (jc, tc):
        c.populate(jg.features, layers, "r0", "segment_sum", "single")
    for step in range(3):
        batch, cur = [], jg
        for _ in range(int(rng.integers(1, 3))):
            # Each delta addresses the graph the previous one left.
            batch.append(_random_delta_kw(cur, rng))
            cur = jfr.fold_delta_frontier(cur, [JDelta(**batch[-1])]).graph
        jfu = jfr.fold_delta_frontier(jg, [JDelta(**kw) for kw in batch])
        tfu = tfr.fold_delta_frontier(tg, [GraphDelta(**kw)
                                           for kw in batch])
        _assert_fold_equal(jfu, tfu)
        jc.apply_update(jfu, revision=f"r{step + 1}")
        tc.apply_update(tfu, revision=f"r{step + 1}")
        jg, tg = jfu.graph, tfu.graph
        for name in ("h0", "seeds", "extra_edges"):
            assert np.array_equal(getattr(tc, name), getattr(jc, name))
        for a, b in zip(tc.layers, jc.layers):
            assert np.array_equal(a, b)
        assert tc.pallas_ok == jc.pallas_ok
        feats = np.array(jg.features, copy=True)
        feats[rng.integers(0, jg.num_vertices)] += 1.0
        jq = jc.plan_query(feats, jg, 2)
        tq = tc.plan_query(feats, tg, 2)
        assert (tq is None) == (jq is None)
        if tq is not None:
            assert np.array_equal(tq.seeds, jq.seeds)
            assert len(tq.rows) == len(jq.rows)
            for a, b in zip(tq.rows, jq.rows):
                assert np.array_equal(a, b)
            assert tq.fraction == jq.fraction
        jp = jc.frontier_plan(jg, 2)
        tp = tc.frontier_plan(tg, 2)
        for a, b in zip(tp.rows, jp.rows):
            assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="frontier_max_fraction"):
        tfr.ActivationCache(0.0)


# ----------------------------------------------------------------------------
# sessions: the port's frontier queries against the JAX package's
# ----------------------------------------------------------------------------

def _params(kind, feature_dim, seed=0):
    jparams = jmodels.gnn_init(jax.random.PRNGKey(seed), kind,
                               [feature_dim, 8, 4])
    nparams = [{k: np.asarray(v) for k, v in p.items()} for p in jparams]
    return jparams, tmodels.params_from_numpy(nparams)


@pytest.mark.parametrize("aggregation", ["segment_sum", "pallas"])
@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_frontier_session_matches_jax(kind, aggregation):
    """The same feature stream (a few sensors change per query) and one
    feature upsert through a cached JAX session and a cached port session:
    the same queries take the frontier path with the same dirty rows and
    the embeddings agree at the reference's bar."""
    rng = np.random.default_rng(11)
    jg, tg = _random_graph(rng)
    jparams, tparams = _params(kind, jg.feature_dim)
    knobs = dict(cluster=CLUSTER, executor="sim", aggregation=aggregation,
                 compressor="none")
    jsess = JEngine((jparams, kind), **knobs).compile(jg).session(
        activation_cache=True, frontier_max_fraction=0.6)
    tsess = Engine((tparams, kind), device="cpu", **knobs).compile(
        tg).session(activation_cache=True, frontier_max_fraction=0.6)
    feats = np.array(jg.features, copy=True)
    taken = 0
    for q in range(4):
        if q == 2:
            kw = dict(feature_ids=[3], feature_values=np.full(
                (1, jg.feature_dim), 0.5, np.float32))
            jsess.update(JDelta(**kw))
            tsess.update(GraphDelta(**kw))
            feats = np.array(jsess.plan.graph.features, copy=True)
        elif q:
            feats = feats.copy()
            feats[rng.integers(0, len(feats), 2)] += 1.0
        want = np.asarray(jsess.query(feats).embeddings)
        got = tsess.query(feats).embeddings
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        jf, tf = jsess.last_frontier, tsess.last_frontier
        assert (tf is None) == (jf is None), q
        if tf is not None:
            taken += 1
            for a, b in zip(tf.rows, jf.rows):
                assert np.array_equal(a, b)
    assert taken >= 2


# ----------------------------------------------------------------------------
# the port's own contracts, bitwise
# ----------------------------------------------------------------------------

def _fresh(tparams, kind, executor, aggregation, g, feats):
    eng = Engine((tparams, kind), cluster=CLUSTER, executor=executor,
                 aggregation=aggregation, device="cpu")
    return eng.compile(g).session().query(feats).embeddings


COMBOS = [(e, a, k) for e in ("sim", "cloud")
          for a in ("segment_sum", "pallas") for k in ("gcn", "sage")]


@pytest.mark.parametrize("executor,aggregation,kind", COMBOS)
def test_frontier_fuzz_is_fresh_compile_bitwise(executor, aggregation, kind):
    """Random delta streams (the reference fuzzer's), then a query whose
    features change in one row: every query of a cached session is
    bitwise a fresh compile of the mutated graph, and the frontier path
    fires (a structural delta disarms the kernel path until the next full
    pass, so there it fires on the closing queries)."""
    base = COMBOS.index((executor, aggregation, kind)) * 100
    hits = 0
    for case in range(3):
        rng = np.random.default_rng(base + case)
        _, tg = _random_graph(rng)
        _, tparams = _params(kind, tg.feature_dim, seed=case)
        sess = Engine((tparams, kind), cluster=CLUSTER, executor=executor,
                      aggregation=aggregation, device="cpu").compile(
                          tg).session(activation_cache=True,
                                      frontier_max_fraction=1.0)
        sess.query()
        for _ in range(3):
            sess.update(GraphDelta(**_random_delta_kw(sess.plan.graph,
                                                      rng)))
            g2 = sess.plan.graph
            feats = None
            if rng.random() < 0.5:
                feats = np.array(g2.features, copy=True)
                feats[rng.integers(0, g2.num_vertices)] += 1.0
            got = sess.query(feats).embeddings
            want = _fresh(tparams, kind, executor, aggregation, g2, feats)
            assert np.array_equal(got, want)
            hits += sess.last_frontier is not None
        g2 = sess.plan.graph
        feats = np.array(g2.features, copy=True)
        feats[rng.integers(0, g2.num_vertices)] -= 1.0
        got = sess.query(feats).embeddings
        assert np.array_equal(got, _fresh(tparams, kind, executor,
                                          aggregation, g2, feats))
        hits += sess.last_frontier is not None
    assert hits >= 3


@pytest.mark.parametrize("aggregation", ["segment_sum", "pallas"])
def test_frontier_batch_is_serial_bitwise(aggregation):
    """One stacked frontier pass for a micro-batch: every member bitwise
    its serial full execute, and the last member's tables become the
    cache."""
    rng = np.random.default_rng(5)
    _, tg = _random_graph(rng)
    _, tparams = _params("gcn", tg.feature_dim)
    plan = Engine((tparams, "gcn"), cluster=CLUSTER, executor="sim",
                  aggregation=aggregation, device="cpu").compile(tg)
    sess = plan.session(activation_cache=True, frontier_max_fraction=1.0)
    full = plan.session()
    sess.execute(tg.features)
    stack = np.stack([tg.features] * 3)
    for b in range(3):
        stack[b, b] += 1.0
    many = sess.execute_many(stack)
    assert sess.last_frontier is not None
    for b in range(3):
        assert np.array_equal(many[b], full.execute(stack[b]))
    again = sess.execute(stack[-1])
    assert sess.last_frontier is None   # nothing changed: cached rows
    assert np.array_equal(again, many[-1])


def test_gat_falls_back_and_stays_exact():
    rng = np.random.default_rng(9)
    _, tg = _random_graph(rng)
    _, tparams = _params("gat", tg.feature_dim)
    plan = Engine((tparams, "gat"), cluster=CLUSTER, executor="sim",
                  aggregation="segment_sum", device="cpu").compile(tg)
    sess = plan.session(activation_cache=True, frontier_max_fraction=1.0)
    feats = np.array(tg.features, copy=True)
    for _ in range(3):
        got = sess.execute(feats)
        assert sess.last_frontier is None
        assert np.array_equal(got, plan.session().execute(feats))
        feats = feats.copy()
        feats[rng.integers(0, len(feats))] += 1.0


def test_structural_delta_disarms_the_kernel_path():
    """After a structural delta the kernel path serves a full capturing
    pass (``pallas_ok``); a feature-only stream re-arms it."""
    rng = np.random.default_rng(4)
    _, tg = _random_graph(rng)
    _, tparams = _params("gcn", tg.feature_dim)
    sess = Engine((tparams, "gcn"), cluster=CLUSTER, executor="sim",
                  aggregation="pallas", device="cpu").compile(tg).session(
                      activation_cache=True, frontier_max_fraction=1.0)
    ones = np.ones((1, tg.feature_dim), np.float32)
    sess.query()
    sess.update(GraphDelta(add_edges=[(0, 5), (5, 0)]))
    assert not sess._acache.pallas_ok
    sess.query()
    assert sess.last_frontier is None
    sess.update(GraphDelta(feature_ids=[7], feature_values=ones))
    got = sess.query().embeddings
    assert sess.last_frontier is not None
    assert np.array_equal(got, _fresh(tparams, "gcn", "sim", "pallas",
                                      sess.plan.graph, None))


def test_budget_overflow_runs_a_full_pass():
    rng = np.random.default_rng(8)
    _, tg = _random_graph(rng)
    _, tparams = _params("sage", tg.feature_dim)
    sess = Engine((tparams, "sage"), cluster=CLUSTER, executor="sim",
                  aggregation="segment_sum", device="cpu").compile(
                      tg).session(activation_cache=True,
                                  frontier_max_fraction=0.01)
    sess.query()
    feats = np.array(tg.features, copy=True)
    feats[0] += 1.0
    got = sess.query(feats).embeddings
    assert sess.last_frontier is None
    assert np.array_equal(got, _fresh(tparams, "sage", "sim", "segment_sum",
                                      tg, feats))
    assert sess.frontier_state() is not None


def test_deferred_session_does_not_serve_stale_cache_across_flush():
    rng = np.random.default_rng(3)
    v = 48
    g = from_edge_list(v, np.array([(i, i + 1) for i in range(v - 1)],
                                   np.int64),
                       rng.normal(size=(v, 4)).astype(np.float32))
    _, tparams = _params("gcn", 4, seed=3)
    sess = Engine((tparams, "gcn"), cluster=CLUSTER, executor="sim",
                  aggregation="segment_sum", device="cpu").compile(
                      g).session(activation_cache=True,
                                 frontier_max_fraction=1.0,
                                 updates="deferred")
    before = sess.query().embeddings
    sess.update(GraphDelta(add_edges=[(0, 20), (20, 0)], feature_ids=[5],
                           feature_values=np.full((1, 4), 2.0, np.float32)))
    assert np.array_equal(sess.query().embeddings, before)
    sess.flush_updates()
    after = sess.query().embeddings
    want = _fresh(tparams, "gcn", "sim", "segment_sum", sess.plan.graph,
                  None)
    assert np.array_equal(after, want)
    assert not np.array_equal(after, before)


def test_staleness_and_cache_are_exclusive():
    rng = np.random.default_rng(1)
    _, tg = _random_graph(rng)
    _, tparams = _params("gcn", tg.feature_dim)
    plan = Engine((tparams, "gcn"), cluster=CLUSTER, device="cpu",
                  exchange="halo_async", staleness_bound=1).compile(tg)
    with pytest.raises(ValueError, match="mutually exclusive"):
        plan.session(activation_cache=True)


# ----------------------------------------------------------------------------
# mesh-bsp: capture and frontier inside the port
# ----------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ring(v=300):
    rng = np.random.default_rng(0)
    edges = np.array([(i, (i + 1) % v) for i in range(v)]
                     + [(i, (i + 37) % v) for i in range(0, v, 5)], np.int64)
    return from_edge_list(v, edges,
                          rng.normal(size=(v, 6)).astype(np.float32))


MESH = [("gcn", "pallas", "daq"), ("sage", "pallas", "none"),
        ("gcn", "segment_sum", "none"), ("sage", "segment_sum", "daq")]


@pytest.mark.parametrize("kind,aggregation,compressor", MESH,
                         ids=["-".join(c) for c in MESH])
def test_mesh_frontier_is_cacheless_session_bitwise(kind, aggregation,
                                                    compressor):
    """A cached mesh session against a cache-less one on the same plan
    chain (mesh numerics depend on the layout): feature changes, a
    feature upsert and a structural delta, single queries and a stacked
    batch, all bitwise; the frontier path fires on both aggregations."""
    g = _ring()
    _, tparams = _params(kind, g.feature_dim)
    eng = Engine((tparams, kind), cluster="4B", executor="mesh-bsp",
                 aggregation=aggregation, compressor=compressor,
                 device="cpu")
    inc = eng.compile(g).session(activation_cache=True,
                                 frontier_max_fraction=1.0)
    ref_s = eng.compile(g).session()
    assert np.array_equal(inc.query().embeddings, ref_s.query().embeddings)
    ones = np.ones((1, g.feature_dim), np.float32)
    deltas = [GraphDelta(feature_ids=[7], feature_values=ones),
              GraphDelta(add_edges=[(0, 150), (150, 0)]),
              GraphDelta(feature_ids=[40], feature_values=-ones)]
    hits = 0
    for d in deltas:
        inc.update(d)
        ref_s.update(d)
        assert np.array_equal(inc.query().embeddings,
                              ref_s.query().embeddings)
        hits += inc.last_frontier is not None
    assert hits >= 2
    feats = inc.collect()
    stack = np.stack([feats] * 3)
    for b in range(3):
        stack[b, 11 * b + 3] += 1.0
    many = inc.execute_many(stack)
    assert inc.last_frontier is not None
    for b in range(3):
        assert np.array_equal(many[b], ref_s.execute(stack[b]))


@pytest.mark.parametrize("aggregation", ["pallas", "segment_sum"])
def test_mesh_capture_last_layer_is_the_plain_run(aggregation):
    g = _ring()
    _, tparams = _params("sage", g.feature_dim)
    plan = Engine((tparams, "sage"), cluster="4B", executor="mesh-bsp",
                  aggregation=aggregation, compressor="daq",
                  device="cpu").compile(g)
    backend = EXECUTORS.resolve("mesh-bsp")
    sess = plan.session()
    pg = sess.partitioned()
    feats = sess.collect()
    layers = backend.run_layers(plan, feats, plan.placement.assignment, pg,
                                "halo", aggregation=aggregation)
    assert [a.shape for a in layers] == [(g.num_vertices, 8),
                                         (g.num_vertices, 4)]
    assert np.array_equal(layers[-1], sess.execute(feats))
    stack = np.stack([feats, feats * 0.5])
    many = backend.run_layers(plan, stack, plan.placement.assignment, pg,
                              "halo", aggregation=aggregation)
    for b in range(2):
        assert np.array_equal(many[-1][b], sess.execute(stack[b]))


def test_mesh_frontier_rejects_gat():
    g = _ring()
    _, tparams = _params("gat", g.feature_dim)
    plan = Engine((tparams, "gat"), cluster="4B", executor="mesh-bsp",
                  aggregation="segment_sum", device="cpu").compile(g)
    with pytest.raises(ValueError, match="frontier"):
        bsp.bsp_infer_frontier(list(plan.model.params), "gat", g.features,
                               plan.partitioned, [[0], [0]],
                               [np.zeros((g.num_vertices, 8), np.float32),
                                np.zeros((g.num_vertices, 4), np.float32)],
                               device="cpu")


# ----------------------------------------------------------------------------
# the row-subset launches' plain versions
# ----------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _operand(vb=5, src_blocks=6, seed=0):
    rng = np.random.default_rng(seed)
    e = 3000
    s = rng.integers(0, src_blocks * 128, e)
    r = rng.integers(0, vb * 128, e)
    r[:600] = 130                          # one split row (> 512 entries)
    blocks, cols, mask, _ = ga.build_block_csr(s, r, vb * 128)
    ts = [torch.as_tensor(a) for a in (blocks, cols, mask)]
    return ts, ga.compact_block_csr(*ts)


@pytest.mark.parametrize("sel", [[0], [1, 3], [4, 2, 0], []],
                         ids=["one", "two", "unsorted", "none"])
def test_row_subset_lists_its_blocks_rows_in_launch_order(sel):
    (blocks, cols, mask), rows = _operand()
    sub = ga.row_subset(rows, sel)
    assert sub.blocks.tolist() == sorted(sel)
    keep = set(sel)
    want_w = [r for r in rows.warp_rows.tolist() if r[0] // 128 in keep]
    want_s = [r for r in rows.split.tolist() if r // 128 in keep]
    assert sub.warp_rows.tolist() == want_w
    assert sub.split.tolist() == want_s
    listed = {r[0] for r in want_w} | set(want_s)
    assert listed == {b * 128 + i for b in keep for i in range(128)}
    assert sub.row_mask().nonzero().squeeze(1).tolist() == sorted(listed)


def test_row_subset_checks_its_blocks():
    _, rows = _operand()
    with pytest.raises(ValueError, match="unique"):
        ga.row_subset(rows, [1, 1])
    with pytest.raises(ValueError, match=r"\[0, 5\)"):
        ga.row_subset(rows, [5])
    with pytest.raises(ValueError, match=r"\[0, 5\)"):
        ga.row_subset(rows, [-1])


@pytest.mark.parametrize("batched", [False, True], ids=["one", "batch"])
@pytest.mark.parametrize("op", ["block_spmm", "dequant_spmm"])
def test_subset_plain_version_is_the_full_rows(op, batched):
    """On the CPU a subset launch gives the full product's rows of its
    blocks, bitwise, and zeros elsewhere; the ``ref`` row slices say the
    same."""
    (blocks, cols, mask), rows = _operand()
    gen = torch.Generator().manual_seed(1)
    lead = (2,) if batched else ()
    sub = ga.row_subset(rows, [1, 4])
    keep = sub.row_mask()
    if op == "block_spmm":
        h = torch.randn(lead + (6 * 128, 7), generator=gen)
        fn = ga.block_spmm_batched if batched else ga.block_spmm
        full = fn(blocks, cols, mask, h, rows=rows)
        part = fn(blocks, cols, mask, h, rows=sub)
        refn = (ref.block_spmm_batched_subset_ref if batched
                else ref.block_spmm_subset_ref)
        again = refn(blocks, cols, mask, h, sub.blocks)
    else:
        codes = torch.randint(0, 256, lead + (6 * 128, 7), generator=gen,
                              dtype=torch.uint8)
        sc = torch.rand(lead + (6 * 128,), generator=gen)
        mn = torch.randn(lead + (6 * 128,), generator=gen)
        fn = dq.dequant_spmm_batched if batched else dq.dequant_spmm
        full = fn(blocks, cols, mask, codes, sc, mn, rows=rows)
        part = fn(blocks, cols, mask, codes, sc, mn, rows=sub)
        refn = (ref.dequant_spmm_batched_subset_ref if batched
                else ref.dequant_spmm_subset_ref)
        again = refn(blocks, cols, mask, codes, sc, mn, sub.blocks)
    assert torch.equal(part[..., keep, :], full[..., keep, :])
    assert not part[..., ~keep, :].any()
    assert torch.equal(again, part)
