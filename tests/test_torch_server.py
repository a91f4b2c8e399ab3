"""The port's request-level serving == the JAX package's.

The same traces (``repro_torch.api.traces`` is held byte-identical to
``repro.api.traces`` for the same seed) go through the reference's
``Server`` and the port's: every ``Response`` timing and count field is
exactly equal, every ``UpdateResponse`` and ``Rejection`` is equal, and
``summarize`` is equal; embeddings match within rtol 1e-4 / atol 1e-5 (the
bar of tests/test_aggregation.py). With the SLO control plane the priority
order, rejections and ladder rungs are the reference's. Inside the port,
every response is bitwise its serial ``Session.query``, on ``mesh-bsp``
too. The port runs on the CPU (``device="cpu"``); the JAX kernel path runs
its Pallas kernels in interpret mode.
"""
import builtins
import dataclasses
import functools
import json
import warnings

import jax
import numpy as np
import pytest

from repro.api import Engine as JEngine
from repro.api import GraphDelta as JDelta
from repro.api import Request as JRequest
from repro.api import Server as JServer
from repro.api import UpdateRequest as JUpdateRequest
from repro.api import slo as jslo
from repro.api import traces as jtraces
from repro.gnn import datasets as jdata
from repro.gnn import models as jmodels
from repro_torch.api import (Engine, GraphDelta, Request, Response, Server,
                             UpdateRequest, UpdateResponse, slo, traces)
from repro_torch.api.slo import (AdaptiveBatchController, Rejection,
                                 SLOPolicy)
from repro_torch.gnn import datasets as tdata
from repro_torch.gnn import models as tmodels

from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-4, 1e-5

#: Response fields held exactly (everything but the embeddings).
TIMING = ("latency", "throughput", "breakdown", "wire_bytes",
          "exchange_bytes", "backend", "accuracy", "request_id",
          "arrival_time", "queue_delay", "service_start", "finish_time",
          "batch_size", "batch_index", "collect_time", "execute_time",
          "overlap_saved", "priority", "deadline", "deadline_met",
          "degradation", "staleness", "site", "route", "routing_delay",
          "retries", "recovered", "capacity")


@functools.lru_cache(maxsize=None)
def _setup(kind="gcn"):
    g = jdata.load("siot", scale=0.05, seed=0)
    gt = tdata.load("siot", scale=0.05, seed=0)
    jparams = jmodels.gnn_init(jax.random.PRNGKey(0), kind,
                               [g.feature_dim, 16, 8])
    nparams = [{k: np.asarray(v) for k, v in p.items()} for p in jparams]
    return g, gt, jparams, tmodels.params_from_numpy(nparams)


@functools.lru_cache(maxsize=None)
def _plans(aggregation, kind="gcn", executor="sim"):
    g, gt, jparams, tparams = _setup(kind)
    knobs = dict(cluster="1A+2B+1C", executor=executor,
                 aggregation=aggregation, compressor="daq")
    return (JEngine((jparams, kind), **knobs).compile(g),
            Engine((tparams, kind), device="cpu", **knobs).compile(gt))


def _features_fn(g):
    def features_fn(i, rng):
        return g.features + rng.normal(scale=0.01, size=g.features.shape)
    return features_fn


def _delta_fn(cls, g):
    """Deltas valid against the sequentially updated graph: new vertices
    (their ids tracked across calls), edge additions and removals among
    stable low ids, and feature upserts."""
    state = {"v": g.num_vertices, "calls": 0}

    def delta_fn(i, rng):
        k = state["calls"] % 3
        state["calls"] += 1
        if k == 0:
            v = state["v"]
            state["v"] += 2
            return cls(add_features=rng.normal(size=(2, g.feature_dim)),
                       add_edges=np.stack([v + np.arange(2),
                                           rng.integers(0, 50, 2)], 1))
        if k == 1:
            ids = rng.choice(50, 4, replace=False)
            return cls(feature_ids=ids, feature_values=rng.normal(
                size=(4, g.feature_dim)))
        pairs = rng.integers(0, 50, size=(4, 2))
        return cls(add_edges=pairs[:2], remove_edges=pairs[2:])
    return delta_fn


def _trace(pkg, name, g, n=16, **kw):
    """The named trace from ``pkg`` (``traces`` of either package)."""
    if name == "poisson":
        return pkg.poisson(n, 30.0, seed=1, **kw)
    if name == "constant":
        return pkg.constant(n, 12.0, seed=2, **kw)
    if name == "bursty":
        return pkg.bursty(n, 10.0, burst=4, seed=3, **kw)
    if name == "mixed":
        cls = JDelta if pkg is jtraces else GraphDelta
        return pkg.mixed(n, 20.0, delta_fn=_delta_fn(cls, g),
                         update_fraction=0.25, seed=4, **kw)
    raise KeyError(name)


def _requests_equal(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "delta":
            for d in dataclasses.fields(x):
                p, q = getattr(x, d.name), getattr(y, d.name)
                assert (p is None) == (q is None), d.name
                if p is not None:
                    assert p.dtype == q.dtype and np.array_equal(p, q)
        elif isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


def _same_outputs(tout, jout):
    """The port's drain output equals the reference's, entry by entry."""
    assert [type(r).__name__ for r in tout] == [type(r).__name__
                                               for r in jout]
    for t, j in zip(tout, jout):
        if isinstance(t, Response):
            for f in TIMING:
                assert getattr(t, f) == getattr(j, f), f
            np.testing.assert_allclose(t.embeddings, j.embeddings,
                                       rtol=RTOL, atol=ATOL)
        elif isinstance(t, UpdateResponse):
            for f in dataclasses.fields(t):
                x, y = getattr(t, f.name), getattr(j, f.name)
                if f.name == "report":
                    assert (x is None) == (y is None)
                    if x is not None:
                        assert dataclasses.asdict(x) == dataclasses.asdict(y)
                else:
                    assert x == y, f.name
        else:
            assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert Server.summarize(tout) == JServer.summarize(jout)


def _serial_equal(plan, responses, features_of, **session_kw):
    """Inside the port: each response is bitwise its serial query."""
    for r in responses:
        if isinstance(r, Response):
            s = plan.session(**session_kw).query(features_of(r.request_id))
            assert np.array_equal(r.embeddings, s.embeddings), r.request_id


# ----------------------------------------------------------------------------
# Traces
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["poisson", "constant", "bursty", "mixed"])
def test_traces_are_byte_identical_to_the_reference(name):
    g, gt, _, _ = _setup()
    slo_fn_j = jslo.slo_classes([(0.3, 2, 0.5), (0.7, 0, None)])
    slo_fn_t = slo.slo_classes([(0.3, 2, 0.5), (0.7, 0, None)])
    for kw_j, kw_t in (({}, {}),
                       (dict(features_fn=_features_fn(g), slo_fn=slo_fn_j,
                             origin_fn=jtraces.geo_origins(
                                 [(0.0, 0.0), (1.0, 2.0)], seed=3)),
                        dict(features_fn=_features_fn(gt), slo_fn=slo_fn_t,
                             origin_fn=traces.geo_origins(
                                 [(0.0, 0.0), (1.0, 2.0)], seed=3))),
                       (dict(deadline=0.25, priority=3, executor="single"),
                        dict(deadline=0.25, priority=3, executor="single"))):
        jt, tt = _trace(jtraces, name, g, **kw_j), _trace(traces, name, gt,
                                                         **kw_t)
        assert len(jt) == len(tt)
        for a, b in zip(jt, tt):
            _requests_equal(a, b)
    if name == "mixed":
        assert any(isinstance(r, UpdateRequest) for r in tt)


def test_trace_argument_errors_match_reference():
    for call in (lambda p: p.poisson(3, 0.0),
                 lambda p: p.constant(3, -1.0),
                 lambda p: p.bursty(3, 1.0, burst=0),
                 lambda p: p.mixed(3, 1.0, delta_fn=None,
                                   update_fraction=2.0),
                 lambda p: p.geo_origins([]),
                 lambda p: p.geo_origins([(0, 0)], spread=-1.0)):
        msgs = []
        for pkg in (jtraces, traces):
            with pytest.raises(ValueError) as ei:
                call(pkg)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]


# ----------------------------------------------------------------------------
# Server against the reference's Server
# ----------------------------------------------------------------------------

SERVE = [("poisson", "segment_sum"), ("constant", "segment_sum"),
         ("bursty", "pallas"), ("mixed", "segment_sum"),
         ("mixed", "pallas")]


@pytest.mark.parametrize("name,aggregation", SERVE)
def test_server_matches_reference(name, aggregation):
    g, gt, _, _ = _setup()
    jplan, tplan = _plans(aggregation)
    kw = dict(max_batch=4, max_wait=0.02)
    # Fresh uploads per request, except on the mixed trace, whose updates
    # add vertices (an upload is a whole [V, F] table).
    fresh = name != "mixed"
    jout = jplan.server(**kw).replay(_trace(
        jtraces, name, g, features_fn=_features_fn(g) if fresh else None))
    tsrv = tplan.server(**kw)
    trace = _trace(traces, name, gt,
                   features_fn=_features_fn(gt) if fresh else None)
    tout = tsrv.replay(trace)
    _same_outputs(tout, jout)
    assert max(r.batch_size for r in tout if isinstance(r, Response)) > 1
    if fresh:
        feats = {k: r.features for k, r in enumerate(trace)}
        _serial_equal(tplan, tout, feats.get)
    else:
        assert any(isinstance(r, UpdateResponse) and r.report.mode
                   == "incremental" for r in tout)
        assert tsrv.session.plan.graph.num_vertices > gt.num_vertices


@pytest.mark.parametrize("executor", ["single", "cloud"])
def test_server_other_executors_match_reference(executor):
    g, gt, _, _ = _setup()
    jplan, tplan = _plans("segment_sum", executor=executor)
    jout = jplan.server(max_batch=3).replay(jtraces.poisson(9, 40.0, seed=5))
    tout = tplan.server(max_batch=3).replay(traces.poisson(9, 40.0, seed=5))
    _same_outputs(tout, jout)


def test_closed_loop_submit_drain_and_replay_count_match_reference():
    g, gt, _, _ = _setup()
    jplan, tplan = _plans("segment_sum")
    js, ts = jplan.server(max_batch=2), tplan.server(max_batch=2)
    for srv, pkg_delta in ((js, JDelta), (ts, GraphDelta)):
        srv.submit(None)
        srv.submit(None, arrival_time=0.05, priority=1)
        srv.submit(pkg_delta(add_edges=[[0, 9]]))
        srv.submit(None, deadline=10.0)
    _same_outputs(ts.drain(), js.drain())
    _same_outputs(ts.replay(3), js.replay(3))
    assert ts.num_batches == js.num_batches
    assert repr(ts) == repr(js)
    with pytest.raises(TypeError, match="GraphDelta"):
        ts.submit(UpdateRequest(delta="oops"))
    with pytest.raises(ValueError, match="max_batch"):
        tplan.server(max_batch=0)


def test_deferred_updates_coalesce_like_the_reference():
    g, gt, _, _ = _setup()
    jplan, tplan = _plans("pallas")
    outs = []
    for plan, pkg in ((jplan, jtraces), (tplan, traces)):
        srv = plan.server(max_batch=4, updates="deferred")
        gg = plan.graph
        outs.append((srv, srv.replay(_trace(pkg, "mixed", gg, n=12))))
    (js, jout), (ts, tout) = outs
    _same_outputs(tout, jout)
    assert ts.last_update_report.num_deltas > 1
    assert (dataclasses.asdict(ts.last_update_report)
            == dataclasses.asdict(js.last_update_report))


def test_poisoned_update_is_consumed_like_the_reference():
    g, gt, _, _ = _setup()
    _, tplan = _plans("segment_sum")
    srv = tplan.server(max_batch=1)
    srv.submit(None, arrival_time=0.1)
    srv.submit(UpdateRequest(delta=GraphDelta(remove_vertices=[10 ** 6]),
                             arrival_time=0.2))
    srv.submit(None, arrival_time=0.3)
    with pytest.raises(ValueError, match="remove_vertices") as ei:
        srv.drain()
    assert [type(r).__name__ for r in ei.value.partial_responses] == [
        "Response"]
    assert [type(r).__name__ for r in srv.drain()] == ["Response"]


# ----------------------------------------------------------------------------
# The SLO control plane
# ----------------------------------------------------------------------------

def _svc(plan, **knobs):
    return plan.session(**knobs).account().total_latency


def test_default_ladder_matches_reference():
    jplan, tplan = _plans("pallas")
    for knobs in ({}, dict(aggregation="segment_sum"),
                  dict(compressor="none")):
        jl = jslo.default_ladder(jplan.session(**knobs))
        tl = slo.default_ladder(tplan.session(**knobs))
        assert [dataclasses.asdict(r) for r in tl] == [
            dataclasses.asdict(r) for r in jl]
    assert slo.default_ladder(tplan.session())[0].name == "segment_sum"
    # "auto" resolves on the plan's device: on the CPU it is segment_sum,
    # so that ladder has no segment-sum rung (as the reference's off-TPU).
    _, auto = _plans("auto")
    assert [r.name for r in slo.default_ladder(auto.session())] == [
        "uniform8", "layers1"]


@pytest.mark.parametrize("trace_name", ["poisson", "mixed"])
def test_slo_server_matches_reference(trace_name):
    """Overload with two service classes: priority order, rejections and
    rungs are the reference's, and updates are priced on the clock."""
    g, gt, _, _ = _setup()
    jplan, tplan = _plans("pallas")
    s0 = _svc(tplan)
    classes = [(0.4, 2, 1.5 * s0), (0.6, 0, 3.0 * s0)]
    outs = []
    for plan, pkg, sl, gg in ((jplan, jtraces, jslo, g),
                              (tplan, traces, slo, gt)):
        kw = dict(slo_fn=sl.slo_classes(classes))
        if trace_name == "mixed":
            trace = pkg.mixed(20, 3.0 / s0, update_fraction=0.15, seed=6,
                              delta_fn=_delta_fn(
                                  JDelta if pkg is jtraces else GraphDelta,
                                  gg), **kw)
        else:
            trace = pkg.poisson(20, 3.0 / s0, seed=6, **kw)
        policy = sl.SLOPolicy(update_deadline=1.0)
        outs.append(plan.server(max_batch=4, slo=policy).replay(trace))
    jout, tout = outs
    _same_outputs(tout, jout)
    resp = [r for r in tout if isinstance(r, Response)]
    assert any(r.degradation > 0 for r in resp)
    assert any(isinstance(r, Rejection) for r in tout)
    if trace_name == "mixed":
        assert any(isinstance(r, UpdateResponse) and r.service_time > 0
                   for r in tout)


def test_degraded_responses_are_configured_sessions_bitwise():
    g, gt, _, _ = _setup()
    _, tplan = _plans("pallas")
    srv = tplan.server(max_batch=4, slo=SLOPolicy(reject_hopeless=False))
    s0 = _svc(tplan)
    trace = traces.poisson(12, 3.0 / s0, seed=8, deadline=1.2 * s0,
                           features_fn=_features_fn(gt))
    out = srv.replay(trace)
    assert {r.degradation for r in out} > {0}
    assert all(isinstance(r, Response) for r in out)
    for r in out:
        knobs = ({} if r.degradation == 0
                 else srv.ladder[r.degradation - 1].knobs())
        direct = tplan.session(**knobs).query(trace[r.request_id].features)
        assert np.array_equal(r.embeddings, direct.embeddings)
        if r.degradation:
            assert knobs["aggregation"] == "segment_sum"


def test_priority_never_crosses_an_update_like_the_reference():
    g, gt, _, _ = _setup()
    jplan, tplan = _plans("segment_sum")
    outs = []
    for plan, delta_cls, Req, UReq, gg in (
            (jplan, JDelta, JRequest, JUpdateRequest, g),
            (tplan, GraphDelta, Request, UpdateRequest, gt)):
        srv = plan.server(max_batch=1, slo=True)
        delta = delta_cls(feature_ids=[0],
                          feature_values=gg.features[:1] * 2.0)
        srv.submit(Req(arrival_time=0.0, priority=0))
        srv.submit(Req(arrival_time=0.0, priority=9))
        srv.submit(UReq(delta=delta, arrival_time=0.5))
        srv.submit(Req(arrival_time=0.6, priority=0))
        srv.submit(Req(arrival_time=0.6, priority=9))
        outs.append(srv.drain())
    _same_outputs(outs[1], outs[0])
    assert [r.priority for r in outs[1] if isinstance(r, Response)] == [
        9, 0, 9, 0]


def test_adaptive_batch_matches_the_unseeded_reference(monkeypatch):
    g, gt, _, _ = _setup()
    jplan, tplan = _plans("segment_sum")
    jctl = jslo.AdaptiveBatchController(max_batch=6, seed_curve=None)
    jout = jplan.server(max_batch=6, adaptive_batch=jctl).replay(
        jtraces.bursty(18, 20.0, burst=6, seed=2))
    # adaptive_batch=True reads no file: any open of a BENCH_* file fails.
    real_open = builtins.open

    def guarded_open(file, *args, **kwargs):
        if "BENCH" in str(file):
            raise AssertionError(f"opened {file}")
        return real_open(file, *args, **kwargs)
    monkeypatch.setattr(builtins, "open", guarded_open)
    tsrv = tplan.server(max_batch=6, adaptive_batch=True)
    assert tsrv.batch_controller._seed == {}
    tout = tsrv.replay(traces.bursty(18, 20.0, burst=6, seed=2))
    _same_outputs(tout, jout)
    assert tsrv.batch_controller._obs == jctl._obs


def test_load_bench_curve_reads_only_the_named_file(tmp_path):
    with pytest.raises(TypeError):
        slo.load_bench_curve()
    path = tmp_path / "sweep.json"
    rows = [{"executor": "sim", "aggregation": a, "batch": b,
             "batched_s": s * b} for a, s in (("segment_sum", 0.001),
                                              ("pallas", 0.002))
            for b in (1, 2, 4)]
    path.write_text(json.dumps({"rows": rows}))
    for kw in (dict(), dict(aggregation="pallas"),
               dict(executor="mesh-bsp", aggregation="bogus")):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            assert (slo.load_bench_curve(str(path), **kw)
                    == jslo.load_bench_curve(str(path), **kw))
    assert slo.load_bench_curve(str(tmp_path / "missing.json")) == {}
    ctl = AdaptiveBatchController(
        max_batch=4, seed_curve=slo.load_bench_curve(str(path)))
    ref = jslo.AdaptiveBatchController(
        max_batch=4, seed_curve=jslo.load_bench_curve(str(path)))
    for b, s in ((2, 0.5), (4, 0.7), (1, 0.3)):
        ctl.observe(b, s)
        ref.observe(b, s)
        assert [ctl.estimate(k) for k in range(1, 7)] == [
            ref.estimate(k) for k in range(1, 7)]
        assert ctl.pick(4, slack=0.6) == ref.pick(4, slack=0.6)


# ----------------------------------------------------------------------------
# Inside the port: the mesh, the shim, the knobs outside the slice
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("compressor", ["daq", "none"])
def test_mesh_server_responses_are_serial_queries_bitwise(compressor):
    _, gt, _, tparams = _setup("sage")
    plan = Engine((tparams, "sage"), cluster="1A+2B+1C", executor="mesh-bsp",
                  aggregation="pallas", compressor=compressor,
                  device="cpu").compile(gt)
    trace = traces.poisson(10, 40.0, seed=3, features_fn=_features_fn(gt))
    srv = plan.server(max_batch=4, max_wait=0.05)
    out = srv.replay(trace)
    assert max(r.batch_size for r in out) > 1
    assert all(r.exchange_bytes > 0 for r in out)
    _serial_equal(plan, out, lambda k: trace[k].features)


def test_mesh_server_with_updates_matches_fresh_layouts():
    from repro_torch.runtime import bsp
    _, gt, _, tparams = _setup("gcn")
    plan = Engine((tparams, "gcn"), cluster="4B", executor="mesh-bsp",
                  aggregation="pallas", device="cpu").compile(gt)
    srv = plan.server(max_batch=4)
    d = GraphDelta(add_features=np.ones((2, gt.feature_dim), np.float32),
                   add_edges=[[gt.num_vertices, 3], [gt.num_vertices + 1, 7]],
                   remove_vertices=[11])
    out = srv.replay([Request(arrival_time=0.0),
                      UpdateRequest(delta=d, arrival_time=0.01),
                      Request(arrival_time=0.02), Request(arrival_time=0.02)])
    assert out[1].report.mode == "incremental"
    p2 = srv.session.plan
    scratch = dataclasses.replace(p2, partitioned=bsp.build_partitioned(
        p2.graph, p2.placement.assignment, n=p2.num_fogs, build_blocks=True))
    want = scratch.session().query().embeddings
    assert out[2].batch_size == 2
    assert all(np.array_equal(r.embeddings, want) for r in out[2:])


def test_stream_warns_stays_lazy_and_equals_query():
    _, tplan = _plans("pallas")
    sess = tplan.session()
    with pytest.warns(DeprecationWarning, match="Server"):
        it = sess.stream(3)
        first = next(it)
    assert sess.num_queries == 1          # lazy: one query per next()
    rest = list(it)
    assert sess.num_queries == 3
    q = tplan.session().query()
    for r in [first] + rest:
        assert np.array_equal(r.embeddings, q.embeddings)
        # The serial server's clock puts arrival + latency at the finish
        # time, so the latency equals the query's up to one rounding (the
        # reference's tests/test_server.py holds it to pytest.approx).
        assert r.latency == pytest.approx(q.latency)
        assert r.throughput == q.throughput and r.batch_size == 1
    with pytest.warns(DeprecationWarning):
        [r] = list(sess.stream([None], executor="cloud"))
    assert r.backend == "cloud"


def test_faults_raise_not_implemented_naming_the_item():
    _, tplan = _plans("segment_sum")
    with pytest.raises(NotImplementedError, match="item 3, fault tolerance"):
        tplan.server(faults=[("crash", 0.1, "A0")])
    with pytest.raises(NotImplementedError, match="fault tolerance"):
        Server(tplan.session(), faults=object())
