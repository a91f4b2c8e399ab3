"""The port's node-level fault tolerance == the JAX package's.

Host code is held exactly: ``Fault`` validation, ``FaultSchedule`` (sorted,
``random``, ``window``, ``counts``), the injector's cursor, the retry and
failover pricing, ``Engine.fail_nodes``' assignments, placements and
``PartitionedGraph`` layouts in both modes, and Server chaos replays (every
response timing, ``recovered`` / ``retries`` / ``capacity`` tag, and
``summarize``) and a fleet with a per-site schedule; embeddings match at
rtol 1e-4 / atol 1e-5 (tests/test_aggregation.py:51), or within the 8-bit
bar on the DAQ wire. Inside the port, bitwise: a recompile failover is a
fresh compile on the survivors, a repair failover's single-program
execute is the pre-crash one, a recover after a graph update serves a
fresh full-cluster compile of the current graph (a branch the reference
cannot run: it imports a module that does not exist), and the seeded
chaos property holds. One subprocess runs the JAX mesh (four forced host
devices, ``_shard_map`` rebound as in tests/test_torch_mesh.py). The port
runs on the CPU (``device="cpu"``).
"""
import dataclasses
import functools
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.analysis import AnalysisContext as JContext
from repro.analysis import run_checks as jrun_checks
from repro.api import Engine as JEngine
from repro.api import faults as jfaults
from repro.api.server import Request as JRequest
from repro.api.slo import default_ladder as jdefault_ladder
from repro.core import simulation as jsim
from repro.gnn import datasets as jdata
from repro.gnn import models as jmodels
from repro_torch.analysis import AnalysisContext, run_checks
from repro_torch.api import Engine, GraphDelta, Response, faults
from repro_torch.api.registry import EXCHANGES
from repro_torch.api.server import Request
from repro_torch.api.slo import default_ladder
from repro_torch.core import simulation
from repro_torch.gnn import datasets as tdata
from repro_torch.gnn import models as tmodels

from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
DAQ_BAR = 5e-2
KNOBS = dict(exchange="halo_async", staleness_bound=2)
#: Response fields held exactly (everything but the embeddings).
FIELDS = ("latency", "throughput", "breakdown", "wire_bytes",
          "exchange_bytes", "backend", "request_id", "arrival_time",
          "queue_delay", "service_start", "finish_time", "batch_size",
          "batch_index", "collect_time", "execute_time", "overlap_saved",
          "degradation", "staleness", "site", "route", "routing_delay",
          "retries", "recovered", "capacity")
#: PartitionedGraph array fields held exactly.
LAYOUT = ("feats", "vertex_mask", "senders_global", "senders_halo",
          "receivers_local", "edge_mask", "boundary_rows", "boundary_mask",
          "self_senders_global", "self_senders_halo", "part_of", "slot_of")


@functools.lru_cache(maxsize=None)
def _setup():
    g = jdata.load("siot", scale=0.06, seed=0)
    gt = tdata.load("siot", scale=0.06, seed=0)
    jparams = jmodels.gnn_init(jax.random.PRNGKey(0), "gcn",
                               [g.feature_dim, 16, 8])
    nparams = [{k: np.asarray(v) for k, v in p.items()} for p in jparams]
    return g, gt, jparams, tmodels.params_from_numpy(nparams)


@functools.lru_cache(maxsize=None)
def _engines(cluster="1A+3B", **knobs):
    _, _, jparams, tparams = _setup()
    knobs = dict(KNOBS, **knobs)
    return (JEngine((jparams, "gcn"), cluster, **knobs),
            Engine((tparams, "gcn"), cluster, device="cpu", **knobs))


@functools.lru_cache(maxsize=None)
def _plans(cluster="1A+3B", **knobs):
    je, te = _engines(cluster, **knobs)
    return je.compile(_setup()[0]), te.compile(_setup()[1])


def _trace(cls, n, dt=0.03):
    return [cls(arrival_time=i * dt) for i in range(n)]


def _fault_tuple(f):
    return (f.time, f.kind, f.node, f.duration, f.slowdown, f.losses)


def _same_schedule(t_sched, j_sched):
    assert [_fault_tuple(f) for f in t_sched] == \
        [_fault_tuple(f) for f in j_sched]


def _same_layout(a, b):
    """Two PartitionedGraph (port, reference) host layouts, exactly."""
    for name in ("n", "slots", "edges_per_part", "boundary_slots"):
        assert getattr(a, name) == getattr(b, name), name
    for name in LAYOUT:
        assert np.array_equal(getattr(a, name), np.asarray(getattr(b, name))
                              ), name
    for name in ("local_csr", "halo_csr"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            for f in ("blocks", "cols", "mask"):
                assert np.array_equal(getattr(x, f),
                                      np.asarray(getattr(y, f))), (name, f)
            assert (x.src_rows, x.out_rows) == (y.src_rows, y.out_rows)


def _same_plan_host(tp, jp):
    assert tp.provenance == jp.provenance
    assert [n.name for n in tp.cluster.nodes] == \
        [n.name for n in jp.cluster.nodes]
    assert [f.name for f in tp.fogs] == [f.name for f in jp.fogs]
    for name in ("assignment", "mapping", "est_exec", "est_total"):
        assert np.array_equal(np.asarray(getattr(tp.placement, name)),
                              np.asarray(getattr(jp.placement, name))), name
    assert tp.placement.est_makespan == jp.placement.est_makespan
    assert tp.config.cluster_spec == jp.config.cluster_spec
    _same_layout(tp.partitioned, jp.partitioned)


def _same_responses(tout, jout, daq_wire=False):
    assert len(tout) == len(jout)
    for a, b in zip(tout, jout):
        for name in FIELDS:
            assert getattr(a, name) == getattr(b, name), (name, a.request_id)
        _close(a.embeddings, np.asarray(b.embeddings), daq_wire)


def _close(got, want, daq_wire=False):
    if daq_wire:
        err = float(np.abs(got - want).max())
        assert err <= DAQ_BAR * max(float(np.abs(want).max()), 1.0), err
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------------------------
# Fault / FaultSchedule / FaultInjector
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("args,kw,match", [
    ((0.0, "meteor"), dict(node="fog0(A)"), "unknown fault kind"),
    ((-1.0, "halo_loss"), {}, ">= 0"),
    ((0.0, "crash"), {}, "needs a node"),
    ((0.0, "straggler"), dict(node="x", slowdown=0.5, duration=1.0),
     "slowdown"),
    ((0.0, "straggler"), dict(node="x", slowdown=2.0), "duration"),
    ((0.0, "halo_loss"), dict(losses=0), "losses")])
def test_fault_validation_equals_reference(args, kw, match):
    with pytest.raises(ValueError, match=match) as te:
        faults.Fault(*args, **kw)
    with pytest.raises(ValueError) as je:
        jfaults.Fault(*args, **kw)
    assert str(te.value) == str(je.value)


def test_schedule_and_injector_equal_reference():
    events = [(0.5, "halo_loss"), (0.1, "halo_loss"), (0.3, "crash", "a"),
              (0.3, "recover", "a")]
    ts = faults.FaultSchedule([faults.Fault(*e) for e in events])
    js = jfaults.FaultSchedule([jfaults.Fault(*e) for e in events])
    _same_schedule(ts, js)
    assert [f.time for f in ts] == [0.1, 0.3, 0.3, 0.5]
    assert repr(ts) == repr(js) and ts.counts() == js.counts()
    assert ts.node_names == js.node_names == ("a",)
    _same_schedule(ts.window(0.1, 0.5), js.window(0.1, 0.5))
    ti, ji = faults.FaultInjector(ts), jfaults.FaultInjector(js)
    for t in (0.05, 0.3, 0.3, 0.49):
        _same_schedule(ti.due(t), ji.due(t))
        assert ti.remaining == ji.remaining
    _same_schedule(ti.flush(), ji.flush())
    assert ti.remaining == ji.remaining == 0
    with pytest.raises(TypeError, match="Fault events"):
        faults.FaultSchedule([("crash", 0.1, "a")])


@pytest.mark.parametrize("seed", [7, 11, 16])
def test_random_schedule_equals_reference(seed):
    nodes = ["fog0(A)", "fog1(B)", "fog2(B)", "fog3(B)"]
    kw = dict(horizon=20.0, crash_rate=0.5, loss_rate=0.5,
              straggler_rate=0.3, mean_outage=0.3, seed=seed)
    ts = faults.FaultSchedule.random(nodes, **kw)
    _same_schedule(ts, jfaults.FaultSchedule.random(nodes, **kw))
    assert len(ts) > 0
    down = set()
    for f in ts:                 # never every node down at once
        if f.kind == "crash":
            down.add(f.node)
            assert len(down) < len(nodes)
        elif f.kind == "recover":
            down.discard(f.node)
    assert ts.counts()["crash"] == ts.counts()["recover"]
    with pytest.raises(ValueError, match="horizon"):
        faults.FaultSchedule.random(nodes, horizon=0.0)


# ----------------------------------------------------------------------------
# retry / failover pricing
# ----------------------------------------------------------------------------

def test_retry_and_failover_pricing_equal_reference():
    for losses in (1, 2, 4, 6):
        for timeout in (None, 0.01):
            kw = {} if timeout is None else dict(timeout=timeout)
            assert simulation.simulate_retry(losses, sync_cost=5e-3, **kw) \
                == jsim.simulate_retry(losses, sync_cost=5e-3, **kw)
    from repro.api.registry import EXCHANGES as JEXCHANGES
    for name in ("halo", "allgather", "halo_async"):
        t, j = EXCHANGES.resolve(name), JEXCHANGES.resolve(name)
        assert (t.retryable, t.stale_tolerant) == (j.retryable,
                                                   j.stale_tolerant)
        for losses in (1, 3, 6):
            assert t.recovery_cost(losses, 5e-3) == \
                j.recovery_cost(losses, 5e-3)
    jp, tp = _plans()
    for moved in (0, 100, 200):
        assert simulation.simulate_failover(tp.cluster, moved,
                                            tp.graph.feature_dim) == \
            jsim.simulate_failover(jp.cluster, moved, jp.graph.feature_dim)


# ----------------------------------------------------------------------------
# Engine.fail_nodes
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("executor,aggregation,mode", [
    ("sim", "auto", None), ("sim", "auto", "recompile"),
    ("mesh-bsp", "pallas", "repair"), ("mesh-bsp", "pallas", "recompile")])
def test_fail_nodes_equals_reference(executor, aggregation, mode):
    je, te = _engines(executor=executor, aggregation=aggregation)
    jp, tp = _plans(executor=executor, aggregation=aggregation)
    crashed = tp.cluster.nodes[-1].name
    t2 = te.fail_nodes(tp, [crashed], mode=mode)
    j2 = je.fail_nodes(jp, [crashed], mode=mode)
    _same_plan_host(t2, j2)
    assert t2.provenance == "failover" and t2.config.cluster_spec is None
    assert t2.partitioned.device_cache == {}
    assert crashed not in [n.name for n in t2.cluster.nodes]
    if executor == "sim":
        # single-program numerics do not depend on the assignment
        assert np.array_equal(t2.session().query().embeddings,
                              tp.session().query().embeddings)
    else:
        _close(t2.session().query().embeddings,
               np.asarray(tp.session().query().embeddings), daq_wire=True)


def test_recompile_failover_is_a_fresh_compile():
    _, te = _engines(executor="mesh-bsp", aggregation="pallas")
    _, tp = _plans(executor="mesh-bsp", aggregation="pallas")
    crashed = tp.cluster.nodes[1].name
    t2 = te.fail_nodes(tp, crashed, mode="recompile")
    survivors = dataclasses.replace(
        tp.cluster, nodes=[n for n in tp.cluster.nodes if n.name != crashed])
    fresh = Engine((_setup()[3], "gcn"), survivors, device="cpu",
                   executor="mesh-bsp", aggregation="pallas",
                   **KNOBS).compile(_setup()[1])
    assert t2.config == dataclasses.replace(fresh.config, cluster_spec=None)
    for name in ("assignment", "mapping", "est_total"):
        assert np.array_equal(getattr(t2.placement, name),
                              getattr(fresh.placement, name))
    for name in LAYOUT:
        assert np.array_equal(getattr(t2.partitioned, name),
                              getattr(fresh.partitioned, name))
    x = _setup()[1].features
    assert np.array_equal(t2.session().execute(x), fresh.session().execute(x))


def test_fail_nodes_rejects_bad_input():
    _, te = _engines()
    _, tp = _plans()
    with pytest.raises(KeyError, match="unknown node"):
        te.fail_nodes(tp, ["not-a-node"])
    with pytest.raises(ValueError, match="at least one"):
        te.fail_nodes(tp, [])
    with pytest.raises(ValueError, match="must survive"):
        te.fail_nodes(tp, [n.name for n in tp.cluster.nodes])
    with pytest.raises(ValueError, match="out of range"):
        te.fail_nodes(tp, [99])
    with pytest.raises(ValueError, match="mode"):
        te.fail_nodes(tp, [0], mode="heal")


def test_failover_plan_never_resurrects_node():
    """After a failover, recompiles and update pricing see the SURVIVING
    cluster, as in the reference."""
    g, gt = _setup()[:2]
    je, te = _engines()
    jp, tp = _plans()
    crashed = tp.cluster.nodes[-1].name
    t2, j2 = te.fail_nodes(tp, [crashed]), je.fail_nodes(jp, [crashed])
    te2 = Engine.from_plan(t2)
    survivors = [n.name for n in t2.cluster.nodes]
    assert [n.name for n in te2.cluster.nodes] == survivors
    feats = np.ones((1, g.feature_dim), np.float32)
    t3 = te2.apply_delta(t2, GraphDelta(add_features=feats,
                                        add_edges=[(g.num_vertices, 0)]),
                         force="recompile")
    from repro.api import GraphDelta as JDelta
    jdelta = JDelta(add_features=feats, add_edges=[(g.num_vertices, 0)])
    j3 = JEngine.from_plan(j2).apply_delta(j2, jdelta, force="recompile")
    assert [n.name for n in t3.cluster.nodes] == survivors
    assert np.array_equal(t3.placement.assignment, j3.placement.assignment)
    assert simulation.simulate_update(t2.cluster, GraphDelta(
        add_features=feats, add_edges=[(g.num_vertices, 0)])) == \
        jsim.simulate_update(j2.cluster, jdelta) > 0


def test_session_rebind_invalidates_layout_state():
    """A failover rebind drops the halo store and the mesh family's
    activation cache and swaps the layout; a single-program cache
    survives."""
    _, tp = _plans(executor="mesh-bsp", aggregation="pallas")
    sess = tp.session()
    x = _setup()[1].features
    sess.execute(x)
    assert sess._halo.tables is not None
    plan2 = sess.failover(tp.cluster.nodes[-1].name)
    assert sess.plan is plan2 and sess.partitioned() is plan2.partitioned
    assert sess._halo.tables is None
    assert sess.state.placement.assignment is not \
        plan2.placement.assignment
    mesh = _plans(executor="mesh-bsp", aggregation="pallas",
                  staleness_bound=0)[1].session(activation_cache=True)
    mesh.query()
    assert mesh._acache.primed
    mesh.failover(0)
    assert not mesh._acache.primed
    single = _plans(staleness_bound=0)[1].session(activation_cache=True)
    single.query()
    single.failover(0)
    assert single._acache.primed
    with pytest.raises(ValueError, match="same-graph"):
        sess.rebind(dataclasses.replace(
            plan2, graph=tdata.load("siot", scale=0.05, seed=0)))


# ----------------------------------------------------------------------------
# Server recovery tiers
# ----------------------------------------------------------------------------

def test_server_rejects_unknown_fault_node():
    _, tp = _plans()
    with pytest.raises(ValueError, match="unknown nodes") as te:
        tp.server(faults=faults.FaultSchedule(
            [faults.Fault(0.1, "crash", node="ghost")]))
    jp = _plans()[0]
    with pytest.raises(ValueError) as je:
        jp.server(faults=jfaults.FaultSchedule(
            [jfaults.Fault(0.1, "crash", node="ghost")]))
    assert str(te.value) == str(je.value)


def test_fault_free_schedule_costs_nothing():
    _, tp = _plans()
    base = tp.server(max_batch=4).serve(_trace(Request, 16))
    out = tp.server(max_batch=4, faults=faults.FaultSchedule([])).serve(
        _trace(Request, 16))
    for a, b in zip(out, base):
        assert a.latency == b.latency
        assert np.array_equal(a.embeddings, b.embeddings)
        assert (a.retries, a.recovered, a.capacity) == (0, None, "full")
        assert a.breakdown["recovery"] == 0.0
    assert "recovery" not in base[0].breakdown


#: schedules of the reference's tier tests: (events, requests, slo).
TIERS = {
    "tier1-retry": ([(0.10, "halo_loss", None, 0.0, 1.0, 2)], 16, None),
    "tier2-stale": ([(0.08, "halo_loss", None, 0.0, 1.0, 6)], 16, None),
    "tier3-crash-restore": ([(0.10, "crash", -1), (0.60, "recover", -1)],
                            40, None),
    "tier3-loss-failover": ([(0.02, "halo_loss", 2, 0.0, 1.0, 6),
                             (0.40, "recover", 2)], 24, None),
    "straggler": ([(0.05, "straggler", 1, 0.30, 4.0)], 24, None),
    "crash-under-slo": ([(0.10, "crash", -1)], 24, True),
}


def _events(spec, plan, mod):
    names = [n.name for n in plan.cluster.nodes]
    out = []
    for e in spec:
        e = list(e)
        if len(e) > 2 and isinstance(e[2], int):
            e[2] = names[e[2]]
        out.append(mod.Fault(*e))
    return mod.FaultSchedule(out)


@pytest.mark.parametrize("case", sorted(TIERS))
def test_recovery_tiers_equal_reference(case):
    spec, n, slo = TIERS[case]
    jp, tp = _plans()
    jsrv = jp.server(max_batch=4, slo=slo, faults=_events(spec, jp, jfaults))
    tsrv = tp.server(max_batch=4, slo=slo, faults=_events(spec, tp, faults))
    jout = jsrv.serve(_trace(JRequest, n))
    tout = tsrv.serve(_trace(Request, n))
    answered = [r for r in tout if isinstance(r, Response)]
    _same_responses(answered, [r for r in jout if hasattr(r, "embeddings")])
    assert tsrv.summarize(tout) == jsrv.summarize(jout)
    assert (tsrv.replayed, sorted(tsrv._crashed)) == (jsrv.replayed,
                                                      sorted(jsrv._crashed))
    assert [lv.name for lv in tsrv.ladder] == [lv.name for lv in jsrv.ladder]
    tags = [r.recovered for r in answered]
    base = tp.server(max_batch=4, slo=slo).serve(_trace(Request, n))
    by_id = {r.request_id: r for r in base if isinstance(r, Response)}
    for r in answered:   # bitwise the fault-free serve unless tagged
        assert (np.array_equal(r.embeddings, by_id[r.request_id].embeddings)
                or r.staleness > 0 or r.capacity == "degraded")
    if case == "tier1-retry":
        assert "retry" in tags and all(r.retries == 2 for r in answered
                                       if r.recovered == "retry")
    elif case == "tier2-stale":
        assert "stale" in tags
    elif case == "tier3-crash-restore":
        assert "failover" in tags and "restored" in tags
        assert tsrv.session.plan is tp and tsrv.replayed > 0
        assert tsrv.summarize(tout)["availability"] == 1.0
    elif case == "straggler":
        assert not tsrv._slow
        assert max(r.latency for r in answered) > max(
            r.latency for r in base)
    elif case == "crash-under-slo":
        assert tsrv.ladder[0].name == "survivor-degraded"


def test_survivor_degraded_ladder_equals_reference():
    je, te = _engines()
    jp, tp = _plans()
    crashed = tp.cluster.nodes[-1].name
    t = default_ladder(te.fail_nodes(tp, [crashed]).session())
    j = jdefault_ladder(je.fail_nodes(jp, [crashed]).session())
    assert [lv.name for lv in t] == [lv.name for lv in j]
    assert t[0].name == "survivor-degraded"


# ----------------------------------------------------------------------------
# seeded chaos property
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("executor,aggregation,seed", [
    ("sim", "segment_sum", 11), ("sim", "pallas", 11),
    ("single", "segment_sum", 11), ("sim", "pallas", 16),
    ("single", "segment_sum", 16)])
def test_chaos_property_equals_reference(executor, aggregation, seed):
    jp, tp = _plans(executor=executor, aggregation=aggregation)
    n = 32
    kw = dict(horizon=n * 0.03, crash_rate=1.5, loss_rate=2.0,
              straggler_rate=1.0, mean_outage=0.3, seed=seed)
    names = [nd.name for nd in tp.cluster.nodes]
    tsched = faults.FaultSchedule.random(names, **kw)
    jsched = jfaults.FaultSchedule.random(names, **kw)
    _same_schedule(tsched, jsched)
    tsrv = tp.server(max_batch=4, faults=tsched)
    jsrv = jp.server(max_batch=4, faults=jsched)
    tout = tsrv.serve(_trace(Request, n))
    jout = jsrv.serve(_trace(JRequest, n))
    _same_responses(tout, jout)
    assert tsrv.summarize(tout) == jsrv.summarize(jout)
    base = {r.request_id: r for r in
            tp.server(max_batch=4).serve(_trace(Request, n))}
    assert len(tout) == n
    for r in tout:
        assert (np.array_equal(r.embeddings, base[r.request_id].embeddings)
                or r.staleness > 0 or r.capacity == "degraded")
    assert tsrv.summarize(tout)["availability"] == 1.0


def test_recover_after_update_serves_a_fresh_compile():
    """The branch the reference cannot run: a structural delta lands while
    a node is down, then it recovers; the restored plan is a fresh
    full-cluster compile of the current graph, bitwise."""
    g, gt = _setup()[:2]
    _, te = _engines(executor="mesh-bsp", aggregation="pallas")
    _, tp = _plans(executor="mesh-bsp", aggregation="pallas")
    victim = tp.cluster.nodes[2].name
    sched = faults.FaultSchedule([faults.Fault(0.05, "crash", node=victim),
                                  faults.Fault(0.50, "recover",
                                               node=victim)])
    srv = tp.server(max_batch=4, faults=sched)
    out = srv.serve(_trace(Request, 8))
    assert any(r.capacity == "degraded" for r in out)
    v = gt.num_vertices
    srv.submit(GraphDelta(add_features=np.ones((2, gt.feature_dim),
                                               np.float32),
                          add_edges=[(v, 0), (v + 1, 1), (0, v)],
                          remove_edges=[(int(gt.senders[0]),
                                         int(gt.receivers[0]))]))
    out += srv.serve([Request(arrival_time=0.3 + 0.03 * i)
                      for i in range(12)])
    assert "restored" in [getattr(r, "recovered", None) for r in out]
    plan = srv.session.plan
    assert plan.provenance != "failover" and not srv._crashed
    assert [n.name for n in plan.cluster.nodes] == \
        [n.name for n in tp.cluster.nodes]
    fresh = Engine.from_plan(tp)._recompile(plan.graph)
    for name in LAYOUT:
        assert np.array_equal(getattr(plan.partitioned, name),
                              getattr(fresh.partitioned, name))
    x = plan.graph.features
    assert np.array_equal(plan.session().execute(x),
                          fresh.session().execute(x))
    want = fresh.session().query().embeddings
    tags = [getattr(r, "recovered", None) for r in out]
    after = [r for r in out[tags.index("restored"):]
             if isinstance(r, Response)]
    assert after and all(r.capacity == "full" for r in after)
    for r in after:   # fresh serves of the restored plan, bitwise
        assert r.staleness > 0 or np.array_equal(r.embeddings, want)
    assert any(r.staleness == 0 for r in after)


# ----------------------------------------------------------------------------
# fleet, fault checks
# ----------------------------------------------------------------------------

def test_fleet_with_node_faults_equals_reference():
    sites = {"north": (59.33, 18.07), "south": (48.21, 16.37)}
    g, gt, jparams, tparams = _setup()
    jfleet = JEngine((jparams, "gcn"), "1A+2B", **KNOBS).compile_fleet(
        g, sites)
    tfleet = Engine((tparams, "gcn"), "1A+2B", device="cpu",
                    **KNOBS).compile_fleet(gt, sites)
    with pytest.raises(ValueError, match="unknown sites"):
        tfleet.server(faults={"atlantis": faults.FaultSchedule([])})
    node = tfleet.site("north").plan.cluster.nodes[-1].name
    spec = [(0.05, "crash", node), (0.50, "recover", node)]
    servers = []
    for fleet, mod in ((tfleet, faults), (jfleet, jfaults)):
        sched = mod.FaultSchedule([mod.Fault(*e) for e in spec])
        fs = fleet.server(capacity=100, max_batch=4,
                          faults={"north": sched})
        for i in range(24):
            fs.submit(arrival_time=i * 0.03,
                      origin=sites["north" if i % 2 == 0 else "south"])
        servers.append((fs, fs.drain()))
    (tfs, tout), (jfs, jout) = servers
    tresp = [r for r in tout if isinstance(r, Response)]
    _same_responses(tresp, [r for r in jout if hasattr(r, "embeddings")])
    assert tfs.summarize(tout) == jfs.summarize(jout)
    assert len(tresp) == 24 and tfs.summarize(tout)["dropped"] == 0
    assert any(r.recovered == "failover" for r in tresp if r.site == "north")
    assert all(r.recovered is None for r in tresp if r.site == "south")


def test_fault_checks_equal_reference():
    je, te = _engines()
    jp, tp = _plans()
    crashed = tp.cluster.nodes[-1].name
    t2, j2 = te.fail_nodes(tp, [crashed]), je.fail_nodes(jp, [crashed])
    tbad = dataclasses.replace(
        t2, config=t2.config.with_overrides(cluster_spec="1A+3B"))
    jbad = dataclasses.replace(
        j2, config=j2.config.with_overrides(cluster_spec="1A+3B"))
    tdouble = faults.FaultSchedule([faults.Fault(0.1, "crash", node="a"),
                                    faults.Fault(0.2, "crash", node="a")])
    jdouble = jfaults.FaultSchedule([jfaults.Fault(0.1, "crash", node="a"),
                                     jfaults.Fault(0.2, "crash", node="a")])
    for tkw, jkw in ((dict(plan=t2, base_plan=tp, crashed=(crashed,)),
                      dict(plan=j2, base_plan=jp, crashed=(crashed,))),
                     (dict(plan=tbad, base_plan=tp, crashed=(crashed,)),
                      dict(plan=jbad, base_plan=jp, crashed=(crashed,))),
                     (dict(plan=t2, schedule=tdouble),
                      dict(plan=j2, schedule=jdouble))):
        t = run_checks(AnalysisContext(plan=tkw["plan"],
                                       failover=faults.FailoverAudit(**tkw)),
                       families=("fault",))
        j = jrun_checks(JContext(plan=jkw["plan"],
                                 failover=jfaults.FailoverAudit(**jkw)),
                        families=("fault",))
        assert t.ran == j.ran
        assert [(d.check_id, d.severity, d.subject) for d in t.diagnostics
                if d.severity != "info"] == \
            [(d.check_id, d.severity, d.subject) for d in j.diagnostics
             if d.severity != "info"]
    # a live server: the halo store after a failover is revision-clean
    srv = tp.server(max_batch=4, faults=_events(
        TIERS["tier3-crash-restore"][0][:1], tp, faults))
    srv.serve(_trace(Request, 16))
    audit = faults.FailoverAudit(plan=srv.session.plan, base_plan=tp,
                                 crashed=tuple(srv._crashed), server=srv)
    report = run_checks(AnalysisContext(plan=audit.plan, failover=audit),
                        families=("fault", "plan", "cache"))
    assert report.ok and not report.warnings, report.format()


# ----------------------------------------------------------------------------
# the JAX mesh (subprocess): repair failover and chaos replay
# ----------------------------------------------------------------------------

REFERENCE = textwrap.dedent("""
    import sys
    import jax
    import numpy as np
    import repro.runtime.bsp as bsp

    _shard_map = bsp._shard_map

    def _shard_map_compat(f, *args, check_rep=None, **kwargs):
        if check_rep is not None:
            kwargs["check_vma"] = False
        return _shard_map(f, *args, **kwargs)

    bsp._shard_map = _shard_map_compat

    from repro.api import Engine
    from repro.api.faults import FaultSchedule
    from repro.api.server import Request
    from repro.gnn import datasets, models

    g = datasets.load("siot", scale=0.05, seed=0)
    params = models.gnn_init(jax.random.PRNGKey(0), "gcn",
                             [g.feature_dim, 16, 8])
    out = {}
    for i, p in enumerate(params):
        for k, val in p.items():
            out[f"param/{i}/{k}"] = np.asarray(val)
    eng = Engine((params, "gcn"), "1A+3B", executor="mesh-bsp",
                 aggregation="pallas", compressor="daq",
                 exchange="halo_async", staleness_bound=2)
    plan = eng.compile(g)
    crashed = plan.cluster.nodes[2].name
    plan2 = eng.fail_nodes(plan, crashed, mode="repair")
    out["failover/assignment"] = np.asarray(plan2.placement.assignment)
    out["failover/embeddings"] = np.asarray(
        plan2.session().query().embeddings)
    sched = FaultSchedule.random(
        [nd.name for nd in plan.cluster.nodes], horizon=0.5,
        crash_rate=1.5, loss_rate=2.0, straggler_rate=1.0,
        mean_outage=0.3, seed=16)
    srv = plan.server(max_batch=4, faults=sched)
    resp = srv.serve([Request(arrival_time=i * 0.03) for i in range(16)])
    for r in resp:
        out[f"chaos/{r.request_id}/embeddings"] = np.asarray(r.embeddings)
        out[f"chaos/{r.request_id}/latency"] = np.asarray(r.latency)
        out[f"chaos/{r.request_id}/tags"] = np.array(
            [str(r.recovered), str(r.retries), r.capacity,
             str(r.staleness)])
    np.savez(sys.argv[1], **out)
    print("OK")
""")


@pytest.fixture(scope="module")
def mesh_reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("faults") / "reference.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", REFERENCE, str(path)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK" in proc.stdout
    with np.load(path) as ref:
        return dict(ref)


def test_mesh_failover_and_chaos_match_jax(mesh_reference):
    """The JAX mesh's repair failover and seeded chaos replay against the
    port's: the same assignment, timings and tags; embeddings within the
    DAQ wire's bar; inside the port every response bitwise a serial
    query on the plan that served it or tagged."""
    ref = mesh_reference
    gt = tdata.load("siot", scale=0.05, seed=0)
    params = [{k[len(f"param/{i}/"):]: torch.tensor(v)
               for k, v in ref.items() if k.startswith(f"param/{i}/")}
              for i in range(2)]
    eng = Engine((params, "gcn"), "1A+3B", executor="mesh-bsp",
                 aggregation="pallas", compressor="daq",
                 exchange="halo_async", staleness_bound=2, device="cpu")
    plan = eng.compile(gt)
    plan2 = eng.fail_nodes(plan, plan.cluster.nodes[2].name, mode="repair")
    assert np.array_equal(plan2.placement.assignment,
                          ref["failover/assignment"])
    emb = plan2.session().query().embeddings
    _close(emb, ref["failover/embeddings"], daq_wire=True)
    sess = plan2.session(staleness_bound=0)   # every serve fresh
    assert np.array_equal(sess.query().embeddings, emb)
    x = np.stack([gt.features + i for i in range(3)])
    many = sess.execute_many(x)
    assert all(np.array_equal(m, sess.execute(f)) for m, f in zip(many, x))
    sched = faults.FaultSchedule.random(
        [nd.name for nd in plan.cluster.nodes], horizon=0.5,
        crash_rate=1.5, loss_rate=2.0, straggler_rate=1.0,
        mean_outage=0.3, seed=16)
    srv = plan.server(max_batch=4, faults=sched)
    resp = srv.serve(_trace(Request, 16))
    assert len(resp) == 16 and srv.summarize(resp)["availability"] == 1.0
    base = {r.request_id: r for r in
            plan.server(max_batch=4).serve(_trace(Request, 16))}
    for r in resp:
        key = f"chaos/{r.request_id}/"
        assert r.latency == float(ref[key + "latency"])
        assert [str(r.recovered), str(r.retries), r.capacity,
                str(r.staleness)] == list(ref[key + "tags"])
        _close(r.embeddings, ref[key + "embeddings"], daq_wire=True)
        assert (np.array_equal(r.embeddings, base[r.request_id].embeddings)
                or r.staleness > 0 or r.capacity == "degraded")
