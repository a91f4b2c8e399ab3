"""The port's stale-halo serving and fleet router == the JAX package's.

Host code is held exactly: the staleness pattern of a bounded
``exchange="halo_async"`` session, its accounting (latency, exchange
bytes) with and without staleness, the ``Response.staleness`` a Server
records, ``haversine_km``, the Router's ranks and decisions, and a
``FleetServer`` replay of a geo-tagged trace with a site set down and up
again (every response timing, route and site, and ``summarize``) are
``==`` the reference's; embeddings match within rtol 1e-4 / atol 1e-5.
Inside the port: ``staleness_bound=0`` is bitwise ``halo``, a stale serve
is bitwise ``bsp_infer_stale`` over ``build_halo_tables`` of the recorded
serve, and an update forces a fresh serve. One subprocess runs the JAX
mesh (four forced host devices, ``_shard_map`` rebound as in
tests/test_torch_mesh.py) for the mesh's frontier and stale serves. The
port runs on the CPU (``device="cpu"``).
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

from repro.api import Engine as JEngine
from repro.api import Server as JServer
from repro.api import fleet as jfleet
from repro.api import traces as jtraces
from repro.gnn import datasets as jdata
from repro.gnn import models as jmodels
from repro_torch.api import Engine, GraphDelta, Response, Server, traces
from repro_torch.api import fleet as tfleet
from repro_torch.gnn import datasets as tdata
from repro_torch.gnn import models as tmodels
from repro_torch.runtime import bsp

from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
DAQ_BAR = 5e-2
SITES = {"north": (59.33, 18.07), "south": (48.21, 16.37),
         "west": (51.51, -0.13)}
#: Response fields held exactly (everything but the embeddings).
TIMING = ("latency", "throughput", "breakdown", "wire_bytes",
          "exchange_bytes", "backend", "request_id", "arrival_time",
          "queue_delay", "service_start", "finish_time", "batch_size",
          "batch_index", "collect_time", "execute_time", "overlap_saved",
          "staleness", "site", "route", "routing_delay")


@functools.lru_cache(maxsize=None)
def _setup():
    g = jdata.load("siot", scale=0.06, seed=0)
    gt = tdata.load("siot", scale=0.06, seed=0)
    jparams = jmodels.gnn_init(jax.random.PRNGKey(0), "gcn",
                               [g.feature_dim, 16, 8])
    nparams = [{k: np.asarray(v) for k, v in p.items()} for p in jparams]
    return g, gt, jparams, tmodels.params_from_numpy(nparams)


def _engines(**knobs):
    _, _, jparams, tparams = _setup()
    return (JEngine((jparams, "gcn"), "1A+2B", **knobs),
            Engine((tparams, "gcn"), "1A+2B", device="cpu", **knobs))


def _feats(g, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(g.features.shape).astype(np.float32)
            for _ in range(n)]


# ----------------------------------------------------------------------------
# staleness: pattern and accounting
# ----------------------------------------------------------------------------

def test_staleness_pattern_and_accounting_equal_reference():
    g = _setup()[0]
    je, te = _engines(exchange="halo_async", staleness_bound=2)
    js, ts = je.compile(g).session(), te.compile(_setup()[1]).session()
    seen = []
    for f in _feats(g, 5, 1):
        np.testing.assert_allclose(ts.execute(f), np.asarray(js.execute(f)),
                                   rtol=RTOL, atol=ATOL)
        assert ts.last_staleness == js.last_staleness
        seen.append(ts.last_staleness)
    assert seen == [0, 1, 2, 0, 1]
    for st in (0, 1):
        a, b = ts.account(staleness=st), js.account(staleness=st)
        assert a.total_latency == b.total_latency
        assert a.throughput == b.throughput
        assert ts.exchange_bytes(staleness=st) == js.exchange_bytes(
            staleness=st)
    assert ts.account(staleness=1).total_latency < \
        ts.account(staleness=0).total_latency
    assert ts.exchange_bytes(staleness=1) == 0 < ts.exchange_bytes(
        staleness=0)
    srv = [Server(ts.plan.session(), max_batch=1),
           JServer(js.plan.session(), max_batch=1)]
    for s in srv:
        for i in range(3):
            s.submit(arrival_time=0.01 * i)
    tout, jout = (s.drain() for s in srv)
    assert [r.staleness for r in tout] == [0, 1, 2]
    for a, b in zip(tout, jout):
        for name in TIMING[:-3]:
            assert getattr(a, name) == getattr(b, name), name


@pytest.mark.parametrize("executor,aggregation", [
    ("sim", "segment_sum"), ("mesh-bsp", "pallas"),
    ("mesh-bsp", "segment_sum")])
def test_bound0_is_halo_bitwise(executor, aggregation):
    gt = _setup()[1]
    _, tparams = _setup()[2:]
    kw = dict(executor=executor, aggregation=aggregation, compressor="daq",
              device="cpu")
    sync = Engine((tparams, "gcn"), "1A+2B", exchange="halo",
                  **kw).compile(gt).session()
    async0 = Engine((tparams, "gcn"), "1A+2B", exchange="halo_async",
                    staleness_bound=0, **kw).compile(gt).session()
    for f in _feats(gt, 2, 0):
        assert np.array_equal(sync.execute(f), async0.execute(f))
        assert async0.last_staleness == 0
    assert async0.can_serve_stale() is False


@pytest.mark.parametrize("aggregation", ["pallas", "segment_sum"])
def test_mesh_stale_serve_is_the_replay_bitwise(aggregation):
    """Serve 0 fresh, 1 and 2 stale (single and batched), 3 fresh: each
    stale serve is bitwise ``bsp_infer_stale(_many)`` over the tables built
    from serve 0's captured layer inputs and differs from a fresh serve;
    the fresh serves are bitwise ``halo``."""
    gt = _setup()[1]
    tparams = _setup()[3]
    kw = dict(executor="mesh-bsp", aggregation=aggregation,
              compressor="none", device="cpu")
    sync = Engine((tparams, "gcn"), "1A+2B", exchange="halo",
                  **kw).compile(gt).session()
    sess = Engine((tparams, "gcn"), "1A+2B", exchange="halo_async",
                  staleness_bound=2, **kw).compile(gt).session()
    f0, f1, f2, f3 = _feats(gt, 4, 2)
    assert np.array_equal(sess.execute(f0), sync.execute(f0))
    plan = sync.plan
    layers = sync.resolve_executor().run_layers(
        plan, f0, plan.placement.assignment, sync.partitioned(), "halo",
        aggregation=aggregation)
    tables = bsp.build_halo_tables(sync.partitioned(), [f0] + layers[:-1])
    assert all(np.array_equal(a, b) for a, b in zip(tables,
                                                    sess._halo.tables))
    assert sess.can_serve_stale()
    out1 = sess.execute(f1)
    assert sess.last_staleness == 1
    params = list(plan.model.params)
    want = bsp.bsp_infer_stale(params, "gcn", f1, sess.partitioned(),
                               tables, device="cpu",
                               aggregation=aggregation)
    assert np.array_equal(out1, want)
    assert not np.array_equal(out1, sync.execute(f1))
    many = sess.execute_many(np.stack([f1, f2]))
    assert sess.last_staleness == 2 and not sess.can_serve_stale()
    want = bsp.bsp_infer_stale_many(params, "gcn", np.stack([f1, f2]),
                                    sess.partitioned(), tables,
                                    device="cpu", aggregation=aggregation)
    assert np.array_equal(many[0], out1) and np.array_equal(many[1],
                                                            want[1])
    assert np.array_equal(sess.execute(f3), sync.execute(f3))
    assert sess.last_staleness == 0


def test_update_forces_fresh_serve():
    gt = _setup()[1]
    tparams = _setup()[3]
    sess = Engine((tparams, "gcn"), "1A+2B", exchange="halo_async",
                  staleness_bound=3, executor="mesh-bsp",
                  aggregation="pallas", device="cpu").compile(gt).session()
    sess.execute(gt.features)
    sess.execute(gt.features)
    assert sess.last_staleness == 1
    sess.update(GraphDelta(feature_ids=np.array([0]),
                           feature_values=np.ones((1, gt.feature_dim),
                                                  np.float32)))
    assert not sess.can_serve_stale()
    got = sess.execute(sess.plan.graph.features)
    assert sess.last_staleness == 0
    fresh = Engine((tparams, "gcn"), "1A+2B", exchange="halo",
                   executor="mesh-bsp", aggregation="pallas",
                   device="cpu").compile(sess.plan.graph).session()
    assert np.array_equal(got, fresh.execute(sess.plan.graph.features))


def test_engine_rejects_bound_on_sync_exchange():
    tparams = _setup()[3]
    with pytest.raises(ValueError, match="stale-tolerant"):
        Engine((tparams, "gcn"), "1A+2B", exchange="halo",
               staleness_bound=1, device="cpu")
    with pytest.raises(ValueError, match=">= 0"):
        Engine((tparams, "gcn"), "1A+2B", exchange="halo_async",
               staleness_bound=-1, device="cpu")
    eng = Engine((tparams, "gcn"), "1A+2B", exchange="halo_async",
                 staleness_bound=2, device="cpu")
    assert eng.config.staleness_bound == 2
    assert Engine.from_plan(eng.compile(_setup()[1])).config == eng.config


# ----------------------------------------------------------------------------
# the fleet: routes, clocks, summarize
# ----------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _fleets():
    je, te = _engines(exchange="halo_async", staleness_bound=2)
    return (je.compile_fleet(_setup()[0], SITES),
            te.compile_fleet(_setup()[1], SITES))


def test_compile_fleet_shape_equals_reference():
    jf, tf = _fleets()
    assert tf.site_names == jf.site_names == ("north", "south", "west")
    assert tf.cloud_plan.config.executor == "cloud"
    assert tf.cloud_plan.config.staleness_bound == 0
    assert tf.centroids() == jf.centroids()
    for a, b in zip(tf.sites, jf.sites):
        assert a.plan.config.seed == b.plan.config.seed
        assert a.plan.config.staleness_bound == 2
        assert np.array_equal(a.plan.placement.assignment,
                              b.plan.placement.assignment)
    assert tf.describe() == jf.describe()
    with pytest.raises(ValueError, match="reserved"):
        tfleet.Site(name="cloud", location=(0.0, 0.0),
                    plan=tf.sites[0].plan)
    with pytest.raises(KeyError, match="unknown site"):
        tf.site("nowhere")
    with pytest.raises(ValueError, match="at least one site"):
        Engine((_setup()[3], "gcn"), "1A+2B", device="cpu").compile_fleet(
            _setup()[1], {})
    with pytest.raises(ValueError, match="unknown sites"):
        tf.server(faults={"nowhere": []})
    assert tf.server(faults={"north": []}).servers["north"].injector \
        is not None


def test_router_decisions_equal_reference():
    jf, tf = _fleets()
    jr, tr = jfleet.Router(jf, capacity=2), tfleet.Router(tf, capacity=2)
    rng = np.random.default_rng(0)
    origins = [None] + [tuple(rng.uniform([40, -10], [65, 30]))
                        for _ in range(12)]
    depth = {"north": 2, "south": 0, "west": 1}
    for down in ((), ("north",), ("north", "south", "west")):
        for name in SITES:
            jr.set_down(name, name in down)
            tr.set_down(name, name in down)
        for o in origins:
            assert tr.rank(o) == jr.rank(o)
            for qd in (lambda n: 0, depth.get, lambda n: 99):
                a, b = tr.route(o, qd), jr.route(o, qd)
                assert dataclasses.astuple(a) == dataclasses.astuple(b)
                assert a.routing_delay == b.routing_delay
    for a in SITES.values():
        for b in SITES.values():
            assert tfleet.haversine_km(a, b) == jfleet.haversine_km(a, b)
    with pytest.raises(KeyError):
        tr.set_down("nowhere")


def _replay(fs, trace, down_at, up_at):
    out = []
    for i, r in enumerate(trace):
        if i == down_at:
            fs.set_down("north")
        if i == up_at:
            fs.set_down("north", False)
        fs.submit(r)
        if i % 5 == 4:
            out += fs.drain()
    return out + fs.drain()


def test_fleet_replay_with_a_site_down_equals_reference():
    """A geo-tagged Poisson trace through both FleetServers, the nearest
    site set down partway and back up: every response's timing, site,
    route and staleness ``==``, embeddings within the bar, ``summarize``
    ``==``, zero drops."""
    jf, tf = _fleets()
    kw = dict(seed=4, origin_fn=None)
    jtr = jtraces.poisson(24, 40.0, **dict(
        kw, origin_fn=jtraces.geo_origins(jf.centroids(), seed=5)))
    ttr = traces.poisson(24, 40.0, **dict(
        kw, origin_fn=traces.geo_origins(tf.centroids(), seed=5)))
    jfs, tfs = jf.server(capacity=4), tf.server(capacity=4)
    jout = _replay(jfs, jtr, 6, 15)
    tout = _replay(tfs, ttr, 6, 15)
    assert len(tout) == len(jout) == 24
    assert all(isinstance(r, Response) for r in tout)
    for a, b in zip(tout, jout):
        for name in TIMING:
            assert getattr(a, name) == getattr(b, name), name
        np.testing.assert_allclose(a.embeddings, np.asarray(b.embeddings),
                                   rtol=RTOL, atol=ATOL)
    ts, js = tfs.summarize(tout), jfs.summarize(jout)
    assert ts == js
    assert ts["dropped"] == 0
    assert sum(ts["routes"].values()) == 24
    assert ts["routes"]["failed_over"] > 0


def test_fleet_update_fans_out_and_stays_one_revision():
    _, tf = _fleets()
    gt = _setup()[1]
    fs = tf.server()
    reports = fs.update(GraphDelta(feature_ids=np.array([3]),
                                   feature_values=np.full(
                                       (1, gt.feature_dim), 0.5,
                                       np.float32)))
    assert set(reports) == set(fs.tier_names)
    graphs = [fs.servers[n].session.plan.graph for n in fs.tier_names]
    assert all(np.array_equal(g.features, graphs[0].features)
               for g in graphs)
    with pytest.raises(TypeError, match="update"):
        fs.submit(GraphDelta(feature_ids=np.array([0]),
                             feature_values=np.zeros((1, gt.feature_dim),
                                                     np.float32)))


# ----------------------------------------------------------------------------
# the JAX mesh (subprocess): frontier and stale serves
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

    from repro.api import Engine, GraphDelta
    from repro.gnn import models
    from repro.gnn.graph import from_edge_list

    v = 256
    rng = np.random.default_rng(0)
    edges = np.array([(i, (i + 1) % v) for i in range(v)], np.int64)
    g = from_edge_list(v, edges, rng.normal(size=(v, 4)).astype(np.float32))
    params = models.gnn_init(jax.random.PRNGKey(0), "gcn", [4, 8, 4])
    out = {}
    for i, p in enumerate(params):
        for k, val in p.items():
            out[f"param/{i}/{k}"] = np.asarray(val)
    ones = np.ones((1, 4), np.float32)
    for agg, comp in (("segment_sum", "none"), ("pallas", "daq")):
        eng = Engine((params, "gcn"), cluster="4B", executor="mesh-bsp",
                     aggregation=agg, compressor=comp)
        sess = eng.compile(g).session(activation_cache=True,
                                      frontier_max_fraction=1.0)
        deltas = [None, GraphDelta(feature_ids=[7], feature_values=ones),
                  GraphDelta(add_edges=[(0, 9), (9, 0)]),
                  GraphDelta(feature_ids=[40], feature_values=-ones)]
        for q, d in enumerate(deltas):
            if d is not None:
                sess.update(d)
            out[f"{agg}/frontier/{q}"] = np.asarray(sess.query().embeddings)
            lf = sess.last_frontier
            out[f"{agg}/rows/{q}"] = (np.concatenate(lf.rows) if lf
                                      else np.array([-1]))
        stale = Engine((params, "gcn"), cluster="4B", executor="mesh-bsp",
                       aggregation=agg, compressor=comp,
                       exchange="halo_async",
                       staleness_bound=2).compile(g).session()
        frng = np.random.default_rng(1)
        for q in range(4):
            f = frng.normal(size=(v, 4)).astype(np.float32)
            out[f"{agg}/stale/{q}"] = np.asarray(stale.execute(f))
            out[f"{agg}/staleness/{q}"] = np.asarray(stale.last_staleness)
            out[f"{agg}/xbytes/{q}"] = np.asarray(stale.exchange_bytes())
    np.savez(sys.argv[1], **out)
    print("OK")
""")


@pytest.fixture(scope="module")
def mesh_reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("stale") / "reference.npz"
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


def _close(got, want, daq_wire):
    if daq_wire:
        err = float(np.abs(got - want).max())
        assert err <= DAQ_BAR * max(float(np.abs(want).max()), 1.0), err
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("agg,comp", [("segment_sum", "none"),
                                      ("pallas", "daq")])
def test_mesh_frontier_and_stale_match_jax(mesh_reference, agg, comp):
    """The JAX mesh's cached session and bounded-stale session against the
    port's on the same ring graph: the same frontier rows per query, the
    same staleness pattern and exchange bytes, embeddings at the bar (the
    DAQ wire at the reference's 8-bit bar)."""
    from repro_torch.gnn.graph import from_edge_list
    ref = mesh_reference
    v = 256
    rng = np.random.default_rng(0)
    edges = np.array([(i, (i + 1) % v) for i in range(v)], np.int64)
    g = from_edge_list(v, edges, rng.normal(size=(v, 4)).astype(np.float32))
    layers = {}
    for key, val in ref.items():
        if key.startswith("param/"):
            _, i, name = key.split("/")
            layers.setdefault(int(i), {})[name] = val
    params = tmodels.params_from_numpy([layers[i] for i in sorted(layers)])
    sess = Engine((params, "gcn"), cluster="4B", executor="mesh-bsp",
                  aggregation=agg, compressor=comp, device="cpu").compile(
                      g).session(activation_cache=True,
                                 frontier_max_fraction=1.0)
    ones = np.ones((1, 4), np.float32)
    deltas = [None, GraphDelta(feature_ids=[7], feature_values=ones),
              GraphDelta(add_edges=[(0, 9), (9, 0)]),
              GraphDelta(feature_ids=[40], feature_values=-ones)]
    for q, d in enumerate(deltas):
        if d is not None:
            sess.update(d)
        _close(sess.query().embeddings, ref[f"{agg}/frontier/{q}"],
               comp == "daq")
        lf = sess.last_frontier
        rows = np.concatenate(lf.rows) if lf else np.array([-1])
        assert np.array_equal(rows, ref[f"{agg}/rows/{q}"]), q
    stale = Engine((params, "gcn"), cluster="4B", executor="mesh-bsp",
                   aggregation=agg, compressor=comp, exchange="halo_async",
                   staleness_bound=2, device="cpu").compile(g).session()
    frng = np.random.default_rng(1)
    for q in range(4):
        f = frng.normal(size=(v, 4)).astype(np.float32)
        got = stale.execute(f)
        assert stale.last_staleness == ref[f"{agg}/staleness/{q}"].item()
        assert stale.exchange_bytes() == ref[f"{agg}/xbytes/{q}"].item()
        # A stale serve replays f32 tables: no wire, so the f32 bar.
        _close(got, ref[f"{agg}/stale/{q}"],
               comp == "daq" and stale.last_staleness == 0)
