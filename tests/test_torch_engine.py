"""The PyTorch port's serving path == the JAX package's, end to end.

``Engine(...).compile(g).session().query()`` on both packages with the
same graph and (carried-across) weights: embeddings within rtol 1e-4 /
atol 1e-5 (the bar of tests/test_aggregation.py), simulated latency,
throughput and bytes exactly equal. The JAX kernel path runs its Pallas
kernels in interpret mode; the port runs on the CPU (``device="cpu"``),
where its kernel wrappers take their plain versions.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.api import Engine as JEngine
from repro.gnn import datasets as jdata
from repro.gnn import models as jmodels
from repro_torch.api import Engine, UnknownComponentError
from repro_torch.api.registry import EXECUTORS
from repro_torch.gnn import datasets as tdata
from repro_torch.gnn import models as tmodels
from repro_torch.kernels import gather_aggregate as tga

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


CONFIGS = [(ex, kind, agg) for ex in ("sim", "single", "cloud")
           for kind in ("gcn", "sage") for agg in ("pallas", "segment_sum")]
CONFIGS += [(ex, "gat", "segment_sum") for ex in ("sim", "single", "cloud")]


@pytest.mark.parametrize("executor,kind,aggregation", CONFIGS)
def test_query_matches_jax(executor, kind, aggregation):
    g, gt, jparams, tparams = _setup(kind)
    knobs = dict(executor=executor, aggregation=aggregation,
                 compressor="daq")
    jr = JEngine((jparams, kind), **knobs).compile(g).session().query()
    plan = Engine((tparams, kind), device="cpu", **knobs).compile(gt)
    tr = plan.session().query()
    assert tr.embeddings.dtype == np.float32
    assert tr.embeddings.shape == jr.embeddings.shape
    np.testing.assert_allclose(tr.embeddings, jr.embeddings,
                               rtol=RTOL, atol=ATOL)
    assert tr.latency == jr.latency
    assert tr.throughput == jr.throughput
    assert tr.wire_bytes == jr.wire_bytes
    assert tr.exchange_bytes == jr.exchange_bytes
    assert tr.breakdown == jr.breakdown
    assert tr.backend == jr.backend


@pytest.mark.parametrize(
    "kind,aggregation",
    [(kind, agg) for kind in ("gcn", "sage") for agg in ("pallas",
                                                         "segment_sum")]
    + [("gat", "segment_sum")])
def test_execute_many_is_serial_execute_bitwise(kind, aggregation):
    _, gt, _, tparams = _setup(kind)
    sess = Engine((tparams, kind), device="cpu", compressor="none",
                  aggregation=aggregation).compile(gt).session()
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(3, gt.num_vertices, gt.feature_dim)).astype(
        np.float32)
    many = sess.execute_many(feats)
    assert len(many) == 3
    for b in range(3):
        assert np.array_equal(many[b], sess.execute(feats[b]))
    # A list of tables and a singleton batch take the same numbers.
    assert np.array_equal(sess.execute_many(list(feats))[1], many[1])
    assert np.array_equal(sess.execute_many(feats[:1])[0], many[0])


def test_gnn_module_and_generator_params_serve():
    _, gt, _, _ = _setup("gcn")
    module = tmodels.GNN("sage", [gt.feature_dim, 16, 2],
                         torch.Generator().manual_seed(0))
    plan = Engine(module, device="cpu", aggregation="pallas").compile(gt)
    res = plan.session().query()
    assert res.embeddings.shape == (gt.num_vertices, 2)
    assert np.isfinite(res.embeddings).all()
    assert plan.describe()["pipeline"]["device"] == "cpu"


def test_auto_aggregation_resolves_by_device():
    from repro_torch.runtime import bsp
    assert bsp.resolve_aggregation("auto", "gcn", device="cpu") == \
        "segment_sum"
    assert bsp.resolve_aggregation("auto", "gcn", device="cuda") == "pallas"
    assert bsp.resolve_aggregation("auto", "gat", device="cuda") == \
        "segment_sum"
    with pytest.raises(ValueError, match="available"):
        bsp.resolve_aggregation("zstd", "gcn")


def test_cpu_kernel_path_launches_no_kernel():
    _, gt, _, tparams = _setup("gcn")
    before = (tga.block_spmm.launches, tga.block_spmm_batched.launches)
    sess = Engine((tparams, "gcn"), device="cpu",
                  aggregation="pallas").compile(gt).session()
    sess.query()
    sess.execute_many(np.stack([sess.collect()] * 2))
    assert (tga.block_spmm.launches,
            tga.block_spmm_batched.launches) == before


def test_gat_with_pallas_raises_value_error():
    _, gt, _, tparams = _setup("gat")
    with pytest.raises(ValueError, match="pallas"):
        Engine((tparams, "gat"), device="cpu", aggregation="pallas")


def test_mesh_bsp_is_registered_and_validates_like_the_reference():
    """``mesh-bsp`` validates ``aggregation`` with the exchange as context,
    as the reference's Engine and Session do: the kernel path needs the
    ``halo`` exchange and a static-sum kind."""
    _, gt, _, gcn = _setup("gcn")
    _, _, _, gat = _setup("gat")
    assert "mesh-bsp" in EXECUTORS
    with pytest.raises(ValueError, match="halo"):
        Engine((gcn, "gcn"), device="cpu", executor="mesh-bsp",
               exchange="allgather", aggregation="pallas")
    with pytest.raises(ValueError, match="pallas"):
        Engine((gat, "gat"), device="cpu", executor="mesh-bsp",
               aggregation="pallas")
    # The single-program backends have no exchange to validate against.
    plan = Engine((gcn, "gcn"), device="cpu", executor="sim",
                  exchange="allgather", aggregation="pallas",
                  compressor="none").compile(gt)
    with pytest.raises(ValueError, match="halo"):
        plan.session(executor="mesh-bsp")
    # "auto" on the CPU resolves to segment_sum: no block shards are built.
    auto = Engine((gcn, "gcn"), device="cpu", executor="mesh-bsp",
                  aggregation="auto").compile(gt)
    assert auto.partitioned.local_csr is None
    with pytest.raises(UnknownComponentError, match="mesh-bsp"):
        Engine((gcn, "gcn"), device="cpu", executor="tpu-pod")


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    _, gt, _, tparams = _setup("gcn")
    with pytest.raises(RuntimeError, match="cuda"):
        Engine((tparams, "gcn")).compile(gt)


@pytest.mark.parametrize("knob", ["staleness_bound", "validate",
                                  "activation_cache", "failover",
                                  "fail_nodes", "compile_fleet",
                                  "server_faults"])
def test_knobs_outside_the_slice_raise_not_implemented(knob):
    _, gt, _, tparams = _setup("gcn")
    model = (tparams, "gcn")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if knob == "staleness_bound":
            Engine(model, device="cpu", exchange="halo_async",
                   staleness_bound=2)
        elif knob == "validate":
            Engine(model, device="cpu", validate="warn")
        else:
            eng = Engine(model, device="cpu", compressor="none")
            plan = eng.compile(gt)
            if knob == "activation_cache":
                plan.session(activation_cache=True)
            elif knob == "failover":
                plan.session().failover(None)
            elif knob == "fail_nodes":
                eng.fail_nodes(plan, 0)
            elif knob == "server_faults":
                plan.server(faults=[("crash", 0.1, "A0")])
            else:
                eng.compile_fleet(gt, {"a": (0.0, 0.0)})


def test_from_plan_and_session_overrides():
    _, gt, _, tparams = _setup("sage")
    plan = Engine((tparams, "sage"), device="cpu", compressor="none",
                  aggregation="pallas").compile(gt)
    again = Engine.from_plan(plan).compile(gt)
    assert again.config == plan.config
    assert np.array_equal(again.placement.assignment,
                          plan.placement.assignment)
    sess = plan.session(num_layers=1, aggregation="segment_sum",
                        executor="cloud")
    res = sess.query()
    assert res.embeddings.shape == (gt.num_vertices, 16)
    assert res.backend == "cloud" and res.exchange_bytes == 0
    assert isinstance(sess.adapt(), str)
