"""The port's ``mesh-bsp`` executor == the JAX package's, end to end.

The JAX reference runs in ONE subprocess for this module, with four forced
host devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``, so
the flag never leaks into this process). On the installed jax, the
reference's ``shard_map(..., check_rep=False)`` call on the kernel path
raises ``TypeError``: ``jax.shard_map`` takes ``check_vma`` instead. The
subprocess therefore rebinds ``repro.runtime.bsp._shard_map`` to a wrapper
that drops ``check_rep`` and passes ``check_vma=False``, inside that
process only; nothing under ``src/repro/`` changes.

It serves SIoT at scale 0.05, ``[F, 16, 8]``, ``cluster="1A+2B+1C"`` (four
fogs) through ``Engine(..., executor="mesh-bsp")`` for every
configuration in ``CONFIGS``: one ``query()`` and one ``execute_many`` of
B = 2. The port then serves the same configurations on the CPU with the
same weights and must give the simulated numbers and bytes exactly, the
f32-wire embeddings within rtol 1e-4 / atol 1e-5, and the DAQ-wire
embeddings within the reference's 8-bit bar (``tests/test_aggregation.py``:
``|d| <= 5e-2 * max(max|want|, 1)``). Across frameworks a second-layer
code can land one step apart where f32 rounding falls on a rounding
boundary, so the DAQ wire is not held to 1e-4; its first-layer codes are
bitwise (``tests/test_torch_daq.py``).
"""
import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
from filelock import FileLock

from repro_torch.api import Engine
from repro_torch.api.registry import EXECUTORS
from repro_torch.gnn import datasets as tdata
from repro_torch.gnn import models as tmodels
from repro_torch.runtime import bsp as tbsp

from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
DAQ_BAR = 5e-2
CLUSTER = "1A+2B+1C"

#: (kind, compressor, aggregation, exchange)
CONFIGS = [(kind, comp, agg, "halo") for kind in ("gcn", "sage")
           for comp in ("none", "daq") for agg in ("pallas", "segment_sum")]
CONFIGS += [("gat", "none", "segment_sum", "halo"),
            ("gat", "daq", "segment_sum", "halo"),
            ("gcn", "daq", "segment_sum", "allgather"),
            ("gat", "none", "segment_sum", "allgather")]
KERNEL_CONFIGS = [c for c in CONFIGS if c[2] == "pallas"]

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
    from repro.gnn import datasets, models

    configs = eval(sys.argv[2])
    g = datasets.load("siot", scale=0.05, seed=0)
    noise = np.random.default_rng(3).normal(scale=0.1,
                                            size=g.features.shape)
    out = {}
    for kind in sorted({c[0] for c in configs}):
        params = models.gnn_init(jax.random.PRNGKey(0), kind,
                                 [g.feature_dim, 16, 8])
        for i, p in enumerate(params):
            for k, v in p.items():
                out[f"{kind}/param/{i}/{k}"] = np.asarray(v)
    for kind, comp, agg, exchange in configs:
        tag = "/".join((kind, comp, agg, exchange))
        params = models.gnn_init(jax.random.PRNGKey(0), kind,
                                 [g.feature_dim, 16, 8])
        sess = Engine((params, kind), cluster=sys.argv[3], compressor=comp,
                      exchange=exchange, executor="mesh-bsp",
                      aggregation=agg).compile(g).session()
        res = sess.query()
        stack = np.stack([sess.collect(), sess.collect(g.features + noise)])
        many = sess.execute_many(stack)
        out[tag + "/embeddings"] = res.embeddings
        out[tag + "/stack"] = stack
        out[tag + "/many"] = np.stack(many)
        for key in ("latency", "throughput", "wire_bytes",
                    "exchange_bytes"):
            out[tag + "/" + key] = np.asarray(getattr(res, key))
    np.savez(sys.argv[1], **out)
    print("OK")
""")


def shared_npz(tmp_path_factory, name: str, build) -> dict:
    """``build(dir)`` -> the path of an npz, run once for this session:
    under xdist the first worker to take the lock builds it and the others
    read it (``tests/test_torch_dist.py`` reads this module's reference
    the same way)."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent           # the session's directory, shared
    path = base / f"{name}.npz"
    with FileLock(str(path) + ".lock"):
        if not path.exists():
            os.replace(build(tmp_path_factory.mktemp(name)), path)
    with np.load(path) as f:
        return dict(f)


def build_reference(tmp):
    path = tmp / "reference.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(path), repr(CONFIGS), CLUSTER],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK" in proc.stdout
    return path


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return shared_npz(tmp_path_factory, "mesh_reference", build_reference)


@functools.lru_cache(maxsize=None)
def _graph():
    return tdata.load("siot", scale=0.05, seed=0)


def _params(reference, kind):
    layers = {}
    for key, value in reference.items():
        if key.startswith(f"{kind}/param/"):
            _, _, i, name = key.split("/")
            layers.setdefault(int(i), {})[name] = value
    return tmodels.params_from_numpy([layers[i] for i in sorted(layers)])


def _session(reference, kind, comp, agg, exchange, **kw):
    return Engine((_params(reference, kind), kind), cluster=CLUSTER,
                  compressor=comp, exchange=exchange, executor="mesh-bsp",
                  aggregation=agg, device="cpu").compile(_graph()).session(
                      **kw)


def _assert_embeddings(got, want, daq_wire):
    assert got.dtype == np.float32 and got.shape == want.shape
    if daq_wire:
        err = float(np.abs(got - want).max())
        assert err <= DAQ_BAR * max(float(np.abs(want).max()), 1.0), err
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("config", CONFIGS, ids="-".join)
def test_mesh_query_and_batch_match_jax(reference, config):
    kind, comp, agg, exchange = config
    tag = "/".join(config)
    sess = _session(reference, *config)
    res = sess.query()
    daq_wire = comp == "daq" and agg == "pallas"
    _assert_embeddings(res.embeddings, reference[tag + "/embeddings"],
                       daq_wire)
    assert res.backend == "mesh-bsp"
    for key in ("latency", "throughput", "wire_bytes", "exchange_bytes"):
        assert getattr(res, key) == reference[tag + "/" + key].item(), key
    many = sess.execute_many(reference[tag + "/stack"])
    assert len(many) == 2
    for got, want in zip(many, reference[tag + "/many"]):
        _assert_embeddings(got, want, daq_wire)


@pytest.mark.parametrize("config", CONFIGS, ids="-".join)
def test_mesh_execute_many_is_serial_execute_bitwise(reference, config):
    sess = _session(reference, *config)
    stack = reference["/".join(config) + "/stack"]
    many = sess.execute_many(stack)
    for b in range(len(stack)):
        assert np.array_equal(many[b], sess.execute(stack[b]))


@pytest.mark.parametrize("config", KERNEL_CONFIGS, ids="-".join)
def test_mesh_kernel_path_runs_the_kernels(reference, config, monkeypatch):
    """One local and one halo product per layer and query, one batched
    launch each per layer for a batch: the DAQ wire's halo product is
    ``dequant_spmm``, else ``block_spmm``."""
    calls = {}

    def spy(name):
        inner = getattr(tbsp, name)

        def wrapper(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return inner(*args, **kwargs)
        monkeypatch.setattr(tbsp, name, wrapper)

    for name in ("block_spmm", "block_spmm_batched", "dequant_spmm",
                 "dequant_spmm_batched"):
        spy(name)
    kind, comp, agg, exchange = config
    sess = _session(reference, *config)
    sess.query()
    sess.execute_many(reference["/".join(config) + "/stack"])
    k = 2
    want = ({"block_spmm": k, "dequant_spmm": k, "block_spmm_batched": k,
             "dequant_spmm_batched": k} if comp == "daq" else
            {"block_spmm": 2 * k, "block_spmm_batched": 2 * k})
    assert calls == want


def test_adapted_mesh_session_rebuilds_with_blocks(reference, monkeypatch):
    """After ``adapt`` migrates vertices the session rebuilds its layout
    WITH the block-CSR shards and keeps serving on the kernel path, bitwise
    what ``bsp_infer`` gives on a layout built fresh from the adapted
    assignment."""
    sess = _session(reference, "gcn", "daq", "pallas", "halo",
                    adapt_every=1, lam=1.0, theta=0.0)
    before = sess.placement.assignment.copy()
    sess.query()
    assert sess.state.mode_history[-1] == "replan"
    after = sess.placement.assignment
    assert (after != before).any()
    halo_products = []
    inner = tbsp.dequant_spmm
    monkeypatch.setattr(tbsp, "dequant_spmm", lambda *a, **kw: (
        halo_products.append(1), inner(*a, **kw))[1])
    feats = sess.collect()
    got = sess.execute(feats)
    assert sess.partitioned().local_csr is not None
    assert len(halo_products) == 2
    g = _graph()
    fresh = tbsp.build_partitioned(g, after, build_blocks=True)
    want = tbsp.bsp_infer(list(sess.plan.model.params), "gcn",
                          tbsp.dataclasses.replace(g, features=feats), after,
                          device="cpu", aggregation="pallas",
                          halo_quant=True, pg=fresh)
    assert np.array_equal(got, want)


def test_with_features_keeps_the_device_operands(reference):
    sess = _session(reference, "sage", "none", "pallas", "halo")
    sess.query()
    pg = sess.partitioned()
    cached = dict(pg.device_cache)
    assert {what for _, what in cached} >= {"layout", "csr"}
    again = pg.with_features(_graph().features)
    assert again.device_cache is pg.device_cache
    sess.query()
    assert all(pg.device_cache[k] is v for k, v in cached.items())


def test_capture_entry_points_return_the_plain_run_bitwise(reference):
    """``bsp_infer_capture(_many)`` (and ``run_layers`` over them) return
    every layer; the last is bitwise the plain ``bsp_infer(_many)`` on
    both aggregation paths, with and without the DAQ wire."""
    g = _graph()
    params = list(_params(reference, "sage"))
    rng = np.random.default_rng(4)
    stack = np.stack([g.features, g.features + rng.normal(
        scale=0.1, size=g.features.shape).astype(np.float32)])
    for agg, hq in (("pallas", True), ("pallas", False),
                    ("segment_sum", False)):
        sess = _session(reference, "sage", "daq" if hq else "none", agg,
                        "halo")
        pg = sess.partitioned()
        assign = sess.placement.assignment
        kw = dict(device="cpu", aggregation=agg, halo_quant=hq)
        layers = tbsp.bsp_infer_capture(params, "sage", g, assign, pg=pg,
                                        **kw)
        assert [a.shape for a in layers] == [(g.num_vertices, 16),
                                             (g.num_vertices, 8)]
        assert np.array_equal(layers[-1], tbsp.bsp_infer(
            params, "sage", g, assign, pg=pg, **kw))
        many = tbsp.bsp_infer_capture_many(params, "sage", stack, pg, **kw)
        assert np.array_equal(many[-1], tbsp.bsp_infer_many(
            params, "sage", stack, pg, **kw))
        backend = EXECUTORS.resolve("mesh-bsp")
        got = backend.run_layers(sess.plan, stack[1], assign, pg, "halo",
                                 aggregation=agg)
        assert np.array_equal(got[-1], sess.execute(stack[1]))
