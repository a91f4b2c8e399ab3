"""Host-side numpy code of the PyTorch port == the JAX package, exactly.

Datasets, block-CSR layouts, fingerprints, partitions, placements, codecs,
simulated timings and per-partition buffers are host numpy in both
packages, so they must agree bit for bit (``np.array_equal`` / ``==``).
"""
import dataclasses

import numpy as np
import pytest

from repro.api import COMPRESSORS as JCOMPRESSORS
from repro.api import PLACEMENTS as JPLACEMENTS
from repro.core import compression as jcomp
from repro.core import partition as jpart
from repro.core import simulation as jsim
from repro.gnn import datasets as jdata
from repro.kernels import gather_aggregate as jga
from repro.kernels import ops as jops
from repro.runtime import bsp as jbsp
from repro_torch.api import COMPRESSORS as TCOMPRESSORS
from repro_torch.api import PLACEMENTS as TPLACEMENTS
from repro_torch.core import compression as tcomp
from repro_torch.core import partition as tpart
from repro_torch.core import profiler as tprof
from repro_torch.core import simulation as tsim
from repro_torch.gnn import datasets as tdata
from repro_torch.kernels import gather_aggregate as tga
from repro_torch.kernels import ops as tops
from repro_torch.runtime import bsp as tbsp

from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)


def _assert_tree_equal(a, b, path="root"):
    """Recursive exact equality over dataclasses, arrays and scalars."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _assert_tree_equal(getattr(a, f.name), getattr(b, f.name),
                               f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def _scale(name):
    return 0.01 if name.startswith("rmat") else 0.05


@pytest.mark.parametrize("name", sorted(jdata.TABLE_III))
def test_datasets_load_bit_equal(name):
    a = jdata.load(name, scale=_scale(name), seed=3)
    b = tdata.load(name, scale=_scale(name), seed=3)
    _assert_tree_equal(a, b)


def test_pems_window_bit_equal():
    _assert_tree_equal(jdata.load_pems_window(scale=0.5, seed=2),
                       tdata.load_pems_window(scale=0.5, seed=2))


@pytest.mark.parametrize("rectangular", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_build_block_csr_bit_equal(rectangular, weighted):
    rng = np.random.default_rng(5)
    n, e = 300, 2000
    src_space = 700 if rectangular else n
    s = rng.integers(0, src_space, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    w = rng.uniform(0.1, 1.0, e).astype(np.float32) if weighted else None
    _assert_tree_equal(list(jga.build_block_csr(s, r, n, weights=w)),
                       list(tga.build_block_csr(s, r, n, weights=w)))
    for f in (8, 52, 128, 200, 384):
        assert jga.padded_feature_dim(f) == tga.padded_feature_dim(f)


def test_graph_fingerprint_hex_equal():
    g = jdata.load("siot", scale=0.05, seed=0)
    gt = tdata.load("siot", scale=0.05, seed=0)
    assert jops.graph_fingerprint(g) == tops.graph_fingerprint(gt)
    assert len(tops.graph_fingerprint(gt)) == 32


@pytest.mark.parametrize("n", [2, 4, 6])
def test_bgp_assignment_bit_equal(n):
    g = jdata.load("siot", scale=0.05, seed=1)
    gt = tdata.load("siot", scale=0.05, seed=1)
    w = np.linspace(1.0, 2.0, n)
    w = w / w.sum()
    a = jpart.bgp(g, n, weights=w, seed=4)
    b = tpart.bgp(gt, n, weights=w, seed=4)
    assert np.array_equal(a, b)
    sa, sb = jpart.partition_stats(g, a), tpart.partition_stats(gt, b)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert np.array_equal(sa[k], sb[k]), k
    # The optional METIS partitioner is registered in both or in neither.
    assert ("metis" in jpart.PARTITIONERS) == ("metis" in tpart.PARTITIONERS)


def _clusters(spec="1A+4B+1C", network="wifi", scale=0.05):
    g = jdata.load("siot", scale=scale, seed=0)
    gt = tdata.load("siot", scale=scale, seed=0)
    cj = jsim.make_cluster(spec, network, g, hidden=16, k_layers=2, seed=0)
    ct = tsim.make_cluster(spec, network, gt, hidden=16, k_layers=2, seed=0)
    return g, gt, cj, ct


@pytest.mark.parametrize("strategy", ["iep", "metis+greedy", "random"])
def test_placement_and_makespan_bit_equal(strategy):
    g, gt, cj, ct = _clusters()
    fj, ft = cj.fog_specs(seed=0), ct.fog_specs(seed=0)
    _assert_tree_equal(fj, ft)
    pj = JPLACEMENTS.resolve(strategy).place(g, fj, k_layers=2,
                                              sync_cost=cj.sync_cost, seed=0)
    pt = TPLACEMENTS.resolve(strategy).place(gt, ft, k_layers=2,
                                              sync_cost=ct.sync_cost, seed=0)
    _assert_tree_equal(pj, pt)
    assert pj.est_makespan == pt.est_makespan


@pytest.mark.parametrize("codec", ["none", "daq", "daq_noll", "uniform8"])
def test_compressor_roundtrip_bit_equal(codec):
    g = jdata.load("siot", scale=0.05, seed=0)
    feats = np.random.default_rng(1).normal(
        size=(g.num_vertices, g.feature_dim))
    a = JCOMPRESSORS.resolve(codec).roundtrip(feats, g.degrees)
    b = TCOMPRESSORS.resolve(codec).roundtrip(feats, g.degrees)
    assert a.dtype == b.dtype == np.float32
    assert np.array_equal(a, b)
    if codec.startswith("daq"):
        pa = jcomp.daq_pack(feats, g.degrees)
        pb = tcomp.daq_pack(feats, g.degrees)
        assert pa.nbytes(True) == pb.nbytes(True)
        assert np.array_equal(jcomp.daq_unpack(pa), tcomp.daq_unpack(pb))


@pytest.mark.parametrize("pipeline", ["multi", "single", "cloud"])
@pytest.mark.parametrize("compress", [None, "daq", "uniform8"])
def test_simulate_latency_and_wire_bytes_bit_equal(pipeline, compress):
    g, gt, cj, ct = _clusters(network="4g")
    pj = JPLACEMENTS.resolve("iep").place(g, cj.fog_specs(seed=0),
                                          k_layers=2, sync_cost=cj.sync_cost)
    pt = TPLACEMENTS.resolve("iep").place(gt, ct.fog_specs(seed=0),
                                          k_layers=2, sync_cost=ct.sync_cost)
    for batch in (1, 4):
        rj = jsim.simulate(pipeline, cj, pj, compress=compress,
                           batch_size=batch)
        rt = tsim.simulate(pipeline, ct, pt, compress=compress,
                           batch_size=batch)
        _assert_tree_equal(rj, rt)
        assert rj.breakdown() == rt.breakdown()
    assert np.array_equal(jsim.measured_exec_times(cj, pj),
                          tsim.measured_exec_times(ct, pt))


@pytest.mark.parametrize("n", [3, 6])
def test_build_partitioned_bit_equal(n):
    g = jdata.load("siot", scale=0.05, seed=2)
    gt = tdata.load("siot", scale=0.05, seed=2)
    assign = jpart.bgp(g, n, seed=0)
    a = jbsp.build_partitioned(g, assign, build_blocks=True)
    b = tbsp.build_partitioned(gt, assign, build_blocks=True)
    assert b.local_csr is not None and b.halo_csr is not None
    _assert_tree_equal(a, b)
    feats = np.random.default_rng(0).normal(
        size=(3, g.num_vertices, g.feature_dim)).astype(np.float32)
    assert np.array_equal(a.feature_stack(feats), b.feature_stack(feats))
    _assert_tree_equal(a.with_features(feats[0]), b.with_features(feats[0]))
    for ex in ("halo", "allgather", "halo_async"):
        assert (jbsp.EXCHANGES.resolve(ex).bytes_per_sync(a, 52)
                == tbsp.EXCHANGES.resolve(ex).bytes_per_sync(b, 52))
        assert (jbsp.exchange_bytes(a, 52, ex, 1, 8)
                == tbsp.exchange_bytes(b, 52, ex, 1, 8))
        assert (jbsp.EXCHANGES.resolve(ex).recovery_cost(2, 5e-3)
                == tbsp.EXCHANGES.resolve(ex).recovery_cost(2, 5e-3))


def test_time_gnn_measurer_runs_on_cpu():
    import torch
    from repro_torch.gnn import models
    gt = tdata.load("siot", scale=0.05, seed=0)
    params = models.gnn_init(torch.Generator().manual_seed(0), "gcn",
                             [gt.feature_dim, 8, 2])
    measure = tprof.time_gnn_measurer(gt, "gcn", params, repeats=1,
                                      device="cpu")
    t = measure(np.arange(100))
    assert isinstance(t, float) and t > 0.0
