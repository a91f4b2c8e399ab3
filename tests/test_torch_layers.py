"""GNN layers and models of the PyTorch port vs the JAX package.

The JAX package's ``gnn_init`` makes the weights; ``params_from_numpy``
carries them across. Device numerics must agree within rtol 1e-4 /
atol 1e-5 (the bar of tests/test_aggregation.py). Inside the port, the
stacked [B, V, F] dense tail must be bitwise the per-example loop.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.gnn import datasets as jdata
from repro.gnn import layers as jlayers
from repro.gnn import models as jmodels
from repro_torch.gnn import datasets as tdata
from repro_torch.gnn import layers as tlayers
from repro_torch.gnn import models as tmodels

from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-4, 1e-5


@functools.lru_cache(maxsize=None)
def _setup(kind):
    g = jdata.load("siot", scale=0.05, seed=0)
    gt = tdata.load("siot", scale=0.05, seed=0)
    dims = [g.feature_dim, 16, 8]
    jparams = jmodels.gnn_init(jax.random.PRNGKey(1), kind, dims)
    nparams = [{k: np.asarray(v) for k, v in p.items()} for p in jparams]
    h = np.random.default_rng(2).normal(
        size=(g.num_vertices, g.feature_dim)).astype(np.float32)
    return g, gt, jparams, tmodels.params_from_numpy(nparams), h


@pytest.mark.parametrize("kind", ["gcn", "sage", "gat"])
@pytest.mark.parametrize("last", [False, True])
def test_single_layer_matches_jax(kind, last):
    g, gt, jparams, tparams, h = _setup(kind)
    jedges = jlayers.EdgeList.from_graph(g)
    tedges = tlayers.EdgeList.from_graph(gt)
    _, jfn = jlayers.LAYER_FNS[kind]
    _, tfn = tlayers.LAYER_FNS[kind]
    kw = {"activation": None} if last else {}
    want = np.asarray(jfn(jparams[0], jnp.asarray(h), jedges, **kw))
    got = tfn(tparams[0], torch.as_tensor(h), tedges, **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["gcn", "sage", "gat"])
def test_gnn_apply_matches_jax(kind):
    g, gt, jparams, tparams, h = _setup(kind)
    want = np.asarray(jmodels.gnn_apply(jparams, kind, jnp.asarray(h),
                                        jlayers.EdgeList.from_graph(g)))
    edges = tlayers.EdgeList.from_graph(gt)
    got = tmodels.gnn_apply(tparams, kind, torch.as_tensor(h), edges)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # nn.Module wrapper: same numbers, same parameter layout.
    module = tmodels.GNN.from_params(tparams, kind)
    assert torch.equal(module(torch.as_tensor(h), edges), got)
    outs = tmodels.gnn_apply_layers(tparams, kind, torch.as_tensor(h), edges)
    assert len(outs) == 2 and torch.equal(outs[-1], got)


def test_padded_edge_list_and_masked_degree_match_jax():
    g, gt, *_ = _setup("gcn")
    je = jlayers.EdgeList.from_graph(g, pad_to=g.num_edges + 37)
    te = tlayers.EdgeList.from_graph(gt, pad_to=gt.num_edges + 37)
    for a, b in zip(je[:3], te[:3]):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert te.senders.dtype == torch.int32 and te.mask.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(jlayers.masked_degree(je)),
                                  tlayers.masked_degree(te).numpy())
    h = np.random.default_rng(4).normal(size=(g.num_vertices, 5)).astype(
        np.float32)
    for agg in ("aggregate_sum", "aggregate_mean"):
        want = np.asarray(getattr(jlayers, agg)(jnp.asarray(h), je))
        got = getattr(tlayers, agg)(torch.as_tensor(h), te).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["gcn", "sage"])
@pytest.mark.parametrize("last", [False, True])
def test_apply_layer_with_sum_matches_jax_and_batched_is_serial(kind, last):
    g, gt, jparams, tparams, h = _setup(kind)
    jedges = jlayers.EdgeList.from_graph(g)
    tedges = tlayers.EdgeList.from_graph(gt)
    a = np.array(jlayers.aggregate_sum(jnp.asarray(h), jedges))
    want = np.asarray(jlayers.apply_layer_with_sum(
        kind, jparams[0], jnp.asarray(h), jedges, jnp.asarray(a), last=last))
    got = tlayers.apply_layer_with_sum(kind, tparams[0], torch.as_tensor(h),
                                       tedges, torch.as_tensor(a), last=last)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # The stacked [B, V, F] form is bitwise the per-example loop.
    rng = np.random.default_rng(5)
    hs = torch.as_tensor(rng.normal(size=(3,) + h.shape).astype(np.float32))
    sums = torch.stack([tlayers.aggregate_sum(x, tedges) for x in hs])
    stacked = tlayers.apply_layer_with_sum(kind, tparams[0], hs, tedges,
                                           sums, last=last)
    for b in range(3):
        assert torch.equal(stacked[b], tlayers.apply_layer_with_sum(
            kind, tparams[0], hs[b], tedges, sums[b], last=last))


def test_gat_isolated_vertex_softmax_guard():
    """A receiver with no incoming edge keeps -inf under the segment max;
    the isfinite guard must zero it (no NaN) exactly as the JAX layer."""
    g, gt, jparams, tparams, h = _setup("gat")
    keep = g.receivers != 0                      # vertex 0 loses its in-edges
    je = jlayers.EdgeList(jnp.asarray(g.senders[keep]),
                          jnp.asarray(g.receivers[keep]),
                          jnp.ones(int(keep.sum()), jnp.float32),
                          g.num_vertices)
    te = tlayers.EdgeList(torch.as_tensor(g.senders[keep]),
                          torch.as_tensor(g.receivers[keep]),
                          torch.ones(int(keep.sum())), g.num_vertices)
    hsrc = np.random.default_rng(6).normal(size=h.shape).astype(np.float32)
    want = np.asarray(jlayers.gat_layer(jparams[0], jnp.asarray(h), je,
                                        h_src=jnp.asarray(hsrc)))
    got = tlayers.gat_layer(tparams[0], torch.as_tensor(h), te,
                            h_src=torch.as_tensor(hsrc))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_gnn_init_and_accuracy():
    gen = torch.Generator().manual_seed(0)
    params = tmodels.gnn_init(gen, "sage", [52, 64, 2])
    assert [tuple(p["w"].shape) for p in params] == [(104, 64), (128, 2)]
    assert all(v.dtype == torch.float32 for p in params for v in p.values())
    again = tmodels.gnn_init(torch.Generator().manual_seed(0), "sage",
                             [52, 64, 2])
    assert all(torch.equal(p["w"], q["w"]) for p, q in zip(params, again))
    logits = torch.tensor([[0.1, 0.9], [0.8, 0.2], [0.3, 0.7]])
    labels = torch.tensor([1, 0, 0])
    want = float(jmodels.accuracy(jnp.asarray(logits.numpy()),
                                  jnp.asarray(labels.numpy())))
    assert float(tmodels.accuracy(logits, labels)) == pytest.approx(want)
