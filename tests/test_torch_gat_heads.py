"""The multi-head GAT (kind ``gat_heads``: the PPI model of Velickovic et
al., ICLR 2018, at cut widths) through the port's normal path, on the CPU.

Heads ``[2, 2, 3]`` of widths ``[8, 8, 5]``: two hidden layers of two
concatenated heads (the second with the identity skip, its input as wide
as its output) and a last layer of three averaged heads. Served through
``Engine(...).session().execute_many`` on ``sim``, ``single`` and the
folded six-fog ``mesh-bsp``, it must match the plain float64 reference
(``plain_gat_heads``) at the repository's rtol 1e-4 / atol 1e-5, a batch
must be its serial runs bit for bit, and gloo ranks the folded run.

The per-head weighted sum (``kernels.segment_sum`` with ``w`` [E, H]) is
on the CPU its plain version, which must give the floats of a serial
``index_add_`` a head; on the card ``headed_sum_kernel`` must give the
plain version's (tests marked ``cuda``). The single-head ``gat`` runs the
same layer at H = 1 and must keep the arithmetic it had, written out
here.
"""
import functools
import importlib.util
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import _torch_dist_ranks as ranks
import plain_gat_heads as plain
from repro_torch.api import Engine
from repro_torch.gnn import datasets as tdata
from repro_torch.gnn import layers as tlayers
from repro_torch.gnn import models as tmodels
from repro_torch.kernels import segment_sum as tseg
from repro_torch.runtime import dist as fog_dist

from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

HEADS, DIMS = ranks.GAT_HEADS, ranks.GAT_HEAD_DIMS
B = 3
CLUSTER = "1A+4B+1C"          # six fogs, as the benchmark folds them


@functools.lru_cache(maxsize=None)
def _graph():
    return tdata.load("siot", scale=0.03, seed=0)


def _widths(f):
    return [f, HEADS[0] * DIMS[0], HEADS[1] * DIMS[1], DIMS[2]]


def _params(g=None, seed=0):
    g = g or _graph()
    return tmodels.gnn_init(torch.Generator().manual_seed(seed), "gat_heads",
                            _widths(g.feature_dim), heads=HEADS)


def _stack(g=None, b=B, seed=1):
    g = g or _graph()
    rng = np.random.default_rng(seed)
    return (g.features[None] + rng.normal(
        scale=0.5, size=(b,) + g.features.shape)).astype(np.float32)


def _session(executor, params=None, kind="gat_heads", cluster=CLUSTER):
    return Engine((params or _params(), kind), cluster=cluster,
                  compressor="none", exchange="halo", executor=executor,
                  aggregation="segment_sum", device="cpu"
                  ).compile(_graph()).session()


def _bits(x):
    return torch.as_tensor(np.ascontiguousarray(x)).view(torch.int32)


def test_the_layers_lay_out_their_heads():
    g = _graph()
    params = _params()
    f = g.feature_dim
    assert [tuple(p["w"].shape) for p in params] == [(f, 16), (16, 16),
                                                     (16, 15)]
    assert [tuple(p["att_src"].shape) for p in params] == [(2, 8), (2, 8),
                                                           (3, 5)]
    assert all(p["att_dst"].shape == p["att_src"].shape for p in params)
    with pytest.raises(ValueError, match="3 head counts for 2 layers"):
        tmodels.gnn_init(torch.Generator(), "gat_heads", [4, 6, 2],
                         heads=[2, 2, 2])
    with pytest.raises(ValueError, match="divide"):
        tmodels.gnn_init(torch.Generator(), "gat_heads", [4, 6, 2],
                         heads=[4, 2])


def test_weights_drawn_without_heads_are_refused():
    # every way of drawing weights goes through gnn_init: none may draw a
    # one-head gat_heads by default
    with pytest.raises(ValueError, match="need heads"):
        tmodels.gnn_init(torch.Generator(), "gat_heads", [4, 6, 2])
    with pytest.raises(ValueError, match="need heads"):
        tmodels.GNN("gat_heads", [4, 6, 2], torch.Generator())
    with pytest.raises(ValueError, match="need heads"):
        tmodels.train_node_classifier(torch.Generator(), "gat_heads",
                                      _graph(), hidden=6, steps=1)


@pytest.mark.parametrize("executor", ["sim", "single", "mesh-bsp"])
def test_serves_the_plain_reference(executor):
    g, params, stack = _graph(), _params(), _stack()
    got = _session(executor, params).execute_many(stack)
    assert len(got) == B
    for x, out in zip(stack, got):
        want = plain.forward(params, x, g.senders, g.receivers,
                             g.num_vertices)
        assert out.shape == (g.num_vertices, DIMS[2])
        np.testing.assert_allclose(out, want.numpy(), rtol=1e-4, atol=1e-5)


def test_the_skip_and_the_mean_are_in_the_answer():
    """Served without the skip (kind ``gat``: the same multi-head layer)
    the answer moves far past the tolerance, and the last layer's heads
    are averaged, not concatenated."""
    g, params, stack = _graph(), _params(), _stack(b=1)
    with_skip = _session("sim", params).execute_many(stack)[0]
    without = _session("sim", params, kind="gat").execute_many(stack)[0]
    assert with_skip.shape == without.shape == (g.num_vertices, DIMS[2])
    assert np.abs(with_skip - without).max() > 1e-2


@pytest.mark.parametrize("executor", ["sim", "mesh-bsp"])
def test_a_batch_is_its_serial_runs_bitwise(executor):
    sess = _session(executor)
    stack = _stack()
    batched = sess.execute_many(stack)
    for x, out in zip(stack, batched):
        assert torch.equal(_bits(out), _bits(sess.execute(x)))


def test_ranks_serve_the_folded_run_bitwise():
    """Four gloo ranks, one fog each, serve a batch; every rank returns
    the folded run's floats."""
    g = ranks.graph()
    params = tmodels.gnn_init(torch.Generator().manual_seed(4), "gat_heads",
                              _widths(g.feature_dim), heads=HEADS)
    inputs = {f"param/{i}/{k}": v.numpy() for i, p in enumerate(params)
              for k, v in p.items()}
    inputs["stack"] = _stack(g, b=2, seed=3)
    cluster = "1A+2B+1C"
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/inputs.npz"
        np.savez(path, **inputs)
        fog_dist.spawn(ranks.serve_gat_heads_rank, 4, tmp, path, cluster,
                       tmp)
        got = []
        for r in range(4):
            with np.load(f"{tmp}/gat_heads{r}.npz") as f:
                got.append(f["many"])
    want = ranks.gat_heads_many(inputs, cluster, g)
    for r, many in enumerate(got):
        assert torch.equal(_bits(many), _bits(want)), r


def _sum_inputs(seed, v, e, heads, d):
    """Random receivers over the first v - 2 vertices, every 7th edge a
    masked padding edge, a source table of rows of H * D floats spanning
    12 decades (every 5th row -0.0) and per-head weights."""
    rng = np.random.default_rng(seed)
    r = torch.as_tensor(rng.integers(0, v - 2, e).astype(np.int32))
    mask = np.ones(e, np.float32)
    mask[::7] = 0.0
    rows = 2 * v
    x = rng.normal(size=(rows, heads * d)) * 10.0 ** rng.integers(
        -6, 6, (rows, 1))
    x[::5] = -0.0
    idx_all = torch.as_tensor(rng.integers(0, rows, e).astype(np.int32))
    w = torch.as_tensor(rng.uniform(-1, 1, (e, heads)).astype(np.float32))
    order, offsets = tseg.receiver_order(r, v, torch.as_tensor(mask))
    return (torch.as_tensor(x.astype(np.float32)), r, idx_all, w, order,
            offsets, torch.as_tensor(mask))


@pytest.mark.parametrize("heads,d", [(2, 8), (3, 5), (4, 1), (6, 7),
                                     (1, 9)])
def test_the_per_head_sum_is_a_serial_index_add_a_head(heads, d):
    x, r, idx_all, w, order, offsets, mask = _sum_inputs(heads, 40, 900,
                                                        heads, d)
    v = offsets.shape[0] - 1
    idx = idx_all[order.long()]
    before = (tseg.segment_sum.launches, tseg.segment_sum.headed_launches)
    got = tseg.segment_sum(x, order, offsets, idx=idx, w=w)
    assert (tseg.segment_sum.launches,
            tseg.segment_sum.headed_launches) == before   # no launch here
    kept = mask > 0
    want = torch.zeros((v, heads * d))
    for k in range(heads):
        cols = slice(k * d, (k + 1) * d)
        msg = x[idx_all.long()][:, cols] * w[:, k:k + 1]
        want[:, cols].index_add_(0, r.long()[kept], msg[kept])
    assert torch.equal(_bits(got), _bits(want))


def test_the_per_head_sum_refuses_weights_that_do_not_cut_the_row():
    x, _, idx_all, w, order, offsets, _ = _sum_inputs(0, 20, 100, 3, 5)
    idx = idx_all[order.long()]
    with pytest.raises(ValueError, match="dividing"):
        tseg.segment_sum(x[:, :14], order, offsets, idx=idx, w=w)
    with pytest.raises(ValueError, match="dividing"):
        tseg.segment_sum(x[:, 0], order, offsets, idx=idx, w=w)


def test_the_per_head_sum_has_its_gradients():
    x, _, idx_all, w, order, offsets, _ = _sum_inputs(2, 12, 60, 3, 2)
    idx = idx_all[order.long()]
    tr = tseg.Transposed(order, offsets, idx, x.shape[0])
    xd = x.double().requires_grad_()
    wd = w.double().requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, b: tseg.segment_sum(a, order, offsets, idx=idx, w=b,
                                      transposed=lambda: tr),
        (xd, wd))


def _single_head_layer(params, h, edges, *, activation=F.elu, h_src=None):
    """The port's single-head GAT layer as it was before heads: the
    arithmetic ``gat`` must keep, op for op."""
    wh = h @ params["w"]
    wh_src = wh if h_src is None else h_src @ params["w"]
    alpha_src = (wh_src * params["att_src"]).sum(-1)
    alpha_dst = (wh * params["att_dst"]).sum(-1)
    v = edges.num_vertices
    if h_src is None:
        edges = edges.self_looped
    s, r, m = edges.senders, edges.receivers, edges.mask
    logits = F.leaky_relu(alpha_src[s] + alpha_dst[r], 0.2)
    logits = torch.where(m > 0, logits, -torch.inf)
    seg_max = torch.full((v,), -torch.inf, dtype=logits.dtype)
    seg_max = seg_max.scatter_reduce(0, r.long(), logits, "amax",
                                     include_self=False)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    ex = torch.where(m > 0, torch.exp(logits - seg_max[r]), 0.0)
    denom = tlayers._segment_sum(ex, edges)
    coef = ex / torch.clamp_min(denom[r], 1e-16)
    a = tlayers._segment_sum(wh_src, edges, idx=edges.gather, w=coef)
    return activation(a) if activation is not None else a


def test_one_head_is_the_single_head_arithmetic():
    g = _graph()
    old_draw = torch.Generator().manual_seed(7)
    glorot = tlayers._glorot
    want_params = [{"w": glorot(old_draw, (fi, fo)),
                    "att_src": glorot(old_draw, (1, fo)),
                    "att_dst": glorot(old_draw, (1, fo))}
                   for fi, fo in ((g.feature_dim, 16), (16, 4))]
    params = tmodels.gnn_init(torch.Generator().manual_seed(7), "gat",
                              [g.feature_dim, 16, 4])
    for p, q in zip(params, want_params):
        assert all(torch.equal(p[k], q[k]) for k in q)
    edges = tlayers.EdgeList.from_graph(g)
    h = torch.as_tensor(_stack(b=1)[0])
    layer = tlayers.LAYER_FNS["gat"][1]
    for last in (False, True):
        kw = {"activation": None} if last else {}
        got = layer(params[0], h, edges, **kw)
        want = _single_head_layer(params[0], h, edges, **kw)
        assert torch.equal(_bits(got), _bits(want))
    # over another source table (the mesh's local | halo rows)
    h_src = torch.cat([h, h[:7] * 0.5])
    looped = edges.self_looped
    got = layer(params[0], h, looped, h_src=h_src)
    want = _single_head_layer(params[0], h, looped, h_src=h_src)
    assert torch.equal(_bits(got), _bits(want))


def _profiled(fn):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    spans = sorted(((e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events() if e.name.startswith("fog.")),
                   key=lambda s: (s[0], -s[1]))
    parents = []
    for i, (s, e, _) in enumerate(spans):
        holders = [o for j, o in enumerate(spans)
                   if j != i and o[0] <= s and e <= o[1]]
        parents.append(max(holders, key=lambda o: o[0])[2]
                       if holders else None)
    return out, spans, parents


def test_a_traced_batch_records_the_attention_and_the_per_head_sums():
    """On the mesh, one ``fog.attention`` a layer and example inside its
    ``fog.layer``, holding the edge softmax's ``fog.kernel.edge_softmax``
    (no segment sum: the denominators are the softmax's own); one
    ``fog.kernel.headed_sum`` a layer and example beside it. Tracing moves
    no answer and no counter."""
    sess = _session("mesh-bsp")
    stack = _stack()
    counters = (tseg.segment_sum.launches, tseg.segment_sum.headed_launches)
    plain_out = sess.execute_many(stack)
    traced, spans, parents = _profiled(lambda: sess.execute_many(stack))
    assert (tseg.segment_sum.launches,
            tseg.segment_sum.headed_launches) == counters
    for a, b in zip(plain_out, traced):
        assert torch.equal(_bits(a), _bits(b))
    steps = len(HEADS) * B
    names = [s[2] for s in spans]
    assert names.count("fog.layer") == steps
    assert names.count("fog.attention") == steps
    assert names.count("fog.kernel.headed_sum") == steps
    assert names.count("fog.kernel.edge_softmax") == steps
    assert names.count("fog.kernel.segment_sum") == 0
    for (_, _, name), parent in zip(spans, parents):
        if name in ("fog.attention", "fog.kernel.headed_sum"):
            assert parent == "fog.layer", name
        if name == "fog.kernel.edge_softmax":
            assert parent == "fog.attention"


@pytest.mark.cuda
@pytest.mark.parametrize("heads,d", [(4, 256), (6, 121), (2, 8), (3, 5),
                                     (4, 1)])
def test_the_kernel_is_the_plain_version(heads, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU path")
    dev = torch.device("cuda")
    x, r, idx_all, w, order, offsets, _ = _sum_inputs(heads + d, 300, 30_000,
                                                      heads, d)
    # a hub: a third of the edges into receiver 5, past the long threshold
    r[::3] = 5
    order, offsets = tseg.receiver_order(r, 300)
    idx = idx_all[order.long()]
    long = tseg.LongSegments(offsets, heads * d)
    assert long.ids.numel() >= 1
    want = tseg.segment_sum(x, order, offsets, idx=idx, w=w, long=long)
    on = [t.to(dev) for t in (x, order, offsets, idx, w)]
    long_dev = tseg.LongSegments(on[2], heads * d)
    before = (tseg.segment_sum.launches, tseg.segment_sum.headed_launches)
    got = tseg.segment_sum(on[0], on[1], on[2], idx=on[3], w=on[4],
                           long=long_dev)
    torch.cuda.synchronize()
    assert (tseg.segment_sum.launches - before[0],
            tseg.segment_sum.headed_launches - before[1]) == (1, 1)
    assert torch.equal(_bits(got.cpu()), _bits(want))


def test_chip_smoke_headed_bound_is_pinned():
    """The yardstick of the per-head sum's time on the card: ``chip_smoke.
    headed_bound`` counts each source row once, an index, an order entry
    and H weights an entry, the offsets and the output once at the HBM
    rate, here at the cell's first layer (144,576 source rows, 1,399,590
    entries into 84,960 rows of 4 x 256 floats)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    ms, by = chip_smoke.headed_bound(144_576, 1_024, 1_399_590, 84_960, 4)
    nbytes = 4 * (144_576 * 1_024 + 1_399_590 * 6 + 84_961
                  + 84_960 * 1_024)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)
