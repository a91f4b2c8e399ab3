"""The port's fixed-order segment sum (``kernels.segment_sum``), its fused
gather-and-sum over the source table, and the edge lists that carry its
order, gather index, long segments and degrees.

On the CPU the wrapper runs its plain version, which must give exactly the
floats of a serial ``index_add_`` into zeros in edge order: duplicate
receivers, padding edges (masked to ±0 messages, which the order leaves
out), empty segments and -0.0 messages included. The GNN layers that sum
through it keep those floats, and the self-looped edge list of GAT is the
reference's concatenation.
The fused form (``idx``, ``w``) must be bitwise the old composition
(messages ``src[s] * mask (* w)`` over every edge, then the sum), and the
layers must match the JAX package at rtol 1e-4 / atol 1e-5 and the
pre-fusion port bitwise.
The CUDA kernel is held to the same floats on the card by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.gnn import layers as jlayers
from repro.gnn import models as jmodels
from repro_torch.api import Engine
from repro_torch.gnn import datasets as tdata
from repro_torch.gnn import layers as tlayers
from repro_torch.gnn import models as tmodels
from repro_torch.kernels import ref
from repro_torch.kernels import segment_sum as tseg
from repro_torch.runtime import bsp

from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)


def _graph(seed: int, v: int, e: int, f: int):
    """Random receivers over the first v - 3 vertices (the last three stay
    empty), messages spanning 16 decades, every 5th message -0.0 and every
    7th a padding edge's message, multiplied by its mask 0 as the layers
    do (so -0.0 where it was negative). Returns receivers, messages, mask."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, v - 3, e).astype(np.int32)
    x = rng.normal(size=(e, f)) * 10.0 ** rng.integers(-8, 8, (e, 1))
    x = x.astype(np.float32)
    x[::5] = -0.0
    mask = np.ones(e, np.float32)
    mask[::7] = 0.0
    x = x * mask[:, None]
    return torch.as_tensor(r), torch.as_tensor(x), torch.as_tensor(mask)


def _serial_index_add(x, r, v):
    return x.new_zeros((v,) + tuple(x.shape[1:])).index_add_(0, r, x)


@pytest.mark.parametrize("seed,v,e,f", [(0, 50, 3000, 7), (1, 300, 500, 1),
                                        (2, 40, 4000, 65), (3, 8, 64, 3)])
@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_fixed_order_sum_is_serial_index_add_bitwise(seed, v, e, f, flat,
                                                     masked):
    r, x, mask = _graph(seed, v, e, f)
    if flat:
        x = x[:, 0].contiguous()
    order, offsets = tseg.receiver_order(r, v, mask if masked else None)
    assert order.numel() == (int(mask.sum()) if masked else e)
    before = tseg.segment_sum.launches
    got = tseg.segment_sum(x, order, offsets)
    want = _serial_index_add(x, r, v)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))  # 0 + -0.0
    assert torch.equal(got[-3:], torch.zeros_like(got[-3:]))       # empty
    assert tseg.segment_sum.launches == before   # CPU tensors never launch


def test_receiver_order_is_stable_with_segment_offsets():
    r = torch.tensor([3, 0, 3, 1, 0, 3, 5], dtype=torch.int32)
    order, offsets = tseg.receiver_order(r, 7)
    assert order.dtype == offsets.dtype == torch.int32
    assert order.tolist() == [1, 4, 3, 0, 2, 5, 6]
    assert offsets.tolist() == [0, 2, 3, 3, 6, 6, 7, 7]
    mask = torch.tensor([1, 1, 0, 1, 1, 0, 1], dtype=torch.float32)
    order, offsets = tseg.receiver_order(r, 7, mask)
    assert order.tolist() == [1, 4, 3, 0, 6]
    assert offsets.tolist() == [0, 2, 3, 3, 4, 4, 5, 5]
    empty = tseg.receiver_order(torch.zeros(0, dtype=torch.int32), 3)
    assert empty[0].numel() == 0 and empty[1].tolist() == [0, 0, 0, 0]
    assert tseg.segment_sum(torch.zeros(0, 4), *empty).shape == (3, 4)


def test_float64_and_plain_version():
    r, x, _ = _graph(4, 60, 900, 5)
    order, offsets = tseg.receiver_order(r, 60)
    x64 = x.double() * 1.000001
    assert torch.equal(tseg.segment_sum(x64, order, offsets),
                       _serial_index_add(x64, r, 60))
    assert torch.equal(ref.segment_sum_ref(x, order, offsets),
                       tseg.segment_sum(x, order, offsets))


def test_segment_sum_rejects_bad_operands():
    r, x, _ = _graph(5, 20, 100, 4)
    order, offsets = tseg.receiver_order(r, 20)
    with pytest.raises(ValueError, match="order must be 1-d int32"):
        tseg.segment_sum(x, order.long(), offsets)
    with pytest.raises(ValueError, match="offsets must be 1-d int32"):
        tseg.segment_sum(x, order, offsets[None])
    with pytest.raises(ValueError, match=r"x \[E\] or \[E, F\]"):
        tseg.segment_sum(x[None], order, offsets)
    with pytest.raises(ValueError, match="100 entries in order for 99"):
        tseg.segment_sum(x[:99], order, offsets)


@pytest.mark.parametrize("pad", [0, 37])
def test_edge_list_carries_the_order_and_layers_keep_their_floats(pad):
    g = tdata.load("siot", scale=0.05, seed=0)
    edges = tlayers.EdgeList.from_graph(g, pad_to=g.num_edges + pad)
    order, offsets = tseg.receiver_order(edges.receivers, g.num_vertices,
                                         edges.mask)
    assert torch.equal(edges.order, order)
    assert torch.equal(edges.offsets, offsets)
    assert order.numel() == g.num_edges          # the padding is left out
    h = torch.as_tensor(np.random.default_rng(6).normal(
        size=(g.num_vertices, 9)).astype(np.float32))
    msgs = h[edges.senders] * edges.mask[:, None]
    assert torch.equal(tlayers.aggregate_sum(h, edges),
                       _serial_index_add(msgs, edges.receivers,
                                         g.num_vertices))
    assert torch.equal(tlayers.masked_degree(edges), _serial_index_add(
        edges.mask, edges.receivers, g.num_vertices))


def test_masked_edges_carry_no_message():
    """An inf or NaN in a masked edge's source row reaches no sum: the
    result is the serial sum of the unmasked edges alone."""
    g = tdata.load("siot", scale=0.05, seed=0)
    real = tlayers.EdgeList.from_graph(g)
    quiet = int(np.setdiff1d(np.arange(g.num_vertices), g.senders)[0])
    pad = torch.full((11,), quiet, dtype=torch.int32)
    edges = tlayers.EdgeList(
        torch.cat([real.senders, pad]),
        torch.cat([real.receivers, torch.arange(11, dtype=torch.int32)]),
        torch.cat([real.mask, torch.zeros(11)]), g.num_vertices)
    h = torch.as_tensor(np.random.default_rng(8).normal(
        size=(g.num_vertices, 5)).astype(np.float32))
    h[quiet] = float("nan")         # only masked edges leave this row
    h[quiet, 0] = float("inf")
    got = tlayers.aggregate_sum(h, edges)
    assert torch.equal(got, _serial_index_add(h[real.senders],
                                              real.receivers,
                                              g.num_vertices))
    assert torch.isfinite(got).all()


def test_self_looped_edges_are_built_once_in_the_reference_order():
    g = tdata.load("siot", scale=0.05, seed=0)
    edges = tlayers.EdgeList.from_graph(g)
    looped = edges.self_looped
    assert looped is edges.self_looped
    ids = torch.arange(g.num_vertices, dtype=torch.int32)
    assert torch.equal(looped.senders, torch.cat([edges.senders, ids]))
    assert torch.equal(looped.receivers, torch.cat([edges.receivers, ids]))
    assert torch.equal(looped.mask, torch.cat(
        [edges.mask, torch.ones(g.num_vertices)]))
    # Each receiver's self edge comes last in its segment.
    last = looped.order[looped.offsets[1:].long() - 1]
    assert torch.equal(last, g.num_edges + ids)


# ----------------------------------------------------------------------------
# The fused gather-and-sum over the source table
# ----------------------------------------------------------------------------

def _hub_edges(seed: int, v: int, e: int, hub: int, pad: int):
    """An edge list over v vertices: e random edges, ``hub`` more into
    vertex 3 (a segment over the long-segment threshold when hub exceeds
    it) and ``pad`` masked padding edges into the last vertex, as
    ``EdgeList.from_graph(pad_to=...)`` pads. Returns numpy senders,
    receivers and mask."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, v, e + hub).astype(np.int32)
    r = np.concatenate([rng.integers(0, v, e),
                        np.full(hub, 3)]).astype(np.int32)
    perm = rng.permutation(e + hub)
    s, r = s[perm], r[perm]
    mask = np.ones(e + hub, np.float32)
    s = np.concatenate([s, np.full(pad, v - 1, np.int32)])
    r = np.concatenate([r, np.full(pad, v - 1, np.int32)])
    mask = np.concatenate([mask, np.zeros(pad, np.float32)])
    return s, r, mask


def _old_sum(src, edges, w=None):
    """The pre-fusion composition: messages over every edge, masked (and
    weighted), then the segment sum over the order."""
    msgs = src[edges.senders.long()] * edges.mask[:, None]
    if w is not None:
        msgs = msgs * w[:, None]
    return tseg.segment_sum(msgs, edges.order, edges.offsets)


@pytest.mark.parametrize("f", [1, 2, 7, 52, 65])
@pytest.mark.parametrize("hub,pad", [(0, 0), (0, 23),
                                     (tseg.WIDE_LONG_SEGMENT + 75, 23)])
@pytest.mark.parametrize("weighted", [False, True])
def test_fused_sum_is_the_old_composition_bitwise(f, hub, pad, weighted):
    s, r, mask = _hub_edges(f + hub, 40, 600, hub, pad)
    edges = tlayers.EdgeList(torch.as_tensor(s), torch.as_tensor(r),
                             torch.as_tensor(mask), 40)
    rng = np.random.default_rng(f)
    src = rng.normal(size=(40, f)) * 10.0 ** rng.integers(-6, 6, (40, 1))
    src = torch.as_tensor(src.astype(np.float32))
    src[::4] = -0.0
    w = None
    if weighted:   # GAT's coefficients: 0 on masked edges
        w = torch.as_tensor(rng.uniform(0, 1, len(s)).astype(np.float32))
        w = w * edges.mask
    want = _old_sum(src, edges, w)
    got = tseg.segment_sum(src, edges.order, edges.offsets,
                           idx=edges.gather, w=w,
                           long=edges.long_segments(f))
    plain = ref.gather_segment_sum_ref(src, edges.gather, edges.offsets,
                                       order=edges.order, w=w)
    for x in (got, plain):
        assert torch.equal(x, want)
        assert torch.equal(torch.signbit(x), torch.signbit(want))
    assert len(edges.long_segments(f).ids) == (hub > 0)
    if not weighted:
        assert torch.equal(tlayers.aggregate_sum(src, edges), want)
    if f == 1:      # a flat [E] table, as GAT's denominators
        flat = tseg.segment_sum(src[:, 0], edges.order, edges.offsets,
                                idx=edges.gather, w=w)
        assert torch.equal(flat, want[:, 0])


def test_edge_list_index_structures_are_integer_exact():
    s, r, mask = _hub_edges(7, 60, 900, 2 * tseg.LONG_SEGMENT + 9, 31)
    edges = tlayers.EdgeList(torch.as_tensor(s), torch.as_tensor(r),
                             torch.as_tensor(mask), 60)
    assert edges.gather.dtype == torch.int32
    assert torch.equal(edges.gather, edges.senders[edges.order.long()])
    assert edges.gather is edges.gather            # built once
    counts = np.bincount(r[mask > 0], minlength=60)
    for f in (1, 64):
        want = [v for v in np.argsort(-counts, kind="stable")
                if counts[v] > tseg.long_threshold(f)]
        long = edges.long_segments(f)
        assert long.ids.dtype == torch.int32
        assert long.offsets is edges.offsets
        assert long.ids.tolist() == want == [3]
        assert edges.long_segments(f) is long         # built once
    # Longest first, ties by receiver; the threshold set by the width.
    offsets = torch.tensor([0, 200, 200, 500, 700, 701], dtype=torch.int32)
    assert [tseg.long_threshold(f) for f in (1, 2, 3, 4, 7, 8, 64)] == [
        128, 128, 256, 128, 256, 256, 256]
    assert tseg.LongSegments(offsets, 1).ids.tolist() == [2, 0, 3]
    assert tseg.LongSegments(offsets, 52).ids.tolist() == [2]
    assert tseg.LongSegments(offsets[:2], 2).ids.tolist() == [0]
    assert tseg.LongSegments(offsets[:1], 1).ids.numel() == 0


def test_segment_sum_takes_long_segments_only_of_its_own_offsets():
    """The card's lane groups skip every segment over the threshold and
    count on the list for a CTA each, so a list of other offsets (which
    could miss a long segment) is refused, on any device."""
    s, r, mask = _hub_edges(5, 30, 400, tseg.WIDE_LONG_SEGMENT + 3, 9)
    edges = tlayers.EdgeList(torch.as_tensor(s), torch.as_tensor(r),
                             torch.as_tensor(mask), 30)
    x = torch.ones(30, 4)
    other = edges.offsets.clone()
    for long in (tseg.LongSegments(other, 4),
                 tseg.LongSegments(edges.offsets[:-1], 4)):
        with pytest.raises(ValueError, match="other offsets"):
            tseg.segment_sum(x, edges.order, edges.offsets,
                             idx=edges.gather, long=long)
    got = tseg.segment_sum(x, edges.order, edges.offsets, idx=edges.gather,
                           long=tseg.LongSegments(edges.offsets, 4))
    want = tseg.segment_sum(x, edges.order, edges.offsets, idx=edges.gather)
    assert torch.equal(got, want)


def _executor_edge_lists():
    """Every edge list the executors build, on a small SIoT: sim's (and
    its self-looped GAT list), a padded list, and the mesh's folded halo
    and allgather lists (GCN's and GAT's)."""
    g = tdata.load("siot", scale=0.05, seed=0)
    edges = tlayers.EdgeList.from_graph(g)
    out = {"sim": edges, "sim self-looped": edges.self_looped,
           "padded": tlayers.EdgeList.from_graph(g, pad_to=g.num_edges + 57)}
    params = tmodels.gnn_init(torch.Generator().manual_seed(0), "gcn",
                              [g.feature_dim, 8, 2])
    plan = Engine((params, "gcn"), executor="mesh-bsp",
                  device="cpu").compile(g)
    pg, dev = plan.partitioned, torch.device("cpu")
    for exchange in ("halo", "allgather"):
        for kind in ("gcn", "gat"):
            out[f"mesh {exchange} {kind}"] = bsp._edges(pg, dev, exchange,
                                                        kind)
    return out


def test_degrees_from_the_order_are_index_add_of_the_mask_bitwise():
    for name, edges in _executor_edge_lists().items():
        want = _serial_index_add(edges.mask, edges.receivers.long(),
                                 edges.num_vertices)
        got = tlayers.masked_degree(edges)
        assert got.dtype == torch.float32, name
        assert torch.equal(got, want), name
        assert tlayers.masked_degree(edges) is got, name   # cached
        if name.startswith("mesh halo"):
            assert edges.order.numel() < edges.mask.numel()   # padded


def test_edge_list_rejects_a_mask_other_than_0_and_1():
    r = torch.tensor([0, 1, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="only 0 and 1"):
        tlayers.EdgeList(r, r, torch.tensor([1.0, 0.5, 0.0]), 2)
    with pytest.raises(ValueError, match="only 0 and 1"):
        tlayers.EdgeList(r, r, torch.tensor([1.0, float("nan"), 0.0]), 2)


def _gat_before(params, h, edges, h_src=None):
    """``gat_layer`` as the port computed it before the fused sum: the
    message tensor ``wh_src[s] * coef`` over every edge, then the segment
    sum over the order."""
    wh = h @ params["w"]
    wh_src = wh if h_src is None else h_src @ params["w"]
    alpha_src = (wh_src * params["att_src"]).sum(-1)
    alpha_dst = (wh * params["att_dst"]).sum(-1)
    if h_src is None:
        edges = edges.self_looped
    s, r, m = edges.senders, edges.receivers, edges.mask
    logits = torch.nn.functional.leaky_relu(alpha_src[s] + alpha_dst[r], 0.2)
    logits = torch.where(m > 0, logits, -torch.inf)
    seg_max = torch.full((edges.num_vertices,), -torch.inf).scatter_reduce(
        0, r.long(), logits, "amax", include_self=False)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    ex = torch.where(m > 0, torch.exp(logits - seg_max[r]), 0.0)
    denom = tseg.segment_sum(ex, edges.order, edges.offsets)
    coef = ex / torch.clamp_min(denom[r], 1e-16)
    a = tseg.segment_sum(wh_src[s] * coef[:, None], edges.order,
                         edges.offsets)
    return torch.nn.functional.elu(a)


@pytest.mark.parametrize("kind", ["gcn", "sage", "gat"])
def test_layers_on_a_hub_list_match_jax_and_the_pre_fusion_port(kind):
    v, f = 48, 6
    s, r, mask = _hub_edges(11, v, 500, tseg.LONG_SEGMENT + 40, 19)
    je = jlayers.EdgeList(jnp.asarray(s), jnp.asarray(r), jnp.asarray(mask),
                          v)
    te = tlayers.EdgeList(torch.as_tensor(s), torch.as_tensor(r),
                          torch.as_tensor(mask), v)
    assert te.long_segments(1).ids.tolist() == [3]
    jparams = jmodels.gnn_init(jax.random.PRNGKey(2), kind, [f, 5])
    tparams = tmodels.params_from_numpy(
        [{k: np.asarray(x) for k, x in p.items()} for p in jparams])[0]
    h = np.random.default_rng(12).normal(size=(v, f)).astype(np.float32)
    _, jfn = jlayers.LAYER_FNS[kind]
    _, tfn = tlayers.LAYER_FNS[kind]
    want = np.asarray(jfn(jparams[0], jnp.asarray(h), je))
    got = tfn(tparams, torch.as_tensor(h), te)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    th = torch.as_tensor(h)
    if kind == "gat":
        before = _gat_before(tparams, th, te)
    else:   # the pre-fusion sum and the index_add_ degrees
        deg = _serial_index_add(te.mask, te.receivers.long(), v)

        def old_aggregate(h_, edges_, h_src_=None):
            a = _old_sum(h_, edges_)
            return a if kind == "gcn" else a / torch.clamp_min(deg, 1.0)[
                :, None]
        before = tfn(tparams, th, te, aggregate=old_aggregate)
        assert torch.equal(tlayers.masked_degree(te), deg)
    assert torch.equal(got, before)
