"""The port's fixed-order segment sum (``kernels.segment_sum``) and the
edge lists that carry its order.

On the CPU the wrapper runs its plain version, which must give exactly the
floats of a serial ``index_add_`` into zeros in edge order: duplicate
receivers, padding edges (masked to ±0 messages, which the order leaves
out), empty segments and -0.0 messages included. The GNN layers that sum
through it keep those floats, and the self-looped edge list of GAT is the
reference's concatenation.
The CUDA kernel is held to the same floats on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.gnn import datasets as tdata
from repro_torch.gnn import layers as tlayers
from repro_torch.kernels import ref
from repro_torch.kernels import segment_sum as tseg

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
