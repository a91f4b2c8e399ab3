"""GAT's edge softmax (``kernels.edge_softmax``) on the CPU.

On a CPU tensor the wrapper runs its plain version, ``kernels.ref.
edge_softmax_ref``, which must be bit for bit the op chain the GAT layer
ran before the softmax became one call (written out here as
``_chain``): one head and several, masked edges (with inf and NaN scores
behind them), a receiver with no edge and a hub past the long-segment
threshold. Through its ``torch.autograd.Function`` the gradients of both
score tables must be the chain's, bit for bit, in float32 and float64, and
so must a whole GAT layer's output and gradients. CPU calls launch
nothing; the wrapper refuses indices other than int32 and tables that do
not fit the edge list. On the card ``edge_softmax_kernel`` must give the
plain chain's floats on every entry of the order (tests marked ``cuda``,
and ``chip_smoke.py``).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.gnn import layers as tlayers
from repro_torch.kernels import edge_softmax as tes
from repro_torch.kernels import ref
from repro_torch.kernels import segment_sum as tseg

from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

HEADS = [1, 4, 6]
#: the hub's extra entries, past the long-segment threshold
HUB = tseg.LONG_SEGMENT + 57


def _edges(seed: int, v: int = 40, e: int = 600, pad: int = 23,
           extra_row: bool = True):
    """(EdgeList, rows of the source table): e random edges over receivers
    0 .. v - 3 (v - 2 and v - 1 get none), HUB more into receiver 3, then
    ``pad`` masked edges into v - 1 from the extra source row v (without
    ``extra_row``: from v - 1, as ``EdgeList.from_graph`` pads), the
    edges shuffled."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, v, e + HUB)
    r = np.concatenate([rng.integers(0, v - 2, e), np.full(HUB, 3)])
    s = np.concatenate([s, np.full(pad, v if extra_row else v - 1)])
    r = np.concatenate([r, np.full(pad, v - 1)])
    mask = np.concatenate([np.ones(e + HUB), np.zeros(pad)])
    perm = rng.permutation(len(s))
    edges = tlayers.EdgeList(torch.as_tensor(s[perm].astype(np.int32)),
                             torch.as_tensor(r[perm].astype(np.int32)),
                             torch.as_tensor(mask[perm].astype(np.float32)),
                             v)
    return edges, v + 1 if extra_row else v


def _scores(seed: int, rows: int, v: int, heads: int, dtype=torch.float32):
    """Score tables [rows, H] and [v, H] ([rows] and [v] at one head),
    spread over a few decades; the masked edges' source row (the last)
    holds inf, -inf and NaN."""
    rng = np.random.default_rng(seed)
    a_src = rng.normal(size=(rows, heads)) * 10.0 ** rng.integers(
        -2, 2, (rows, 1))
    a_dst = rng.normal(size=(v, heads)) * 3.0
    a_src[-1] = [(np.inf, -np.inf, np.nan)[h % 3] for h in range(heads)]
    a_src, a_dst = (torch.as_tensor(x, dtype=dtype) for x in (a_src, a_dst))
    if heads == 1:
        return a_src[:, 0].contiguous(), a_dst[:, 0].contiguous()
    return a_src, a_dst


def _chain(alpha_src, alpha_dst, edges):
    """The GAT layer's softmax as it ran before ``edge_softmax``: head-major
    [H, M] and [H, V] tables ([M] and [V] at one head) -> coef [H, E]."""
    v = edges.num_vertices
    s, r, m = edges.senders, edges.receivers, edges.mask
    logits = F.leaky_relu(alpha_src[..., s] + alpha_dst[..., r], 0.2)
    logits = torch.where(m > 0, logits, -torch.inf)  # [H, E]
    seg_max = torch.full(logits.shape[:-1] + (v,), -torch.inf,
                         dtype=logits.dtype, device=logits.device)
    seg_max = seg_max.scatter_reduce(-1, r.long().expand_as(logits),
                                     logits, "amax", include_self=False)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    ex = torch.where(m > 0, torch.exp(logits - seg_max[..., r]), 0.0)
    denom = tlayers._segment_sum(ex.movedim(0, -1), edges).movedim(-1, 0)
    return ex / torch.clamp_min(denom[..., r], 1e-16)


def _head_major(t):
    return t.T if t.ndim == 2 else t


def _bits(x):
    x = x.contiguous()
    return x.view(torch.int64 if x.dtype == torch.float64 else torch.int32)


@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_plain_version_is_the_chain_bitwise(heads, seed):
    edges, rows = _edges(seed)
    a_src, a_dst = _scores(seed + 10, rows, edges.num_vertices, heads)
    assert edges.long_segments(tes.LONG_FEATURES).ids.tolist() == [3]
    before = tes.edge_softmax.launches
    got = tes.edge_softmax(a_src, a_dst, edges)
    assert tes.edge_softmax.launches == before   # CPU tensors never launch
    want = _chain(_head_major(a_src), _head_major(a_dst), edges)
    assert got.shape == (edges.senders.shape[0],) + tuple(a_src.shape[1:])
    assert torch.equal(_bits(got), _bits(want.movedim(0, -1)))
    assert torch.equal(_bits(got),
                       _bits(ref.edge_softmax_ref(
                           a_src, a_dst, edges.senders, edges.receivers,
                           edges.mask, edges.order, edges.offsets)))
    masked = edges.mask == 0
    assert torch.equal(got[masked], torch.zeros_like(got[masked]))
    assert torch.isfinite(got).all()   # inf and NaN only behind the mask
    # every receiver with an edge sums its coefficients to about 1
    kept = got[edges.order.long()]
    seg = torch.segment_reduce(kept.double(), "sum",
                               offsets=edges.offsets.long(), axis=0)
    has = (edges.offsets[1:] > edges.offsets[:-1])
    assert not has[-2:].any()
    torch.testing.assert_close(seg[has], torch.ones_like(seg[has]),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("heads", HEADS)
def test_a_receiver_whose_scores_are_all_minus_inf_gets_zeros(heads):
    """The max of a segment of -inf logits is not finite, so it is 0, the
    exponents 0 and the denominator floored: 0 coefficients, as the chain
    gives; a +inf logit gives NaN there, as the chain does."""
    edges, rows = _edges(3)
    a_src, a_dst = _scores(13, rows, edges.num_vertices, heads)
    a_dst = a_dst.clone()
    a_dst[3] = -torch.inf
    a_dst[5] = torch.inf
    got = tes.edge_softmax(a_src, a_dst, edges)
    want = _chain(_head_major(a_src), _head_major(a_dst),
                  edges).movedim(0, -1)
    assert torch.equal(_bits(got), _bits(want))
    r = edges.receivers
    hub = (r == 3) & (edges.mask > 0)
    assert torch.equal(got[hub], torch.zeros_like(got[hub]))
    assert torch.isnan(got[(r == 5) & (edges.mask > 0)]).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("heads", HEADS)
def test_the_gradients_are_the_chains_bitwise(heads, dtype):
    edges, rows = _edges(4)
    a_src, a_dst = _scores(14, rows, edges.num_vertices, heads, dtype)
    a_src[-1] = 0.0     # finite scores, so the chain's gradients are too
    g = torch.as_tensor(np.random.default_rng(5).normal(
        size=(edges.senders.shape[0],) + tuple(a_src.shape[1:])),
        dtype=dtype)
    got_src, got_dst = (t.clone().requires_grad_() for t in (a_src, a_dst))
    coef = tes.edge_softmax(got_src, got_dst, edges)
    assert coef.grad_fn is not None
    grads = torch.autograd.grad(coef, (got_src, got_dst), g)
    want_src, want_dst = (t.clone().requires_grad_() for t in (a_src, a_dst))
    want = _chain(_head_major(want_src), _head_major(want_dst),
                  edges).movedim(0, -1)
    assert torch.equal(_bits(coef.detach()), _bits(want.detach()))
    wants = torch.autograd.grad(want, (want_src, want_dst), g)
    for got_g, want_g in zip(grads, wants):
        assert got_g.dtype == dtype
        assert torch.equal(_bits(got_g), _bits(want_g))
        assert torch.isfinite(got_g).all()


def test_the_gradients_pass_gradcheck():
    edges, rows = _edges(6, v=12, e=40, pad=5)
    a_src, a_dst = _scores(16, rows, edges.num_vertices, 2, torch.float64)
    a_src[-1] = 0.0
    assert torch.autograd.gradcheck(
        lambda s, d: tes.edge_softmax(s, d, edges),
        (a_src.requires_grad_(), a_dst.requires_grad_()))


def _scores_pr33(z, att):
    heads = att.shape[0]
    scores = (z.view(z.shape[0], heads, -1) * att).sum(-1).T
    return scores[0] if heads == 1 else scores


def _gat_layer_pr33(params, h, edges, *, activation=F.elu, h_src=None,
                    skip=False):
    """``gat_layer`` with its softmax written out as the chain."""
    heads = params["att_src"].shape[0]
    wh = h @ params["w"]
    wh_src = wh if h_src is None else h_src @ params["w"]
    if h_src is None:
        edges = edges.self_looped
    coef = _chain(_scores_pr33(wh_src, params["att_src"]),
                  _scores_pr33(wh, params["att_dst"]), edges)
    a = tlayers._segment_sum(wh_src, edges, idx=edges.gather,
                             w=coef.movedim(0, -1))
    if activation is None:
        return tlayers._mean_heads(a, heads)
    if skip and h.shape[-1] == a.shape[-1]:
        a = a + h
    return activation(a)


@pytest.mark.parametrize("heads,d,last", [(1, 6, False), (1, 6, True),
                                          (4, 3, False), (6, 2, True)])
@pytest.mark.parametrize("own_table", [True, False],
                         ids=["self-looped", "h_src"])
def test_a_gat_layer_keeps_its_output_and_gradients(heads, d, last,
                                                    own_table):
    edges, rows = _edges(7, extra_row=not own_table)
    v, f = edges.num_vertices, 5
    rng = np.random.default_rng(8)
    h = torch.as_tensor(rng.normal(size=(v, f)).astype(np.float32))
    params = tlayers.gat_init(torch.Generator().manual_seed(9), f,
                              heads * d, heads=heads, concat=not last)
    h_src = None
    if not own_table:   # the mesh's form: another table, its own self edges
        h_src = torch.cat([h, torch.as_tensor(
            rng.normal(size=(rows - v, f)).astype(np.float32))])
        edges = edges.self_looped
    kw = {"activation": None} if last else {}
    outs, grads = [], []
    for layer in (tlayers.gat_layer, _gat_layer_pr33):
        p = {k: t.clone().requires_grad_() for k, t in params.items()}
        out = layer(p, h, edges, h_src=h_src, **kw)
        outs.append(out.detach())
        grads.append(torch.autograd.grad((out * out).sum(), list(p.values())))
    assert torch.equal(_bits(outs[0]), _bits(outs[1]))
    for got, want in zip(*grads):
        assert torch.equal(_bits(got), _bits(want))


def test_the_wrapper_refuses_what_does_not_fit():
    edges, rows = _edges(10)
    a_src, a_dst = _scores(20, rows, edges.num_vertices, 4)
    with pytest.raises(ValueError, match="rows"):
        tes.edge_softmax(a_src, a_dst[:-1], edges)
    with pytest.raises(ValueError, match="a_dst"):
        tes.edge_softmax(a_src, a_dst[:, :3], edges)
    with pytest.raises(ValueError, match="a_dst"):
        tes.edge_softmax(a_src[:, 0], a_dst, edges)
    with pytest.raises(ValueError, match="differ"):
        tes.edge_softmax(a_src, a_dst.double(), edges)
    for name in ("order", "offsets", "senders"):
        bad = edges._replace(**{name: getattr(edges, name).long()})
        with pytest.raises(ValueError, match=f"{name} must be 1-d int32"):
            tes.edge_softmax(a_src, a_dst, bad)
    bad = edges._replace()
    bad.gather = edges.gather[:-1]
    with pytest.raises(ValueError, match="gather"):
        tes.edge_softmax(a_src, a_dst, bad)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tes.edge_softmax(a_src.to("meta"), a_dst.to("meta"),
                         _on_meta(edges))


def _on_meta(edges):
    return edges._replace(**{k: getattr(edges, k).to("meta") for k in (
        "senders", "receivers", "mask", "order", "offsets")})


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_softmax_bound_is_pinned():
    """The yardstick of the kernel's time on the card: ``chip_smoke.
    softmax_bound`` counts the order and the gather index once, the
    coefficients written once, the score tables' rows read once and the
    offsets once, at the HBM rate, here at RMAT-40k's folded layout."""
    chip_smoke = _chip_smoke()
    for heads in (1, 4, 6):
        ms, by = chip_smoke.softmax_bound(144_576, 68_016, 1_399_590, heads)
        nbytes = 4 * (144_576 * heads + 68_016 * heads + 68_017
                      + 1_399_590 * (2 + heads))
        assert by == "bytes"
        assert ms == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("heads", HEADS + [2, 8])
def test_the_kernel_is_the_plain_chain_on_the_order(heads):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU path")
    dev = torch.device("cuda")
    edges, rows = _edges(heads, v=300, e=30_000, pad=900)
    cuda_edges = tlayers.EdgeList(*(t.to(dev) for t in edges[:3]),
                                  edges.num_vertices)
    a_src, a_dst = (t.to(dev) for t in _scores(heads, rows, 300, heads))
    before = tes.edge_softmax.launches
    got = tes.edge_softmax(a_src, a_dst, cuda_edges)
    assert tes.edge_softmax.launches == before + 1
    want = ref.edge_softmax_ref(a_src, a_dst, cuda_edges.senders,
                                cuda_edges.receivers, cuda_edges.mask,
                                cuda_edges.order, cuda_edges.offsets,
                                tes._total(cuda_edges))
    kept = cuda_edges.order.long()
    assert torch.equal(_bits(got[kept]), _bits(want[kept]))
    again = tes.edge_softmax(a_src, a_dst, cuda_edges)
    assert torch.equal(_bits(got[kept]), _bits(again[kept]))
