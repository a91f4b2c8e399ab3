"""GNN training, the ASTGCN-lite case study, the deprecated serving shims
and ``fograph-demo-torch`` of the PyTorch port vs the JAX package.

Both packages start from the JAX package's init, carried across through
numpy, and train on the same graph. The bars:

- one step (loss and every gradient, ``jax.value_and_grad`` against the
  port's autograd through its segment sums and their transposed-order
  backward): rtol 1e-4 / atol 1e-5, the reference's own bar for device
  numerics (``tests/test_aggregation.py:51``);
- 20 SGD steps of ``train_node_classifier`` (10 of ``train_astgcn``):
  each step's loss within rtol 1e-4, the final parameters within rtol 1e-3
  / atol 1e-5 and the final accuracy within 1 / V. The reference states
  no training bar. Per-step rounding differences (f32, other summation
  orders in the matmuls) are carried and amplified by each later step, so
  the parameter bar is ten times the one-step bar; a loss is a mean over
  every vertex and stays at the one-step bar; argmax can flip on a vertex
  whose two logits tie to within that drift, so accuracy may move by one
  vertex;
- host numpy (``forecast_errors``, the shims' simulated numbers): ``==``.

The JAX per-step losses come from a loop with the body of the reference's
``train_node_classifier`` / ``train_astgcn`` (whose functions return only
the last loss); its final parameters and loss are held to the reference
function's own.
"""
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.gnn import datasets as jdata
from repro.gnn import layers as jlayers
from repro.gnn import models as jmodels
from repro.runtime import serving as jserving
from repro_torch.api import demo
from repro_torch.gnn import datasets as tdata
from repro_torch.gnn import layers as tlayers
from repro_torch.gnn import models as tmodels
from repro_torch.kernels import ref
from repro_torch.kernels import segment_sum as tseg
from repro_torch.runtime import serving as tserving

from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-4, 1e-5
TRAIN_RTOL = 1e-3
KINDS = ("gcn", "sage", "gat")
DIMS_HIDDEN = 16
STEPS = 20
LR = 5e-3
AST_STEPS = 10
AST_LR = 1e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _siot():
    return (jdata.load("siot", scale=0.05, seed=0),
            tdata.load("siot", scale=0.05, seed=0))


@functools.lru_cache(maxsize=None)
def _reference_training(kind):
    """The JAX side of one kind: the init, the first step's loss and
    gradients, the per-step losses of STEPS steps of the reference's step
    body, and the reference trainer's own (params, loss)."""
    g, _ = _siot()
    nc = int(g.labels.max()) + 1
    init = jmodels.gnn_init(jax.random.PRNGKey(0), kind,
                            [g.feature_dim, DIMS_HIDDEN, nc])
    edges = jlayers.EdgeList.from_graph(g)
    h0, y = jnp.asarray(g.features), jnp.asarray(g.labels)

    def loss_fn(p):
        return jmodels.cross_entropy(jmodels.gnn_apply(p, kind, h0, edges), y)

    @jax.jit
    def step(p):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        p = jax.tree_util.tree_map(lambda w, g_: w - LR * g_, p, grads)
        return p, loss, grads

    p, losses, first_grads = init, [], None
    for _ in range(STEPS):
        p, loss, grads = step(p)
        first_grads = grads if first_grads is None else first_grads
        losses.append(float(loss))
    trained, final_loss = jmodels.train_node_classifier(
        jax.random.PRNGKey(0), kind, g, hidden=DIMS_HIDDEN, steps=STEPS,
        lr=LR)
    acc = float(jmodels.accuracy(jmodels.gnn_apply(trained, kind, h0, edges),
                                 y))
    return {"init": _np(init), "first_grads": _np(first_grads),
            "losses": losses, "loop_params": _np(p),
            "params": _np(trained), "loss": final_loss, "accuracy": acc}


@pytest.mark.parametrize("kind", KINDS)
def test_first_step_loss_and_gradients_match_jax(kind):
    want = _reference_training(kind)
    _, gt = _siot()
    params = tmodels.params_from_numpy(want["init"])
    flat = [v.requires_grad_() for p in params for v in p.values()]
    edges = tlayers.EdgeList.from_graph(gt)
    loss = tmodels.cross_entropy(
        tmodels.gnn_apply(params, kind, torch.as_tensor(gt.features),
                          edges), torch.as_tensor(gt.labels))
    grads = torch.autograd.grad(loss, flat)
    np.testing.assert_allclose(loss.detach().item(), want["losses"][0],
                               rtol=RTOL)
    names = [(i, k) for i, p in enumerate(params) for k in p]
    for (i, k), g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want["first_grads"][i][k],
                                   rtol=RTOL, atol=ATOL, err_msg=f"{i}/{k}")
    assert any(float(g.abs().max()) > 0 for g in grads)


@pytest.mark.parametrize("kind", KINDS)
def test_sgd_steps_match_the_reference_trainer(kind):
    want = _reference_training(kind)
    g, gt = _siot()
    # The step-body loop is the reference trainer.
    assert want["losses"][-1] == pytest.approx(want["loss"], rel=1e-6)
    for a, b in zip(want["loop_params"], want["params"]):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-8)

    def train(steps):
        return tmodels.train_node_classifier(
            torch.Generator().manual_seed(0), kind, gt, hidden=DIMS_HIDDEN,
            steps=steps, lr=LR, init=want["init"])
    losses = [train(n)[1] for n in range(1, STEPS)]
    params, loss = train(STEPS)
    np.testing.assert_allclose(losses + [loss], want["losses"], rtol=RTOL)
    for got, ref_p in zip(params, want["params"]):
        assert set(got) == set(ref_p)
        for k, v in got.items():
            assert v.dtype == torch.float32 and not v.requires_grad
            np.testing.assert_allclose(v.numpy(), ref_p[k], rtol=TRAIN_RTOL,
                                       atol=ATOL, err_msg=k)
    edges = tlayers.EdgeList.from_graph(gt)
    acc = float(tmodels.accuracy(tmodels.gnn_apply(
        params, kind, torch.as_tensor(gt.features), edges),
        torch.as_tensor(gt.labels)))
    assert abs(acc - want["accuracy"]) <= 1.0 / g.num_vertices
    # init is copied, never trained in place
    assert np.array_equal(want["init"][0]["w"],
                          np.asarray(jmodels.gnn_init(
                              jax.random.PRNGKey(0), kind,
                              [g.feature_dim, DIMS_HIDDEN, 2])[0]["w"]))


def test_trainer_from_a_generator_is_deterministic_and_serves():
    _, gt = _siot()

    def train():
        return tmodels.train_node_classifier(
            torch.Generator().manual_seed(3), "gcn", gt, hidden=8, steps=3)
    (a, la), (b, lb) = train(), train()
    assert la == lb and np.isfinite(la)
    for pa, pb in zip(a, b):
        for k in pa:
            assert torch.equal(pa[k], pb[k])
    want = tmodels.gnn_init(torch.Generator().manual_seed(3), "gcn",
                            [gt.feature_dim, 8, 2])
    assert not torch.equal(a[0]["w"], want[0]["w"])   # it trained
    from repro_torch.api import Engine
    res = Engine((a, "gcn"), device="cpu").compile(gt).session().query()
    assert res.embeddings.shape == (gt.num_vertices, 2)


# ----------------------------------------------------------------------------
# The transposed gather-and-sum (the backward of kernels.segment_sum)
# ----------------------------------------------------------------------------

def _hub_list():
    """An edge list over 40 vertices: random edges, a hub (vertex 0) that
    receives from and sends to most vertices, every 6th edge masked,
    receiver 39 with no edge, and vertex 38 the source of masked edges
    only."""
    rng = np.random.default_rng(5)
    s = rng.integers(1, 38, 300)
    r = rng.integers(1, 38, 300)
    s = np.concatenate([s, np.arange(1, 38), np.zeros(37, np.int64),
                        np.full(5, 38)])
    r = np.concatenate([r, np.zeros(37, np.int64), np.arange(1, 38),
                        rng.integers(0, 38, 5)])
    mask = np.ones(len(s), np.float32)
    mask[::6] = 0.0
    mask[-5:] = 0.0
    return tlayers.EdgeList(torch.as_tensor(s, dtype=torch.int32),
                            torch.as_tensor(r, dtype=torch.int32),
                            torch.as_tensor(mask), 40)


@pytest.mark.parametrize("per_edge", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_transposed_sum_gradients_match_autograd_of_the_plain_version(
        per_edge, weighted):
    edges = _hub_list()
    rng = np.random.default_rng(6)
    e, v, f = edges.senders.shape[0], edges.num_vertices, 5
    rows = e if per_edge else v
    shape = (rows,) if per_edge else (rows, f)
    x = torch.tensor(rng.normal(size=shape), requires_grad=True)
    w = torch.tensor(rng.uniform(size=e) * edges.mask.double().numpy(),
                     requires_grad=True) if weighted else None
    idx = edges.order if per_edge else edges.gather
    g = torch.tensor(rng.normal(size=(v,) + shape[1:]))
    inputs = [x] + ([w] if weighted else [])

    before = tseg.segment_sum.launches
    got = tseg.segment_sum(
        x, edges.order, edges.offsets, idx=None if per_edge else idx, w=w,
        transposed=functools.partial(edges.transposed, rows, per_edge))
    grads = torch.autograd.grad(got, inputs, g)
    want = ref.gather_segment_sum_ref(x, idx, edges.offsets,
                                      order=edges.order, w=w)
    want_grads = torch.autograd.grad(want, inputs, g)
    assert torch.equal(got, want)
    for a, b in zip(grads, want_grads):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    if weighted:
        masked = edges.mask == 0
        assert torch.equal(grads[1][masked], torch.zeros_like(w[masked]))
    assert tseg.segment_sum.launches == before   # the CPU never launches


def test_transposed_order_is_cached_with_its_hub_long_segments():
    edges = _hub_list()
    t = edges.transposed(40)
    assert edges.transposed(40) is t and edges.transposed(40, True) is not t
    counts = t.offsets[1:] - t.offsets[:-1]
    assert int(counts.sum()) == edges.order.shape[0]
    assert int(counts[38]) == 0                      # masked sources only
    kept = edges.mask > 0
    assert int(counts[0]) == int(((edges.senders == 0) & kept).sum())
    # entries sorted stably by source row, each carrying its edge
    s = edges.senders.long()[t.order.long()]
    assert torch.equal(s, torch.sort(s, stable=True).values)
    assert torch.equal(edges.receivers[t.order.long()], t.idx)
    hub = t.long_segments(1)
    assert hub is t.long_segments(2) and hub.offsets is t.offsets
    assert 0 not in tseg.LongSegments(t.offsets, 64).ids.tolist()


def test_nan_in_a_masked_source_row_reaches_no_gradient():
    edges = _hub_list()
    rng = np.random.default_rng(8)
    x = torch.tensor(rng.normal(size=(40, 3)))
    x[38] = float("nan")                 # read by masked edges only
    x.requires_grad_()
    w = torch.tensor(rng.uniform(size=edges.senders.shape[0]),
                     requires_grad=True)
    out = tseg.segment_sum(x, edges.order, edges.offsets, idx=edges.gather,
                           w=w, transposed=functools.partial(
                               edges.transposed, 40))
    gx, gw = torch.autograd.grad(out.sum(), [x, w])
    assert torch.isfinite(out).all()
    assert torch.isfinite(gx).all() and torch.isfinite(gw).all()
    assert torch.equal(gx[38], torch.zeros(3, dtype=gx.dtype))


def test_a_gradient_needs_the_transposed_order():
    edges = _hub_list()
    x = torch.ones(40, 3, dtype=torch.float64, requires_grad=True)
    with pytest.raises(ValueError, match="transposed="):
        tseg.segment_sum(x, edges.order, edges.offsets, idx=edges.gather)
    with torch.no_grad():   # no gradient wanted: no order needed
        tseg.segment_sum(x, edges.order, edges.offsets, idx=edges.gather)


def test_layer_gradients_go_through_the_function_and_skip_features():
    _, gt = _siot()
    edges = tlayers.EdgeList.from_graph(gt)
    calls = []
    orig = tseg._SegmentSum.backward

    def spy(ctx, g):
        calls.append(tuple(ctx.needs_input_grad[:2]))
        return orig(ctx, g)
    params = tmodels.gnn_init(torch.Generator().manual_seed(0), "gcn",
                              [gt.feature_dim, 8, 2])
    flat = [v.requires_grad_() for p in params for v in p.values()]
    tseg._SegmentSum.backward = staticmethod(spy)
    try:
        out = tmodels.gnn_apply(params, "gcn", torch.as_tensor(gt.features),
                                edges)
        torch.autograd.grad(out.sum(), flat)
    finally:
        tseg._SegmentSum.backward = staticmethod(orig)
    # layer 1 sums the features (no gradient wanted: no Function), layer 2
    # its input's rows
    assert calls == [(True, False)]
    assert (gt.num_vertices, False) in edges._transposed


# ----------------------------------------------------------------------------
# ASTGCN-lite (paper §IV-C)
# ----------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _pems():
    return (jdata.load_pems_window(1.0, seed=0),
            tdata.load_pems_window(1.0, seed=0))


def _astgcn_loss_fn(tg, hist, apply, edges, mean, as_array):
    """The trainers' loss: the MSE against the z-scored target."""
    mu, sd = float(tg.target.mean()), float(tg.target.std() + 1e-6)
    y = as_array((tg.target - mu) / sd)
    return lambda p: mean((apply(p, hist, edges) - y) ** 2)


def _jax_astgcn_run(tg, init, edges, dtype):
    """AST_STEPS steps of the reference's ``train_astgcn`` step body in
    ``dtype`` (float64 only under ``jax.enable_x64``): the losses, the
    first gradients and the final parameters."""
    hist = jnp.asarray(tg.history.astype(dtype))
    loss_fn = _astgcn_loss_fn(tg, hist, jmodels.astgcn_apply, edges,
                              jnp.mean, lambda a: jnp.asarray(a, dtype))

    @jax.jit
    def step(p):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        p = jax.tree_util.tree_map(lambda w, g_: w - AST_LR * g_, p, grads)
        return p, loss, grads

    p = jax.tree_util.tree_map(lambda v: jnp.asarray(np.asarray(v, dtype)),
                               init)
    forecast = np.asarray(jmodels.astgcn_apply(p, hist, edges))
    losses, first = [], None
    for _ in range(AST_STEPS):
        p, loss, grads = step(p)
        first = grads if first is None else first
        losses.append(float(loss))
    return {"forecast": forecast, "losses": losses,
            "first_grads": _np(first), "params": _np(p)}


@functools.lru_cache(maxsize=None)
def _reference_astgcn():
    """The JAX side: the init, AST_STEPS steps of the step body in float32
    and in float64, and the reference trainer's own float32 result."""
    tg, _ = _pems()
    init = jmodels.astgcn_init(jax.random.PRNGKey(0), tg.history.shape[-1],
                               tg.history.shape[0], tg.target.shape[0])
    edges = jlayers.EdgeList.from_graph(tg.graph)
    out = {"init": _np(init),
           "f32": _jax_astgcn_run(tg, init, edges, np.float32)}
    with jax.enable_x64(True):
        out["f64"] = _jax_astgcn_run(tg, init, edges, np.float64)
    trained, out["mu_sd"], out["loss"] = jmodels.train_astgcn(
        jax.random.PRNGKey(0), tg, steps=AST_STEPS, lr=AST_LR)
    out["params"] = _np(trained)
    return out


def _port_astgcn_first_step(init, tg, dtype):
    params = {k: torch.tensor(np.asarray(v), dtype=dtype, requires_grad=True)
              for k, v in init.items()}
    edges = tlayers.EdgeList.from_graph(tg.graph)
    hist = torch.as_tensor(tg.history, dtype=dtype)
    out = tmodels.astgcn_apply(params, hist, edges)
    loss = _astgcn_loss_fn(tg, hist, tmodels.astgcn_apply, edges,
                           torch.mean, lambda a: torch.as_tensor(
                               a, dtype=dtype))(params)
    grads = torch.autograd.grad(loss, list(params.values()))
    return out.detach(), loss.detach().item(), dict(zip(params, grads))


def test_astgcn_forward_and_first_gradients_match_jax_in_float64():
    """Both packages' forecast, loss and first gradients, evaluated in
    float64 on the same init, at rtol 1e-4 / atol 1e-5: the port's
    structure (attention, the one-launch spatial sum and its transposed
    backward, the temporal convolution, the head) is the reference's."""
    want = _reference_astgcn()
    _, tg = _pems()
    out, loss, grads = _port_astgcn_first_step(want["init"], tg,
                                               torch.float64)
    assert out.shape == tuple(tg.target.shape)
    np.testing.assert_allclose(out.numpy(), want["f64"]["forecast"],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(loss, want["f64"]["losses"][0], rtol=RTOL)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want["f64"]["first_grads"][k],
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_astgcn_forward_and_first_gradients_match_jax_in_float32():
    """The served dtype. ASTGCN-lite runs on raw PeMS readings (flows near
    100), so its temporal attention's logits reach about 380 and its
    float32 forecast and attention gradients carry about 1e-4 of rounding
    in either package: measured on this init, the JAX package's float32
    forecast lies 1.2e-4 (max abs) from its float64 one and its ``ta_k``
    gradient 2.7 times the elementwise rtol 1e-4 / atol 1e-5 bar from
    its float64 one; the port's lie 0.98e-4 and 0.76 times. An elementwise
    bar between the two float32 results therefore fails on the few
    entries near 0 (port vs JAX 2.2 times the bar on 4 of 3,684 forecast
    entries). The float64 test above holds the structure at that bar;
    here each tensor is held at rtol 1e-4 with the atol scaled to its
    magnitude, 1e-5 * max(1, max|want|), the form of the reference's DAQ
    bar (``tests/test_aggregation.py:81``)."""
    want = _reference_astgcn()
    _, tg = _pems()
    out, loss, grads = _port_astgcn_first_step(want["init"], tg,
                                               torch.float32)
    assert out.dtype == torch.float32
    ref32 = want["f32"]
    pairs = [("forecast", out, ref32["forecast"])] + [
        (k, g, ref32["first_grads"][k]) for k, g in grads.items()]
    for name, got, ref_v in pairs:
        scale = max(1.0, float(np.abs(ref_v).max()))
        np.testing.assert_allclose(got.numpy(), ref_v, rtol=RTOL,
                                   atol=ATOL * scale, err_msg=name)
    np.testing.assert_allclose(loss, ref32["losses"][0], rtol=RTOL)


def test_train_astgcn_matches_the_reference_trainer():
    """Training amplifies rounding: the loss swings from 99 to 229 and
    back in the first steps, and the JAX package's float32 losses drift
    from its own float64 run to 1.5e-4 (relative) by step 10, and its
    float32 parameters to 2.0 times the training bar (rtol 1e-3 / atol
    1e-5; the port's float32 run stays within 1e-5 and 0.16 times). So
    each step's loss is held at rtol 1e-4, and the final parameters at the
    training bar, to the reference's step body run in float64; the final
    loss to the reference trainer's float32 one at rtol 1e-3; and each
    final parameter no farther from the float64 run than the reference
    trainer's float32 one."""
    want = _reference_astgcn()
    _, tg = _pems()
    assert want["f32"]["losses"][-1] == pytest.approx(want["loss"], rel=1e-6)

    def train(steps):
        return tmodels.train_astgcn(torch.Generator().manual_seed(0), tg,
                                    steps=steps, lr=AST_LR,
                                    init=want["init"])
    losses = [train(n)[2] for n in range(1, AST_STEPS)]
    params, mu_sd, loss = train(AST_STEPS)
    assert mu_sd == want["mu_sd"]
    np.testing.assert_allclose(losses + [loss], want["f64"]["losses"],
                               rtol=RTOL)
    np.testing.assert_allclose(loss, want["loss"], rtol=TRAIN_RTOL)
    for k, v in params.items():
        assert v.dtype == torch.float32 and not v.requires_grad
        exact = want["f64"]["params"][k]
        np.testing.assert_allclose(v.numpy(), exact, rtol=TRAIN_RTOL,
                                   atol=ATOL, err_msg=k)
        assert np.abs(v.numpy() - exact).max() <= \
            np.abs(want["params"][k] - exact).max(), k


def test_astgcn_init_draws_the_reference_scale_from_the_generator():
    a = tmodels.astgcn_init(torch.Generator().manual_seed(0), 3, 12, 12)
    b = tmodels.astgcn_init(torch.Generator().manual_seed(0), 3, 12, 12)
    ref_p = _reference_astgcn()["init"]
    assert set(a) == set(ref_p)
    for k, v in a.items():
        assert v.shape == ref_p[k].shape and torch.equal(v, b[k])
        if k.endswith("_b"):
            assert not v.any()
        else:   # normals * sqrt(2 / (fan_in + fan_out))
            scale = (2.0 / sum(v.shape[-2:])) ** 0.5
            assert 0.5 < float(v.std()) / scale < 1.5


def test_one_launch_spatial_sum_is_bitwise_per_timestep_sums():
    _, tg = _pems()
    edges = tlayers.EdgeList.from_graph(tg.graph)
    x = torch.as_tensor(np.random.default_rng(4).normal(
        size=tg.history.shape).astype(np.float32))
    got = tmodels.astgcn_spatial_sum(x, edges)
    want = torch.stack([tlayers.aggregate_sum(x[t], edges)
                        for t in range(x.shape[0])])
    assert got.shape == x.shape and torch.equal(got, want)


def test_forecast_errors_equal_the_reference():
    rng = np.random.default_rng(9)
    target = rng.normal(60, 20, size=(12, 307)).astype(np.float32)
    target[0, :3] = 0.0
    pred = target + rng.normal(0, 5, size=target.shape).astype(np.float32)
    assert tmodels.forecast_errors(pred, target) == \
        jmodels.forecast_errors(pred, target)


# ----------------------------------------------------------------------------
# The deprecated shims and the demo
# ----------------------------------------------------------------------------

def _deprecations(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(w.message) for w in caught
                 if issubclass(w.category, DeprecationWarning)]


def test_shims_match_the_reference_workflow():
    """``tests/test_system.py``'s deploy / serve / adapt workflow in both
    packages. At scale 0.05 a background load of 3.0 (that test's, at
    scale 0.15) moves no vertex in either package; 6.0 makes both
    diffuse."""
    g, gt = _siot()
    init = _reference_training("gcn")["init"]
    sides = {}
    for name, mod, params, graph, kw in (
            ("jax", jserving, init, g, {}),
            ("port", tserving, tmodels.params_from_numpy(init), gt,
             {"device": "cpu"})):
        svc, w_deploy = _deprecations(lambda: mod.deploy(
            graph, params, "gcn", cluster_spec="1A+2B+1C", network="wifi",
            compress="daq", **kw))
        r1, w_query = _deprecations(lambda: mod.serve_query(svc))
        mode0, w_adapt = _deprecations(lambda: mod.adapt(svc))
        svc.cluster.nodes[0].background_load = 6.0
        mode1, _ = _deprecations(lambda: mod.adapt(svc, lam=1.2))
        r2, _ = _deprecations(lambda: mod.serve_query(svc))
        sides[name] = dict(svc=svc, r1=r1, r2=r2, modes=(mode0, mode1),
                           warnings=w_deploy + w_query + w_adapt)
    jx, pt = sides["jax"], sides["port"]
    assert pt["modes"] == jx["modes"] and pt["modes"][0] == "none" \
        and pt["modes"][1] != "none"
    assert pt["warnings"] == [m.replace("repro.", "repro_torch.")
                              for m in jx["warnings"]]
    assert len(pt["warnings"]) == 3
    for r in ("r1", "r2"):
        for key in ("latency", "throughput", "wire_bytes", "exchange_bytes"):
            assert getattr(pt[r], key) == getattr(jx[r], key), (r, key)
        np.testing.assert_allclose(pt[r].embeddings, jx[r].embeddings,
                                   rtol=RTOL, atol=ATOL)
    svc = pt["svc"]
    assert svc.kind == "gcn" and svc.compress == "daq"
    assert svc.exchange == "halo" and len(svc.params) == 2
    svc.compress = None
    assert svc.compress is None


def test_compression_shim_cuts_wire_bytes_not_answers():
    _, gt = _siot()
    params = tmodels.params_from_numpy(_reference_training("gcn")["init"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        raw = tserving.serve_query(tserving.deploy(
            gt, params, "gcn", compress=None, device="cpu"))
        daq = tserving.serve_query(tserving.deploy(
            gt, params, "gcn", compress="daq", device="cpu"))
    assert daq.wire_bytes < 0.5 * raw.wire_bytes
    assert np.mean(raw.embeddings.argmax(-1)
                   == daq.embeddings.argmax(-1)) > 0.99


def test_demo_runs_on_the_cpu(capsys):
    assert demo.main(["--device", "cpu", "--scale", "0.05", "--steps", "5",
                      "--queries", "2"]) == 0
    out = capsys.readouterr().out
    assert "trained gcn" in out and "on cpu" in out
    assert "cloud-vs-fog" in out and "scheduler action" in out
