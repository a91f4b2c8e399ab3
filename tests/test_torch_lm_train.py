"""Transformer training in the PyTorch port vs the JAX package.

The port's ``loss_fn``, ``make_train_step``, AdamW, the synthetic corpus,
the checkpoint format, the scans' backward and ``launch.train`` run on the
same seeded numpy inputs as the reference, with the reference's weights
carried across by ``transformer.params_from_numpy``. The bars:

- a loss: rtol 1e-4 / atol 1e-4, the reference's model-level logit bar
  (tests/test_flash_attention.py:74);
- a gradient: rtol 1e-4 with atol 1e-5 * max(1, max|want|) per leaf, the
  reference's device bar (tests/test_aggregation.py:51) with its atol
  scaled to the leaf, as its DAQ bar is (tests/test_aggregation.py:81):
  a leaf's entries are sums over the batch whose rounding grows with the
  leaf's scale;
- three train steps: each step's loss and grad_norm within rtol 1e-4; the
  parameters and moments after them within TRAIN_ATOL (``_train_bar``:
  twice how far float32 runs lie from a float64 run of the same steps,
  measured by ``scripts/train_step_bar.py``);
- AdamW fed the same gradients: rtol 1e-6 / atol 1e-7 (the same f32
  operations in the same order; the powers in the bias corrections may
  differ by an ulp);
- host numpy (the corpus, sizes, shapes): ``==``.
"""
import contextlib
import dataclasses
import functools
import importlib.util
import io
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.checkpoint import io as jckpt
from repro.configs import registry as jreg
from repro.data import pipeline as jpipe
from repro.launch import train as jtrain
from repro.models import config as jconfig
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import io as tckpt
from repro_torch.configs import registry as treg
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import recurrence as rc
from repro_torch.kernels import ref
from repro_torch.launch import train as ttrain
from repro_torch.models import config as tconfig
from repro_torch.models import transformer as ttf
from repro_torch.optim import adamw as tadamw

from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-4
RTOL, ATOL = 1e-4, 1e-5
OPT_RTOL, OPT_ATOL = 1e-6, 1e-7
B, S = 2, 16
TRAIN_ARCHS = ["qwen1.5-0.5b", "falcon-mamba-7b", "recurrentgemma-9b",
               "deepseek-v3-671b"]
TRAIN_STEPS = 3
TRAIN_LR = 1e-3


def _cfgs(arch):
    return jreg.reduced(jreg.get(arch)), treg.reduced(treg.get(arch))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_init(jcfg, seed):
    """The reference's init_params, jitted (a third faster here than op
    by op for the MoE configs)."""
    return _np(jax.jit(lambda k: jtf.init_params(jcfg, k))(
        jax.random.PRNGKey(seed)))


@functools.lru_cache(maxsize=None)
def _init(arch):
    return _jax_init(_cfgs(arch)[0], 0)


def _batch(cfg, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        inputs = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    else:
        inputs = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return {"inputs": inputs,
            "targets": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32)}


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _reference_grads(arch):
    """jax.value_and_grad of the reference's loss_fn (remat off), once per
    config: (loss, gradient tree as numpy)."""
    jcfg, _ = _cfgs(arch)
    batch = {k: jnp.asarray(v) for k, v in _batch(jcfg).items()}
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jtf.loss_fn(p, jcfg, b, remat=False)))
    loss, grads = fn(jax.tree_util.tree_map(jnp.asarray, _init(arch)), batch)
    return float(loss), _np(grads)


def _port_grads(arch, remat):
    _, tcfg = _cfgs(arch)
    params = ttf.params_from_numpy(_init(arch), tcfg)
    leaves = [p.requires_grad_() for p in pytree.tree_leaves(params)]
    loss = ttf.loss_fn(params, tcfg, _torch_batch(_batch(tcfg)), remat=remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), grads


def _leaf_close(got, want, what, rtol=RTOL, atol=ATOL):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    scaled = atol * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=scaled,
                               err_msg=what)


def _leaves_with_paths(params):
    """('/'-joined key, leaf) pairs, the checkpoint's keys."""
    return tckpt._flatten(params)


# ----------------------------------------------------------------------------
# loss_fn and its gradients
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jreg.list_archs())
def test_loss_and_every_gradient_match_jax(arch):
    """All ten reduced configs at B = 2, S = 16, remat off: the loss at
    the logit bar and every gradient leaf (the reference's tree unstacked
    as ``params_from_numpy`` unstacks parameters) at the gradient bar."""
    want_loss, want_grads = _reference_grads(arch)
    _, tcfg = _cfgs(arch)
    loss, grads = _port_grads(arch, remat=False)
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    want = _leaves_with_paths(ttf.params_from_numpy(want_grads, tcfg))
    assert len(want) == len(grads)
    for (path, w), g in zip(want, grads):
        assert tuple(g.shape) == tuple(w.shape), path
        _leaf_close(g, w.numpy(), path)


@pytest.mark.parametrize("arch", jreg.list_archs())
def test_remat_is_bitwise_no_remat(arch):
    """Checkpointing each unit recomputes the same floats: loss and every
    gradient bitwise those of remat off."""
    loss0, grads0 = _port_grads(arch, remat=False)
    loss1, grads1 = _port_grads(arch, remat=True)
    assert torch.equal(loss0, loss1)
    for g0, g1 in zip(grads0, grads1):
        assert torch.equal(g0, g1)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b"])
def test_scan_parameters_get_gradients_through_the_function(arch,
                                                            monkeypatch):
    """On the CPU the scans' autograd Functions run (their plain backward),
    and every scan parameter gets a nonzero gradient from loss_fn."""
    calls = []
    for name, fn in (("_selective_bwd", rc._selective_bwd),
                     ("_rglru_bwd", rc._rglru_bwd)):
        def spy(*a, _fn=fn, _name=name):
            calls.append(_name)
            return _fn(*a)
        monkeypatch.setattr(rc, name, spy)
    _, tcfg = _cfgs(arch)
    params = ttf.params_from_numpy(_init(arch), tcfg)
    for p in pytree.tree_leaves(params):
        p.requires_grad_()
    loss = ttf.loss_fn(params, tcfg, _torch_batch(_batch(tcfg)))
    loss.backward()
    names = (("x_proj", "dt_proj", "dt_bias", "a_log") if arch.startswith(
        "falcon") else ("w_input_gate", "w_rec_gate", "lambda_p"))
    kind = "mamba" if arch.startswith("falcon") else "rglru"
    layers = [p for p, spec in zip(params["layers"], tcfg.layer_specs())
              if spec.mixer == kind]
    assert layers and len(calls) == len(layers)
    for p in layers:
        for n in names:
            g = p["mixer"][n].grad
            assert g is not None and bool((g != 0).any()), n


# ----------------------------------------------------------------------------
# The scans' backward
# ----------------------------------------------------------------------------

def _scan_inputs(kind, s, width, seed):
    rng = np.random.default_rng(seed)
    b = 2
    if kind == "selective":
        st = 16
        return dict(
            dt=np.log1p(np.exp(rng.normal(size=(b, s, width)) - 1.0)),
            b=rng.normal(size=(b, s, st)), c=rng.normal(size=(b, s, st)),
            x=rng.normal(size=(b, s, width)),
            a=-np.tile(np.arange(1, st + 1, dtype=np.float64), (width, 1)),
            h0=rng.normal(size=(b, width, st)),
            dy=rng.normal(size=(b, s, width)),
            dh_last=rng.normal(size=(b, width, st)))
    return dict(xc=rng.normal(size=(b, s, width)),
                wi=rng.normal(size=width) * 0.5,
                wr=rng.normal(size=width) * 0.5,
                lam=2.0 + rng.normal(size=width) * 0.1,
                h0=rng.normal(size=(b, width)),
                dhs=rng.normal(size=(b, s, width)),
                dh_last=rng.normal(size=(b, width)))


def _jax_selective(dt, b, c, x, a, h0):
    """The reference's ``_mamba_inner`` scan (ssm.py:68-80) from the
    post-softplus dt and the projections: its step function, its lax.scan."""
    def step(h, inp):
        dt_t, b_t, c_t, x_t = inp
        da = jnp.exp(dt_t[..., None] * a)
        db = dt_t[..., None] * b_t[:, None, :]
        h = da * h + db * x_t[..., None]
        return h, jnp.einsum("bds,bs->bd", h, c_t)

    xs = tuple(t.transpose(1, 0, 2) for t in (dt, b, c, x))
    h_last, ys = jax.lax.scan(step, h0, xs)
    return ys.transpose(1, 0, 2), h_last


@pytest.mark.parametrize("s", [1, 7, 37])
def test_selective_scan_backward_matches_jax_vjp(s):
    """``ref.selective_scan_bwd_ref`` against ``jax.vjp`` of the
    reference's scan, odd width, nonzero h0 and dh_last, every input's
    gradient at rtol 1e-4 / atol 1e-5."""
    v = {k: x.astype(np.float32) for k, x in
         _scan_inputs("selective", s, 13, s).items()}
    args = [v[k] for k in ("dt", "b", "c", "x", "a", "h0")]
    _, vjp = jax.vjp(_jax_selective, *map(jnp.asarray, args))
    want = vjp((jnp.asarray(v["dy"]), jnp.asarray(v["dh_last"])))
    got = ref.selective_scan_bwd_ref(
        *map(torch.as_tensor, args), torch.as_tensor(v["dy"]),
        torch.as_tensor(v["dh_last"]))
    for name, g, w in zip(("dt", "b", "c", "x", "a", "h0"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("s", [1, 7, 37])
def test_rglru_scan_backward_matches_jax_vjp(s):
    """``ref.rglru_scan_bwd_ref`` against ``jax.vjp`` of the reference's
    ``_rglru_scan`` (gates included), odd width, nonzero h0 and dh_last."""
    v = {k: x.astype(np.float32) for k, x in
         _scan_inputs("rglru", s, 13, s).items()}

    def fn(xc, wi, wr, lam, h0):
        return jssm._rglru_scan({"w_input_gate": wi, "w_rec_gate": wr,
                                 "lambda_p": lam}, xc, h0)

    args = [v[k] for k in ("xc", "wi", "wr", "lam", "h0")]
    (hs, _), vjp = jax.vjp(fn, *map(jnp.asarray, args))
    want = vjp((jnp.asarray(v["dhs"]), jnp.asarray(v["dh_last"])))
    targs = list(map(torch.as_tensor, args))
    hs_t, _ = ref.rglru_scan_ref(*targs)
    np.testing.assert_allclose(hs_t.numpy(), np.asarray(hs), rtol=RTOL,
                               atol=ATOL)
    got = ref.rglru_scan_bwd_ref(*targs, hs_t, torch.as_tensor(v["dhs"]),
                                 torch.as_tensor(v["dh_last"]))
    for name, g, w in zip(("xc", "wi", "wr", "lam", "h0"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("kind", ["selective", "rglru"])
def test_scan_functions_pass_gradcheck_in_float64(kind):
    """``torch.autograd.gradcheck`` of the wrappers at tiny sizes in
    float64: the autograd Function with its plain backward on the CPU
    against finite differences, for every input."""
    v = {k: torch.tensor(x, requires_grad=True) for k, x in
         _scan_inputs(kind, 5, 3, 11).items()}
    if kind == "selective":
        v["a"] = v["a"].detach()[:, :4].clone().requires_grad_()
        for k in ("b", "c", "h0"):
            v[k] = v[k].detach()[..., :4].clone().requires_grad_()
        args = [v[k] for k in ("dt", "b", "c", "x", "a", "h0")]
        fn = rc.selective_scan
    else:
        args = [v[k] for k in ("xc", "wi", "wr", "lam", "h0")]
        fn = rc.rglru_scan
    assert torch.autograd.gradcheck(fn, args)


def test_scan_backward_skips_unwanted_inputs_and_counts_nothing_on_cpu():
    """Only inputs that want a gradient get one; a CPU backward is the
    plain version and raises no kernel count."""
    v = {k: torch.tensor(x, dtype=torch.float32) for k, x in
         _scan_inputs("selective", 4, 5, 3).items()}
    x = v["x"].requires_grad_()
    before = (rc.selective_scan.backward_launches,
              rc.rglru_scan.backward_launches)
    y, _ = rc.selective_scan(v["dt"], v["b"], v["c"], x, v["a"], v["h0"])
    (gx,) = torch.autograd.grad(y.sum(), [x])
    assert gx.shape == x.shape
    assert before == (rc.selective_scan.backward_launches,
                      rc.rglru_scan.backward_launches)


@pytest.mark.parametrize("name, b, s, width, states, want", [
    ("selective_scan_bwd", 1, 4096, 8192, 16, 0.2014),
    ("selective_scan_bwd", 2, 2048, 8192, 16, 0.2019),
    ("rglru_scan_bwd", 1, 4096, 4096, 1, 0.0802),
    ("rglru_scan_bwd", 1, 3072, 4096, 1, 0.0601)])
def test_chip_smoke_backward_bound_is_pinned(name, b, s, width, states,
                                             want):
    """The yardstick of the backward kernels' times on the card:
    ``chip_smoke.scan_bwd_bound`` at S = 4096 and at the training shapes
    stays what PERF.md reports, bytes-bound."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    ms, by = chip_smoke.scan_bwd_bound(name, b, s, width, states)
    assert (round(ms, 4), by) == (want, "bytes")


def _cu_constants() -> dict:
    """The ``constexpr int`` constants of ``csrc/recurrence.cu``."""
    import re
    src = (Path(rc.__file__).parent / "csrc" / "recurrence.cu").read_text()
    return {name: int(v) for name, v in
            re.findall(r"constexpr int (\w+) = (\d+);", src)}


@pytest.mark.parametrize("wrapper, kernel", [("SS_BWD_CHUNK", "kSbT"),
                                             ("SS_BWD_CHANNELS", "kSbG")])
def test_selective_backward_shapes_agree_with_the_kernel_source(wrapper,
                                                                kernel):
    """The wrapper's chunk (the kept states' spacing, ``h_keep``'s second
    axis) and channel group (``db_part`` / ``dc_part``'s first axis) are
    the backward kernel's, read from its source: a partial buffer of
    another shape would be written out of range on the card."""
    assert _cu_constants()[kernel] == getattr(rc, wrapper)


# ----------------------------------------------------------------------------
# The train step
# ----------------------------------------------------------------------------

def _reference_train(arch, microbatches, lr=TRAIN_LR):
    jcfg, _ = _cfgs(arch)
    opt = jadamw.AdamW(learning_rate=jadamw.warmup_cosine(
        lr, warmup=1, total=TRAIN_STEPS))
    step = jax.jit(jtf.make_train_step(jcfg, opt, microbatches=microbatches))
    params = jax.tree_util.tree_map(jnp.asarray, _init(arch))
    state = opt.init(params)
    metrics = []
    for i in range(TRAIN_STEPS):
        batch = {k: jnp.asarray(v) for k, v in _batch(jcfg, seed=i).items()}
        params, state, m = step(params, state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, _np(params), _np(state)


def _port_train(arch, microbatches, lr=TRAIN_LR):
    _, tcfg = _cfgs(arch)
    opt = tadamw.AdamW(learning_rate=tadamw.warmup_cosine(
        lr, warmup=1, total=TRAIN_STEPS))
    step = ttf.make_train_step(tcfg, opt, microbatches=microbatches)
    params = ttf.params_from_numpy(_init(arch), tcfg)
    state = opt.init(params)
    metrics = []
    for i in range(TRAIN_STEPS):
        params, state, m = step(params, state,
                                _torch_batch(_batch(tcfg, seed=i)))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, params, state


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_micro_batch_gradients_are_summed_in_f32(dtype):
    """Two micro-batches: the loss and gradients are the two halves'
    f32 sums divided by 2, bitwise (f32 parameters sum in autograd's
    .grad, bf16 ones into f32 sums, as the reference's f32 accumulator)."""
    _, tcfg = _cfgs("qwen1.5-0.5b")
    params = pytree.tree_map(lambda p: p.to(dtype), ttf.params_from_numpy(
        _init("qwen1.5-0.5b"), tcfg))
    batch = _torch_batch(_batch(tcfg, b=4))
    loss, grads = ttf.value_and_grad(params, tcfg, batch, microbatches=2)
    halves = [ttf.value_and_grad(params, tcfg, {k: v[i:i + 2] for k, v in
                                                batch.items()})
              for i in (0, 2)]
    two = torch.tensor(2.0)
    assert torch.equal(loss, (halves[0][0] + halves[1][0]) / two)
    for g, g0, g1 in zip(*(pytree.tree_leaves(t) for t in (
            grads, halves[0][1], halves[1][1]))):
        assert g0.dtype == dtype and g.dtype == torch.float32
        assert torch.equal(g, (g0.float() + g1.float()) / two)


#: The bar for parameters and moments after TRAIN_STEPS steps (see
#: ``_train_bar``).
TRAIN_ATOL = {"params": 2e-3, "m": 1e-4, "v": 3e-5}


def _train_bar(what):
    """Parameters and moments after three AdamW steps at lr 1e-3: atol
    TRAIN_ATOL[what], no relative part. Adam divides each first moment by
    the root of the second, so a coordinate whose gradient is near 0
    moves by up to about lr whatever the gradient's size, and rounding
    decides the direction: f32 rounding reaches the parameters at about
    lr. ``scripts/train_step_bar.py`` measures it on these steps (CPU):
    the reference's float32 run lies up to 3.7e-4 (parameters), 1.4e-5
    (m) and 4.8e-6 (v) from its float64 run, and the port's float32 run
    up to 5.1e-4, 3.3e-5 and 1.1e-5 from that float64 run. Two float32
    runs that each lie within d of it lie within 2 d of each other: the
    bars are twice the larger distance, rounded up to one digit."""
    return 0.0, TRAIN_ATOL[what]


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_matches_reference(arch, microbatches):
    want_metrics, want_params, want_state = _reference_train(
        arch, microbatches)
    got_metrics, params, state = _port_train(arch, microbatches)
    _, tcfg = _cfgs(arch)
    np.testing.assert_allclose(np.array(got_metrics), np.array(want_metrics),
                               rtol=RTOL)
    assert int(state.step) == int(want_state.step) == TRAIN_STEPS
    for what, got, want in (
            ("params", params, ttf.params_from_numpy(want_params, tcfg)),
            ("m", state.m, ttf.params_from_numpy(want_state.m, tcfg)),
            ("v", state.v, ttf.params_from_numpy(want_state.v, tcfg))):
        rtol, atol = _train_bar(what)
        for (path, w), g in zip(_leaves_with_paths(want),
                                pytree.tree_leaves(got)):
            np.testing.assert_allclose(
                g.numpy(), w.numpy(), rtol=rtol, atol=atol,
                err_msg=f"{what} {path}")


# ----------------------------------------------------------------------------
# AdamW
# ----------------------------------------------------------------------------

def _random_tree(arch, seed):
    """A gradient-shaped tree of seeded normals in the reference's
    (stacked) layout."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), _init(arch))


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference_on_the_same_gradients(moment_dtype):
    """Five steps of both optimizers on the same gradients, the reference
    run op by op as its ``apply`` is written (jitted, XLA on the CPU
    contracts ``m b1 + (1 - b1) g`` into a fused multiply-add, which
    rounds once where the written arithmetic rounds three times and, with
    bf16 moments, can flip a moment's bf16 rounding): parameters and
    moments within rtol 1e-6 / atol 1e-7."""
    arch = "recurrentgemma-9b"
    _, tcfg = _cfgs(arch)
    sched = dict(base_lr=1e-2, warmup=2, total=5)
    jopt = jadamw.AdamW(learning_rate=jadamw.warmup_cosine(**sched),
                        moment_dtype=moment_dtype)
    topt = tadamw.AdamW(learning_rate=tadamw.warmup_cosine(**sched),
                        moment_dtype=moment_dtype)
    jp = jax.tree_util.tree_map(jnp.asarray, _init(arch))
    js = jopt.init(jp)
    tp = ttf.params_from_numpy(_init(arch), tcfg)
    ts = topt.init(tp)
    for i in range(5):
        g = _random_tree(arch, i)
        jp, js = jopt.apply(jp, jax.tree_util.tree_map(jnp.asarray, g), js)
        tp, ts = topt.apply(tp, ttf.params_from_numpy(g, tcfg), ts)
    assert int(ts.step) == int(js.step) == 5
    for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        want = ttf.params_from_numpy(_np(_upcast(want)), tcfg)
        for (path, w), g in zip(_leaves_with_paths(want),
                                pytree.tree_leaves(got)):
            np.testing.assert_allclose(g.float().numpy(), w.numpy(),
                                       rtol=OPT_RTOL, atol=OPT_ATOL,
                                       err_msg=path)


def _upcast(tree):
    """A JAX tree with bf16 leaves widened to f32 (exactly) for numpy."""
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), tree)


def test_warmup_cosine_matches_reference():
    for args in ((3e-4, 20, 100), (1e-3, 0, 50), (1e-2, 5, 5)):
        jl, tl = jadamw.warmup_cosine(*args), tadamw.warmup_cosine(*args)
        steps = np.arange(0, 101, dtype=np.int32)
        want = np.asarray(jax.vmap(jl)(jnp.asarray(steps)))
        got = np.array([float(tl(torch.tensor(int(s), dtype=torch.int32)))
                        for s in steps])
        np.testing.assert_allclose(got, want, rtol=OPT_RTOL, atol=0)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "deepseek-v3-671b",
                                  "falcon-mamba-7b"])
def test_weight_decay_changes_exactly_the_leaves_the_reference_decays(arch):
    """Zero gradients and weight_decay > 0: only the decay moves a
    parameter, so the leaves that change are the decayed ones. The
    reference decays every stacked stage leaf (its 1-D leaves too) and
    neither final_norm nor the MTP block's 1-D leaves; the port must
    change exactly those."""
    jcfg, tcfg = _cfgs(arch)
    init = _init(arch)
    if arch == "recurrentgemma-9b":   # one period and a partial one
        jcfg = dataclasses.replace(jcfg, num_layers=5)
        tcfg = dataclasses.replace(tcfg, num_layers=5)
        assert [r for _, r in tcfg.stages()] == [1, 1]
        init = _jax_init(jcfg, 1)
    zeros = jax.tree_util.tree_map(np.zeros_like, init)
    jopt = jadamw.AdamW(learning_rate=1e-2, weight_decay=0.5)
    jp = jax.tree_util.tree_map(jnp.asarray, init)
    jp2, _ = jopt.apply(jp, jax.tree_util.tree_map(jnp.asarray, zeros),
                        jopt.init(jp))
    changed_ref = ttf.params_from_numpy(jax.tree_util.tree_map(
        lambda a, b: np.full(a.shape, np.any(a != b)), _np(jp2), init), tcfg)
    topt = tadamw.AdamW(learning_rate=1e-2, weight_decay=0.5)
    tp = ttf.params_from_numpy(init, tcfg)
    before = [p.clone() for p in pytree.tree_leaves(tp)]
    tp, _ = topt.apply(tp, ttf.params_from_numpy(zeros, tcfg),
                       topt.init(tp))
    got = {path: bool((p != b).any())
           for (path, p), b in zip(_leaves_with_paths(tp), before)}
    want = {path: bool(c.all())
            for path, c in _leaves_with_paths(changed_ref)}
    assert got == want
    # The trap itself: 1-D layer leaves are decayed, final_norm is not.
    assert want["layers/0/norm1"] and not want["final_norm"]
    if "mtp" in tp:
        assert not want["mtp/norm"] and not want["mtp/block/norm1"]
        assert want["mtp/proj/w"]


def test_state_from_numpy_continues_a_jax_started_run():
    """Two reference AdamW steps, then the state and parameters carried
    across: the port's third step lands on the reference's third."""
    arch = "falcon-mamba-7b"
    _, tcfg = _cfgs(arch)
    opt_kw = dict(learning_rate=1e-2, moment_dtype="bfloat16")
    jopt, topt = jadamw.AdamW(**opt_kw), tadamw.AdamW(**opt_kw)
    jp = jax.tree_util.tree_map(jnp.asarray, _init(arch))
    js = jopt.init(jp)
    for i in range(2):
        jp, js = jopt.apply(jp, jax.tree_util.tree_map(
            jnp.asarray, _random_tree(arch, i)), js)
    tp = ttf.params_from_numpy(_np(jp), tcfg)
    ts = tadamw.state_from_numpy(_np(js), tcfg)
    assert ts.m["layers"][0]["mixer"]["x_proj"].dtype == torch.bfloat16
    g = _random_tree(arch, 2)
    jp, js = jopt.apply(jp, jax.tree_util.tree_map(jnp.asarray, g), js)
    tp, ts = topt.apply(tp, ttf.params_from_numpy(g, tcfg), ts)
    assert int(ts.step) == int(js.step) == 3
    for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        want = ttf.params_from_numpy(_np(_upcast(want)), tcfg)
        for (path, w), p in zip(_leaves_with_paths(want),
                                pytree.tree_leaves(got)):
            np.testing.assert_allclose(p.float().numpy(), w.numpy(),
                                       rtol=OPT_RTOL, atol=OPT_ATOL,
                                       err_msg=path)


# ----------------------------------------------------------------------------
# The data pipeline
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "internvl2-26b",
                                  "falcon-mamba-7b"])
def test_corpus_batches_equal_the_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    shape = ("train", 32, 4, "train")
    jc = jpipe.SyntheticCorpus(jcfg, jconfig.InputShape(*shape), seed=3)
    tc = tpipe.SyntheticCorpus(tcfg, tconfig.InputShape(*shape), seed=3)
    for i in (0, 1, 7):
        want, got = jc.batch(i), tc.batch(i)
        assert want.keys() == got.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    assert (tcfg.input_mode == "embeddings") == (got["inputs"].ndim == 3)


@pytest.mark.parametrize("shape", list(jconfig.INPUT_SHAPES))
@pytest.mark.parametrize("arch", jreg.list_archs())
def test_input_specs_match_the_reference(arch, shape):
    jcfg, tcfg = jreg.get(arch), treg.get(arch)
    want = jpipe.input_specs(jcfg, jconfig.INPUT_SHAPES[shape])
    got = tpipe.input_specs(tcfg, tconfig.INPUT_SHAPES[shape])
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(want[k].shape)
        assert str(got[k].dtype).removeprefix("torch.") == str(
            want[k].dtype)


# ----------------------------------------------------------------------------
# Checkpoints
# ----------------------------------------------------------------------------

def _ckpt_tree():
    _, tcfg = _cfgs("qwen1.5-0.5b")
    params = ttf.params_from_numpy(_init("qwen1.5-0.5b"), tcfg)
    params["layers"][0]["norm1"] = params["layers"][0]["norm1"].to(
        torch.bfloat16) + 0.001
    opt = tadamw.AdamW(moment_dtype="bfloat16")
    state = opt.init(params)
    state.m["final_norm"].fill_(-3.14159)
    return {"params": params, "opt": state._replace(
        step=torch.tensor(7, dtype=torch.int32))}


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    tree = _ckpt_tree()
    path = tckpt.save(str(tmp_path), 5, tree)
    assert path.endswith("step_00000005.npz")
    target = {"params": pytree.tree_map(torch.zeros_like, tree["params"]),
        "opt": tadamw.AdamW(moment_dtype="bfloat16").init(tree["params"])}
    back = tckpt.restore(str(tmp_path), target)
    assert isinstance(back["opt"], tadamw.AdamWState)
    assert int(back["opt"].step) == 7 and back["opt"].step.ndim == 0
    got_items = dict(tckpt._flatten(back))
    for key, want in tckpt._flatten(tree):
        got = got_items[key]
        assert got.dtype == want.dtype, key
        if want.dtype == torch.bfloat16:   # compare the bits
            got, want = got.view(torch.int16), want.view(torch.int16)
        assert torch.equal(got, want), key
    # the reference's format: flat '/'-joined keys, bf16 leaves listed
    with np.load(path) as data:
        assert "opt/m/final_norm" in data and "opt/step" in data
        assert data["params/layers/0/norm1"].dtype == np.uint16
        assert "params/layers/0/norm1" in data[tckpt.BF16_KEYS].tolist()


def test_checkpoint_keeps_the_newest_and_finds_the_latest(tmp_path):
    d = str(tmp_path / "ck")
    assert tckpt.latest_step(d) is None
    tree = {"w": torch.arange(6.0).reshape(2, 3)}
    for step in (1, 2, 3, 4, 5):
        tckpt.save(d, step, tree, keep=2)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_00000004.npz", "step_00000005.npz"]
    assert tckpt.latest_step(d) == 5
    with pytest.raises(FileNotFoundError):
        tckpt.restore(str(tmp_path / "empty"), tree)


def test_checkpoint_refuses_a_missing_key_and_a_wrong_shape(tmp_path):
    tckpt.save(str(tmp_path), 1, {"w": torch.zeros(2, 3)})
    with pytest.raises(KeyError):
        tckpt.restore(str(tmp_path), {"w": torch.zeros(2, 3),
                                      "b": torch.zeros(3)})
    with pytest.raises(ValueError):
        tckpt.restore(str(tmp_path), {"w": torch.zeros(3, 2)})
    # the reference refuses the same two
    with pytest.raises(KeyError):
        jckpt.restore(str(tmp_path), {"w": np.zeros((2, 3)),
                                      "b": np.zeros(3)})


def test_an_interrupted_write_leaves_the_last_checkpoint(tmp_path,
                                                         monkeypatch):
    d = str(tmp_path)
    tckpt.save(d, 1, {"w": torch.ones(4)})

    def fail(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", fail)
    with pytest.raises(OSError):
        tckpt.save(d, 2, {"w": torch.full((4,), 2.0)})
    monkeypatch.undo()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000001.npz"]
    assert tckpt.latest_step(d) == 1
    back = tckpt.restore(d, {"w": torch.zeros(4)})
    assert torch.equal(back["w"], torch.ones(4))


# ----------------------------------------------------------------------------
# launch.train
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("size", ["reduced", "25m", "100m"])
def test_size_config_equals_the_reference(size):
    for arch in jreg.list_archs():
        want = jtrain.size_config(jreg.get(arch), size)
        got = ttrain.size_config(treg.get(arch), size)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), arch


def _main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert ttrain.main(argv) == 0
    return out.getvalue()


def test_train_main_checkpoints_and_resumes(tmp_path):
    argv = ["--size", "reduced", "--seq", "16", "--batch", "2",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2", "--device",
            "cpu", "--log-every", "1"]
    first = _main(argv + ["--steps", "4"])
    assert first.splitlines()[0].startswith("training granite-3-2b-reduced")
    assert "resumed" not in first and "step     4 loss" in first
    assert tckpt.latest_step(str(tmp_path)) == 4
    second = _main(argv + ["--steps", "6"])
    assert "resumed from step 4" in second
    assert "step     5 loss" in second and "done: 2 steps" in second
    losses = [float(line.split()[3]) for line in (first + second).splitlines()
              if line.startswith("step")]
    assert len(losses) == 6 and np.all(np.isfinite(losses))


def test_train_main_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(["--size", "reduced", "--steps", "1"])
