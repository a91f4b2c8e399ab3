"""The port's non-dense mixers vs the JAX package's, unit by unit.

``models.moe.moe_ffn`` (capacity drops, the dropless capacity, tied
router probabilities), ``models.ssm`` (Mamba and RG-LRU, full sequence
and decode), ``models.attention``'s MLA (the weight-absorbed decode
continuing the forward) and the int8 ``QuantKVCache`` run on the same
numpy-seeded inputs and the JAX package's weights. The recurrence scans'
plain versions (``kernels.ref``, the CPU path of ``kernels.recurrence``)
are held to the reference's ``lax.scan`` through its ``_mamba_inner`` and
``_rglru_scan``, and the flash plain version at head_dim 256 (MQA, a
window) to the Pallas kernel in interpret mode.

Bars: rtol 1e-4 / atol 1e-5 for functions (the reference's kernel bar,
tests/test_aggregation.py:51; both packages round the same f32 operations
in other orders) and rtol 1e-4 / atol 1e-4 for logits
(tests/test_flash_attention.py:74); the MoE keep masks and the int8 codes
exactly.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.kernels.flash_attention import gqa_flash as jgqa_flash
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro_torch.configs import registry as treg
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import recurrence as trc
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm

from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-4, 1e-5          # tests/test_aggregation.py:51
LOGIT_ATOL = 1e-4                # tests/test_flash_attention.py:74


def _cfgs(arch, **changes):
    return (dataclasses.replace(jreg.reduced(jreg.get(arch)), **changes),
            dataclasses.replace(treg.reduced(treg.get(arch)), **changes))


def _t(tree):
    """A JAX parameter tree as torch tensors (the same numbers)."""
    return jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)),
                                  tree)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


# ----------------------------------------------------------------------------
# MoE
# ----------------------------------------------------------------------------

def _jax_keep(params, x, cfg, cf):
    """The reference's routing decisions (src/repro/models/moe.py:57-76),
    which ``moe_ffn`` keeps inside: top-k experts and the keep mask."""
    t = x.shape[0] * x.shape[1]
    e, k = cfg.num_experts, cfg.experts_per_token
    probs = jax.nn.softmax(x.reshape(t, -1).astype(jnp.float32)
                           @ params["router"], axis=-1)
    _, top_i = jax.lax.top_k(probs, k)
    cap = int(max(1, (t * k) / e * cf))
    flat_e = top_i.reshape(-1)
    eo = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(eo, axis=0) - eo,
                              flat_e[:, None], 1)[:, 0]
    return np.asarray(flat_e), np.asarray(pos < cap), cap


@pytest.mark.parametrize("case", ["drops", "dropless", "tied"])
def test_moe_ffn_matches_jax(case):
    """Capacity 1.25 with drops, the decode's dropless E / k, and a router
    whose columns 0 and 1 (and 2 and 3) are equal, so every token's top
    two probabilities tie: ``lax.top_k`` puts the lower index first, so
    must the port (its slot order sets the queue order and the aux loss's
    first choices)."""
    jcfg, tcfg = _cfgs("deepseek-v3-671b")
    jp = jmoe.init_moe(jax.random.PRNGKey(4), jcfg, jnp.float32)
    # A router 50 times the initial scale and tokens with a common offset:
    # the experts' loads differ, so a queue overflows at capacity 1.25.
    r = np.asarray(jp["router"]) * 50.0
    if case == "tied":
        r[:, 1], r[:, 3] = r[:, 0], r[:, 2]
    jp = dict(jp, router=jnp.asarray(r))
    cf = tcfg.num_experts / tcfg.experts_per_token if case == "dropless" \
        else 1.25
    x = _normal(5, 2, 24, tcfg.d_model) + 1.0
    want, want_aux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg,
                                  capacity_factor=cf)
    tp = _t(jp)
    got, aux = tmoe.moe_ffn(tp, torch.as_tensor(x), tcfg,
                            capacity_factor=cf)
    # Outputs up to |8| (the offset tokens): the logit bar's atol.
    _close(got, want, atol=LOGIT_ATOL)
    _close(aux, want_aux)
    flat_e, keep, cap = _jax_keep(jp, jnp.asarray(x), jcfg, cf)
    r = tmoe.route(tp["router"], torch.as_tensor(x).reshape(-1, x.shape[-1]),
                   tcfg, cf)
    assert r.capacity == cap
    np.testing.assert_array_equal(r.experts.numpy(), flat_e)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert keep.all() == (case != "drops")   # drops only where meant


@pytest.mark.parametrize("dropless", [False, True])
@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "grok-1-314b"])
def test_moe_keep_masks_in_the_model_equal_jax(arch, dropless, monkeypatch):
    """A forward of the reduced model at the prefill's capacity 1.25 (with
    drops) and at the dropless E / k: each MoE layer's keep mask equals the
    reference routing's on the same layer input, and the logits the JAX
    forward's. The first 24 tokens of each row are one id, so their hidden
    states agree and pick the same experts: at 1.25 those queues overflow."""
    from repro_torch.models import transformer as ttf
    jcfg, tcfg = _cfgs(arch)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    tp = ttf.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    cf = tcfg.num_experts / tcfg.experts_per_token if dropless else 1.25
    toks = np.random.default_rng(17).integers(0, tcfg.vocab_size, (2, 32))
    toks[:, :24] = 7
    seen = []
    inner = tmoe.moe_ffn

    def recording(params, x, cfg, **kw):
        seen.append((params["router"], x))
        return inner(params, x, cfg, **kw)

    monkeypatch.setattr(tmoe, "moe_ffn", recording)
    got, _ = ttf.forward(tp, tcfg, torch.as_tensor(toks), capacity_factor=cf)
    want, _ = jtf.forward(jp, jcfg, jnp.asarray(toks, jnp.int32),
                          capacity_factor=cf)
    _close(got, want, atol=LOGIT_ATOL)
    assert len(seen) == sum(s.ffn == "moe" for s in tcfg.layer_specs())
    drops = 0
    for router, x in seen:
        keep = tmoe.route(router, x.reshape(-1, x.shape[-1]), tcfg, cf).keep
        _, want_keep, _ = _jax_keep({"router": jnp.asarray(router.numpy())},
                                    jnp.asarray(x.numpy()), jcfg, cf)
        np.testing.assert_array_equal(keep.numpy(), want_keep)
        drops += int((~keep).sum())
    assert (drops == 0) == dropless


# ----------------------------------------------------------------------------
# Mamba and RG-LRU
# ----------------------------------------------------------------------------

#: Config changes that give each kind a channel count that is not a
#: multiple of 32 (nor of 16): d_inner = 2 d_model = 200, lru_width = 200.
RAGGED = {"mamba": dict(d_model=100), "rglru": dict(lru_width=200)}


def _ssm_params(kind, **changes):
    arch = "falcon-mamba-7b" if kind == "mamba" else "recurrentgemma-9b"
    jcfg, tcfg = _cfgs(arch, **changes)
    init = jssm.init_mamba if kind == "mamba" else jssm.init_rglru
    jp = init(jax.random.PRNGKey(6), jcfg, jnp.float32)
    if kind == "mamba":   # nonzero biases, so they are exercised
        jp = dict(jp, conv_b=jnp.asarray(_normal(7, tcfg.ssm_d_inner,
                                                 scale=0.1)),
                  dt_bias=jnp.asarray(_normal(8, tcfg.ssm_d_inner,
                                              scale=0.5)))
    else:
        jp = dict(jp, conv_b=jnp.asarray(_normal(7, tcfg.rglru_width,
                                                 scale=0.1)),
                  lambda_p=jnp.asarray(_normal(8, tcfg.rglru_width) + 2.0))
    return jcfg, tcfg, jp, _t(jp)


@pytest.mark.parametrize("kind", ["mamba", "rglru"])
def test_recurrent_forward_matches_jax(kind):
    jcfg, tcfg, jp, tp = _ssm_params(kind)
    x = _normal(9, 2, 40, tcfg.d_model)
    jfwd = jssm.mamba_forward if kind == "mamba" else jssm.rglru_forward
    tfwd = tssm.mamba_forward if kind == "mamba" else tssm.rglru_forward
    before = (trc.selective_scan.launches, trc.rglru_scan.launches)
    _close(tfwd(tp, torch.as_tensor(x), tcfg),
           jfwd(jp, jnp.asarray(x), jcfg))
    # CPU tensors run the plain versions and never launch.
    assert (trc.selective_scan.launches, trc.rglru_scan.launches) == before


@pytest.mark.parametrize("kind", ["mamba", "rglru"])
def test_recurrent_decode_matches_jax(kind):
    """Eight one-token decode steps from a random state in both packages,
    then the state's conv history and recurrent state themselves."""
    jcfg, tcfg, jp, tp = _ssm_params(kind)
    if kind == "mamba":
        jst = jssm.MambaState(
            jnp.asarray(_normal(10, 2, tcfg.ssm_conv - 1, tcfg.ssm_d_inner)),
            jnp.asarray(_normal(11, 2, tcfg.ssm_d_inner, tcfg.ssm_state)))
        tst = tssm.MambaState(*(torch.tensor(np.asarray(a)) for a in jst))
        jdec, tdec = jssm.mamba_decode, tssm.mamba_decode
    else:
        jst = jssm.RGLRUState(
            jnp.asarray(_normal(10, 2, tcfg.ssm_conv - 1, tcfg.rglru_width)),
            jnp.asarray(_normal(11, 2, tcfg.rglru_width)))
        tst = tssm.RGLRUState(*(torch.tensor(np.asarray(a)) for a in jst))
        jdec, tdec = jssm.rglru_decode, tssm.rglru_decode
    for step in range(8):
        x = _normal(20 + step, 2, 1, tcfg.d_model)
        want, jst = jdec(jp, jnp.asarray(x), jst, jcfg)
        got, tst = tdec(tp, torch.as_tensor(x), tst, tcfg)
        _close(got, want)
    for got, want in zip(dataclasses.astuple(tst), jst):
        _close(got, want)


@pytest.mark.parametrize("width", ["config", "ragged"])
@pytest.mark.parametrize("s", [1, 33, 37])
def test_selective_scan_plain_version_matches_lax_scan(s, width):
    """``kernels.recurrence.selective_scan`` on CPU tensors (the plain step
    loop) inside ``_mamba_inner`` vs the reference's ``_mamba_inner`` and
    its ``lax.scan``: y and the last state, from a nonzero h0; at a decode
    step's S = 1 and at lengths that end inside a chunk of the kernel's
    time axis, at the reduced config's d_inner and at one that is not a
    multiple of 32 (the ragged shapes the kernel meets on the card)."""
    jcfg, tcfg, jp, tp = _ssm_params(
        "mamba", **(RAGGED["mamba"] if width == "ragged" else {}))
    b, di, st = 2, tcfg.ssm_d_inner, tcfg.ssm_state
    assert (di % 32 != 0) == (width == "ragged")
    xc, z = _normal(30, b, s, di), _normal(31, b, s, di)
    h0 = _normal(32, b, di, st)
    want_y, want_h = jssm._mamba_inner(jp, jnp.asarray(xc), jnp.asarray(z),
                                       jcfg, jnp.asarray(h0))
    got_y, got_h = tssm._mamba_inner(tp, torch.as_tensor(xc),
                                     torch.as_tensor(z), tcfg,
                                     torch.as_tensor(h0))
    # y sums 16 products h c of up to ~50 each a step: the logit atol.
    _close(got_y, want_y, atol=LOGIT_ATOL)
    _close(got_h, want_h)


@pytest.mark.parametrize("width", ["config", "ragged"])
@pytest.mark.parametrize("s", [1, 33, 37])
def test_rglru_scan_plain_version_matches_lax_scan(s, width):
    """The same for ``rglru_scan`` against ``_rglru_scan``: hs and the last
    state at S = 1, 33 and 37, at a width of 256 and of 200."""
    jcfg, tcfg, jp, tp = _ssm_params(
        "rglru", **(RAGGED["rglru"] if width == "ragged" else {}))
    b, w = 2, tcfg.rglru_width
    assert (w % 32 != 0) == (width == "ragged")
    xc, h0 = _normal(33, b, s, w, scale=2.0), _normal(34, b, w)
    want_hs, want_h = jssm._rglru_scan(jp, jnp.asarray(xc), jnp.asarray(h0))
    got_hs, got_h = trc.rglru_scan(torch.as_tensor(xc), tp["w_input_gate"],
                                   tp["w_rec_gate"], tp["lambda_p"],
                                   torch.as_tensor(h0))
    _close(got_hs, want_hs)
    _close(got_h, want_h)


def test_scan_plain_versions_compute_in_float64():
    """The on-card yardstick: float64 inputs give float64 outputs close to
    the f32 ones."""
    rng = np.random.default_rng(35)
    b, s, di, st = 1, 9, 16, 4
    args = [rng.uniform(0.01, 0.5, (b, s, di)), rng.normal(size=(b, s, st)),
            rng.normal(size=(b, s, st)), rng.normal(size=(b, s, di)),
            -rng.uniform(0.5, 2.0, (di, st)), rng.normal(size=(b, di, st))]
    y64, h64 = tref.selective_scan_ref(*(torch.tensor(a) for a in args))
    y32, h32 = tref.selective_scan_ref(*(torch.tensor(a).float()
                                         for a in args))
    assert y64.dtype == h64.dtype == torch.float64
    np.testing.assert_allclose(y32.numpy(), y64.numpy(), rtol=RTOL,
                               atol=ATOL)
    gates = [rng.normal(size=(b, s, di)), rng.normal(size=di),
             rng.normal(size=di), rng.normal(size=di) + 2.0,
             rng.normal(size=(b, di))]
    hs64, _ = tref.rglru_scan_ref(*(torch.tensor(a) for a in gates))
    hs32, _ = tref.rglru_scan_ref(*(torch.tensor(a).float() for a in gates))
    assert hs64.dtype == torch.float64
    np.testing.assert_allclose(hs32.numpy(), hs64.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("name, width, states, want", [
    ("selective_scan", 8192, 16, 0.1208), ("rglru_scan", 4096, 1, 0.0401)])
def test_chip_smoke_scan_bound_is_pinned(name, width, states, want):
    """The yardstick of the scans' times on the card: ``chip_smoke.
    scan_bound`` at B = 1, S = 4096 and the models' widths (falcon-mamba's
    di = 8192 with 16 states, recurrentgemma's w = 4096) stays what
    PERF.md reports, bytes-bound."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    ms, by = chip_smoke.scan_bound(name, 1, 4096, width, states)
    assert (round(ms, 4), by) == (want, "bytes")


def test_scan_wrappers_reject_disagreeing_shapes():
    z = torch.zeros
    with pytest.raises(ValueError, match="shapes disagree"):
        trc.selective_scan(z(1, 4, 8), z(1, 4, 16), z(1, 4, 16), z(1, 4, 8),
                           z(8, 16), z(1, 8, 8))
    with pytest.raises(ValueError, match="shapes disagree"):
        trc.rglru_scan(z(1, 4, 8), z(8), z(8), z(4), z(1, 8))
    with pytest.raises(ValueError, match="h0 is on meta"):
        trc.rglru_scan(z(1, 4, 8), z(8), z(8), z(8), z(1, 8, device="meta"))


# ----------------------------------------------------------------------------
# MLA and the int8 KV cache
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 8])
def test_mla_decode_continues_mla_forward_as_jax(window):
    """Fill an MLA cache from a 12-token prompt (the reference's prefill
    recomputation, a ring of ``window`` when set), then decode 6 tokens:
    each step's output against the JAX package's, and the forward."""
    jcfg, tcfg = _cfgs("deepseek-v3-671b")
    jp = jattn.init_mla(jax.random.PRNGKey(12), jcfg, jnp.float32)
    tp = _t(jp)
    x = _normal(13, 2, 12, tcfg.d_model)
    _close(tattn.mla_forward(tp, torch.as_tensor(x), tcfg, window=window),
           jattn.mla_forward(jp, jnp.asarray(x), jcfg, window=window))
    spec = jreg.get("deepseek-v3-671b").layer_specs()[0]
    jc = jtf._prefill_cache(jp, spec, jnp.asarray(x), jcfg, window, 18)
    c_kv, k_rope = tattn.mla_prefill_latent(tp, torch.as_tensor(x), tcfg)
    t = min(window, 18) if window else 18
    tc = tattn.MLACache.zeros(2, t, tcfg.kv_lora_rank, tcfg.qk_rope_head_dim,
                              torch.float32)
    for pos in range(12):   # the same cache, one token at a time
        slot = pos % window if window else pos
        tc.c_kv[:, slot], tc.k_rope[:, slot] = c_kv[:, pos], k_rope[:, pos]
    _close(tc.c_kv, jc.c_kv)
    _close(tc.k_rope, jc.k_rope)
    for step in range(6):
        xt = _normal(40 + step, 2, 1, tcfg.d_model)
        want, jc = jattn.mla_decode(jp, jnp.asarray(xt), jc, 12 + step, jcfg,
                                    window=window)
        got, tc = tattn.mla_decode(tp, torch.as_tensor(xt), tc, 12 + step,
                                   tcfg, window=window)
        _close(got, want)
    _close(tc.c_kv, jc.c_kv)


def test_quantize_heads_equals_jax():
    x = _normal(14, 2, 8, 4, 16, scale=3.0)
    jq, js = jattn._quantize_heads(jnp.asarray(x))
    tq, ts = tattn._quantize_heads(torch.as_tensor(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tattn._dequantize_heads(tq, ts, torch.float32).numpy(),
        np.asarray(jattn._dequantize_heads(jq, js, jnp.float32)))


@pytest.mark.parametrize("window", [0, 8])
def test_quant_kv_cache_decode_matches_jax(window):
    """Twelve decode steps through an int8 cache (a ring of 8 when
    windowed) in both packages, rtol 1e-4; the codes and scales the port
    writes in place equal the reference's. Both packages must quantize the
    same k and v: weights on a 1/64 grid and integer inputs make the
    projections exact, and RoPE is off (its cos / sin differ in the last
    bit between the frameworks, enough to flip a code at a rounding
    boundary by one step of the scale)."""
    jcfg, tcfg = _cfgs("qwen1.5-0.5b", pos_embedding="none")
    jp = jattn.init_gqa(jax.random.PRNGKey(15), jcfg, jnp.float32)
    jp = jax.tree_util.tree_map(lambda a: jnp.round(a * 64) / 64, jp)
    tp = _t(jp)
    t = window or 12
    jc = jattn.QuantKVCache.zeros(2, t, tcfg.num_kv_heads, tcfg.head_dim)
    tc = tattn.QuantKVCache.zeros(2, t, tcfg.num_kv_heads, tcfg.head_dim)
    rng = np.random.default_rng(16)
    for pos in range(12):
        x = rng.integers(-2, 3, (2, 1, tcfg.d_model)).astype(np.float32)
        want, jc = jattn.gqa_decode(jp, jnp.asarray(x), jc, pos, jcfg,
                                    window=window)
        got, tc = tattn.gqa_decode(tp, torch.as_tensor(x), tc, pos, tcfg,
                                   window=window)
        _close(got, want, atol=LOGIT_ATOL)
    for got, want in zip(dataclasses.astuple(tc), jc):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------------------
# Flash at head_dim 256 (recurrentgemma's local attention)
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_head_dim_256_mqa_window_matches_pallas(dtype):
    """recurrentgemma's local attention shape, cut down: MQA (4 query heads
    on 1 kv head), head_dim 256, a window of 48. The wrapper takes dh 256
    (the card's kernel since this change); its CPU plain version vs the
    Pallas kernel in interpret mode, at the reference's flash bars
    (tests/test_flash_attention.py: 1e-4 / 1e-5 in f32, 3e-2 in bf16)."""
    assert 256 in tfa.HEAD_DIMS
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    q, k, v = (_normal(60 + i, 2, 128, h, 256)
               for i, h in enumerate((4, 1, 1)))
    want = jgqa_flash(*(jnp.asarray(a, jd) for a in (q, k, v)), window=48,
                      bq=64, bk=64)
    got = tfa.gqa_flash(*(torch.as_tensor(a).to(td) for a in (q, k, v)),
                        window=48, bq=64, bk=64)
    assert got.shape == (2, 128, 4, 256) and got.dtype == td
    tol = (RTOL, ATOL) if dtype == "float32" else (3e-2, 3e-2)
    _close(got, jnp.asarray(want, jnp.float32), *tol)
