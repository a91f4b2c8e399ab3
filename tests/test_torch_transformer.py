"""The port's transformer serving path vs the JAX package's.

Configurations and their reduced variants must be equal field by field.
Layers (``rms_norm``, ``apply_rope``, the SiLU / GELU ``mlp``), the dense
decoders and the non-dense ones (MLA + MoE + MTP, MoE, Mamba, RG-LRU with
local attention: ``forward``, ``prefill``, ``decode_step`` with the flash
kernel's plain version or the chunked path, the windowed ring-buffer
decode), ``init_cache`` for every config, ``cast_params`` and the serving
loop (``place_batches``, greedy tokens of ``serve``) run on the same
seeded numpy inputs and the JAX package's weights, carried across by
``transformer.params_from_numpy``. Logits must agree within the
reference's model-level bar, rtol 1e-4 / atol 1e-4
(tests/test_flash_attention.py:74); layers within rtol 1e-5 / atol 1e-5
in float32 (both packages round the same f32 operations, in other orders)
and one bf16 rounding (rtol 2**-7) in bfloat16; placements and greedy
tokens exactly; the served copy's logits bitwise.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import serve as jserve
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch.configs import registry as treg
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf

from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

LOGIT_RTOL, LOGIT_ATOL = 1e-4, 1e-4   # tests/test_flash_attention.py:74
LAYER_TOL = 1e-5
BF16_RTOL = 2.0 ** -7
DENSE = ["qwen1.5-0.5b", "starcoder2-3b", "granite-3-2b"]
NOT_DENSE = ["deepseek-v3-671b", "falcon-mamba-7b", "grok-1-314b",
             "recurrentgemma-9b"]
IMPLS = ["flash", "chunked"]
DECODE_STEPS = 6


def _cfgs(arch, impl="chunked", **changes):
    """(JAX config, port config): the reduced arch with ``impl``."""
    j = dataclasses.replace(jreg.reduced(jreg.get(arch)), attn_impl=impl,
                            **changes)
    t = dataclasses.replace(treg.reduced(treg.get(arch)), attn_impl=impl,
                            **changes)
    return j, t


@functools.lru_cache(maxsize=None)
def _params(arch):
    """The JAX package's random weights of the reduced arch, and the same
    numbers as the port's parameters."""
    jcfg, tcfg = _cfgs(arch)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, ttf.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                     tcfg)


def _close(got, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


# ----------------------------------------------------------------------------
# Configurations
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jreg.list_archs())
def test_configs_and_reduced_equal_the_reference(arch):
    assert treg.list_archs() == jreg.list_archs()
    assert treg.canonical(arch) == jreg.canonical(arch)
    for jc, tc in ((jreg.get(arch), treg.get(arch)),
                   (jreg.reduced(jreg.get(arch)),
                    treg.reduced(treg.get(arch)))):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert [dataclasses.astuple(s) for s in tc.layer_specs()] == \
            [dataclasses.astuple(s) for s in jc.layer_specs()]
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
    assert treg.get("qwen1.5-0.5b").name == "qwen1.5-0.5b"


# ----------------------------------------------------------------------------
# Layers
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    jd, td = jlayers.dtype_of(dtype), tlayers.dtype_of(dtype)
    want = jlayers.rms_norm(jnp.asarray(x, jd), jnp.asarray(scale), 1e-6)
    got = tlayers.rms_norm(torch.as_tensor(x).to(td), torch.as_tensor(scale),
                           1e-6)
    assert got.dtype == td
    tol = LAYER_TOL if dtype == "float32" else BF16_RTOL
    _close(got, want, rtol=tol, atol=LAYER_TOL)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 4, 64)).astype(np.float32)
    pos = np.arange(100, 109)[None].repeat(2, 0).astype(np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tlayers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), theta)
    _close(got, want, rtol=LAYER_TOL, atol=LAYER_TOL)


@pytest.mark.parametrize("gated,activation", [(True, "silu"),
                                              (False, "gelu")])
def test_mlp_matches_jax(gated, activation):
    jp = jlayers.init_mlp(jax.random.PRNGKey(3), 64, 96, jnp.float32, gated)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    x = np.random.default_rng(2).normal(size=(2, 7, 64)).astype(np.float32)
    want = jlayers.mlp(jp, jnp.asarray(x), activation=activation)
    got = tlayers.mlp(tp, torch.as_tensor(x), activation=activation)
    _close(got, want, rtol=LAYER_TOL, atol=LAYER_TOL)


# ----------------------------------------------------------------------------
# The dense decoder
# ----------------------------------------------------------------------------

def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (b, s)).astype(np.int32)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_jax(arch, impl):
    jcfg, tcfg = _cfgs(arch, impl)
    jp, tp = _params(arch)
    toks = _tokens(tcfg, 2, 64, 4)
    want, _ = jtf.forward(jp, jcfg, jnp.asarray(toks))
    before = tfa.flash_attention.launches
    got, aux = ttf.forward(tp, tcfg, torch.as_tensor(toks))
    assert got.shape == (2, 64, tcfg.vocab_size) and float(aux) == 0.0
    _close(got, want)
    assert tfa.flash_attention.launches == before


def _jax_decode(jcfg, window=0):
    return jax.jit(lambda p, c, tok, pos: jtf.decode_step(
        p, jcfg, c, tok, pos, window=window))


def _prefill_and_decode(arch, impl, s, window=0, cache_len=0):
    """Prefill [2, s] prompts, then DECODE_STEPS greedy steps of the JAX
    package's tokens through both packages; returns both logits lists."""
    jcfg, tcfg = _cfgs(arch, impl)
    jp, tp = _params(arch)
    toks = _tokens(tcfg, 2, s, 5)
    jl, jc = jtf.prefill(jp, jcfg, jnp.asarray(toks), window=window,
                         cache_len=cache_len)
    tl, tc = ttf.prefill(tp, tcfg, torch.as_tensor(toks), window=window,
                         cache_len=cache_len)
    pairs = [(tl, jl)]
    decode = _jax_decode(jcfg, window)
    for step in range(DECODE_STEPS):
        tok = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)
        jl, jc = decode(jp, jc, jnp.asarray(tok), jnp.asarray(s + step))
        tl, tc = ttf.decode_step(tp, tcfg, tc, torch.as_tensor(tok), s + step,
                                 window=window)
        pairs.append((tl, jl))
    return pairs


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_jax(arch, impl):
    pairs = _prefill_and_decode(arch, impl, 16, cache_len=16 + DECODE_STEPS)
    assert pairs[0][0].shape == (2, 1, _cfgs(arch)[1].vocab_size)
    for got, want in pairs:
        _close(got, want)


@pytest.mark.parametrize("impl", IMPLS)
def test_windowed_ring_buffer_decode_matches_jax(impl):
    """Prefill 32 tokens into a 16-entry ring, then decode past it."""
    for got, want in _prefill_and_decode("qwen1.5-0.5b", impl, 32,
                                         window=16):
        _close(got, want)


@pytest.mark.parametrize("arch", ["musicgen-medium", "internvl2-26b"])
def test_audio_and_vlm_decoders_match_jax(arch):
    """Sinusoidal positions with the plain GELU MLP (musicgen), and
    precomputed [B, S, D] embeddings as input (internvl2's frontend stub)."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(arch)
    if tcfg.input_mode == "embeddings":
        x = np.random.default_rng(6).normal(
            size=(2, 32, tcfg.d_model)).astype(np.float32)
    else:
        x = _tokens(tcfg, 2, 32, 6)
    want, _ = jtf.forward(jp, jcfg, jnp.asarray(x))
    got, _ = ttf.forward(tp, tcfg, torch.as_tensor(x))
    _close(got, want)


def test_activation_dtype_copy_gives_the_same_numbers():
    """``cast_params`` (served weights) is bitwise the per-use casts."""
    _, tcfg = _cfgs("starcoder2-3b", activation_dtype="bfloat16")
    _, tp = _params("starcoder2-3b")
    toks = torch.as_tensor(_tokens(tcfg, 2, 16, 7))
    a, _ = ttf.forward(tp, tcfg, toks)
    cast = ttf.cast_params(tp, tcfg)
    assert cast["layers"][0]["mixer"]["wq"].dtype == torch.bfloat16
    b, _ = ttf.forward(cast, tcfg, toks)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)


# ----------------------------------------------------------------------------
# The decoders off the dense path (MLA + MoE + MTP, MoE, Mamba, RG-LRU with
# local attention)
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", NOT_DENSE)
def test_non_dense_forward_matches_jax(arch, impl):
    jcfg, tcfg = _cfgs(arch, impl)
    jp, tp = _params(arch)
    toks = _tokens(tcfg, 2, 32, 8)
    want, want_aux = jtf.forward(jp, jcfg, jnp.asarray(toks))
    got, aux = ttf.forward(tp, tcfg, torch.as_tensor(toks))
    assert got.shape == (2, 32, tcfg.vocab_size)
    _close(got, want)
    _close(aux, want_aux)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", NOT_DENSE)
def test_non_dense_prefill_and_decode_match_jax(arch, impl):
    """Prefill (MoE at capacity 1.25, the recurrent states recomputed as
    the reference does) then 6 decode steps (dropless MoE)."""
    for got, want in _prefill_and_decode(arch, impl, 16,
                                         cache_len=16 + DECODE_STEPS):
        _close(got, want)


@pytest.mark.parametrize("arch", NOT_DENSE)
def test_non_dense_windowed_decode_matches_jax(arch):
    """A 32-token prefill into 16-entry rings (MLA's latent cache, GQA's
    KV; recurrentgemma's local attention keeps its own window of 32, which
    the decode then passes), then decode past them."""
    for got, want in _prefill_and_decode(arch, "flash", 32, window=16):
        _close(got, want)


@pytest.mark.parametrize("arch", NOT_DENSE)
def test_non_dense_init_params_have_the_reference_shapes(arch):
    _, tcfg = _cfgs(arch)
    jp, tp = _params(arch)
    fresh = ttf.init_params(tcfg, torch.Generator().manual_seed(0))
    flat = lambda t: jax.tree_util.tree_leaves(  # noqa: E731
        jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)), t))
    assert flat(fresh) == flat(tp)
    assert len(tp["layers"]) == tcfg.num_layers


def test_mtp_subtree_carries_across_with_the_reference_shapes():
    """DeepSeek-V3's MTP head: built by ``init_params`` and carried by
    ``params_from_numpy`` leaf for leaf (one block, not stacked)."""
    _, tcfg = _cfgs("deepseek-v3-671b")
    jp, tp = _params("deepseek-v3-671b")
    fresh = ttf.init_params(tcfg, torch.Generator().manual_seed(0))
    assert set(tp["mtp"]) == {"proj", "block", "norm"}
    want = jax.tree_util.tree_leaves_with_path(jp["mtp"])
    got = jax.tree_util.tree_leaves_with_path(tp["mtp"])
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, g), (_, w), (_, f) in zip(
            got, want, jax.tree_util.tree_leaves_with_path(fresh["mtp"])):
        assert tuple(g.shape) == tuple(w.shape) == tuple(f.shape)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert "mtp" not in _params("grok-1-314b")[1]


def test_recurrentgemma_stages_unstack_in_layer_order():
    """recurrentgemma's reduced stages: a (rglru, rglru, local_attn) group
    once; its full config: that group x 12, then (rglru, rglru) x 1. Each
    port layer holds the reference's stacked slice of its stage."""
    full = treg.get("recurrentgemma-9b")
    assert [(tuple(s.mixer for s in g), r) for g, r in full.stages()] == \
        [(("rglru", "rglru", "local_attn"), 12), (("rglru", "rglru"), 1)]
    jcfg, tcfg = _cfgs("recurrentgemma-9b", num_layers=5)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(3))
    tp = ttf.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    order = [(0, 0, 0), (0, 0, 1), (0, 0, 2), (1, 0, 0), (1, 0, 1)]
    for layer, (stage, r, j), spec in zip(tp["layers"], order,
                                          tcfg.layer_specs()):
        want = jp["stages"][stage][j]["mixer"]
        key = "in_x" if spec.mixer == "rglru" else "wq"
        np.testing.assert_array_equal(layer["mixer"][key].numpy(),
                                      np.asarray(want[key][r]))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("arch", jreg.list_archs())
def test_init_cache_matches_jax_for_every_config(arch, quantized):
    """One cache a layer, each the reference's (stage, repeat, spec) slice
    in shape and dtype, all zeros; int8 codes with f32 scales for
    attention when quantized."""
    jcfg, tcfg = _cfgs(arch)
    want = []
    for (group, repeats), stage in zip(
            jcfg.stages(), jtf.init_cache(jcfg, 2, 40, window=16,
                                          quantized=quantized)):
        for r in range(repeats):
            want += [jax.tree_util.tree_map(lambda a: a[r], c)
                     for c in stage]
    got = ttf.init_cache(tcfg, 2, 40, window=16, quantized=quantized)
    assert len(got) == len(want) == tcfg.num_layers
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__
        for gt, wt in zip(dataclasses.astuple(g), w):
            assert tuple(gt.shape) == tuple(wt.shape)
            assert str(gt.dtype).removeprefix("torch.") == str(wt.dtype)
            assert not gt.any()


_WIDE = dict(param_dtype="float32", activation_dtype="bfloat16")


def _inputs(cfg, b, s, seed):
    if cfg.input_mode == "embeddings":
        return torch.as_tensor(np.random.default_rng(seed).normal(
            size=(b, s, cfg.d_model)).astype(np.float32))
    return torch.as_tensor(_tokens(cfg, b, s, seed))


@pytest.mark.parametrize("arch", jreg.list_archs())
def test_served_copy_is_bitwise_the_uncast_parameters(arch):
    """``cast_params`` in the full configs' dtypes (f32 parameters, bf16
    activations): forward, prefill and two decode steps give ``torch.equal``
    logits from the served copy and from the uncast parameters. Only
    parameters that every use casts to bf16 are cast (Mamba's mixer, the
    RG-LRU's gates, conv and ``in_x``, MLA's ``wkv_a`` and the MoE router
    keep f32)."""
    _, tcfg = _cfgs(arch, **_WIDE)
    params = ttf.init_params(tcfg, torch.Generator().manual_seed(1))
    served = ttf.cast_params(params, tcfg)
    x = _inputs(tcfg, 2, 12, 9)
    a, _ = ttf.forward(params, tcfg, x)
    b, _ = ttf.forward(served, tcfg, x)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    runs = []
    for p in (params, served):
        logits, caches = ttf.prefill(p, tcfg, x, cache_len=14)
        out = [logits]
        for step in range(2):
            tok = (x[:, -1:] if x.is_floating_point()
                   else torch.argmax(out[-1][:, -1:], dim=-1))
            logits, caches = ttf.decode_step(p, tcfg, caches, tok, 12 + step)
            out.append(logits)
        runs.append(out)
    for u, v in zip(*runs):
        assert torch.equal(u, v)


#: Worst |port - JAX| over the logits of forward, prefill and 6 decode
#: steps in bf16 activations with f32 parameters, measured once on the CPU
#: against max |logit| of the JAX forward: falcon-mamba 0.0156 of 3.47
#: (0.45 %), recurrentgemma 0.0234 of 3.13 (0.75 %), one and one and a half
#: bf16 ulps of a logit near 3. The bar, 1e-2 * max|logit| (about two and
#: a half bf16 roundings of the largest logit), leaves room for the
#: rounding order of bf16 sums.
BF16_BAR = 1e-2


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b"])
def test_bf16_activations_with_f32_parameters_match_jax(arch):
    """The full configs' dtypes through both packages: the f32 conv taps
    lift Mamba's projections to f32 products, and each prefill state is
    recomputed from the uncast projection, in both. The reference runs op
    by op (``jax.disable_jit``), as the port does: under ``jit`` XLA's CPU
    fusions keep f32 between bf16 ops, and the reference's own jitted
    recurrentgemma forward lies 0.055 (1.8 % of max |logit|) from its
    op-by-op run on these inputs."""
    jcfg, tcfg = _cfgs(arch, **_WIDE)
    jp, _ = _params(arch)
    tp = ttf.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    toks = _tokens(tcfg, 2, 16, 10)
    pairs = []
    with jax.disable_jit():
        want_f, _ = jtf.forward(jp, jcfg, jnp.asarray(toks))
        got_f, _ = ttf.forward(tp, tcfg, torch.as_tensor(toks))
        pairs.append((got_f, want_f))
        jl, jc = jtf.prefill(jp, jcfg, jnp.asarray(toks), cache_len=22)
        tl, tc = ttf.prefill(tp, tcfg, torch.as_tensor(toks), cache_len=22)
        pairs.append((tl, jl))
        for step in range(DECODE_STEPS):
            tok = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)
            jl, jc = jtf.decode_step(jp, jcfg, jc, jnp.asarray(tok),
                                     jnp.asarray(16 + step))
            tl, tc = ttf.decode_step(tp, tcfg, tc, torch.as_tensor(tok),
                                     16 + step)
            pairs.append((tl, jl))
    scale = float(np.abs(np.asarray(want_f, np.float32)).max())
    worst = max(float(np.abs(g.float().numpy()
                             - np.asarray(w, np.float32)).max())
                for g, w in pairs)
    assert worst <= BF16_BAR * scale, (worst, scale)


@pytest.mark.parametrize("window", [0, 16])
def test_causal_mask_and_init_cache_match_jax(window):
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    np.testing.assert_array_equal(
        tattn.causal_mask(24, window).numpy(),
        np.asarray(jattn.causal_mask(24, window)))
    jcfg, tcfg = _cfgs("starcoder2-3b")
    want = jtf.init_cache(jcfg, 2, 40, window=window)[0][0]  # stage 0, spec 0
    got = ttf.init_cache(tcfg, 2, 40, window=window)
    assert len(got) == tcfg.num_layers
    for c in got:   # the reference stacks the layers on a leading axis
        assert tuple(c.k.shape) == tuple(want.k.shape[1:])
        assert tuple(c.v.shape) == tuple(want.v.shape[1:])
        assert str(c.k.dtype).removeprefix("torch.") == str(want.k.dtype)
        assert not c.k.any() and not c.v.any()


def test_init_params_has_the_reference_shapes():
    _, tcfg = _cfgs("starcoder2-3b")
    jp, _ = _params("starcoder2-3b")
    tp = ttf.init_params(tcfg, torch.Generator().manual_seed(0))
    want = ttf.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 tcfg)
    flat = lambda t: jax.tree_util.tree_leaves(  # noqa: E731
        jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)), t))
    assert flat(tp) == flat(want)


# ----------------------------------------------------------------------------
# Serving (launch/serve.py)
# ----------------------------------------------------------------------------

def _pods(mod, speeds=(1.0, 1.6, 2.4)):
    pods = [mod.Pod(f"pod{i}({s})", s) for i, s in enumerate(speeds)]
    mod.profile_pods(pods, base_step_s=0.02)
    return pods


@pytest.mark.parametrize("placement", ["iep", "metis+greedy", "random"])
def test_place_batches_equals_the_reference(placement):
    cfg = treg.reduced(treg.get("qwen1.5-0.5b"))
    reqs = tserve.make_requests(cfg, 14, 16)
    jreqs = [jserve.Request(r.rid, r.prompt, r.max_new) for r in reqs]
    for size in (2, 4):
        tb = [reqs[i:i + size] for i in range(0, len(reqs), size)]
        jb = [jreqs[i:i + size] for i in range(0, len(jreqs), size)]
        for take in (3, 5):   # fewer and more batches than pods
            for seed in (0, 1):
                got = tserve.place_batches(tb[:take], _pods(tserve),
                                           placement, seed)
                want = jserve.place_batches(jb[:take], _pods(jserve),
                                            placement, seed)
                assert np.array_equal(np.asarray(got), np.asarray(want))


def _serve_against_jax(arch, impl, requests=6):
    """The port's ``serve`` on the CPU vs the reference's prefill /
    decode_step loop (serve.py:125-160) on the same requests and weights:
    the greedy tokens must be equal."""
    jcfg, tcfg = _cfgs(arch, impl)
    jp, tp = _params(arch)
    tokens, size = 4, 2
    out = tserve.serve(tcfg, requests=requests, tokens=tokens,
                       batch_size=size, device="cpu", params=tp, log=None)
    reqs = out["requests"]
    assert out["tokens"] == requests * tokens
    assert len(out["batches"]) == -(-requests // size)
    decode = _jax_decode(jcfg)
    for i in range(0, len(reqs), size):
        batch = reqs[i:i + size]
        plen = max(len(r.prompt) for r in batch)
        toks = np.zeros((len(batch), plen), np.int32)
        for bi, r in enumerate(batch):
            toks[bi, plen - len(r.prompt):] = r.prompt
        logits, caches = jtf.prefill(jp, jcfg, jnp.asarray(toks),
                                     cache_len=plen + tokens)
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        want = [np.asarray(tok)[:, 0]]
        for step in range(tokens - 1):
            logits, caches = decode(jp, caches, tok, jnp.asarray(plen + step))
            tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
            want.append(np.asarray(tok)[:, 0])
        want = np.stack(want, axis=1)
        for bi, r in enumerate(batch):
            assert r.done == want[bi].tolist(), (r.rid, r.done, want[bi])


@pytest.mark.parametrize("impl", IMPLS)
def test_serve_gives_the_reference_greedy_tokens(impl):
    _serve_against_jax("qwen1.5-0.5b", impl)


@pytest.mark.parametrize("arch", NOT_DENSE)
def test_non_dense_serve_gives_the_reference_greedy_tokens(arch):
    _serve_against_jax(arch, "flash", requests=4)


@pytest.mark.parametrize("arch", jreg.list_archs())
def test_serve_runs_every_config(arch):
    """``serve`` takes each of the ten configs (reduced, CPU): every
    request gets its tokens, each a token id of the vocabulary."""
    _, tcfg = _cfgs(arch)
    out = tserve.serve(tcfg, requests=2, tokens=3, batch_size=2,
                       device="cpu", log=None)
    assert out["tokens"] == 6
    for r in out["requests"]:
        assert len(r.done) == 3 and all(0 <= t < tcfg.vocab_size
                                        for t in r.done)


def test_serve_main_needs_a_device_or_runs_on_the_named_one():
    assert tserve.main(["--device", "cpu", "--requests", "2", "--tokens",
                        "2", "--batch-size", "2"]) == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tserve.main(["--requests", "2", "--tokens", "2"])
