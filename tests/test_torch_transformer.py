"""The port's transformer serving path vs the JAX package's.

Configurations and their reduced variants must be equal field by field.
Layers (``rms_norm``, ``apply_rope``, the SiLU / GELU ``mlp``), the dense
decoder (``forward``, ``prefill``, ``decode_step`` with the flash kernel's
plain version or the chunked path, the windowed ring-buffer decode) and the
serving loop (``place_batches``, greedy tokens of ``serve``) run on the
same seeded numpy inputs and the JAX package's weights, carried across by
``transformer.params_from_numpy``. Logits must agree within the
reference's model-level bar, rtol 1e-4 / atol 1e-4
(tests/test_flash_attention.py:74); layers within rtol 1e-5 / atol 1e-5
in float32 (both packages round the same f32 operations, in other orders)
and one bf16 rounding (rtol 2**-7) in bfloat16; placements and greedy
tokens exactly.
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


@pytest.mark.parametrize("arch", NOT_DENSE)
def test_layer_kinds_outside_the_dense_path_raise(arch):
    cfg = treg.reduced(treg.get(arch))
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        ttf.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        ttf.init_cache(cfg, 1, 8)
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        tserve.serve(cfg, requests=1, tokens=1, device="cpu", log=None)


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


@pytest.mark.parametrize("impl", IMPLS)
def test_serve_gives_the_reference_greedy_tokens(impl):
    """The port's ``serve`` on the CPU vs the reference's prefill /
    decode_step loop (serve.py:125-160) on the same requests and weights."""
    jcfg, tcfg = _cfgs("qwen1.5-0.5b", impl)
    jp, tp = _params("qwen1.5-0.5b")
    tokens, size = 4, 2
    out = tserve.serve(tcfg, requests=6, tokens=tokens, batch_size=size,
                       device="cpu", params=tp, log=None)
    reqs = out["requests"]
    assert out["tokens"] == 6 * tokens and len(out["batches"]) == 3
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


def test_serve_main_needs_a_device_or_runs_on_the_named_one():
    assert tserve.main(["--device", "cpu", "--requests", "2", "--tokens",
                        "2", "--batch-size", "2"]) == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tserve.main(["--requests", "2", "--tokens", "2"])
