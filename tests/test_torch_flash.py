"""Flash attention of the PyTorch port vs the JAX Pallas kernel.

The port's ``flash_attention`` / ``gqa_flash`` on CPU tensors run their
plain versions (``kernels.ref``); they must agree with the JAX kernel in
interpret mode and with its plain-softmax oracle at the shapes of
tests/test_flash_attention.py, within that file's bars: rtol 1e-4 /
atol 1e-5 in float32, 3e-2 in bfloat16. The wrappers keep the reference's
argument checks (its assertions raise ``ValueError`` here). The CUDA
kernel itself is held against these plain versions on the card by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.flash_attention import gqa_flash as jgqa_flash
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref

from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-4, 1e-5          # tests/test_flash_attention.py
BF16_TOL = 3e-2                  # tests/test_flash_attention.py:58


def _inputs(seed, *shapes, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(dtype) for s in shapes]


def _both(arrays, jdtype=jnp.float32, tdtype=torch.float32):
    return ([jnp.asarray(a, jdtype) for a in arrays],
            [torch.as_tensor(a).to(tdtype) for a in arrays])


def _check(got, *wants, rtol=RTOL, atol=ATOL):
    got = got.float().numpy()
    for want in wants:
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize("bh,s,t,dh", [(4, 256, 256, 64), (2, 128, 128, 128),
                                       (1, 512, 512, 32), (3, 128, 384, 64)])
def test_suffix_queries_match_jax(bh, s, t, dh):
    """Chunked-prefill layout: S queries at the end of a length-T cache."""
    (jq, jk, jv), (q, k, v) = _both(_inputs(bh + s + t + dh, (bh, s, dh),
                                            (bh, t, dh), (bh, t, dh)))
    qoff = t - s
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, bq=64, bk=64, q_offset=qoff)
    assert got.shape == (bh, s, dh) and got.dtype == torch.float32
    _check(got, jflash(jq, jk, jv, bq=64, bk=64, q_offset=qoff),
           jref.flash_attention_ref(jq, jk, jv, q_offset=qoff))
    assert tfa.flash_attention.launches == before   # CPU tensors never launch


@pytest.mark.parametrize("window", [32, 64, 128])
def test_windowed_matches_jax(window):
    (jq, jk, jv), (q, k, v) = _both(_inputs(window, *[(2, 256, 64)] * 3))
    got = tfa.flash_attention(q, k, v, bq=64, bk=64, window=window)
    _check(got, jflash(jq, jk, jv, bq=64, bk=64, window=window),
           jref.flash_attention_ref(jq, jk, jv, window=window))


@pytest.mark.parametrize("block", [(32, 64), (64, 32), (128, 128)])
def test_block_sweep_matches_jax(block):
    bq, bk = block
    (jq, jk, jv), (q, k, v) = _both(_inputs(7, *[(2, 128, 64)] * 3))
    got = tfa.flash_attention(q, k, v, bq=bq, bk=bk)
    _check(got, jflash(jq, jk, jv, bq=bq, bk=bk),
           jref.flash_attention_ref(jq, jk, jv))


def test_bf16_matches_jax():
    (jq, jk, jv), (q, k, v) = _both(_inputs(9, *[(2, 128, 64)] * 3),
                                    jnp.bfloat16, torch.bfloat16)
    got = tfa.flash_attention(q, k, v, bq=64, bk=64)
    assert got.dtype == torch.bfloat16
    _check(got, jflash(jq, jk, jv, bq=64, bk=64),
           jref.flash_attention_ref(jq, jk, jv), rtol=BF16_TOL,
           atol=BF16_TOL)


def test_rows_with_no_visible_key_are_zero():
    """Queries at 128..191 with a 32-wide window over a 64-key cache see
    no key at all: the reference guards them to exactly 0."""
    (jq, jk, jv), (q, k, v) = _both(_inputs(3, (2, 64, 64), (2, 64, 64),
                                            (2, 64, 64)))
    got = tfa.flash_attention(q, k, v, bq=64, bk=64, window=32,
                              q_offset=128)
    want = np.asarray(jflash(jq, jk, jv, bq=64, bk=64, window=32,
                             q_offset=128))
    assert (got.numpy() == 0).all() and (want == 0).all()


def test_non_causal_matches_jax():
    (jq, jk, jv), (q, k, v) = _both(_inputs(4, (2, 64, 32), (2, 128, 32),
                                            (2, 128, 32)))
    got = tfa.flash_attention(q, k, v, bq=64, bk=64, causal=False)
    _check(got, jflash(jq, jk, jv, bq=64, bk=64, causal=False))


@pytest.mark.parametrize("h,kv,window", [(8, 2, 0), (8, 8, 0), (4, 1, 0),
                                         (8, 2, 48)])
def test_gqa_flash_matches_jax(h, kv, window):
    """Model layout with kv groups (and one sliding window)."""
    (jq, jk, jv), (q, k, v) = _both(_inputs(11 + h + kv, (2, 128, h, 32),
                                            (2, 128, kv, 32),
                                            (2, 128, kv, 32)))
    got = tfa.gqa_flash(q, k, v, window=window, bq=64, bk=64)
    assert got.shape == (2, 128, h, 32)
    _check(got, jgqa_flash(jq, jk, jv, window=window, bq=64, bk=64))


def test_plain_version_promotes_float64():
    """The on-card yardstick: float64 inputs compute in float64."""
    q, k, v = (torch.as_tensor(a, dtype=torch.float64)
               for a in _inputs(5, *[(1, 64, 32)] * 3))
    out = tref.flash_attention_ref(q, k, v)
    assert out.dtype == torch.float64
    f32 = tref.flash_attention_ref(q.float(), k.float(), v.float())
    np.testing.assert_allclose(f32.numpy(), out.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_wrappers_reject_what_the_reference_or_kernel_does_not_take():
    q, k, v = (torch.as_tensor(a) for a in _inputs(6, *[(2, 128, 64)] * 3))
    with pytest.raises(ValueError, match="multiples"):
        tfa.flash_attention(q[:, :100], k, v, bq=64, bk=64)
    with pytest.raises(ValueError, match="multiples"):
        tfa.flash_attention(q, k[:, :100], v[:, :100], bq=64, bk=64)
    with pytest.raises(ValueError, match="q_offset"):
        tfa.flash_attention(q, k, v, bq=64, bk=64, q_offset=32)
    with pytest.raises(ValueError, match="head dims"):
        tfa.flash_attention(q[..., :48], k[..., :48], v[..., :48])
    with pytest.raises(ValueError, match="head dims"):
        tfa.flash_attention(q, k, v[..., :32])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="k is"):
        tfa.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="disagree"):
        tfa.flash_attention(q, k[:1], v[:1])
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2)
                            [..., :64], k, v)
    with pytest.raises(ValueError, match="BH, S, dh"):
        tfa.flash_attention(q[None], k[None], v[None])
    q4 = torch.zeros(1, 128, 6, 64)
    with pytest.raises(ValueError, match="kv groups"):
        tfa.gqa_flash(q4, torch.zeros(1, 128, 4, 64),
                      torch.zeros(1, 128, 4, 64))
    with pytest.raises(ValueError, match="multiples"):
        tfa.gqa_flash(torch.zeros(1, 200, 4, 64),
                      torch.zeros(1, 200, 2, 64),
                      torch.zeros(1, 200, 2, 64))


def test_tma_preconditions_raise_on_misaligned_views():
    """The bf16 kernel reads q, k and v by TMA: a view whose first element
    or strides are not 16-byte multiples raises ``ValueError`` before any
    launch (the check is pointer and stride arithmetic, so CPU tensors
    reach it), and a contiguous [B, S, H, dh] table passes."""
    aligned = torch.zeros(2, 128, 4, 64, dtype=torch.bfloat16)
    tfa.check_tma_layout("gqa_flash", aligned, aligned, aligned)
    shifted = torch.zeros(aligned.numel() + 1, dtype=torch.bfloat16)[1:]
    with pytest.raises(ValueError, match="16-byte aligned base"):
        tfa.check_tma_layout("gqa_flash", aligned,
                             shifted.view(2, 128, 4, 64), aligned)
    # Rows of 68 elements: head stride 136 bytes, not a multiple of 16.
    wide = torch.zeros(2, 128, 4, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match=r"strides \(34816, 272, 68\)"):
        tfa.check_tma_layout("gqa_flash", wide, aligned, aligned)
