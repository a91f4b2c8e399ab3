"""Block-CSR SpMM of the PyTorch port vs the JAX Pallas kernels.

The JAX kernels run in interpret mode (as tests/test_kernels.py runs them);
the port's plain versions (``kernels.ref``) and its wrappers on CPU tensors
must agree within that file's bar, rtol 1e-5 / atol 1e-4. The CUDA kernels
themselves are held against these plain versions on the card by
``chip_smoke.py``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gather_aggregate as jga
from repro.kernels import ref as jref
from repro.gnn import datasets as jdata
from repro_torch.gnn import datasets as tdata
from repro_torch.kernels import gather_aggregate as tga
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-5, 1e-4


def _operands(n, e, src_space, seed, empty_blocks=False):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, src_space, e).astype(np.int32)
    hi = min(n, 128) if empty_blocks else n   # later row-blocks: padding only
    r = rng.integers(0, hi, e).astype(np.int32)
    blocks, cols, mask, pv = jga.build_block_csr(s, r, n)
    src_rows = -(-src_space // 128) * 128
    return blocks, cols, mask, pv, src_rows


CASES = [  # (n, e, source rows, empty row-blocks)
    (300, 2000, 300, False),     # square
    (256, 1500, 700, False),     # rectangular source (halo-table shape)
    (400, 600, 400, True),       # all-padding row-blocks
]


@functools.lru_cache(maxsize=None)
def _case(case, f):
    """Operands, a [3, S, F] feature stack and the JAX batched kernel's
    output on it (interpret mode, F zero-padded to the width its feature
    tiling takes and sliced back). The JAX batched kernel is bitwise its
    serial one per example, so out[b] also serves the serial comparison.
    """
    n, e, src, empty = CASES[case]
    blocks, cols, mask, pv, src_rows = _operands(n, e, src, case, empty)
    if empty:
        assert (mask[1:] == 0).all()
    h = np.random.default_rng(10 + f).normal(
        size=(3, src_rows, f)).astype(np.float32)
    hp = np.zeros(h.shape[:-1] + (jga.padded_feature_dim(f),), np.float32)
    hp[..., :f] = h
    out = jga.block_spmm_batched(
        jnp.asarray(blocks), jnp.asarray(cols), jnp.asarray(mask),
        jnp.asarray(hp), interpret=True)
    return blocks, cols, mask, pv, h, np.asarray(out)[..., :f]


@pytest.mark.parametrize("f", [8, 52, 64, 200])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_block_spmm_plain_and_cpu_wrapper_match_jax(case, f):
    blocks, cols, mask, pv, h, want = _case(case, f)
    h, want = h[0], want[0]
    tb, tc, tm, th = (torch.as_tensor(x) for x in (blocks, cols, mask, h))
    before = tga.block_spmm.launches
    plain = tref.block_spmm_ref(tb, tc, tm, th).numpy()
    wrapped = tga.block_spmm(tb, tc, tm, th).numpy()
    assert plain.shape == wrapped.shape == (pv, f)
    np.testing.assert_allclose(plain, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(wrapped, want, rtol=RTOL, atol=ATOL)
    assert tga.block_spmm.launches == before   # CPU tensors never launch


@pytest.mark.parametrize("f", [8, 52, 64, 200])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_block_spmm_batched_plain_and_cpu_wrapper_match_jax(case, f):
    blocks, cols, mask, pv, h, want = _case(case, f)
    tb, tc, tm, th = (torch.as_tensor(x) for x in (blocks, cols, mask, h))
    before = tga.block_spmm_batched.launches
    plain = tref.block_spmm_batched_ref(tb, tc, tm, th).numpy()
    wrapped = tga.block_spmm_batched(tb, tc, tm, th).numpy()
    assert wrapped.shape == (3, pv, f)
    np.testing.assert_allclose(plain, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(wrapped, want, rtol=RTOL, atol=ATOL)
    assert tga.block_spmm_batched.launches == before
    for b in range(3):   # per example == the serial call, bitwise
        assert torch.equal(torch.as_tensor(wrapped[b]),
                           tga.block_spmm(tb, tc, tm, th[b]))


def test_plain_version_matches_jax_oracle():
    blocks, cols, mask, pv, src_rows = _operands(200, 900, 200, 7)
    h = np.random.default_rng(3).normal(size=(src_rows, 64)).astype(
        np.float32)
    want = np.asarray(jref.block_spmm_ref(
        jnp.asarray(blocks), jnp.asarray(cols), jnp.asarray(mask),
        jnp.asarray(h)))
    got = tref.block_spmm_ref(*(torch.as_tensor(x)
                                for x in (blocks, cols, mask, h)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("normalize", [None, "mean"])
def test_block_csr_aggregate_matches_jax(normalize):
    g = jdata.load("yelp", scale=0.05, seed=7)
    gt = tdata.load("yelp", scale=0.05, seed=7)
    h = np.random.default_rng(8).normal(
        size=(g.num_vertices, 32)).astype(np.float32)
    from repro.kernels import ops as jops
    want = jops.BlockCsr(g, normalize=normalize).aggregate(h)
    csr = tops.BlockCsr(gt, normalize=normalize, device="cpu")
    got = csr.aggregate(h)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    stacked = csr.aggregate(np.stack([h, 2 * h]))
    assert np.array_equal(stacked[0], got)
    # The keyed cache: one operand per (adjacency, normalize, block, device).
    tops.invalidate_block_csr(gt)
    a = tops.block_csr_for(gt, normalize=normalize, device="cpu")
    assert tops.block_csr_for(gt, normalize=normalize, device="cpu") is a
    assert tops.invalidate_block_csr(gt) == 1
    assert len(tops.BLOCK_CSR_KEY_FIELDS) == 4


def _good():
    blocks, cols, mask, pv, src_rows = _operands(200, 900, 200, 1)
    h = np.zeros((src_rows, 16), np.float32)
    return [torch.as_tensor(x) for x in (blocks, cols, mask, h)]


@pytest.mark.parametrize("bad", ["h_rows", "h_short", "dtype", "cols_shape",
                                 "h_ndim", "strided", "col_bound"])
def test_wrapper_rejects_bad_operands(bad):
    b, c, m, h = _good()
    hb = None                             # batched operand, [B, S, F]
    kw = {}
    if bad == "h_rows":
        h = h[:-1]
    elif bad == "h_short":
        h = h[:128]                       # cols reach block 1
    elif bad == "dtype":
        h = h.double()
    elif bad == "cols_shape":
        c = c[:, :-1].contiguous() if c.shape[1] > 1 else c[:-1]
    elif bad == "h_ndim":
        h, hb = h[None], h
    elif bad == "strided":
        h = torch.zeros(h.shape[0], 32)[:, ::2]
    elif bad == "col_bound":
        kw["max_col"] = h.shape[0] // 128  # one block past the table
    with pytest.raises((ValueError, TypeError)):
        tga.block_spmm(b, c, m, h, **kw)
    with pytest.raises((ValueError, TypeError)):
        tga.block_spmm_batched(b, c, m, h[None] if hb is None else hb, **kw)
