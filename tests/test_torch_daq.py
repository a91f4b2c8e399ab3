"""DAQ-fused block-CSR SpMM of the PyTorch port vs the JAX Pallas kernels.

``dequant_spmm`` / ``dequant_spmm_batched`` aggregate straight from
quantized codes. The JAX kernels run in interpret mode (as
tests/test_kernels.py runs them); the port's plain versions
(``kernels.ref``) and its wrappers on CPU tensors must agree with them and
with the JAX ``dequant_spmm_ref`` within that file's bar, rtol 1e-5 /
atol 1e-4. The standalone ``dequant`` and ``ops.dequantize_features`` are
held to the JAX ones within that file's dequant bar, rtol 1e-6 / atol
1e-5 (the JAX kernel fuses the product and the sum into one rounding; the
port rounds twice, bitwise what numpy gives). Also here: the halo wire's
``_wire_quantize`` (bitwise the JAX one) and
``BlockCsr.aggregate_quantized``. The CUDA kernels themselves are held
against these plain versions on the card by ``chip_smoke.py``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.gnn import datasets as jdata
from repro.kernels import daq_dequant as jdq
from repro.kernels import gather_aggregate as jga
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.runtime import bsp as jbsp
from repro_torch.gnn import datasets as tdata
from repro_torch.kernels import daq_dequant as tdq
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.runtime import bsp as tbsp

from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-5, 1e-4
DQ_RTOL, DQ_ATOL = 1e-6, 1e-5   # tests/test_kernels.py:114
BATCH = 3

CASES = [  # (output rows, edges, source rows)
    (300, 2000, 300),     # square
    (256, 1500, 700),     # rectangular source (halo-table shape)
]
CODES = {"uint8": np.uint8, "uint16": np.uint16, "uint32": np.uint32}


def _codes(dtype, shape, rng):
    """Codes spanning the dtype's range, with per-row parameters that map
    them to about [-1, 1]."""
    top = np.iinfo(dtype).max
    codes = rng.integers(0, top, shape, dtype=np.uint64,
                         endpoint=True).astype(dtype)
    scales = (rng.uniform(0.5, 2.0, shape[:-1]) / top).astype(np.float32)
    mins = rng.uniform(-1.0, 0.0, shape[:-1]).astype(np.float32)
    return codes, scales, mins


@functools.lru_cache(maxsize=None)
def _case(case, f, dtype):
    """Operands, a [3, S, F] code stack with its row parameters, and the
    JAX batched and serial kernels' outputs (interpret mode; F zero-padded
    to the width the JAX feature tiling takes and sliced back)."""
    n, e, src = CASES[case]
    rng = np.random.default_rng(100 * case + f)
    s = rng.integers(0, src, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    blocks, cols, mask, pv = jga.build_block_csr(s, r, n)
    src_rows = -(-src // 128) * 128
    codes, scales, mins = _codes(CODES[dtype], (BATCH, src_rows, f), rng)
    cp = np.zeros(codes.shape[:-1] + (jga.padded_feature_dim(f),),
                  codes.dtype)
    cp[..., :f] = codes
    ops = tuple(jnp.asarray(x) for x in (blocks, cols, mask))
    batched = jdq.dequant_spmm_batched(
        *ops, jnp.asarray(cp), jnp.asarray(scales), jnp.asarray(mins),
        interpret=True)
    serial = jdq.dequant_spmm(*ops, jnp.asarray(cp[0]),
                              jnp.asarray(scales[0]), jnp.asarray(mins[0]),
                              interpret=True)
    oracle = jref.dequant_spmm_ref(*ops, jnp.asarray(codes[0]),
                                   jnp.asarray(scales[0]),
                                   jnp.asarray(mins[0]))
    return ((blocks, cols, mask), pv, (codes, scales, mins),
            np.asarray(batched)[..., :f], np.asarray(serial)[:, :f],
            np.asarray(oracle))


def _torch(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


@pytest.mark.parametrize("dtype", list(CODES))
@pytest.mark.parametrize("f", [8, 52, 200])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_dequant_spmm_plain_and_cpu_wrapper_match_jax(case, f, dtype):
    ops, pv, (codes, scales, mins), _, want, oracle = _case(case, f, dtype)
    args = _torch(*ops, codes[0], scales[0], mins[0])
    before = tdq.dequant_spmm.launches
    plain = tref.dequant_spmm_ref(*args).numpy()
    wrapped = tdq.dequant_spmm(*args).numpy()
    assert plain.shape == wrapped.shape == (pv, f)
    for got in (plain, wrapped):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)
    assert tdq.dequant_spmm.launches == before   # CPU tensors never launch


@pytest.mark.parametrize("dtype", list(CODES))
@pytest.mark.parametrize("f", [8, 52, 200])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_dequant_spmm_batched_matches_jax_and_is_serial(case, f, dtype):
    ops, pv, (codes, scales, mins), want, _, _ = _case(case, f, dtype)
    args = _torch(*ops, codes, scales, mins)
    before = tdq.dequant_spmm_batched.launches
    plain = tref.dequant_spmm_batched_ref(*args).numpy()
    wrapped = tdq.dequant_spmm_batched(*args).numpy()
    assert plain.shape == wrapped.shape == (BATCH, pv, f)
    np.testing.assert_allclose(plain, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(wrapped, want, rtol=RTOL, atol=ATOL)
    for b in range(BATCH):   # every example is bitwise the serial call
        serial = tdq.dequant_spmm(*_torch(*ops, codes[b], scales[b],
                                          mins[b])).numpy()
        assert np.array_equal(wrapped[b], serial)
    assert tdq.dequant_spmm_batched.launches == before


def test_plain_dequant_rounds_product_then_sum():
    """The panel is codes*scale rounded, then +min rounded (no FMA): the
    rounding the CUDA kernel repeats with __fmul_rn / __fadd_rn."""
    rng = np.random.default_rng(5)
    codes, scales, mins = _codes(np.uint8, (64, 16), rng)
    got = tref.dequant_ref(*_torch(codes, scales, mins)).numpy()
    prod = (codes.astype(np.float32) * scales[:, None]).astype(np.float32)
    want = (prod + mins[:, None]).astype(np.float32)
    assert np.array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jref.dequant_ref(jnp.asarray(codes),
                                         jnp.asarray(scales),
                                         jnp.asarray(mins))))


def test_zero_padded_source_rows_contribute_exactly_zero():
    """Rows 0..127 of the output read only source block 1, which is all
    zero padding (code 0, scale 0, min 0) or a wire-quantized all-zero row
    (code 0, scale ~3.9e-15, min 0): the output there is exactly 0."""
    rng = np.random.default_rng(6)
    s = np.concatenate([rng.integers(128, 256, 400),
                        rng.integers(0, 128, 400)]).astype(np.int32)
    r = np.concatenate([rng.integers(0, 128, 400),
                        rng.integers(128, 256, 400)]).astype(np.int32)
    blocks, cols, mask, _ = jga.build_block_csr(s, r, 256)
    codes, scales, mins = _codes(np.uint8, (2, 256, 52), rng)
    codes[:, 128:] = 0
    scales[0, 128:], mins[0, 128:] = 0.0, 0.0
    zero_rows = torch.zeros(128, 52)
    _, wire_scale, wire_min = tbsp._wire_quantize(zero_rows)
    assert float(wire_scale[0]) == np.float32(1e-12) / np.float32(255.0)
    scales[1, 128:], mins[1, 128:] = wire_scale.numpy(), wire_min.numpy()
    out = tdq.dequant_spmm_batched(*_torch(blocks, cols, mask, codes, scales,
                                           mins)).numpy()
    assert (out[:, :128] == 0).all()
    assert np.abs(out[:, 128:]).max() > 0


@pytest.mark.parametrize("shape", [(37, 52), (2, 37, 52)],
                         ids=["rows", "batched"])
def test_wire_quantize_is_bitwise_the_jax_one(shape):
    rng = np.random.default_rng(7)
    h = rng.normal(size=shape).astype(np.float32)
    h[..., ::5, :] = 0.0                   # masked boundary rows
    h[..., 3, :] = 0.25                    # constant row: max == min
    jc, js, jm = (np.asarray(x) for x in jbsp._wire_quantize(jnp.asarray(h)))
    tc, ts, tm = (x.numpy() for x in tbsp._wire_quantize(torch.as_tensor(h)))
    assert tc.dtype == jc.dtype == np.uint8
    assert np.array_equal(tc, jc)
    assert np.array_equal(ts, js) and np.array_equal(tm, jm)
    if len(shape) == 3:                    # batched == per-example, bitwise
        one = tbsp._wire_quantize(torch.as_tensor(h[1]))
        assert all(np.array_equal(a.numpy(), b[1]) for a, b in
                   zip(one, (tc, ts, tm)))


def test_aggregate_quantized_matches_jax():
    g = jdata.load("siot", scale=0.05, seed=0)
    gt = tdata.load("siot", scale=0.05, seed=0)
    rng = np.random.default_rng(8)
    codes, scales, mins = _codes(np.uint8, (g.num_vertices, g.feature_dim),
                                 rng)
    want = jops.BlockCsr(g).aggregate_quantized(codes, scales, mins,
                                                interpret=True)
    before = tdq.dequant_spmm.launches
    got = tops.BlockCsr(gt, device="cpu").aggregate_quantized(codes, scales,
                                                              mins)
    assert got.shape == want.shape == (g.num_vertices, g.feature_dim)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert tdq.dequant_spmm.launches == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    ops, _, (codes, scales, mins), *_ = _case(0, 8, "uint8")
    blocks, cols, mask = _torch(*ops)
    c, s, m = _torch(codes[0], scales[0], mins[0])
    with pytest.raises(TypeError, match="codes"):
        tdq.dequant_spmm(blocks, cols, mask, c.to(torch.int32), s, m)
    with pytest.raises(TypeError, match="scales"):
        tdq.dequant_spmm(blocks, cols, mask, c, s.double(), m)
    with pytest.raises(ValueError, match="mins"):
        tdq.dequant_spmm(blocks, cols, mask, c, s, m[:-1])
    with pytest.raises(ValueError, match="one per source row"):
        tdq.dequant_spmm_batched(*_torch(*ops, codes,
                                         scales[:, :-1].copy(), mins))
    with pytest.raises(ValueError, match="rows"):
        tdq.dequant_spmm(blocks, cols, mask, c[:100], s[:100], m[:100])
    with pytest.raises(ValueError, match="reaches block"):
        tdq.dequant_spmm(blocks, cols, mask, c, s, m, max_col=3)


def _two_roundings(codes, scales, mins):
    prod = (codes.astype(np.float32) * scales[:, None]).astype(np.float32)
    return (prod + mins[:, None]).astype(np.float32)


@pytest.mark.parametrize("dtype", list(CODES))
@pytest.mark.parametrize("v,f", [(256, 128), (512, 256)])
def test_dequant_matches_jax(dtype, v, f):
    """The reference's shapes and code ranges (tests/test_kernels.py)."""
    rng = np.random.default_rng(4)
    top = min(np.iinfo(CODES[dtype]).max, 1 << 20)
    codes = rng.integers(0, top, (v, f)).astype(CODES[dtype])
    sc = rng.uniform(1e-3, 1.0, v).astype(np.float32)
    mn = rng.normal(size=v).astype(np.float32)
    want = np.asarray(jdq.dequant(jnp.asarray(codes), jnp.asarray(sc),
                                  jnp.asarray(mn), interpret=True))
    before = tdq.dequant.launches
    got = tdq.dequant(*_torch(codes, sc, mn)).numpy()
    assert got.dtype == np.float32 and got.shape == (v, f)
    np.testing.assert_allclose(got, want, rtol=DQ_RTOL, atol=DQ_ATOL)
    assert np.array_equal(got, _two_roundings(codes, sc, mn))
    assert tdq.dequant.launches == before   # CPU tensors never launch


@pytest.mark.parametrize("dtype", list(CODES))
@pytest.mark.parametrize("v,f", [(300, 52), (1000, 128), (256, 200)])
def test_dequantize_features_matches_jax(dtype, v, f):
    """Pad to the 256 x 128 tiling, dequantize, cut back: numpy in and
    out, as ``benchmarks/run.py`` calls it."""
    codes, sc, mn = _codes(CODES[dtype], (v, f), np.random.default_rng(v))
    want = jops.dequantize_features(codes, sc, mn, interpret=True)
    got = tops.dequantize_features(codes, sc, mn, device="cpu")
    assert isinstance(got, np.ndarray) and got.shape == want.shape == (v, f)
    np.testing.assert_allclose(got, want, rtol=DQ_RTOL, atol=DQ_ATOL)
    assert np.array_equal(got, _two_roundings(codes, sc, mn))


def test_dequant_rejects_what_the_reference_or_kernel_does_not_take():
    codes, sc, mn = _torch(*_codes(np.uint8, (512, 128),
                                   np.random.default_rng(9)))
    with pytest.raises(TypeError, match="codes"):
        tdq.dequant(codes.to(torch.int32), sc, mn)
    with pytest.raises(ValueError, match=r"\[V, F\]"):
        tdq.dequant(codes[None], sc, mn)
    with pytest.raises(ValueError, match="one per row"):
        tdq.dequant(codes, sc[:-1], mn)
    with pytest.raises(TypeError, match="mins"):
        tdq.dequant(codes, sc, mn.double())
    with pytest.raises(ValueError, match="tile"):
        tdq.dequant(codes[:300], sc[:300], mn[:300])
    with pytest.raises(ValueError, match="tile"):
        tdq.dequant(codes[:, :100].contiguous(), sc, mn, f_tile=64)
    assert tdq.dequant(codes[:100, :52].contiguous(), sc[:100],
                       mn[:100]).shape == (100, 52)   # one tile each way
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tops.dequantize_features(codes.numpy(), sc.numpy(), mn.numpy())
