"""The DAQ-fused products of the PyTorch port on the row-compacted operand.

On CUDA ``dequant_spmm`` / ``dequant_spmm_batched`` read no tiles: they walk
the operand's ``compact_block_csr`` rows and dequantize each gathered
source row in registers. These CPU tests hold the plain versions of that
walk (``ref.dequant_spmm_rows_ref`` and the batched form) to the JAX
package's Pallas kernels in interpret mode at rtol 1e-5 / atol 1e-4, on
``tests/test_torch_daq.py``'s cases, uint8 and uint16 codes, F = 52 and
64; check batched == serial bitwise and the float64 walk against the dense
plain version; and check the wrappers' ``rows`` argument. The CUDA kernels
themselves are held to these plain versions on the card by
``chip_smoke.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import daq_dequant as tdq
from repro_torch.kernels import gather_aggregate as tga
from repro_torch.kernels import ref as tref

from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)
from test_torch_daq import BATCH, CASES, _case, _codes, _torch

RTOL, ATOL = 1e-5, 1e-4
DTYPES = ["uint8", "uint16"]
FEATURES = [52, 64]


def _rows(ops):
    return tga.compact_block_csr(*_torch(*ops))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("f", FEATURES)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_rows_plain_versions_match_jax(case, f, dtype):
    ops, pv, (codes, scales, mins), want, want_serial, oracle = _case(
        case, f, dtype)
    rows = _rows(ops)
    batched = tref.dequant_spmm_rows_batched_ref(
        rows, *_torch(codes, scales, mins)).numpy()
    assert batched.dtype == np.float32 and batched.shape == (BATCH, pv, f)
    np.testing.assert_allclose(batched, want, rtol=RTOL, atol=ATOL)
    serial = tref.dequant_spmm_rows_ref(
        rows, *_torch(codes[0], scales[0], mins[0])).numpy()
    assert serial.shape == (pv, f)
    for jax_out in (want_serial, oracle):
        np.testing.assert_allclose(serial, jax_out, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("f", FEATURES)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_rows_plain_version_batched_is_serial(case, f, dtype):
    ops, _, (codes, scales, mins), *_ = _case(case, f, dtype)
    rows = _rows(ops)
    c, s, m = _torch(codes, scales, mins)
    batched = tref.dequant_spmm_rows_batched_ref(rows, c, s, m)
    for b in range(BATCH):
        assert torch.equal(batched[b],
                           tref.dequant_spmm_rows_ref(rows, c[b], s[b], m[b]))
    # In float64 the walk is the dense plain version over the tiles.
    blocks, cols, mask = _torch(*ops)
    np.testing.assert_allclose(
        tref.dequant_spmm_rows_batched_ref(rows, c, s, m,
                                           dtype=torch.float64).numpy(),
        tref.dequant_spmm_batched_ref(blocks.double(), cols, mask.double(),
                                      c, s, m).numpy(),
        rtol=1e-12, atol=1e-12)


def test_zero_padded_source_rows_contribute_exactly_zero_on_rows():
    """As ``test_torch_daq.py``'s dense test: output rows 0..127 read only
    source block 1, all zero padding (code 0, scale 0, min 0); the walk
    gives exactly 0 there in f32 and in float64."""
    rng = np.random.default_rng(6)
    s = np.concatenate([rng.integers(128, 256, 400),
                        rng.integers(0, 128, 400)]).astype(np.int32)
    r = np.concatenate([rng.integers(0, 128, 400),
                        rng.integers(128, 256, 400)]).astype(np.int32)
    ops = tga.build_block_csr(s, r, 256)[:3]
    codes, scales, mins = _codes(np.uint8, (2, 256, 52), rng)
    codes[:, 128:], scales[:, 128:], mins[:, 128:] = 0, 0.0, 0.0
    rows = _rows(ops)
    for dtype in (torch.float32, torch.float64):
        out = tref.dequant_spmm_rows_batched_ref(
            rows, *_torch(codes, scales, mins), dtype=dtype)
        assert out.dtype == dtype
        assert (out[:, :128] == 0).all()
        assert out[:, 128:].abs().max() > 0


@pytest.mark.parametrize("bad", ["other_tiles", "max_src", "device"])
def test_dequant_wrappers_reject_rows_that_do_not_fit(bad):
    ops, _, (codes, scales, mins), *_ = _case(0, 52, "uint8")
    blocks, cols, mask = _torch(*ops)
    c, s, m = _torch(codes, scales, mins)
    rows = _rows(ops)
    if bad == "other_tiles":          # another operand's rows
        rows = _rows(_case(1, 52, "uint8")[0])
        assert rows.tiles != tuple(blocks.shape[:2])
    elif bad == "max_src":            # reads past the code table
        rows = dataclasses.replace(rows, max_src=c.shape[1])
    else:                             # an operand on another device
        rows = dataclasses.replace(rows, **{
            f.name: getattr(rows, f.name).to("meta")
            for f in dataclasses.fields(rows)
            if isinstance(getattr(rows, f.name), torch.Tensor)})
    with pytest.raises(ValueError):
        tdq.dequant_spmm(blocks, cols, mask, c[0], s[0], m[0], rows=rows)
    with pytest.raises(ValueError):
        tdq.dequant_spmm_batched(blocks, cols, mask, c, s, m, rows=rows)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_dequant_wrappers_with_rows_give_the_dense_plain_version(dtype):
    ops, _, (codes, scales, mins), *_ = _case(1, 64, dtype)
    blocks, cols, mask = _torch(*ops)
    c, s, m = _torch(codes, scales, mins)
    rows = _rows(ops)
    before = (tdq.dequant_spmm.launches, tdq.dequant_spmm_batched.launches)
    assert torch.equal(
        tdq.dequant_spmm(blocks, cols, mask, c[0], s[0], m[0], rows=rows),
        tref.dequant_spmm_ref(blocks, cols, mask, c[0], s[0], m[0]))
    assert torch.equal(
        tdq.dequant_spmm_batched(blocks, cols, mask, c, s, m, rows=rows),
        tref.dequant_spmm_batched_ref(blocks, cols, mask, c, s, m))
    assert (tdq.dequant_spmm.launches,
            tdq.dequant_spmm_batched.launches) == before
