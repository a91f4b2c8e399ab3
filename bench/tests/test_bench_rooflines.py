"""The block kernels' roofline readers on hand-built traces: the least time
of the products a traced batch needs, counted by hand, over the kernel's
device time; nothing where the kernel did not run."""
from types import SimpleNamespace

import numpy as np
import pytest

import run
import tracing

#: 4 vertices on two fogs, 6 directed edges: 3 within a fog, 3 across
#: from 3 distinct rows (``counts.fog_edges``); widths [3, 2], so one
#: product a layer at F = 3; 2 batches of 2 graphs traced.
PART = np.array([0, 0, 1, 1])
SENDERS = np.array([0, 1, 2, 1, 3, 0])
RECEIVERS = np.array([1, 0, 3, 2, 0, 3])
#: bytes of one batched product: 8 a nonzero, then per graph the source
#: rows (F floats, or F codes and an 8-byte (scale, min) pair) and the
#: 4 output rows
LOCAL = 3 * 8 + 2 * (4 * 3 * 4 + 4 * 3 * 4)
CROSS_F32 = 3 * 8 + 2 * (3 * 3 * 4 + 4 * 3 * 4)
CROSS_8BIT = 3 * 8 + 2 * (3 * (3 * 1 + 8) + 4 * 3 * 4)


def _ctx(kernel, compressor, durations_us=(10.0, 10.0)):
    device, t = [], 0.0
    for d in durations_us:
        device.append((t, t + d, "kernel", f"void {kernel}<2, int>(...)"))
        t += 2 * d
    device.append((0.0, 1.0, "gpu_memcpy", "Memcpy HtoD"))
    tr = tracing.Trace(device=device, host=[], window_us=t, start_us=0.0)
    return SimpleNamespace(
        trace=tr, assignment=lambda: PART, senders=SENDERS,
        receivers=RECEIVERS, vertices=4, dims=[3, 2], batch=2, batches=2,
        config={"engine": {"compressor": compressor}})


@pytest.mark.parametrize("name,kernel,compressor,nbytes", [
    ("block_spmm_roofline", "rows_spmm_kernel", "daq", LOCAL),
    ("block_spmm_roofline", "rows_spmm_kernel", "none", LOCAL + CROSS_F32),
    ("dequant_spmm_roofline", "dequant_rows_kernel", "daq", CROSS_8BIT)])
def test_value_from_hand_counts(name, kernel, compressor, nbytes):
    busy_s = 20e-6
    want = 100.0 * (nbytes / 3.35e12) * 2 / busy_s
    got = run.reader(name)(_ctx(kernel, compressor))
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", ["block_spmm_roofline",
                                  "dequant_spmm_roofline"])
def test_nothing_where_the_kernel_did_not_run(name):
    assert run.reader(name)(_ctx("segment_kernel", "daq")) is None
    assert run.reader(name)(SimpleNamespace(trace=None)) is None
