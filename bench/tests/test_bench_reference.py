"""The wire's rounding against ``runtime.bsp``'s, the wire's slack, the
control's precision, and the shared count functions against hand counts
(each kind's reference and forward count: ``test_bench_models.py``)."""
import numpy as np
import pytest
import torch

import counts
import reference


def test_wire_roundtrip_equals_the_ports_wire_quantize():
    from repro_torch.runtime.bsp import _wire_quantize
    gen = torch.Generator().manual_seed(0)
    h = torch.randn((300, 64), generator=gen) * torch.rand(
        (300, 1), generator=gen) * 5
    h[7] = 0.0                        # an all-zero (padding) row
    codes, scales, mins = _wire_quantize(h)
    want = codes.float() * scales[:, None] + mins[:, None]
    got = reference.wire_roundtrip(h)
    assert torch.equal(got, want)
    assert torch.equal(reference.wire_roundtrip(h.double()),
                       codes.double() * scales.double()[:, None]
                       + mins.double()[:, None])


@pytest.mark.parametrize("code", [0, 1, 200, 254])
def test_slack_covers_a_flipped_code_on_a_rounding_edge(code):
    g = {"num_vertices": 3, "senders": np.array([0, 1], np.int32),
         "receivers": np.array([1, 2], np.int32)}
    rg = reference.Graph(g, "cpu", np.array([0, 1, 1]))
    # row 0's feature 1 sits half a code step above ``code``: on the edge
    # between it and the next, where a last-bit difference flips the code
    h = torch.tensor([[0.0, (code + 0.5 - 1e-6) / 255, 1.0],
                      [0.0, 0.2, 1.0], [0.0, 0.3, 1.0]],
                     dtype=torch.float64)
    w = torch.tensor([[1.0], [2.0], [3.0]], dtype=torch.float64)
    slack = reference.wire_slack(h, w, rg)
    step = (1.0 / 255) * 2.0 / 2.0     # one code of row 0 through w, /(deg+1)
    assert slack[1, 0].item() == pytest.approx(step, rel=1e-6)
    assert slack[0, 0] == 0 and slack[2, 0] == 0   # no edge / not crossing
    h[0, 1] = (code + 0.4) / 255       # off the edge: no slack
    assert reference.wire_slack(h, w, rg).abs().max() == 0


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12,
                      -1.0 - 2.0 ** -11])
    got = reference.tf32_round(x)
    assert got.tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0,
                            -1.0 - 2.0 ** -10]


def test_counts_match_hand_counts():
    nbytes, flops = counts.spmm_bytes_flops(6, 4, 4, 3, 2)
    assert nbytes == 6 * 8 + 2 * (4 * 3 * 4 + 4 * 3 * 4) and flops == 72
    nbytes, _ = counts.spmm_bytes_flops(2, 1, 4, 3, 1, code_bytes=1,
                                        row_bytes=8)
    assert nbytes == 2 * 8 + (1 * (3 + 8) + 4 * 3 * 4)
    nbytes, flops = counts.segment_bytes_flops(10, 4, 4, 2, True, True)
    assert nbytes == 10 * 12 + 5 * 4 + 4 * 2 * 4 + 4 * 2 * 4
    assert flops == 40
    nbytes, flops = counts.segment_bytes_flops(10, 10, 4, 1, False, False)
    assert nbytes == 10 * 4 + 5 * 4 + 10 * 4 + 4 * 4 and flops == 10
    part = np.array([0, 0, 1, 1])
    s, r = np.array([0, 1, 2, 1, 3, 0]), np.array([1, 0, 3, 2, 0, 3])
    assert counts.fog_edges(part, s, r) == (3, 3, 3)
    assert counts.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 67e12) == pytest.approx(1.0)
