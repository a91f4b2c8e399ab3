"""The multi-head GAT's file (``bench/models/gat_heads.py``) and the two
metrics that read its cell: the weights laid out against the flat draw by
hand, the float64 reference against the port's own CPU forward at cut
widths, the operation count against a hand count, and the readers on
hand-built traces (nothing where their kernel or span is absent); then a
traced CPU run of the cell at cut widths."""
import json
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from conftest import ROOT

import graphgen
import inputs
import reference
import run
import tracing

HEADS = run.kind_file("gat_heads")
#: cut widths: heads [2, 2, 3] of [8, 8, 5], so the skip is present.
CUT = {"kind": "gat_heads", "dims": [32, 16, 16, 5], "heads": [2, 2, 3],
       "precision": "float32"}


def test_the_configuration_is_the_ppi_model_at_its_published_widths():
    cfg = json.loads((ROOT / "bench/configs/gat-ppi-rmat40k.json")
                     .read_text())
    model = cfg["model"]
    assert model == {"kind": "gat_heads", "dims": [32, 1024, 1024, 121],
                     "heads": [4, 4, 6], "precision": "float32"}
    assert [d for _, _, d in HEADS.layer_shapes(model)] == cfg["head_dims"]
    assert cfg["engine"]["hidden"] == cfg["hidden"] == 1024
    assert cfg["reduced"] == ["edges"]
    for key in ("input_width", "output_width", "skip", "output"):
        assert key in cfg["assumed"]


def test_weights_are_the_flat_draw_cut_in_layer_order():
    seed = 2**31 + 5
    shapes = HEADS.weight_shapes(CUT)
    assert [(li, name, shape) for li, name, shape, _ in shapes] == [
        (0, "w", (32, 16)), (0, "att_src", (2, 8)), (0, "att_dst", (2, 8)),
        (1, "w", (16, 16)), (1, "att_src", (2, 8)), (1, "att_dst", (2, 8)),
        (2, "w", (16, 15)), (2, "att_src", (3, 5)), (2, "att_dst", (3, 5))]
    lims = [lim for _, _, _, lim in shapes]
    assert lims[0] == math.sqrt(6.0 / 48) and lims[1] == math.sqrt(6.0 / 9)
    assert lims[6] == math.sqrt(6.0 / 31) and lims[7] == math.sqrt(6.0 / 6)
    got = inputs.make_weights(shapes, torch.Generator().manual_seed(seed))
    flat = torch.rand(sum(math.prod(s) for _, _, s, _ in shapes),
                      generator=torch.Generator().manual_seed(seed))
    flat = flat * 2.0 - 1.0
    at = 0
    for li, name, shape, lim in shapes:
        n = math.prod(shape)
        want = (flat[at:at + n] * lim).reshape(shape)
        assert torch.equal(got[li][name], want), (li, name)
        at += n


def test_widths_that_the_heads_do_not_cut_are_refused():
    with pytest.raises(ValueError, match="divide"):
        HEADS.weight_shapes({"dims": [32, 10, 5], "heads": [4, 1]})
    with pytest.raises(ValueError, match="head counts"):
        HEADS.weight_shapes({"dims": [32, 16, 5], "heads": [2]})


def test_reference_equals_the_ports_cpu_forward():
    from repro_torch.gnn.graph import Graph
    from repro_torch.gnn.layers import EdgeList
    from repro_torch.gnn.models import gnn_apply
    g = graphgen.generate("rmat-40k", 0.02, 0)
    gen = torch.Generator().manual_seed(3)
    params = inputs.make_weights(HEADS.weight_shapes(CUT), gen)
    x = torch.as_tensor(g["features"]) + torch.randn(
        g["features"].shape, generator=gen)
    graph = Graph(num_vertices=g["num_vertices"],
                  **{k: g[k] for k in graphgen.KEYS})
    with torch.no_grad():
        got = gnn_apply(params, "gat_heads", x, EdgeList.from_graph(graph))
    rg = reference.Graph(g, "cpu")
    want = reference.forward(HEADS, params, x, rg)
    assert got.shape == want.shape == (g["num_vertices"], 5)
    np.testing.assert_allclose(got.double().numpy(), want.numpy(),
                               rtol=1e-4, atol=1e-5)
    assert reference.excess(got, want, torch.zeros_like(want)) < 1e-5
    # the messages in blocks of a few edges are the messages whole
    old = HEADS.BLOCK
    try:
        HEADS.BLOCK = 64
        assert torch.equal(reference.forward(HEADS, params, x, rg), want)
    finally:
        HEADS.BLOCK = old
    # and the TF32 control is far off
    tf32 = reference.forward(HEADS, params, x, rg, precision="tf32")
    assert reference.excess(tf32, want, torch.zeros_like(want)) > 1e-4


def test_forward_flops_match_a_hand_count():
    # 4 vertices, 6 directed edges (10 with self loops); heads [2, 3] of
    # [3, 2]: a hidden layer 6 wide on a 6-wide input (so the skip), then
    # three averaged heads of 2
    model = {"dims": [6, 6, 2], "heads": [2, 3]}
    e, v = 10, 4
    hidden = (2 * v * 6 * 6 + 4 * v * 6 + 7 * e * 2 + 2 * e * 6
              + v * 6)
    last = (2 * v * 6 * 6 + 4 * v * 6 + 7 * e * 3 + 2 * e * 6
            + v * 6)
    assert HEADS.forward_flops(model, v, 6) == hidden + last
    # the published model: ~154 GFLOP a graph on RMAT-40k
    flops = HEADS.forward_flops(
        {"dims": [32, 1024, 1024, 121], "heads": [4, 4, 6]}, 40_000,
        1_359_590)
    assert 150e9 < flops < 160e9


def _ctx(device=(), host=(), model=CUT, gnn=HEADS, batches=2, batch=2):
    tr = tracing.Trace(device=list(device), host=list(host),
                       window_us=10_000.0, start_us=0.0)
    return SimpleNamespace(trace=tr, model=model, gnn=gnn, vertices=4,
                           senders=np.array([0, 1, 2, 1, 3, 0]),
                           batches=batches, batch=batch,
                           graphs=batches * batch)


def test_the_roofline_from_a_hand_count():
    # per layer over 4 vertices and 10 entries: 4 + 4 H bytes an entry, 5
    # offsets, the source rows and the output, H * D floats each
    def nbytes(h, width):
        return 10 * (4 + 4 * h) + 5 * 4 + 2 * 4 * width * 4
    need = sum(nbytes(h, w) / 3.35e12 for h, w in ((2, 16), (2, 16),
                                                   (3, 15)))
    kernel = "void (anonymous namespace)::headed_sum_kernel<4, 2>(...)"
    dev = [(0.0, 10.0, "kernel", kernel), (20.0, 30.0, "kernel", kernel),
           (40.0, 50.0, "kernel", "void segment_kernel<1, 1, true>(...)")]
    got = run.reader("headed_sum_roofline")(_ctx(dev))
    assert got == pytest.approx(100.0 * need * 4 / 20e-6, rel=1e-12)


def test_the_roofline_reads_nothing_without_its_kernel():
    read = run.reader("headed_sum_roofline")
    seg = [(0.0, 10.0, "kernel", "void segment_kernel<1, 1, true>(...)")]
    assert read(_ctx(seg)) is None
    assert read(SimpleNamespace(trace=None)) is None
    kernel = [(0.0, 10.0, "kernel", "headed_sum_kernel<4, 2>")]
    one_head = {"kind": "gat", "dims": [32, 64, 8], "precision": "float32"}
    assert read(_ctx(kernel, model=one_head,
                     gnn=run.kind_file("gat"))) is None
    assert read(_ctx(kernel, model=dict(CUT, heads=[1, 1, 1]))) is None


def test_the_attention_span_per_graph():
    host = [(0.0, 900.0, "fog.layer"), (100.0, 400.0, "fog.attention"),
            (1_000.0, 1_500.0, "fog.attention"),
            (2_000.0, 2_100.0, "aten::mm")]
    got = run.reader("attention_ms_per_graph")(_ctx(host=host))
    assert got == pytest.approx(0.8 / 4)
    assert run.reader("attention_ms_per_graph")(
        _ctx(host=host[:1] + host[3:])) is None
    assert run.reader("attention_ms_per_graph")(
        SimpleNamespace(trace=None, graphs=1)) is None


def test_a_traced_cpu_run_of_the_cell_at_cut_widths():
    c = run.cell("gat-ppi-rmat40k.b8")
    c.config = dict(c.config, model=CUT)
    c.traffic = dict(c.traffic, batch=2, pool=4, stacks=2, trace_batches=2,
                     check_graphs=4)
    r = run.run_cell(c, 2**31 + 7, 0.0, True, device="cpu", scale=0.02)
    assert r["correct"] and r["failed"] == 0
    assert r["checks"]["emb_excess"]["value"] < 1e-5
    assert r["metrics"]["attention_ms_per_graph"]["value"] > 0
    # the batched mesh path's spans read in this cell as in the GAT cell
    for name in ("stage_ms_per_graph", "dispatch_ms_per_graph",
                 "unfold_ms_per_graph", "syncs_per_batch"):
        assert r["metrics"][name]["value"] > 0, name
    # no card, no kernel: the roofline reads nothing
    assert "headed_sum_roofline" not in r["metrics"]
    per_layer = {m["name"] for m in c.per_layer}
    assert {"headed_sum_roofline", "attention_ms_per_graph"} <= per_layer
    assert {m["name"] for m in c.end_to_end} == {
        "graphs_per_s", "batch_p95_ms", "peak_mem_gib", "setup_s"}


def test_the_tf32_control_fails_the_cells_limit():
    """The reference in TF32 on a run's sampled graphs, at the published
    widths on a small graph, lands far past the cell's limit."""
    import control
    c = run.cell("gat-ppi-rmat40k.b8")
    c.traffic = dict(c.traffic, batch=2, pool=4, stacks=2, check_graphs=2)
    value = control.control_excess(c, 2**31 + 12, "cpu", 0.02)
    assert value > 3 * float(c.config["check"]["emb_excess_limit"])
