"""The model kinds' files (``bench/models/<kind>.py``): how the harness
finds them, that a new kind needs a file of its own and nothing else, the
weights each lays out against the flat draw written out by hand, each
reference against the port's own CPU forward, and the operation counts
against hand counts."""
import json
import math
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from conftest import BENCH, ROOT

import graphgen
import inputs
import reference
import run

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
KINDS = sorted(p.stem for p in (BENCH / "models").glob("*.py"))


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda e: e["name"])
def test_every_configurations_kind_resolves_to_its_file(entry):
    kind = json.loads((ROOT / entry["file"]).read_text())["model"]["kind"]
    mod = run.kind_file(kind)
    assert mod.__file__ == str(BENCH / "models" / f"{kind}.py")
    for name in ("weight_shapes", "layer", "forward_flops"):
        assert callable(getattr(mod, name))
    cell = next(w for w in MAN["workloads"] if w["config"] == entry["name"])
    assert run.cell(cell["name"]).gnn.__file__ == mod.__file__


def test_an_unknown_kind_fails_naming_the_known_kinds():
    with pytest.raises(SystemExit) as e:
        run.kind_file("sage")
    assert "'sage'" in str(e.value)
    assert str(e.value).endswith("known kinds: " + ", ".join(KINDS))


#: a kind no configuration has: h' = h W_self + mean_{u in N(v)} h_u W_nbr,
#: ReLU between layers; no 8-bit wire.
TOY = '''
import math
import torch
import reference


def weight_shapes(model):
    dims = model["dims"]
    return [(li, name, (fi, fo), math.sqrt(6.0 / (fi + fo)))
            for li, (fi, fo) in enumerate(zip(dims[:-1], dims[1:]))
            for name in ("w_self", "w_nbr")]


def layer(p, h, g, *, last, wire, tf32):
    a = torch.zeros_like(h).index_add_(0, g.r, h[g.s])
    a = a / torch.clamp_min(g.deg.to(h.dtype), 1.0)[:, None]
    out = reference.mm(h, p["w_self"], tf32) + reference.mm(a, p["w_nbr"],
                                                             tf32)
    return out if last else torch.relu(out)


def forward_flops(model, vertices, edges):
    dims = model["dims"]
    return sum(edges * fi + vertices * fi + 4.0 * vertices * fi * fo
               + vertices * fo for fi, fo in zip(dims[:-1], dims[1:]))
'''


def test_a_kind_file_in_another_directory_is_drawn_referenced_and_counted(
        tmp_path):
    (tmp_path / "toy.py").write_text(TOY)
    with pytest.raises(SystemExit):       # not in the benchmark's models
        run.kind_file("toy")
    c = run.cell("gcn-siot-daq.b8")
    model = {"kind": "toy", "dims": [52, 16, 2], "precision": "float32"}
    c.config = dict(c.config, model=model)
    c.gnn = run.kind_file("toy", tmp_path)
    c.traffic = dict(c.traffic, batch=2, pool=4, stacks=2)
    g, params, stacks = run.draw(c, 2**31 + 5, torch.device("cpu"), 0.02)
    assert [sorted(p) for p in params] == [["w_nbr", "w_self"]] * 2
    assert params[1]["w_nbr"].shape == (16, 2)

    x = torch.as_tensor(stacks[0][1][0])
    rg = reference.Graph(g, "cpu")
    got, slack = reference.forward(c.gnn, params, x, rg, with_slack=True)
    h = x.double()
    s, r = torch.as_tensor(g["senders"]).long(), torch.as_tensor(
        g["receivers"]).long()
    deg = torch.bincount(r, minlength=g["num_vertices"]).double()
    for li, p in enumerate(params):
        a = torch.zeros_like(h).index_add_(0, r, h[s])
        a = a / deg.clamp_min(1.0)[:, None]
        h = h @ p["w_self"].double() + a @ p["w_nbr"].double()
        h = h if li == 1 else torch.relu(h)
    assert torch.allclose(got, h, rtol=1e-12, atol=1e-12)
    assert torch.equal(slack, torch.zeros_like(got))
    with pytest.raises(ValueError, match="wire_slack"):
        reference.forward(c.gnn, params, x,
                          reference.Graph(g, "cpu", np.zeros(
                              g["num_vertices"], np.int64)), wire=True)

    ctx = SimpleNamespace(gnn=c.gnn, model=model, graphs_per_s=2.0,
                          vertices=g["num_vertices"], senders=g["senders"])
    v, e = g["num_vertices"], len(g["senders"])
    flops = (e * 52 + v * 52 + 4.0 * v * 52 * 16 + v * 16
             + e * 16 + v * 16 + 4.0 * v * 16 * 2 + v * 2)
    assert run.reader("forward_mfu")(ctx) == pytest.approx(
        100.0 * flops * 2.0 / 67e12)


def _old_draw(kind, dims, seed):
    """The weights as the harness drew them before the kinds had files of
    their own: one flat uniform draw, cut layer by layer into ``w`` then
    GCN's ``b`` (zero) or GAT's ``att_src`` and ``att_dst``."""
    gen = torch.Generator().manual_seed(seed)
    per_layer = []
    for fi, fo in zip(dims[:-1], dims[1:]):
        if kind == "gcn":
            per_layer.append([("w", (fi, fo), math.sqrt(6.0 / (fi + fo))),
                              ("b", (fo,), 0.0)])
        else:
            lim = math.sqrt(6.0 / (1 + fo))
            per_layer.append([("w", (fi, fo), math.sqrt(6.0 / (fi + fo))),
                              ("att_src", (1, fo), lim),
                              ("att_dst", (1, fo), lim)])
    sizes = [math.prod(s) for lay in per_layer for _, s, _ in lay]
    flat = torch.rand(sum(sizes), generator=gen) * 2.0 - 1.0
    parts = iter(flat.split(sizes))
    return [{name: (next(parts) * lim).reshape(shape).clone()
             for name, shape, lim in lay} for lay in per_layer]


@pytest.mark.parametrize("kind,dims", [("gcn", [52, 64, 2]),
                                       ("gat", [32, 64, 8])])
@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_weights_are_the_flat_draw_cut_in_the_old_order(kind, dims, seed):
    shapes = run.kind_file(kind).weight_shapes({"kind": kind, "dims": dims})
    got = inputs.make_weights(shapes,
                              torch.Generator().manual_seed(seed))
    want = _old_draw(kind, dims, seed)
    assert [list(p) for p in got] == [list(p) for p in want]
    for p, q in zip(got, want):
        assert all(torch.equal(p[k], q[k]) for k in q)


def test_the_single_head_gat_refuses_more_heads():
    gat = run.kind_file("gat")
    assert gat.weight_shapes({"dims": [4, 3], "heads": 1})
    with pytest.raises(ValueError, match="4"):
        gat.weight_shapes({"dims": [4, 3], "heads": 4})


@pytest.mark.parametrize("name,scale,kind,dims", [
    ("siot", 0.05, "gcn", [52, 64, 2]),
    ("rmat-40k", 0.02, "gat", [32, 64, 8])])
def test_reference_equals_the_ports_cpu_forward(name, scale, kind, dims):
    from repro_torch.gnn.graph import Graph
    from repro_torch.gnn.layers import EdgeList
    from repro_torch.gnn.models import gnn_apply
    g = graphgen.generate(name, scale, 0)
    gen = torch.Generator().manual_seed(3)
    mod = run.kind_file(kind)
    params = inputs.make_weights(mod.weight_shapes({"dims": dims}), gen)
    x = torch.as_tensor(g["features"]) + torch.randn(
        g["features"].shape, generator=gen)
    graph = Graph(num_vertices=g["num_vertices"],
                  **{k: g[k] for k in graphgen.KEYS})
    with torch.no_grad():
        got = gnn_apply(params, kind, x, EdgeList.from_graph(graph))
    want = reference.forward(mod, params, x, reference.Graph(g, "cpu"))
    np.testing.assert_allclose(got.double().numpy(), want.numpy(),
                               rtol=1e-4, atol=1e-5)
    assert reference.excess(got, want, torch.zeros_like(want)) < 1e-5


def test_forward_flops_match_hand_counts():
    # a toy graph: 4 vertices, 6 directed edges, widths [3, 2]
    model = {"dims": [3, 2]}
    assert run.kind_file("gcn").forward_flops(model, 4, 6) == (
        6 * 3 + 2 * 4 * 3 + 2 * 4 * 3 * 2 + 4 * 2)
    e = 6 + 4
    assert run.kind_file("gat").forward_flops(model, 4, 6) == (
        2 * 4 * 3 * 2 + 4 * 4 * 2 + 7 * e + 2 * e * 2)


@pytest.mark.parametrize("path", ["run.py", "control.py", "inputs.py",
                                  "reference.py", "counts.py",
                                  "metrics/forward_mfu.py"])
def test_the_shared_files_name_no_kind(path):
    """What a kind owns is in its file: the harness around it names none."""
    text = (BENCH / path).read_text().lower()
    for kind in KINDS:
        assert not re.search(rf"\b{kind}\b", text), (path, kind)
