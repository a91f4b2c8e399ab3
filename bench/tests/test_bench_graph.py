"""The benchmark's frozen copies against the program they were copied from:
the Table III generator and the planner's vertex -> fog assignment."""
import numpy as np
import pytest
import torch

import graphgen
import inputs
import placement_copy
import run


@pytest.mark.parametrize("name,scale", [("siot", 0.05), ("rmat-40k", 0.01),
                                        ("rmat-20k", 0.02)])
def test_generator_equals_the_ports_loader(name, scale):
    from repro_torch.gnn import datasets
    want = datasets.load(name, scale, seed=0)
    got = graphgen.generate(name, scale, 0)
    assert got["num_vertices"] == want.num_vertices
    for key in graphgen.KEYS:
        a, b = got[key], getattr(want, key)
        assert (a is None and b is None) or np.array_equal(a, b), key


def test_cache_round_trip(tmp_path):
    a = graphgen.load("siot", 0.02, 0, tmp_path)
    b = graphgen.load("siot", 0.02, 0, tmp_path)
    assert len(list(tmp_path.iterdir())) == 1
    for key in graphgen.KEYS:
        assert (a[key] is None and b[key] is None) or np.array_equal(
            a[key], b[key])


@pytest.mark.parametrize("name,scale,kind,dims", [
    ("siot", 0.08, "gcn", [52, 64, 2]),
    ("rmat-40k", 0.02, "gat", [32, 64, 8])])
def test_assignment_equals_the_ports_placement(name, scale, kind, dims):
    from repro_torch.api import Engine
    from repro_torch.gnn.graph import Graph
    g = graphgen.generate(name, scale, 0)
    graph = Graph(num_vertices=g["num_vertices"],
                  **{k: g[k] for k in graphgen.KEYS})
    params = inputs.make_weights(
        run.kind_file(kind).weight_shapes({"dims": dims}),
        torch.Generator().manual_seed(0))
    plan = Engine((params, kind), cluster="1A+4B+1C", executor="mesh-bsp",
                  aggregation="segment_sum", device="cpu").compile(graph)
    got = placement_copy.assignment(g, "1A+4B+1C", k_layers=len(dims) - 1)
    assert np.array_equal(got, plan.placement.assignment)
    assert len(np.unique(got)) == 6


def test_inputs_are_the_seeds():
    feats = np.zeros((50, 52), np.float32)
    spec = {"kind": "onehot_blocks", "blocks": 4}

    def draw(seed):
        gen, rng = inputs.generators(seed, "cpu")
        w = inputs.make_weights(
            run.kind_file("gcn").weight_shapes({"dims": [52, 64, 2]}), gen)
        pool = inputs.make_snapshots(spec, feats, 6, gen)
        st = inputs.make_stacks(pool, {"batch": 3, "stacks": 2}, rng)
        return w, pool, st

    a, b, c = draw(2**31 + 7), draw(2**31 + 7), draw(5)
    assert torch.equal(a[1], b[1]) and not torch.equal(a[1], c[1])
    assert all(torch.equal(x["w"], y["w"]) for x, y in zip(a[0], b[0]))
    assert [s[0].tolist() for s in a[2]] == [s[0].tolist() for s in b[2]]
    assert a[1].sum(-1).eq(4).all()      # one 1 in each of the 4 blocks
    assert a[0][0]["b"].eq(0).all()
