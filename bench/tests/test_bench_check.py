"""The check that decides ``correct``: sound runs pass it, the control (the
reference in TF32) and every fault a cell can have fail it. Runs drive
``run.run_cell`` on the CPU at a small scale (the harness's look for a
card skipped); the window is one call, so every answer is judged."""
import json
import shutil
import subprocess
import sys

import pytest
import torch
from conftest import BENCH, ROOT

import control
import run

CELLS = {"gcn-siot-daq.b8": 0.05, "gat-rmat40k.b8": 0.02}
SMALL = {"batch": 4, "pool": 8, "stacks": 2, "trace_batches": 2,
         "check_graphs": 4}


def _cell(name):
    c = run.cell(name)
    c.traffic = dict(c.traffic, **SMALL)
    return c


def _run(name, seed=2**31 + 5, trace=False):
    return run.run_cell(_cell(name), seed, 0.0, trace, device="cpu",
                        scale=CELLS[name])


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] == 4
    chk = r["checks"]["emb_excess"]
    assert chk["value"] < chk["limit"] / 10
    assert set(r["metrics"]) == {m["name"] for m in _cell(name).end_to_end}
    assert {"peak_mem_gib", "setup_s"} <= set(r["metrics"])
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reports_per_layer_metrics(name):
    r = _run(name, seed=9, trace=True)
    assert r["correct"]
    names = {m["name"] for m in _cell(name).per_layer}
    assert "compile_s" in r["metrics"] and set(r["metrics"]) <= names
    if "graphs_per_s" in {m["name"] for m in _cell(name).end_to_end}:
        assert {"halo_bytes_per_graph", "forward_mfu"} <= set(r["metrics"])
    assert r["device"]["window_s"] > 0 and "breakdown" in r


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [11, 2**31 + 12])
def test_the_tf32_control_fails_the_limit(name, seed):
    c = _cell(name)
    value = control.control_excess(c, seed, "cpu", CELLS[name])
    assert value > 3 * float(c.config["check"]["emb_excess_limit"])


def _stale(orig):
    last = {}

    def execute_many(self, feats, **kw):
        out = orig(self, feats, **kw)
        prev, last["out"] = last.get("out", out), out
        return prev
    return execute_many


def _half(orig):
    def execute_many(self, feats, **kw):
        out = orig(self, feats[: len(feats) // 2], **kw)
        return out + out[: len(feats) - len(out)]
    return execute_many


def _altered(orig):
    def execute_many(self, feats, **kw):
        out = [o.copy() for o in orig(self, feats, **kw)]
        for o in out:
            o[0, 0] += 1e-3 * abs(o).max()
        return out
    return execute_many


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["stale", "half", "altered", "exchange"])
def test_a_fault_makes_the_run_incorrect(name, fault, monkeypatch):
    from repro_torch.api.session import Session
    from repro_torch.runtime import bsp
    if fault == "exchange":
        orig_x = bsp._exchange
        monkeypatch.setattr(bsp, "_exchange", lambda *a: tuple(
            torch.zeros_like(t) for t in orig_x(*a)))
    else:
        wrap = {"stale": _stale, "half": _half, "altered": _altered}[fault]
        monkeypatch.setattr(Session, "execute_many",
                            wrap(Session.execute_many))
    r = _run(name)
    assert not r["correct"]
    assert r["checks"]["emb_excess"]["value"] > \
        r["checks"]["emb_excess"]["limit"]


def test_without_a_card_the_run_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "gcn-siot-daq.b8", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=ROOT, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_the_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "gcn-siot-daq.b8", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=tmp_path, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.card
def test_a_short_run_on_the_card(card):
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "gcn-siot-daq.b8", "--seed", "77", "--seconds", "2",
                        "--trace", "1"], capture_output=True, text=True,
                       cwd=ROOT, timeout=360)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert r["device"]["busy_s"] > 0


@pytest.mark.parametrize("compressor,aggregation,wire", [
    ("daq", "segment_sum", (4, 0)), ("none", "segment_sum", (4, 0)),
    ("daq", "pallas", (1, 8))])
def test_halo_bytes_are_counted_at_each_layers_width(compressor, aggregation,
                                                     wire):
    import numpy as np
    from repro_torch.api import Engine
    from repro_torch.gnn.graph import Graph
    import graphgen
    import inputs
    dims = [12, 20, 3]
    g = graphgen.generate("siot", 0.02, 0)
    g["features"] = g["features"][:, :dims[0]]
    graph = Graph(num_vertices=g["num_vertices"],
                  **{k: g[k] for k in graphgen.KEYS})
    params = inputs.make_weights(
        run.kind_file("gcn").weight_shapes({"dims": dims}),
        torch.Generator().manual_seed(0))
    knobs = {"compressor": compressor, "aggregation": aggregation}
    sess = Engine((params, "gcn"), cluster="1A+4B+1C", executor="mesh-bsp",
                  device="cpu", **knobs).compile(graph).session()
    pg = sess.partitioned()
    halo_rows = pg.n * pg.boundary_slots
    assert halo_rows > 0 and len(np.unique(
        sess.placement.assignment)) > 1
    dtype_bytes, row_overhead = wire
    want = [halo_rows * (f * dtype_bytes + row_overhead) for f in dims[:-1]]
    assert run.halo_bytes_per_forward(sess, dims) == sum(want)
    assert sess.exchange_bytes() == want[0]     # the first layer's sync
    assert run.wire_quantized(knobs) == (wire == (1, 8))
