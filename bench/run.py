#!/usr/bin/env python3
"""One cell of the benchmark of ``repro_torch``, run once.

    python3 bench/run.py --workload CELL --seed N --seconds S --trace 0|1

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (``bench/configs/<name>.json``: graph, model, engine knobs,
snapshot kind, the check's limit) and a traffic mix
(``bench/traffic/<name>.json``). The configuration's model kind brings its
own file (``bench/models/<kind>.py``: the weights' layout, the reference's
layer, the operations of a forward). The run:

1. set-up: loads the graph (``graphgen``, cached under ``bench/.cache``),
   draws the weights (in the kind's layout) and a pool of sensor
   snapshots from ``--seed`` on the card, cuts the traffic's
   micro-batches, compiles ``Engine(...).compile(graph).session()`` and
   warms it up on the cell's batch shape;
2. window: closed loop, one stacked [B, V, F] micro-batch a call into
   ``Session.execute_many`` (the call ``Server._serve_batch`` makes) for
   ``--seconds``; every call returns host arrays, so it ends in a sync;
3. with ``--trace 1``, ``torch.profiler`` over ``trace_batches`` more
   calls, read by the per-layer metrics (``bench/metrics/<name>.py``);
4. the check: a seed-drawn sample of the window's answers against the
   plain reference (``reference.py``), after the program is freed.

The last line of standard output is one JSON object; the numbers compared
end standard error. Without a CUDA card the run fails; it never falls back
to the CPU.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = BENCH / ".cache"
MODELS = BENCH / "models"
#: top-level module names the run may not hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(BENCH))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import graphgen  # noqa: E402
import inputs  # noqa: E402
import placement_copy  # noqa: E402
import reference  # noqa: E402
import tracing  # noqa: E402

GIB = float(1 << 30)


def cell(name: str) -> SimpleNamespace:
    """The cell ``name``: its manifest entry, configuration, traffic and
    the metrics it reports."""
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in man["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{', '.join(sorted(work))}")
    w = work[name]
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    if traffic["loop"] != "closed":
        raise SystemExit(f"traffic {w['traffic']!r}: only a closed loop "
                         f"is generated")

    end_to_end = [m for m in man["end_to_end"]
                  if name in m.get("workloads", [name])]
    reported = {m["name"] for m in end_to_end}
    # a per-layer metric without ``workloads`` goes with the end-to-end
    # metric it moves
    per_layer = [m for m in man["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    config = json.loads((BENCH / "configs" / f"{w['config']}.json")
                        .read_text())
    return SimpleNamespace(
        name=name, chips=int(w["chips"]), config=config,
        gnn=kind_file(config["model"]["kind"]), traffic=traffic,
        end_to_end=end_to_end, per_layer=per_layer)


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """``read(ctx)`` of the per-layer metric ``name``
    (``bench/metrics/<name>.py``)."""
    return _module(BENCH / "metrics" / f"{name}.py",
                   f"bench_metric_{name}").read


def kind_file(kind: str, models: Path = MODELS):
    """The file of the model kind ``kind``, ``<models>/<kind>.py``, with
    ``weight_shapes(model)`` ([(layer, name, shape, glorot limit)] in draw
    order), the reference's ``layer(p, h, g, last=, wire=, tf32=)``,
    ``forward_flops(model, vertices, edges)``, and ``wire_slack(p, h, g)``
    where the 8-bit wire is modelled; ``model`` is the configuration's
    ``model`` object."""
    known = sorted(p.stem for p in Path(models).glob("*.py"))
    if kind not in known:
        raise SystemExit(f"model kind {kind!r} has no file in {models}; "
                         f"known kinds: {', '.join(known)}")
    return _module(Path(models) / f"{kind}.py", f"bench_model_{kind}")


class Sample:
    """A seed-drawn uniform sample of ``k`` of the window's answers
    (reservoir sampling): (pool index of the snapshot, answer)."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        if self.seen < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def sample_rng(seed: int) -> np.random.Generator:
    """The sampler's generator of a run's ``seed`` (apart from the
    inputs')."""
    return np.random.default_rng([int(seed) % (1 << 63), 1])


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _sync(device: torch.device):
    return (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)


def draw(c: SimpleNamespace, seed: int, dev: torch.device, scale=None):
    """(graph arrays, weights, micro-batches) of a run of cell ``c`` with
    ``seed``; ``scale`` shrinks the graph (the CPU tests)."""
    cfg, data = c.config, c.config["dataset"]
    g = graphgen.load(data["name"], data["scale"] if scale is None else scale,
                      data["seed"], CACHE / "graphs")
    gen, rng = inputs.generators(seed, dev)
    params = inputs.make_weights(c.gnn.weight_shapes(cfg["model"]), gen)
    pool = inputs.make_snapshots(cfg["snapshot"], g["features"],
                                 int(c.traffic["pool"]), gen)
    return g, params, inputs.make_stacks(pool, c.traffic, rng)


def wire_quantized(knobs: dict) -> bool:
    """Whether the halo rows of a plan with engine ``knobs`` cross on the
    8-bit wire: the program quantizes them only on the block-CSR kernel
    path of a DAQ plan."""
    if knobs["aggregation"] not in ("pallas", "segment_sum"):
        raise ValueError(f"aggregation {knobs['aggregation']!r}: a "
                         f"configuration names the path it runs")
    return (knobs["compressor"].startswith("daq")
            and knobs["aggregation"] == "pallas")


def halo_bytes_per_forward(sess, dims) -> int:
    """Bytes the halo exchange of ``sess`` moves in one forward: one sync a
    layer, each of that layer's input width (``dims[:-1]``), in the
    session's own wire format; 0 off the multi-fog pipeline."""
    from repro_torch.api.registry import EXCHANGES
    backend = sess.resolve_executor()
    if backend.pipeline != "multi":
        return 0
    cfg = sess.plan.config
    dtype_bytes, row_overhead = backend.wire_format(
        sess.plan, cfg.exchange, cfg.aggregation)
    spec, pg = EXCHANGES.resolve(cfg.exchange), sess.partitioned()
    return sum(spec.bytes_per_sync(pg, int(f), dtype_bytes, row_overhead)
               for f in dims[:-1])


def fog_assignment(c: SimpleNamespace, g: dict):
    """The vertex -> fog assignment of cell ``c``'s plan on graph ``g``,
    worked out again by the frozen planner."""
    knobs = c.config["engine"]
    return placement_copy.assignment(
        g, knobs["cluster"], knobs["network"], knobs["hidden"],
        len(c.config["model"]["dims"]) - 1, knobs["seed"])


def run_cell(c: SimpleNamespace, seed: int, seconds: float, trace: bool,
             device: str = "cuda", scale=None) -> dict:
    """Run cell ``c`` once and return its result line (a dict).
    ``scale`` shrinks the graph (the CPU tests)."""
    from repro_torch.api import Engine
    from repro_torch.gnn.graph import Graph

    cfg, traffic = c.config, c.traffic
    model, knobs = cfg["model"], cfg["engine"]
    dev = torch.device(device)
    sync = _sync(dev)
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 as stated
    torch.backends.cudnn.allow_tf32 = False

    # -- set-up ------------------------------------------------------------
    parts = {"imports": time.perf_counter() - T0}
    mark = time.perf_counter()
    g, params, stacks = draw(c, seed, dev, scale)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    graph = Graph(num_vertices=g["num_vertices"],
                  **{k: g[k] for k in graphgen.KEYS})
    parts["graph_and_inputs"] = time.perf_counter() - mark
    mark = time.perf_counter()
    sess = Engine((params, model["kind"]), device=dev, **knobs
                  ).compile(graph).session()
    parts["compile"] = time.perf_counter() - mark
    mark = time.perf_counter()
    for _, feats in stacks[:2]:
        sess.execute_many(feats)
    sync()
    parts["warm_up"] = time.perf_counter() - mark
    setup_s = time.perf_counter() - T0

    # -- window ------------------------------------------------------------
    sample = Sample(int(traffic["check_graphs"]), sample_rng(seed))
    lat, graphs, i = [], 0, 0
    start = time.perf_counter()
    while True:
        idx, feats = stacks[i % len(stacks)]
        t1 = time.perf_counter()
        out = sess.execute_many(feats)
        t2 = time.perf_counter()
        lat.append(t2 - t1)
        for j, o in zip(idx, out):
            sample.offer((int(j), o))
        graphs += len(out)
        i += 1
        if t2 - start >= seconds:
            break
    window_s = t2 - start
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    graphs_per_s = graphs / window_s

    tr = None
    if trace:
        def traced():
            for k in range(int(traffic["trace_batches"])):
                with torch.profiler.record_function(
                        tracing.SPAN + "execute_many"):
                    sess.execute_many(stacks[k % len(stacks)][1])
        tr = tracing.record(traced, sync)
    halo_bytes = halo_bytes_per_forward(sess, model["dims"])
    del sess, out
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"modules loaded that the port may not load: "
                           f"{', '.join(bad)}")

    # -- the check ---------------------------------------------------------
    held = {}

    def assignment():
        if "a" not in held:
            held["a"] = fog_assignment(c, g)
        return held["a"]

    wire = wire_quantized(knobs)
    rg = reference.Graph(g, dev, assignment() if wire else None)
    pool_of = {}
    for idx, feats in stacks:
        for j, f in zip(idx, feats):
            pool_of[int(j)] = f
    worst, failed = 0.0, 0
    limit = float(cfg["check"]["emb_excess_limit"])
    for j, got in sample.items:
        want, slack = reference.forward(
            c.gnn, params, torch.as_tensor(pool_of[j], device=dev), rg,
            wire=wire, with_slack=True)
        gap = reference.excess(torch.as_tensor(got, device=dev), want, slack)
        worst = max(worst, gap)
        failed += gap > limit
    checks = {"emb_excess": {"value": worst, "limit": limit}}
    correct = bool(sample.items) and worst <= limit

    # -- metrics -----------------------------------------------------------
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
                "count": c.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": graphs,
              "failed": int(failed)}
    if not trace:
        e2e = {"graphs_per_s": graphs_per_s,
               "batch_p95_ms": float(np.percentile(lat, 95)) * 1e3,
               "peak_mem_gib": peak / GIB, "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]],
                                         "unit": m["unit"]}
                             for m in c.end_to_end}
    else:
        ctx = SimpleNamespace(
            trace=tr, config=cfg, graphs_per_s=graphs_per_s,
            batches=int(traffic["trace_batches"]),
            graphs=int(traffic["trace_batches"]) * int(traffic["batch"]),
            batch=int(traffic["batch"]), model=model, gnn=c.gnn,
            kind=model["kind"], dims=model["dims"],
            vertices=int(g["num_vertices"]),
            senders=g["senders"], receivers=g["receivers"],
            halo_bytes=halo_bytes, assignment=assignment, setup_parts=parts)
        metrics = {}
        for m in c.per_layer:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        dev_info["busy_s"] = tr.busy_us() / 1e6
        dev_info["window_s"] = tr.window_us / 1e6
        result["breakdown"] = {"device_ops": tracing.top_device_ops(tr),
                               "idle_gaps": tracing.top_idle_gaps(tr)}
    result["device"] = dev_info
    result["setup_parts_s"] = parts    # not a metric: where set-up went
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    c = cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        print(f"run.py: {c.name} needs {c.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    result = run_cell(c, args.seed, args.seconds, bool(args.trace))
    for name, chk in result["checks"].items():
        print(f"check {name} {chk['value']!r} limit {chk['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
