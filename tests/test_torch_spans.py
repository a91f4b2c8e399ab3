"""The port's spans (``repro_torch.runtime.trace``) on the folded
``mesh-bsp`` serving path, on the CPU.

Under ``torch.profiler`` a served batch records the documented ``fog.*``
spans and no others, each nested where its layer sits (stage, scatter and
H2D; one span a BSP superstep with its exchange and kernel calls inside;
the unfold), in the counts the code runs them: on the segment path one
``fog.layer`` an example and layer, on the kernel path one a layer.
Without a profiler a span enters no ``record_function``, and the answers
are bitwise the same either way.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.api import Engine
from repro_torch.gnn import datasets as tdata
from repro_torch.gnn import models as tmodels
from repro_torch.kernels import daq_dequant, gather_aggregate, segment_sum
from repro_torch.runtime import trace

from _torch_threads import one_cpu_thread  # noqa: F401  (autouse)

K, B = 2, 3
KERNELS = ("block_spmm", "block_spmm_batched", "dequant_spmm",
           "dequant_spmm_batched", "dequant", "segment_sum")
DOCUMENTED = {"fog." + n for n in ("execute_many", "execute", "stage",
                                   "scatter", "h2d", "layer", "exchange",
                                   "unfold")} | {
    "fog.kernel." + k for k in KERNELS}
#: (kind, compressor, aggregation, kernel spans a superstep runs)
PATHS = [("gat", "none", "segment_sum", {"segment_sum": 2}),
         ("gcn", "none", "segment_sum", {"segment_sum": 1}),
         ("gcn", "daq", "pallas", {"block_spmm_batched": 1,
                                   "dequant_spmm_batched": 1}),
         ("gcn", "none", "pallas", {"block_spmm_batched": 2})]
COUNTERS = [(gather_aggregate.block_spmm, "launches"),
            (gather_aggregate.block_spmm_batched, "launches"),
            (daq_dequant.dequant_spmm, "launches"),
            (daq_dequant.dequant_spmm_batched, "launches"),
            (segment_sum.segment_sum, "launches")]


@functools.lru_cache(maxsize=None)
def _graph():
    return tdata.load("siot", scale=0.03, seed=0)


def _session(kind, comp, agg):
    g = _graph()
    params = tmodels.gnn_init(torch.Generator().manual_seed(0), kind,
                              [g.feature_dim, 8, 4])
    return Engine((params, kind), cluster="1A+2B+1C", compressor=comp,
                  executor="mesh-bsp", aggregation=agg,
                  device="cpu").compile(g).session()


def _stack():
    g = _graph()
    rng = np.random.default_rng(1)
    return (g.features[None] + rng.normal(
        scale=0.1, size=(B,) + g.features.shape)).astype(np.float32)


def _profiled(fn):
    """fn() under a CPU profiler -> (its answer, the fog.* spans as
    (start, end, name), and each span's innermost enclosing fog.* span)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    spans = sorted(((e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events() if e.name.startswith("fog.")),
                   key=lambda s: (s[0], -s[1]))
    parents = []
    for i, (s, e, _) in enumerate(spans):
        holders = [o for j, o in enumerate(spans)
                   if j != i and o[0] <= s and e <= o[1]]
        parents.append(max(holders, key=lambda o: o[0]) if holders else None)
    return out, spans, parents


def _count(spans, name):
    return sum(1 for s in spans if s[2] == name)


@pytest.mark.parametrize("path", PATHS, ids=lambda p: "-".join(p[:3]))
def test_batch_spans_nest_by_layer(path):
    kind, comp, agg, per_step = path
    sess = _session(kind, comp, agg)
    out, spans, parents = _profiled(lambda: sess.execute_many(_stack()))
    assert len(out) == B
    names = {s[2] for s in spans}
    assert names <= DOCUMENTED, names - DOCUMENTED
    batch = [s for s in spans if s[2] == "fog.execute_many"]
    assert len(batch) == 1
    for span, parent in zip(spans, parents):
        name = span[2]
        if name in ("fog.stage", "fog.layer", "fog.unfold"):
            inside = [b for b in batch
                      if b[0] <= span[0] and span[1] <= b[1]]
            assert len(inside) == 1, name
        if name in ("fog.scatter", "fog.h2d"):
            assert parent[2] == "fog.stage", name
        if name == "fog.exchange" or name.startswith("fog.kernel."):
            assert parent[2] == "fog.layer", name
    steps = K * B if agg == "segment_sum" else K
    assert _count(spans, "fog.layer") == steps
    assert _count(spans, "fog.exchange") == steps
    for one in ("fog.stage", "fog.scatter", "fog.h2d", "fog.unfold"):
        assert _count(spans, one) == 1, one
    kernels = {s[2] for s in spans if s[2].startswith("fog.kernel.")}
    assert kernels == {"fog.kernel." + k for k in per_step}
    for k, n in per_step.items():
        assert _count(spans, "fog.kernel." + k) == n * steps, k


def test_query_spans_stage_twice_and_run_each_layer_once():
    """``Session.execute`` (one query): the scatter into the layout and
    the H2D are two stages; one superstep a layer."""
    sess = _session("gcn", "daq", "pallas")
    _, spans, parents = _profiled(lambda: sess.execute(_stack()[0]))
    assert {s[2] for s in spans} <= DOCUMENTED
    assert _count(spans, "fog.execute") == 1
    assert _count(spans, "fog.execute_many") == 0
    assert _count(spans, "fog.stage") == 2
    assert _count(spans, "fog.layer") == _count(spans, "fog.exchange") == K
    assert _count(spans, "fog.kernel.dequant_spmm") == K
    for span, parent in zip(spans, parents):
        if span[2] in ("fog.scatter", "fog.h2d"):
            assert parent[2] == "fog.stage"


@pytest.mark.parametrize("path", PATHS, ids=lambda p: "-".join(p[:3]))
def test_spans_leave_answers_and_counters_unchanged(path):
    sess = _session(*path[:3])
    stack = _stack()
    before = [getattr(f, a) for f, a in COUNTERS]
    plain = sess.execute_many(stack)
    mid = [getattr(f, a) for f, a in COUNTERS]
    traced, _, _ = _profiled(lambda: sess.execute_many(stack))
    after = [getattr(f, a) for f, a in COUNTERS]
    assert [m - b for m, b in zip(mid, before)] == [
        a - m for a, m in zip(after, mid)]
    for p, t in zip(plain, traced):
        assert np.array_equal(p, t)


def test_no_record_function_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert trace.span("stage") is trace.span("layer")
    sess = _session("gcn", "daq", "pallas")
    assert len(sess.execute_many(_stack())) == B
    sess.execute(_stack()[0])
