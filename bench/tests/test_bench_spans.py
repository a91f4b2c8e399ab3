"""The per-layer metrics that read the program's own ``fog.*`` spans, on
hand-built traces: the value from known spans, nothing without them (a
program that records no spans), and the per-graph and per-batch
divisions; then a traced CPU run of the GAT cell that reports them."""
from types import SimpleNamespace

import pytest

import run
import tracing

SPAN_METRICS = ("stage_ms_per_graph", "dispatch_ms_per_graph",
                "unfold_ms_per_graph", "syncs_per_batch")


def _ctx(host, batches=2, batch=4):
    tr = tracing.Trace(device=[(0.0, 10.0, "kernel", "k")], host=host,
                       window_us=10_000.0, start_us=0.0)
    return SimpleNamespace(trace=tr, batches=batches, batch=batch,
                           graphs=batches * batch)


#: two batches: each a fog.execute_many holding a stage (scatter and h2d
#: inside), two supersteps with one exchange each, and an unfold; times
#: in microseconds, with operators and the benchmark's span around them.
HOST = []
for b, t0 in enumerate((0.0, 5_000.0)):
    HOST += [(t0, t0 + 4_000.0, "bench.execute_many"),
             (t0, t0 + 4_000.0, "fog.execute_many"),
             (t0 + 100.0, t0 + 900.0, "fog.stage"),
             (t0 + 100.0, t0 + 600.0, "fog.scatter"),
             (t0 + 600.0, t0 + 900.0, "fog.h2d"),
             (t0 + 650.0, t0 + 850.0, "aten::copy_"),
             (t0 + 1_000.0, t0 + 1_600.0, "fog.layer"),
             (t0 + 1_000.0, t0 + 1_100.0, "fog.exchange"),
             (t0 + 1_600.0, t0 + 2_400.0, "fog.layer"),
             (t0 + 1_600.0, t0 + 1_700.0, "fog.exchange"),
             (t0 + 2_500.0, t0 + 3_900.0, "fog.unfold")]
#: per graph of 2 x 4: stage 2 x 800 us, layers 2 x 1400 us, unfold
#: 2 x 1400 us; 2 exchanges a batch.
WANT = {"stage_ms_per_graph": 1.6 / 8, "dispatch_ms_per_graph": 2.8 / 8,
        "unfold_ms_per_graph": 2.8 / 8, "syncs_per_batch": 2.0}


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_value_from_known_spans(name):
    assert run.reader(name)(_ctx(HOST)) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", SPAN_METRICS)
@pytest.mark.parametrize("host", [
    [], [(0.0, 4_000.0, "bench.execute_many"),
         (10.0, 50.0, "aten::copy_")]], ids=["empty", "no-program-spans"])
def test_nothing_without_spans(name, host):
    assert run.reader(name)(_ctx(host)) is None
    assert run.reader(name)(SimpleNamespace(trace=None, batches=1,
                                            graphs=1)) is None


@pytest.mark.parametrize("batches,batch", [(1, 8), (2, 4), (4, 2)])
def test_divisions(batches, batch):
    """The same spans over the same graphs: per-graph readings follow the
    graphs traced, the syncs the batches."""
    ctx = _ctx(HOST, batches, batch)
    assert run.reader("stage_ms_per_graph")(ctx) == pytest.approx(1.6 / 8)
    assert run.reader("syncs_per_batch")(ctx) == pytest.approx(4 / batches)


def test_overlapping_spans_count_once():
    """Host time is the union of a span's intervals."""
    host = [(0.0, 1_000.0, "fog.stage"), (500.0, 1_500.0, "fog.stage")]
    ctx = _ctx(host, batches=1, batch=1)
    assert run.reader("stage_ms_per_graph")(ctx) == pytest.approx(1.5)


def test_a_traced_cpu_run_reads_the_program_spans():
    c = run.cell("gat-rmat40k.b8")
    c.traffic = dict(c.traffic, batch=2, pool=4, stacks=1, trace_batches=2,
                     check_graphs=2)
    r = run.run_cell(c, 2**31 + 7, 0.0, True, device="cpu", scale=0.01)
    assert r["correct"]
    m = r["metrics"]
    assert set(SPAN_METRICS) <= set(m)
    # GAT runs the examples one after another: K = 2 syncs each
    assert m["syncs_per_batch"]["value"] == 2 * 2
    for name in SPAN_METRICS[:3]:
        assert m[name]["value"] > 0 and m[name]["unit"] == "ms"
