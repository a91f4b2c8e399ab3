"""The program's own spans in a trace: the ``fog.*`` host events that
``repro_torch.runtime.trace.span`` records while the profiler runs (none
in a program that records no spans: the readers then give nothing)."""
import tracing

PREFIX = "fog."


def named(trace, name: str):
    """The host events of the span ``fog.<name>`` in ``trace``."""
    if trace is None:
        return []
    return [h for h in trace.host if h[2] == PREFIX + name]


def ms_per_graph(ctx, name: str):
    """Host milliseconds inside ``fog.<name>`` spans per graph traced;
    None without such spans."""
    spans = named(ctx.trace, name)
    if not spans:
        return None
    return tracing.union_us(spans) / 1e3 / ctx.graphs
