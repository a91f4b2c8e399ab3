"""dispatch_ms_per_graph (``runtime.bsp`` supersteps): host time in the
program's ``fog.layer`` spans (one a BSP superstep of
``runtime.bsp._run_layers``: exchange, aggregation, dense tail, merge,
the kernel wrappers included), per graph served: what enqueueing the
forward costs the host. Moves ``graphs_per_s``."""
import spans


def read(ctx):
    return spans.ms_per_graph(ctx, "layer")
