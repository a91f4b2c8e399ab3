"""stage_ms_per_graph (host staging of ``api.executors``): host time in
the program's ``fog.stage`` spans (``runtime.bsp._local_stack``: the
numpy scatter into the [n, B, P, F] table, then the host-to-device copy
and the fold), per graph served. Moves ``graphs_per_s``."""
import spans


def read(ctx):
    return spans.ms_per_graph(ctx, "stage")
