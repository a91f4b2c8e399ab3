"""unfold_ms_per_graph (``runtime.bsp`` result): host time in the
program's ``fog.unfold`` spans (``runtime.bsp._unfold``: the unpermute,
the device-to-host copy, and the host's wait for the queued forward), per
graph served. Moves ``graphs_per_s``."""
import spans


def read(ctx):
    return spans.ms_per_graph(ctx, "unfold")
