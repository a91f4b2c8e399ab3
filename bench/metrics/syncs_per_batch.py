"""syncs_per_batch (``runtime.bsp`` exchange): the program's
``fog.exchange`` spans (one a BSP sync, ``runtime.bsp._exchange``) per
micro-batch traced: a count of work, one a layer on the batched kernel
path, one an example and layer where the examples run one after another.
Moves ``graphs_per_s``."""
import spans


def read(ctx):
    n = len(spans.named(ctx.trace, "exchange"))
    return n / ctx.batches if n else None
