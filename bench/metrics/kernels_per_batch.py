"""kernels_per_batch (dispatch of ``api.session`` / ``api.executors``):
kernel launches in the trace per micro-batch. Moves ``graphs_per_s``."""


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    n = sum(1 for e in tr.device if e[2] == "kernel")
    return n / ctx.batches if n else None
