"""h2d_ms_per_graph (host staging of ``api.executors``): device time of
the host-to-device copies in the trace, per graph served. Moves
``graphs_per_s``."""


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    copies = [e for e in tr.device if e[2] == "gpu_memcpy" and "HtoD" in e[3]]
    if not copies:
        return None
    return sum(e - s for s, e, _, _ in copies) / 1e3 / ctx.graphs
