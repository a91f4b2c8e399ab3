"""forward_mfu (the whole forward): operations a graph's forward needs
(the model kind's ``forward_flops``, ``bench/models/<kind>.py``, from the
edges and the widths) times the window's graphs a second, as a share of
the card's float32 peak (the configurations' precision). Moves
``graphs_per_s``."""
import counts


def read(ctx):
    flops = ctx.gnn.forward_flops(ctx.model, ctx.vertices, len(ctx.senders))
    return 100.0 * flops * ctx.graphs_per_s / counts.PEAK_F32_FLOP_PER_S
