"""headed_sum_roofline (kernels): ``headed_sum_kernel``'s device time in
the trace against the least time of the per-head weighted sums a forward
needs: one a layer of more than one head, over the E + V edges with self
loops into V rows of H * D floats (the widths from the kind's file,
``layer_shapes``; a kind whose file has none reads nothing). The least
time reads the source table's V rows once, one source index and H weights
an entry and the V + 1 offsets, and writes the output once, at the HBM
rate; its operations (a product and an add an entry a column) are far
under the float32 rate. Moves ``graphs_per_s``."""
import counts

KERNEL = "headed_sum_kernel"


def bytes_flops(entries: int, rows: int, heads: int, width: int):
    """(bytes, operations) of one per-head sum of ``entries`` terms into
    ``rows`` rows of ``width`` = H * D floats, gathered from a table of
    ``rows`` rows."""
    nbytes = (entries * (4 + 4 * heads) + (rows + 1) * 4
              + 2 * rows * width * 4)
    return nbytes, 2.0 * entries * width


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.named(KERNEL):
        return None
    shapes = getattr(ctx.gnn, "layer_shapes", None)
    if shapes is None:
        return None
    v = ctx.vertices
    e = len(ctx.senders) + v
    need = sum(counts.bound_s(*bytes_flops(e, v, h, h * d))
               for _, h, d in shapes(ctx.model) if h > 1)
    if not need:
        return None
    busy = sum(t1 - t0 for t0, t1, _, _ in tr.named(KERNEL)) / 1e6
    return 100.0 * need * ctx.graphs / busy
