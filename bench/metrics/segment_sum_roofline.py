"""segment_sum_roofline (kernels): ``segment_kernel``'s device time in the
trace against the least time of the segment sums a GAT layer needs: the
softmax denominators (one value an edge, E + V edges with self loops)
and the weighted messages (the source table's V rows read once, one
index and one weight an edge), each into V rows. Moves ``graphs_per_s``.
"""
import counts

KERNEL = "segment_kernel"


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.kind != "gat" or not tr.named(KERNEL):
        return None
    v = ctx.vertices
    e = len(ctx.senders) + v
    need = 0.0
    for fo in ctx.dims[1:]:
        denominators = counts.segment_bytes_flops(e, e, v, 1, False, False)
        messages = counts.segment_bytes_flops(e, v, v, fo, True, True)
        need += counts.bound_s(*denominators) + counts.bound_s(*messages)
    need *= ctx.graphs
    busy = sum(t1 - t0 for t0, t1, _, _ in tr.named(KERNEL)) / 1e6
    return 100.0 * need / busy
