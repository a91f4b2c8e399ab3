"""block_spmm_roofline (kernels): ``rows_spmm_kernel``'s device time in
the trace against the least time of the block-CSR products it serves
(``block_spmm(_batched)``): every layer's local product over the edges
within a fog (V rows read, V written), and on an f32 wire also the halo
product over the edges that cross fogs (each crossing row read once).
Moves ``graphs_per_s``."""
import counts

KERNEL = "rows_spmm_kernel"


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.named(KERNEL):
        return None
    local, cross, rows = counts.fog_edges(ctx.assignment(), ctx.senders,
                                          ctx.receivers)
    need = counts.spmm_layers_s(local, ctx.vertices, ctx.vertices, ctx.dims,
                                ctx.batch)
    if not ctx.config["engine"]["compressor"].startswith("daq"):
        need += counts.spmm_layers_s(cross, rows, ctx.vertices, ctx.dims,
                                     ctx.batch)
    busy = sum(e - s for s, e, _, _ in tr.named(KERNEL)) / 1e6
    return 100.0 * need * ctx.batches / busy
