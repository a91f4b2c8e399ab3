"""dequant_spmm_roofline (kernels): ``dequant_rows_kernel``'s device time
in the trace against the least time of the 8-bit wire's halo products
(``dequant_spmm(_batched)``): every layer's product over the edges that
cross fogs, reading each crossing row once as uint8 codes plus its f32
(scale, min) pair and writing V rows. Moves ``graphs_per_s``."""
import counts

KERNEL = "dequant_rows_kernel"


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.named(KERNEL):
        return None
    _, cross, rows = counts.fog_edges(ctx.assignment(), ctx.senders,
                                      ctx.receivers)
    need = counts.spmm_layers_s(cross, rows, ctx.vertices, ctx.dims,
                                ctx.batch, code_bytes=1, row_bytes=8)
    busy = sum(e - s for s, e, _, _ in tr.named(KERNEL)) / 1e6
    return 100.0 * need * ctx.batches / busy
