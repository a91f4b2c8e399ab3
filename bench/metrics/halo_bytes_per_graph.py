"""halo_bytes_per_graph (``runtime.bsp``): the bytes the halo exchange
moves in one graph's forward, by the program's own count of a sync
(``ExchangeSpec.bytes_per_sync``) in the session's wire format, one sync a
layer at that layer's input width (``run.halo_bytes_per_forward``). Moves
``graphs_per_s``."""


def read(ctx):
    if not ctx.halo_bytes:
        return None
    return float(ctx.halo_bytes)
