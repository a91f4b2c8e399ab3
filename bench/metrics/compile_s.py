"""compile_s (``api.engine`` compile): the seconds of set-up spent in
``Engine(...).compile(graph).session()``: the planner (the analytic
profiler, partitioning, placement) and the block-CSR layout. Moves
``setup_s``."""


def read(ctx):
    return float(ctx.setup_parts["compile"])
