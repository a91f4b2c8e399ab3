"""attention_ms_per_graph (``gnn.layers`` edge softmax): host time in the
program's ``fog.attention`` spans (each GAT layer's scores, logits,
per-head segment max, exponents, denominators and coefficients), per
graph served. Moves ``graphs_per_s``."""
import spans


def read(ctx):
    return spans.ms_per_graph(ctx, "attention")
