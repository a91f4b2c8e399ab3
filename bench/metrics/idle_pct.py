"""idle_pct (device): the share of the traced window in which no kernel,
copy or fill ran on the card, from the union of the device intervals
(``scripts/profile_query.py``'s definition). Moves ``graphs_per_s``."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device or tr.window_us <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_us() / tr.window_us)
