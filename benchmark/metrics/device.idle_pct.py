"""device.idle_pct: the share of the traced epoch (rank 0's) in which no
kernel, copy or set runs on the card."""


def read(ctx):
    t = ctx.trace
    if t.window_us <= 0 or t.busy_us <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us / t.window_us)
