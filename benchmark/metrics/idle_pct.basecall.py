"""The share of the traced window in which nothing ran on the card (no
kernel, no copy): 100 * (1 - busy / window), busy the union of the
device's intervals."""


def read(ctx):
    t = ctx.trace
    if t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
