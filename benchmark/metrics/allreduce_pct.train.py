"""The share of rank 0's traced window covered by the collectives: the
union of the intervals of the device's kernels whose names hold ``nccl``
(any case), within the window.  It holds the gradient all-reduce and any
wait in it for the slowest rank.  None where no such kernel ran (one rank,
or a group over gloo)."""


def read(ctx):
    t = ctx.trace
    if not t.window or t.window_s <= 0:
        return None
    lo, hi = t.window
    spans = sorted((max(s, lo), min(e, hi)) for n, s, e in t.device
                   if "nccl" in n.lower() and e > lo and s < hi)
    if not spans:
        return None
    covered, end = 0.0, lo
    for s, e in spans:
        if e > end:
            covered += e - max(s, end)
            end = e
    return 100.0 * covered / 1e6 / t.window_s
