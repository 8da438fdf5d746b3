"""The Viterbi kernels' share of their roofline: the least time of
viterbi_fwd (the posterior read once, the codes written once; 42 ops a
state a frame) and viterbi_back (a code read, a state and a move written a
frame) over the valid frames the traced window's traffic gives (each
window's or read's own frame count from its samples, never the padded
launch shape), over the device time of the kernels named ``viterbi_fwd``
and ``viterbi_back``."""
from benchmark.harness import roofline


def read(ctx):
    took = ctx.trace.kernel_seconds("viterbi_fwd", "viterbi_back")
    if took <= 0:
        return None
    frames, rows = ctx.work["viterbi_frames"], ctx.work["viterbi_rows"]
    T = frames / rows
    least = (roofline.bound(*roofline.viterbi_fwd_bound(T, rows))
             + roofline.bound(*roofline.viterbi_back_bound(T, rows)))
    return 100.0 * least / took
