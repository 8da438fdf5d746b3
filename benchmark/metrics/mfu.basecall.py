"""The whole basecall's share of the card's float32 peak: the network's
forward FLOPs a sample (counted from the configuration's widths) times the
read samples called in the traced window, over the window, over 67
TFLOP/s.  Window overlap and the Viterbi's work are not counted."""
from benchmark.harness import roofline


def read(ctx):
    flop = ctx.flops_per_sample * ctx.work["samples"]
    return 100.0 * flop / ctx.window_s / roofline.F32_FLOP_PER_S
