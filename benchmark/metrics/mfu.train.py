"""The whole training step's share of the card's float32 peak: three
times the forward FLOPs a sample (the forward, and the backward's two
products of each), times the samples of the chunks trained in the traced
window, over the window, over 67 TFLOP/s."""
from benchmark.harness import roofline


def read(ctx):
    flop = 3.0 * ctx.flops_per_sample * ctx.work["samples"]
    return 100.0 * flop / ctx.window_s / roofline.F32_FLOP_PER_S
