"""gru_fwd's share of its roofline: the least time of the valid steps the
traced window's traffic gives each GRU layer (6 S^2 a step at 67 TFLOP/s,
or xp read and h written once at 3.35 TB/s, whichever is longer), over the
device time of the kernels named ``gru_fwd_kernel``."""
from benchmark.harness import roofline


def read(ctx):
    took = ctx.trace.kernel_seconds("gru_fwd_kernel")
    if took <= 0:
        return None
    least = sum(roofline.bound(*roofline.gru_fwd_bound(steps, S))
                for S, steps in ctx.work["gru_steps"])
    return 100.0 * least / took
