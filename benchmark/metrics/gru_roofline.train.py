"""The training GRU kernels' share of their roofline: the least time of
the forward (training variant, with its gate trace), the backward and the
weight cotangents over every GRU step the traced window ran (the trained
steps and the graph's warm-up group), over the device time of the kernels
named ``gru_fwd_kernel``, ``gru_bwd_kernel``, ``wgrad_tiles`` and
``wgrad_sum``."""
from benchmark.harness import roofline


def read(ctx):
    took = ctx.trace.kernel_seconds("gru_fwd_kernel", "gru_bwd_kernel",
                                    "wgrad_tiles", "wgrad_sum")
    if took <= 0:
        return None
    least = sum(roofline.bound(*b)
                for S, steps in ctx.work["gru_kernel_steps"]
                for b in roofline.gru_train_bounds(steps, S))
    return 100.0 * least / took
