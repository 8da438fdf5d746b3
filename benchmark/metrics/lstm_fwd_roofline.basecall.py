"""lstm_fwd's share of its roofline: the least time of the recurrence's
work over the valid frames the traced window's traffic gives each LSTM
layer (8 S^2 FLOPs a row-step at 67 TFLOP/s, or xp (4S) read and h (S)
written once at 3.35 TB/s, whichever is longer), over the device time of
the kernels named ``lstm_fwd_kernel``.  None where the traffic runs no
LSTM or no such kernel ran."""
from benchmark.harness import roofline


def lstm_fwd_bound(steps, S):
    """lstm_fwd's (bytes, flop) over ``steps`` valid row-steps: xp read
    and h written a step, the weights (4 S^2) read once; the product with
    sW (S x 4S), 8 S^2 a step."""
    return 4 * (5 * S * steps + 4 * S * S), 8 * S * S * steps


def read(ctx):
    took = ctx.trace.kernel_seconds("lstm_fwd_kernel")
    if took <= 0 or not ctx.work.get("lstm_steps"):
        return None
    least = sum(roofline.bound(*lstm_fwd_bound(steps, S))
                for S, steps in ctx.work["lstm_steps"])
    return 100.0 * least / took
