"""output_head's share of its roofline: the least time of the head's work
over the valid frames the traced window's traffic gives (each window's or
read's own frame count, never the padded launch shape): the projection,
2·I·K FLOPs a frame at 67 TFLOP/s, or the float32 posterior written once
at 3.35 TB/s, whichever is longer; I and K the last layer's widths.  Over
the device time of the kernels named ``output_head_kernel``."""
from benchmark.harness import roofline


def read(ctx):
    took = ctx.trace.kernel_seconds("output_head_kernel")
    if took <= 0:
        return None
    head = ctx.layers[-1]
    least = roofline.bound(*roofline.output_head_bound(
        ctx.work["frames"], head["insize"], head["size"]))
    return 100.0 * least / took
