"""The CRF decode's share of its roofline: the least time of its work over
the valid frames the traced window's traffic gives (each window's own
frame count, never the padded launch shape): the frame's 5N float32
transition scores (1,280 at state_len 4) read once and its label written
once (a byte) at 3.35 TB/s, over the device time of the kernels named
``crf_beta_kernel`` and ``crf_forward_kernel``.  None where no such kernel
ran."""
from benchmark.harness import roofline


def crf_decode_bound(frames, nstate):
    """The decode's (bytes, ops) over ``frames`` valid row-frames: the
    scores read once, the labels written once; its exp and log work is
    not counted."""
    return frames * (4 * 5 * nstate + 1), 0


def read(ctx):
    took = ctx.trace.kernel_seconds("crf_beta_kernel", "crf_forward_kernel")
    if took <= 0:
        return None
    head = ctx.layers[-1]
    nstate = head["nbase"] ** head["state_len"]
    least = roofline.bound(*crf_decode_bound(ctx.work["frames"], nstate))
    return 100.0 * least / took
