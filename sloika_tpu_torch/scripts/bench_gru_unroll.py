"""Price time-step unrolling and weight precision of the GRU forward on the
card: the port's counterpart of ``scripts/bench_gru_unroll.py``.

:data:`gru_unroll` replaces that script's Pallas TPU kernel (``run_case``,
kernel :26-45, ``pl.pallas_call`` :47), a copy of the production forward
``nn/pallas_gru.py::_kernel`` that takes U time rows a grid step, with
``csrc/gru_unroll.cu``: ``gru_fwd.cu``'s design with U steps a loop body,
the next body's projections fetched into shared memory while the current
one runs, and bf16 weights for ``precision="default"``.  The cases run at
raw_0.98_rgrgr's training shape (T = 400 steps, B = 100, S = 96)::

    python -m sloika_tpu_torch.scripts.bench_gru_unroll [U ...] [--device cuda|cpu]
"""
import argparse
import ctypes
import sys
import time

import numpy as np
import torch

from sloika_tpu_torch import config, cuda_build
from sloika_tpu_torch.scripts import cuda_ms

#: timed calls a round, as in the JAX script; the best of 3 rounds
REPS = 20

PRECISIONS = ("highest", "default")
UNROLLS = (1, 2, 4, 8)


def gru_unroll_plain(xp, sWT, sW2T, precision="highest"):
    """The plain twin: a loop over time of ``torch.mm`` in float32 from
    h = 0, unmasked, forward.  For ``precision="default"`` the operands of
    both products (h, r * h and the weights) are rounded to bf16 first, as
    the TPU's one bf16 pass does; the sums stay float32."""
    T, B, S3 = xp.shape
    S = S3 // 3
    if precision == "default":
        rnd = lambda a: a.bfloat16().float()
    else:
        rnd = lambda a: a
    w1, w2 = rnd(sWT), rnd(sW2T)
    h = xp.new_zeros((B, S))
    out = xp.new_empty((T, B, S))
    for t in range(T):
        lp = xp[t]
        vT = lp[:, :2 * S] + torch.mm(rnd(h), w1)
        z = torch.sigmoid(vT[:, :S])
        r = torch.sigmoid(vT[:, S:])
        hbar = torch.tanh(lp[:, 2 * S:] + torch.mm(rnd(r * h), w2))
        h = z * h + (1 - z) * hbar
        out[t] = h
    return out


class GruUnroll:
    """The GRU forward, U steps a loop body; replaces the Pallas TPU kernel
    of ``scripts/bench_gru_unroll.py::run_case`` with ``csrc/gru_unroll.cu``.

    Launches the CUDA kernel for CUDA tensors and runs
    :func:`gru_unroll_plain` for CPU tensors.  ``launches`` counts kernel
    launches."""

    _ARGTYPES = {"gru_unroll": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                 + [ctypes.c_void_p]}

    def __init__(self):
        self.launches = 0

    def __call__(self, xp, sWT, sW2T, U=1, precision="highest"):
        """:param xp: (T, B, 3S) float32 projections; any T
        :param U: steps a loop body, 1, 2, 4 or 8 (the kernel's only knob:
            the result does not depend on it)
        :returns: (T, B, S) float32
        """
        if precision not in PRECISIONS:
            raise ValueError("precision must be one of {}".format(PRECISIONS))
        if xp.device.type == "cpu":
            return gru_unroll_plain(xp, sWT, sW2T, precision)
        if U not in UNROLLS:
            raise ValueError("U must be one of {}".format(UNROLLS))
        T, B, S3 = xp.shape
        S = S3 // 3
        dev = xp.device
        cuda_build.check_tensor(xp, (T, B, 3 * S), torch.float32, dev, "xp")
        cuda_build.check_tensor(sWT, (S, 2 * S), torch.float32, dev, "sWT")
        cuda_build.check_tensor(sW2T, (S, S), torch.float32, dev, "sW2T")
        if not 0 < S <= 512:
            raise ValueError("GRU size {} outside the kernel's 1..512"
                             .format(S))
        out = torch.empty((T, B, S), dtype=torch.float32, device=dev)
        if T == 0 or B == 0:
            return out
        lib = cuda_build.load("gru_unroll", self._ARGTYPES)
        with torch.cuda.device(dev):
            err = lib.gru_unroll(xp.data_ptr(), sWT.data_ptr(),
                                 sW2T.data_ptr(), out.data_ptr(), T, B, S, U,
                                 int(precision == "default"),
                                 torch.cuda.current_stream().cuda_stream)
        cuda_build.check(err, "gru_unroll")
        self.launches += 1
        return out


#: the probe's entry point (kernel on CUDA, plain twin on the CPU)
gru_unroll = GruUnroll()


def case_inputs(U, B=100, S=96, T=400):
    """(xp (Tp, B, 3S), sWT, sW2T) float32 as the JAX script draws them
    (:64-67), Tp = T rounded up to a multiple of U.  sWT is drawn after xp,
    so the weights differ where Tp does."""
    Tp = -(-T // U) * U
    rs = np.random.RandomState(0)
    xp = rs.normal(size=(Tp, B, 3 * S)).astype(np.float32) * 0.1
    sWT = rs.normal(size=(S, 2 * S)).astype(np.float32) * 0.1
    sW2T = rs.normal(size=(S, S)).astype(np.float32) * 0.1
    return xp, sWT, sW2T


def run_case(U, B=100, S=96, T=400, precision="highest", device="cuda"):
    """Run and time one case on ``device`` (CUDA events; nothing is timed
    on the CPU).

    :returns: (out (Tp, B, S), ms a call or None)
    """
    dev = config.resolve_device(device)
    xp, sWT, sW2T = (torch.from_numpy(a).to(dev)
                     for a in case_inputs(U, B, S, T))
    run = lambda: gru_unroll(xp, sWT, sW2T, U=U, precision=precision)
    t0 = time.time()
    out = run()
    if dev.type != "cuda":
        print("U=%-2d prec=%-8s run on the CPU in %.1f s, not timed"
              % (U, precision, time.time() - t0), flush=True)
        return out, None
    torch.cuda.synchronize()
    print("U=%-2d prec=%s build+run %.1f s"
          % (U, precision, time.time() - t0), flush=True)
    ms = cuda_ms(run, REPS, rounds=3)
    print("U=%-2d prec=%-8s %7.3f ms (%.2f us/step)"
          % (U, precision, ms, ms * 1e3 / T), flush=True)
    return out, ms


def parity(base, out):
    """"EXACT" or the largest difference of ``out``'s first steps from
    ``base``."""
    out = out[:base.shape[0]]
    if torch.equal(base, out):
        return "EXACT"
    return "max|d|=%.3g" % float((base - out).abs().max())


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Time the GRU forward at U steps a loop body")
    parser.add_argument("unroll", nargs="*", type=int,
                        help="U values (default 1 2 4 8)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    dev = config.resolve_device(args.device)
    config.disable_tf32()
    if dev.type == "cuda":
        print("device: %s" % torch.cuda.get_device_name(dev), flush=True)
    base, _ = run_case(1, device=dev)
    for U in args.unroll or UNROLLS:
        if U == 1:
            continue
        out, _ = run_case(U, device=dev)
        print("U=%-2d parity vs U=1: %s" % (U, parity(base, out)),
              flush=True)
    # the bf16 variant: single-pass bf16 products
    run_case(1, precision="default", device=dev)
    run_case(4, precision="default", device=dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
