"""Measure the device-memory bandwidth a ring of asynchronous copies
attains on the card: the port's counterpart of ``scripts/bench_dma.py``.

:data:`hbm_ring` replaces that script's Pallas TPU kernel (``run_case``,
kernel :28-52, ``pl.pallas_call`` :54) with ``csrc/hbm_ring.cu``: chunks of
``rows`` time rows of a (T, B, K) float32 array stream through an
``nslots``-deep ring in shared memory, filled by Hopper's bulk asynchronous
copies (``cp.async.bulk`` on an ``mbarrier``), and an elementwise max over
the rows is folded into (B, K) so that nothing is dead.  The bandwidth is
the input's bytes over the kernel's time, beside the data sheet's 3.35 TB/s
that the port's ``bound_ms`` figures assume::

    python -m sloika_tpu_torch.scripts.bench_dma [rows,nslots ...] \\
        [--batch B] [--T T] [--device cuda|cpu]
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
REPS = 8

#: device-memory bandwidth of one H100 SXM (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
CASES = ((1, 2), (1, 8), (8, 4), (32, 3))
MAX_SLOTS = 16


def hbm_ring_plain(x, rows):
    """The plain twin: the max over the first Tr = (T // rows) * rows time
    rows of ``x`` (T, B, K), one ``torch.maximum`` a row from -inf (the
    ring's chunking changes no bit: max is exact)."""
    Tr = x.shape[0] // rows * rows
    acc = torch.full(tuple(x.shape[1:]), -float("inf"), dtype=x.dtype,
                     device=x.device)
    for t in range(Tr):
        acc = torch.maximum(acc, x[t])
    return acc


class HbmRing:
    """The copy-ring max; replaces the Pallas TPU kernel of
    ``scripts/bench_dma.py::run_case`` with ``csrc/hbm_ring.cu``.

    Launches the CUDA kernel for CUDA tensors and runs
    :func:`hbm_ring_plain` for CPU tensors.  ``launches`` counts kernel
    launches; ``plan`` is the last launch's (tile width in floats, tiles,
    blocks)."""

    _ARGTYPES = {"hbm_ring": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2}

    def __init__(self):
        self.launches = 0
        self.plan = None

    def __call__(self, x, rows, nslots):
        """:returns: (B, K) float32"""
        if rows < 1 or not 1 <= nslots <= MAX_SLOTS:
            raise ValueError("rows >= 1 and 1 <= nslots <= {} (got {}, {})"
                             .format(MAX_SLOTS, rows, nslots))
        if x.device.type == "cpu":
            return hbm_ring_plain(x, rows)
        T, B, K = x.shape
        dev = x.device
        cuda_build.check_tensor(x, (T, B, K), torch.float32, dev, "x")
        if (B * K) % 4 or x.data_ptr() % 16:
            raise ValueError("hbm_ring takes B * K a multiple of 4 and a "
                             "16-byte aligned x")
        nchunk = T // rows
        out = torch.empty((B, K), dtype=torch.float32, device=dev)
        if nchunk == 0 or B * K == 0:
            return out.fill_(-float("inf"))
        plan = (ctypes.c_int * 3)()
        lib = cuda_build.load("hbm_ring", self._ARGTYPES)
        with torch.cuda.device(dev):
            err = lib.hbm_ring(x.data_ptr(), out.data_ptr(), nchunk, rows,
                               nslots, B * K, ctypes.addressof(plan),
                               torch.cuda.current_stream().cuda_stream)
        cuda_build.check(err, "hbm_ring")
        self.launches += 1
        self.plan = tuple(plan)
        return out


#: the probe's entry point (kernel on CUDA, plain twin on the CPU)
hbm_ring = HbmRing()


def case_inputs(rows, B, T, K=1024):
    """x (Tr, B, K) float32 as the JAX script draws it (:69-70), uniform on
    [0, 1), Tr = (T // rows) * rows."""
    rs = np.random.RandomState(0)
    return rs.rand(T // rows * rows, B, K).astype(np.float32)


def run_case(rows, nslots, B, T, K=1024, device="cuda", x=None):
    """Run and time one (rows, nslots) case on ``device`` (CUDA events;
    nothing is timed on the CPU).

    :param x: a (T, B, K) float32 tensor on ``device``; default
        :func:`case_inputs`
    :returns: (out (B, K), ms a call or None)
    """
    dev = config.resolve_device(device)
    if x is None:
        x = torch.from_numpy(case_inputs(rows, B, T, K)).to(dev)
    Tr = x.shape[0] // rows * rows
    nbytes = Tr * B * K * 4
    run = lambda: hbm_ring(x, rows, nslots)
    t0 = time.time()
    out = run()
    if dev.type != "cuda":
        print("rows=%-3d slots=%d run on the CPU in %.1f s, not timed"
              % (rows, nslots, time.time() - t0), flush=True)
        return out, None
    torch.cuda.synchronize()
    print("rows=%-3d slots=%d build+run %.1f s"
          % (rows, nslots, time.time() - t0), flush=True)
    ms = cuda_ms(run, REPS, rounds=3)
    W, ntiles, grid = hbm_ring.plan
    rate = nbytes / ms * 1e3               # bytes a second
    print("rows=%-3d slots=%d %8.3f ms -> %6.1f GB/s, %.1f%% of 3.35 TB/s "
          "(chunk %.2f MB; tiles of %d floats, %d tiles on %d blocks, ring "
          "%.1f KB a block)" % (
              rows, nslots, ms, rate / 1e9, 100 * rate / HBM_BYTES_PER_S,
              rows * B * K * 4 / 1e6, W, ntiles, grid,
              nslots * rows * W * 4 / 1e3), flush=True)
    return out, ms


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Measure the bandwidth of a ring of bulk async copies")
    parser.add_argument("cases", nargs="*",
                        help="rows,nslots pairs (default 1,2 1,8 8,4 32,3)")
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--T", type=int, default=3264)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    cases = ([tuple(int(v) for v in c.split(",")) for c in args.cases]
             or CASES)
    dev = config.resolve_device(args.device)
    if dev.type == "cuda":
        print("device: %s" % torch.cuda.get_device_name(dev), flush=True)
    for rows, nslots in cases:
        run_case(rows, nslots, args.batch, args.T, device=dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
