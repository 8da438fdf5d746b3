"""Measure the device-memory bandwidth a ring of asynchronous copies
attains on the card: the port's counterpart of ``scripts/bench_dma.py``.

:data:`hbm_ring` replaces that script's Pallas TPU kernel (``run_case``,
kernel :28-52, ``pl.pallas_call`` :54) with ``csrc/hbm_ring.cu``: chunks of
``rows`` time rows of a (T, B, K) float32 array stream through an
``nslots``-deep ring in shared memory, filled by a producer warp with
Hopper's bulk asynchronous copies (``cp.async.bulk`` on a full
``mbarrier`` a slot) and released by consumer warps on an empty one, and an
elementwise max over the rows is folded into (B, K) so that nothing is
dead.  :func:`hbm_ring_plan` sets the tiles and the grid.  The bandwidth is
the input's bytes over the kernel's time, beside the data sheet's 3.35 TB/s
that the port's ``bound_ms`` figures assume::

    python -m sloika_tpu_torch.scripts.bench_dma [rows,nslots ...] \\
        [--batch B] [--T T] [--device cuda|cpu] [--clocks]

With ``--clocks`` (on the card) it also builds ``csrc/hbm_ring.cu`` with
``-DHBM_RING_CLOCKS`` into a library of its own and runs each case on the
same input through it: lane 0 of each warp of block 0 sums the SM clock
cycles of each phase of a chunk (RING_PHASES), reported a chunk beside
the loop's cycles a chunk.  The clocked build must give the port's bits.
On the card it also times ``torch.amax`` over the same input, the one
PyTorch call that computes the same function.
"""
import argparse
import ctypes
import functools
import json
import sys
import time

import numpy as np
import torch

from sloika_tpu_torch import config, cuda_build
from sloika_tpu_torch.nn.fused_gru import H100_SMS, SMEM_OPTIN, _round
from sloika_tpu_torch.scripts import cuda_ms

#: timed calls a round, as in the JAX script; the best of 3 rounds
REPS = 8

#: device-memory bandwidth of one H100 SXM (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
CASES = ((1, 2), (1, 8), (8, 4), (32, 3))
MAX_SLOTS = 16
#: the phases of a chunk that the clocked build stamps (slots 0-4 of each
#: warp's eight; slot 6 holds the block's chunks, 7 the loop's cycles).  The
#: consumer warps wait on the full barrier, fold, release the slot and store
#: a finished tile; the producer warp (the last) waits on the empty barrier
#: and issues the refill
RING_PHASES = ("slot_wait", "fold", "release", "refill_issue", "tile_store")
#: shared memory an SM holds (bytes), and what the runtime reserves a block
SM_SMEM, BLOCK_RESERVED = 233472, 1024
#: the ring's mbarriers (full and empty, 16 each) ahead of its slots
RING_BAR_BYTES = 256
#: a consumer warp folds one float4 a lane of each row: 128 floats, and a
#: block has at most 8 consumer warps
WARP_FLOATS, MAX_CONSUMERS = 128, 8


def hbm_ring_plan(N, rows, nslots, sms=H100_SMS, optin=SMEM_OPTIN):
    """The launch plan of ``hbm_ring.cu`` over N columns.

    Tile width ``W``: the widest multiple of 128 floats (of 4 below 128) up
    to 1,024 whose ring of ``nslots * rows * W`` floats fits ``optin`` bytes
    beside the barriers, narrowed to the columns an SM would get.  One
    consumer warp for each 128 floats, so that every consumer thread folds
    one float4 a row of a whole tile.  Blocks: as many as the SMs hold at
    once (``blocks_per_sm`` of them fit an SM by shared memory and
    threads), but no more than there are tiles, so that the tiles of an SM
    stream at once; then as few as keep the most tiles a block the same.

    :returns: dict of W, tiles, tiles_per_block, grid, consumers, threads,
        blocks_per_sm, smem (bytes)
    """
    if N < 4 or N % 4 or rows < 1 or not 1 <= nslots <= MAX_SLOTS:
        raise ValueError("hbm_ring takes N a multiple of 4, rows >= 1 and "
                         "1 <= nslots <= {} (got {}, {}, {})".format(
                             MAX_SLOTS, N, rows, nslots))
    wfit = (optin - RING_BAR_BYTES) // (4 * nslots * rows)
    wmax = min(wfit, WARP_FLOATS * MAX_CONSUMERS)
    step = WARP_FLOATS if wmax >= WARP_FLOATS else 4
    wmax = wmax // step * step
    if wmax < 4:
        raise ValueError("a ring of {} x {} rows does not fit {} bytes"
                         .format(nslots, rows, optin))
    W = min(_round(-(-N // sms), step), wmax)
    tiles = -(-N // W)
    consumers = -(-W // WARP_FLOATS)
    threads = 32 * (consumers + 1)
    smem = RING_BAR_BYTES + 4 * nslots * rows * W
    per_sm = min(SM_SMEM // (smem + BLOCK_RESERVED), 2048 // threads, 32)
    k = -(-tiles // min(tiles, sms * per_sm))
    grid = -(-tiles // k)
    return {"W": W, "tiles": tiles, "tiles_per_block": k, "grid": grid,
            "consumers": consumers, "threads": threads,
            "blocks_per_sm": -(-grid // sms), "smem": smem}


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
    launches; ``plan`` is the last launch's :func:`hbm_ring_plan`."""

    _ARGTYPES = {"hbm_ring": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
                 + [ctypes.c_int] * 3 + [ctypes.c_void_p]}

    def __init__(self):
        self.launches = 0
        self.plan = None

    def _library(self):
        """The loaded ``hbm_ring`` library (``--clocks`` swaps in its
        clocked build)."""
        return cuda_build.load("hbm_ring", self._ARGTYPES)

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
        props = torch.cuda.get_device_properties(dev)
        plan = hbm_ring_plan(B * K, rows, nslots,
                             props.multi_processor_count,
                             getattr(props, "shared_memory_per_block_optin",
                                     SMEM_OPTIN))
        lib = self._library()
        with torch.cuda.device(dev):
            err = lib.hbm_ring(x.data_ptr(), out.data_ptr(), nchunk, rows,
                               nslots, B * K, plan["W"], plan["tiles"],
                               plan["grid"], plan["consumers"], plan["smem"],
                               torch.cuda.current_stream().cuda_stream)
        cuda_build.check(err, "hbm_ring")
        self.launches += 1
        self.plan = plan
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
    plan = hbm_ring.plan
    rate = nbytes / ms * 1e3               # bytes a second
    print("rows=%-3d slots=%d %8.3f ms -> %6.1f GB/s, %.1f%% of 3.35 TB/s "
          "(chunk %.2f MB; tiles of %d floats, %d tiles on %d blocks of %d "
          "consumer warps, %d a block an SM; ring %.1f KB a block)" % (
              rows, nslots, ms, rate / 1e9, 100 * rate / HBM_BYTES_PER_S,
              rows * B * K * 4 / 1e6, plan["W"], plan["tiles"], plan["grid"],
              plan["consumers"], plan["blocks_per_sm"],
              nslots * rows * plan["W"] * 4 / 1e3), flush=True)
    return out, ms


@functools.lru_cache(maxsize=None)
def _clocked_library():
    from sloika_tpu_torch.scripts import clocked_library
    return clocked_library("hbm_ring", "HBM_RING_CLOCKS", HbmRing._ARGTYPES,
                           "hbm_ring_clocks_read")


def chunk_clocks(x, rows, nslots, out):
    """Run one case through the clocked build of ``hbm_ring`` (it must give
    ``out``); returns its ms, the loop's cycles a chunk and each phase's
    cycles a chunk, by warp, the consumers' mean and the producer's."""
    from sloika_tpu_torch.scripts import read_clocks
    lib = _clocked_library()

    class Clocked(HbmRing):
        def _library(self):
            return lib

    ring = Clocked()
    run = lambda: ring(x, rows, nslots)
    ms = cuda_ms(run, REPS, rounds=3)
    if not torch.equal(run(), out):
        raise AssertionError("the clocked build of hbm_ring gave other bits")
    raw = read_clocks(lib, "hbm_ring_clocks_read", ring.plan["consumers"] + 1)
    names = RING_PHASES + ("loop",)
    by_warp = [dict(zip(names, [w[k] / max(w[6], 1) for k in range(5)]
                        + [w[7] / max(w[6], 1)])) for w in raw]
    consumers = by_warp[:-1]
    mean = {n: sum(w[n] for w in consumers) / len(consumers) for n in names}
    return {"ms": ms, "chunks_block0": raw[0][6],
            "cycles_per_chunk": mean["loop"], "consumers_mean": mean,
            "producer": by_warp[-1], "phases_by_warp": by_warp}


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Measure the bandwidth of a ring of bulk async copies")
    parser.add_argument("cases", nargs="*",
                        help="rows,nslots pairs (default 1,2 1,8 8,4 32,3)")
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--T", type=int, default=3264)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--clocks", action="store_true",
                        help="also split a chunk by the clocked build")
    args = parser.parse_args(argv)
    cases = ([tuple(int(v) for v in c.split(",")) for c in args.cases]
             or CASES)
    dev = config.resolve_device(args.device)
    if dev.type == "cuda":
        print("device: %s" % torch.cuda.get_device_name(dev), flush=True)
    x = None
    if dev.type == "cuda":
        # one input for every case, drawn on the card
        x = torch.rand((args.T, args.batch, 1024), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(0))
    for rows, nslots in cases:
        out, ms = run_case(rows, nslots, args.batch, args.T, device=dev, x=x)
        if args.clocks and dev.type == "cuda":
            print("rows=%-3d slots=%d clocks: %s" % (
                rows, nslots, json.dumps(chunk_clocks(x, rows, nslots, out))),
                flush=True)
    if dev.type == "cuda":
        # the PyTorch call that computes the same function over all T rows
        ms = cuda_ms(lambda: torch.amax(x, dim=0), REPS, rounds=3)
        print("torch.amax %8.3f ms -> %6.1f GB/s" % (
            ms, x.numel() * 4 / ms / 1e6), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
