"""Time the banded remap kernels on the card at the remap paths' shapes::

    python -m sloika_tpu_torch.scripts.bench_remap [--clocks] [--shapes main,rerun]

Shapes (T frames, B rows, P positions, W window): "main", the remap main
path's DP batch in ``chip_smoke.py`` (64 reads bucketed to 35,429 frames,
references to 14,763 positions, band 768); "rerun", its re-run batch (the
four reads whose references the band cannot reach, bucketed to 10,497
frames and 9,842 positions, at W = 3,072).  The posterior is
``log_softmax(2 x N(0, 1))`` over 1,025 states, drawn on the card from a
seed, and the rows' frame and position counts are ragged, as in
``chip_smoke.py`` phase 8.  It times ``remap_banded`` and ``remap_back``
(the best of 2 rounds of 3 back-to-back calls by CUDA events), beside the
least time the card could take for each one's work (:func:`bounds`).

Another tree's kernels, e.g. a parent commit unpacked with ``git
archive``, are timed by that tree's own copy of this script::

    PYTHONPATH=<tree> python <tree>/sloika_tpu_torch/scripts/bench_remap.py

With ``--clocks`` it builds ``csrc/remap_banded.cu`` with
``-DREMAP_BANDED_CLOCKS`` and ``csrc/remap_back.cu`` with
``-DREMAP_BACK_CLOCKS``, each into a library of its own, and runs them on
the same inputs: lane 0 of each warp of block 0 sums the SM clock cycles
of each phase of a step (BANDED_PHASES; BACK_PHASES, whose walker and
copier warps are reported apart, and the cycles of one read of a chase
through shared memory, ``smem_chase_cycles``).  It reports them a step,
each warp's
and the mean over the warps, beside both builds' times; the cycles
of the clocked loop over its time give the clock they ran at.  A clocked
build must give the port's bits.

Prints one JSON line: the card and its power limit, the tree timed, and
the times.
"""
import argparse
import json
import os
import subprocess

import numpy as np
import torch

#: name -> (T, B, P, W)
SHAPES = {"main": (35429, 64, 14763, 768), "rerun": (10497, 4, 9842, 3072)}
NSTATE = 1025
SLIP = 5.0
#: the phases of a step that each clocked build stamps, in order
BANDED_PHASES = ("stores_head", "gather_issue", "scans_publish", "barrier",
                 "fold", "update", "slot_wait")
#: remap_back's warps: the walker (0) and the copier (1)
BACK_PHASES = ("slot_wait", "walk", "release", "copy_issue")


def remap_inputs(dev, lt, P, W, seed):
    """Sequences, masks, both priors and the block-quantised band schedule
    of a batch of rows with ragged frame and position counts (the first row
    the longest in both), for the time-major log-posterior ``lt`` (T, B,
    1025): (seq, mask, prior0, prior1, starts)."""
    from sloika_tpu_torch.ops import remap_kernel as rk
    rs = np.random.RandomState(seed)
    T, B = lt.shape[:2]
    nframes = rs.randint(T * 3 // 4, T + 1, size=B)
    npos = rs.randint(P // 2, P + 1, size=B)
    nframes[0], npos[0] = T, P
    seq = rs.randint(1, NSTATE, size=(B, P)).astype(np.int32)
    mask = np.arange(P)[None, :] < npos[:, None]
    prior = np.log(rs.uniform(0.05, 1.0, size=(2, B, P))).astype(np.float32)
    TB = rk.block_len(W)
    Tp = -(-T // TB) * TB
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    starts = rk.band_starts_blocked(t(nframes), t(npos.astype(np.int32)), Tp,
                                    W, TB)
    return t(seq), t(mask), t(prior[0]), t(prior[1]), starts


def posterior(T, B, dev, seed):
    """(T, B, 1025) log-posterior drawn on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.log_softmax(
        2.0 * torch.randn((T, B, NSTATE), generator=gen, device=dev),
        dim=2).contiguous()


def banded_clocks(args, ref):
    """Run the clocked build of ``remap_banded`` on ``args`` (it must give
    ``ref``, the port's build's (traceback, vfinal)); returns its time, the
    clock it ran at and the cycles a step of each phase."""
    from sloika_tpu_torch.ops.remap_kernel import (RemapBanded,
                                                   remap_banded_plan)
    from sloika_tpu_torch.scripts import (clocked_library, cuda_ms,
                                         read_clocks, split_clocks)
    lib = clocked_library("remap_banded", "REMAP_BANDED_CLOCKS",
                          RemapBanded._ARGTYPES, "remap_banded_clocks_read")

    class Clocked(RemapBanded):
        def _library(self):
            return lib

    run = lambda: Clocked()(*args)
    ms = cuda_ms(run, 3, 2)
    got = run()
    if not all(map(torch.equal, got, ref)):
        raise AssertionError("the clocked build of remap_banded gave other "
                             "bits")
    plan = remap_banded_plan(args[6], args[0].shape[2])
    raw = read_clocks(lib, "remap_banded_clocks_read", 32)
    split = split_clocks(raw[:plan["warps"]], args[4].shape[0] - 1, ms,
                   BANDED_PHASES)
    if plan["producer"]:
        # the producer warp: its barriers with the refill, and its window
        # moves' barriers
        w = raw[plan["warps"]]
        steps = args[4].shape[0] - 1
        split["producer"] = {"barrier_refill": w[3] / steps,
                             "move_barriers": w[5] / steps,
                             "loop": w[7] / steps}
    return split


def back_clocks(args, ref):
    """The same for ``remap_back`` (it must give ``ref``, the path)."""
    from sloika_tpu_torch.ops.remap_kernel import RemapBacktrack
    from sloika_tpu_torch.scripts import (clocked_library, cuda_ms,
                                         read_clocks, split_clocks)
    lib = clocked_library("remap_back", "REMAP_BACK_CLOCKS",
                          RemapBacktrack._ARGTYPES, "remap_back_clocks_read")

    class Clocked(RemapBacktrack):
        def _library(self):
            return lib

    run = lambda: Clocked()(*args)
    ms = cuda_ms(run, 3, 2)
    if not torch.equal(run(), ref):
        raise AssertionError("the clocked build of remap_back gave other "
                             "bits")
    raw = read_clocks(lib, "remap_back_clocks_read", 2)
    split = split_clocks(raw, args[0].shape[0] - 1, ms, BACK_PHASES)
    split["walker"], split["copier"] = split.pop("phases_by_warp")
    del split["phases_mean"]
    split["cycles_per_step"] = split["walker"]["loop"]
    # thread 0's chase of 64 dependent shared-memory reads
    split["smem_chase_cycles"] = raw[0][6] / 64
    return split


def bounds(T, Tp, B, P, W):
    """The least ms of each kernel's work at a shape, as ``chip_smoke.py``
    phase 8 counts it: ``remap_banded`` the posterior (T frames of NSTATE
    floats), sequences, masks, priors and schedule read once, the int16
    traceback and final scores written once (~13 f32 operations a window
    lane a step: the bytes bound it); ``remap_back`` a delta and a window
    start read and a position written a step (a chain of Tp dependent
    loads sets its time, not these bytes)."""
    from sloika_tpu_torch.scripts import bound_ms
    return (bound_ms(T * B * NSTATE * 4 + B * P * 9 + Tp * B * 4
                     + Tp * B * W * 2 + B * W * 4, 13 * Tp * B * W),
            bound_ms(Tp * B * (2 + 4 + 4) + B * 4, 3 * Tp * B))


def bench_shape(name, dev, clocks):
    """Time both kernels at one of SHAPES (and split their steps)."""
    from sloika_tpu_torch.ops import remap_kernel as rk
    from sloika_tpu_torch.scripts import cuda_ms
    T, B, P, W = SHAPES[name]
    lt = posterior(T, B, dev, seed=T + W)
    seq, mask, p0, p1, starts = remap_inputs(dev, lt, P, W, seed=W + T)
    args = (lt, seq, mask, p0, starts, SLIP, W)
    tb, vfinal = rk.remap_banded(*args)
    _, path = rk.finish_banded(tb, vfinal, starts, p1, rk.remap_backtrack)
    back_args = (tb, starts, path[-1])
    Tp = starts.shape[0]
    ms = cuda_ms(lambda: rk.remap_banded(*args), 3, 2)
    back_ms = cuda_ms(lambda: rk.remap_backtrack(*back_args), 3, 2)
    out = {"T": T, "Tp": Tp, "B": B, "P": P, "W": W,
           "remap_banded": {"ms": ms, "us_per_step": 1e3 * ms / Tp},
           "remap_back": {"ms": back_ms, "us_per_step": 1e3 * back_ms / Tp}}
    out["remap_banded"]["plan"] = rk.remap_banded_plan(W, NSTATE)
    out["remap_back"]["plan"] = rk.remap_back_plan(W)
    out["remap_banded"]["bound_ms"], out["remap_back"]["bound_ms"] = bounds(
        T, Tp, B, P, W)
    if clocks:
        out["remap_banded_clocks"] = banded_clocks(args, (tb, vfinal))
        out["remap_back_clocks"] = back_clocks(back_args, path)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Time the banded remap kernels at the remap shapes")
    parser.add_argument("--clocks", action="store_true",
                        help="also split a step of each kernel by its "
                        "clocked build")
    parser.add_argument("--shapes", default="main,rerun",
                        help="comma-separated names of SHAPES")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_remap needs a CUDA device")
    import sloika_tpu_torch
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    result = {"card": card,
              "tree": os.path.dirname(os.path.dirname(
                  os.path.abspath(sloika_tpu_torch.__file__)))}
    for name in args.shapes.split(","):
        result[name] = bench_shape(name, dev, args.clocks)
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
