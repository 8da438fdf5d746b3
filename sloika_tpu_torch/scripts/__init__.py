"""Diagnostic probes of the card, the port's counterparts of the JAX
package's ``scripts/bench_gru_unroll.py``, ``scripts/bench_viterbi_parts.py``
and ``scripts/bench_dma.py``.  Each runs its own CUDA kernel, beside a plain
PyTorch twin::

    python -m sloika_tpu_torch.scripts.bench_gru_unroll [U ...] [--device cuda|cpu]
    python -m sloika_tpu_torch.scripts.bench_viterbi_parts [variant ...] \\
        [--batch B] [--T T] [--device cuda|cpu]
    python -m sloika_tpu_torch.scripts.bench_dma [rows,nslots ...] \\
        [--batch B] [--T T] [--device cuda|cpu]

They run on the card unless given ``--device cpu``, where the twins run
and nothing is timed.
"""
import ctypes

import torch

#: the published peaks of one H100 SXM (NVIDIA data sheet) the bounds use
HBM_BYTES_PER_S, F32_FLOP_PER_S = 3.35e12, 67e12


def bound_ms(nbytes, nflop):
    """The least ms the card could take to move ``nbytes`` and do ``nflop``
    float32 operations."""
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, nflop / F32_FLOP_PER_S)


def cuda_ms(fn, reps, rounds=1):
    """The least over ``rounds`` of the mean milliseconds of ``fn()`` over
    ``reps`` back-to-back runs, by CUDA events, after one warm-up run (the
    probes take the best of 3 rounds, as the JAX scripts do)."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(stop) / reps)
    return best


def clocked_library(name, flag, functions, read):
    """Build ``csrc/<name>.cu`` with ``-D<flag>``, which compiles its clock
    stamps in, into a library of its own (``_build/lib<name>_clocks.so``,
    rebuilt when stale as the port's are; the port's kernels are built
    without it) and load it, once a process.

    :param functions: {function name: argtypes} of its entry points
    :param read: the entry point that copies the stamps to host memory
    """
    from sloika_tpu_torch import cuda_build
    key = "{}_clocks".format(name)
    if key in cuda_build._LIBS:
        return cuda_build._LIBS[key]
    lib = ctypes.CDLL(cuda_build.build_all([(name, flag)])[0])
    for fn, argtypes in list(functions.items()) + [(read, [ctypes.c_void_p])]:
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    cuda_build._LIBS[key] = lib
    return lib


def read_clocks(lib, read, warps, slots=8):
    """The stamps of a clocked library's last launch: ``slots`` sums of
    cycles for each of ``warps`` warps (block 0's 32, then, where a
    library stamps two blocks, the second block's)."""
    from sloika_tpu_torch import cuda_build
    torch.cuda.synchronize()
    raw = (ctypes.c_longlong * (64 * slots))()    # two blocks' warps at most
    cuda_build.check(getattr(lib, read)(raw), read)
    return [[raw[w * slots + k] for k in range(slots)] for w in range(warps)]


def split_clocks(raw, steps, ms, phases):
    """Cycles a step of each phase, by warp and their mean (over the warps
    that stamped), from a clocked build's stamps (slot 7: the whole loop),
    and the clock they ran at."""
    per_warp = [[w[k] / steps for k in range(8)] for w in raw if w[7] > 0]
    mean = [sum(w[k] for w in per_warp) / len(per_warp) for k in range(8)]
    us = 1e3 * ms / steps
    return {"ms": ms, "us_per_step": us, "ghz": mean[7] / us / 1e3,
            "cycles_per_step": mean[7],
            "phases_mean": dict(zip(phases, mean)),
            "phases_by_warp": [dict(zip(phases + ("loop",),
                                        w[:len(phases)] + [w[7]]))
                               for w in per_warp]}
