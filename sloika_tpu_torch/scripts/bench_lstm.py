"""Time the LSTM forward and backward kernels on the card at the event
training path's shape::

    python -m sloika_tpu_torch.scripts.bench_lstm

The shape (T, B, S) = (500, 100, 64): ``baseline_lstm``'s training batch of
100 chunks of 500 events.  Lengths are ragged (T/2 to T, the first row T
long), the inputs drawn on the card from a seed.  It times the forward's
inference variant (no traces), its training variant (the cell and gate
traces), ``lstm_bwd`` (the backward recurrence, from those traces) and
``lstm_wgrad`` beside the einsums of its twin.  Times are the best of 3
rounds of back-to-back calls by CUDA events.

Another tree's kernels, e.g. a parent commit unpacked with ``git
archive``, are timed by that tree's own copy of this script::

    PYTHONPATH=<tree> python <tree>/sloika_tpu_torch/scripts/bench_lstm.py

It also builds ``csrc/lstm_bwd.cu`` with ``-DLSTM_BWD_CLOCKS`` into a
library of its own and runs it at the same shape: lane 0 of each warp of
block 0 sums the SM clock cycles of each phase of a step (the cell, the
wait for the next ring slot, the barrier, the refill's copies and its
commit, the product, the shuffles).  It reports them a step, each warp's
and their mean, beside both builds' times a step; the cycles of the
clocked loop over its time give the clock they ran at.

Prints one JSON line: the card and its power limit, the tree timed, and
the times.
"""
import ctypes
import json
import os
import subprocess

import numpy as np
import torch

SHAPE = (500, 100, 64)
#: the phases of a step that the clocked build stamps, in order
PHASES = ("cell", "slot_wait", "barrier", "refill_copies", "refill_commit",
          "product", "shuffles")


def inputs(T, B, S, dev, seed=0):
    """xp (T, B, 4S), sWT at 1/sqrt(2S), p at 1/sqrt(S), the cotangent g and
    a ragged (T, B) mask."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    xp = torch.randn((T, B, 4 * S), generator=gen, device=dev)
    sWT = torch.randn((S, 4 * S), generator=gen, device=dev) / np.sqrt(2 * S)
    p = torch.randn((3, S), generator=gen, device=dev) / np.sqrt(S)
    g = torch.randn((T, B, S), generator=gen, device=dev)
    lengths = np.random.RandomState(seed).randint(T // 2, T + 1, size=B)
    lengths[0] = T
    mask = torch.from_numpy(np.arange(T)[:, None] < lengths[None, :]).to(dev)
    return xp, sWT, p, g, mask


def step_clocks(gates, sWT, p, mask, g, c, dxp):
    """Run the clocked build of ``lstm_bwd`` on these inputs (it must give
    ``dxp``, the port's build's bits); returns its time a step, the clock
    it ran at and the cycles a step of each phase."""
    from sloika_tpu_torch import cuda_build
    from sloika_tpu_torch.nn.fused_lstm import LstmBackward
    from sloika_tpu_torch.scripts import cuda_ms
    src = os.path.join(cuda_build.CSRC_DIR, "lstm_bwd.cu")
    path = os.path.join(cuda_build.BUILD_DIR, "liblstm_bwd_clocks.so")
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    built = subprocess.run([cuda_build._nvcc()] + cuda_build.NVCC_FLAGS
                           + ["-DLSTM_BWD_CLOCKS", "-o", path, src],
                           capture_output=True, text=True)
    if built.returncode != 0:
        raise RuntimeError("nvcc failed on the clocked build:\n"
                           + built.stderr)
    lib = ctypes.CDLL(path)
    for fn, argtypes in LstmBackward._ARGTYPES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.lstm_bwd_clocks_read.argtypes = [ctypes.c_void_p]
    lib.lstm_bwd_clocks_read.restype = ctypes.c_int

    class Clocked(LstmBackward):
        def _library(self):
            return lib

    run = lambda: Clocked().recurrence(gates, sWT, p, mask, False, g, c)
    ms = cuda_ms(run, 3, 3)
    if not torch.equal(run(), dxp):
        raise AssertionError("the clocked build gave other bits")
    raw = (ctypes.c_longlong * 256)()
    cuda_build.check(lib.lstm_bwd_clocks_read(raw), "lstm_bwd_clocks_read")
    T = gates.shape[0]
    warps = -(-4 * sWT.shape[0] // 32)
    per_warp = [[raw[w * 8 + k] / T for k in range(8)] for w in range(warps)]
    mean = [sum(w[k] for w in per_warp) / warps for k in range(8)]
    us = 1e3 * ms / T
    # the loop's cycles over the launch's time (which adds the prologue)
    return {"us_per_step": us, "ghz": mean[7] / us / 1e3,
            "cycles_per_step": mean[7],
            "phases_mean": dict(zip(PHASES, mean)),
            "phases_by_warp": [dict(zip(PHASES, w)) for w in per_warp]}


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("bench_lstm needs a CUDA device")
    import sloika_tpu_torch
    from sloika_tpu_torch import config
    from sloika_tpu_torch.nn.fused_lstm import (lstm_backward, lstm_forward,
                                                lstm_wgrad, lstm_wgrad_plain)
    from sloika_tpu_torch.scripts import cuda_ms
    config.disable_tf32()
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    T, B, S = SHAPE
    xp, sWT, p, g, mask = inputs(T, B, S, dev)
    inference = lambda: lstm_forward(xp, sWT, p, mask=mask, emit_cout=False)
    train = lambda: lstm_forward(xp, sWT, p, mask=mask, emit_gates=True)
    h, c, gates = train()
    bwd = lambda: lstm_backward.recurrence(gates, sWT, p, mask, False, g, c)
    dxp = bwd()
    shape = {"T": T, "B": B, "S": S}
    ms = cuda_ms(bwd, 3, 3)
    fwd_ms = cuda_ms(inference, 3, 3)
    result = {
        "card": card,
        "tree": os.path.dirname(os.path.dirname(
            os.path.abspath(sloika_tpu_torch.__file__))),
        "lstm_fwd": dict(shape, ms=fwd_ms, us_per_step=1e3 * fwd_ms / T),
        "lstm_fwd_train": dict(shape, ms=cuda_ms(train, 3, 3)),
        "lstm_bwd": dict(shape, ms=ms, us_per_step=1e3 * ms / T),
        "lstm_wgrad": dict(
            shape, ms=cuda_ms(lambda: lstm_wgrad(h, c, dxp, False), 20, 3),
            einsum_ms=cuda_ms(lambda: lstm_wgrad_plain(h, c, dxp, False),
                              20, 3)),
        "lstm_bwd_clocks": step_clocks(gates, sWT, p, mask, g, c, dxp)}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
