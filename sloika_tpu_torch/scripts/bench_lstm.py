"""Time the LSTM forward and backward kernels on the card at the event
training path's shape::

    python -m sloika_tpu_torch.scripts.bench_lstm [--clocks]

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

It also times the forward's inference variant at the event basecall
path's shape, (T, B) = (9,000, 64), and splits a call of ``lstm_wgrad``
by its launches (``torch.profiler``: device ms of each kernel a call);
``lstm_wgrad`` is also timed at S = WGRAD_NARROW_S on random rows.
With ``--wgrad``
it times ``lstm_wgrad`` alone (the other kernels run once, untimed, to
make its inputs).  This script uses only the kernels' Python entry points,
so it also times another tree's kernels when that tree comes first on the
path::

    PYTHONPATH=<tree> python sloika_tpu_torch/scripts/bench_lstm.py --wgrad

With ``--clocks`` it builds ``csrc/lstm_fwd.cu`` with ``-DLSTM_FWD_CLOCKS``
and ``csrc/lstm_bwd.cu`` with ``-DLSTM_BWD_CLOCKS``, each into a library
of its own, and runs them at the training shape (the forward in both
variants): lane 0 of each warp of block 0 sums the SM clock cycles of
each phase of a step (FWD_PHASES, BWD_PHASES).  It reports them a step,
each warp's and their mean, beside both builds' times a step; the cycles
of the clocked loop over its time give the clock they ran at.  It also
builds ``csrc/lstm_wgrad.cu`` with ``-DLSTM_WGRAD_CLOCKS`` and splits a
slice of its block 0 (WGRAD_PHASES).  A clocked build must give the port's
bits.

Prints one JSON line: the card and its power limit, the tree timed, and
the times.
"""
import argparse
import json
import os
import subprocess

import numpy as np
import torch

SHAPE = (500, 100, 64)
#: the event basecall path's batch: 64 reads of up to 9,000 events
SERVING = (9000, 64)
#: the phases of a step that each clocked build stamps, in order
FWD_PHASES = ("product", "slot_wait", "activation", "shuffles_cell",
              "barrier", "refill_stores")
BWD_PHASES = ("cell", "slot_wait", "barrier", "refill_copies",
              "refill_commit", "product", "shuffles")
WGRAD_PHASES = ("slice_wait_barrier", "refill_issue", "fmas")
#: a width that is not a multiple of 4 (rows of h and c that are not
#: 16-byte units), at which ``lstm_wgrad`` is also timed
WGRAD_NARROW_S = 65


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


def _split(raw, T, ms, phases):
    """Cycles a step of each phase, by warp and their mean, from the
    stamps (slot 7: the whole loop), and the clock they ran at."""
    per_warp = [[w[k] / T for k in range(8)] for w in raw]
    mean = [sum(w[k] for w in per_warp) / len(per_warp) for k in range(8)]
    us = 1e3 * ms / T
    # the loop's cycles over the launch's time (which adds the prologue)
    return {"us_per_step": us, "ghz": mean[7] / us / 1e3,
            "cycles_per_step": mean[7],
            "phases_mean": dict(zip(phases, mean)),
            "phases_by_warp": [dict(zip(phases, w)) for w in per_warp]}


def fwd_step_clocks(xp, sWT, p, mask, ref, train=False):
    """Run the clocked build of ``lstm_fwd``'s inference variant (with
    ``train``, the training variant) on these inputs (it must give ``ref``,
    the port's build's h, or its (h, c, gates)); returns its time a step,
    the clock it ran at and the cycles a step of each phase."""
    from sloika_tpu_torch.nn.fused_lstm import LstmForward
    from sloika_tpu_torch.scripts import clocked_library, cuda_ms, read_clocks
    lib = clocked_library("lstm_fwd", "LSTM_FWD_CLOCKS",
                          LstmForward._ARGTYPES, "lstm_fwd_clocks_read")

    class Clocked(LstmForward):
        def _library(self):
            return lib

    if train:
        run = lambda: Clocked()(xp, sWT, p, mask=mask, emit_gates=True)
    else:
        run = lambda: Clocked()(xp, sWT, p, mask=mask, emit_cout=False)[0]
    ms = cuda_ms(run, 3, 3)
    got = run()
    if not (all(map(torch.equal, got, ref)) if train
            else torch.equal(got, ref)):
        raise AssertionError("the clocked build of lstm_fwd gave other bits")
    warps = -(-4 * sWT.shape[0] // 32)
    raw = read_clocks(lib, "lstm_fwd_clocks_read", warps)
    return _split(raw, xp.shape[0], ms, FWD_PHASES)


def bwd_step_clocks(gates, sWT, p, mask, g, c, dxp):
    """The same for ``lstm_bwd`` (it must give ``dxp``)."""
    from sloika_tpu_torch.nn.fused_lstm import LstmBackward
    from sloika_tpu_torch.scripts import clocked_library, cuda_ms, read_clocks
    lib = clocked_library("lstm_bwd", "LSTM_BWD_CLOCKS",
                          LstmBackward._ARGTYPES, "lstm_bwd_clocks_read")

    class Clocked(LstmBackward):
        def _library(self):
            return lib

    run = lambda: Clocked().recurrence(gates, sWT, p, mask, False, g, c)
    ms = cuda_ms(run, 3, 3)
    if not torch.equal(run(), dxp):
        raise AssertionError("the clocked build of lstm_bwd gave other bits")
    warps = -(-4 * sWT.shape[0] // 32)
    raw = read_clocks(lib, "lstm_bwd_clocks_read", warps)
    return _split(raw, gates.shape[0], ms, BWD_PHASES)


def wgrad_clocks(h, c, dxp, ref):
    """Run the clocked build of ``lstm_wgrad`` (it must give ``ref``, the
    port's build's (dsWT, dp)); returns its time, its cycles a slice and
    the cycles a slice of each phase, by warp of block 0 and their mean."""
    from sloika_tpu_torch.nn.fused_lstm import LstmWgrad, lstm_wgrad_plan
    from sloika_tpu_torch.scripts import (clocked_library, cuda_ms,
                                          read_clocks, split_clocks)
    lib = clocked_library("lstm_wgrad", "LSTM_WGRAD_CLOCKS",
                          LstmWgrad._ARGTYPES, "lstm_wgrad_clocks_read")

    class Clocked(LstmWgrad):
        def _library(self):
            return lib

    run = lambda: Clocked()(h, c, dxp, False)
    ms = cuda_ms(run, 3, 3)
    if not all(map(torch.equal, run(), ref)):
        raise AssertionError("the clocked build of lstm_wgrad gave other "
                             "bits")
    T, B, S = h.shape
    plan = lstm_wgrad_plan(T, B, S)
    warps = plan["threads"] // 32
    slices = -(-min(plan["rows_per_split"], T * B) // plan["kb"])
    split = split_clocks(read_clocks(lib, "lstm_wgrad_clocks_read", warps),
                         slices, ms, WGRAD_PHASES)
    split["cycles_per_slice"] = split.pop("cycles_per_step")
    split.pop("us_per_step")
    split["slices"], split["slice_rows"] = slices, plan["kb"]
    return split


def wgrad_bound(rows, S):
    """``lstm_wgrad``'s bytes and operations over ``rows`` valid rows: h,
    c and dxp read once, dsWT and dp written; 8 S^2 flop a row (the
    peephole sums add 6 S)."""
    return 4 * (6 * S * rows + 4 * S * S + 3 * S), 8 * S * S * rows


def wgrad_launches(h, c, dxp, reps=10):
    """Device ms a call of each kernel that ``lstm_wgrad`` launches, by
    ``torch.profiler`` over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile
    from sloika_tpu_torch.nn.fused_lstm import lstm_wgrad
    lstm_wgrad(h, c, dxp, False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            lstm_wgrad(h, c, dxp, False)
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us > 0 and ev.count >= reps:
            out[ev.key] = {"ms_a_call": us / 1e3 / reps,
                           "launches_a_call": ev.count / reps}
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Time the LSTM kernels at the event paths' shapes")
    parser.add_argument("--clocks", action="store_true",
                        help="also split a step of lstm_fwd and lstm_bwd "
                        "and a slice of lstm_wgrad by the clocked builds")
    parser.add_argument("--wgrad", action="store_true",
                        help="time lstm_wgrad alone")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_lstm needs a CUDA device")
    import sloika_tpu_torch
    from sloika_tpu_torch import config
    from sloika_tpu_torch.nn import fused_lstm
    from sloika_tpu_torch.nn.fused_lstm import (lstm_backward, lstm_forward,
                                                lstm_wgrad, lstm_wgrad_plain)
    from sloika_tpu_torch import scripts
    from sloika_tpu_torch.scripts import cuda_ms
    # the bound depends on the shapes alone; a tree whose scripts lack it
    # reports none
    bound_ms = getattr(scripts, "bound_ms", lambda nbytes, nflop: None)
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
    tree = os.path.dirname(os.path.dirname(os.path.abspath(
        sloika_tpu_torch.__file__)))
    wgrad = dict(
        shape, ms=cuda_ms(lambda: lstm_wgrad(h, c, dxp, False), 20, 3),
        einsum_ms=cuda_ms(lambda: lstm_wgrad_plain(h, c, dxp, False), 20, 3),
        bound_ms=bound_ms(*wgrad_bound(T * B, S)),
        by_launch=wgrad_launches(h, c, dxp))
    if hasattr(fused_lstm, "lstm_wgrad_plan"):
        wgrad["plan"] = fused_lstm.lstm_wgrad_plan(T, B, S)
    Sn = WGRAD_NARROW_S
    gen = torch.Generator(device=dev).manual_seed(3)
    hn, cn, dn = (torch.randn((T, B, k * Sn), generator=gen, device=dev)
                  for k in (1, 1, 4))
    narrow = {"T": T, "B": B, "S": Sn,
              "ms": cuda_ms(lambda: lstm_wgrad(hn, cn, dn, False), 20, 3),
              "einsum_ms": cuda_ms(lambda: lstm_wgrad_plain(hn, cn, dn,
                                                            False), 20, 3),
              "bound_ms": bound_ms(*wgrad_bound(T * B, Sn))}
    del hn, cn, dn
    result = {"card": card, "tree": tree, "lstm_wgrad": wgrad,
              "lstm_wgrad_narrow": narrow}
    if args.clocks:
        result["lstm_wgrad_clocks"] = wgrad_clocks(
            h, c, dxp, lstm_wgrad(h, c, dxp, False))
    if args.wgrad:
        print(json.dumps(result), flush=True)
        return 0
    ms = cuda_ms(bwd, 3, 3)
    fwd_ms = cuda_ms(inference, 3, 3)
    Ts, Bs = SERVING
    xs, _, _, _, ms_mask = inputs(Ts, Bs, S, dev, seed=1)
    serving_ms = cuda_ms(
        lambda: lstm_forward(xs, sWT, p, mask=ms_mask, emit_cout=False), 3, 3)
    del xs
    result.update({
        "lstm_fwd": dict(shape, ms=fwd_ms, us_per_step=1e3 * fwd_ms / T),
        "lstm_fwd_train": dict(shape, ms=cuda_ms(train, 3, 3)),
        "lstm_fwd_serving": {"T": Ts, "B": Bs, "S": S, "ms": serving_ms,
                             "us_per_step": 1e3 * serving_ms / Ts},
        "lstm_bwd": dict(shape, ms=ms, us_per_step=1e3 * ms / T)})
    if args.clocks:
        h_inf = inference()[0]
        result["lstm_fwd_clocks"] = fwd_step_clocks(xp, sWT, p, mask, h_inf)
        result["lstm_fwd_train_clocks"] = fwd_step_clocks(
            xp, sWT, p, mask, (h, c, gates), train=True)
        result["lstm_bwd_clocks"] = bwd_step_clocks(gates, sWT, p, mask, g,
                                                    c, dxp)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
