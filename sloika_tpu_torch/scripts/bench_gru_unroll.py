"""Price time-step unrolling and weight precision of the GRU forward on the
card: the port's counterpart of ``scripts/bench_gru_unroll.py``.

:data:`gru_unroll` replaces that script's Pallas TPU kernel (``run_case``,
kernel :26-45, ``pl.pallas_call`` :47), a copy of the production forward
``nn/pallas_gru.py::_kernel`` that takes U time rows a grid step, with
``csrc/gru_unroll.cu``: ``gru_fwd.cu``'s step (weights in registers, bf16
pairs for ``precision="default"``) fed by a ring of slots of U time rows,
each refilled by one thread's bulk copies.  :func:`gru_unroll_plan` picks
its launch from the shapes.  The cases run at raw_0.98_rgrgr's training
shape (T = 400 steps, B = 100, S = 96) and, with ``--S 96 144``, at the
stand-in's widest layer too::

    python -m sloika_tpu_torch.scripts.bench_gru_unroll [U ...] [--S S ...] \
        [--clocks] [--parent DIR] [--device cuda|cpu]

``--clocks`` also builds ``csrc/gru_unroll.cu`` with ``-DGRU_UNROLL_CLOCKS``
into a library of its own and splits a step by phase (UNROLL_PHASES), at
U = 1 and 8.  ``--parent DIR`` also times another tree's probe (e.g. a
parent commit unpacked with ``git archive``) at the same cases, before and
after this tree's (parent, change, change, parent): this script, run with
``--cases`` in a process of its own with DIR first on ``PYTHONPATH``, times
the probe of whichever ``sloika_tpu_torch`` comes first on the path,
through its ``run_case`` (and ``step_clocks``, where it has one).
"""
import argparse
import ctypes
import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from sloika_tpu_torch import config, cuda_build
from sloika_tpu_torch.nn.fused_gru import (H100_SMS, SMEM_OPTIN, _round,
                                           _rows_a_block)
from sloika_tpu_torch.scripts import cuda_ms

#: timed calls a round, as in the JAX script; the best of 3 rounds
REPS = 20

PRECISIONS = ("highest", "default")
UNROLLS = (1, 2, 4, 8)
#: the widths the cases run at: the training shape's, and the stand-in's
#: widest layer (``pretrained.pkl``'s GRU 144)
WIDTHS = (96, 144)
#: the phases of a step that the clocked build stamps, in order
UNROLL_PHASES = ("ring", "product1", "gates", "barrier1", "product2",
                 "update", "barrier2")
#: the register modes the kernel is built for, by precision: (largest S,
#: kr rows of sWT's column, kh2 rows of a half of sW2T's column, largest
#: rows a block); from UNROLL_REGISTER_MIN_S up, else both weights staged
#: ("smem").  bf16 holds two rows a register: at S = 144 all of sWT's
UNROLL_REGISTER_MODES = {"highest": ((96, 96, 48, 8), (144, 48, 72, 2)),
                         "default": ((96, 96, 48, 8), (144, 144, 72, 2))}
UNROLL_REGISTER_MIN_S = 73
#: the 8-warp layout ("registers8", f32, one row a block): widths above
#: W8_MAIN and up to 2 kh2, kr and kh2, and its threads
UNROLL_W8 = {"main": 128, "kr": 104, "kh2": 72, "threads": 256}
#: the ring's slots of U time rows at most and at least (one slot: each
#: body waits for its own rows, where two do not fit, as at S = 145, U = 8
#: and 8 rows a block), and the bytes of their mbarriers
UNROLL_MAX_SLOTS, UNROLL_MIN_SLOTS, UNROLL_BAR_BYTES = 4, 1, 64


def gru_unroll_plan(B, S, U, precision="highest", sms=H100_SMS,
                    optin=SMEM_OPTIN):
    """The launch plan of ``gru_unroll.cu`` for B rows of width S, U time
    rows a ring slot.

    Rows a block ``br``: the fewest of 1, 2, 4, 8 that fit the batch in one
    wave over ``sms`` SMs.  In f32 at one row a block and S above 128 (to
    144), the 8-warp layout ("registers8": 256 threads at 255 registers, kr
    of sWT's rows held, the rest staged), which beat the 9-warp one
    (PERF.md section 6).  Else the first
    register mode of
    UNROLL_REGISTER_MODES[precision] that holds S at this ``br`` (from
    UNROLL_REGISTER_MIN_S), whose sWT rows past ``kr`` are staged; else
    "smem", both weights staged in shared memory when they fit (``stage1``,
    ``stage2``), else read through L1.  Then the deepest ring, up to
    UNROLL_MAX_SLOTS slots, that fits ``optin`` bytes, at least two slots
    where two fit (with less staged if need be), else one (a ValueError
    where not one slot of U time rows fits).  ``ld``: floats a
    row of xp as the kernel reads it (3S rounded up to 4: the bulk copies
    move 16-byte units).

    :returns: dict of br, mode, kr, kh2, nslot, ld, stage1, stage2, smem
        (bytes), threads
    """
    if precision not in PRECISIONS:
        raise ValueError("precision must be one of {}".format(PRECISIONS))
    if U not in UNROLLS:
        raise ValueError("U must be one of {}".format(UNROLLS))
    br = _rows_a_block(B, sms)
    ld = _round(3 * S, 4)
    wbytes = 2 if precision == "default" else 4
    modes = [("registers", kr, kh2) for s_max, kr, kh2, br_max
             in UNROLL_REGISTER_MODES[precision]
             if UNROLL_REGISTER_MIN_S <= S <= s_max and br <= br_max]
    mode, kr, kh2 = (modes + [("smem", 0, 0)])[0]
    threads = _round(2 * S, 32)
    w8 = UNROLL_W8
    if (precision == "highest" and br == 1
            and w8["main"] < S <= 2 * w8["kh2"]):
        mode, kr, kh2, threads = ("registers8", w8["kr"], w8["kh2"],
                                  w8["threads"])
    kh = kh2 or _round((S + 1) // 2, 4)
    fixed = UNROLL_BAR_BYTES + 4 * (_round(max(S, kr) * br, 4)
                                    + _round(2 * kh * br, 4))
    w1 = wbytes * max(S - kr, 0) * 2 * S
    if mode == "registers8":
        # hv and r * h of 2 kh2 rows, the extra states' z, sWT's rows past
        # kr staged a column a thread
        fixed = UNROLL_BAR_BYTES + 4 * (4 * kh2 + 16)
        w1 = 4 * (S - kr) * threads
    w2 = wbytes * kh * S * 2 if mode == "smem" else 0
    stagings = ((True, True), (True, False), (False, False))
    if mode != "smem":
        stagings = ((True, False),)
    # a ring of two slots or more first, with as much staged as fits
    choices = [(st, n) for st in stagings
               for n in range(UNROLL_MAX_SLOTS, 1, -1)]
    choices += [(st, UNROLL_MIN_SLOTS) for st in stagings]
    for (stage1, stage2), nslot in choices:
        nbytes = (fixed + 4 * nslot * U * br * ld
                  + (w1 if stage1 else 0) + (w2 if stage2 else 0))
        if nbytes <= optin:
            return {"br": br, "mode": mode, "kr": kr, "kh2": kh2,
                    "nslot": nslot, "ld": ld, "stage1": stage1,
                    "stage2": stage2, "smem": nbytes, "threads": threads}
    raise ValueError("GRU size {} does not fit the probe at U = {}".format(
        S, U))


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
    """The GRU forward, U time rows a ring slot; replaces the Pallas TPU
    kernel of ``scripts/bench_gru_unroll.py::run_case`` with
    ``csrc/gru_unroll.cu``, launched with :func:`gru_unroll_plan`.

    Launches the CUDA kernel for CUDA tensors and runs
    :func:`gru_unroll_plain` for CPU tensors.  ``launches`` counts kernel
    launches."""

    _ARGTYPES = {"gru_unroll": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 14
                 + [ctypes.c_void_p]}

    def __init__(self):
        self.launches = 0

    def _library(self):
        """The loaded ``gru_unroll`` library (:func:`step_clocks` swaps in
        its clocked build)."""
        return cuda_build.load("gru_unroll", self._ARGTYPES)

    def __call__(self, xp, sWT, sW2T, U=1, precision="highest"):
        """:param xp: (T, B, 3S) float32 projections; any T
        :param U: time rows a ring slot, 1, 2, 4 or 8 (the result does not
            depend on it)
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
        props = torch.cuda.get_device_properties(dev)
        plan = gru_unroll_plan(B, S, U, precision,
                               props.multi_processor_count,
                               getattr(props, "shared_memory_per_block_optin",
                                       SMEM_OPTIN))
        # the bulk copies move whole 16-byte units: rows of ld floats
        if plan["ld"] != 3 * S:
            xp = torch.nn.functional.pad(xp, (0, plan["ld"] - 3 * S))
        elif xp.data_ptr() % 16:
            xp = xp.clone()
        lib = self._library()
        with torch.cuda.device(dev):
            err = lib.gru_unroll(xp.data_ptr(), sWT.data_ptr(),
                                 sW2T.data_ptr(), out.data_ptr(), T, B, S,
                                 plan["ld"], U, int(precision == "default"),
                                 plan["br"], plan["kr"], plan["kh2"],
                                 plan["nslot"], int(plan["stage1"]),
                                 int(plan["stage2"]), plan["smem"],
                                 plan["threads"],
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
        print("U=%-2d prec=%-8s S=%d run on the CPU in %.1f s, not timed"
              % (U, precision, S, time.time() - t0), flush=True)
        return out, None
    torch.cuda.synchronize()
    print("U=%-2d prec=%s S=%d build+run %.1f s"
          % (U, precision, S, time.time() - t0), flush=True)
    ms = cuda_ms(run, REPS, rounds=3)
    print("U=%-2d prec=%-8s S=%d %7.3f ms (%.2f us/step)"
          % (U, precision, S, ms, ms * 1e3 / T), flush=True)
    return out, ms


def step_clocks(U, S=96, precision="highest", T=400, B=100, device="cuda"):
    """Build ``gru_unroll.cu`` with ``-DGRU_UNROLL_CLOCKS`` into a library
    of its own and run it at one case (it must give the port's build's
    bits): its ms, and the cycles a step of each phase (UNROLL_PHASES), by
    warp of block 0 and their mean."""
    from sloika_tpu_torch.scripts import (clocked_library, read_clocks,
                                          split_clocks)
    dev = torch.device(device)
    lib = clocked_library("gru_unroll", "GRU_UNROLL_CLOCKS",
                          GruUnroll._ARGTYPES, "gru_unroll_clocks_read")

    class Clocked(GruUnroll):
        def _library(self):
            return lib

    xp, sWT, sW2T = (torch.from_numpy(a).to(dev)
                     for a in case_inputs(U, B, S, T))
    ref = gru_unroll(xp, sWT, sW2T, U=U, precision=precision)
    run = lambda: Clocked()(xp, sWT, sW2T, U=U, precision=precision)
    ms = cuda_ms(run, 5, rounds=3)
    if not torch.equal(run(), ref):
        raise AssertionError("the clocked build of gru_unroll gave other "
                             "bits")
    warps = gru_unroll_plan(B, S, U, precision)["threads"] // 32
    return split_clocks(read_clocks(lib, "gru_unroll_clocks_read", warps),
                        xp.shape[0], ms, UNROLL_PHASES)


def parity(base, out):
    """"EXACT" or the largest difference of ``out``'s first steps from
    ``base``."""
    out = out[:base.shape[0]]
    if torch.equal(base, out):
        return "EXACT"
    return "max|d|=%.3g" % float((base - out).abs().max())


def time_cases(gu, widths, unrolls, clocks, device="cuda"):
    """Time every (S, precision, U) case through module ``gu`` (this
    script, or another tree's copy of it) and, with ``clocks`` where ``gu``
    has ``step_clocks``, split its step at U = 1 and 8.  Prints each case's
    parity with the first U.

    :returns: {"S<S> <precision> U<U>": ms, "... clocks": split}
    """
    cases = {}
    for S in widths:
        for p in gu.PRECISIONS:
            base = None
            for U in unrolls:
                out, ms = gu.run_case(U, S=S, precision=p, device=device)
                cases["S%d %s U%d" % (S, p, U)] = ms
                if base is None:
                    base, U0 = out, U
                else:
                    print("U=%-2d parity vs U=%d: %s"
                          % (U, U0, gu.parity(base, out)), flush=True)
            if clocks and hasattr(gu, "step_clocks"):
                for U in (1, 8):
                    split = gu.step_clocks(U, S=S, precision=p)
                    cases["S%d %s U%d clocks" % (S, p, U)] = {
                        k: split[k] for k in ("ms", "cycles_per_step",
                                              "ghz", "phases_mean")}
    return cases


def time_tree(tree, widths, unrolls, clocks):
    """The cases of :func:`time_cases` through another tree's probe: this
    script with ``--cases``, in a process of its own with that tree first on
    the path."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    argv = ([sys.executable, os.path.abspath(__file__), "--cases"]
            + [str(u) for u in unrolls] + ["--S"] + [str(w) for w in widths]
            + (["--clocks"] if clocks else []))
    done = subprocess.run(argv, cwd=tree, env=env, capture_output=True,
                          text=True, timeout=1800)
    lines = [l for l in done.stdout.splitlines() if l.startswith("CASES ")]
    if done.returncode != 0 or not lines:
        raise RuntimeError("the probe of {} failed:\n{}{}".format(
            tree, done.stdout[-4000:], done.stderr[-4000:]))
    return json.loads(lines[-1][len("CASES "):])


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Time the GRU forward at U time rows a ring slot")
    parser.add_argument("unroll", nargs="*", type=int,
                        help="U values (default 1 2 4 8)")
    parser.add_argument("--S", nargs="+", type=int, default=[WIDTHS[0]],
                        help="widths (default 96; the stand-in's 144 too "
                        "with --S 96 144)")
    parser.add_argument("--clocks", action="store_true",
                        help="split a step by the clocked build (card only)")
    parser.add_argument("--parent", default=None,
                        help="another tree whose probe to time before and "
                        "after this one's (card only)")
    parser.add_argument("--cases", action="store_true",
                        help="time the probe of whichever sloika_tpu_torch "
                        "comes first on the path and print its cases as "
                        "one JSON line (what --parent runs)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    dev = config.resolve_device(args.device)
    config.disable_tf32()
    unrolls = args.unroll or list(UNROLLS)
    if args.cases:
        gu = importlib.import_module("sloika_tpu_torch.scripts."
                                     "bench_gru_unroll")
        print("CASES " + json.dumps(time_cases(gu, args.S, unrolls,
                                               args.clocks, dev)),
              flush=True)
        return 0
    if dev.type != "cuda":
        time_cases(sys.modules[__name__], args.S, unrolls, False, dev)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print("device: %s [%s]" % (torch.cuda.get_device_name(dev), card),
          flush=True)
    here = sys.modules[__name__]
    runs = []
    if args.parent:
        runs.append(("parent", time_tree(args.parent, args.S, unrolls,
                                         args.clocks)))
    runs.append(("change", time_cases(here, args.S, unrolls, args.clocks,
                                      dev)))
    if args.parent:
        runs.append(("change", time_cases(here, args.S, unrolls, False,
                                          dev)))
        runs.append(("parent", time_tree(args.parent, args.S, unrolls,
                                         False)))
    print(json.dumps({"card": card, "T": 400, "B": 100,
                      "runs": [{"tree": t, "cases": c} for t, c in runs]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
