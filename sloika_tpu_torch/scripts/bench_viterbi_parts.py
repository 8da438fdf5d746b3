"""Bisect the Viterbi step's cost on the card with stripped-down variants:
the port's counterpart of ``scripts/bench_viterbi_parts.py``.

:data:`viterbi_parts` replaces that script's Pallas TPU kernels
(``run_variant``, ``make_kernel`` :19-94, ``pl.pallas_call`` :107) with
``csrc/viterbi_parts.cu``, whose design is ``viterbi_fwd.cu``'s "single"
route (each row's frames through a ring of bulk copies, one barrier a step;
:func:`viterbi_parts_plan`): each variant removes what the Pallas variant
removes, so the difference between two variants prices one part of that
kernel's step (the log, the int8 store, the stay compare, the group
reduction).  ``expand`` runs ``full``: the TPU's exact one-hot expansion
matmul is an index on the card::

    python -m sloika_tpu_torch.scripts.bench_viterbi_parts [variant ...] \\
        [--batch B] [--T T] [--device cuda|cpu] [--parent DIR]

``--parent DIR`` also times another tree's probe (e.g. a parent commit
unpacked with ``git archive``) before and after this tree's (parent,
change, change, parent), on inputs drawn on the card
(:func:`device_inputs`): this script, run with ``--cases`` in a process of
its own with DIR first on ``PYTHONPATH``, times the probe of whichever
``sloika_tpu_torch`` comes first on the path.
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
from sloika_tpu_torch.nn.fused_gru import H100_SMS, SMEM_OPTIN
from sloika_tpu_torch.ops import viterbi_kernel as vk
from sloika_tpu_torch.scripts import cuda_ms

#: timed calls a round, as in the JAX script; the best of 3 rounds
REPS = 8

VARIANTS = ("noop", "nolog", "f32store", "copy", "maxstay", "reduce",
            "expand", "full")
#: the kernel's variant codes (csrc/viterbi_parts.cu); "expand" is "full"
_CODES = {"noop": 0, "nolog": 1, "f32store": 2, "copy": 3, "maxstay": 4,
          "reduce": 5, "expand": 6, "full": 6}


def viterbi_parts_plain(variant, post, stay, nstep=4, log=torch.log):
    """The plain twin: a loop over time of whole-row torch ops, following
    the Pallas variants (``make_kernel`` :25-92) line for line.

    :param post: (T, B, K) float32 probability-domain posterior
    :param stay: (T, B, 1) float32 stay probability
    :param log: the log the DP takes of ``p + 1e-10`` (``torch.log``, which
        equals the kernel's ``logf`` on the card; a test passes another
        framework's to compare with it bit for bit)
    :returns: (tb (T, B, K) int8, final scores (B, K) float32)
    """
    T, B, K = post.shape
    nrem = K // nstep
    vscore = post[0].clone()
    tb = torch.zeros((T, B, K), dtype=torch.int8, device=post.device)
    if variant == "noop":
        return tb, vscore
    for t in range(1, T):
        p = vscore
        if variant == "nolog":
            vscore = p + stay[t]
            tb[t] = post[t].to(torch.int8)
            continue
        lpk = log(post[t] + 1e-10)
        lps = log(stay[t] + 1e-10)
        if variant == "f32store":
            vscore = p + lps + lpk
            continue
        if variant == "copy":
            vscore = p + lps
            tb[t] = lpk.to(torch.int8)
            continue
        held = p + lps
        if variant == "maxstay":
            new = lpk + p
            code = torch.where(new > held, 1, -1)
        else:
            mx = p[:, :nrem]
            am = torch.zeros((B, nrem), dtype=torch.int64, device=p.device)
            for g in range(1, nstep):
                cand = p[:, g * nrem:(g + 1) * nrem]
                better = cand > mx
                mx = torch.where(better, cand, mx)
                am = torch.where(better, g, am)
            if variant == "reduce":     # destination k takes k mod K/nstep
                score, group = mx.repeat(1, nstep), am.repeat(1, nstep)
            else:                       # destination k takes k // nstep
                score = mx.repeat_interleave(nstep, dim=1)
                group = am.repeat_interleave(nstep, dim=1)
            new = lpk + score
            code = torch.where(new > held, group, -1)
        vscore = torch.maximum(new, held)
        tb[t] = code.to(torch.int8)
    return tb, vscore


def viterbi_parts_plan(B, K, sms=H100_SMS, optin=SMEM_OPTIN):
    """The launch plan of ``viterbi_parts.cu``: ``viterbi_fwd_plan``'s
    "single" route with 4 destinations a thread (K / 4 threads a block), for
    any K that is a multiple of 4.  A slot holds the stay's 16-byte unit and
    the row (16 + 4 K bytes); the scores take 8 K.  ``blocks``: the blocks
    an SM must hold for the batch to run in one wave (fewer where a ring of
    FWD_MIN_SLOTS would not fit beside them); the ring is the deepest, up to
    FWD_MAX_SLOTS, with which that many fit: 16 slots at B = 128 and K =
    1,024, as ``viterbi_fwd_plan`` gives.

    :returns: dict of threads, blocks, nslots, slot_bytes, smem
    """
    if K % 4 or not 4 <= K <= 4096:
        raise ValueError("viterbi_parts takes K a multiple of 4 in 4..4096 "
                         "(got K {})".format(K))
    threads = K // 4
    fixed = vk.FWD_BAR_BYTES + 8 * K
    slot = 16 + 4 * K
    slots = lambda n: (vk._budget(n, optin) - fixed) // slot
    blocks = vk._resident(B, threads, sms)
    while blocks > 1 and slots(blocks) < vk.FWD_MIN_SLOTS:
        blocks -= 1
    nslots = min(vk.FWD_MAX_SLOTS, slots(blocks))
    if nslots < vk.FWD_MIN_SLOTS:
        raise ValueError("viterbi_parts: no ring of {} slots fits K = {}"
                         .format(vk.FWD_MIN_SLOTS, K))
    return {"threads": threads, "blocks": blocks, "nslots": nslots,
            "slot_bytes": slot, "smem": fixed + nslots * slot}


class ViterbiParts:
    """One variant of the Viterbi step; replaces the Pallas TPU kernels of
    ``scripts/bench_viterbi_parts.py::run_variant`` with
    ``csrc/viterbi_parts.cu``.

    Launches the CUDA kernel for CUDA tensors and runs
    :func:`viterbi_parts_plain` for CPU tensors.  ``launches`` counts kernel
    launches."""

    _ARGTYPES = {"viterbi_parts": [ctypes.c_int] + [ctypes.c_void_p] * 4
                 + [ctypes.c_int] * 5 + [ctypes.c_ulonglong,
                                          ctypes.c_void_p]}

    def __init__(self):
        self.launches = 0

    def __call__(self, variant, post, stay, nstep=4):
        """:returns: (tb (T, B, K) int8, final scores (B, K) float32)"""
        if variant not in VARIANTS:
            raise ValueError("variant must be one of {}".format(VARIANTS))
        if post.device.type == "cpu":
            return viterbi_parts_plain(variant, post, stay, nstep)
        T, B, K = post.shape
        dev = post.device
        if nstep != 4:
            raise ValueError("viterbi_parts takes nstep 4 (got {})".format(
                nstep))
        plan = viterbi_parts_plan(B, K, *vk._device_limits(dev))
        cuda_build.check_tensor(post, (T, B, K), torch.float32, dev, "post")
        cuda_build.check_tensor(stay, (T, B, 1), torch.float32, dev, "stay")
        if post.data_ptr() % 16:
            raise ValueError("post must be 16-byte aligned")
        tb = torch.empty((T, B, K), dtype=torch.int8, device=dev)
        vf = torch.empty((B, K), dtype=torch.float32, device=dev)
        if T == 0 or B == 0:
            return tb, vf
        lib = cuda_build.load("viterbi_parts", self._ARGTYPES)
        with torch.cuda.device(dev):
            err = lib.viterbi_parts(_CODES[variant], post.data_ptr(),
                                    stay.data_ptr(), tb.data_ptr(),
                                    vf.data_ptr(), T, B, K, plan["nslots"],
                                    plan["smem"], cuda_build.storage_end(stay),
                                    torch.cuda.current_stream().cuda_stream)
        cuda_build.check(err, "viterbi_parts")
        self.launches += 1
        return tb, vf


#: the probe's entry point (kernel on CUDA, plain twin on the CPU)
viterbi_parts = ViterbiParts()


def variant_inputs(B, T, K=1024):
    """(post (T, B, K), stay (T, B, 1)) float32 as the JAX script draws them
    (:132-135): Dirichlet(0.05) rows and uniform stays."""
    rs = np.random.RandomState(0)
    post = rs.dirichlet(np.full(K, 0.05), size=(T, B)).astype(np.float32)
    stay = rs.rand(T, B, 1).astype(np.float32)
    return post, stay


def device_inputs(B, T, K, device, seed=0):
    """(post, stay) of the same kinds drawn on ``device`` from a seeded
    ``torch.Generator``: each row normalised Gamma(0.05) draws, a
    Dirichlet(0.05) (numpy's draw takes minutes at the script's shape)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    post = torch._standard_gamma(
        torch.full((T, B, K), 0.05, device=device), generator=gen)
    post /= post.sum(dim=2, keepdim=True)
    stay = torch.rand((T, B, 1), generator=gen, device=device)
    return post, stay


def run_variant(variant, B, T, K=1024, nstep=4, device="cuda", inputs=None):
    """Run and time one variant on ``device`` (CUDA events; nothing is
    timed on the CPU).

    :param inputs: (post, stay) tensors on ``device``; default
        :func:`variant_inputs`
    :returns: ((tb, final scores), ms a call or None)
    """
    dev = config.resolve_device(device)
    if inputs is None:
        inputs = (torch.from_numpy(a).to(dev)
                  for a in variant_inputs(B, T, K))
    post, stay = inputs
    run = lambda: viterbi_parts(variant, post, stay, nstep)
    t0 = time.time()
    out = run()
    if dev.type != "cuda":
        print("%-10s run on the CPU in %.1f s, not timed"
              % (variant, time.time() - t0), flush=True)
        return out, None
    torch.cuda.synchronize()
    print("%-10s build+run %.1f s" % (variant, time.time() - t0), flush=True)
    ms = cuda_ms(run, REPS, rounds=3)
    print("%-10s %7.3f ms (best of 3x%d; %.3f us/step)"
          % (variant, ms, REPS, ms * 1e3 / T), flush=True)
    return out, ms


def time_variants(variants, B, T, dev):
    """{variant: ms} of whichever ``sloika_tpu_torch``'s probe comes first
    on the path, on :func:`device_inputs`."""
    vp = importlib.import_module("sloika_tpu_torch.scripts."
                                 "bench_viterbi_parts")
    inputs = vp.device_inputs(B, T, 1024, dev)
    return {v: vp.run_variant(v, B, T, device=dev, inputs=inputs)[1]
            for v in variants}


def time_tree(tree, variants, B, T):
    """:func:`time_variants` through another tree's probe: this script
    with ``--cases``, in a process of its own with that tree first on the
    path."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    argv = ([sys.executable, os.path.abspath(__file__), "--cases",
             "--batch", str(B), "--T", str(T)] + list(variants))
    done = subprocess.run(argv, cwd=tree, env=env, capture_output=True,
                          text=True, timeout=1800)
    lines = [l for l in done.stdout.splitlines() if l.startswith("CASES ")]
    if done.returncode != 0 or not lines:
        raise RuntimeError("the probe of {} failed:\n{}{}".format(
            tree, done.stdout[-4000:], done.stderr[-4000:]))
    return json.loads(lines[-1][len("CASES "):])


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Time the Viterbi step with parts of the DP removed")
    parser.add_argument("variants", nargs="*",
                        help="variants (default all): " + " ".join(VARIANTS))
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--T", type=int, default=3277)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--parent", default=None,
                        help="another tree whose probe to time before and "
                        "after this one's (card only)")
    parser.add_argument("--cases", action="store_true",
                        help="time the probe of whichever sloika_tpu_torch "
                        "comes first on the path and print its times as "
                        "one JSON line (what --parent runs)")
    args = parser.parse_args(argv)
    unknown = sorted(set(args.variants) - set(VARIANTS))
    if unknown:
        parser.error("unknown variants {}".format(unknown))
    dev = config.resolve_device(args.device)
    variants = args.variants or list(VARIANTS)
    if args.cases:
        print("CASES " + json.dumps(time_variants(variants, args.batch,
                                                  args.T, dev)), flush=True)
        return 0
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
        print("device: %s [%s]" % (torch.cuda.get_device_name(dev), card),
              flush=True)
    if args.parent:
        runs = [("parent", time_tree(args.parent, variants, args.batch,
                                     args.T)),
                ("change", time_variants(variants, args.batch, args.T, dev)),
                ("change", time_variants(variants, args.batch, args.T, dev)),
                ("parent", time_tree(args.parent, variants, args.batch,
                                     args.T))]
        print(json.dumps({"card": card, "B": args.batch, "T": args.T,
                          "runs": [{"tree": t, "ms": ms}
                                   for t, ms in runs]}), flush=True)
        return 0
    inputs = tuple(torch.from_numpy(a).to(dev)
                   for a in variant_inputs(args.batch, args.T))
    for v in variants:
        run_variant(v, args.batch, args.T, device=dev, inputs=inputs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
