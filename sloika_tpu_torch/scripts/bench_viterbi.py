"""Time the Viterbi kernels on the card at the decode paths' shapes::

    python -m sloika_tpu_torch.scripts.bench_viterbi [--clocks] \\
        [--shapes chunk,production,events,whole]

Shapes (T frames, B rows; K = 1,024 states, klen 5): "chunk", the chunked
basecall's window batch (T 3,277, B 64); "production", ``bench.py``'s
batch of 1,024 windows; "events", the events basecall's batch of 64 reads
of up to 9,000 events; "whole", ``chip_smoke.py``'s longest batch of 8
whole reads (22,543 frames).  The posterior is ``softmax(4 x N(0, 1))``
over 1,025 states, drawn on the card from a seed, as in ``chip_smoke.py``
phase 4.  It times ``viterbi_fwd`` and ``viterbi_back`` (the best of 2
rounds of 3 back-to-back calls by CUDA events).  The general route's
shapes (GENERAL_SHAPES: "whole7", the whole read batch at 16,384 states,
klen 7 over 4 bases; "klen8", T 1,000, B 8 at 65,536; "nbase5", the
5-letter call's batch, T 10,870, B 8 at 3,125 states over 5 bases) time
both kernels' general routes, the backtrace also on a copy of its codes
one byte off a 16-byte boundary (at klen 7, the 1-D bulk copies beside
the aligned codes' tensor-map boxes).

Another tree's kernels, e.g. a parent commit unpacked with ``git
archive``, are timed by that tree's own copy of this script::

    PYTHONPATH=<tree> python <tree>/sloika_tpu_torch/scripts/bench_viterbi.py

or, for the shapes this copy knows, by ``--parent <tree>``: this script in
a process of its own with the tree first on the path, before and after
this tree's run (parent, change, change, parent; untimed by clocks).

With ``--clocks`` it builds ``csrc/viterbi_fwd.cu`` with
``-DVITERBI_FWD_CLOCKS`` and ``csrc/viterbi_back.cu`` with
``-DVITERBI_BACK_CLOCKS``, each into a library of its own, and runs them
on the same inputs: lane 0 of each warp of block 0 sums the SM clock
cycles of each phase of a step (FWD_PHASES; on the general route
GENERAL_PHASES, in block 0 of row 0's cluster; BACK_PHASES, whose walker
and copier warps are reported apart, and the cycles of one read of a chase
through shared memory, ``smem_chase_cycles``).  It reports them a step,
each warp's and the mean over the warps, beside both builds' times; the
cycles of the clocked loop over its time give the clock they ran at.  A
clocked build must give the port's bits.  ``viterbi_back`` is also given
its design's bound: the bytes of the whole traceback read once, and its
chain floor, T shared-memory reads at the chase's cycles.  The general
forward is given its design floor, T one-way hops of a score into another
block's shared memory, a store and its release arrival on that block's
barrier (``push_hop_cycles``: half a round trip between two blocks of the
cluster), and the floor of a step that synchronised by a
cluster barrier and loaded its inputs from the other blocks
(``cluster_barrier_cycles``, ``remote_load_cycles``), each timed by the
clocked build.

Prints one JSON line: the card and its power limit, the tree timed, and
the times.
"""
import argparse
import json
import os
import subprocess
import sys

import torch

#: name -> (T, B)
SHAPES = {"chunk": (3277, 64), "production": (3277, 1024),
          "events": (9000, 64), "whole": (22543, 8)}
KLEN, NSTATE, SKIP_PEN = 5, 1025, 5.0
#: the general route's shapes over 4 bases: name -> (T, B, klen)
GENERAL_SHAPES = {"whole7": (22543, 8, 7, 4), "klen8": (1000, 8, 8, 4),
                  "nbase5": (10870, 8, 5, 5)}
#: the phases of a step that each clocked build stamps, in order
FWD_PHASES = ("row", "logs", "maxima", "update_store", "barrier")
GENERAL_PHASES = ("slot_wait", "logs", "input_wait", "maxima", "update",
                  "barrier_send")
#: viterbi_back's warps: the walker (0) and the copier (1)
BACK_PHASES = ("slot_wait", "walk", "store", "release", "copy_issue")
#: the published peak of one H100 SXM's device memory (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12


def posterior(T, B, dev, seed, nstate=NSTATE):
    """(T, B, nstate) probability-domain posterior drawn on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((T, B, nstate), generator=gen, device=dev)
    return torch.softmax(x.mul_(4.0), dim=2).contiguous()


def fwd_clocks(post, ref, klen=KLEN, nbase=4):
    """Run the clocked build of ``viterbi_fwd`` on ``post`` (it must give
    ``ref``, the port's build's (vfinal, traceback)); returns its time, the
    clock it ran at and the cycles a step of each phase (GENERAL_PHASES
    where klen takes the general route)."""
    from sloika_tpu_torch.ops import viterbi_kernel as vk
    from sloika_tpu_torch.scripts import (clocked_library, cuda_ms,
                                         read_clocks, split_clocks)
    lib = clocked_library("viterbi_fwd", "VITERBI_FWD_CLOCKS",
                          vk.ViterbiForward._ARGTYPES,
                          "viterbi_fwd_clocks_read")

    class Clocked(vk.ViterbiForward):
        def _library(self):
            return lib

    run = lambda: Clocked()(post, klen, SKIP_PEN, nbase=nbase)
    ms = cuda_ms(run, 3, 2)
    if not all(map(torch.equal, run(), ref)):
        raise AssertionError("the clocked build of viterbi_fwd gave other "
                             "bits")
    # the DP warps of row 0's block, each of which stamps
    T, B, nst = post.shape
    K = nst - 1
    if vk.kernel_route(K, klen, nbase) == "general":
        plan = general_plan(B, K, post.device, nbase)
        warps = plan["threads"] // 32
        raw = read_clocks(lib, "viterbi_fwd_clocks_read", warps)
        split = split_clocks(raw, max(T - 1, 1), ms, GENERAL_PHASES)
        split["plan"] = plan
        # thread 0's 16 cluster barriers, thread 32's chase of 64 loads from
        # another block's shared memory, thread 64's 32 round trips of a
        # store and its release arrival between two blocks: the design's
        # floor is one such hop a step; a step that synchronised by a
        # cluster barrier and read its inputs would pay a barrier and a
        # remote load
        if plan["C"] > 1 and warps > 2:
            hop = raw[2][6] / 64
            split.update({"cluster_barrier_cycles": raw[0][6] / 16,
                          "remote_load_cycles": raw[1][6] / 64,
                          "push_hop_cycles": hop})
            per_ms = T / (split["ghz"] * 1e6)
            split["design_floor_ms"] = hop * per_ms
            split["barrier_floor_ms"] = per_ms * (
                split["cluster_barrier_cycles"]
                + split["remote_load_cycles"])
        return split
    plan = vk.viterbi_fwd_plan(B, K, pairs=vk.ViterbiForward().pairs(
        K, post.device))
    dp = K // 4 if plan["route"] == "pair" else plan["threads"]
    warps = -(-dp // 32)
    raw = read_clocks(lib, "viterbi_fwd_clocks_read", warps)
    return split_clocks(raw, T - 1, ms, FWD_PHASES)


def general_plan(B, K, dev, nbase=4):
    """The general route's launch plan for B rows of K states over nbase
    bases on ``dev`` (a tree before the cluster route plans without the
    card's clusters)."""
    from sloika_tpu_torch.ops import viterbi_kernel as vk
    optin = vk._device_limits(dev)[1]
    if not hasattr(vk.viterbi_forward, "general_clusters"):
        return vk.viterbi_general_plan(B, K, nbase, optin)
    return vk.viterbi_general_plan(
        B, K, nbase, optin,
        vk.viterbi_forward.general_clusters(K, nbase, dev))


def back_clocks(tb, last, ref, nbase=4):
    """The same for ``viterbi_back`` (it must give ``ref``, the path and
    moves), on the general route where ``tb``'s shape takes it."""
    from sloika_tpu_torch.ops.viterbi_kernel import ViterbiBacktrace
    from sloika_tpu_torch.scripts import (clocked_library, cuda_ms,
                                         read_clocks, split_clocks)
    lib = clocked_library("viterbi_back", "VITERBI_BACK_CLOCKS",
                          ViterbiBacktrace._ARGTYPES,
                          "viterbi_back_clocks_read")

    class Clocked(ViterbiBacktrace):
        def _library(self):
            return lib

    run = lambda: Clocked()(tb, last, nbase=nbase)
    ms = cuda_ms(run, 3, 2)
    if not all(map(torch.equal, run(), ref)):
        raise AssertionError("the clocked build of viterbi_back gave other "
                             "bits")
    raw = read_clocks(lib, "viterbi_back_clocks_read", 2)
    split = split_clocks(raw, max(tb.shape[0] - 1, 1), ms, BACK_PHASES)
    # the copier stamps nothing where the general route has no ring
    warps = split.pop("phases_by_warp")
    split["walker"], split["copier"] = warps[0], (warps + [None])[1]
    del split["phases_mean"]
    split["cycles_per_step"] = split["walker"]["loop"]
    # thread 0's chase of 64 dependent shared-memory reads
    split["smem_chase_cycles"] = raw[0][6] / 64
    return split


def back_design_bounds(T, B, K, split):
    """``viterbi_back``'s design bounds (ms): the whole traceback read once
    at the published rate, and T shared-memory reads at the chase's cycles
    and the clocked build's clock."""
    return {"design_bytes_ms": 1e3 * T * B * K / HBM_BYTES_PER_S,
            "chain_floor_ms": T * split["smem_chase_cycles"]
            / (split["ghz"] * 1e6)}


def bench_shape(name, dev, clocks):
    """Time both kernels at one of SHAPES (and split their steps)."""
    from sloika_tpu_torch.ops import viterbi_kernel as vk
    from sloika_tpu_torch.scripts import cuda_ms
    T, B = SHAPES[name]
    post = posterior(T, B, dev, seed=T + B)
    vfinal, tb = vk.viterbi_forward(post, KLEN, SKIP_PEN)
    last = torch.argmax(vfinal, dim=1)
    path = vk.viterbi_backtrace(tb, last)
    ms = cuda_ms(lambda: vk.viterbi_forward(post, KLEN, SKIP_PEN), 3, 2)
    back_ms = cuda_ms(lambda: vk.viterbi_backtrace(tb, last), 3, 2)
    K = NSTATE - 1
    out = {"T": T, "B": B, "K": K,
           "viterbi_fwd": {"ms": ms, "us_per_step": 1e3 * ms / T,
                           "plan": vk.viterbi_fwd_plan(
                               B, K, pairs=vk.viterbi_forward.pairs(K, dev))},
           "viterbi_back": {"ms": back_ms, "us_per_step": 1e3 * back_ms / T,
                            "plan": vk.viterbi_back_plan(B, K, T)}}
    if clocks:
        out["viterbi_fwd_clocks"] = fwd_clocks(post, (vfinal, tb))
        out["viterbi_back_clocks"] = back_clocks(tb, last, path)
        out["viterbi_back"].update(back_design_bounds(
            T, B, K, out["viterbi_back_clocks"]))
    return out


def bench_general(name, dev, clocks):
    """Time the general routes of ``viterbi_fwd`` and ``viterbi_back`` at
    one of GENERAL_SHAPES (and split their steps)."""
    from sloika_tpu_torch.ops import viterbi_kernel as vk
    from sloika_tpu_torch.scripts import cuda_ms
    T, B, klen, nbase = GENERAL_SHAPES[name]
    K = nbase ** klen
    post = posterior(T, B, dev, seed=T + B, nstate=K + 1)
    fwd = lambda: vk.viterbi_forward(post, klen, SKIP_PEN, nbase=nbase)
    ref = fwd()
    last = torch.argmax(ref[0], dim=1)
    back = lambda: vk.viterbi_backtrace(ref[1], last, nbase=nbase)
    path = back()
    ms = cuda_ms(fwd, 3, 2)
    back_ms = cuda_ms(back, 3, 2)
    out = {"T": T, "B": B, "K": K, "nbase": nbase,
           "viterbi_fwd_general": {"ms": ms, "us_per_step": 1e3 * ms / T,
                                   "plan": general_plan(B, K, dev, nbase)},
           "viterbi_back_general": {"ms": back_ms,
                                    "us_per_step": 1e3 * back_ms / T}}
    if hasattr(vk, "viterbi_back_general_plan"):
        out["viterbi_back_general"]["plan"] = vk.viterbi_back_general_plan(
            B, K, T, nbase)
    # the backtrace of the same codes one byte off a 16-byte boundary (the
    # plan's other copy form where the aligned codes take tensor-map boxes)
    view = torch.empty(ref[1].numel() + 1, dtype=torch.int8,
                       device=dev)[1:].view(ref[1].shape)
    view.copy_(ref[1])
    off = lambda: vk.viterbi_backtrace(view, last, nbase=nbase)
    if not all(map(torch.equal, off(), path)):
        raise AssertionError("the backtrace of an unaligned view gave other "
                             "bits")
    out["viterbi_back_general"]["unaligned_ms"] = cuda_ms(off, 3, 2)
    if hasattr(vk, "viterbi_back_general_plan"):
        out["viterbi_back_general"]["unaligned_plan"] = (
            vk.viterbi_back_general_plan(B, K, T, nbase, aligned=False))
    del view
    if hasattr(vk.viterbi_forward, "general_clusters"):
        out["viterbi_fwd_general"]["cards_clusters"] = (
            vk.viterbi_forward.general_clusters(K, nbase, dev))
    if clocks:
        out["viterbi_fwd_general_clocks"] = fwd_clocks(post, ref, klen,
                                                       nbase)
        split = back_clocks(ref[1], last, path, nbase)
        out["viterbi_back_general_clocks"] = split
        out["viterbi_back_general"].update(back_design_bounds(T, B, K,
                                                              split))
    return out


def run_tree(tree, shapes):
    """This script's timings (no clocks) through another tree's kernels: a
    process of its own with that tree first on the path."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    done = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--shapes", shapes], cwd=tree, env=env,
                          capture_output=True, text=True, timeout=1800)
    lines = [l for l in done.stdout.splitlines() if l.startswith("{")]
    if done.returncode != 0 or not lines:
        raise RuntimeError("bench_viterbi in {} failed:\n{}{}".format(
            tree, done.stdout[-4000:], done.stderr[-4000:]))
    return json.loads(lines[-1])


def run_here(shapes, dev, clocks):
    """This tree's timings of ``shapes`` (comma-separated names)."""
    import sloika_tpu_torch
    result = {"tree": os.path.dirname(os.path.dirname(
        os.path.abspath(sloika_tpu_torch.__file__)))}
    for name in shapes.split(","):
        result[name] = (bench_general(name, dev, clocks)
                        if name in GENERAL_SHAPES
                        else bench_shape(name, dev, clocks))
        torch.cuda.empty_cache()
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Time the Viterbi kernels at the decode paths' shapes")
    parser.add_argument("--clocks", action="store_true",
                        help="also split a step of each kernel by its "
                        "clocked build")
    parser.add_argument("--shapes", default="chunk,production,events,whole",
                        help="comma-separated names of SHAPES and "
                        "GENERAL_SHAPES")
    parser.add_argument("--parent", default=None,
                        help="another tree to time before and after this "
                        "one (parent, change, change, parent)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_viterbi needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    if not args.parent:
        result = run_here(args.shapes, dev, args.clocks)
        result["card"] = card
        print(json.dumps(result), flush=True)
        return 0
    runs = [("parent", run_tree(args.parent, args.shapes)),
            ("change", run_here(args.shapes, dev, args.clocks)),
            ("change", run_here(args.shapes, dev, False)),
            ("parent", run_tree(args.parent, args.shapes))]
    print(json.dumps({"card": card, "runs": [dict(r, run=n)
                                             for n, r in runs]}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
