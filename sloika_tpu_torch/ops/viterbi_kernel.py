"""Transducer Viterbi on the GPU: the CUDA kernels and their dispatch.

:data:`viterbi_forward` replaces the Pallas TPU kernels
``sloika_tpu/ops/pallas/viterbi.py::_fwd_kernel_sm`` (the production,
state-major layout) and its lane-major twin ``_fwd_kernel`` with
``csrc/viterbi_fwd.cu``: it reads the forward's native time-major posterior
(T, B, K+1) in the probability domain, takes ``log(p + 1e-10)`` in-kernel
and writes int8 traceback codes (T, B, K) and the final scores (B, K).

:data:`viterbi_backtrace` replaces the int8-code backtrace of
``_viterbi_impl`` (an XLA scan in the JAX package) with
``csrc/viterbi_back.cu``.

Both kernels take their launch plans from Python:
:func:`viterbi_fwd_plan` (a cluster of two blocks a row, one taking the
logs, or one block a row, and the rings' slots and shared memory) and
:func:`viterbi_back_plan` (frames a slot of the traceback ring, slots,
shared memory).  Both dispatch on the device of their input: the kernel for
a CUDA tensor, the plain twin of :mod:`sloika_tpu_torch.ops.decode` for a
CPU tensor.  The tuned kernels take nbase = 4 and klen 2..6 (K = 16 ..
4,096 states); every other posterior that the Pallas kernel takes (its
``nbase`` and ``klen`` are parameters: klen 7 over 4 bases, or 3 or 5
bases) takes the same sources' general route (``viterbi_fwd_general``,
``viterbi_back_general``, planned by :func:`viterbi_general_plan`), by the
shape rule :func:`kernel_route`.  ``launches`` counts kernel launches of
either route, ``general_launches`` those of the general route.
"""
import ctypes

import torch

from sloika_tpu_torch import cuda_build
from sloika_tpu_torch.nn.fused_gru import H100_SMS, SMEM_OPTIN, _round
from sloika_tpu_torch.ops.decode import (viterbi_backtrace_plain,
                                         viterbi_forward_plain)

#: the kmer lengths the tuned kernels take (K = 4 ** klen states)
KLENS = (2, 3, 4, 5, 6)
#: an SM's shared memory, what each resident block reserves of it, its
#: threads and its blocks at most (sm_90)
SM_SMEM, BLOCK_RESERVED, SM_THREADS, SM_BLOCKS = 233472, 1024, 2048, 32
#: viterbi_fwd.cu: its mbarriers; destinations a thread where a block has
#: its SM alone (the shortest step) and where blocks share an SM (the
#: fewest instructions); the posterior ring's depth at most and at least
FWD_BAR_BYTES, FWD_DPT_ALONE, FWD_DPT_SHARED = 128, 4, 8
FWD_MAX_SLOTS, FWD_MIN_SLOTS = 16, 2
#: its pair route (a cluster of two blocks a row, the second taking the
#: logs): the mbarriers; the log block's posterior slots; frames a slot, most
#: first; the log ring's depth at most
FWD_PAIR_BAR_BYTES, FWD_PAIR_POST_SLOTS = 384, 2
FWD_PAIR_ROWS, FWD_PAIR_MAX_SLOTS = (8, 4, 2, 1), 4
#: viterbi_back.cu: its threads (a walker and a copier warp); its
#: mbarriers (full and empty, 16 each); frames a slot it is built for,
#: most first; the bytes a slot is aimed at; the ring's depth at most and
#: at least
BACK_THREADS, BACK_BAR_BYTES = 64, 256
BACK_FRAMES, BACK_SLOT_BYTES = (32, 16, 8, 4, 2, 1), 16384
BACK_MAX_SLOTS, BACK_MIN_SLOTS = 16, 2
#: the general route: threads a block at most, the ring's depth at most
GENERAL_MAX_THREADS, GENERAL_MAX_SLOTS = 1024, 4


def _states(K):
    if K not in [4 ** k for k in KLENS]:
        raise ValueError("the Viterbi kernels take K = 4^klen states for "
                         "klen {}..{} (got K = {})".format(KLENS[0],
                                                            KLENS[-1], K))


def kernel_route(K, klen, nbase):
    """"tuned" where the tuned kernels decode K states of kmers of ``klen``
    over ``nbase`` bases (nbase 4, klen in KLENS, K = 4^klen), else
    "general" (any nbase whose codes, up to nbase + nbase^2 - 1, fit int8,
    as the Pallas kernel's do).  A shape rule, decided before any build."""
    if nbase == 4 and klen in KLENS and K == 4 ** klen:
        return "tuned"
    if nbase + nbase * nbase > 128:
        raise ValueError("int8 traceback codes hold nbase + nbase^2 <= 128 "
                         "(got nbase {})".format(nbase))
    return "general"


def _klen_of(K, nbase):
    """The kmer length whose nbase^klen states are K (the reference asserts
    that a posterior has them, ``sloika_tpu/basecall.py:156-158``)."""
    klen, n = 0, 1
    while n < K and nbase > 1:
        klen, n = klen + 1, n * nbase
    if n != K or K < nbase * nbase:
        raise ValueError("{} states are not nbase^klen for nbase {} and "
                         "klen >= 2".format(K, nbase))
    return klen


def _resident(B, threads, sms):
    """Blocks an SM must hold for a batch of B one-row blocks to run in one
    wave over ``sms`` SMs, at most what its threads and block slots allow."""
    return max(1, min(-(-B // sms), SM_THREADS // threads, SM_BLOCKS))


def _budget(blocks, optin):
    """Shared memory a block may take with ``blocks`` blocks an SM."""
    return min(optin, SM_SMEM // blocks - BLOCK_RESERVED)


def viterbi_fwd_plan(B, K, sms=H100_SMS, optin=SMEM_OPTIN, pairs=None):
    """The launch plan of ``viterbi_fwd.cu`` for B rows of K states.

    Where the card runs a cluster of two blocks for every row at once (B
    <= ``pairs``, the clusters it holds, by default ``sms // 2``), route
    "pair": blocks of ``threads`` = K threads (at least 32, at most
    1,024), a DP block, whose first K/4 run the step, and a log block,
    which streams the row's posterior through its own ring
    (FWD_PAIR_POST_SLOTS slots of G frames), takes ``logf(p + 1e-10)`` of
    four frames at once and copies G frames of logs at a time into the DP
    block's log ring (``nslots`` slots).  G: the most of FWD_PAIR_ROWS
    with two log slots in ``optin`` bytes; then up to FWD_PAIR_MAX_SLOTS
    log slots.  Each block takes at least half an
    SM's shared memory, so that the two run on two SMs.

    Else route "single": a block a row, K / dpt threads of dpt
    destinations each: 4 where the batch leaves each block an SM of its own
    (B <= sms), where the latency of a step bounds the kernel; else 8,
    where the SM's instruction issue bounds it and a thread of two step
    groups computes their shared skip maximum once (PERF.md §6).
    Its dynamic shared memory holds the posterior ring's mbarriers,
    ``nslots`` one-frame slots and the double-buffered scores (8 K bytes).
    ``blocks``: the blocks an SM must hold for the batch to run in one wave
    (at most what its threads allow, and fewer where a ring of
    FWD_MIN_SLOTS would not fit beside them: 3 at B = 1,024 and K = 4,096,
    where the design before this one held 2); the ring is the deepest, up
    to FWD_MAX_SLOTS, with which that many blocks fit the SM's shared
    memory: 4 slots at B = 1,024 and K = 1,024.

    A row's frame is its 16-byte-aligned superset, ``4 (K+1) + 12`` bytes
    rounded up to 16 (a log row, K + 4 floats, is as long).

    :returns: dict of route, dpt (0 for "pair"), threads, blocks (an SM),
        G, nslots, row_bytes, smem (dynamic bytes)
    """
    _states(K)
    pairs = sms // 2 if pairs is None else pairs
    row_bytes = _round(4 * (K + 1) + 12, 16)
    if B <= pairs:
        fixed = FWD_PAIR_BAR_BYTES + 8 * K
        chunks = lambda g: (optin - fixed) // (g * row_bytes)
        G = next(g for g in FWD_PAIR_ROWS
                 if chunks(g) >= FWD_PAIR_POST_SLOTS + FWD_MIN_SLOTS)
        nslots = min(FWD_PAIR_MAX_SLOTS, chunks(G) - FWD_PAIR_POST_SLOTS)
        smem = max(fixed + (nslots + FWD_PAIR_POST_SLOTS) * G * row_bytes,
                   SM_SMEM // 2)
        return {"route": "pair", "dpt": 0,
                "threads": min(1024, max(32, K)), "blocks": 1,
                "G": G, "nslots": nslots, "row_bytes": row_bytes,
                "smem": smem}
    dpt = FWD_DPT_ALONE if B <= sms else FWD_DPT_SHARED
    threads = max(1, K // dpt)
    fixed = FWD_BAR_BYTES + 8 * K
    slots = lambda n: (_budget(n, optin) - fixed) // row_bytes
    blocks = _resident(B, threads, sms)
    while blocks > 1 and slots(blocks) < FWD_MIN_SLOTS:
        blocks -= 1
    nslots = min(FWD_MAX_SLOTS, slots(blocks))
    if nslots < FWD_MIN_SLOTS:
        raise ValueError("viterbi_fwd: no ring of {} slots fits {} blocks "
                         "of K = {} an SM".format(FWD_MIN_SLOTS, blocks, K))
    return {"route": "single", "dpt": dpt, "threads": threads,
            "blocks": blocks, "G": 1, "nslots": nslots,
            "row_bytes": row_bytes, "smem": fixed + nslots * row_bytes}


def viterbi_back_plan(B, K, T, sms=H100_SMS, optin=SMEM_OPTIN):
    """The launch plan of ``viterbi_back.cu`` for B rows of T frames of K
    states.

    A block a row, of BACK_THREADS threads.  The traceback streams through
    a ring of slots of F frames (F K bytes, 128-byte aligned), one box of a
    tensor map a slot.  ``blocks``: the blocks an SM must hold for the
    batch to run in one wave; F: the most of BACK_FRAMES (the kernel is
    built for each) whose slot is at most BACK_SLOT_BYTES and of which two
    fit that many blocks an SM (else 1); then as many slots as fit, up to
    BACK_MAX_SLOTS and to the row's chunks of F frames.  16 frames and 14
    slots at B = 8 and K = 1,024; 8 frames and 3 slots at B = 1,024.

    :returns: dict of F, nslots, slot_bytes, blocks, smem (dynamic bytes)
    """
    _states(K)
    blocks = _resident(B, BACK_THREADS, sms)
    budget = _budget(blocks, optin) - BACK_BAR_BYTES
    F = next((f for f in BACK_FRAMES if f * K <= BACK_SLOT_BYTES
              and BACK_MIN_SLOTS * _round(f * K, 128) <= budget), 1)
    slot_bytes = _round(F * K, 128)
    chunks = -(-max(T - 1, 0) // F)
    nslots = max(BACK_MIN_SLOTS, min(BACK_MAX_SLOTS, budget // slot_bytes,
                                     chunks))
    smem = BACK_BAR_BYTES + nslots * slot_bytes
    if smem > optin:
        raise ValueError("viterbi_back: K = {} does not fit {} bytes of "
                         "shared memory".format(K, optin))
    return {"F": F, "nslots": nslots, "slot_bytes": slot_bytes,
            "blocks": blocks, "smem": smem}


def viterbi_general_plan(B, K, nbase, optin=SMEM_OPTIN):
    """The launch plan of the general route (``viterbi_fwd_general``) for B
    rows of K = nbase^klen states.

    A block a row of ``threads`` (K rounded up to a warp, at most
    GENERAL_MAX_THREADS).  A step's arrays (the scores, updated in place,
    and the K/nbase step groups' and K/nbase^2 skip groups' maxima and
    codes: ``4 (K + K/nbase + K/nbase^2) + K/nbase + K/nbase^2`` bytes) lie
    in shared memory with at least one ring slot beside them where that
    fits (``shared``), else in device memory, ``work_floats`` floats a row.
    The ring takes as many one-frame slots (the row's 16-byte-aligned
    superset) as fit beside them, up to GENERAL_MAX_SLOTS (0: the rows are
    read from device memory).  At K = 16,384 over 4 bases: the arrays in
    shared memory and two slots.

    :returns: dict of threads, shared, nslots, row_bytes, work_floats, smem
        (dynamic bytes)
    """
    nrs = K // nbase
    nrk = nrs // nbase
    arrays = _round(4 * (K + nrs + nrk) + nrs + nrk, 16)
    row_bytes = _round(4 * (K + 1) + 12, 16)
    slots = lambda used: min(GENERAL_MAX_SLOTS,
                             max(0, optin - FWD_BAR_BYTES - used)
                             // row_bytes)
    shared = slots(arrays) >= 1
    nslots = slots(arrays if shared else 0)
    return {"threads": min(GENERAL_MAX_THREADS, max(32, _round(K, 32))),
            "shared": shared, "nslots": nslots, "row_bytes": row_bytes,
            "work_floats": 0 if shared else arrays // 4,
            "smem": FWD_BAR_BYTES + nslots * row_bytes
            + (arrays if shared else 0)}


def _device_limits(dev):
    """(SMs, shared memory a block may opt in to) of a CUDA device."""
    props = torch.cuda.get_device_properties(dev)
    return (props.multi_processor_count,
            getattr(props, "shared_memory_per_block_optin", SMEM_OPTIN))


class ViterbiForward:
    """(vfinal (B, K), traceback (T, B, K) int8) from a probability-domain
    posterior (T, B, K+1), column 0 = stay.  Replaces the Pallas TPU
    kernels ``sloika_tpu/ops/pallas/viterbi.py::_fwd_kernel_sm`` and
    ``_fwd_kernel`` with ``csrc/viterbi_fwd.cu``, launched with
    :func:`viterbi_fwd_plan`."""

    _ARGTYPES = {"viterbi_fwd": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                 + [ctypes.c_float] + [ctypes.c_int] * 4
                 + [ctypes.c_ulonglong, ctypes.c_void_p],
                 "viterbi_fwd_pairs": [ctypes.c_int] * 2 + [ctypes.c_void_p],
                 "viterbi_fwd_general": [ctypes.c_void_p] * 4
                 + [ctypes.c_int] * 4 + [ctypes.c_float]
                 + [ctypes.c_int] * 4 + [ctypes.c_ulonglong,
                                          ctypes.c_void_p]}

    def __init__(self):
        self.launches = 0
        self.general_launches = 0
        self._pairs = {}

    def pairs(self, K, device):
        """The clusters of the pair route's blocks for K states that the
        card runs at once (queried once for each device and K)."""
        key = (str(device), K)
        if key not in self._pairs:
            smem = viterbi_fwd_plan(0, K, *_device_limits(device),
                                    pairs=1)["smem"]
            n = ctypes.c_int(0)
            with torch.cuda.device(device):
                cuda_build.check(self._library().viterbi_fwd_pairs(
                    K, smem, ctypes.byref(n)), "viterbi_fwd_pairs")
            self._pairs[key] = n.value
        return self._pairs[key]

    def _library(self):
        """The loaded ``viterbi_fwd`` library (``scripts/bench_viterbi.py``
        swaps in its clocked build)."""
        return cuda_build.load("viterbi_fwd", self._ARGTYPES)

    def __call__(self, post, klen, skip_pen=0.0, nbase=4):
        if post.device.type == "cpu":
            return viterbi_forward_plain(post, klen, skip_pen=skip_pen,
                                         nbase=nbase)
        T, B, nst = post.shape
        K = nst - 1
        if K != nbase ** klen:
            raise ValueError("the posterior has {} states, klen {} over {} "
                             "bases needs {}".format(nst, klen, nbase,
                                                     nbase ** klen + 1))
        route = kernel_route(K, klen, nbase)
        cuda_build.check_tensor(post, (T, B, nst), torch.float32,
                                post.device, "post")
        tb = torch.empty((T, B, K), dtype=torch.int8, device=post.device)
        vfinal = torch.empty((B, K), dtype=torch.float32, device=post.device)
        if T == 0 or B == 0:
            return vfinal, tb
        if route == "general":
            self._general(post, tb, vfinal, nbase, skip_pen)
            return vfinal, tb
        plan = viterbi_fwd_plan(B, K, *_device_limits(post.device),
                                pairs=self.pairs(K, post.device))
        lib = self._library()
        with torch.cuda.device(post.device):
            err = lib.viterbi_fwd(post.data_ptr(), tb.data_ptr(),
                                  vfinal.data_ptr(), T, B, K,
                                  float(skip_pen), plan["dpt"], plan["G"],
                                  plan["nslots"], plan["smem"],
                                  cuda_build.storage_end(post),
                                  torch.cuda.current_stream().cuda_stream)
        cuda_build.check(err, "viterbi_fwd")
        self.launches += 1
        return vfinal, tb

    def _general(self, post, tb, vfinal, nbase, skip_pen):
        """The general route into ``tb`` and ``vfinal``."""
        T, B, nst = post.shape
        plan = viterbi_general_plan(B, nst - 1, nbase,
                                    _device_limits(post.device)[1])
        work = None
        if not plan["shared"]:
            work = torch.empty(B * plan["work_floats"], dtype=torch.float32,
                               device=post.device)
        lib = self._library()
        with torch.cuda.device(post.device):
            err = lib.viterbi_fwd_general(
                post.data_ptr(), tb.data_ptr(), vfinal.data_ptr(),
                None if work is None else work.data_ptr(), T, B, nst - 1,
                nbase, float(skip_pen), plan["nslots"], plan["threads"],
                plan["smem"], plan["work_floats"],
                cuda_build.storage_end(post),
                torch.cuda.current_stream().cuda_stream)
        cuda_build.check(err, "viterbi_fwd_general")
        self.launches += 1
        self.general_launches += 1


class ViterbiBacktrace:
    """(path (B, T) int32, moved (B, T) bool) from traceback codes
    (T, B, K) int8 and the last state of each row.  Replaces the XLA
    backtrace of ``sloika_tpu/ops/pallas/viterbi.py::_viterbi_impl`` with
    ``csrc/viterbi_back.cu``, launched with :func:`viterbi_back_plan`."""

    _ARGTYPES = {"viterbi_back": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                 + [ctypes.c_void_p],
                 "viterbi_back_general": [ctypes.c_void_p] * 4
                 + [ctypes.c_int] * 4 + [ctypes.c_void_p]}

    def __init__(self):
        self.launches = 0
        self.general_launches = 0

    def _library(self):
        """The loaded ``viterbi_back`` library (``scripts/bench_viterbi.py``
        swaps in its clocked build)."""
        return cuda_build.load("viterbi_back", self._ARGTYPES)

    def __call__(self, tb, last_state, nbase=4):
        if tb.device.type == "cpu":
            return viterbi_backtrace_plain(tb, last_state, nbase=nbase)
        T, B, K = tb.shape
        route = kernel_route(K, _klen_of(K, nbase), nbase)
        cuda_build.check_tensor(tb, (T, B, K), torch.int8, tb.device, "tb")
        last = last_state.to(torch.int32).contiguous()
        cuda_build.check_tensor(last, (B,), torch.int32, tb.device,
                                "last_state")
        path = torch.empty((B, T), dtype=torch.int32, device=tb.device)
        moved = torch.empty((B, T), dtype=torch.bool, device=tb.device)
        if T == 0 or B == 0:
            return path, moved
        if route == "general":
            with torch.cuda.device(tb.device):
                err = self._library().viterbi_back_general(
                    tb.data_ptr(), last.data_ptr(), path.data_ptr(),
                    moved.data_ptr(), T, B, K, nbase,
                    torch.cuda.current_stream().cuda_stream)
            cuda_build.check(err, "viterbi_back_general")
            self.launches += 1
            self.general_launches += 1
            return path, moved
        if tb.data_ptr() % 16:
            tb = tb.clone()          # the tensor map reads 16-byte units
        plan = viterbi_back_plan(B, K, T, *_device_limits(tb.device))
        lib = self._library()
        with torch.cuda.device(tb.device):
            err = lib.viterbi_back(tb.data_ptr(), last.data_ptr(),
                                   path.data_ptr(), moved.data_ptr(),
                                   T, B, K, plan["F"], plan["nslots"],
                                   plan["smem"],
                                   torch.cuda.current_stream().cuda_stream)
        cuda_build.check(err, "viterbi_back")
        self.launches += 1
        return path, moved


#: the Viterbi forward entry point (kernel on CUDA, plain twin on the CPU)
viterbi_forward = ViterbiForward()

#: the backtrace entry point (kernel on CUDA, plain twin on the CPU)
viterbi_backtrace = ViterbiBacktrace()


def viterbi(post, klen, skip_pen=0.0, nbase=4):
    """Viterbi decode of a probability-domain time-major posterior
    (T, B, K+1) through :data:`viterbi_forward` and
    :data:`viterbi_backtrace` (cf. ``sloika_tpu.ops.pallas.viterbi.viterbi``
    with ``time_major=True``).

    :returns: (score (B,), path (B, T) int32, moved (B, T) bool)
    """
    vfinal, tb = viterbi_forward(post, klen, skip_pen=skip_pen, nbase=nbase)
    score = torch.amax(vfinal, dim=1)
    last = torch.argmax(vfinal, dim=1)          # first of equal maxima
    path, moved = viterbi_backtrace(tb, last, nbase=nbase)
    return score, path, moved
