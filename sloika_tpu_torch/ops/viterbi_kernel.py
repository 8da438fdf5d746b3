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
logs, or one block a row, and the rings' slots and shared memory),
:func:`viterbi_back_plan` and, for the general route,
:func:`viterbi_back_general_plan` (frames a slot of the traceback ring,
slots, shared memory).  Both dispatch on the device of their input: the
kernel for a CUDA tensor, the plain twin of
:mod:`sloika_tpu_torch.ops.decode` for a CPU tensor.  The tuned kernels take nbase = 4 and klen 2..6 (K = 16 ..
4,096 states); every other posterior that the Pallas kernel takes (its
``nbase`` and ``klen`` are parameters: klen 7 over 4 bases, or 3 or 5
bases) takes the same sources' general route (``viterbi_fwd_general``,
``viterbi_back_general``, planned by :func:`viterbi_general_plan`: the
forward's row over a cluster of blocks), by the shape rule
:func:`kernel_route`.  ``launches`` counts kernel launches of either route,
``general_launches`` those of the general route.

The forward takes a float32 or a bfloat16 posterior (POST_DTYPES), on every
route: the JAX package's ``Basecaller`` streams it in bfloat16 when its
compute dtype is bfloat16, and its Pallas kernel upcasts each row to
float32 before the log, as the CUDA kernels and the plain twin do.  The
plans size the rings in bytes, so a bfloat16 row takes about half a slot.
"""
import ctypes

import torch

from sloika_tpu_torch import cuda_build
from sloika_tpu_torch.nn.fused_gru import (H100_CLUSTERS, H100_SMS,
                                           SMEM_OPTIN, _round)
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
#: the general backtrace: the bytes a slot of bulk-copied frames is aimed
#: at, and the largest frame it copies (PERF.md §6)
GENERAL_SLOT_BYTES, GENERAL_RING_BYTES = 65536, 32768
#: the general route: threads a block at most, the ring's depth at most
#: and at least; the clusters of blocks a row it may take, most first
GENERAL_MAX_THREADS, GENERAL_MAX_SLOTS, GENERAL_MIN_SLOTS = 1024, 8, 2
GENERAL_CLUSTERS = (16, 8, 4, 2, 1)
#: the posterior dtypes the forward takes (``viterbi_fwd.cu``'s element
#: types)
POST_DTYPES = (torch.float32, torch.bfloat16)


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


def _row_bytes(n, esize):
    """A ring slot of a row of n elements of ``esize`` bytes: its
    16-byte-aligned superset from any ``esize``-aligned start
    (``viterbi_fwd.cu::superset_bytes``)."""
    return _round(esize * n + 16 - esize, 16)


def viterbi_fwd_plan(B, K, sms=H100_SMS, optin=SMEM_OPTIN, pairs=None,
                     esize=4):
    """The launch plan of ``viterbi_fwd.cu`` for B rows of K states of a
    posterior of ``esize``-byte elements (4: float32, 2: bfloat16).

    Where the card runs a cluster of two blocks for every row at once (B
    <= ``pairs``, the clusters it holds, by default ``sms // 2``), route
    "pair": blocks of ``threads`` = K threads (at least 32, at most
    1,024), a DP block, whose first K/4 run the step, and a log block,
    which streams the row's posterior through its own ring
    (FWD_PAIR_POST_SLOTS slots of G frames), takes ``logf(p + 1e-10)`` of
    four frames at once and copies G frames of logs (K + 4 floats a frame)
    at a time into the DP block's log ring (``nslots`` slots).  G: the most
    of FWD_PAIR_ROWS with two log slots beside the posterior slots in
    ``optin`` bytes; then up to FWD_PAIR_MAX_SLOTS log slots.  Each block
    takes at least half an SM's shared memory, so that the two run on two
    SMs.

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

    A row's frame is its 16-byte-aligned superset, ``esize (K+1) + 16 -
    esize`` bytes rounded up to 16 (a log row, K + 4 floats, is as long as
    a float32 row).

    :returns: dict of route, dpt (0 for "pair"), threads, blocks (an SM),
        G, nslots, row_bytes, smem (dynamic bytes)
    """
    _states(K)
    if esize not in (2, 4):
        raise ValueError("viterbi_fwd reads 4- or 2-byte elements (got {})"
                         .format(esize))
    pairs = sms // 2 if pairs is None else pairs
    row_bytes = _row_bytes(K + 1, esize)
    if B <= pairs:
        fixed = FWD_PAIR_BAR_BYTES + 8 * K
        log_bytes = 4 * (K + 4)
        # log slots of g frames beside the log block's posterior slots
        logs = lambda g: ((optin - fixed - FWD_PAIR_POST_SLOTS * g
                           * row_bytes) // (g * log_bytes))
        G = next(g for g in FWD_PAIR_ROWS if logs(g) >= FWD_MIN_SLOTS)
        nslots = min(FWD_PAIR_MAX_SLOTS, logs(G))
        smem = max(fixed + G * (nslots * log_bytes
                                + FWD_PAIR_POST_SLOTS * row_bytes),
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
    plan = _back_ring(B, K, T, sms, optin)
    if plan["smem"] > optin:
        raise ValueError("viterbi_back: K = {} does not fit {} bytes of "
                         "shared memory".format(K, optin))
    return plan


def _back_ring(B, K, T, sms, optin):
    """:func:`viterbi_back_plan`'s ring of tensor-map boxes for any K a
    power of two, which may not fit ``optin``."""
    blocks = _resident(B, BACK_THREADS, sms)
    budget = _budget(blocks, optin) - BACK_BAR_BYTES
    F = next((f for f in BACK_FRAMES if f * K <= BACK_SLOT_BYTES
              and BACK_MIN_SLOTS * _round(f * K, 128) <= budget), 1)
    slot_bytes = _round(F * K, 128)
    chunks = -(-max(T - 1, 0) // F)
    nslots = max(BACK_MIN_SLOTS, min(BACK_MAX_SLOTS, budget // slot_bytes,
                                     chunks))
    return {"F": F, "nslots": nslots, "slot_bytes": slot_bytes,
            "blocks": blocks, "smem": BACK_BAR_BYTES + nslots * slot_bytes}


def viterbi_back_general_plan(B, K, T, nbase, sms=H100_SMS,
                              optin=SMEM_OPTIN, aligned=True):
    """The launch plan of ``viterbi_back.cu``'s general route for B rows of
    T frames of K = nbase^klen states (any nbase whose codes fit int8).

    As :func:`viterbi_back_plan`, a block a row of BACK_THREADS threads
    whose walker chases the state through a ring of frames in shared
    memory, by one of three copies (``copy``):

    - "tensor" where nbase is 4, K a power of two (klen 7 over 4 bases)
      and the traceback starts on a 16-byte boundary (``aligned``): one
      tensor-map box of F frames a slot, as :func:`viterbi_back_plan` sets
      it (``viterbi_back.cu``'s tuned kernel, whose decode holds for any
      power of two over 4 bases);
    - "bulk" otherwise: each frame a 1-D bulk copy of its 16-byte-aligned
      superset (``frame_bytes``: K + 15 rounded up to 16), issued by lane q
      of the copier for frame q of a slot, so that a slot's copies go out
      together; F the most of BACK_FRAMES whose slot is at most
      GENERAL_SLOT_BYTES and of which two fit the budget of the blocks an
      SM must hold (a slot's copies issued together run faster than one at
      a time, PERF.md §6).  16 frames of 3,152 bytes and 4 slots at nbase 5
      (K = 3,125) and B = 8;
    - "none" where a frame is larger than GENERAL_RING_BYTES (klen 8 over 4
      bases) or two slots do not fit ``optin`` bytes: no ring, the walker
      reads each frame's code from device memory (a 64 KB frame takes
      longer to copy into one SM than a dependent load takes, PERF.md §6).

    Then as many slots as fit, up to BACK_MAX_SLOTS and to the row's chunks
    of F frames, and at least BACK_MIN_SLOTS.  Raises, naming the shape,
    for codes that are not nbase^klen over an alphabet whose codes fit
    int8, or K of 2^24 states or more (the decode's reciprocals).

    :returns: dict of copy, F, nslots, frame_bytes, slot_bytes, blocks,
        smem (dynamic bytes)
    """
    nskip = nbase * nbase
    if (nbase < 2 or nbase + nskip > 128 or K < nskip or K % nskip
            or K >= 1 << 24):
        raise ValueError("viterbi_back_general: K = {} states over nbase {} "
                         "are not nbase^klen codes of int8 below 2^24".format(
                             K, nbase))
    frame_bytes = _row_bytes(K, 1)
    if nbase == 4 and aligned and K & (K - 1) == 0:
        plan = dict(_back_ring(B, K, T, sms, optin), copy="tensor",
                    frame_bytes=K)
    else:
        blocks = _resident(B, BACK_THREADS, sms)
        budget = _budget(blocks, optin) - BACK_BAR_BYTES
        F = next((f for f in BACK_FRAMES if f * frame_bytes
                  <= GENERAL_SLOT_BYTES
                  and BACK_MIN_SLOTS * f * frame_bytes <= budget), 1)
        chunks = -(-max(T - 1, 0) // F)
        nslots = max(BACK_MIN_SLOTS, min(
            BACK_MAX_SLOTS, budget // (F * frame_bytes), chunks))
        plan = {"copy": "bulk", "F": F, "nslots": nslots,
                "frame_bytes": frame_bytes, "slot_bytes": F * frame_bytes,
                "blocks": blocks,
                "smem": BACK_BAR_BYTES + nslots * F * frame_bytes}
    if plan["frame_bytes"] > GENERAL_RING_BYTES or plan["smem"] > optin:
        # the bulk kernel without a ring
        return {"copy": "none", "F": 1, "nslots": 0,
                "frame_bytes": frame_bytes, "slot_bytes": 0,
                "blocks": plan["blocks"], "smem": BACK_BAR_BYTES}
    return plan


def _general_slot_bytes(KC, esize=4):
    """A general ring slot: the stay's 16-byte unit, then the aligned
    superset of a block's KC kmers of ``esize`` bytes
    (``viterbi_fwd.cu::general_slot_bytes``)."""
    return 16 + _row_bytes(KC, esize)


def _general_arrays(K, C):
    """A block's arrays in shared memory (``general_arrays``), KC = K / C
    floats each rounded up to 16 bytes: where C > 1 its scores, its inputs
    of both parities, 2 KC each (the step and the skip predecessors), and
    every block's cluster addresses (2 C words); at C = 1 its scores of both
    parities, which are its inputs."""
    KC4 = _round(K // C, 4)
    return 4 * (5 * KC4 + _round(2 * C, 4)) if C > 1 else 4 * 2 * KC4


def general_cluster_shapes(K, nbase, optin=SMEM_OPTIN, esize=4):
    """{C: {threads, nslots, smem}}: each cluster size of GENERAL_CLUSTERS
    at which the general kernel takes K states over nbase bases, from a
    posterior of ``esize``-byte elements, with its arrays in shared
    memory.  C divides the K / nbase^2 skip groups (so a
    block's states, step groups and skip groups are whole ranges), into
    ranges of a multiple of 4 where C > 1 (a group's 4 scores go to their
    consumers as one 16-byte store), and is at most nbase^2 (so that every
    block feeds every block each step); a block has K / (nbase C) step
    groups, a thread each (at least a warp, at most GENERAL_MAX_THREADS);
    its arrays and a ring of GENERAL_MIN_SLOTS slots fit ``optin`` bytes;
    the ring is as deep as fits, up to GENERAL_MAX_SLOTS; smem is at least
    half an SM's shared memory (up to ``optin``), so each block has an SM
    of its own: the step's latency, not the SM's issue, sets the pace."""
    nrk = K // (nbase * nbase)
    shapes = {}
    for C in GENERAL_CLUSTERS:
        if (nrk < 1 or nrk % C or C > nbase * nbase
                or (C > 1 and (nrk // C) % 4)):
            continue
        threads = min(GENERAL_MAX_THREADS,
                      max(32, _round(K // (nbase * C), 32)))
        fixed = FWD_BAR_BYTES + _general_arrays(K, C)
        slot = _general_slot_bytes(K // C, esize)
        nslots = min(GENERAL_MAX_SLOTS, max(0, optin - fixed) // slot)
        if nslots < GENERAL_MIN_SLOTS:
            continue
        shapes[C] = {"threads": threads,
                     "nslots": nslots,
                     "smem": max(fixed + nslots * slot,
                                 min(optin, SM_SMEM // 2))}
    return shapes


def viterbi_general_plan(B, K, nbase, optin=SMEM_OPTIN, clusters=None,
                         esize=4):
    """The launch plan of the general route (``viterbi_fwd_general``) for B
    rows of K = nbase^klen states of a posterior of ``esize``-byte elements:
    a cluster of C blocks a row.

    ``clusters``: {C: the clusters of C blocks that the card runs at once
    at :func:`general_cluster_shapes`' sizes} (``ViterbiForward.
    general_clusters`` asks the card, at the float32 sizes: a block of
    either takes at least half an SM's shared memory, so the card holds as
    many; default H100_CLUSTERS).  C is the
    largest of those shapes' sizes whose B clusters all run in one wave:
    8 at klen 7 and B = 8 on the H100, where 16 would leave a row for a
    second wave and double the time.  Where no size runs in one wave, the
    smallest that fits, its smem not padded (blocks may share an SM: the
    issue of many rows, not one step's latency, sets the pace).  Where no
    size fits shared memory (a card of little of it), C = 1 with the
    scores in device memory (``shared`` False, ``work_floats`` a row) and
    as many ring slots as fit (0 where fewer than GENERAL_MIN_SLOTS fit:
    the rows are read from device memory).

    :returns: dict of C, threads, shared, nslots, slot_bytes, work_floats,
        smem (dynamic bytes)
    """
    shapes = general_cluster_shapes(K, nbase, optin, esize)
    clusters = H100_CLUSTERS if clusters is None else clusters
    wave = [C for C in shapes if B <= clusters.get(C, 0)]
    if wave or shapes:
        C = max(wave) if wave else min(shapes)
        plan = dict(shapes[C], C=C, shared=True, work_floats=0,
                    slot_bytes=_general_slot_bytes(K // C, esize))
        if not wave:
            plan["smem"] = (FWD_BAR_BYTES + _general_arrays(K, C)
                            + plan["nslots"] * plan["slot_bytes"])
        return plan
    slot = _general_slot_bytes(K, esize)
    nslots = min(GENERAL_MAX_SLOTS, max(0, optin - FWD_BAR_BYTES) // slot)
    nslots = nslots if nslots >= GENERAL_MIN_SLOTS else 0
    return {"C": 1, "threads": min(GENERAL_MAX_THREADS,
                                   max(32, _round(K // nbase, 32))),
            "shared": False, "nslots": nslots, "slot_bytes": slot,
            "work_floats": 2 * _round(K, 4),
            "smem": FWD_BAR_BYTES + nslots * slot}


def _device_limits(dev):
    """(SMs, shared memory a block may opt in to) of a CUDA device."""
    props = torch.cuda.get_device_properties(dev)
    return (props.multi_processor_count,
            getattr(props, "shared_memory_per_block_optin", SMEM_OPTIN))


class ViterbiForward:
    """(vfinal (B, K) float32, traceback (T, B, K) int8) from a
    probability-domain posterior (T, B, K+1) of float32 or bfloat16, column
    0 = stay.  Replaces the Pallas TPU kernels
    ``sloika_tpu/ops/pallas/viterbi.py::_fwd_kernel_sm`` and ``_fwd_kernel``
    with ``csrc/viterbi_fwd.cu``, launched with :func:`viterbi_fwd_plan`."""

    _ARGTYPES = {"viterbi_fwd": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                 + [ctypes.c_float] + [ctypes.c_int] * 5
                 + [ctypes.c_ulonglong, ctypes.c_void_p],
                 "viterbi_fwd_pairs": [ctypes.c_int] * 2 + [ctypes.c_void_p],
                 "viterbi_fwd_general": [ctypes.c_void_p] * 4
                 + [ctypes.c_int] * 4 + [ctypes.c_float]
                 + [ctypes.c_int] * 6 + [ctypes.c_ulonglong,
                                          ctypes.c_void_p],
                 "viterbi_fwd_general_clusters": [ctypes.c_int] * 3
                 + [ctypes.c_void_p]}

    def __init__(self):
        self.launches = 0
        self.general_launches = 0
        self._pairs = {}
        self._clusters = {}

    def pairs(self, K, device):
        """The clusters of the pair route's blocks for K states that the
        card runs at once (queried once for each device and K, at the
        float32 plan: a block of either dtype's plan takes at least half an
        SM's shared memory, so the card holds as many)."""
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

    def general_clusters(self, K, nbase, device):
        """{C: the clusters of C blocks of the general kernel that the card
        runs at once}, at :func:`general_cluster_shapes`' sizes for K states
        over nbase bases (queried once for each device and shape)."""
        optin = _device_limits(device)[1]
        key = (str(device), K, nbase, optin)
        if key not in self._clusters:
            lib = self._library()
            found = {}
            with torch.cuda.device(device):
                for C, shape in general_cluster_shapes(K, nbase,
                                                       optin).items():
                    n = ctypes.c_int(0)
                    cuda_build.check(lib.viterbi_fwd_general_clusters(
                        C, shape["threads"], shape["smem"], ctypes.byref(n)),
                        "viterbi_fwd_general_clusters")
                    found[C] = n.value
            self._clusters[key] = found
        return self._clusters[key]

    def _library(self):
        """The loaded ``viterbi_fwd`` library (``scripts/bench_viterbi.py``
        swaps in its clocked build)."""
        return cuda_build.load("viterbi_fwd", self._ARGTYPES)

    def __call__(self, post, klen, skip_pen=0.0, nbase=4):
        if post.dtype not in POST_DTYPES:
            raise ValueError("viterbi_forward takes a float32 or bfloat16 "
                             "posterior (got {})".format(post.dtype))
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
        cuda_build.check_tensor(post, (T, B, nst), post.dtype, post.device,
                                "post")
        tb = torch.empty((T, B, K), dtype=torch.int8, device=post.device)
        vfinal = torch.empty((B, K), dtype=torch.float32, device=post.device)
        if T == 0 or B == 0:
            return vfinal, tb
        if route == "general":
            self._general(post, tb, vfinal, nbase, skip_pen)
            return vfinal, tb
        esize = post.element_size()
        plan = viterbi_fwd_plan(B, K, *_device_limits(post.device),
                                pairs=self.pairs(K, post.device), esize=esize)
        lib = self._library()
        with torch.cuda.device(post.device):
            err = lib.viterbi_fwd(post.data_ptr(), tb.data_ptr(),
                                  vfinal.data_ptr(), T, B, K,
                                  float(skip_pen), plan["dpt"], plan["G"],
                                  plan["nslots"], plan["smem"], esize,
                                  cuda_build.storage_end(post),
                                  torch.cuda.current_stream().cuda_stream)
        cuda_build.check(err, "viterbi_fwd")
        self.launches += 1
        return vfinal, tb

    def _general(self, post, tb, vfinal, nbase, skip_pen):
        """The general route into ``tb`` and ``vfinal``."""
        T, B, nst = post.shape
        K = nst - 1
        esize = post.element_size()
        plan = viterbi_general_plan(
            B, K, nbase, _device_limits(post.device)[1],
            self.general_clusters(K, nbase, post.device), esize)
        work = None
        if not plan["shared"]:
            work = torch.empty(B * plan["work_floats"], dtype=torch.float32,
                               device=post.device)
        lib = self._library()
        with torch.cuda.device(post.device):
            err = lib.viterbi_fwd_general(
                post.data_ptr(), tb.data_ptr(), vfinal.data_ptr(),
                None if work is None else work.data_ptr(), T, B, K, nbase,
                float(skip_pen), plan["C"], plan["nslots"], plan["threads"],
                plan["smem"], plan["work_floats"], esize,
                cuda_build.storage_end(post),
                torch.cuda.current_stream().cuda_stream)
        cuda_build.check(err, "viterbi_fwd_general")
        self.launches += 1
        self.general_launches += 1


class ViterbiBacktrace:
    """(path (B, T) int32, moved (B, T) bool) from traceback codes
    (T, B, K) int8 and the last state of each row.  Replaces the XLA
    backtrace of ``sloika_tpu/ops/pallas/viterbi.py::_viterbi_impl`` with
    ``csrc/viterbi_back.cu``, launched with :func:`viterbi_back_plan`
    (the general route with :func:`viterbi_back_general_plan`)."""

    _ARGTYPES = {"viterbi_back": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                 + [ctypes.c_void_p],
                 "viterbi_back_general": [ctypes.c_void_p] * 4
                 + [ctypes.c_int] * 8 + [ctypes.c_ulonglong,
                                          ctypes.c_void_p]}

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
            plan = viterbi_back_general_plan(B, K, T, nbase,
                                             *_device_limits(tb.device),
                                             aligned=tb.data_ptr() % 16 == 0)
            if plan["copy"] == "tensor":
                with torch.cuda.device(tb.device):
                    err = self._library().viterbi_back(
                        tb.data_ptr(), last.data_ptr(), path.data_ptr(),
                        moved.data_ptr(), T, B, K, plan["F"],
                        plan["nslots"], plan["smem"],
                        torch.cuda.current_stream().cuda_stream)
                cuda_build.check(err, "viterbi_back (general, tensor copies)")
                self.launches += 1
                self.general_launches += 1
                return path, moved
            with torch.cuda.device(tb.device):
                err = self._library().viterbi_back_general(
                    tb.data_ptr(), last.data_ptr(), path.data_ptr(),
                    moved.data_ptr(), T, B, K, nbase, plan["F"],
                    plan["nslots"], plan["frame_bytes"], plan["smem"],
                    cuda_build.storage_end(tb),
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
