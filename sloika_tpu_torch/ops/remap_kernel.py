"""The banded remap DP on the GPU: the CUDA kernels, their plain twins and
their dispatch (cf. ``sloika_tpu/ops/pallas/remap.py``).

:data:`remap_banded` replaces the Pallas TPU kernel
``sloika_tpu/ops/pallas/remap.py::_banded_kernel`` with
``csrc/remap_banded.cu``: the Viterbi DP over a (B, W) window of sequence
positions that slides along each row's band schedule, writing an int16
traceback of position deltas (0 stay, 1 step, >= 2 slip distance) and the
final window scores.  :data:`remap_backtrack` replaces ``_backtrack_kernel``
with ``csrc/remap_back.cu``: the reverse walk ``pos -= delta``.

Both kernels take their launch plans from Python: :func:`remap_banded_plan`
(consumer warps, positions a thread, the posterior ring's slots, shared
memory) and :func:`remap_back_plan` (frames a slot of the traceback ring,
slots, shared memory).  A window wider than :data:`MAX_W` (the exact DP of
a reference in the 22,145-position bucket takes W = 22,272) goes to
``remap_banded.cu``'s wide route, a cluster of eight blocks a row that
split the window between their registers and shared memories
(:func:`kernel_route`, decided by shape before any build); both wrappers
count launches at such a window in ``wide_launches`` as well as
``launches``.  Past :data:`WIDE_MAX_W` the int16 position deltas cannot
hold a slip (the JAX kernel's float-to-int16 cast saturates there and its
traceback walks to a wrong position), so the plans refuse the window.

Both dispatch on the device of their input: the kernel for a CUDA tensor,
the plain twin (:func:`remap_banded_plain`, :func:`remap_backtrack_plain`)
for a CPU tensor.  ``launches`` counts kernel launches.

The JAX package builds the banded emissions outside its kernel with a
one-hot matmul (``_block_emissions``), a TPU device; here the kernel gathers
them itself from the time-major log-posterior, and the plain twin gathers
them with ``torch.gather``.  The schedule is block-quantised: the window
stays put for ``TB = block_len(W)`` frames, so it moves by ``d in [0, TB]``
at block boundaries only.
"""
import ctypes

import torch

from sloika_tpu_torch import cuda_build
from sloika_tpu_torch.cuda_build import storage_end
from sloika_tpu_torch.nn.fused_gru import SMEM_OPTIN, _round
from sloika_tpu_torch.ops.remap import NEG_LARGE
from sloika_tpu_torch.ops.remap_banded import band_starts

#: the widest window the banded kernel's tuned route takes
MAX_W = 16384
#: the widest window of the wide route, and of both kernels: the largest
#: int16 position delta
WIDE_MAX_W = 32767
#: the wide route: blocks a row (a cluster, the most a portable cluster
#: holds), consumer warps a block at most (with the producer, a block of
#: 512 threads of up to 128 registers), positions a thread, fewest first,
#: and the (positions a thread, block size) instances remap_banded.cu
#: builds for it; its mbarriers and the edges the blocks send each other,
#: ahead of its ring
WIDE_CLUSTER, WIDE_WARPS, WIDE_PPTS = 8, 15, (8, 12)
WIDE_BUILDS = ((8, 512), (12, 512))
WIDE_BAR_BYTES = 512
#: posterior states of the models the port remaps with (the plans' default)
NSTATE = 1025
#: remap_banded.cu: the ring's mbarriers ahead of its slots; the statically
#: allocated shared memory (warp totals and edges, by parity, for up to 32
#: warps); the bytes a window position takes when the window moves (score,
#: prefix max, int16 position)
BANDED_BAR_BYTES, BANDED_STATIC_BYTES, BANDED_POSITION_BYTES = 256, 1280, 10
#: positions a thread the kernel is built for (a template argument, at
#: 256, 512 and 1024 threads a block), and the tiers of consumer warps a
#: block aims at, with the most positions a thread each allows.  A step's
#: fixed work costs a warp ~300 instructions and a position ~35, most of
#: them dependent compares and selects: one warp a scheduler idles on their
#: latency, and more warps hide it but repeat the fixed work (PERF.md §6:
#: 6 x 4 beat 4 x 6, 8 x 3 and 12 x 2 at W = 768; 12 x 8 beat 6 x 16, 8 x
#: 12 and 16 x 6 at W = 3,072)
BANDED_PPTS, BANDED_TIERS = (2, 3, 4, 6, 8, 12, 16), ((6, 8), (12, 16))
#: the (positions a thread, block size) instances remap_banded.cu builds:
#: those the plan can choose (tests/test_torch_remap_kernels.py checks
#: both lists against each other)
BANDED_BUILDS = ((2, 256), (3, 256), (4, 256), (6, 256), (8, 256),
                 (6, 512), (8, 512), (12, 512), (16, 512), (16, 1024))
#: the posterior ring: frames a slot (the consumers wait on a slot's barrier
#: and the producer refills it once every that many steps), and slots,
#: each deepest first
BANDED_ROWS, BANDED_SLOTS = (4, 2, 1), (4, 3, 2)
#: remap_back.cu: frames a slot it is built for, most first
BACK_FRAMES = (16, 8, 4, 2, 1)
#: the longest side of a tensor map's box (elements)
BACK_BOX_LANES = 256
#: its mbarriers (full and empty, 16 each); the bytes a slot of frames is
#: aimed at; the ring's depth at most, and at least
BACK_BAR_BYTES, BACK_SLOT_BYTES, BACK_MAX_SLOTS, BACK_MIN_SLOTS = (
    256, 16384, 16, 2)


def block_len(W):
    """Frames the window stays put for (sloika_tpu/ops/pallas/remap.py:55)."""
    return max(16, min(256, W // 2))


def band_starts_blocked(nframes, npos, T, W, TB):
    """:func:`band_starts` held at its value of each ``TB``-frame block's
    first frame (sloika_tpu/ops/pallas/remap.py:60): (T, B) int32."""
    base = band_starts(nframes, npos, T, W)
    kidx = (torch.arange(T, device=base.device) // TB) * TB
    return base[kidx]


def _check_window(W):
    if not 1 <= W <= WIDE_MAX_W:
        raise ValueError(
            "the remap kernels take a window of 1..{} positions, the widest "
            "whose slips the int16 traceback holds (got W = {})".format(
                WIDE_MAX_W, W))


def kernel_route(W):
    """"tuned" for a window of at most :data:`MAX_W` positions, "wide" up
    to :data:`WIDE_MAX_W`; raises past that.  A shape rule, decided before
    any build."""
    _check_window(W)
    return "tuned" if W <= MAX_W else "wide"


def _ring(arrays, nstate, optin):
    """The deepest posterior ring, (frames a slot, slots), whose slots (each
    frame's 16-byte-aligned superset, ``4 * nstate + 12`` bytes rounded up
    to 16) fit ``optin`` bytes beside ``arrays`` and the static shared
    memory; (1, 0) where none of two slots does."""
    slot_bytes = _round(4 * nstate + 12, 16)
    fits = lambda smem: smem + BANDED_STATIC_BYTES <= optin
    rows, nslots = next(((r, n) for r in BANDED_ROWS for n in BANDED_SLOTS
                         if fits(arrays + n * r * slot_bytes)), (1, 0))
    smem = arrays + nslots * rows * slot_bytes
    return rows, nslots, slot_bytes, smem, fits(smem)


def _store_width(W, ppt):
    return (16 if W % 8 == 0 and ppt % 8 == 0 else
            8 if W % 4 == 0 and ppt % 4 == 0 else
            4 if W % 2 == 0 and ppt % 2 == 0 else 2)


def remap_banded_plan(W, nstate=NSTATE, optin=SMEM_OPTIN):
    """The launch plan of ``remap_banded.cu`` for a window of W positions
    and posterior rows of ``nstate`` states.

    Positions a thread ``ppt``: the fewest of BANDED_PPTS, up to 8, that
    cover W on 6 consumer warps (6 x 4 at W = 768), else the fewest that
    cover it on 12 (12 x 8 at W = 3,072), else 16 on as many warps as W
    needs (at most 32): BANDED_TIERS.

    Then the deepest posterior ring, of slots of ``rows`` frames
    (BANDED_ROWS) and ``nslots`` slots (BANDED_SLOTS), whose frames (each
    row's 16-byte-aligned superset, ``4 * nstate + 12`` bytes rounded up
    to 16) fit ``optin`` bytes beside the moved window's arrays.  A
    producer warp beside the consumers issues the ring's copies, off their
    path, where the block has room for it (below 32 consumer warps; else
    warp 0 issues them).  Where no ring of two slots fits (rows of 16,385
    states at W above 9,976, or of 65,537 at any W), ``nslots`` is 0: the
    consumers gather each frame's emissions from device memory a step
    ahead, and there is no producer.  The traceback goes 16 bytes a store
    where W % 8 == 0 and ppt % 8 == 0, 8 where W % 4 == 0 and ppt % 4 ==
    0, 4 where W is even, else 2.  ``maxt``: the kernel instance's block
    size, the least of 256, 512 and 1,024 threads that holds the block
    (BANDED_BUILDS lists the instances).

    Past :data:`MAX_W`, the wide route's plan (:func:`kernel_route`): a
    cluster of WIDE_CLUSTER blocks a row, each the block above on its share
    of the window (:func:`wide_plan`).

    :returns: dict of route ("tuned" or "wide"), warps (consumers a
        block), producer (0 or 1), threads, maxt, ppt, rows, nslots,
        slot_bytes (a frame's), vec (bytes a traceback store), smem
        (dynamic bytes a block); the wide route also cluster, hb and
        blocks
    """
    if kernel_route(W) == "wide":
        return wide_plan(W, nstate, optin)
    ppt = next((p for aim, most in BANDED_TIERS for p in BANDED_PPTS
                if p <= most and W <= 32 * aim * p), BANDED_PPTS[-1])
    warps = -(-W // (32 * ppt))
    rows, nslots, slot_bytes, smem, fits = _ring(
        BANDED_BAR_BYTES + BANDED_POSITION_BYTES * _round(W, 8), nstate,
        optin)
    if not fits:
        raise ValueError("remap_banded: a window of {} positions does not "
                         "fit {} bytes of shared memory".format(W, optin))
    producer = int(nslots > 0 and warps < 32)
    threads = 32 * (warps + producer)
    maxt = next(m for m in (256, 512, 1024) if threads <= m)
    return {"route": "tuned", "warps": warps, "producer": producer,
            "threads": threads, "maxt": maxt, "ppt": ppt, "rows": rows,
            "nslots": nslots, "slot_bytes": slot_bytes,
            "vec": _store_width(W, ppt), "smem": smem}


def wide_plan(W, nstate=NSTATE, optin=SMEM_OPTIN):
    """The wide route's plan (:func:`remap_banded_plan` past MAX_W): a
    cluster of WIDE_CLUSTER blocks a row, each the tuned block at ``ppt``
    positions a thread (the fewest of WIDE_PPTS that keep a block within
    WIDE_WARPS consumer warps: 8 up to W = 30,720, else 12).  Every block
    but the last holds ``hb`` positions, W / cluster rounded up to whole
    warps (32 ppt), so that no block before the last holds a position past
    its own; the last holds the rest (``blocks``: the positions of each).  Each has ``hb / (32
    ppt)`` consumer warps, the moved window's arrays of ``hb`` positions
    and a ring as the tuned plan sets it; ``maxt``: the least block size of
    WIDE_BUILDS at ``ppt`` that holds the block.  Raises where a block's
    arrays do not fit.  At W = 22,272: 8 blocks of 2,816 positions, 11
    warps x 8."""
    cluster = WIDE_CLUSTER
    ppt = next((p for p in WIDE_PPTS if _round(-(-W // cluster), 32 * p)
                <= 32 * p * WIDE_WARPS), WIDE_PPTS[-1])
    hb = _round(-(-W // cluster), 32 * ppt)
    warps = hb // (32 * ppt)
    rows, nslots, slot_bytes, smem, fits = _ring(
        WIDE_BAR_BYTES + BANDED_POSITION_BYTES * hb, nstate, optin)
    # the producer warp also sends the block's edge to the blocks after it
    threads = 32 * (warps + 1)
    maxt = next((m for p, m in WIDE_BUILDS if p == ppt and threads <= m),
                None)
    if not fits or maxt is None or (cluster - 1) * hb >= W:
        raise ValueError("remap_banded: a window of {} positions over a "
                         "cluster of {} blocks of {} positions, {} a thread, "
                         "does not fit {} bytes of shared memory".format(
                             W, cluster, hb, ppt, optin))
    return {"route": "wide", "cluster": cluster, "hb": hb,
            "blocks": (hb,) * (cluster - 1) + (W - (cluster - 1) * hb,),
            "warps": warps, "producer": 1, "threads": threads,
            "maxt": maxt, "ppt": ppt, "rows": rows, "nslots": nslots,
            "slot_bytes": slot_bytes, "vec": _store_width(W, ppt),
            "smem": smem}


def remap_back_plan(W, optin=SMEM_OPTIN):
    """The launch plan of ``remap_back.cu`` for a window of W positions.

    The traceback streams through a ring of slots of K frames.  Two copy
    forms: one box a slot of a 4-D tensor map over the traceback
    ("tensor": the lanes split as ``inner`` x W / inner, each at most
    BACK_BOX_LANES, as a box's sides must be; the map's strides need W % 8
    == 0), or one bulk copy a frame ("bulk rows": each row's
    16-byte-aligned superset, ``2 * W + 14`` bytes rounded up to 16).  The
    copier issues a slot's copies one after another (PERF.md §6: ~100
    cycles a copy), so the tensor form is taken wherever W allows it.  K:
    the most of BACK_FRAMES (the kernel is built for each) in
    BACK_SLOT_BYTES; then the deepest ring up to BACK_MAX_SLOTS that fits
    ``optin`` bytes.

    :returns: dict of K, nslots, copy ("tensor" or "bulk rows"), inner
        (the box's innermost side; 0 for bulk rows), frame_bytes,
        slot_bytes (K frames, 128-byte aligned for a box), smem (dynamic
        bytes)
    """
    _check_window(W)
    inner = next((i for i in range(BACK_BOX_LANES, 0, -8)
                  if W % 8 == 0 and W % i == 0
                  and W // i <= BACK_BOX_LANES), 0)
    if inner:
        copy, frame_bytes = "tensor", 2 * W
    else:
        copy, frame_bytes = "bulk rows", _round(2 * W + 14, 16)
    K = next(k for k in BACK_FRAMES
             if k == 1 or k * frame_bytes <= BACK_SLOT_BYTES)
    slot_bytes = _round(K * frame_bytes, 128) if inner else K * frame_bytes
    nslots = min(BACK_MAX_SLOTS, (optin - BACK_BAR_BYTES) // slot_bytes)
    if nslots < BACK_MIN_SLOTS:
        raise ValueError("remap_back: a window of {} positions does not fit "
                         "{} bytes of shared memory".format(W, optin))
    return {"K": K, "nslots": nslots, "copy": copy, "inner": inner,
            "frame_bytes": frame_bytes, "slot_bytes": slot_bytes,
            "smem": BACK_BAR_BYTES + nslots * slot_bytes}


def _step_inputs_plain(ltrans_t, seq_states, pos_mask, starts, t, W, neg):
    """Step ``t``'s inputs of the banded DP (sloika_tpu/ops/pallas/
    remap.py:290-306 and ``_block_emissions`` :215, by gather), one step at
    a time so that no (Tp, B, W) index tensor is built.

    Frames ``t >= T`` (up to ``Tp``, the length of ``starts``) are stays:
    NEG emissions and stay score 0.

    :returns: (emit (B, W) f32, stay (B,) f32, valid (B, W) bool, idx (B, W)
        int64 positions clamped to the sequence)
    """
    T, B, _ = ltrans_t.shape
    P = seq_states.shape[1]
    pos = starts[t].long()[:, None] + torch.arange(W, device=starts.device)
    idx = pos.clamp(0, P - 1)
    valid = torch.gather(pos_mask, 1, idx) & (pos < P)
    if t < T:
        seq_w = torch.gather(seq_states, 1, idx).long()
        emit = torch.where(valid, torch.gather(ltrans_t[t], 1, seq_w), neg)
        stay = ltrans_t[t, :, 0]
    else:
        emit = torch.full((B, W), NEG_LARGE, dtype=torch.float32,
                          device=ltrans_t.device)
        stay = torch.zeros((B,), dtype=torch.float32, device=ltrans_t.device)
    return emit, stay, valid, idx


def _slip_prefix_max(y, lane, W, neg):
    """Running max of each row of ``y`` and its position, the earlier
    position winning ties: the Hillis-Steele scan of ``_banded_kernel``
    (sloika_tpu/ops/pallas/remap.py:92-101).  Where every value up to a
    position is ``neg``, its position wraps in from the far end of the
    row; such a slip source never wins (tests/test_torch_remap.py)."""
    yi = lane
    k = 1
    while k < W:
        y_s = torch.where(lane >= k, torch.roll(y, k, 1), neg)
        yi_s = torch.roll(yi, k, 1)
        earlier = y_s >= y
        y = torch.where(earlier, y_s, y)
        yi = torch.where(earlier, yi_s, yi)
        k *= 2
    return y, yi


def remap_banded_plain(ltrans_t, seq_states, pos_mask, prior_initial, starts,
                       slip, W):
    """The banded DP, line for line as ``_banded_kernel``
    (sloika_tpu/ops/pallas/remap.py:69-154), ``torch.roll`` standing in for
    ``pltpu.roll``.

    :param ltrans_t: (T, B, nstate) f32 time-major log posteriors
    :param seq_states: (B, P) int32;  :param pos_mask: (B, P) bool
    :param prior_initial: (B, P) f32;  :param starts: (Tp, B) int32 window
        starts, constant within ``block_len(W)``-frame blocks
    :returns: (traceback (Tp, B, W) int16, vfinal (B, W) f32)
    """
    Tp, B = starts.shape
    P = seq_states.shape[1]
    TB = block_len(W)
    nbits = 0 if W >= P else max(int(TB).bit_length(), 1)
    dev = ltrans_t.device
    neg = torch.tensor(NEG_LARGE, dtype=torch.float32, device=dev)
    slip = torch.tensor(slip, dtype=torch.float32, device=dev)
    lane = torch.arange(W, dtype=torch.int32, device=dev).expand(B, W)
    lanef = lane.to(torch.float32)

    traceback = torch.empty((Tp, B, W), dtype=torch.int16, device=dev)
    traceback[0] = 0
    # t = 0: the DP initialisation prior_initial + fmax(emit_0, stay_0) on
    # valid lanes (sloika_tpu/ops/pallas/remap.py:311-315)
    emit0, stay0, _, idx0 = _step_inputs_plain(ltrans_t, seq_states,
                                               pos_mask, starts, 0, W, neg)
    p = torch.where(emit0 > neg * 0.5,
                    torch.gather(prior_initial, 1, idx0)
                    + torch.fmax(emit0, stay0[:, None]), neg)
    for t in range(1, Tp):
        emit, stay, valid, _ = _step_inputs_plain(
            ltrans_t, seq_states, pos_mask, starts, t, W, neg)
        # slip prefix max in the previous window's coordinates
        y, yi = _slip_prefix_max(p + slip * lanef, lane, W, neg)
        z = torch.where(lane >= 2, torch.roll(y, 2, 1), neg)
        zi = torch.roll(yi, 2, 1)

        # shift into the new window by the row's jump d
        dt = (starts[t] - starts[t - 1])[:, None]
        q = p
        for bit in range(nbits):
            s = 1 << bit
            hit = (dt & s) > 0
            q = torch.where(hit, torch.where(lane >= W - s, neg,
                                             torch.roll(q, W - s, 1)), q)
            z = torch.where(hit, torch.where(lane >= W - s, neg,
                                             torch.roll(z, W - s, 1)), z)
            zi = torch.where(hit, torch.roll(zi, W - s, 1), zi)
        qm1 = torch.where(lane == 0, neg, torch.roll(q, 1, 1))

        # stay, then step, then slip, each under strict >
        cs = q + stay[:, None]
        delta = torch.zeros((B, W), dtype=torch.float32, device=dev)
        score_step = qm1 + emit
        take = score_step > cs
        cs = torch.where(take, score_step, cs)
        delta = torch.where(take, 1.0, delta)

        fs = z - slip * (lanef - 1.0 + dt.to(torch.float32))
        score_slip = fs + emit
        take = score_slip > cs
        delta = torch.where(take, (lane + dt - zi).to(torch.float32), delta)
        cs = torch.where(take, score_slip, cs)

        p = torch.where(valid, cs, neg)
        traceback[t] = delta.to(torch.int16)
    return traceback, p


def remap_backtrack_plain(traceback, starts, last):
    """Reverse traceback, as ``_backtrack_kernel``
    (sloika_tpu/ops/pallas/remap.py:161-212): ``path[Tp-1] = last`` and
    ``path[t-1] = path[t] - traceback[t, b, clip(path[t] - starts[t])]``.

    :returns: path (Tp, B) int32 absolute positions
    """
    Tp, B, W = traceback.shape
    path = torch.empty((Tp, B), dtype=torch.int32, device=traceback.device)
    pos = last.to(torch.int32)
    path[Tp - 1] = pos
    for t in range(Tp - 1, 0, -1):
        rel = torch.clamp(pos - starts[t], 0, W - 1).long()
        delta = torch.gather(traceback[t], 1, rel[:, None])[:, 0]
        pos = pos - delta.to(torch.int32)
        path[t - 1] = pos
    return path


class RemapBanded:
    """(traceback (Tp, B, W) int16, vfinal (B, W) f32) of the banded DP.
    Replaces the Pallas TPU kernel ``sloika_tpu/ops/pallas/remap.py::
    _banded_kernel`` with ``csrc/remap_banded.cu``; runs
    :func:`remap_banded_plain` for CPU tensors.  A window wider than
    :data:`MAX_W` takes the wide route, a cluster of eight blocks a row
    (counted in ``wide_launches``); where the card cannot run such a
    cluster, it raises with the plan named."""

    #: the widest window the kernel takes (:func:`remap_banded_plan`)
    MAX_W = WIDE_MAX_W

    _ARGTYPES = {"remap_banded": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                 + [ctypes.c_float] + [ctypes.c_int] * 8
                 + [ctypes.c_ulonglong, ctypes.c_void_p],
                 "remap_banded_wide": [ctypes.c_void_p] * 7
                 + [ctypes.c_int] * 6 + [ctypes.c_float]
                 + [ctypes.c_int] * 10 + [ctypes.c_ulonglong,
                                           ctypes.c_void_p],
                 "remap_banded_wide_clusters": [ctypes.c_int] * 5
                 + [ctypes.c_void_p]}

    def __init__(self):
        self.launches = 0
        self.wide_launches = 0
        self._clusters = {}

    def _library(self):
        return cuda_build.load("remap_banded", self._ARGTYPES)

    def wide_clusters(self, plan, device):
        """The clusters of the wide plan's blocks that the card runs at
        once (queried once for each device and plan); raises, naming the
        plan, where it runs none."""
        key = (str(device), plan["cluster"], plan["ppt"], plan["maxt"],
               plan["threads"], plan["smem"])
        if key not in self._clusters:
            n = ctypes.c_int(0)
            with torch.cuda.device(device):
                cuda_build.check(self._library().remap_banded_wide_clusters(
                    plan["cluster"], plan["ppt"], plan["maxt"],
                    plan["threads"], plan["smem"], ctypes.byref(n)),
                    "remap_banded_wide_clusters")
            if n.value < 1:
                raise RuntimeError("remap_banded: the card runs no cluster "
                                   "of the wide plan {}".format(plan))
            self._clusters[key] = n.value
        return self._clusters[key]

    def __call__(self, ltrans_t, seq_states, pos_mask, prior_initial, starts,
                 slip, W):
        if ltrans_t.device.type == "cpu":
            return remap_banded_plain(ltrans_t, seq_states, pos_mask,
                                      prior_initial, starts, slip, W)
        route = kernel_route(W)
        T, B, nstate = ltrans_t.shape
        P = seq_states.shape[1]
        Tp = starts.shape[0]
        dev = ltrans_t.device
        if Tp < T or T < 1:
            raise ValueError("starts must cover the {} frames (got {})"
                             .format(T, Tp))
        cuda_build.check_tensor(ltrans_t, (T, B, nstate), torch.float32, dev,
                                "ltrans_t")
        cuda_build.check_tensor(seq_states, (B, P), torch.int32, dev,
                                "seq_states")
        cuda_build.check_tensor(pos_mask, (B, P), torch.bool, dev,
                                "pos_mask")
        cuda_build.check_tensor(prior_initial, (B, P), torch.float32, dev,
                                "prior_initial")
        cuda_build.check_tensor(starts, (Tp, B), torch.int32, dev, "starts")
        traceback = torch.empty((Tp, B, W), dtype=torch.int16, device=dev)
        vfinal = torch.empty((B, W), dtype=torch.float32, device=dev)
        if B == 0:
            return traceback, vfinal
        plan = remap_banded_plan(W, nstate)
        lib = self._library()
        if route == "wide":
            self.wide_clusters(plan, dev)
            with torch.cuda.device(dev):
                err = lib.remap_banded_wide(
                    ltrans_t.data_ptr(), seq_states.data_ptr(),
                    pos_mask.data_ptr(), prior_initial.data_ptr(),
                    starts.data_ptr(), traceback.data_ptr(),
                    vfinal.data_ptr(), T, B, nstate, P, W, Tp, float(slip),
                    plan["hb"], plan["cluster"], plan["warps"],
                    plan["producer"], plan["ppt"], plan["maxt"],
                    plan["rows"], plan["nslots"], plan["vec"],
                    plan["smem"], storage_end(ltrans_t),
                    torch.cuda.current_stream().cuda_stream)
            cuda_build.check(err, "remap_banded_wide (plan {})".format(plan))
            self.launches += 1
            self.wide_launches += 1
            return traceback, vfinal
        with torch.cuda.device(dev):
            err = lib.remap_banded(
                ltrans_t.data_ptr(), seq_states.data_ptr(),
                pos_mask.data_ptr(), prior_initial.data_ptr(),
                starts.data_ptr(), traceback.data_ptr(), vfinal.data_ptr(),
                T, B, nstate, P, W, Tp, float(slip), plan["warps"],
                plan["producer"], plan["maxt"], plan["ppt"], plan["rows"],
                plan["nslots"],
                plan["vec"], plan["smem"],
                storage_end(ltrans_t),
                torch.cuda.current_stream().cuda_stream)
        cuda_build.check(err, "remap_banded")
        self.launches += 1
        return traceback, vfinal


class RemapBacktrack:
    """path (Tp, B) int32 from the banded DP's traceback, window starts and
    each row's last position.  Replaces the Pallas TPU kernel
    ``sloika_tpu/ops/pallas/remap.py::_backtrack_kernel`` with
    ``csrc/remap_back.cu``; runs :func:`remap_backtrack_plain` for CPU
    tensors.  One kernel at every window; launches at a window wider than
    :data:`MAX_W` (the banded DP's wide route) are also counted in
    ``wide_launches``."""

    _ARGTYPES = {"remap_back": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                 + [ctypes.c_ulonglong, ctypes.c_void_p]}

    def __init__(self):
        self.launches = 0
        self.wide_launches = 0

    def _library(self):
        return cuda_build.load("remap_back", self._ARGTYPES)

    def __call__(self, traceback, starts, last):
        if traceback.device.type == "cpu":
            return remap_backtrack_plain(traceback, starts, last)
        Tp, B, W = traceback.shape
        dev = traceback.device
        cuda_build.check_tensor(traceback, (Tp, B, W), torch.int16, dev,
                                "traceback")
        cuda_build.check_tensor(starts, (Tp, B), torch.int32, dev, "starts")
        last = last.to(torch.int32).contiguous()
        cuda_build.check_tensor(last, (B,), torch.int32, dev, "last")
        path = torch.empty((Tp, B), dtype=torch.int32, device=dev)
        if Tp == 0 or B == 0:
            return path
        plan = remap_back_plan(W)
        lib = self._library()
        with torch.cuda.device(dev):
            err = lib.remap_back(traceback.data_ptr(), starts.data_ptr(),
                                 last.data_ptr(), path.data_ptr(), Tp, B, W,
                                 plan["K"], plan["nslots"], plan["inner"],
                                 plan["smem"], storage_end(traceback),
                                 torch.cuda.current_stream().cuda_stream)
        cuda_build.check(err, "remap_back")
        self.launches += 1
        if kernel_route(W) == "wide":
            self.wide_launches += 1
        return path


#: the banded DP entry point (kernel on CUDA, plain twin on the CPU)
remap_banded = RemapBanded()

#: the traceback entry point (kernel on CUDA, plain twin on the CPU)
remap_backtrack = RemapBacktrack()


def map_to_sequence_banded(ltrans_t, seq_states, slip, prior_initial,
                           prior_final, pos_mask, nframes, npos, W):
    """Banded Viterbi alignment through :data:`remap_banded` and
    :data:`remap_backtrack` (sloika_tpu/ops/pallas/remap.py:258-365 with
    ``time_major=True``).  With ``W >= P`` the window covers every position
    and this is the exact DP.

    :param ltrans_t: (T, B, nstate) f32 log posteriors, column 0 = stay
    :param seq_states: (B, P) int32 emission state per position
    :param slip: slip penalty (>= 0)
    :param prior_initial, prior_final: (B, P) f32 log position priors
    :param pos_mask: (B, P) bool, True for real positions
    :param nframes, npos: (B,) true frame and sequence lengths
    :param W: window width (guaranteed band: ``W - block_len(W)``)
    :returns: (score (B,) f32, path (B, T) int32 absolute positions)
    """
    T = ltrans_t.shape[0]
    TB = block_len(W)
    Tp = -(-T // TB) * TB                 # whole blocks; the rest are stays
    starts = band_starts_blocked(nframes, npos, Tp, W, TB)
    traceback, vfinal = remap_banded(ltrans_t, seq_states, pos_mask,
                                     prior_initial, starts, slip, W)
    score, path = finish_banded(traceback, vfinal, starts, prior_final,
                                remap_backtrack)
    return score, path[:T].t()


def finish_banded(traceback, vfinal, starts, prior_final, backtrack):
    """Score and path from the banded DP's outputs
    (sloika_tpu/ops/pallas/remap.py:352-364): the final-position prior, the
    best end position (the first of equal maxima), and the backtrace from
    it by ``backtrack`` (:data:`remap_backtrack` or its plain twin).  The
    trailing pad frames are stays, which change neither scores nor the
    final position.

    :returns: (score (B,) f32, path (Tp, B) int32 absolute positions)
    """
    Tp, B, W = traceback.shape
    P = prior_final.shape[1]
    dev = traceback.device
    s_last = starts[Tp - 1]
    warange = torch.arange(W, device=dev)
    p1_w = torch.gather(prior_final, 1,
                        (s_last.long()[:, None] + warange).clamp(0, P - 1))
    pscore = vfinal + p1_w
    last_w = torch.argmax(pscore, dim=1)          # first of equal maxima
    score = pscore[torch.arange(B, device=dev), last_w]
    last = s_last + last_w.to(torch.int32)
    return score, backtrack(traceback, starts, last)
