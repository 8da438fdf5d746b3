"""Peephole LSTM recurrence: the CUDA kernels, their plain PyTorch twins and
the autograd function that joins them.

:data:`lstm_forward` replaces the Pallas TPU kernels
``sloika_tpu/nn/pallas_lstm.py::_fwd_kernel`` and ``_fwd_kernel_nocout``
(through ``_fwd_step``, driven by ``_pallas_scan``) with ``csrc/lstm_fwd.cu``,
and, at S above MAX_SIZE (inference only), with ``csrc/lstm_fwd_wide.cu``:
a cluster of blocks that split the gate columns, each keeping its slice of
the recurrent weights on chip and sharing h over distributed shared memory.
:data:`lstm_backward` replaces the VJP kernel ``_bwd_kernel`` (driven by
``_pallas_scan_bwd``) with two: ``csrc/lstm_bwd.cu``, the reverse-time
recurrence, and ``csrc/lstm_wgrad.cu`` (:data:`lstm_wgrad`), the
recurrent-weight and peephole cotangents summed over the T*B rows.  The
input projection ``x @ iW.T + b`` stays a ``torch.matmul`` outside the
kernels, as the JAX package leaves it to XLA.

Unlike the Pallas kernels, which recompute the gates in the backward, the
forward's training variant (``emit_gates``) also writes the gate trace
``[u, i, f, o]`` (T, B, 4S) and the backward reads it (``lstm_bwd.cu``
says why); :class:`LstmFunction` asks for it only when a gradient is
needed.

Contract (all versions; ``_gates``/``_fwd_step``): over ``xp`` (T, B, 4S)
float32, the recurrent weights ``sWT`` (S, 4S) and the peepholes ``p``
(3, S), gate order 0 candidate, 1 input, 2 forget, 3 output::

    g    = xp_t + h @ sWT
    f    = sigmoid(g2 + c * p[1]);  i = sigmoid(g1 + c * p[0])
    c'   = c * f + tanh(g0) * i
    o    = sigmoid(g3 + c' * p[2])
    h'   = tanh(c') * o

A masked step keeps and emits the carried (h, c); ``reverse`` scans from
the last step to the first.  The forward returns h (T, B, S) and, when
asked, the cell trace c (T, B, S) that only the backward reads; the
backward carries the state cotangents straight through masked steps and
gives them zero ``dxp``.
"""
import ctypes
import itertools

import torch

from sloika_tpu_torch import cuda_build
from sloika_tpu_torch.nn.fused_gru import (H100_CLUSTERS, H100_SMS,
                                           SMEM_OPTIN, _round, _rows_a_block,
                                           h_prev_of)

#: the backward kernels' limit on S (and the forward's traces'): a block
#: has 4S threads (at most 1,024)
MAX_SIZE = 256
#: the forward's limit on S: past MAX_SIZE a cluster of blocks splits the
#: gate columns (the "wide" route, ``csrc/lstm_fwd_wide.cu``, inference
#: only)
FWD_MAX_SIZE = 384


def _gates(lp, h, c, sWT, p):
    """Forward gate computation shared by both twins (``_gates`` :36-49)."""
    S = p.shape[1]
    sumW = lp + h @ sWT
    g0 = sumW[:, :S]
    g1 = sumW[:, S:2 * S]
    g2 = sumW[:, 2 * S:3 * S]
    g3 = sumW[:, 3 * S:]
    f = torch.sigmoid(g2 + c * p[1:2])
    i = torch.sigmoid(g1 + c * p[0:1])
    u = torch.tanh(g0)
    c_new = c * f + u * i
    o = torch.sigmoid(g3 + c_new * p[2:3])
    return f, i, u, c_new, o


def lstm_scan_plain(xp, sWT, p, mask, reverse=False, emit_cout=True,
                    emit_gates=False):
    """The plain twin of the forward: a Python loop over time of eager
    torch ops that follows ``_fwd_step`` (:52-66).

    :param emit_gates: also return the gate trace ``[u, i, f, o]``
        (T, B, 4S) of every step, masked ones included (needs ``emit_cout``)
    :returns: (h (T, B, S), c (T, B, S) or None), and the gate trace with
        ``emit_gates``
    """
    if emit_gates and not emit_cout:
        raise ValueError("the gate trace comes with the cell trace")
    T, B, S4 = xp.shape
    S = S4 // 4
    h = xp.new_zeros((B, S))
    c = xp.new_zeros((B, S))
    hout = xp.new_empty((T, B, S))
    cout = xp.new_empty((T, B, S)) if emit_cout else None
    gates = xp.new_empty((T, B, S4)) if emit_gates else None
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        f, i, u, c_new, o = _gates(xp[t], h, c, sWT, p)
        if emit_gates:
            gates[t] = torch.cat([u, i, f, o], dim=1)
        h_new = torch.tanh(c_new) * o
        m = mask[t][:, None]
        h = torch.where(m, h_new, h)
        c = torch.where(m, c_new, c)
        hout[t] = h
        if emit_cout:
            cout[t] = c
    return (hout, cout, gates) if emit_gates else (hout, cout)


def lstm_scan_bwd_plain(xp, sWT, p, mask, reverse, g, h_out, c_out):
    """The plain twin of the backward: a Python loop over time that follows
    ``pallas_lstm.py::_bwd_kernel`` (:133-169) line for line.

    :param g: (T, B, S) cotangent of the forward's output ``h_out``
    :returns: (dxp (T, B, 4S), dsWT (S, 4S), dp (3, S))
    """
    T, B, S4 = xp.shape
    S = S4 // 4
    h_prev = h_prev_of(h_out, reverse)
    c_prev = h_prev_of(c_out, reverse)
    sW = sWT.t()
    dh = xp.new_zeros((B, S))
    dc = xp.new_zeros((B, S))
    dxp = xp.new_empty((T, B, S4))
    dsWT = xp.new_zeros((S, S4))
    dp = xp.new_zeros((3, S))
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        hp, cp = h_prev[t], c_prev[t]
        m = mask[t][:, None]
        f, i, u, c_new, o = _gates(xp[t], hp, cp, sWT, p)
        tc = torch.tanh(c_new)

        dht = dh + g[t]
        dct = dc
        dh_eff = torch.where(m, dht, torch.zeros_like(dht))
        dc_eff = torch.where(m, dct, torch.zeros_like(dct))

        do = dh_eff * tc
        dg3 = do * o * (1 - o)
        dcn = dc_eff + dh_eff * o * (1 - tc * tc) + dg3 * p[2:3]
        du = dcn * i
        dg0 = du * (1 - u * u)
        di = dcn * u
        dg1 = di * i * (1 - i)
        df = dcn * cp
        dg2 = df * f * (1 - f)
        dg = torch.cat([dg0, dg1, dg2, dg3], dim=1)

        dc_prev = dcn * f + dg1 * p[0:1] + dg2 * p[1:2]
        dh_prev = dg @ sW
        # masked steps copied (h, c) through: cotangents flow straight back
        zero = torch.zeros_like(dht)
        dh = dh_prev + torch.where(m, zero, dht)
        dc = dc_prev + torch.where(m, zero, dct)

        dxp[t] = torch.where(m, dg, torch.zeros_like(dg))
        dsWT += hp.t() @ dg
        dp[0] += torch.sum(dg1 * cp, dim=0)
        dp[1] += torch.sum(dg2 * cp, dim=0)
        dp[2] += torch.sum(dg3 * c_new, dim=0)
    return dxp, dsWT, dp


def lstm_scan_bwd_gates_plain(gates, sWT, p, mask, reverse, g, h_out,
                              c_out):
    """The plain twin of ``lstm_bwd.cu`` with ``lstm_wgrad``: the backward
    of :func:`lstm_scan_bwd_plain` from the forward's gate trace instead of
    a recompute (the same arithmetic in the same order; ``tanh(c')`` from
    the cell trace, which holds c' at every valid step).

    :param gates: (T, B, 4S) ``[u, i, f, o]`` from ``lstm_scan_plain(...,
        emit_gates=True)`` or the kernel's training variant
    :returns: (dxp (T, B, 4S), dsWT (S, 4S), dp (3, S))
    """
    T, B, S4 = gates.shape
    S = S4 // 4
    h_prev = h_prev_of(h_out, reverse)
    c_prev = h_prev_of(c_out, reverse)
    sW = sWT.t()
    dh = gates.new_zeros((B, S))
    dc = gates.new_zeros((B, S))
    dxp = gates.new_empty((T, B, S4))
    dsWT = gates.new_zeros((S, S4))
    dp = gates.new_zeros((3, S))
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        hp, cp = h_prev[t], c_prev[t]
        m = mask[t][:, None]
        u, i, f, o = gates[t].split(S, dim=1)
        c_new = c_out[t]
        tc = torch.tanh(c_new)

        dht = dh + g[t]
        dct = dc
        dh_eff = torch.where(m, dht, torch.zeros_like(dht))
        dc_eff = torch.where(m, dct, torch.zeros_like(dct))

        do = dh_eff * tc
        dg3 = do * o * (1 - o)
        dcn = dc_eff + dh_eff * o * (1 - tc * tc) + dg3 * p[2:3]
        du = dcn * i
        dg0 = du * (1 - u * u)
        di = dcn * u
        dg1 = di * i * (1 - i)
        df = dcn * cp
        dg2 = df * f * (1 - f)
        dg = torch.cat([dg0, dg1, dg2, dg3], dim=1)

        dc_prev = dcn * f + dg1 * p[0:1] + dg2 * p[1:2]
        dh_prev = dg @ sW
        zero = torch.zeros_like(dht)
        dh = dh_prev + torch.where(m, zero, dht)
        dc = dc_prev + torch.where(m, zero, dct)

        dxp[t] = torch.where(m, dg, torch.zeros_like(dg))
        dsWT += hp.t() @ dg
        dp[0] += torch.sum(dg1 * cp, dim=0)
        dp[1] += torch.sum(dg2 * cp, dim=0)
        dp[2] += torch.sum(dg3 * c_new, dim=0)
    return dxp, dsWT, dp


def lstm_wgrad_plain(h_out, c_out, dxp, reverse):
    """The plain twin of ``lstm_wgrad.cu``: the recurrent-weight and
    peephole cotangents as einsums over the T*B rows.

    :param dxp: (T, B, 4S) the backward's input cotangent, zero at masked
        steps
    :returns: (dsWT (S, 4S), dp (3, S))
    """
    S = h_out.shape[2]
    h_prev = h_prev_of(h_out, reverse)
    c_prev = h_prev_of(c_out, reverse)
    dsWT = torch.einsum("tbi,tbj->ij", h_prev, dxp)
    dp = torch.stack([
        torch.einsum("tbs,tbs->s", dxp[:, :, S:2 * S], c_prev),
        torch.einsum("tbs,tbs->s", dxp[:, :, 2 * S:3 * S], c_prev),
        torch.einsum("tbs,tbs->s", dxp[:, :, 3 * S:], c_out)])
    return dsWT, dp


def _check_lstm_shapes(xp, sWT, p, mask, limit, what):
    T, B, S4 = xp.shape
    S = S4 // 4
    dev = xp.device
    if not 0 < S <= limit or S4 != 4 * S:
        raise ValueError("LSTM size {} outside the {}' 1..{}".format(
            S4 / 4, what, limit))
    cuda_build.check_tensor(xp, (T, B, S4), torch.float32, dev, "xp")
    cuda_build.check_tensor(sWT, (S, S4), torch.float32, dev, "sWT")
    cuda_build.check_tensor(p, (3, S), torch.float32, dev, "p")
    if tuple(mask.shape) != (T, B) or mask.device != dev:
        raise ValueError("mask must be (T, B) on {}".format(dev))
    return T, B, S


#: the forward kernel's register mode (``csrc/lstm_fwd.cu``): a lane holds
#: its column's FWD_REGISTER_KQ weights, for S from FWD_REGISTER_MIN_S to
#: FWD_REGISTER_KQ (below it sWT is staged)
FWD_REGISTER_KQ = 64
FWD_REGISTER_MIN_S = 33
#: bytes of the forward's mask window (steps x rows a block, a byte each),
#: largest first: 16 KB holds all of an event read's 9,000 steps at one row
#: a block
FWD_MASK_WINDOWS = (16384, 4096, 1024)
#: the forward's xp ring: its mbarriers' bytes, then slots of BR x 4S floats
FWD_BAR_BYTES = 64
#: the wide route (``lstm_fwd_wide.cu``): blocks a cluster, states a block
#: (S padded to their product), k groups (warps) a block, rows a chunk (the
#: unit of its exchange), chunks a step at most, the mbarriers' bytes
WIDE_CLUSTER, WIDE_STATES, WIDE_GROUPS = 16, 24, 12
WIDE_CHUNK_ROWS, WIDE_MAX_CHUNKS, WIDE_BAR_BYTES = 8, 12, 192
#: its threads: a warp a k group
WIDE_THREADS = 32 * WIDE_GROUPS


def wide_smem(rows):
    """Shared-memory bytes of the wide route at ``rows`` rows a cluster
    (rounded up to chunks): the barriers, h of every block's states, two
    staging buffers and c of the block's own, a chunk's xp, and two
    chunks' partial sums of its k groups."""
    rp = _round(rows, WIDE_CHUNK_ROWS)
    chunk = WIDE_CHUNK_ROWS * 4 * WIDE_STATES
    return WIDE_BAR_BYTES + 4 * (rp * WIDE_STATES * (WIDE_CLUSTER + 3)
                                 + chunk + 2 * WIDE_GROUPS * chunk)


def wide_rows(optin=SMEM_OPTIN):
    """The most rows a cluster of the wide route takes: whole chunks whose
    shared memory fits ``optin`` bytes, at most WIDE_MAX_CHUNKS."""
    fits = [n * WIDE_CHUNK_ROWS for n in range(1, WIDE_MAX_CHUNKS + 1)
            if wide_smem(n * WIDE_CHUNK_ROWS) <= optin]
    if not fits:
        raise ValueError("the wide route does not fit {} bytes of shared "
                         "memory".format(optin))
    return fits[-1]


def lstm_fwd_wide_plan(B, S, optin=SMEM_OPTIN, clusters=None):
    """The launch plan of ``lstm_fwd_wide.cu`` (S above MAX_SIZE) for a
    batch of B rows.

    ``clusters``: the clusters of WIDE_CLUSTER blocks the card runs at once
    (:meth:`LstmForward.wide_clusters` asks the card; default
    H100_CLUSTERS').  Rows a cluster at most: :func:`wide_rows`.  The batch
    takes the fewest waves of those clusters that hold it, spread evenly:
    ``rows`` = ceil(B / clusters launched), and as many clusters as B needs
    at that.  A function of (B, S, optin, clusters) alone.

    :returns: dict of mode ("cluster"), cluster, rows, clusters, chunks,
        smem (bytes), threads
    """
    if not MAX_SIZE < S <= FWD_MAX_SIZE or B < 1:
        raise ValueError("the wide route takes S {}..{} and B >= 1 (got S "
                         "{}, B {})".format(MAX_SIZE + 1, FWD_MAX_SIZE, S, B))
    active = H100_CLUSTERS[WIDE_CLUSTER] if clusters is None else clusters
    if active < 1:
        raise ValueError("the card runs no cluster of the wide route")
    waves = -(-B // (active * wide_rows(optin)))
    rows = -(-B // min(B, active * waves))
    return {"mode": "cluster", "cluster": WIDE_CLUSTER, "rows": rows,
            "clusters": -(-B // rows),
            "chunks": -(-rows // WIDE_CHUNK_ROWS), "smem": wide_smem(rows),
            "threads": WIDE_THREADS}


def lstm_fwd_plan(B, S, sms=H100_SMS, optin=SMEM_OPTIN, clusters=None):
    """The launch plan of ``lstm_fwd.cu`` for a batch of B rows of width S,
    or past MAX_SIZE that of ``lstm_fwd_wide.cu`` (:func:`lstm_fwd_wide_plan`
    with ``clusters``).

    Rows a block ``br``: the fewest of 1, 2, 4, 8 that fit the batch in one
    wave over ``sms`` SMs.  Then the first of these that fits ``optin``
    bytes of shared memory with an xp ring ``ns`` of 4 step slots (the
    copies run 3 steps ahead), else 3, else 2, and the largest mask window
    of FWD_MASK_WINDOWS: sWT's columns in registers ("registers", S from
    FWD_REGISTER_MIN_S to FWD_REGISTER_KQ); sWT staged ("smem"); sWT read
    from global memory ("global").

    :returns: dict of br, mode, kq, stage, ns, mw (mask window in steps),
        smem (bytes), threads
    """
    if not 0 < S <= FWD_MAX_SIZE:
        raise ValueError("LSTM size {} does not fit the forward kernel "
                         "(1..{})".format(S, FWD_MAX_SIZE))
    if S > MAX_SIZE:
        return lstm_fwd_wide_plan(B, S, optin, clusters)
    br = _rows_a_block(B, sms)
    threads = _round(4 * S, 32)
    choices = ([("registers", FWD_REGISTER_KQ, 0)]
               if FWD_REGISTER_MIN_S <= S <= FWD_REGISTER_KQ else [])
    choices += [("smem", 0, 1), ("global", 0, 0)]
    for mode, kq, stage in choices:
        kk = kq or _round(S, 4)
        for ns in (4, 3, 2):
            for window in FWD_MASK_WINDOWS:
                nbytes = (FWD_BAR_BYTES + window + 4 * (
                    ns * br * 4 * S + 2 * kk * br
                    + (4 * S * S if stage else 0)))
                if nbytes <= optin:
                    return {"br": br, "mode": mode, "kq": kq,
                            "stage": stage, "ns": ns, "mw": window // br,
                            "smem": nbytes, "threads": threads}
    raise ValueError("LSTM size {} does not fit the forward kernel".format(
        S))


#: the backward kernel's register mode (``csrc/lstm_bwd.cu``): a thread
#: holds its quarter row of sWT, BWD_REGISTER_KQ floats, for S from
#: BWD_REGISTER_MIN_S to BWD_REGISTER_KQ (below it sWT is staged)
BWD_REGISTER_KQ = 64
BWD_REGISTER_MIN_S = 33


def _quarter_stride(n, br):
    """Floats between two quarters of dg in the backward's shared memory:
    n rounded up to 4, then padded until the four quarters' reads of one k
    (16 bytes, 32 at 8 rows a block) fall in four disjoint groups of the
    32 banks."""
    width = 8 if br >= 8 else 4
    qs = _round(n, 4)
    while not all(min((a - b) % 32, (b - a) % 32) >= width
                  for a, b in itertools.combinations(
                      [(q * qs) % 32 for q in range(4)], 2)):
        qs += 4
    return qs


def lstm_bwd_plan(B, S, sms=H100_SMS, optin=SMEM_OPTIN):
    """The launch plan of ``lstm_bwd.cu`` for a batch of B rows of width S.

    Rows a block ``br``: the fewest of 1, 2, 4, 8 that fit the batch in one
    wave over ``sms`` SMs.  Then the first of these that fits ``optin``
    bytes of shared memory with a ring ``ns`` of 4 step slots, else 3, else
    2: sWT's quarter rows in registers ("registers", S from
    BWD_REGISTER_MIN_S to BWD_REGISTER_KQ); sWT staged ("smem"); sWT read
    from global memory ("global").

    :returns: dict of br, mode, kq, stage, ns, qs, smem (bytes), threads
    """
    br = _rows_a_block(B, sms)
    threads = _round(4 * S, 32)
    slot = _round(br * 7 * S + br, 4)
    choices = ([("registers", BWD_REGISTER_KQ, 0)]
               if BWD_REGISTER_MIN_S <= S <= BWD_REGISTER_KQ else [])
    choices += [("smem", 0, 1), ("global", 0, 0)]
    for mode, kq, stage in choices:
        kk = kq or _round(S, 4)
        qs = _quarter_stride(kk * br, br)
        for ns in (4, 3, 2):
            nbytes = 4 * (ns * slot + 8 * qs + (4 * S * kk if stage else 0))
            if nbytes <= optin:
                return {"br": br, "mode": mode, "kq": kq, "stage": stage,
                        "ns": ns, "qs": qs, "smem": nbytes,
                        "threads": threads}
    raise ValueError("LSTM size {} does not fit the backward kernel".format(
        S))


def _optin(device):
    """The shared memory a block of ``device`` may opt in to (bytes)."""
    return getattr(torch.cuda.get_device_properties(device),
                   "shared_memory_per_block_optin", SMEM_OPTIN)


class LstmForward:
    """The LSTM forward recurrence; replaces the Pallas TPU kernels
    ``sloika_tpu/nn/pallas_lstm.py::_fwd_kernel`` (with the cell trace) and
    ``_fwd_kernel_nocout`` (without) with ``csrc/lstm_fwd.cu``, and past
    S = MAX_SIZE with ``csrc/lstm_fwd_wide.cu``, launched by
    :func:`lstm_fwd_plan`.

    Launches a CUDA kernel for CUDA tensors and runs :func:`lstm_scan_plain`
    for CPU tensors.  ``launches`` counts kernel launches, and
    ``wide_launches`` those of the wide route."""

    _ARGTYPES = {"lstm_fwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11
                 + [ctypes.c_void_p]}
    _WIDE_ARGTYPES = {"lstm_fwd_wide": [ctypes.c_void_p] * 5
                      + [ctypes.c_int] * 7 + [ctypes.c_void_p],
                      "lstm_fwd_wide_clusters": [ctypes.c_int,
                                                 ctypes.c_void_p]}

    def __init__(self):
        self.launches = 0
        self.wide_launches = 0
        self._clusters = {}

    def _library(self):
        """The loaded ``lstm_fwd`` library (``scripts/bench_lstm.py``
        swaps in its clocked build)."""
        return cuda_build.load("lstm_fwd", self._ARGTYPES)

    def _wide_library(self):
        """The loaded ``lstm_fwd_wide`` library (``scripts/bench_lstm.py``
        swaps in its clocked build)."""
        return cuda_build.load("lstm_fwd_wide", self._WIDE_ARGTYPES)

    def wide_clusters(self, device):
        """The clusters of the wide route's blocks that the card runs at
        once (queried once for each device, at the route's largest shared
        memory: a block takes the SM alone at any rows)."""
        key = str(device)
        if key not in self._clusters:
            smem = wide_smem(wide_rows(_optin(device)))
            n = ctypes.c_int(0)
            with torch.cuda.device(device):
                cuda_build.check(self._wide_library().lstm_fwd_wide_clusters(
                    smem, ctypes.byref(n)), "lstm_fwd_wide_clusters")
            self._clusters[key] = n.value
        return self._clusters[key]

    def _wide(self, xp, sWT, p, mask8, h_out, reverse):
        T, B, S = h_out.shape
        dev = xp.device
        plan = lstm_fwd_wide_plan(B, S, _optin(dev), self.wide_clusters(dev))
        lib = self._wide_library()
        with torch.cuda.device(dev):
            err = lib.lstm_fwd_wide(xp.data_ptr(), mask8.data_ptr(),
                                    sWT.data_ptr(), p.data_ptr(),
                                    h_out.data_ptr(), T, B, S,
                                    int(bool(reverse)), plan["rows"],
                                    plan["clusters"], plan["smem"],
                                    torch.cuda.current_stream().cuda_stream)
        cuda_build.check(err, "lstm_fwd_wide")
        self.launches += 1
        self.wide_launches += 1

    def __call__(self, xp, sWT, p, mask=None, reverse=False, emit_cout=True,
                 emit_gates=False):
        """:param mask: optional (T, B) bool valid-step mask
        :param emit_gates: also write the gate trace that
            :data:`lstm_backward` reads (needs ``emit_cout``)
        :returns: (h (T, B, S), c (T, B, S) or None without ``emit_cout``),
            and the gate trace (T, B, 4S) with ``emit_gates``
        """
        T, B, S4 = xp.shape
        if mask is None:
            mask = torch.ones((T, B), dtype=torch.bool, device=xp.device)
        if xp.device.type == "cpu":
            return lstm_scan_plain(xp, sWT, p, mask.bool(), reverse,
                                   emit_cout, emit_gates)
        if emit_gates and not emit_cout:
            raise ValueError("the gate trace comes with the cell trace")
        T, B, S = _check_lstm_shapes(xp, sWT, p, mask, FWD_MAX_SIZE,
                                     "forward kernel")
        if emit_cout and S > MAX_SIZE:
            raise ValueError("LSTM size {}: the forward writes its cell and "
                             "gate traces (training) up to {}".format(
                                 S, MAX_SIZE))
        new = lambda n: torch.empty((T, B, n), dtype=torch.float32,
                                    device=xp.device)
        h_out = new(S)
        c_out = new(S) if emit_cout else None
        gates = new(4 * S) if emit_gates else None
        result = (h_out, c_out, gates) if emit_gates else (h_out, c_out)
        if T == 0 or B == 0:
            return result
        mask8 = mask.to(torch.uint8).contiguous()
        if S > MAX_SIZE:
            self._wide(xp, sWT, p, mask8, h_out, reverse)
            return result
        if xp.data_ptr() % 16:
            xp = xp.clone()             # the bulk copies read 16-byte units
        props = torch.cuda.get_device_properties(xp.device)
        plan = lstm_fwd_plan(B, S, props.multi_processor_count,
                             getattr(props, "shared_memory_per_block_optin",
                                     SMEM_OPTIN))
        lib = self._library()
        with torch.cuda.device(xp.device):
            err = lib.lstm_fwd(xp.data_ptr(), mask8.data_ptr(),
                               sWT.data_ptr(), p.data_ptr(),
                               h_out.data_ptr(),
                               c_out.data_ptr() if emit_cout else None,
                               gates.data_ptr() if emit_gates else None,
                               T, B, S, int(bool(reverse)),
                               plan["br"], plan["kq"], plan["stage"],
                               plan["ns"], plan["mw"], plan["smem"],
                               plan["threads"],
                               torch.cuda.current_stream().cuda_stream)
        cuda_build.check(err, "lstm_fwd")
        self.launches += 1
        return result


#: ``lstm_wgrad.cu``: threads a block at most (168 registers a thread),
#: its copy-ring stages, slice rows (most first), the floats after a
#: stage's h and dxp regions, and peephole columns a thread at most
WGRAD_MAX_THREADS = 384
WGRAD_STAGES = 3
WGRAD_SLICES = (32, 16, 8, 4)
WGRAD_PAD = 8
WGRAD_PEEP_COLUMNS = 8


def lstm_wgrad_plan(T, B, S, sms=H100_SMS, optin=SMEM_OPTIN):
    """The launch plan of ``lstm_wgrad.cu`` for the N = T * B rows of an
    (S, 4S) weight sum and its 3S peephole sums.

    8 x 8 thread tiles over the output (``MT`` = S/8 row groups, ``G`` =
    4S/8 column groups), as many column groups a block as fit
    WGRAD_MAX_THREADS threads (all of them up to S = 64, else ``ncb``
    column blocks), whose threads also add the 3S peephole columns' products
    in column block 0 (at most WGRAD_PEEP_COLUMNS a thread); slices of
    ``kb`` rows (the most of
    WGRAD_SLICES whose WGRAD_STAGES stages fit ``optin`` bytes); and the
    rows split so that the ncb x nsplit blocks cover ``sms`` SMs in one
    wave.  ``lh``: floats a row of h_out and c_out as the kernel stages it
    (S rounded up to 4, for the tiles' 16-byte loads).  It depends on the
    shapes alone, so the sum order (and the bits) do too.

    :returns: dict of lh, ng, ncb, kb, nsplit, rows_per_split, threads,
        smem
    """
    lh = _round(S, 4)
    MT, G = -(-S // 8), -(-4 * S // 8)
    ng = min(G, WGRAD_MAX_THREADS // MT)
    if ng < 1 or WGRAD_PEEP_COLUMNS * _round(MT * ng, 32) < 3 * S:
        raise ValueError("LSTM size {} does not fit the weight-cotangent "
                         "kernel".format(S))
    ncb = -(-G // ng)
    ng = -(-G // ncb)
    stage = lambda kb: 4 * (kb * (3 * lh + 4 * S) + 2 * WGRAD_PAD)
    kb = next((k for k in WGRAD_SLICES
               if WGRAD_STAGES * stage(k) <= optin), None)
    if kb is None:
        raise ValueError("LSTM size {} does not fit the weight-cotangent "
                         "kernel".format(S))
    N = T * B
    nsplit = max(1, min(sms // ncb, -(-N // kb)))
    rows = max(kb, _round(-(-N // nsplit), kb))
    nsplit = max(1, -(-N // rows))
    return {"lh": lh, "ng": ng, "ncb": ncb, "kb": kb, "nsplit": nsplit,
            "rows_per_split": rows, "threads": _round(MT * ng, 32),
            "smem": WGRAD_STAGES * stage(kb)}


class LstmWgrad:
    """The recurrent-weight cotangent ``dsWT = sum h_prev^T dxp`` and the
    peephole cotangents over the T*B rows, which the Pallas kernel
    ``_bwd_kernel`` accumulates in its body (:165-169); here
    ``csrc/lstm_wgrad.cu``, launched with :func:`lstm_wgrad_plan`.

    Launches the CUDA kernel for CUDA tensors and runs
    :func:`lstm_wgrad_plain` for CPU tensors.  ``launches`` counts kernel
    launches."""

    _ARGTYPES = {"lstm_wgrad": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                 + [ctypes.c_longlong] + [ctypes.c_int] * 2
                 + [ctypes.c_void_p]}

    def __init__(self):
        self.launches = 0

    def _library(self):
        """The loaded ``lstm_wgrad`` library (``scripts/bench_lstm.py``
        swaps in its clocked build)."""
        return cuda_build.load("lstm_wgrad", self._ARGTYPES)

    def __call__(self, h_out, c_out, dxp, reverse):
        if h_out.device.type == "cpu":
            return lstm_wgrad_plain(h_out, c_out, dxp, reverse)
        T, B, S = h_out.shape
        dev = h_out.device
        if not 0 < S <= MAX_SIZE:
            raise ValueError("LSTM size {} outside the weight-cotangent "
                             "kernel's 1..{}".format(S, MAX_SIZE))
        cuda_build.check_tensor(h_out, (T, B, S), torch.float32, dev, "h_out")
        cuda_build.check_tensor(c_out, (T, B, S), torch.float32, dev, "c_out")
        cuda_build.check_tensor(dxp, (T, B, 4 * S), torch.float32, dev, "dxp")
        dsWT = torch.empty((S, 4 * S), dtype=torch.float32, device=dev)
        dp = torch.empty((3, S), dtype=torch.float32, device=dev)
        if T * B == 0:
            return dsWT.zero_(), dp.zero_()
        plan = lstm_wgrad_plan(T, B, S)
        part = torch.empty((plan["nsplit"], 4 * S * S + 3 * S),
                           dtype=torch.float32, device=dev)
        lib = self._library()
        with torch.cuda.device(dev):
            err = lib.lstm_wgrad(h_out.data_ptr(), c_out.data_ptr(),
                                 dxp.data_ptr(), part.data_ptr(),
                                 dsWT.data_ptr(), dp.data_ptr(), T, B, S,
                                 plan["lh"], int(bool(reverse)), plan["ng"],
                                 plan["ncb"], plan["kb"], plan["nsplit"],
                                 plan["rows_per_split"], plan["threads"],
                                 plan["smem"],
                                 torch.cuda.current_stream().cuda_stream)
        cuda_build.check(err, "lstm_wgrad")
        self.launches += 1
        return dsWT, dp


class LstmBackward:
    """The LSTM VJP; replaces the Pallas TPU kernel
    ``sloika_tpu/nn/pallas_lstm.py::_bwd_kernel`` with ``csrc/lstm_bwd.cu``
    (the reverse-time recurrence from the forward's gate trace) followed by
    :data:`lstm_wgrad`.

    Runs :func:`lstm_scan_bwd_gates_plain` for CPU tensors.  ``launches``
    counts launches of ``lstm_bwd``; ``lstm_wgrad`` counts its own."""

    _ARGTYPES = {"lstm_bwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11
                 + [ctypes.c_void_p]}

    def __init__(self):
        self.launches = 0

    def _library(self):
        """The loaded ``lstm_bwd`` library (``scripts/bench_lstm.py``
        swaps in its clocked build)."""
        return cuda_build.load("lstm_bwd", self._ARGTYPES)

    def recurrence(self, gates, sWT, p, mask, reverse, g, c_out):
        """The ``lstm_bwd`` kernel alone (CUDA tensors only).

        :param gates: (T, B, 4S) gate trace of the forward's training variant
        :returns: dxp (T, B, 4S)
        """
        T, B, S = _check_lstm_shapes(gates, sWT, p, mask, MAX_SIZE,
                                     "backward kernels")
        dev = gates.device
        for t, name in ((g, "g"), (c_out, "c_out")):
            cuda_build.check_tensor(t, (T, B, S), torch.float32, dev, name)
        dxp = torch.empty((T, B, 4 * S), dtype=torch.float32, device=dev)
        if T == 0 or B == 0:
            return dxp
        # int32 mask words: they ride in the kernel's copy ring
        mask32 = mask.to(torch.int32).contiguous()
        props = torch.cuda.get_device_properties(dev)
        plan = lstm_bwd_plan(B, S, props.multi_processor_count,
                             getattr(props, "shared_memory_per_block_optin",
                                     SMEM_OPTIN))
        lib = self._library()
        with torch.cuda.device(dev):
            err = lib.lstm_bwd(gates.data_ptr(), c_out.data_ptr(),
                               g.data_ptr(), mask32.data_ptr(),
                               sWT.data_ptr(), p.data_ptr(), dxp.data_ptr(),
                               T, B, S, int(bool(reverse)), plan["br"],
                               plan["kq"], plan["stage"], plan["ns"],
                               plan["qs"], plan["smem"], plan["threads"],
                               torch.cuda.current_stream().cuda_stream)
        cuda_build.check(err, "lstm_bwd")
        self.launches += 1
        return dxp

    def __call__(self, gates, sWT, p, mask, reverse, g, h_out, c_out):
        """:returns: (dxp (T, B, 4S), dsWT (S, 4S), dp (3, S))"""
        if gates.device.type == "cpu":
            return lstm_scan_bwd_gates_plain(gates, sWT, p, mask.bool(),
                                             reverse, g, h_out, c_out)
        dxp = self.recurrence(gates, sWT, p, mask, reverse, g, c_out)
        dsWT, dp = lstm_wgrad(h_out, c_out, dxp, reverse)
        return dxp, dsWT, dp


#: the LSTM forward entry point (kernel on CUDA, plain twin on the CPU)
lstm_forward = LstmForward()
#: the weight and peephole cotangent sums (kernel on CUDA, einsums on the CPU)
lstm_wgrad = LstmWgrad()
#: the LSTM backward entry point (kernels on CUDA, plain twin on the CPU)
lstm_backward = LstmBackward()


class LstmFunction(torch.autograd.Function):
    """The LSTM recurrence under autograd (cf. the ``jax.custom_vjp``
    ``pallas_lstm.lstm_fused`` :233-260): the forward is :data:`lstm_forward`
    and saves the residuals of ``_fwd`` (:247-250), with the gate trace in
    place of ``xp``; the backward is :data:`lstm_backward`.

    ``apply(xp, sWT, p, mask, reverse, has_peep)`` with a (T, B) bool
    ``mask``.  The cell and gate traces are emitted only when a gradient is
    needed, as ``lstm_fused`` runs the no-cout kernel outside ``jax.grad``.
    Without ``has_peep`` the peepholes get a zero gradient (JAX's
    ``stop_gradient``, ``pallas_lstm.py:276-277``)."""

    @staticmethod
    def forward(ctx, xp, sWT, p, mask, reverse, has_peep):
        # grad mode is off inside Function.forward: ask autograd instead
        if not any(ctx.needs_input_grad[:3]):
            h_out, _ = lstm_forward(xp, sWT, p, mask=mask, reverse=reverse,
                                    emit_cout=False)
            return h_out
        h_out, c_out, gates = lstm_forward(xp, sWT, p, mask=mask,
                                           reverse=reverse, emit_cout=True,
                                           emit_gates=True)
        ctx.save_for_backward(gates, mask, sWT, p, h_out, c_out)
        ctx.reverse, ctx.has_peep = reverse, has_peep
        return h_out

    @staticmethod
    def backward(ctx, g):
        gates, mask, sWT, p, h_out, c_out = ctx.saved_tensors
        dxp, dsWT, dp = lstm_backward(gates, sWT, p, mask, ctx.reverse,
                                      g.contiguous(), h_out, c_out)
        if not ctx.has_peep:
            dp = torch.zeros_like(dp)
        return dxp, dsWT, dp, None, None, None
