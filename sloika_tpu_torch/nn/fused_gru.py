"""GRU recurrence: the CUDA kernels, their plain PyTorch twins and the
autograd function that joins them.

:data:`gru_forward` replaces the Pallas TPU kernel
``sloika_tpu/nn/pallas_gru.py::_kernel`` (driven by ``_pallas_scan`` and
``gru_fused``) with ``csrc/gru_fwd.cu``.  :data:`gru_backward` replaces its
VJP kernel ``_bwd_kernel`` (driven by ``_pallas_scan_bwd``) with two:
``csrc/gru_bwd.cu``, the reverse-time recurrence, and ``csrc/gru_wgrad.cu``
(:data:`gru_wgrad`), the recurrent-weight cotangents summed over the T*B
rows.  The input projection ``x @ iW.T + b`` stays a ``torch.matmul``
outside the kernels, as the JAX package leaves it to XLA.

Unlike the Pallas kernels, which recompute the gates in the backward, the
forward's training variant (``emit_gates``) writes the gate trace
``[z, r, hbar]`` (T, B, 3S) and the backward reads it (``gru_bwd.cu``
says why); :class:`GruFunction` asks for it only when a gradient is needed.

Contract (all versions): over ``xp`` (T, B, 3S) float32 and the recurrent
weights ``sWT`` (S, 2S), ``sW2T`` (S, S)::

    z, r = sigmoid(xp[:, :2S] + h @ sWT)
    hbar = tanh(xp[:, 2S:] + (r * h) @ sW2T)
    h    = z * h + (1 - z) * hbar

A masked step keeps and emits the carried ``h``; ``reverse`` scans from the
last step to the first.  The forward returns (T, B, S) float32; the
backward carries the state cotangent straight through masked steps and
gives them zero ``dxp``.
"""
import ctypes

import torch

from sloika_tpu_torch import cuda_build


def gru_scan_plain(xp, sWT, sW2T, mask, reverse=False, emit_gates=False):
    """The plain twin: a Python loop over time of eager torch ops.

    :returns: h (T, B, S), or (h, the gate trace [z, r, hbar] (T, B, 3S)
        of every step, masked ones included) with ``emit_gates``
    """
    T, B, S3 = xp.shape
    S = S3 // 3
    h = xp.new_zeros((B, S))
    out = xp.new_empty((T, B, S))
    gates = xp.new_empty((T, B, S3)) if emit_gates else None
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        lp = xp[t]
        vT = lp[:, :2 * S] + h @ sWT
        z = torch.sigmoid(vT[:, :S])
        r = torch.sigmoid(vT[:, S:])
        hbar = torch.tanh(lp[:, 2 * S:] + (r * h) @ sW2T)
        if emit_gates:
            gates[t] = torch.cat([z, r, hbar], dim=1)
        new = z * h + (1 - z) * hbar
        h = torch.where(mask[t][:, None], new, h)
        out[t] = h
    return (out, gates) if emit_gates else out


def h_prev_of(h_out, reverse):
    """h_{t-1} in scan order: ``h_out`` shifted one step towards the scan
    start, zeros at the first step (``pallas_gru.py:231-239``)."""
    zero = h_out.new_zeros((1,) + tuple(h_out.shape[1:]))
    if reverse:
        return torch.cat([h_out[1:], zero], dim=0)
    return torch.cat([zero, h_out[:-1]], dim=0)


def gru_scan_bwd_plain(xp, sWT, sW2T, mask, reverse, g, h_out):
    """The plain twin of the backward: a Python loop over time that follows
    ``pallas_gru.py::_bwd_kernel`` (:174-215) line for line.

    :param g: (T, B, S) cotangent of the forward's output ``h_out``
    :returns: (dxp (T, B, 3S), dsWT (S, 2S), dsW2T (S, S))
    """
    T, B, S3 = xp.shape
    S = S3 // 3
    h_prev = h_prev_of(h_out, reverse)
    sW, sW2 = sWT.t(), sW2T.t()
    dh = xp.new_zeros((B, S))
    dxp = xp.new_empty((T, B, S3))
    dsWT = xp.new_zeros((S, 2 * S))
    dsW2T = xp.new_zeros((S, S))
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        lp, hp = xp[t], h_prev[t]
        m = mask[t][:, None]
        # recompute forward quantities for this step
        vT = lp[:, :2 * S] + hp @ sWT
        z = torch.sigmoid(vT[:, :S])
        r = torch.sigmoid(vT[:, S:])
        rh = r * hp
        hbar = torch.tanh(lp[:, 2 * S:] + rh @ sW2T)

        dht = dh + g[t]
        # masked steps copied h through: gradients flow straight to h_{t-1}
        dh_eff = torch.where(m, dht, torch.zeros_like(dht))
        dz = dh_eff * (hp - hbar) * z * (1 - z)
        dhbar = dh_eff * (1 - z)
        da = dhbar * (1 - hbar * hbar)
        drh = da @ sW2
        dr = drh * hp * r * (1 - r)
        dvT = torch.cat([dz, dr], dim=1)
        dh_prev = dh_eff * z + drh * r + dvT @ sW
        dh_prev = dh_prev + torch.where(m, torch.zeros_like(dht), dht)

        d = torch.cat([dvT, da], dim=1)
        dxp[t] = torch.where(m, d, torch.zeros_like(d))
        dsWT += hp.t() @ dvT
        dsW2T += rh.t() @ da
        dh = dh_prev
    return dxp, dsWT, dsW2T


def gru_scan_bwd_gates_plain(gates, sWT, sW2T, mask, reverse, g, h_out):
    """The plain twin of ``gru_bwd.cu`` with ``gru_wgrad``: the backward of
    :func:`gru_scan_bwd_plain` from the forward's gate trace instead of a
    recompute (the same arithmetic in the same order).

    :param gates: (T, B, 3S) ``[z, r, hbar]`` from ``gru_scan_plain(...,
        emit_gates=True)`` or the kernel's training variant
    :returns: (dxp (T, B, 3S), dsWT (S, 2S), dsW2T (S, S))
    """
    T, B, S3 = gates.shape
    S = S3 // 3
    h_prev = h_prev_of(h_out, reverse)
    sW, sW2 = sWT.t(), sW2T.t()
    dh = gates.new_zeros((B, S))
    dxp = gates.new_empty((T, B, S3))
    dsWT = gates.new_zeros((S, 2 * S))
    dsW2T = gates.new_zeros((S, S))
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        z, r, hbar = gates[t].split(S, dim=1)
        hp = h_prev[t]
        m = mask[t][:, None]
        rh = r * hp

        dht = dh + g[t]
        dh_eff = torch.where(m, dht, torch.zeros_like(dht))
        dz = dh_eff * (hp - hbar) * z * (1 - z)
        dhbar = dh_eff * (1 - z)
        da = dhbar * (1 - hbar * hbar)
        drh = da @ sW2
        dr = drh * hp * r * (1 - r)
        dvT = torch.cat([dz, dr], dim=1)
        dh_prev = dh_eff * z + drh * r + dvT @ sW
        dh_prev = dh_prev + torch.where(m, torch.zeros_like(dht), dht)

        d = torch.cat([dvT, da], dim=1)
        dxp[t] = torch.where(m, d, torch.zeros_like(d))
        dsWT += hp.t() @ dvT
        dsW2T += rh.t() @ da
        dh = dh_prev
    return dxp, dsWT, dsW2T


def gru_wgrad_plain(h_out, rh, dxp, reverse):
    """The plain twin of ``gru_wgrad.cu``: the recurrent-weight cotangents
    as one einsum over the T*B rows.

    :param rh: (T, B, S) ``r * h_prev`` of each step
    :param dxp: (T, B, 3S) the backward's input cotangent, zero at masked
        steps
    :returns: (dsWT (S, 2S), dsW2T (S, S))
    """
    S = h_out.shape[2]
    h_prev = h_prev_of(h_out, reverse)
    dsWT = torch.einsum("tbi,tbj->ij", h_prev, dxp[:, :, :2 * S])
    dsW2T = torch.einsum("tbi,tbj->ij", rh, dxp[:, :, 2 * S:])
    return dsWT, dsW2T


#: streaming multiprocessors of an H100 SXM; the plans size their grids by
#: it, so a plan depends on the shapes alone
H100_SMS = 132
#: shared memory a block may opt in to on sm_90 (bytes)
SMEM_OPTIN = 232448
#: the clusters of C one-block-an-SM blocks that an H100 SXM runs at once
#: (``cudaOccupancyMaxActiveClusters`` at 256-1,024 threads, on an H100
#: 80GB HBM3 at 700 W, PERF.md §6): its 132 SMs lie in GPCs of uneven size,
#: so it holds 7 clusters of 16, not 8.  The plans' default where no card
#: is asked
H100_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}
#: the forward kernel's modes (``csrc/gru_fwd.cu``): both weights staged in
#: shared memory; weights held in registers (``kr`` rows of sWT's column
#: and ``kh2`` rows of a half of sW2T's column a thread, sWT's rows past
#: ``kr`` staged); sW2T read from global memory
FWD_MODES = ("smem", "registers", "global")
#: the register modes the kernel is built for: (largest S, kr, kh2, largest
#: rows a block), in order of preference; each holds S <= 2 * kh2
FWD_REGISTER_MODES = ((96, 96, 48, 8), (112, 112, 56, 8), (144, 48, 72, 2),
                      (144, 0, 72, 8))
#: below this width the staged weights are few: mode "smem"
FWD_REGISTER_MIN_S = 73
#: threads a block of the forward's shared-memory and register modes
#: (``__launch_bounds__`` in ``gru_fwd.cu``)
FWD_STAGED_THREADS = 288


def _round(n, m):
    return -(-n // m) * m


def _rows_a_block(B, sms):
    """The fewest of 1, 2, 4, 8 rows a block that fit the batch in one wave
    over ``sms`` SMs (8 past 8 * sms rows)."""
    br = 1
    while br < 8 and -(-B // br) > sms:
        br *= 2
    return br


def gru_fwd_plan(B, S, sms=H100_SMS, optin=SMEM_OPTIN):
    """The launch plan of ``gru_fwd.cu`` for a batch of B rows of width S.

    Rows a block ``br``: the fewest of 1, 2, 4, 8 that fit the batch in one
    wave over ``sms`` SMs.  Then the first of these that fits ``optin``
    bytes of shared memory, with a projection ring ``ns`` of 4 step slots,
    else 3, else 2: for S from FWD_REGISTER_MIN_S to 144, the first register
    mode of FWD_REGISTER_MODES that holds S at this ``br``; both weights
    staged ("smem"); sWT staged and sW2T from global memory; both from
    global memory.

    :returns: dict of br, mode, kr, kh2, ns, stage1, smem (bytes), threads
    """
    br = _rows_a_block(B, sms)
    threads = _round(2 * S, 32)
    slot = _round(br * 3 * S + br, 4)

    def smem(mode, ns, stage1, kr, kh2):
        kh = kh2 if mode == "registers" else _round((S + 1) // 2, 4)
        floats = (ns * slot + _round(max(S, kr) * br, 4) + _round(S * br, 4)
                  + _round(2 * kh * br, 4)
                  + (2 * S * max(S - kr, 0) if stage1 else 0)
                  + (2 * kh * S if mode == "smem" else 0))
        return 4 * floats

    choices = []
    if threads <= FWD_STAGED_THREADS:
        if S >= FWD_REGISTER_MIN_S:
            choices += [("registers", True, kr, kh2)
                        for s_max, kr, kh2, br_max in FWD_REGISTER_MODES
                        if S <= s_max and S <= 2 * kh2 and br <= br_max]
        choices.append(("smem", True, 0, 0))
    choices += [("global", True, 0, 0), ("global", False, 0, 0)]
    for depths in ((4, 3), (2,)):
        for mode, stage1, kr, kh2 in choices:
            for ns in depths:
                nbytes = smem(mode, ns, stage1, kr, kh2)
                if nbytes <= optin:
                    return {"br": br, "mode": mode, "kr": kr, "kh2": kh2,
                            "ns": ns, "stage1": stage1, "smem": nbytes,
                            "threads": threads}
    raise ValueError("GRU size {} does not fit the forward kernel".format(S))


#: the backward kernel's register modes (``csrc/gru_bwd.cu``): (largest S,
#: ka, kb, largest rows a block), in order of preference.  A thread holds
#: ka floats of its first product's row (sW2T's or sWT's row c) and kb of a
#: half of its second's (sWT's row c, from S); ka = 0: the first product's
#: weights are staged in shared memory instead
BWD_REGISTER_MODES = ((96, 96, 48, 8), (112, 112, 56, 8), (144, 0, 72, 8))
#: below this width the backward stages both products' weights: "smem"
BWD_REGISTER_MIN_S = 73
#: threads a block of the backward's staged and global modes
#: (``__launch_bounds__`` in ``gru_bwd.cu``)
BWD_STAGED_THREADS = 512


def gru_bwd_plan(B, S, sms=H100_SMS, optin=SMEM_OPTIN):
    """The launch plan of ``gru_bwd.cu`` for a batch of B rows of width S.

    Rows a block ``br`` as :func:`gru_fwd_plan`.  Then the first of these
    that fits ``optin`` bytes of shared memory with a ring ``ns`` of 4 step
    slots, else 3, else 2: from BWD_REGISTER_MIN_S, the first mode of
    BWD_REGISTER_MODES that holds S at this ``br`` ("registers" with both
    products' weights in registers, "mixed" with the second's); both
    products' weights staged ("smem", stage bits 3); the first's staged and
    the second's from global memory; both from global memory ("global").

    :returns: dict of br, mode, ka, kb, stage, ns, smem (bytes), threads
    """
    br = _rows_a_block(B, sms)
    threads = _round(2 * S, 32)
    slot = _round(br * 5 * S + br, 4)

    def smem(ka, kb, stage, ns):
        kd = ka or _round(S, 4)
        kh = kb or _round((S + 1) // 2, 4)
        floats = (ns * slot + 2 * kd * br + 2 * kh * br
                  + (2 * S * kd if not ka and stage & 1 else 0)
                  + (2 * S * kh if not kb and stage & 2 else 0))
        return 4 * floats

    choices = []
    if S >= BWD_REGISTER_MIN_S:
        choices += [("registers" if ka else "mixed", ka, kb, 0 if ka else 1)
                    for s_max, ka, kb, br_max in BWD_REGISTER_MODES
                    if S <= s_max and S <= 2 * kb and br <= br_max]
    if threads <= BWD_STAGED_THREADS:
        choices += [("smem", 0, 0, 3), ("global", 0, 0, 1),
                    ("global", 0, 0, 0)]
    for mode, ka, kb, stage in choices:
        for ns in (4, 3, 2):
            nbytes = smem(ka, kb, stage, ns)
            if nbytes <= optin:
                return {"br": br, "mode": mode, "ka": ka, "kb": kb,
                        "stage": stage, "ns": ns, "smem": nbytes,
                        "threads": threads}
    raise ValueError("GRU size {} does not fit the backward kernel".format(S))


#: threads a block of ``gru_wgrad.cu`` at most, and its copy-ring stages
WGRAD_MAX_THREADS = 512
WGRAD_STAGES = 3


def gru_wgrad_plan(T, B, S):
    """The launch plan of ``gru_wgrad.cu``: 8 x 8 thread tiles over the
    S x 3S output (``MT`` row groups, ``G`` column groups), as many column
    groups a block as fit WGRAD_MAX_THREADS threads, slices of ``kb`` rows
    (16, else 8, else 4: what a 3-stage ring fits in SMEM_OPTIN bytes), and
    the N = T * B rows split so that about one wave of blocks covers
    H100_SMS SMs.  It depends on the shapes alone, so the sum order (and
    the bits) do too.

    :returns: dict of ng, ncb, kb, nsplit, rows_per_split, threads, smem
    """
    MT = -(-S // 8)
    G = -(-2 * S // 8) + -(-S // 8)
    ncb = -(-MT * G // WGRAD_MAX_THREADS)
    ng = -(-G // ncb)
    ncb = -(-G // ng)
    for kb in (16, 8, 4):
        nbytes = 4 * WGRAD_STAGES * kb * (8 * G + 16 * MT)
        if nbytes <= SMEM_OPTIN:
            break
    else:
        raise ValueError("GRU size {} does not fit the weight-cotangent "
                         "kernel".format(S))
    N = T * B
    nsplit = max(1, min(H100_SMS // ncb, -(-N // kb)))
    rows = max(kb, _round(-(-N // nsplit), kb))
    nsplit = max(1, -(-N // rows))
    return {"ng": ng, "ncb": ncb, "kb": kb, "nsplit": nsplit,
            "rows_per_split": rows, "threads": _round(MT * ng, 32),
            "smem": nbytes}


def _check_gru_shapes(xp, sWT, sW2T, mask, S_max):
    T, B, S3 = xp.shape
    S = S3 // 3
    dev = xp.device
    cuda_build.check_tensor(xp, (T, B, 3 * S), torch.float32, dev, "xp")
    cuda_build.check_tensor(sWT, (S, 2 * S), torch.float32, dev, "sWT")
    cuda_build.check_tensor(sW2T, (S, S), torch.float32, dev, "sW2T")
    if tuple(mask.shape) != (T, B) or mask.device != dev:
        raise ValueError("mask must be (T, B) on {}".format(dev))
    if not 0 < S <= S_max:
        raise ValueError("GRU size {} outside the kernel's 1..{}".format(
            S, S_max))
    return T, B, S


class GruForward:
    """The GRU forward recurrence; replaces the Pallas TPU kernel
    ``sloika_tpu/nn/pallas_gru.py::_kernel`` with ``csrc/gru_fwd.cu``.

    Launches the CUDA kernel for CUDA tensors and runs
    :func:`gru_scan_plain` for CPU tensors.  ``launches`` counts kernel
    launches."""

    _ARGTYPES = {"gru_fwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12
                 + [ctypes.c_void_p]}

    def __init__(self):
        self.launches = 0

    def __call__(self, xp, sWT, sW2T, mask=None, reverse=False,
                 emit_gates=False):
        """:param mask: optional (T, B) bool valid-step mask
        :param emit_gates: run the training variant, which also writes the
            gate trace that :data:`gru_backward` reads
        :returns: h (T, B, S), or (h, gates (T, B, 3S)) with ``emit_gates``
        """
        T, B, S3 = xp.shape
        if mask is None:
            mask = torch.ones((T, B), dtype=torch.bool, device=xp.device)
        if xp.device.type == "cpu":
            return gru_scan_plain(xp, sWT, sW2T, mask.bool(), reverse,
                                  emit_gates)
        T, B, S = _check_gru_shapes(xp, sWT, sW2T, mask, 512)
        out = torch.empty((T, B, S), dtype=torch.float32, device=xp.device)
        gates = (torch.empty((T, B, 3 * S), dtype=torch.float32,
                             device=xp.device) if emit_gates else None)
        result = (out, gates) if emit_gates else out
        if T == 0 or B == 0:
            return result
        # int32 mask words: they ride in the kernel's copy ring
        mask32 = mask.to(torch.int32).contiguous()
        props = torch.cuda.get_device_properties(xp.device)
        plan = gru_fwd_plan(B, S, props.multi_processor_count,
                            getattr(props, "shared_memory_per_block_optin",
                                    SMEM_OPTIN))
        lib = cuda_build.load("gru_fwd", self._ARGTYPES)
        with torch.cuda.device(xp.device):
            err = lib.gru_fwd(xp.data_ptr(), mask32.data_ptr(),
                              sWT.data_ptr(), sW2T.data_ptr(),
                              out.data_ptr(),
                              gates.data_ptr() if emit_gates else None,
                              T, B, S, int(bool(reverse)),
                              plan["br"], FWD_MODES.index(plan["mode"]),
                              plan["kr"], plan["kh2"], plan["ns"],
                              int(plan["stage1"]), plan["smem"],
                              plan["threads"],
                              torch.cuda.current_stream().cuda_stream)
        cuda_build.check(err, "gru_fwd")
        self.launches += 1
        return result


class GruWgrad:
    """The recurrent-weight cotangents ``dsWT = sum h_prev^T dvT`` and
    ``dsW2T = sum (r h_prev)^T da`` over the T*B rows, which the Pallas
    kernel ``_bwd_kernel`` accumulates in its body (:210-214); here
    ``csrc/gru_wgrad.cu``.

    Launches the CUDA kernel for CUDA tensors and runs
    :func:`gru_wgrad_plain` for CPU tensors.  ``launches`` counts kernel
    launches."""

    _ARGTYPES = {"gru_wgrad": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
                 + [ctypes.c_void_p]}

    def __init__(self):
        self.launches = 0

    def __call__(self, h_out, rh, dxp, reverse):
        if h_out.device.type == "cpu":
            return gru_wgrad_plain(h_out, rh, dxp, reverse)
        T, B, S = h_out.shape
        dev = h_out.device
        cuda_build.check_tensor(h_out, (T, B, S), torch.float32, dev, "h_out")
        cuda_build.check_tensor(rh, (T, B, S), torch.float32, dev, "rh")
        cuda_build.check_tensor(dxp, (T, B, 3 * S), torch.float32, dev, "dxp")
        if not 0 < S <= 256:
            raise ValueError("GRU size {} outside the kernel's 1..256".format(
                S))
        plan = gru_wgrad_plan(T, B, S)
        dsWT = torch.empty((S, 2 * S), dtype=torch.float32, device=dev)
        dsW2T = torch.empty((S, S), dtype=torch.float32, device=dev)
        part = torch.empty((plan["nsplit"], S, 3 * S), dtype=torch.float32,
                           device=dev)
        lib = cuda_build.load("gru_wgrad", self._ARGTYPES)
        with torch.cuda.device(dev):
            err = lib.gru_wgrad(h_out.data_ptr(), rh.data_ptr(),
                                dxp.data_ptr(), part.data_ptr(),
                                dsWT.data_ptr(), dsW2T.data_ptr(), T, B, S,
                                int(bool(reverse)), plan["ng"], plan["ncb"],
                                plan["kb"], plan["nsplit"],
                                plan["rows_per_split"], plan["threads"],
                                plan["smem"],
                                torch.cuda.current_stream().cuda_stream)
        cuda_build.check(err, "gru_wgrad")
        self.launches += 1
        return dsWT, dsW2T


class GruBackward:
    """The GRU VJP; replaces the Pallas TPU kernel
    ``sloika_tpu/nn/pallas_gru.py::_bwd_kernel`` with ``csrc/gru_bwd.cu``
    (the reverse-time recurrence from the forward's gate trace, which also
    writes ``r * h_prev``) followed by :data:`gru_wgrad`.

    Runs :func:`gru_scan_bwd_gates_plain` for CPU tensors.  ``launches``
    counts launches of ``gru_bwd``; ``gru_wgrad`` counts its own."""

    _ARGTYPES = {"gru_bwd": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
                 + [ctypes.c_void_p]}

    def __init__(self):
        self.launches = 0

    def recurrence(self, gates, sWT, sW2T, mask, reverse, g, h_out):
        """The ``gru_bwd`` kernel alone (CUDA tensors only).

        :param gates: (T, B, 3S) gate trace of the forward's training variant
        :returns: (dxp (T, B, 3S), rh (T, B, S))
        """
        T, B, S = _check_gru_shapes(gates, sWT, sW2T, mask, 256)
        dev = gates.device
        cuda_build.check_tensor(g, (T, B, S), torch.float32, dev, "g")
        cuda_build.check_tensor(h_out, (T, B, S), torch.float32, dev, "h_out")
        dxp = torch.empty((T, B, 3 * S), dtype=torch.float32, device=dev)
        rh = torch.empty((T, B, S), dtype=torch.float32, device=dev)
        if T == 0 or B == 0:
            return dxp, rh
        # int32 mask words: they ride in the kernel's copy ring
        mask32 = mask.to(torch.int32).contiguous()
        props = torch.cuda.get_device_properties(dev)
        plan = gru_bwd_plan(B, S, props.multi_processor_count,
                            getattr(props, "shared_memory_per_block_optin",
                                    SMEM_OPTIN))
        lib = cuda_build.load("gru_bwd", self._ARGTYPES)
        with torch.cuda.device(dev):
            err = lib.gru_bwd(gates.data_ptr(), h_out.data_ptr(),
                              g.data_ptr(), mask32.data_ptr(),
                              sWT.data_ptr(), sW2T.data_ptr(),
                              dxp.data_ptr(), rh.data_ptr(),
                              T, B, S, int(bool(reverse)), plan["br"],
                              plan["ka"], plan["kb"], plan["stage"],
                              plan["ns"], plan["smem"], plan["threads"],
                              torch.cuda.current_stream().cuda_stream)
        cuda_build.check(err, "gru_bwd")
        self.launches += 1
        return dxp, rh

    def __call__(self, gates, sWT, sW2T, mask, reverse, g, h_out):
        """:returns: (dxp (T, B, 3S), dsWT (S, 2S), dsW2T (S, S))"""
        if gates.device.type == "cpu":
            return gru_scan_bwd_gates_plain(gates, sWT, sW2T, mask.bool(),
                                            reverse, g, h_out)
        dxp, rh = self.recurrence(gates, sWT, sW2T, mask, reverse, g, h_out)
        dsWT, dsW2T = gru_wgrad(h_out, rh, dxp, reverse)
        return dxp, dsWT, dsW2T


#: the GRU forward entry point (kernel on CUDA, plain twin on the CPU)
gru_forward = GruForward()
#: the recurrent-weight cotangent sum (kernel on CUDA, einsum on the CPU)
gru_wgrad = GruWgrad()
#: the GRU backward entry point (kernels on CUDA, plain twin on the CPU)
gru_backward = GruBackward()


class GruFunction(torch.autograd.Function):
    """The GRU recurrence under autograd (cf. the ``jax.custom_vjp``
    ``pallas_gru.gru_fused``): the forward is :data:`gru_forward`, whose
    training variant saves the gate trace in place of ``_fwd``'s ``xp``
    (:289-291); the backward is :data:`gru_backward`.

    ``apply(xp, sWT, sW2T, mask, reverse)`` with a (T, B) bool ``mask``.
    The gate trace is written only when a gradient is needed: under
    ``no_grad``, ``inference_mode`` and on the basecall and remap paths the
    inference variant runs and nothing is saved."""

    @staticmethod
    def forward(ctx, xp, sWT, sW2T, mask, reverse):
        # grad mode is off inside Function.forward: ask autograd instead
        if not any(ctx.needs_input_grad[:3]):
            return gru_forward(xp, sWT, sW2T, mask=mask, reverse=reverse,
                               emit_gates=False)
        h_out, gates = gru_forward(xp, sWT, sW2T, mask=mask, reverse=reverse,
                                   emit_gates=True)
        ctx.save_for_backward(gates, mask, sWT, sW2T, h_out)
        ctx.reverse = reverse
        return h_out

    @staticmethod
    def backward(ctx, g):
        gates, mask, sWT, sW2T, h_out = ctx.saved_tensors
        dxp, dsWT, dsW2T = gru_backward(gates, sWT, sW2T, mask, ctx.reverse,
                                        g.contiguous(), h_out)
        return dxp, dsWT, dsW2T, None, None
