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


def gru_scan_plain(xp, sWT, sW2T, mask, reverse=False):
    """The plain twin: a Python loop over time of eager torch ops."""
    T, B, S3 = xp.shape
    S = S3 // 3
    h = xp.new_zeros((B, S))
    out = xp.new_empty((T, B, S))
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        lp = xp[t]
        vT = lp[:, :2 * S] + h @ sWT
        z = torch.sigmoid(vT[:, :S])
        r = torch.sigmoid(vT[:, S:])
        hbar = torch.tanh(lp[:, 2 * S:] + (r * h) @ sW2T)
        new = z * h + (1 - z) * hbar
        h = torch.where(mask[t][:, None], new, h)
        out[t] = h
    return out


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
    br = 1
    while br < 8 and -(-B // br) > sms:
        br *= 2
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

    _ARGTYPES = {"gru_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12
                 + [ctypes.c_void_p]}

    def __init__(self):
        self.launches = 0

    def __call__(self, xp, sWT, sW2T, mask=None, reverse=False):
        """:param mask: optional (T, B) bool valid-step mask"""
        T, B, S3 = xp.shape
        if mask is None:
            mask = torch.ones((T, B), dtype=torch.bool, device=xp.device)
        if xp.device.type == "cpu":
            return gru_scan_plain(xp, sWT, sW2T, mask.bool(), reverse)
        T, B, S = _check_gru_shapes(xp, sWT, sW2T, mask, 512)
        out = torch.empty((T, B, S), dtype=torch.float32, device=xp.device)
        if T == 0 or B == 0:
            return out
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
                              out.data_ptr(), T, B, S, int(bool(reverse)),
                              plan["br"], FWD_MODES.index(plan["mode"]),
                              plan["kr"], plan["kh2"], plan["ns"],
                              int(plan["stage1"]), plan["smem"],
                              plan["threads"],
                              torch.cuda.current_stream().cuda_stream)
        cuda_build.check(err, "gru_fwd")
        self.launches += 1
        return out


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
    (the reverse-time recurrence, which also writes ``r * h_prev``) followed
    by :data:`gru_wgrad`.

    Runs :func:`gru_scan_bwd_plain` for CPU tensors.  ``launches`` counts
    launches of ``gru_bwd``; ``gru_wgrad`` counts its own."""

    _ARGTYPES = {"gru_bwd": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                 + [ctypes.c_void_p]}

    def __init__(self):
        self.launches = 0

    def recurrence(self, xp, sWT, sW2T, mask, reverse, g, h_out):
        """The ``gru_bwd`` kernel alone (CUDA tensors only).

        :returns: (dxp (T, B, 3S), rh (T, B, S))
        """
        T, B, S = _check_gru_shapes(xp, sWT, sW2T, mask, 256)
        dev = xp.device
        cuda_build.check_tensor(g, (T, B, S), torch.float32, dev, "g")
        cuda_build.check_tensor(h_out, (T, B, S), torch.float32, dev, "h_out")
        dxp = torch.empty((T, B, 3 * S), dtype=torch.float32, device=dev)
        rh = torch.empty((T, B, S), dtype=torch.float32, device=dev)
        if T == 0 or B == 0:
            return dxp, rh
        mask8 = mask.to(torch.uint8).contiguous()
        # the kernel reads both layouts of each weight (see gru_bwd.cu)
        sW = sWT.t().contiguous()
        sW2 = sW2T.t().contiguous()
        lib = cuda_build.load("gru_bwd", self._ARGTYPES)
        with torch.cuda.device(dev):
            err = lib.gru_bwd(xp.data_ptr(), mask8.data_ptr(),
                              sWT.data_ptr(), sW2T.data_ptr(), sW.data_ptr(),
                              sW2.data_ptr(), g.data_ptr(), h_out.data_ptr(),
                              dxp.data_ptr(), rh.data_ptr(),
                              T, B, S, int(bool(reverse)),
                              torch.cuda.current_stream().cuda_stream)
        cuda_build.check(err, "gru_bwd")
        self.launches += 1
        return dxp, rh

    def __call__(self, xp, sWT, sW2T, mask, reverse, g, h_out):
        """:returns: (dxp (T, B, 3S), dsWT (S, 2S), dsW2T (S, S))"""
        if xp.device.type == "cpu":
            return gru_scan_bwd_plain(xp, sWT, sW2T, mask.bool(), reverse, g,
                                      h_out)
        dxp, rh = self.recurrence(xp, sWT, sW2T, mask, reverse, g, h_out)
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
    ``pallas_gru.gru_fused``): the forward is :data:`gru_forward` and saves
    the residuals of ``_fwd`` (:289-291); the backward is
    :data:`gru_backward`.

    ``apply(xp, sWT, sW2T, mask, reverse)`` with a (T, B) bool ``mask``."""

    @staticmethod
    def forward(ctx, xp, sWT, sW2T, mask, reverse):
        h_out = gru_forward(xp, sWT, sW2T, mask=mask, reverse=reverse)
        ctx.save_for_backward(xp, mask, sWT, sW2T, h_out)
        ctx.reverse = reverse
        return h_out

    @staticmethod
    def backward(ctx, g):
        xp, mask, sWT, sW2T, h_out = ctx.saved_tensors
        dxp, dsWT, dsW2T = gru_backward(xp, sWT, sW2T, mask, ctx.reverse,
                                        g.contiguous(), h_out)
        return dxp, dsWT, dsW2T, None, None
