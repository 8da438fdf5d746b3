"""Peephole LSTM recurrence: the CUDA kernels, their plain PyTorch twins and
the autograd function that joins them.

:data:`lstm_forward` replaces the Pallas TPU kernels
``sloika_tpu/nn/pallas_lstm.py::_fwd_kernel`` and ``_fwd_kernel_nocout``
(through ``_fwd_step``, driven by ``_pallas_scan``) with ``csrc/lstm_fwd.cu``.
:data:`lstm_backward` replaces the VJP kernel ``_bwd_kernel`` (driven by
``_pallas_scan_bwd``) with two: ``csrc/lstm_bwd.cu``, the reverse-time
recurrence, and ``csrc/lstm_wgrad.cu`` (:data:`lstm_wgrad`), the
recurrent-weight and peephole cotangents summed over the T*B rows.  The
input projection ``x @ iW.T + b`` stays a ``torch.matmul`` outside the
kernels, as the JAX package leaves it to XLA.

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

import torch

from sloika_tpu_torch import cuda_build
from sloika_tpu_torch.nn.fused_gru import h_prev_of

#: the kernels' limit on S: a block has 4S threads (at most 1,024)
MAX_SIZE = 256


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


def lstm_scan_plain(xp, sWT, p, mask, reverse=False, emit_cout=True):
    """The plain twin of the forward: a Python loop over time of eager
    torch ops that follows ``_fwd_step`` (:52-66).

    :returns: (h (T, B, S), c (T, B, S) or None)
    """
    T, B, S4 = xp.shape
    S = S4 // 4
    h = xp.new_zeros((B, S))
    c = xp.new_zeros((B, S))
    hout = xp.new_empty((T, B, S))
    cout = xp.new_empty((T, B, S)) if emit_cout else None
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        _, _, _, c_new, o = _gates(xp[t], h, c, sWT, p)
        h_new = torch.tanh(c_new) * o
        m = mask[t][:, None]
        h = torch.where(m, h_new, h)
        c = torch.where(m, c_new, c)
        hout[t] = h
        if emit_cout:
            cout[t] = c
    return hout, cout


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


def _check_lstm_shapes(xp, sWT, p, mask):
    T, B, S4 = xp.shape
    S = S4 // 4
    dev = xp.device
    if not 0 < S <= MAX_SIZE or S4 != 4 * S:
        raise ValueError("LSTM size {} outside the kernels' 1..{} (a block "
                         "has 4S threads)".format(S4 / 4, MAX_SIZE))
    cuda_build.check_tensor(xp, (T, B, S4), torch.float32, dev, "xp")
    cuda_build.check_tensor(sWT, (S, S4), torch.float32, dev, "sWT")
    cuda_build.check_tensor(p, (3, S), torch.float32, dev, "p")
    if tuple(mask.shape) != (T, B) or mask.device != dev:
        raise ValueError("mask must be (T, B) on {}".format(dev))
    return T, B, S


class LstmForward:
    """The LSTM forward recurrence; replaces the Pallas TPU kernels
    ``sloika_tpu/nn/pallas_lstm.py::_fwd_kernel`` (with the cell trace) and
    ``_fwd_kernel_nocout`` (without) with ``csrc/lstm_fwd.cu``.

    Launches the CUDA kernel for CUDA tensors and runs
    :func:`lstm_scan_plain` for CPU tensors.  ``launches`` counts kernel
    launches."""

    _ARGTYPES = {"lstm_fwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                 + [ctypes.c_void_p]}

    def __init__(self):
        self.launches = 0

    def __call__(self, xp, sWT, p, mask=None, reverse=False, emit_cout=True):
        """:param mask: optional (T, B) bool valid-step mask
        :returns: (h (T, B, S), c (T, B, S) or None without ``emit_cout``)
        """
        T, B, S4 = xp.shape
        if mask is None:
            mask = torch.ones((T, B), dtype=torch.bool, device=xp.device)
        if xp.device.type == "cpu":
            return lstm_scan_plain(xp, sWT, p, mask.bool(), reverse,
                                   emit_cout)
        T, B, S = _check_lstm_shapes(xp, sWT, p, mask)
        new = lambda: torch.empty((T, B, S), dtype=torch.float32,
                                  device=xp.device)
        h_out = new()
        c_out = new() if emit_cout else None
        if T == 0 or B == 0:
            return h_out, c_out
        mask8 = mask.to(torch.uint8).contiguous()
        lib = cuda_build.load("lstm_fwd", self._ARGTYPES)
        with torch.cuda.device(xp.device):
            err = lib.lstm_fwd(xp.data_ptr(), mask8.data_ptr(),
                               sWT.data_ptr(), p.data_ptr(),
                               h_out.data_ptr(),
                               c_out.data_ptr() if emit_cout else None,
                               T, B, S, int(bool(reverse)),
                               torch.cuda.current_stream().cuda_stream)
        cuda_build.check(err, "lstm_fwd")
        self.launches += 1
        return h_out, c_out


class LstmWgrad:
    """The recurrent-weight cotangent ``dsWT = sum h_prev^T dxp`` and the
    peephole cotangents over the T*B rows, which the Pallas kernel
    ``_bwd_kernel`` accumulates in its body (:165-169); here
    ``csrc/lstm_wgrad.cu``.

    Launches the CUDA kernel for CUDA tensors and runs
    :func:`lstm_wgrad_plain` for CPU tensors.  ``launches`` counts kernel
    launches."""

    _ARGTYPES = {"lstm_wgrad": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                 + [ctypes.c_void_p]}

    #: rows of T*B that one block sums before its partial is stored; the
    #: split depends on the shapes only, so the sum order (and the bits)
    #: are the same from run to run
    ROWS_PER_SPLIT = 1024
    MAX_SPLITS = 64

    def __init__(self):
        self.launches = 0

    def splits(self, nrows):
        return max(1, min(self.MAX_SPLITS, -(-nrows // self.ROWS_PER_SPLIT)))

    def __call__(self, h_out, c_out, dxp, reverse):
        if h_out.device.type == "cpu":
            return lstm_wgrad_plain(h_out, c_out, dxp, reverse)
        T, B, S = h_out.shape
        dev = h_out.device
        cuda_build.check_tensor(h_out, (T, B, S), torch.float32, dev, "h_out")
        cuda_build.check_tensor(c_out, (T, B, S), torch.float32, dev, "c_out")
        cuda_build.check_tensor(dxp, (T, B, 4 * S), torch.float32, dev, "dxp")
        nsplit = self.splits(T * B)
        dsWT = torch.empty((S, 4 * S), dtype=torch.float32, device=dev)
        dp = torch.empty((3, S), dtype=torch.float32, device=dev)
        part = torch.empty((nsplit, 4 * S * S + 3 * S), dtype=torch.float32,
                           device=dev)
        lib = cuda_build.load("lstm_wgrad", self._ARGTYPES)
        with torch.cuda.device(dev):
            err = lib.lstm_wgrad(h_out.data_ptr(), c_out.data_ptr(),
                                 dxp.data_ptr(), part.data_ptr(),
                                 dsWT.data_ptr(), dp.data_ptr(), T, B, S,
                                 int(bool(reverse)), nsplit,
                                 torch.cuda.current_stream().cuda_stream)
        cuda_build.check(err, "lstm_wgrad")
        self.launches += 1
        return dsWT, dp


class LstmBackward:
    """The LSTM VJP; replaces the Pallas TPU kernel
    ``sloika_tpu/nn/pallas_lstm.py::_bwd_kernel`` with ``csrc/lstm_bwd.cu``
    (the reverse-time recurrence) followed by :data:`lstm_wgrad`.

    Runs :func:`lstm_scan_bwd_plain` for CPU tensors.  ``launches`` counts
    launches of ``lstm_bwd``; ``lstm_wgrad`` counts its own."""

    _ARGTYPES = {"lstm_bwd": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                 + [ctypes.c_void_p]}

    def __init__(self):
        self.launches = 0

    def recurrence(self, xp, sWT, p, mask, reverse, g, h_out, c_out):
        """The ``lstm_bwd`` kernel alone (CUDA tensors only).

        :returns: dxp (T, B, 4S)
        """
        T, B, S = _check_lstm_shapes(xp, sWT, p, mask)
        dev = xp.device
        for t, name in ((g, "g"), (h_out, "h_out"), (c_out, "c_out")):
            cuda_build.check_tensor(t, (T, B, S), torch.float32, dev, name)
        dxp = torch.empty((T, B, 4 * S), dtype=torch.float32, device=dev)
        if T == 0 or B == 0:
            return dxp
        mask8 = mask.to(torch.uint8).contiguous()
        # the kernel reads both layouts of the weights (see lstm_bwd.cu)
        sW = sWT.t().contiguous()
        lib = cuda_build.load("lstm_bwd", self._ARGTYPES)
        with torch.cuda.device(dev):
            err = lib.lstm_bwd(xp.data_ptr(), mask8.data_ptr(),
                               sWT.data_ptr(), sW.data_ptr(), p.data_ptr(),
                               g.data_ptr(), h_out.data_ptr(),
                               c_out.data_ptr(), dxp.data_ptr(),
                               T, B, S, int(bool(reverse)),
                               torch.cuda.current_stream().cuda_stream)
        cuda_build.check(err, "lstm_bwd")
        self.launches += 1
        return dxp

    def __call__(self, xp, sWT, p, mask, reverse, g, h_out, c_out):
        """:returns: (dxp (T, B, 4S), dsWT (S, 4S), dp (3, S))"""
        if xp.device.type == "cpu":
            return lstm_scan_bwd_plain(xp, sWT, p, mask.bool(), reverse, g,
                                       h_out, c_out)
        dxp = self.recurrence(xp, sWT, p, mask, reverse, g, h_out, c_out)
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
    and saves the residuals of ``_fwd`` (:247-250); the backward is
    :data:`lstm_backward`.

    ``apply(xp, sWT, p, mask, reverse, has_peep)`` with a (T, B) bool
    ``mask``.  The cell trace is emitted only when a gradient is needed, as
    ``lstm_fused`` runs the no-cout kernel outside ``jax.grad``.  Without
    ``has_peep`` the peepholes get a zero gradient (JAX's
    ``stop_gradient``, ``pallas_lstm.py:276-277``)."""

    @staticmethod
    def forward(ctx, xp, sWT, p, mask, reverse, has_peep):
        # grad mode is off inside Function.forward: ask autograd instead
        train = any(ctx.needs_input_grad[:3])
        h_out, c_out = lstm_forward(xp, sWT, p, mask=mask, reverse=reverse,
                                    emit_cout=train)
        if train:
            ctx.save_for_backward(xp, mask, sWT, p, h_out, c_out)
        ctx.reverse, ctx.has_peep = reverse, has_peep
        return h_out

    @staticmethod
    def backward(ctx, g):
        xp, mask, sWT, p, h_out, c_out = ctx.saved_tensors
        dxp, dsWT, dp = lstm_backward(xp, sWT, p, mask, ctx.reverse,
                                      g.contiguous(), h_out, c_out)
        if not ctx.has_peep:
            dp = torch.zeros_like(dp)
        return dxp, dsWT, dp, None, None, None
