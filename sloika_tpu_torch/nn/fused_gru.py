"""GRU forward recurrence: the CUDA kernel and its plain PyTorch twin.

:data:`gru_forward` replaces the Pallas TPU kernel
``sloika_tpu/nn/pallas_gru.py::_kernel`` (driven by ``_pallas_scan`` and
``gru_fused``) with ``csrc/gru_fwd.cu``.  The input projection
``x @ iW.T + b`` stays a ``torch.matmul`` outside the kernel, as the JAX
package leaves it to XLA.

Contract (both versions): over ``xp`` (T, B, 3S) float32 and the recurrent
weights ``sWT`` (S, 2S), ``sW2T`` (S, S)::

    z, r = sigmoid(xp[:, :2S] + h @ sWT)
    hbar = tanh(xp[:, 2S:] + (r * h) @ sW2T)
    h    = z * h + (1 - z) * hbar

A masked step keeps and emits the carried ``h``; ``reverse`` scans from the
last step to the first.  Returns (T, B, S) float32.
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


class GruForward:
    """The GRU forward recurrence; replaces the Pallas TPU kernel
    ``sloika_tpu/nn/pallas_gru.py::_kernel`` with ``csrc/gru_fwd.cu``.

    Launches the CUDA kernel for CUDA tensors and runs
    :func:`gru_scan_plain` for CPU tensors.  ``launches`` counts kernel
    launches."""

    _ARGTYPES = {"gru_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
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
        S = S3 // 3
        dev = xp.device
        cuda_build.check_tensor(xp, (T, B, 3 * S), torch.float32, dev, "xp")
        cuda_build.check_tensor(sWT, (S, 2 * S), torch.float32, dev, "sWT")
        cuda_build.check_tensor(sW2T, (S, S), torch.float32, dev, "sW2T")
        if tuple(mask.shape) != (T, B) or mask.device != dev:
            raise ValueError("mask must be (T, B) on {}".format(dev))
        if not 0 < 2 * S <= 1024:
            raise ValueError("GRU size {} outside the kernel's 1..512"
                             .format(S))
        if torch.is_grad_enabled() and any(
                a.requires_grad for a in (xp, sWT, sW2T)):
            raise RuntimeError("gru_fwd is a forward kernel (no backward "
                               "yet): call it under torch.no_grad()")
        out = torch.empty((T, B, S), dtype=torch.float32, device=dev)
        if T == 0 or B == 0:
            return out
        mask8 = mask.to(torch.uint8).contiguous()
        lib = cuda_build.load("gru_fwd", self._ARGTYPES)
        with torch.cuda.device(dev):
            err = lib.gru_fwd(xp.data_ptr(), mask8.data_ptr(),
                              sWT.data_ptr(), sW2T.data_ptr(),
                              out.data_ptr(), T, B, S, int(bool(reverse)),
                              torch.cuda.current_stream().cuda_stream)
        cuda_build.check(err, "gru_fwd")
        self.launches += 1
        return out


#: the GRU forward entry point (kernel on CUDA, plain twin on the CPU)
gru_forward = GruForward()
